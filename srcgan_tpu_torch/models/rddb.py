"""RDDBNet, the ESRGAN-style SR generator, as in ``srcgan_tpu.models.rddb``."""
from __future__ import annotations

import math

import torch
from torch import nn

from srcgan_tpu_torch.models.blocks import deconv, rrdb_trunk
from srcgan_tpu_torch.ops import fused
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.ops.initializers import init_kaiming_
from srcgan_tpu_torch.ops.kernels import tail_kernel

# r=8 folds the deconvs but runs conv_last at full resolution: the fully
# folded last conv would be (3,3,64*nf,64*ou), 16x the useful FLOPs.
MAX_FOLD_LAST_R = 4


class RDDBNet(nn.Module):
    """conv_first -> nb x RRDB -> trunk_conv (+ global residual) ->
    log2(r) x [k2s2 deconv + LeakyReLU(0.2)] -> conv_last (no bias).

    The upsample tail always runs phase-folded at trunk resolution
    (``ops.fused.phasefold_deconv_tail``).  In eval, an x4 bf16 CUDA input
    whose shape ``tail_kernel.supported`` accepts goes through the sm_90a
    tail kernel instead, as the JAX model takes its Pallas kernel on a TPU.
    The eval path is forward-only: its folded weights are built once per
    weight set without autograd and cached (rebuilt when a weight's version,
    storage, dtype or device changes).
    """

    def __init__(self, in_ch: int, ou_ch: int, upscale_factor: int,
                 nf: int = 64, nb: int = 3, gc: int = 32, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.upscale_factor = upscale_factor
        n_up = int(math.log2(upscale_factor)) if upscale_factor > 1 else 0
        self.conv_first = nn.Conv2d(in_ch, nf, 3, 1, 1, bias=True)
        self.RRDB_trunk = rrdb_trunk(nf, nb, gc)
        self.trunk_conv = nn.Conv2d(nf, nf, 3, 1, 1, bias=True)
        self.upscale_layers = nn.Sequential(*[
            m for _ in range(n_up) for m in (deconv(nf, nf, 2), nn.LeakyReLU(0.2))])
        self.conv_last = nn.Conv2d(nf, ou_ch, 3, 1, 1, bias=False)
        init_kaiming_(self, generator)
        self.to(device=device, memory_format=torch.channels_last)
        self._prepared = (None, None)     # (key, folded tail weights)

    def forward(self, x):
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        if self.upscale_factor == 1:
            return self.conv_last(fea)
        return to_nchw(self._tail(to_nhwc(fea)))

    def _tail(self, t):
        """Upsample tail on the NHWC view t of the trunk output."""
        deconvs = list(self.upscale_layers)[::2]
        lb = self.conv_last.bias
        if (not self.training and len(deconvs) == 2 and t.is_cuda
                and tail_kernel.supported(t.shape, 4, t.dtype)):
            tw = self._eval_weights("kernel", lambda: tail_kernel.prepare(
                deconvs[0].weight, deconvs[1].weight, self.conv_last.weight))
            return tail_kernel.tail_x4_fused(t, tw, lb)
        # (in,out,kh,kw) -> HWIO; (ou,nf,3,3) -> (3,3,nf,ou)
        dws = [d.weight.permute(2, 3, 0, 1) for d in deconvs]
        lw = self.conv_last.weight.permute(2, 3, 1, 0)
        fold_last = self.upscale_factor <= MAX_FOLD_LAST_R
        wf = None
        if fold_last and not self.training:
            wf = self._eval_weights(("fold", t.dtype), lambda: fused.fold_last_weight(
                fused.tail_phases(len(dws)), lw, self.upscale_factor, t.shape[-1],
                t.dtype))
        return fused.phasefold_deconv_tail(t, dws, lw, lb, alpha=0.2,
                                           fold_last=fold_last, wf=wf)

    def _eval_weights(self, kind, build):
        params = [d.weight for d in list(self.upscale_layers)[::2]]
        params.append(self.conv_last.weight)
        key = (kind, *((p._version, p.data_ptr(), p.dtype, p.device) for p in params))
        if self._prepared[0] != key:
            with torch.no_grad():
                self._prepared = (key, build())
        return self._prepared[1]
