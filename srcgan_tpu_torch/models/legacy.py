"""The legacy CycleGAN-era nets, as in ``srcgan_tpu.models.legacy``.

The generators of the adversarial trainer and two unreachable towers:
``RDDBNetA`` (the mode-based RDDB net the reference's driver imports under
that name), ``RDDBNetB`` (its variant with a global residual),
``RDDBNetD`` (the downscaling mirror), ``SRDenseNetA`` / ``SRDenseNetB``
(deconv up / stride-2 down), ``Encoder`` and ``Decoder``.  Each keeps the
quirks the JAX models keep on purpose; the docstrings name them.  NCHW
modules with the reference's torch names (``RRDB_trunk`` for the JAX
``trunk``), so ``interop`` carries weights across both ways.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srcgan_tpu_torch.models.blocks import rrdb_trunk
from srcgan_tpu_torch.ops import fused, norm
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.ops.initializers import (init_kaiming_, init_kaiming_fan_in_,
                                               init_torch_default_)


def _lrelu(v):
    return F.leaky_relu(v, 0.2)


def _up_conv(conv: nn.Conv2d, x):
    """conv(nearest_upsample_x2(x)) through ``ops.fused.nearest_up2_conv3x3``."""
    y = fused.nearest_up2_conv3x3(to_nhwc(x), conv.weight.permute(2, 3, 1, 0), conv.bias)
    return to_nchw(y)


def _finish(module: nn.Module, init, generator, device):
    init(module, generator)
    module.to(device=device, memory_format=torch.channels_last)


class RDDBNetA(nn.Module):
    """Mode-based RDDB net: conv_first -> RRDB trunk -> trunk_conv, and the
    reference's tail: it upscales ``fea`` (the conv_first features), NOT
    fea + trunk, so the trunk never reaches the output and is not run; x2 and
    x4 apply the SAME ``upconv`` after each nearest upsample; the SAME
    ``HRconv`` runs twice."""

    def __init__(self, in_nc: int, out_nc: int, nf: int = 64, nb: int = 3,
                 gc: int = 32, mode: str = "x2", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mode = mode
        self.conv_first = nn.Conv2d(in_nc, nf, 3, 1, 1)
        self.RRDB_trunk = rrdb_trunk(nf, nb, gc)
        self.trunk_conv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.upconv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.HRconv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv_last = nn.Conv2d(nf, out_nc, 3, 1, 1)
        _finish(self, init_kaiming_, generator, device)

    def forward(self, x):
        fea = self.conv_first(x)
        if self.mode == "x4":
            fea = _lrelu(_up_conv(self.upconv, fea))
            fea = _lrelu(_up_conv(self.upconv, fea))
        elif self.mode == "x2":
            fea = _lrelu(_up_conv(self.upconv, fea))
        elif self.mode == "x1":
            fea = _lrelu(self.upconv(fea))
        fea = _lrelu(self.HRconv(fea))
        return self.conv_last(_lrelu(self.HRconv(fea)))


class RDDBNetB(nn.Module):
    """RDDBNetA with the global residual and separate upconv1 / upconv2; x2
    applies ``upconv1`` twice (after the upsample, then at size) and the
    tail applies the same ``HRconv`` 8 times."""

    def __init__(self, in_nc: int, out_nc: int, nf: int = 64, nb: int = 3,
                 gc: int = 32, mode: str = "x2", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mode = mode
        self.conv_first = nn.Conv2d(in_nc, nf, 3, 1, 1)
        self.RRDB_trunk = rrdb_trunk(nf, nb, gc)
        self.trunk_conv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.upconv1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.upconv2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.HRconv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv_last = nn.Conv2d(nf, out_nc, 3, 1, 1)
        _finish(self, init_kaiming_, generator, device)

    def forward(self, x):
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        if self.mode == "x4":
            fea = _lrelu(_up_conv(self.upconv1, fea))
            fea = _lrelu(_up_conv(self.upconv2, fea))
        elif self.mode == "x2":
            fea = _lrelu(_up_conv(self.upconv1, fea))
            fea = _lrelu(self.upconv1(fea))
        for _ in range(7):
            fea = _lrelu(self.HRconv(fea))
        return self.conv_last(_lrelu(self.HRconv(fea)))


class RDDBNetD(nn.Module):
    """The downscaling mirror of the RDDB nets (a reconstruction in the JAX
    package too): stride-2 ``downconv`` in place of upsample + conv, the SAME
    weights at each scale, then the two-HRconv tail."""

    def __init__(self, in_nc: int, out_nc: int, nf: int = 64, nb: int = 3,
                 gc: int = 32, mode: str = "x2", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mode = mode
        self.conv_first = nn.Conv2d(in_nc, nf, 3, 1, 1)
        self.RRDB_trunk = rrdb_trunk(nf, nb, gc)
        self.trunk_conv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.downconv = nn.Conv2d(nf, nf, 3, 2, 1)
        self.HRconv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv_last = nn.Conv2d(nf, out_nc, 3, 1, 1)
        _finish(self, init_kaiming_, generator, device)

    def forward(self, x):
        fea = self.conv_first(x)
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        for _ in range({"x1": 0, "x2": 1, "x4": 2}[self.mode]):
            fea = _lrelu(self.downconv(fea))
        fea = _lrelu(self.HRconv(fea))
        return self.conv_last(_lrelu(self.HRconv(fea)))


class _DenseBlock(nn.Module):
    """SRDenseNet dense block: conv0 then num_layers-1 dense convs, each
    seeing the concat of the block's earlier outputs; returns
    concat([x, block(x)])."""

    def __init__(self, in_channels: int, growth_rate: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        self.conv0 = nn.Conv2d(in_channels, growth_rate, 3, 1, 1)
        for i in range(num_layers - 1):
            setattr(self, f"dense{i}", nn.Conv2d(growth_rate * (i + 1), growth_rate, 3, 1, 1))

    def forward(self, x):
        h = F.relu(self.conv0(x))
        for i in range(self.num_layers - 1):
            h = torch.cat([h, F.relu(getattr(self, f"dense{i}")(h))], 1)
        return torch.cat([x, h], 1)


class _SRDenseNetBase(nn.Module):
    """The SRDenseNetA/B body; a subclass makes the up / down ``deconv``.
    Kaiming normal (fan_in, relu) weights, zero biases."""

    def __init__(self, in_nc: int, out_nc: int, nb_channel: int = 1,
                 growth_rate: int = 16, num_blocks: int = 8, num_layers: int = 8,
                 mode: str = "x2", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mode = mode
        self.num_blocks = num_blocks
        gl = growth_rate * num_layers
        self.conv_first = nn.Conv2d(in_nc, 1, 3, 1, 1)
        self.conv_low = nn.Conv2d(nb_channel, gl, 3, 1, 1)
        for i in range(num_blocks):
            setattr(self, f"block{i}", _DenseBlock(gl * (i + 1), growth_rate, num_layers))
        self.bottleneck = nn.Conv2d(gl + gl * num_blocks, 256, 1, 1, 0)
        self.deconv = self._make_resample()
        self.reconstruction = nn.Conv2d(256, nb_channel, 3, 1, 1)
        self.conv_last = nn.Conv2d(1, out_nc, 3, 1, 1)
        _finish(self, init_kaiming_fan_in_, generator, device)

    def _make_resample(self) -> nn.Module:
        raise NotImplementedError

    def forward(self, x):
        x = self.conv_first(x)
        x = F.relu(self.conv_low(x))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        x = F.relu(self.bottleneck(x))
        for _ in range({"x2": 1, "x4": 2}.get(self.mode, 0)):
            x = F.relu(self.deconv(x))
        x = self.reconstruction(x)
        return self.conv_last(x)


class SRDenseNetA(_SRDenseNetBase):
    """Upsampling: ConvTranspose2d(256, 256, k3, s2, p1, op1) + ReLU; x4
    reuses the same deconv."""

    def _make_resample(self):
        return nn.ConvTranspose2d(256, 256, 3, 2, 1, 1)


class SRDenseNetB(_SRDenseNetBase):
    """Downsampling: a stride-2 conv + ReLU, reused for x4."""

    def _make_resample(self):
        return nn.Conv2d(256, 256, 3, 2, 1)


class Decoder(nn.Module):
    """Legacy conv downsampling tower: 6 x [conv (no bias) - BN -
    LeakyReLU(0.1)], two stride-2 stages, 64->128->256->128->64 channels.
    Unreachable from the reference's drivers."""

    def __init__(self, *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        chans = [(64, 64, 1), (64, 128, 1), (128, 128, 2), (128, 256, 2),
                 (256, 128, 1), (128, 64, 1)]
        for i, (cin, cout, s) in enumerate(chans, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, 3, s, 1, bias=False))
            setattr(self, f"bn{i}", norm.BatchNorm2d(cout))
        _finish(self, init_torch_default_, generator, device)

    def forward(self, x):
        for i in range(1, 7):
            x = F.leaky_relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)), 0.1)
        return x


class Encoder(nn.Module):
    """Legacy deconv upsampling tower: 6 x [deconv (no bias) - BN - ReLU],
    two stride-2 k3 p1 op1 stages.  Unreachable from the reference's drivers."""

    def __init__(self, *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        chans = [(64, 64, 1, 0), (64, 128, 1, 0), (128, 128, 2, 1),
                 (128, 256, 2, 1), (256, 128, 1, 0), (128, 64, 1, 0)]
        for i, (cin, cout, s, op) in enumerate(chans, start=1):
            setattr(self, f"decon{i}", nn.ConvTranspose2d(cin, cout, 3, s, 1, op, bias=False))
            setattr(self, f"bn{i}", norm.BatchNorm2d(cout))
        _finish(self, init_torch_default_, generator, device)

    def forward(self, x):
        for i in range(1, 7):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"decon{i}")(x)))
        return x
