"""PatchGAN discriminator, as in ``srcgan_tpu.models.discriminator``."""
from __future__ import annotations

import torch
from torch import nn

from srcgan_tpu_torch.ops import norm as norm_ops
from srcgan_tpu_torch.ops.initializers import init_torch_default_


class NLayerDiscriminator(nn.Module):
    """k4 stride-2 conv pyramid, channel doubling capped at 8x, BatchNorm (or
    InstanceNorm), LeakyReLU(0.2), a final 1-channel prediction map.

    The layers sit in an ``nn.Sequential`` named ``model``, so the torch
    names are the reference's ``model.N.*`` and the indices N are those of
    the JAX package's Sequential, whose parameter tree is rooted at the
    Sequential itself (``jax_root``, read by ``interop``).  Normed convs
    have no bias with BN and a bias with IN; torch-default init, as the
    reference leaves the discriminator's."""

    jax_root = "model"

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm: str = "BN", *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        use_bias = norm == "IN"

        def make_norm(ch):
            return norm_ops.BatchNorm2d(ch) if norm == "BN" else norm_ops.InstanceNorm2d(ch)

        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, n_layers):
            nf_mult_prev, nf_mult = nf_mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * nf_mult_prev, ndf * nf_mult, 4, 2, 1, bias=use_bias),
                       make_norm(ndf * nf_mult), nn.LeakyReLU(0.2)]
        nf_mult_prev, nf_mult = nf_mult, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * nf_mult_prev, ndf * nf_mult, 4, 1, 1, bias=use_bias),
                   make_norm(ndf * nf_mult), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * nf_mult, 1, 4, 1, 1)]
        self.model = nn.Sequential(*layers)
        # (kernel, stride, pad) of each conv, for the degenerate-input guard
        self._conv_specs = [(4, 2, 1)] * n_layers + [(4, 1, 1), (4, 1, 1)]
        init_torch_default_(self, generator)
        self.to(device=device, memory_format=torch.channels_last)

    def _check_spatial(self, h: int, w: int) -> None:
        """Raise ValueError where a conv's padded input is smaller than its
        kernel, as the JAX model does (an XLA conv would emit an empty map
        there and the GAN loss would turn NaN)."""
        for k, s, p in self._conv_specs:
            if h + 2 * p < k or w + 2 * p < k:
                raise ValueError(
                    f"NLayerDiscriminator input too small: a {h}x{w} feature map "
                    f"(after earlier stride-2 convs) is smaller than the k{k} kernel")
            h = (h + 2 * p - k) // s + 1
            w = (w + 2 * p - k) // s + 1

    def forward(self, x):
        self._check_spatial(int(x.shape[2]), int(x.shape[3]))
        return self.model(x)
