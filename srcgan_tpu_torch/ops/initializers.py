"""Fresh weights with the JAX package's distributions (``srcgan_tpu.ops.initializers``).

Used only for freshly made models; trained weights come in through
``srcgan_tpu_torch.interop``.  The numbers differ from JAX's for the same
seed (different generators); the distributions are the same: kaiming normal
(fan_out, relu) for conv and deconv weights, torch's default uniform for
biases.  Fans are counted as the JAX package counts them on its HWIO weights,
which for a transposed conv is kh*kw*out_channels.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def kaiming_normal_(w: torch.Tensor, fan: int, generator: torch.Generator):
    """Fill w with N(0, 2/fan) (kaiming normal, relu gain)."""
    std = math.sqrt(2.0) / math.sqrt(fan)
    w.copy_(torch.randn(w.shape, generator=generator) * std)


def torch_bias_default_(b: torch.Tensor, fan_in: int, generator: torch.Generator):
    """Fill b with U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    b.copy_((torch.rand(b.shape, generator=generator) * 2 - 1) * bound)


@torch.no_grad()
def init_kaiming_(module: nn.Module, generator: torch.Generator | None = None):
    """Initialize every conv / transposed conv under ``module`` in place, from
    ``generator`` (seed 0 when omitted), in registration order."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            cin, cout, kh, kw = m.weight.shape          # (in, out, kh, kw)
            fan_out = fan_in = cout * kh * kw
        elif isinstance(m, nn.Conv2d):
            cout, cin_g, kh, kw = m.weight.shape        # (out, in/groups, kh, kw)
            fan_out, fan_in = cout * kh * kw, cin_g * kh * kw
        else:
            continue
        kaiming_normal_(m.weight, fan_out, generator)
        if m.bias is not None:
            torch_bias_default_(m.bias, fan_in, generator)
