"""Shared building blocks of the SR models, as in ``srcgan_tpu.models.blocks``.

NCHW ``nn.Module``s whose attribute names are the reference torch names, so
state_dicts exported by ``srcgan_tpu.interop.export_torch_state_dict`` load
with ``strict=True``.  ResidualDenseBlock5 runs the JAX package's naive
schedule (the literal concat chain); its "grouped" and "paired" schedules are
reassociations of the same function that shaped the work for the TPU's
matrix unit, and are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


def get_deconv_params(upscale_factor: int) -> Tuple[int, int, int]:
    """(kernel, stride, output_padding) per upscale factor: x2->(2,2,0),
    x4->(2,4,2), x8->(4,8,4).  H_out = H_in * upscale_factor."""
    if upscale_factor == 2:
        k, s = 2, 2
    elif upscale_factor == 4:
        k, s = 2, 4
    elif upscale_factor == 8:
        k, s = 4, 8
    else:
        raise ValueError(f"unsupported upscale factor {upscale_factor}")
    return k, s, s - k


def deconv(in_ch: int, out_ch: int, upscale_factor: int = 2) -> nn.ConvTranspose2d:
    """Bias-free transposed conv with the reference deconv spec."""
    k, s, opad = get_deconv_params(upscale_factor)
    return nn.ConvTranspose2d(in_ch, out_ch, k, s, padding=0, output_padding=opad,
                              bias=False)


class ResidualDenseBlock5(nn.Module):
    """5-conv dense block: conv_i sees concat(x, x1..x_{i-1}); output
    conv5(...) * 0.2 + x.  Channel growth nf -> nf+4*gc."""

    def __init__(self, nf: int = 64, gc: int = 32, bias: bool = True):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(nf + i * gc, gc if i < 4 else nf, 3, 1, 1, bias=bias))

    def forward(self, x, lemda: float = 0.2):
        feats = [x]
        for i in range(1, 5):
            conv = getattr(self, f"conv{i}")
            feats.append(F.leaky_relu(conv(torch.cat(feats, 1)), 0.2))
        return self.conv5(torch.cat(feats, 1)) * lemda + x


class RRDB(nn.Module):
    """Residual-in-residual dense block: 3 x RDB5, out * 0.2 + x."""

    def __init__(self, nf: int, gc: int = 32):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5(nf, gc)
        self.RDB2 = ResidualDenseBlock5(nf, gc)
        self.RDB3 = ResidualDenseBlock5(nf, gc)

    def forward(self, x, lemda: float = 0.2):
        return self.RDB3(self.RDB2(self.RDB1(x))) * lemda + x


def rrdb_trunk(nf: int, nb: int, gc: int = 32) -> nn.Sequential:
    """nb RRDBs in sequence."""
    return nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])
