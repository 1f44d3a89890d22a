"""SRDN, the resolution-preserving RRDB encoder/decoder, as in ``srcgan_tpu.models.srdn``."""
from __future__ import annotations

import torch
from torch import nn

from srcgan_tpu_torch.models.blocks import rrdb_trunk
from srcgan_tpu_torch.ops.initializers import init_kaiming_


class SRDN(nn.Module):
    """conv_first -> RRDB encoder (+ residual) -> RRDB decoder (+ residual) ->
    conv_last (no bias).  ``trunk_conv`` is allocated and never run, as in
    the reference, so its checkpoints keep their shape; ``upscale_factor``
    is accepted and unused (the net keeps the resolution)."""

    def __init__(self, in_ch: int, ou_ch: int, upscale_factor: int = 1,
                 nf: int = 64, nb: int = 3, gc: int = 32, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.conv_first = nn.Conv2d(in_ch, nf, 3, 1, 1)
        self.RRDB_encoder = rrdb_trunk(nf, nb, gc)
        self.trunk_conv = nn.Conv2d(nf, nf, 3, 1, 1)
        self.RRDB_decoder = rrdb_trunk(nf, nb, gc)
        self.conv_last = nn.Conv2d(nf, ou_ch, 3, 1, 1, bias=False)
        init_kaiming_(self, generator)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x):
        fea = self.conv_first(x)
        fea = fea + self.RRDB_encoder(fea)
        fea = fea + self.RRDB_decoder(fea)
        return self.conv_last(fea)
