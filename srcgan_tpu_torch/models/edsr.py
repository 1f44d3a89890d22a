"""EDSR with GroupNorm ResnetBlocks and a deconv tail, as in ``srcgan_tpu.models.edsr``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from srcgan_tpu_torch.models.blocks import deconv
from srcgan_tpu_torch.ops import norm
from srcgan_tpu_torch.ops.initializers import init_kaiming_


class EDSRResnetBlock(nn.Module):
    """conv -> GN -> LeakyReLU(0.2) -> conv -> GN -> + residual.  The
    reference allocates ONE GroupNorm (``gn``) and applies it after both
    convs, so the two norms share their scale and bias."""

    def __init__(self, num_channel: int, kernel: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(num_channel, num_channel, kernel, stride, padding)
        self.conv2 = nn.Conv2d(num_channel, num_channel, kernel, stride, padding)
        self.gn = norm.GroupNorm(32, num_channel)

    def forward(self, x):
        y = F.leaky_relu(self.gn(self.conv1(x)), 0.2)
        return self.gn(self.conv2(y)) + x


class EDSR(nn.Module):
    """input_conv -> num_residuals ResnetBlocks -> mid_conv (+ global
    residual) -> log2(r) bias-free k2s2 deconvs with no activation between
    them -> output_conv.  Kaiming init, as the JAX model."""

    # the JAX tree keeps this name (RDDBNet's JAX "upscale" is renamed to it)
    jax_names = {"upscale_layers": "upscale_layers"}

    def __init__(self, in_ch: int, ou_ch: int, upscale_factor: int = 2,
                 base_channel: int = 64, num_residuals: int = 50, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        n_up = int(math.log2(upscale_factor)) if upscale_factor > 1 else 0
        self.input_conv = nn.Conv2d(in_ch, base_channel, 3, 1, 1)
        self.residual_layers = nn.Sequential(
            *[EDSRResnetBlock(base_channel) for _ in range(num_residuals)])
        self.mid_conv = nn.Conv2d(base_channel, base_channel, 3, 1, 1)
        self.upscale_layers = nn.Sequential(
            *[deconv(base_channel, base_channel, 2) for _ in range(n_up)])
        self.output_conv = nn.Conv2d(base_channel, ou_ch, 3, 1, 1)
        init_kaiming_(self, generator)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x):
        x = self.input_conv(x)
        x = self.mid_conv(self.residual_layers(x)) + x
        return self.output_conv(self.upscale_layers(x))
