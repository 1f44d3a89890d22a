"""ESPCN and SRCNN, as in ``srcgan_tpu.models.espcn``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srcgan_tpu_torch.ops.initializers import init_kaiming_, init_torch_default_


class ESPCN(nn.Module):
    """conv5(relu) -> conv3(relu) -> conv3(relu) -> conv3 to base*r^2 ->
    PixelShuffle(r) -> conv3 out.  Widths (64, 64, 32); kaiming init."""

    def __init__(self, in_ch: int = 3, ou_ch: int = 3, upscale_factor: int = 2,
                 base_kernel: int = 64, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = [int(x * base_kernel) for x in (1, 1, 0.5)]
        self.conv1 = nn.Conv2d(in_ch, k[0], 5, 1, 2)
        self.conv2 = nn.Conv2d(k[0], k[1], 3, 1, 1)
        self.conv3 = nn.Conv2d(k[1], k[2], 3, 1, 1)
        self.conv4 = nn.Conv2d(k[2], base_kernel * upscale_factor ** 2, 3, 1, 1)
        self.conv5 = nn.Conv2d(base_kernel, ou_ch, 3, 1, 1)
        self.r = upscale_factor
        init_kaiming_(self, generator)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.relu(self.conv3(x))
        return self.conv5(F.pixel_shuffle(self.conv4(x), self.r))


class SRCNN(nn.Module):
    """9-1-5 conv stack at the input's resolution (the const pipelines' SR
    model); torch-default init, as the JAX model's ``weight_init="torch"``."""

    def __init__(self, in_ch: int = 3, ou_ch: int = 3, upscale_factor: int = 2,
                 base_kernel: int = 64, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = [int(x * base_kernel) for x in (1, 0.5)]
        self.up = upscale_factor
        self.conv1 = nn.Conv2d(in_ch, k[0], 9, 1, 4)
        self.conv2 = nn.Conv2d(k[0], k[1], 1, 1, 0)
        self.conv3 = nn.Conv2d(k[1], ou_ch, 5, 1, 2)
        init_torch_default_(self, generator)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        return F.relu(self.conv3(x))
