"""Training losses of the cascade trainer, as in ``srcgan_tpu.losses``.

Means over every element, as the JAX functions reduce.  The GAN objectives
and DSSIM wait for the adversarial family (ROADMAP A10), the VGG perceptual
loss for A13.
"""
from __future__ import annotations

import torch


def l1(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(output - target))


def mse(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((output - target) ** 2)


def psnr(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / mse(output, target))
