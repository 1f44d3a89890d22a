"""Colour conversions over (..., C) tensors, as in ``srcgan_tpu.ops.color``.

Only luma is here so far; the LAB conversions are still to be ported
(ROADMAP A2).
"""
from __future__ import annotations

import torch

# skimage.color.rgb2gray coefficients, the same as the JAX package's.
LUMA = (0.2125, 0.7154, 0.0721)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> (..., 1) luma."""
    w = torch.tensor(LUMA, dtype=rgb.dtype, device=rgb.device)
    return (rgb * w).sum(dim=-1, keepdim=True)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Alias of rgb_to_gray (the name the training degradation uses)."""
    return rgb_to_gray(rgb)
