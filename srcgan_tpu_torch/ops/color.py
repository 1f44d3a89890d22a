"""Colour conversions over (..., C) tensors, as in ``srcgan_tpu.ops.color``.

Only luma is here so far; the LAB conversions are still to be ported
(ROADMAP A2).
"""
from __future__ import annotations

import functools

import torch

# skimage.color.rgb2gray coefficients, the same as the JAX package's.
LUMA = (0.2125, 0.7154, 0.0721)


@functools.lru_cache(maxsize=16)
def _luma_weights(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # made once per dtype and device: building it from a list on a card is a
    # copy from pageable host memory, which makes the host wait for the card
    return torch.tensor(LUMA, dtype=dtype, device=device)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> (..., 1) luma."""
    return (rgb * _luma_weights(rgb.dtype, rgb.device)).sum(dim=-1, keepdim=True)


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Alias of rgb_to_gray (the name the training degradation uses)."""
    return rgb_to_gray(rgb)
