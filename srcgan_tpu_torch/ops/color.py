"""Colour conversions over (..., C) tensors, as in ``srcgan_tpu.ops.color``
(skimage-compatible, D65 / sRGB).

  - luma / rgb_to_gray: Y = 0.2125 R + 0.7154 G + 0.0721 B.
  - normalized LAB: L/100, (ab + 128)/255, all in [0, 1]; back for display:
    L*100, ab*255 - 128.

RGB is in [0, 1]; every function works at the input's dtype and device.  The
3x3 colour matrices are applied as scalar multiply-adds per channel, so no
constant is copied to the device and no matrix product is subject to TF32.
"""
from __future__ import annotations

import functools

import torch

from srcgan_tpu_torch import config

# skimage.color.rgb2gray coefficients, the same as the JAX package's.
LUMA = (0.2125, 0.7154, 0.0721)


@config.constant_cache
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


# skimage.color D65 2-degree observer constants.
_XYZ_FROM_RGB = ((0.412453, 0.357580, 0.180423),
                 (0.212671, 0.715160, 0.072169),
                 (0.019334, 0.119193, 0.950227))
_WHITE = (0.95047, 1.0, 1.08883)


@functools.lru_cache(maxsize=1)
def _rgb_from_xyz() -> tuple:
    # the fp32 inverse, as the JAX package computes it, made once on the host
    inv = torch.linalg.inv(torch.tensor(_XYZ_FROM_RGB, dtype=torch.float32))
    return tuple(tuple(row) for row in inv.tolist())


def _matvec(rows, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) times the transpose of the 3x3 ``rows``: out_i = sum_j rows[i][j] v_j."""
    a, b, c = v.unbind(dim=-1)
    return torch.stack([a * r[0] + b * r[1] + c * r[2] for r in rows], dim=-1)


def _srgb_to_linear(v):
    return torch.where(v > 0.04045, ((v + 0.055) / 1.055) ** 2.4, v / 12.92)


def _linear_to_srgb(v):
    v = v.clamp_min(0.0)
    return torch.where(v > 0.0031308, 1.055 * v ** (1.0 / 2.4) - 0.055, 12.92 * v)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return _matvec(_XYZ_FROM_RGB, _srgb_to_linear(rgb))


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return _linear_to_srgb(_matvec(_rgb_from_xyz(), xyz)).clamp(0.0, 1.0)


def _per_channel(v: torch.Tensor, scale, divide: bool) -> torch.Tensor:
    chans = v.unbind(dim=-1)
    return torch.stack([c / s if divide else c * s for c, s in zip(chans, scale)], dim=-1)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0,1] -> (..., 3) LAB (L in [0,100], ab ~ [-128,127])."""
    xyz = _per_channel(rgb_to_xyz(rgb), _WHITE, divide=True)
    # torch has no cbrt; the root is taken only where xyz > 0.008856
    f = torch.where(xyz > 0.008856, xyz.clamp_min(0.0) ** (1.0 / 3.0),
                    7.787 * xyz + 16.0 / 116.0)
    fx, fy, fz = f.unbind(dim=-1)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def lab_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_lab (skimage lab2rgb semantics, clipped to [0,1])."""
    lab_l, lab_a, lab_b = lab.unbind(dim=-1)
    fy = (lab_l + 16.0) / 116.0
    f = torch.stack([lab_a / 500.0 + fy, fy, fy - lab_b / 200.0], dim=-1)
    xyz = torch.where(f > 0.2068966, f ** 3, (f - 16.0 / 116.0) / 7.787)
    return xyz_to_rgb(_per_channel(xyz, _WHITE, divide=False))


def rgb_to_lab_norm(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] -> normalized LAB: L/100, (ab+128)/255, all in [0,1]."""
    lab_l, lab_a, lab_b = rgb_to_lab(rgb).unbind(dim=-1)
    return torch.stack([lab_l / 100.0, (lab_a + 128.0) / 255.0, (lab_b + 128.0) / 255.0],
                       dim=-1)


def lab_norm_to_rgb(lab_n: torch.Tensor) -> torch.Tensor:
    """Normalized LAB -> RGB [0,1]."""
    lab_l, lab_a, lab_b = lab_n.unbind(dim=-1)
    return lab_to_rgb(torch.stack([lab_l * 100.0, lab_a * 255.0 - 128.0,
                                   lab_b * 255.0 - 128.0], dim=-1))


def rgb_to_ab_norm(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] -> the normalized ab channels only."""
    return rgb_to_lab_norm(rgb)[..., 1:]
