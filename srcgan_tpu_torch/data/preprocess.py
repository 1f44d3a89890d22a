"""On-device preprocessing of uint8 batches, as in ``srcgan_tpu.data.preprocess``.

  - convert_pair: uint8 RGB (src, tar) -> (gray src, RGB tar) float32
  - degrade_*: the training and eval degradations (luma + down/up-sampling)

NHWC tensors throughout, on the device of the input.
"""
from __future__ import annotations

import torch

from srcgan_tpu_torch.ops import color
from srcgan_tpu_torch.ops.resize import interpolate


def convert_pair(src_u8: torch.Tensor, tar_u8: torch.Tensor, ver: str = "G2RGB"):
    """uint8 NHWC RGB pair -> float32 (src luma 1ch, tar /255 RGB 3ch).

    G2LAB needs the LAB colour ops, which are still to be ported."""
    if ver == "G2LAB":
        raise NotImplementedError("G2LAB needs the LAB colour ops (ROADMAP A9)")
    if ver != "G2RGB":
        raise ValueError(f"unknown dataset version {ver!r}")
    src = src_u8.float() / 255.0
    tar = tar_u8.float() / 255.0
    return color.rgb_to_gray(src), tar


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Y = 0.2125 R + 0.7154 G + 0.0721 B."""
    return color.rgb_to_gray(rgb)


def degrade_bilinear(x: torch.Tensor, up: int) -> torch.Tensor:
    """Training degradation: bilinear downsample by 1/up."""
    return interpolate(x, scale_factor=1.0 / up, mode="bilinear")


def degrade_const(x: torch.Tensor, up: int) -> torch.Tensor:
    """Const-pipeline degradation: bilinear down, then up to the same size."""
    lo = interpolate(x, scale_factor=1.0 / up, mode="bilinear")
    return interpolate(lo, scale_factor=float(up), mode="bilinear")


def degrade_nearest(x: torch.Tensor, up: int) -> torch.Tensor:
    """Eval degradation replay: F.interpolate's default (nearest) mode."""
    return interpolate(x, scale_factor=1.0 / up, mode="nearest")


def degrade_const_nearest(x: torch.Tensor, up: int) -> torch.Tensor:
    """Const eval replay: nearest down, then nearest up to the same size."""
    lo = interpolate(x, scale_factor=1.0 / up, mode="nearest")
    return interpolate(lo, scale_factor=float(up), mode="nearest")
