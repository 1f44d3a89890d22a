"""Image resizing with ``F.interpolate`` semantics, as separable matmuls
(``srcgan_tpu.ops.resize``).

Each 1-D resample is a small dense (out x in) float32 sampling matrix built
once per size pair on the host; it is applied over H, then over W, in fp32.
That is the JAX package's computation step for step (same matrices, same
order), so the two agree to the rounding of the sums.  The public functions
take and return NHWC tensors, as the JAX ones do.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=256)
def _bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) sampling matrix for torch bilinear, align_corners=False,
    antialias=False: src = (dst + 0.5) * in/out - 0.5, clamped; two taps."""
    scale = in_size / out_size
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for d in range(out_size):
        src = min(max((d + 0.5) * scale - 0.5, 0.0), in_size - 1.0)
        lo = int(math.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[d, lo] += 1.0 - frac
        m[d, hi] += frac
    return m.astype(np.float32)


@lru_cache(maxsize=256)
def _nearest_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) 0/1 matrix for torch mode='nearest': src = floor(dst * in/out)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for d in range(out_size):
        m[d, min(int(d * in_size / out_size), in_size - 1)] = 1.0
    return m


_MATRICES = {"bilinear": _bilinear_matrix, "nearest": _nearest_matrix}


@lru_cache(maxsize=256)
def _matrix_on(mode: str, in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The sampling matrix as a tensor on ``device``, copied there once (a
    copy from pageable host memory makes the host wait for the device)."""
    return torch.from_numpy(_MATRICES[mode](in_size, out_size)).to(device)


def _apply_separable(x: torch.Tensor, mode: str, out_hw) -> torch.Tensor:
    """x (N,H,W,C) -> (N,H',W',C) through the (H',H) and (W',W) sampling
    matrices of ``mode``, over H then W, computed in fp32."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    y = torch.einsum("nhwc,oh->nowc", x.float(), _matrix_on(mode, h, oh, x.device))
    y = torch.einsum("nhwc,ow->nhoc", y, _matrix_on(mode, w, ow, x.device))
    return y.to(x.dtype)


def _out_size(in_size: int, scale) -> int:
    # torch: output size = floor(input * scale_factor)
    return int(math.floor(in_size * scale))


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize (align_corners=False, antialias=False) of NHWC x to (H', W')."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    return _apply_separable(x, "bilinear", (oh, ow))


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of NHWC x, as F.interpolate(mode='nearest')."""
    _, h, w, _ = x.shape
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    return _apply_separable(x, "nearest", (oh, ow))


def interpolate(x: torch.Tensor, scale_factor=None, size=None,
                mode: str = "nearest") -> torch.Tensor:
    """F.interpolate over NHWC x for the two modes the reference uses
    (bilinear with align_corners=False, and nearest)."""
    _, h, w, _ = x.shape
    if size is not None:
        oh, ow = size
    else:
        oh, ow = _out_size(h, scale_factor), _out_size(w, scale_factor)
    if mode == "bilinear":
        return resize_bilinear(x, (oh, ow))
    if mode == "nearest":
        return resize_nearest(x, (oh, ow))
    raise ValueError(f"unsupported mode {mode!r}")
