"""SSIM with the protocol's automatic dynamic range: a hand-written sm_90a kernel.

Port of ``srcgan_tpu.ops.pallas.ssim_kernel.ssim_pallas``, the SSIM column of
the evaluation protocol.  NHWC tensors; an 11-tap Gaussian window (sigma 1.5)
applied as a *valid* separable filter to x, y, x², y² and xy of every (image,
channel) plane; the SSIM and contrast-structure maps; their means.

``csrc/ssim.cu`` computes, per 32x32 tile of outputs of one plane, the two
sums over the tile; this wrapper detects the dynamic range L (max > 128 ->
255 else 1, min < -0.5 -> -1 else 0, over the batch or per sample) on the
device without a host round trip, adds a plane's partial sums with
``torch.sum`` and finishes the means as the Pallas wrapper does.

``ssim_fused`` launches the kernel for a CUDA tensor and runs the plain
version (``ssim_reference``, the depthwise-convolution form) for a CPU
tensor; there is no fallback from one to the other.  ``launches`` counts the
kernel launches.  Neither the TPU kernel nor this one has a backward: a
tensor that requires grad is refused (losses take ``ssim_reference``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# Kernel launches since import (or since a caller last set it to 0).
launches = 0

TILE = 32                     # csrc/ssim.cu kTile: outputs per block, each way
_WINDOWS = (3, 5, 7, 9, 11)   # the window sizes csrc/ssim.cu instantiates
_MAX_PLANES = 65535           # grid.z


def _gauss(w_size: int, sigma: float) -> np.ndarray:
    g = np.array([math.exp(-((i - w_size // 2) ** 2) / (2.0 * sigma ** 2))
                  for i in range(w_size)], dtype=np.float64)
    return g / g.sum()


def gauss_taps(w_size: int = 11, sigma: float = 1.5) -> tuple:
    """The kernel's taps: the normalized float64 Gaussian, rounded to float32."""
    return tuple(_gauss(w_size, sigma).astype(np.float32).tolist())


def gaussian_window(w_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The 2-D window of the plain version: the float64 outer product of the
    normalized taps, rounded to float32 once."""
    g = _gauss(w_size, sigma)
    return np.outer(g, g).astype(np.float32)


def tiling(h: int, w: int, w_size: int = 11):
    """(valid_h, valid_w, tiles_y, tiles_x) of one plane: the valid region of
    the filter and the kernel's grid over it.  Raises where a plane is
    smaller than the window (no valid region)."""
    vh, vw = h - w_size + 1, w - w_size + 1
    if vh < 1 or vw < 1:
        raise ValueError(f"ssim: a {h}x{w} plane has no valid region under a "
                         f"{w_size}-tap window")
    return vh, vw, -(-vh // TILE), -(-vw // TILE)


def dynamic_range(y_pred: torch.Tensor, per_sample: bool) -> torch.Tensor:
    """L = max_val - min_val per sample, shape (N,), float32, on the input's
    device, detected from y_pred over the whole batch or per sample.
    Branchless: no value leaves the device."""
    mn, mx = torch.aminmax(y_pred.reshape(y_pred.shape[0], -1), dim=1) if per_sample else (
        torch.aminmax(y_pred))
    one = torch.ones((), dtype=torch.float32, device=y_pred.device)
    max_val = torch.where(mx > 128.0, 255.0 * one, one)
    min_val = torch.where(mn < -0.5, -one, 0.0 * one)
    return (max_val - min_val).expand(y_pred.shape[0])


def plane_ranges(y_pred: torch.Tensor, per_sample: bool) -> torch.Tensor:
    """The kernel's range argument: one L per (image, channel) plane, (N*C,)
    float32, materialized (an expanded view has stride 0 and ONE element in
    memory, and the kernel indexes it by plane)."""
    n, c = y_pred.shape[0], y_pred.shape[-1]
    return dynamic_range(y_pred, per_sample)[:, None].expand(n, c).contiguous().view(-1)


def _check(y_pred: torch.Tensor, y_true: torch.Tensor, w_size: int):
    if y_pred.dim() != 4 or y_pred.shape != y_true.shape:
        raise ValueError(f"ssim: expected two (N,H,W,C) tensors of one shape, got "
                         f"{tuple(y_pred.shape)} and {tuple(y_true.shape)}")
    if y_pred.device != y_true.device:
        raise ValueError("ssim: the two tensors lie on different devices")
    if not (y_pred.is_floating_point() and y_true.is_floating_point()):
        raise ValueError(f"ssim: expected floating tensors, got {y_pred.dtype}, {y_true.dtype}")
    if y_pred.requires_grad or y_true.requires_grad:
        raise ValueError("ssim: the fused SSIM has no backward (the TPU kernel has "
                         "none either); detach the inputs, or take ssim_reference "
                         "for a loss")
    n, h, w, c = y_pred.shape
    return (n, h, w, c) + tiling(h, w, w_size)


def _finish(ssim_sums, cs_sums, n, c, valid, size_average, full):
    """Means from per-plane sums (N*C,), as the Pallas wrapper finishes them."""
    cs = cs_sums.sum() / (n * c * valid)
    if size_average:
        ret = ssim_sums.sum() / (n * c * valid)
    else:
        ret = (ssim_sums.reshape(n, c) / valid).mean(dim=1)
    return (ret, cs) if full else ret


def ssim_reference(y_pred: torch.Tensor, y_true: torch.Tensor, w_size: int = 11,
                   size_average: bool = True, full: bool = False,
                   per_sample_range: bool = False):
    """Plain torch version, the depthwise-convolution form of the JAX package's
    ``ssim_xla``: five valid convolutions (groups=C) with the w_size x w_size
    outer-product window, then the maps and their means.  Differentiable."""
    n, h, w, c = y_pred.shape
    tiling(h, w, w_size)
    y_pred, y_true = y_pred.float(), y_true.float()     # as the kernel: products in fp32
    dyn_l = dynamic_range(y_pred.detach(), per_sample_range).reshape(n, 1, 1, 1)
    window = torch.from_numpy(gaussian_window(w_size)).to(y_pred.device)
    window = window.expand(c, 1, w_size, w_size).contiguous()

    def filt(t):
        return F.conv2d(t.permute(0, 3, 1, 2), window, groups=c)

    mu1, mu2 = filt(y_pred), filt(y_true)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(y_pred * y_pred) - mu1_sq
    sigma2_sq = filt(y_true * y_true) - mu2_sq
    sigma12 = filt(y_pred * y_true) - mu1_mu2

    c1 = (0.01 * dyn_l) ** 2
    c2 = (0.03 * dyn_l) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    cs = torch.mean(v1 / v2)
    ssim_map = ((2.0 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    ret = ssim_map.mean() if size_average else ssim_map.mean(dim=(1, 2, 3))
    return (ret, cs) if full else ret


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """csrc/ssim.cu, built at first use, with its C signatures declared."""
    from srcgan_tpu_torch.ops.kernels import build

    lib = build.load("ssim")
    lib.ssim_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_float)]
                                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                + [ctypes.c_void_p])
    lib.ssim_launch.restype = ctypes.c_int
    lib.ssim_error_string.argtypes = [ctypes.c_int]
    lib.ssim_error_string.restype = ctypes.c_char_p
    return lib


def _kernel(y_pred, y_true, dyn_planes, dims, w_size):
    """Per-plane (ssim_sum, cs_sum), each (N*C,), from one launch."""
    global launches
    n, h, w, c, _, _, tiles_y, tiles_x = dims
    if w_size not in _WINDOWS:
        raise ValueError(f"ssim: the kernel is built for windows {_WINDOWS}, not {w_size}")
    if n * c > _MAX_PLANES:
        raise ValueError(f"ssim: {n * c} planes exceed the kernel's {_MAX_PLANES}")
    lib = _library()
    dev = y_pred.device
    x = y_pred.float().contiguous()
    y = y_true.float().contiguous()
    parts = torch.empty((2, n * c, tiles_y * tiles_x), dtype=torch.float32, device=dev)
    taps = (ctypes.c_float * w_size)(*gauss_taps(w_size))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ssim_launch(x.data_ptr(), y.data_ptr(), dyn_planes.data_ptr(), taps,
                              parts[0].data_ptr(), parts[1].data_ptr(), n, h, w, c, w_size,
                              stream)
    if err:
        raise RuntimeError(f"ssim launch failed: {lib.ssim_error_string(err).decode()}")
    launches += 1
    sums = parts.sum(dim=2)
    return sums[0], sums[1]


def ssim_fused(y_pred: torch.Tensor, y_true: torch.Tensor, w_size: int = 11,
               size_average: bool = True, full: bool = False,
               per_sample_range: bool = False):
    """SSIM of two NHWC batches: a scalar (``size_average``) or (N,) per-sample
    values (the mean over a sample's channels); with ``full`` also the
    contrast-structure mean.  ``per_sample_range`` detects the dynamic range
    per sample, as a one-sample-at-a-time evaluation would, and not over the
    batch.  CUDA tensors: the sm_90a kernel (raises if it cannot run).  CPU
    tensors: the plain version."""
    dims = _check(y_pred, y_true, w_size)
    if not y_pred.is_cuda:
        return ssim_reference(y_pred, y_true, w_size, size_average, full, per_sample_range)
    n, _, _, c, vh, vw, _, _ = dims
    dyn_planes = plane_ranges(y_pred, per_sample_range)
    ssim_sums, cs_sums = _kernel(y_pred, y_true, dyn_planes, dims, w_size)
    return _finish(ssim_sums, cs_sums, n, c, vh * vw, size_average, full)
