"""SSIM with the protocol's automatic dynamic range: a hand-written sm_90a kernel.

Port of ``srcgan_tpu.ops.pallas.ssim_kernel.ssim_pallas``, the SSIM column of
the evaluation protocol.  NHWC tensors; an 11-tap Gaussian window (sigma 1.5)
applied as a *valid* separable filter to x, y, x², y² and xy of every (image,
channel) plane; the SSIM and contrast-structure maps; their means.

``csrc/ssim.cu`` does the whole call on the device in two launches: the
dynamic range L (max > 128 -> 255 else 1, min < -0.5 -> -1 else 0, over the
batch or per sample), then the filters and maps over strips of output
columns of all channels of one image (``strip_width`` columns by ``TILE``
rows a block), whose last block of each sample, and then the last of those,
sum the blocks' partials in a fixed order and write the returned means.  The wrapper checks its
arguments, makes one allocation for the result and launches; the workspace
(tickets, ranges, partials) is kept per device, stream and shape.

``ssim_fused`` launches the kernel for a CUDA tensor and runs the plain
version (``ssim_reference``, the depthwise-convolution form) for a CPU
tensor; there is no fallback from one to the other.  ``launches`` counts the
wrapper's calls that launched the kernel pair.  Neither the TPU kernel nor
this one has a backward: a tensor that requires grad is refused (losses take
``ssim_reference``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# Calls that launched the kernel pair since import (or since a caller last
# set it to 0).
launches = 0

TILE = 32                     # output rows per block; output columns per strip where C <= 4
_WINDOWS = (3, 5, 7, 9, 11)   # the window sizes csrc/ssim.cu instantiates
_MAX_PLANES = 65535           # N * C, as the first design's grid held it
_MAX_PAIRS = 128              # (column, channel) pairs a block, one a thread
_MAX_SMEM = 232448            # csrc/ssim.cu kMaxSmem: a block's ring of input rows
_WORKSPACES = 16              # workspaces kept, the most recently used


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


def strip_width(c: int) -> int:
    """Output columns of a block's strip: all C channels of each, so that a
    block has at most 128 (column, channel) pairs, one a thread."""
    return TILE if c <= 4 else max(1, _MAX_PAIRS // c)


def smem_bytes(c: int, w_size: int = 11) -> int:
    """Shared memory of a block (csrc/ssim.cu smem_bytes): two slots of
    w_size input rows of its strip, x and y, each row padded to 16 bytes."""
    pitch = -(-(strip_width(c) + w_size - 1) * c // 4) * 4
    return 2 * 2 * w_size * pitch * 4


def tiling(h: int, w: int, w_size: int = 11, strip: int = TILE):
    """(valid_h, valid_w, tiles_y, tiles_x) of one image: the valid region of
    the filter and the kernel's grid over it (``TILE`` rows by ``strip``
    columns a block).  Raises where a plane is smaller than the window (no
    valid region)."""
    vh, vw = h - w_size + 1, w - w_size + 1
    if vh < 1 or vw < 1:
        raise ValueError(f"ssim: a {h}x{w} plane has no valid region under a "
                         f"{w_size}-tap window")
    return vh, vw, -(-vh // TILE), -(-vw // strip)


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
    return (n, h, w, c) + tiling(h, w, w_size, strip_width(c))


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

    return _declare(build.load("ssim"))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """csrc/ssim.cu's C signatures, on a build of it (the default one, or a
    variant of the ablation's switches)."""
    lib.ssim_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_float)]
                                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                                + [ctypes.c_void_p])
    lib.ssim_launch.restype = ctypes.c_int
    lib.ssim_workspace_bytes.argtypes = [ctypes.c_int] * 7
    lib.ssim_workspace_bytes.restype = ctypes.c_longlong
    lib.ssim_range_offset.argtypes = []
    lib.ssim_range_offset.restype = ctypes.c_longlong
    lib.ssim_error_string.argtypes = [ctypes.c_int]
    lib.ssim_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _host_taps(w_size: int):
    return (ctypes.c_float * w_size)(*gauss_taps(w_size))


_workspaces: collections.OrderedDict = collections.OrderedDict()


def _workspace(lib, index: int, stream: int, key: tuple) -> torch.Tensor:
    """The zeroed workspace of (device, stream, shape), kept for the next
    call: the kernels' last blocks reset its tickets.  A stream has its own,
    since two calls on two streams may overlap."""
    ws = _workspaces.get((index, stream) + key)
    if ws is None:
        nbytes = lib.ssim_workspace_bytes(*key)
        if nbytes <= 0:
            raise ValueError(f"ssim: the kernel refuses (n, h, w, c, w_size, strip, rows) = {key}")
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=torch.device("cuda", index))
        _workspaces[(index, stream) + key] = ws
        if len(_workspaces) > _WORKSPACES:
            _workspaces.popitem(last=False)
    else:
        _workspaces.move_to_end((index, stream) + key)
    return ws


def sample_ranges(index: int, stream: int, key: tuple) -> torch.Tensor:
    """The L of every sample that the last kernel call at (device, stream,
    shape) used, (N,) float32: a view of its workspace, for checks on the card."""
    ws = _workspaces[(index, stream) + key]
    off = _library().ssim_range_offset()
    return ws[off:off + 4 * key[0]].view(torch.float32)


def _kernel(y_pred, y_true, dims, w_size, size_average=True, full=False,
            per_sample_range=False, lib=None, rows=TILE):
    """The two launches of one call and the views of its result.  ``lib`` and
    ``rows``: another build of csrc/ssim.cu and another count of output rows
    a block, for the ablation (``probes.ssim_ablate``); the call is counted
    all the same."""
    global launches
    n, h, w, c, _, _, _, _ = dims
    if w_size not in _WINDOWS:
        raise ValueError(f"ssim: the kernel is built for windows {_WINDOWS}, not {w_size}")
    if n * c > _MAX_PLANES:
        raise ValueError(f"ssim: {n * c} planes exceed the kernel's {_MAX_PLANES}")
    if c > _MAX_PAIRS:
        raise ValueError(f"ssim: {c} channels exceed the kernel's {_MAX_PAIRS} a block")
    if smem_bytes(c, w_size) > _MAX_SMEM:
        raise ValueError(f"ssim: {c} channels need {smem_bytes(c, w_size)} bytes of shared "
                         f"memory a block, more than the card's {_MAX_SMEM}")
    lib = _library() if lib is None else lib
    x = y_pred if y_pred.dtype == torch.float32 and y_pred.is_contiguous() else (
        y_pred.float().contiguous())
    y = y_true if y_true.dtype == torch.float32 and y_true.is_contiguous() else (
        y_true.float().contiguous())
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    key = (n, h, w, c, w_size, strip_width(c), rows)
    ws = _workspace(lib, index, stream, key)
    out = torch.empty(2 if size_average else n + 1, dtype=torch.float32, device=x.device)

    from srcgan_tpu_torch.ops.kernels import build

    err = build.call_on_device(index, lib.ssim_launch, x.data_ptr(), y.data_ptr(),
                               _host_taps(w_size), ws.data_ptr(), out.data_ptr(), *key[:5],
                               key[5], rows, int(per_sample_range), int(size_average), stream)
    if err:
        raise RuntimeError(f"ssim launch failed: {lib.ssim_error_string(err).decode()}")
    launches += 1
    ret = out[0] if size_average else out[:n]
    if not full:
        return ret
    return ret, out[-1]


def ssim_fused(y_pred: torch.Tensor, y_true: torch.Tensor, w_size: int = 11,
               size_average: bool = True, full: bool = False,
               per_sample_range: bool = False):
    """SSIM of two NHWC batches: a scalar (``size_average``) or (N,) per-sample
    values (the mean over a sample's channels); with ``full`` also the
    contrast-structure mean.  ``per_sample_range`` detects the dynamic range
    per sample, as a one-sample-at-a-time evaluation would, and not over the
    batch.  CUDA tensors: the sm_90a kernel (raises if it cannot run).  CPU
    tensors: the plain version.

    The kernel takes w_size in {3, 5, 7, 9, 11}, N * C <= 65535 and, since
    its strips hold all C channels of a column, C <= 128 (a block's pairs),
    and at w_size = 11 C <= 120 (two chunks of 11 input rows of one column's
    C channels, x and y, fill a block's 232,448 bytes of shared memory
    beyond that).  It refuses the rest before it loads the library."""
    dims = _check(y_pred, y_true, w_size)
    if not y_pred.is_cuda:
        return ssim_reference(y_pred, y_true, w_size, size_average, full, per_sample_range)
    return _kernel(y_pred, y_true, dims, w_size, size_average, full, per_sample_range)
