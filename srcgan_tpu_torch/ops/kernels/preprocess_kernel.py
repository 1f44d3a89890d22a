"""uint8 RGB -> (luma, bilinear 1/up luma) in one pass: a hand-written sm_90a kernel.

Port of ``srcgan_tpu.ops.pallas.preprocess_kernel.fused_gray_degrade``, the
input path of ``CasTrainer``'s uint8 steps with ``fused_input=True``:

    rgb     = tar_u8 / 255                      (N,H,W,3), never materialized
    real_BC = luma(rgb)                         (N,H,W,1)       fp32
    real_BA = mh . real_BC . mw                 (N,H/up,W/up,1) fp32

with mh, mw the bilinear sampling matrices of ``ops.resize``.  Each matrix
row has at most two non-zeros, so the wrapper turns the matrices into tap
tables (``taps``) and ``csrc/gray_degrade.cu`` applies them as two 2-tap
stencils, rows first and then columns, as the matrix products sum.  Block o
of image n owns output row o and the input rows ``strip(o, h, h2)``; it
forms low from the gray values it holds wherever a tap row is one of its
rows (``in_strip``: always, for an integer ratio) and from the bytes where
it is not.

``fused_gray_degrade`` launches the kernel for a CUDA tensor and runs the
plain version (``gray_degrade_reference``) for a CPU tensor; there is no
fallback from one to the other.  ``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from srcgan_tpu_torch.ops import color
from srcgan_tpu_torch.ops.resize import _apply_separable, _bilinear_matrix

# Kernel launches since import (or since a caller last set it to 0).
launches = 0

_MAX_SMEM = 232448         # csrc/gray_degrade.cu kMaxSmem: a block's rows of gray

def _check(tar_u8: torch.Tensor, up: int):
    if tar_u8.dtype != torch.uint8 or tar_u8.dim() != 4 or tar_u8.shape[-1] != 3:
        raise ValueError(f"gray_degrade: expected (N,H,W,3) uint8, got "
                         f"{tuple(tar_u8.shape)} {tar_u8.dtype}")
    if not tar_u8.is_contiguous():
        raise ValueError("gray_degrade: the input must be contiguous NHWC")
    n, h, w, _ = tar_u8.shape
    if up < 1 or h // up < 1 or w // up < 1:
        raise ValueError(f"gray_degrade: {h}x{w} cannot be degraded by 1/{up}")
    return n, h, w, h // up, w // up


def gray_degrade_reference(tar_u8: torch.Tensor, up: int):
    """Plain torch version: /255, luma, then the two matrix products (rows
    first).  Returns (real_BC (N,H,W,1), real_BA (N,H/up,W/up,1)), fp32."""
    _, h, w, _ = tar_u8.shape
    gray = color.rgb_to_gray(tar_u8.float() / 255.0)
    return gray, _apply_separable(gray, "bilinear", (h // up, w // up))


def taps(in_size: int, out_size: int):
    """(out, 2) int32 (lo, hi) and (out, 2) float32 (w_lo, w_hi) of the
    bilinear sampling matrix: the weights are the matrix entries themselves.
    A row with one non-zero gets hi = lo and w_hi = 0."""
    m = _bilinear_matrix(in_size, out_size)
    idx = np.zeros((out_size, 2), np.int32)
    wts = np.zeros((out_size, 2), np.float32)
    for d in range(out_size):
        nz = np.flatnonzero(m[d])
        if not 1 <= len(nz) <= 2 or nz[-1] - nz[0] > 1:
            raise AssertionError(f"bilinear row {d} of {in_size}->{out_size}: taps {nz}")
        idx[d] = nz[0], nz[-1]
        wts[d] = m[d, nz[0]], (m[d, nz[-1]] if len(nz) == 2 else 0.0)
    return idx, wts


def strip(o: int, h: int, h2: int):
    """The input rows [begin, end) that the kernel's block of output row o
    owns: the blocks partition the image, the last one down to row h."""
    return o * h // h2, h if o + 1 == h2 else (o + 1) * h // h2


def in_strip(h: int, h2: int) -> np.ndarray:
    """(h2, 2) bool: whether output row o's (lo, hi) tap rows lie in its own
    block's rows, so that the block reads them from what it holds."""
    idx, _ = taps(h, h2)
    bounds = np.array([strip(o, h, h2) for o in range(h2)])
    return (idx >= bounds[:, :1]) & (idx < bounds[:, 1:])


def smem_bytes(h: int, w: int, h2: int) -> int:
    """Shared memory of a block: the most input rows a block owns
    (ceil(h / h2)) of w floats, and 3 of alignment (csrc/gray_degrade.cu
    gray_degrade_smem_bytes)."""
    return (-(-h // h2) * w + 4) * 4


@functools.lru_cache(maxsize=64)
def _tables(h: int, w: int, h2: int, w2: int, index: int):
    """The row and column tap tables on device ``index``, and their pointers."""
    dev = torch.device("cuda", index)
    tables = [torch.from_numpy(t).to(dev) for t in (*taps(h, h2), *taps(w, w2))]
    return tables, tuple(t.data_ptr() for t in tables)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """csrc/gray_degrade.cu, built at first use, with its C signatures declared."""
    from srcgan_tpu_torch.ops.kernels import build

    lib = build.load("gray_degrade")
    lib.gray_degrade_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.gray_degrade_launch.restype = ctypes.c_int
    lib.gray_degrade_error_string.argtypes = [ctypes.c_int]
    lib.gray_degrade_error_string.restype = ctypes.c_char_p
    return lib


def _kernel(tar_u8: torch.Tensor, up: int):
    global launches
    n, h, w, h2, w2 = _check(tar_u8, up)
    if smem_bytes(h, w, h2) > _MAX_SMEM:
        raise ValueError(f"gray_degrade: {-(-h // h2)} rows of width {w} exceed a block's "
                         f"{_MAX_SMEM} bytes of shared memory")
    if n > 65535:
        raise ValueError(f"gray_degrade: a batch of {n} exceeds the kernel's 65535")
    lib = _library()
    dev = tar_u8.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _, ptrs = _tables(h, w, h2, w2, index)
    # both outputs in one allocation: gray, then low
    buf = torch.empty(n * h * w + n * h2 * w2, dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(index)

    from srcgan_tpu_torch.ops.kernels import build

    at = buf.data_ptr()
    err = build.call_on_device(index, lib.gray_degrade_launch, tar_u8.data_ptr(), *ptrs, at,
                               at + 4 * n * h * w, n, h, w, h2, w2, stream)
    if err:
        raise RuntimeError(
            f"gray_degrade launch failed: {lib.gray_degrade_error_string(err).decode()}")
    launches += 1
    return buf[:n * h * w].view(n, h, w, 1), buf[n * h * w:].view(n, h2, w2, 1)


def fused_gray_degrade(tar_u8: torch.Tensor, up: int):
    """uint8 NHWC RGB (N,H,W,3) -> (real_BC (N,H,W,1), real_BA (N,H//up,W//up,1)),
    fp32.  CUDA tensor: the sm_90a kernel (raises if it cannot run).  CPU
    tensor: the plain version."""
    if tar_u8.is_cuda:
        return _kernel(tar_u8, up)
    _check(tar_u8, up)
    return gray_degrade_reference(tar_u8, up)
