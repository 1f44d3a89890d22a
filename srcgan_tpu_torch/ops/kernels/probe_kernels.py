"""The six tensor-core and data-movement probes: hand-written sm_90a kernels.

Ports of the Pallas TPU probe kernels of the JAX package's scripts, one
wrapper per probe function and beside each its plain PyTorch version:

    probe_matmul      scripts/pallas_matmul_probe.py::make_matmul
    probe_mxu         scripts/pallas_mxu_probe.py::make
    probe_dots        scripts/pallas_layout_probe3.py::probe_dots
    probe_concat_dot  scripts/pallas_layout_probe3.py::probe_concat_dot
    probe_roll        scripts/pallas_layout_probe3.py::probe_roll
    probe_stage1      scripts/pallas_layout_probe3.py::probe_stage1

Each is one call of ``csrc/probes.cu``: the loop of B dependent steps runs
inside the kernel, because it is what the probe measures.  ``probe_matmul``
in bf16 has a kernel of its own (a warp-specialised ``wgmma`` GEMM fed by TMA
loads, w read as it lies); its int8 form and the other dot probes share one
``mma.sync`` template, which first rearranges w into a scratch tensor.  A
wrapper launches its kernel for a CUDA tensor (and raises where the kernel does not
take the shape) and runs the plain version for a CPU tensor; there is no
fallback from one to the other.  ``launches[name]`` counts kernel launches.

The plain versions repeat the arithmetic step by step: bf16 operands with
fp32 sums (``x.float() @ w.float()``), int8 operands with exact integer sums,
the literal perturbation or selection between steps, the wrapping cast.
"""
from __future__ import annotations

import ctypes
import functools

import torch

NAMES = ("probe_matmul", "probe_mxu", "probe_dots", "probe_concat_dot", "probe_roll",
         "probe_stage1")
# Kernel launches by probe since import (or since a caller last set them to 0).
launches = dict.fromkeys(NAMES, 0)

_ROWS = 64                     # csrc/probes.cu kBM: rows of x per block
_WIDTHS = (64, 128, 192)       # the N the kernel is instantiated for
_SLICE_BYTES, _STAGE_ROW_BYTES = 256, 272   # kSliceBytes; 4 * kSliceStride
_MODES = {"plain": 0, "concat": 1, "twodots": 2, "im2col": 3, "shifted": 4}
_PERTURB = 1e-36               # the probes' scale of y[0,0] in the next operand
_ROLL_ADD = 1e-8               # probe_roll's added constant, rounded to bf16 first


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 sums for bf16 operands and exact int32 sums for int8
    (int32 matmul on the CPU; on a card float64, exact below 2^53)."""
    if x.dtype == torch.int8:
        if x.device.type == "cpu":
            return x.int() @ w.int()
        return (x.double() @ w.double()).to(torch.int32)
    return x.float() @ w.float()


def _int8_next(x: torch.Tensor) -> torch.Tensor:
    """clip(x + 1, -127, 127) as int8: the second operand of the int8 chain."""
    return (x.int() + 1).clamp(-127, 127).to(torch.int8)


def _perturb(x: torch.Tensor, y00: torch.Tensor) -> torch.Tensor:
    """x + bf16(y00 * 1e-36): numerically x, but a real dependency on y."""
    return x + (y00 * _PERTURB).to(x.dtype)


def probe_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M,K) @ (K,N), fp32 / int32 sums, cast to the input type (int8 wraps)."""
    return _dot(x, w).to(x.dtype)


def probe_mxu_reference(x: torch.Tensor, w: torch.Tensor, steps: int = 16) -> torch.Tensor:
    """``steps`` dependent dots: acc += x_b @ w; bf16: x_{b+1} = x_b + bf16(y00
    * 1e-36); int8: x_{b+1} = x if y00 is even else clip(x + 1, -127, 127),
    chosen from the first x every time.  Returns acc (fp32 or int32)."""
    is_int = x.dtype == torch.int8
    other = _int8_next(x) if is_int else None
    cur, acc = x, None
    for _ in range(steps):
        y = _dot(cur, w)
        acc = y if acc is None else acc + y
        if is_int:
            cur = torch.where((y[0, 0] & 1) == 0, x, other)
        else:
            cur = _perturb(cur, y[0, 0])
    return acc


def probe_dots_reference(x: torch.Tensor, w: torch.Tensor, steps: int = 16) -> torch.Tensor:
    """probe_mxu's bf16 form (the shallow-K sweep)."""
    return probe_mxu_reference(x, w, steps)


def probe_concat_dot_reference(a: torch.Tensor, w: torch.Tensor, steps: int = 8,
                               form: str = "concat") -> torch.Tensor:
    """``steps`` dependent [a, a * 0.5] @ w, w (128, N): as one K=128 dot of the
    concatenation ("concat") or as two K=64 dots ("twodots")."""
    half = a.shape[1]
    cur, acc = a, torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
    for _ in range(steps):
        if form == "concat":
            y = _dot(torch.cat([cur, cur * 0.5], dim=1), w)
        else:
            y = _dot(cur, w[:half]) + _dot(cur * 0.5, w[half:])
        acc = acc + y
        cur = _perturb(cur, y[0, 0])
    return acc


def _roll_constant() -> float:
    return float(torch.tensor(_ROLL_ADD, dtype=torch.float32).to(torch.bfloat16))


def probe_roll_reference(a: torch.Tensor, shift: int, steps: int = 16) -> torch.Tensor:
    """``steps`` dependent a = roll(a, shift, axis 0) + bf16(1e-8), rows wrapping."""
    c = _roll_constant()
    for _ in range(steps):
        a = torch.roll(a, shift, dims=0) + c
    return a


def tap_shifts(stride: int = 128) -> tuple:
    """Row shifts of the nine taps: dy in (-stride, 0, stride), dx in (-1, 0, 1)."""
    return tuple(dy + dx for dy in (-stride, 0, stride) for dx in (-1, 0, 1))


def probe_stage1_reference(x: torch.Tensor, w: torch.Tensor, steps: int = 4,
                           stride: int = 128) -> torch.Tensor:
    """``steps`` dependent stages: the nine rolled copies of x (M,64) side by
    side as (M,576), one K=576 dot with w (576,N), acc += y; rows wrap modulo
    M and nothing is zeroed at the edges."""
    cur, acc = x, torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32, device=x.device)
    for _ in range(steps):
        col = torch.cat([cur if s == 0 else torch.roll(cur, s, dims=0)
                         for s in tap_shifts(stride)], dim=1)
        y = _dot(col, w)
        acc = acc + y
        cur = _perturb(cur, y[0, 0])
    return acc


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """csrc/probes.cu, built at first use, with its C signatures declared."""
    from srcgan_tpu_torch.ops.kernels import build

    return declare(build.load("probes"))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a build of csrc/probes.cu (of a variant too)."""
    lib.probes_dots_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.probes_dots_launch.restype = ctypes.c_int
    lib.probes_matmul_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.probes_matmul_launch.restype = ctypes.c_int
    lib.probes_roll_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.probes_roll_launch.restype = ctypes.c_int
    lib.probes_error_string.argtypes = [ctypes.c_int]
    lib.probes_error_string.restype = ctypes.c_char_p
    return lib


def _check_pair(name: str, x: torch.Tensor, w: torch.Tensor, dtypes):
    if x.dim() != 2 or w.dim() != 2 or x.dtype != w.dtype or x.dtype not in dtypes:
        raise ValueError(f"{name}: expected 2-D operands of one type in {dtypes}, got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(w.shape)} {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"{name}: operands on {x.device} and {w.device}")


def check_shape(name: str, m: int, k: int, n: int, steps: int = 1, mode: str = "plain"):
    """Raise ValueError where csrc/probes.cu does not take the shape: M % 64,
    K % 32, N in (64, 128, 192), N = 192 in the forms other than plain."""
    if m % _ROWS or k % 32 or n not in _WIDTHS or steps < 1:
        raise ValueError(f"{name}: the kernel takes M % {_ROWS} == 0, K % 32 == 0 and N in "
                         f"{_WIDTHS}; got M={m}, K={k}, N={n}")
    if mode != "plain" and n != 192:
        raise ValueError(f"{name}: the kernel's {mode} form is built for N=192, got {n}")


def _check_contiguous(name: str, *tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the operands must be contiguous")


def _launch_dots(name: str, x: torch.Tensor, w: torch.Tensor, steps: int, cast_out: bool,
                 mode: str, stride: int = 0) -> torch.Tensor:
    """Check what csrc/probes.cu takes, allocate, launch, count."""
    m, (k, n) = x.shape[0], w.shape
    _check_contiguous(name, x, w)
    check_shape(name, m, k, n, steps, mode)
    lib = _library()
    is_int = x.dtype == torch.int8
    out_dtype = x.dtype if cast_out else (torch.int32 if is_int else torch.float32)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    # w in the kernel's staged form: slices of 256 bytes of k, N rows of 272 bytes each
    slices = -(-k * w.element_size() // _SLICE_BYTES)
    wt = torch.empty(slices * n * _STAGE_ROW_BYTES, dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.probes_dots_launch(x.data_ptr(), w.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                     m, k, n, steps, int(is_int), int(cast_out), _MODES[mode],
                                     stride, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.probes_error_string(err).decode()}")
    launches[name] += 1
    return out


def matmul_bf16(lib: ctypes.CDLL, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """probe_matmul's bf16 kernel in the build ``lib`` (the same shapes as the
    other dots, no scratch); no launch counted."""
    m, (k, n) = x.shape[0], w.shape
    _check_contiguous("probe_matmul", x, w)
    check_shape("probe_matmul", m, k, n)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("probe_matmul: the operands must be 16-byte aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.probes_matmul_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, stream)
    if err:
        raise RuntimeError(f"probe_matmul launch failed: {lib.probes_error_string(err).decode()}")
    return out


def _launch_matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    out = matmul_bf16(_library(), x, w)
    launches["probe_matmul"] += 1
    return out


def probe_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One (M,K) @ (K,N) dot fed from device memory, bf16 -> bf16 or int8 ->
    int8 (the int32 sum wraps).  CUDA tensors: the kernel; CPU: the plain version."""
    _check_pair("probe_matmul", x, w, (torch.bfloat16, torch.int8))
    if x.is_cuda:
        if x.dtype == torch.bfloat16:
            return _launch_matmul_bf16(x, w)
        return _launch_dots("probe_matmul", x, w, 1, True, "plain")
    return probe_matmul_reference(x, w)


def probe_mxu(x: torch.Tensor, w: torch.Tensor, steps: int = 16) -> torch.Tensor:
    """``steps`` dependent dots on operands that stay on the SM, bf16 -> fp32 or
    int8 -> int32.  CUDA tensors: the kernel; CPU: the plain version."""
    _check_pair("probe_mxu", x, w, (torch.bfloat16, torch.int8))
    if x.is_cuda:
        return _launch_dots("probe_mxu", x, w, steps, False, "plain")
    return probe_mxu_reference(x, w, steps)


def probe_dots(x: torch.Tensor, w: torch.Tensor, steps: int = 16) -> torch.Tensor:
    """probe_mxu's bf16 form under its own name and count (the shallow-K sweep)."""
    _check_pair("probe_dots", x, w, (torch.bfloat16,))
    if x.is_cuda:
        return _launch_dots("probe_dots", x, w, steps, False, "plain")
    return probe_dots_reference(x, w, steps)


def probe_concat_dot(a: torch.Tensor, w: torch.Tensor, steps: int = 8,
                     form: str = "concat") -> torch.Tensor:
    """``steps`` dependent [a, a * 0.5] @ w with a (M,64), w (128,N) bf16, as one
    stacked K=128 dot (form "concat") or two K=64 dots ("twodots"); fp32 out."""
    _check_pair("probe_concat_dot", a, w, (torch.bfloat16,))
    if form not in ("concat", "twodots"):
        raise ValueError(f"probe_concat_dot: form {form!r} is neither 'concat' nor 'twodots'")
    if w.shape[0] != 2 * a.shape[1]:
        raise ValueError(f"probe_concat_dot: w has {w.shape[0]} rows for a of {a.shape[1]} columns")
    if a.is_cuda:
        if a.shape[1] != 64:
            raise ValueError(f"probe_concat_dot: the kernel takes a of 64 columns, got {a.shape[1]}")
        return _launch_dots("probe_concat_dot", a, w, steps, False, form)
    return probe_concat_dot_reference(a, w, steps, form)


def probe_roll(a: torch.Tensor, shift: int, steps: int = 16) -> torch.Tensor:
    """``steps`` dependent roll(a, shift, axis 0) + bf16(1e-8) of a (M,C) bf16."""
    if a.dim() != 2 or a.dtype != torch.bfloat16:
        raise ValueError(f"probe_roll: expected a 2-D bf16 tensor, got {tuple(a.shape)} {a.dtype}")
    if not a.is_cuda:
        return probe_roll_reference(a, shift, steps)
    m, c = a.shape
    if not a.is_contiguous() or c % 8 or steps < 1:
        raise ValueError(f"probe_roll: the kernel takes a contiguous (M, C % 8 == 0), got {m}x{c}")
    lib = _library()
    out, buf = torch.empty_like(a), torch.empty_like(a)
    counter = torch.empty(1, dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.probes_roll_launch(a.data_ptr(), buf.data_ptr(), out.data_ptr(),
                                     counter.data_ptr(), m, c, shift % m, steps,
                                     _roll_constant(), stream)
    if err:
        raise RuntimeError(f"probe_roll launch failed: {lib.probes_error_string(err).decode()}")
    launches["probe_roll"] += 1
    return out


def probe_stage1(x: torch.Tensor, w: torch.Tensor, steps: int = 4, stride: int = 128,
                 form: str = "im2col") -> torch.Tensor:
    """``steps`` dependent stages of nine rolled copies of x (M,64) and one K=576
    dot with w (576,N), bf16 -> fp32.  form "im2col" gathers the copies into a
    tile in shared memory, as the TPU kernel does in VMEM; "shifted" reads the
    operand at shifted rows and builds nothing.  The same function either way."""
    _check_pair("probe_stage1", x, w, (torch.bfloat16,))
    if form not in ("im2col", "shifted"):
        raise ValueError(f"probe_stage1: form {form!r} is neither 'im2col' nor 'shifted'")
    if w.shape[0] != 9 * x.shape[1] or stride < 1:
        raise ValueError(f"probe_stage1: w has {w.shape[0]} rows for x of {x.shape[1]} columns")
    if x.is_cuda:
        if x.shape[1] != 64:
            raise ValueError(f"probe_stage1: the kernel takes x of 64 columns, got {x.shape[1]}")
        return _launch_dots("probe_stage1", x, w, steps, False, form, stride)
    return probe_stage1_reference(x, w, steps, stride)
