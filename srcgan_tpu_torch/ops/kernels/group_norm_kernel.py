"""GroupNorm over bf16 NHWC activations with fp32 statistics, and an optional
residual add and ReLU after it: a hand-written sm_90a kernel.

It replaces no TPU kernel: the JAX package leaves ``srcgan_tpu.ops.norm.
group_norm`` to XLA, which fuses the fp32 statistics, the affine map and
the casts.  In eager PyTorch the same function cast the bf16 channels_last
activation to fp32, normalised it as contiguous NCHW, cast it back, and ran
the colorizer's ReLU and residual add as passes of their own.
``csrc/group_norm.cu`` reads x twice (statistics, then apply) and the
residual once and writes y once, in bf16:

    y = relu?(x_hat * gamma + beta + residual?)     statistics, affine and
                                                    epilogue in fp32, one
                                                    rounding to bf16

One rule and one launch: ``eligible`` says whether the kernel takes a call
(it follows the input alone), ``launch`` runs it for a call ``eligible``
admitted, checking nothing, and ``group_norm`` is the checked entry, which
raises where ``eligible`` refuses.  ``ops.norm.GroupNorm`` takes ``launch``
where ``eligible`` admits its call and its plain path otherwise; nothing
falls back from the kernel to the plain path after a failure.  All take x
(N,C,H,W) in channels_last memory, as the models hold it; an NHWC tensor's
``permute(0, 3, 1, 2)`` is such a view.  ``group_norm_reference`` is the
plain version, over NHWC as the JAX function.  ``launches`` counts the
kernel's calls (two device kernels each), ``plain_calls`` the ``GroupNorm``
module calls that took the plain path.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc

# Kernel calls, and GroupNorm module calls on the plain path, since import
# (or since a caller last set them to 0).
launches = 0
plain_calls = 0

VEC = 8                  # csrc/group_norm.cu kVec: channels a thread loads at once
MAX_VECTORS = 256        # csrc/group_norm.cu kThreads: vectors of a pixel a block holds


@functools.lru_cache(maxsize=256)
def supported(channels: int, num_groups: int) -> bool:
    """Whether the kernel takes ``channels`` in ``num_groups`` groups: whole
    16-byte vectors of channels, each inside one group or holding whole
    groups."""
    if channels <= 0 or channels % VEC or channels // VEC > MAX_VECTORS:
        return False
    if num_groups <= 0 or channels % num_groups:
        return False
    per = channels // num_groups
    return VEC % per == 0 if per <= VEC else per % VEC == 0


def eligible(x: torch.Tensor, weight, bias, num_groups: int, residual=None) -> bool:
    """Whether the kernel takes a GroupNorm over x: x a plain CUDA tensor
    (not a subclass: the fake and functional tensors of a trace have no
    data), (N,C,H,W) bf16 in channels_last memory, 16-byte aligned, of a
    width the kernel takes; a residual alike; gamma and beta (C,) bf16 on
    x's device; no gradient asked for; no torch-function mode (a strip of
    ``parallel.spatial`` intercepts ``F.group_norm``; ``PlainGroupNorm``)
    and no trace of ``torch.compile`` or ``torch.export`` (an artifact holds
    no call into this package)."""
    if (type(x) is not torch.Tensor or not x.is_cuda or x.dtype != torch.bfloat16
            or x.dim() != 4 or torch._C._len_torch_function_stack()
            or torch.compiler.is_compiling() or torch.compiler.is_exporting()):
        return False
    shape = x.shape
    c = shape[1]
    if (shape[0] > 65535 or not supported(c, num_groups) or x.data_ptr() % 16
            or not x.is_contiguous(memory_format=torch.channels_last)):
        return False
    dev, grad = x.device, torch.is_grad_enabled()
    if grad and x.requires_grad:
        return False
    if residual is not None and (
            type(residual) is not torch.Tensor or residual.dtype != x.dtype
            or residual.shape != shape or residual.device != dev
            or residual.data_ptr() % 16
            or not residual.is_contiguous(memory_format=torch.channels_last)
            or grad and residual.requires_grad):
        return False
    for t in (weight, bias):
        if (t is None or t.dtype != torch.bfloat16 or t.device != dev or t.dim() != 1
                or t.shape[0] != c or not t.is_contiguous() or grad and t.requires_grad):
            return False
    return True


class PlainGroupNorm(TorchFunctionMode):
    """A torch-function mode that passes every call through: under it
    ``eligible`` refuses every call, so each ``GroupNorm`` takes its plain
    path, as inside a strip of ``parallel.spatial``.  The comparisons of the
    kernel's path with the plain one run the plain side under it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def group_norm_reference(x, weight, bias, num_groups: int = 32, eps: float = 1e-5,
                         residual=None, relu: bool = False):
    """Plain torch version over x (N,H,W,C): statistics, affine map, the
    residual add and the ReLU in fp32 (float64 stays), one cast back."""
    dt = torch.promote_types(x.dtype, torch.float32)
    y = to_nhwc(F.group_norm(to_nchw(x).to(dt), num_groups,
                             None if weight is None else weight.to(dt),
                             None if bias is None else bias.to(dt), eps))
    if residual is not None:
        y = y + residual.to(dt)
    if relu:
        y = F.relu(y)
    return y.to(x.dtype)


def ulps_apart(got, x, weight, bias, num_groups: int = 32, eps: float = 1e-5,
               residual=None, relu: bool = False) -> float:
    """How far bf16 ``got`` lies from the plain version over x (N,H,W,C): the
    largest gap over one bf16 ulp of the plain value plus fp32's rounding of
    the operands (2^-18 of |x * a| + |mean * a| + |beta| + |residual|, a =
    gamma * rstd), which another order of fp32 sums moves.  At most 1 where
    got is the same fp32 function rounded once."""
    want = group_norm_reference(x, weight, bias, num_groups, eps, residual, relu).float()
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
    a = torch.rsqrt(var + eps) * (1.0 if weight is None else
                                  weight.float().view(1, 1, num_groups, -1))
    beta = 0.0 if bias is None else bias.float().view(1, 1, num_groups, -1).abs()
    scale = ((xf * a).abs() + (mean * a).abs() + beta).reshape(x.shape)
    if residual is not None:
        scale = scale + residual.float().abs()
    _, exponent = torch.frexp(want.abs().clamp_min(2.0 ** -126))
    allowed = torch.ldexp(torch.ones_like(want), exponent - 8) + scale * 2.0 ** -18
    return ((got.float() - want).abs() / allowed).max().item()


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """csrc/group_norm.cu, built at first use, with its C signatures declared."""
    from srcgan_tpu_torch.ops.kernels import build

    lib = build.load("group_norm")
    lib.group_norm_chunks.argtypes = [ctypes.c_int] * 4
    lib.group_norm_chunks.restype = ctypes.c_int
    lib.group_norm_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                                      + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                              ctypes.c_void_p])
    lib.group_norm_launch.restype = ctypes.c_int
    lib.group_norm_error_string.argtypes = [ctypes.c_int]
    lib.group_norm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=256)
def scratch_floats(n: int, hw: int, c: int, num_groups: int) -> int:
    """fp32 words of the statistics pass's partials at this shape: a
    (count, mean, M2) a group of each of a sample's chunks."""
    chunks = _library().group_norm_chunks(n, hw, c, num_groups)
    if chunks <= 0:
        raise ValueError(f"group_norm: the kernel does not take (n={n}, hw={hw}, c={c}, "
                         f"groups={num_groups})")
    return 3 * n * chunks * num_groups


def launch(x, weight, bias, num_groups: int = 32, eps: float = 1e-5, residual=None,
           relu: bool = False):
    """The kernel over x (N,C,H,W) in channels_last memory, then + residual
    and ReLU where asked, on x's current stream, for a call that ``eligible``
    admitted: it checks nothing.  y is allocated as x is, channels_last."""
    global launches
    lib = _library()
    n, c, h, w = x.shape
    words = scratch_floats(n, h * w, c, num_groups)
    index = x.get_device()
    y = torch.empty_like(x)
    scratch = torch.empty(words, dtype=torch.float32, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(index)

    from srcgan_tpu_torch.ops.kernels import build

    err = build.call_on_device(index, lib.group_norm_launch, x.data_ptr(),
                               None if residual is None else residual.data_ptr(),
                               weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                               scratch.data_ptr(), words, n, h * w, c, num_groups, eps,
                               int(relu), stream)
    if err:
        raise RuntimeError(
            f"group_norm launch failed: {lib.group_norm_error_string(err).decode()}")
    launches += 1
    return y


def group_norm(x, weight, bias, num_groups: int = 32, eps: float = 1e-5, residual=None,
               relu: bool = False):
    """``launch``, checked: raises ValueError on a call the kernel does not
    take (``eligible``)."""
    if not eligible(x, weight, bias, num_groups, residual):
        raise ValueError(
            f"group_norm: the kernel does not take x {type(x).__name__} {tuple(x.shape)} "
            f"{x.dtype} on {x.device} in {num_groups} groups (residual "
            f"{None if residual is None else (tuple(residual.shape), residual.dtype)}, gamma "
            f"{None if weight is None else weight.dtype}, beta "
            f"{None if bias is None else bias.dtype}, gradient "
            f"{torch.is_grad_enabled()}): it takes a bf16 (N,C,H,W) CUDA tensor in "
            f"channels_last memory, 16-byte aligned, whole vectors of {VEC} channels, each in "
            f"one group or holding whole groups, at most {VEC * MAX_VECTORS} channels and "
            f"65535 samples, a residual alike, (C,) bf16 gamma and beta, no gradient asked "
            f"for and no torch-function mode or trace")
    return launch(x, weight, bias, num_groups, eps, residual, relu)
