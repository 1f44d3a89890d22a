"""Numerics mode of a forward pass: fp32 for parity, bf16 for throughput.

The JAX package selects a conv/matmul precision (``srcgan_tpu.config``); its
fp32 parity mode is XLA ``HIGHEST``.  On the card a float32 convolution goes
through cuDNN in TF32 by default, which keeps about three decimal digits, so
the port's fp32 mode turns TF32 off for convolutions AND matmuls for the
scope of the context.  bf16 mode leaves the backend flags alone: the tensors
themselves are bf16 and the kernels accumulate in fp32.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

# "tf32" keeps fp32 tensors and lets cuDNN and cuBLAS feed the tensor cores
# TF32: the card's counterpart of the JAX package's bf16 feed of fp32 tensors.
DTYPES = {"fp32": torch.float32, "tf32": torch.float32, "bf16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  ``None`` means ``torch.device("cuda")`` and raises where no card
    is present; nothing carries on on the CPU unasked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available: this entry point runs on the card by "
            'default; pass device="cpu" (--device cpu on the command line) to run '
            "on the CPU")
    return device


def cast_parameters(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast the module's floating parameters to ``dtype`` in place and leave
    its buffers as they are: BatchNorm's running statistics stay fp32, as the
    JAX package casts parameters only and keeps the model state in fp32
    (``module.to(dtype)`` would round them too).  Strides are kept."""
    for p in module.parameters():
        if p.is_floating_point() and p.dtype != dtype:
            p.data = p.data.to(dtype)
    return module


# The backend flags are process-wide: the open fp32 / tf32 scopes of every
# thread, oldest first, and the flags from before the first of them.  The
# newest open scope sets the flags, so a thread that leaves its scope while
# another thread's is open (the serve daemon's worker and a scene thread)
# does not turn TF32 back on under it.
_SCOPES_LOCK = threading.Lock()
_SCOPES: list = []
_BASE_FLAGS = None


def _set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on


@contextlib.contextmanager
def precision(mode: str):
    """Scope a numerics mode ("fp32" | "tf32" | "bf16") over the enclosed work."""
    global _BASE_FLAGS
    if mode not in DTYPES:
        raise ValueError(f"unknown precision {mode!r}; one of {sorted(DTYPES)}")
    if mode == "bf16":
        yield
        return
    scope = (object(), mode)
    with _SCOPES_LOCK:
        if not _SCOPES:
            _BASE_FLAGS = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
        _SCOPES.append(scope)
        _set_tf32(mode == "tf32")
    try:
        yield
    finally:
        with _SCOPES_LOCK:
            _SCOPES.remove(scope)
            if _SCOPES:
                _set_tf32(_SCOPES[-1][1] == "tf32")
            else:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _BASE_FLAGS


def constant_cache(fn):
    """``functools.lru_cache`` for a function that makes constant tensors
    (once per dtype and device), bypassed while ``torch.export`` traces: the
    tensors a trace makes are placeholders that must not outlive it."""
    cached = functools.lru_cache(maxsize=16)(fn)

    @functools.wraps(fn)
    def get(*args):
        return fn(*args) if torch.compiler.is_exporting() else cached(*args)

    return get
