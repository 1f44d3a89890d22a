"""Shared building blocks of the SR models, as in ``srcgan_tpu.models.blocks``.

NCHW ``nn.Module``s whose attribute names are the reference torch names, so
state_dicts exported by ``srcgan_tpu.interop.export_torch_state_dict`` load
with ``strict=True``.

ResidualDenseBlock5 has four forward schedules, scoped with
``rdb5_schedule``: "naive" (the literal concat chain, cuDNN's convolutions on
the card, and nothing else), "grouped" (one convolution per source, the plain
form of what the fused kernel computes), "fused" (an eval block whose input
the kernel's gate accepts goes through
``ops.kernels.rdb5_kernel.rdb5_bf16_fused``, everything else through the
grouped form) and "auto", the default, which is what runs when nothing is
scoped: a forward on the card that the kernel can take (eval mode, bf16, a
shape its gate accepts, no gradient asked for) goes through the kernel, the
faster route there (PERF.md); every CPU forward and every fp32, training or
other-shaped forward takes the naive form.  All are the same function up to
the order of float sums.  A yardstick that means cuDNN scopes "naive".  The
JAX package's "paired" schedule shaped the work for the TPU's matrix unit and
is not ported.

On a strip of ``parallel.spatial`` the kernel runs on the strip plus the 5
rows each side that its five chained convolutions need, exchanged once, and
the block crops them, where that extended strip passes the gate.  Under
``tensor_parallel()`` (``parallel.tp``) every block takes the naive form: a
channel slice of its convolutions cannot go through a kernel that needs the
block's whole weights, and each per-conv call is a split convolution.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from srcgan_tpu_torch import quant
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.ops.kernels import rdb5_kernel

DEFAULT_RDB5_SCHEDULE = "auto"
_SCHEDULES = ("auto", "naive", "grouped", "fused")
_SCHED_TL = threading.local()


@contextlib.contextmanager
def rdb5_schedule(name: str):
    """Scoped override of the RDB5 forward schedule for forwards in this thread."""
    if name not in _SCHEDULES:
        raise ValueError(f"unknown RDB5 schedule {name!r}; one of {_SCHEDULES}")
    prev = getattr(_SCHED_TL, "value", None)
    _SCHED_TL.value = name
    try:
        yield
    finally:
        _SCHED_TL.value = prev


def current_rdb5_schedule() -> str:
    return getattr(_SCHED_TL, "value", None) or DEFAULT_RDB5_SCHEDULE


# Whether a tensor_parallel scope is open: process-wide, as a recompute of a
# checkpointed pass may run in another thread
_TP = False


@contextlib.contextmanager
def tensor_parallel():
    """Scope of ``parallel.tp``'s steps: the RDB5 blocks take their per-conv
    form and RDDBNet's tail its unfolded deconvs and conv_last, so that
    every convolution is a module call that a split layer can take."""
    global _TP
    prev, _TP = _TP, True
    try:
        yield
    finally:
        _TP = prev


def in_tensor_parallel() -> bool:
    return _TP


def strip_scope():
    """The ``parallel.spatial`` scope of this thread's forward, or None (the
    module is not even imported where no strip ever ran)."""
    sp = sys.modules.get("srcgan_tpu_torch.parallel.spatial")
    return None if sp is None else sp.current()


def get_deconv_params(upscale_factor: int) -> Tuple[int, int, int]:
    """(kernel, stride, output_padding) per upscale factor: x2->(2,2,0),
    x4->(2,4,2), x8->(4,8,4).  H_out = H_in * upscale_factor."""
    if upscale_factor == 2:
        k, s = 2, 2
    elif upscale_factor == 4:
        k, s = 2, 4
    elif upscale_factor == 8:
        k, s = 4, 8
    else:
        raise ValueError(f"unsupported upscale factor {upscale_factor}")
    return k, s, s - k


def deconv(in_ch: int, out_ch: int, upscale_factor: int = 2) -> nn.ConvTranspose2d:
    """Bias-free transposed conv with the reference deconv spec."""
    k, s, opad = get_deconv_params(upscale_factor)
    return nn.ConvTranspose2d(in_ch, out_ch, k, s, padding=0, output_padding=opad,
                              bias=False)


class ResidualDenseBlock5(nn.Module):
    """5-conv dense block: conv_i sees concat(x, x1..x_{i-1}); output
    conv5(...) * 0.2 + x.  Channel growth nf -> nf+4*gc."""

    def __init__(self, nf: int = 64, gc: int = 32, bias: bool = True):
        super().__init__()
        self.nf, self.gc = nf, gc
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(nf + i * gc, gc if i < 4 else nf, 3, 1, 1, bias=bias))
        self._prepared = (None, None)     # (key, bf16 kernel operands)

    def convs(self):
        """[(weight, bias)] of conv1..conv5, the kernel's view of the block."""
        return [(c.weight, c.bias) for c in (getattr(self, f"conv{i + 1}") for i in range(5))]

    def weights_key(self):
        """Changes when a weight's version, storage, dtype or device does;
        None while ``torch.export`` traces (its tensors have no storage)."""
        if torch.compiler.is_exporting():
            return None
        return tuple((t._version, t.data_ptr(), t.dtype, t.device)
                     for pair in self.convs() for t in pair if t is not None)

    def forward(self, x, lemda: float = 0.2):
        if _TP:
            return self.forward_with_sources(x, lemda)[0]
        if not self.training and lemda == 0.2:  # the int8 dispatch is for the default lemda
            y = quant.rdb5_dispatch(self, x)
            if y is not None:  # int8 serving: the whole block in one kernel
                return y
        sched = current_rdb5_schedule()
        if sched == "auto":
            # on the card the kernel, where it can take the forward; else the naive form
            wants_grad = torch.is_grad_enabled() and (x.requires_grad
                                                      or self.conv1.weight.requires_grad)
            if x.is_cuda and not wants_grad:
                y = self._kernel_or_none(x, lemda)
                if y is not None:
                    return y
            sched = "naive"
        if sched == "fused":
            return self._forward_fused(x, lemda)
        if sched == "grouped":
            return self._forward_grouped(x, lemda)
        return self.forward_with_sources(x, lemda)[0]

    def forward_with_sources(self, x, lemda: float = 0.2):
        """Naive forward (the literal concat chain) that also returns the
        stage-5 concat [x, x1..x4], the tensor whose per-channel absmax
        calibrates the fused int8 kernel (``quant.rdb5_dispatch``)."""
        feats = [x]
        for i in range(1, 5):
            conv = getattr(self, f"conv{i}")
            feats.append(F.leaky_relu(conv(torch.cat(feats, 1)), 0.2))
        cat = torch.cat(feats, 1)
        return self.conv5(cat) * lemda + x, cat

    def _forward_grouped(self, x, lemda: float = 0.2):
        """Source-grouped form: conv_i(concat(x, x1..x_{i-1})) decomposes over
        input slices, so each source tensor does ONE convolution that gives
        its contributions to all later stages (output widths 192, 160, 128,
        96, 64).  Same parameters as the naive form; only the order of float
        sums differs."""
        nf, gc = self.nf, self.gc
        ws = [w for w, _ in self.convs()]
        bs = [b for _, b in self.convs()]

        def grouped(s: int):
            """Source s's input slice of conv_{s+1}..conv5, concatenated on out-ch."""
            lo, hi = (0, nf) if s == 0 else (nf + (s - 1) * gc, nf + s * gc)
            return torch.cat([ws[i][:, lo:hi] for i in range(s, 5)], 0)

        def act(pre, i):
            return F.leaky_relu(pre if bs[i] is None else pre + bs[i].view(1, -1, 1, 1), 0.2)

        pre = list(F.conv2d(x, grouped(0), None, 1, 1).split([gc] * 4 + [nf], 1))
        for s in range(1, 5):
            src = act(pre[s - 1], s - 1)
            parts = F.conv2d(src, grouped(s), None, 1, 1).split([gc] * (4 - s) + [nf], 1)
            for k, part in enumerate(parts):
                pre[s + k] = pre[s + k] + part
        x5 = pre[4] if bs[4] is None else pre[4] + bs[4].view(1, -1, 1, 1)
        return x5 * lemda + x

    def _kernel_takes(self, x, extra_rows: int = 0) -> bool:
        """The gate of the bf16 kernel: eval mode, bf16, a supported shape
        (with ``extra_rows`` of halo)."""
        n, c, h, w = x.shape
        return (not self.training and x.dtype == torch.bfloat16
                and rdb5_kernel.supported((n, h + extra_rows, w, c), self.nf, self.gc))

    def _kernel_or_none(self, x, lemda: float):
        """The kernel's forward where its gate takes x, on a strip x plus its
        5-row halo; else None."""
        sc = strip_scope()
        if sc is None:
            return self._forward_kernel(x, lemda) if self._kernel_takes(x) else None
        halo = 5 * ((sc.prev is not None) + (sc.next is not None))
        if not sc.active or not self._kernel_takes(x, halo):
            return None
        return sc.halo_unit(x, 5, 5, lambda e: self._forward_kernel(e, lemda), symmetric=True)

    def _forward_fused(self, x, lemda: float = 0.2):
        y = self._kernel_or_none(x, lemda)
        return self._forward_grouped(x, lemda) if y is None else y

    def _forward_kernel(self, x, lemda: float = 0.2):
        key = self.weights_key()
        if key is None:                  # a torch.export trace: build, keep nothing
            weights = rdb5_kernel.prep_bf16(self.convs())
        else:
            if self._prepared[0] != key:
                self._prepared = (key, rdb5_kernel.prep_bf16(self.convs()))
            weights = self._prepared[1]
        y = rdb5_kernel.rdb5_bf16_fused(to_nhwc(x).contiguous(), weights, lemda)
        return to_nchw(y)


class RRDB(nn.Module):
    """Residual-in-residual dense block: 3 x RDB5, out * 0.2 + x.

    ``remat`` is instance-scoped: when True and a gradient is being
    recorded, the block's forward runs under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so its
    inner activations are recomputed in the backward instead of stored.  The
    GAN trainer sets it on its own generators (``set_trunk_remat``); other
    models in the process keep theirs.  The non-reentrant form runs its
    first forward with the caller's grad mode, so a training forward never
    reaches the RDB5 kernel's gate (which refuses gradients) on one pass and
    cuDNN on the recompute."""

    def __init__(self, nf: int, gc: int = 32):
        super().__init__()
        self.remat = False
        self.RDB1 = ResidualDenseBlock5(nf, gc)
        self.RDB2 = ResidualDenseBlock5(nf, gc)
        self.RDB3 = ResidualDenseBlock5(nf, gc)

    def _run(self, x, lemda: float):
        return self.RDB3(self.RDB2(self.RDB1(x))) * lemda + x

    def forward(self, x, lemda: float = 0.2):
        # remat is value-neutral: int8 calibration records the plain forward
        if self.remat and torch.is_grad_enabled() and not quant.is_calibrating():
            return checkpoint(self._run, x, lemda, use_reentrant=False)
        return self._run(x, lemda)


def rrdb_trunk(nf: int, nb: int, gc: int = 32) -> nn.Sequential:
    """nb RRDBs in sequence."""
    return nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])


def set_trunk_remat(module: nn.Module, flag: bool) -> int:
    """Set ``remat`` on every RRDB inside ``module``; returns how many."""
    n = 0
    for m in module.modules():
        if isinstance(m, RRDB):
            m.remat = flag
            n += 1
    return n
