"""Post-training int8 quantization of the inference cascade, as ``srcgan_tpu.quant``.

Scheme: symmetric int8.
  - activations: per-callsite, per-input-channel scales from a calibration
    pass (absmax over the calibration batches);
  - weights: the input scale folded in, then per-output-channel scales
    (max|w| / 127 over kh, kw, cin), from the fp32 weights.

Mechanism: ``quant_mode`` is a scoped dispatch point for every 2-d
convolution of the enclosed forward, whether an ``nn.Conv2d`` module or
``ops.conv.conv2d`` (both reach ``torch.nn.functional.conv2d``, which a
``TorchFunctionMode`` sees in call order).  Nothing is patched and the state
is per thread: two threads may each run a quantized forward at once, and a
nested block on one thread raises (it would break the callsite counter).

  calibrate  record each callsite's input absmax, keyed by call order;
  int8       quantize the input with the calibrated scale, convolve the int8
             values exactly, dequantize, add the bias.

Convolutions with fewer than ``MIN_QUANT_CH`` channels on either side (first
and last layers), grouped convolutions and transposed convolutions stay in
float.  An eval ``ResidualDenseBlock5`` whose shape the fused kernel accepts is
ONE callsite (``rdb5_dispatch``): its calibration record is the per-channel
absmax of the dense concat [x, x1..x4], and in int8 mode the whole block runs
in ``ops.kernels.rdb5_kernel.rdb5_int8_fused``.  The gate depends on shapes
alone, so the calibrate and int8 passes count callsites alike.

torch has no integer convolution.  The int8 values are convolved in float64,
where every sum of up to 2^38 products of int8 pairs is an exact integer
whatever the order of the sums (fp32 is exact only up to 9*Cin*127^2 < 2^24,
Cin <= 115); the result is rounded, which absorbs a card algorithm that does
not sum plain products.

No host work per int8 forward: the quantized weights and the scales of a
callsite are device tensors, built at its first int8 call and kept in the
``prepared`` dict the caller hands to every ``quant_mode("int8", ...)``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.ops.kernels import rdb5_kernel

# channels below which a convolution is left in float (Cin and Cout gate)
MIN_QUANT_CH = 16

_TL = threading.local()      # .ctx: this thread's active quant_mode, or None


def _active() -> Optional["quant_mode"]:
    return getattr(_TL, "ctx", None)


def is_calibrating() -> bool:
    """True inside a quant_mode('calibrate') block (this thread)."""
    ctx = _active()
    return ctx is not None and ctx.mode == "calibrate"


def _quantizable(w, groups) -> bool:
    """w: (Cout, Cin // groups, kh, kw)."""
    return w.shape[1] >= MIN_QUANT_CH and w.shape[0] >= MIN_QUANT_CH and groups == 1


def _tensor_key(*tensors):
    return tuple((t._version, t.data_ptr(), t.dtype, t.device) for t in tensors if t is not None)


def _record(scales: Dict[int, np.ndarray], i: int, x_nchw) -> None:
    """Fold x's per-channel absmax into callsite i's record (waits for the device)."""
    amax = x_nchw.detach().abs().amax(dim=(0, 2, 3)).float().cpu().numpy()
    prev = scales.get(i)
    scales[i] = amax if prev is None else np.maximum(prev, amax)


def int_conv2d(x_q, w_q, stride=1, padding=0, dilation=1):
    """Exact convolution of integer-valued tensors: x_q (N,C,H,W) in any float
    type, w_q (O,C,kh,kw) float64.  Returns the integer sums as float64."""
    return torch.round(F.conv2d(x_q.double(), w_q, None, stride, padding, dilation))


class quant_mode(TorchFunctionMode):
    """Context manager that routes the enclosed forward's convolutions through
    the calibrate or the int8 path.

    The callsite counter starts at 0 on entry, so one ``with`` block covers
    exactly one forward.  ``scales``: callsite index -> absmax, numpy (filled
    in calibrate mode, read in int8 mode).  ``prepared``: a dict the caller
    keeps between int8 forwards of ONE (weights, scales) pair; it holds each
    callsite's device operands, so that only the first forward builds them and
    copies scales from the host.  Entering while this thread already holds a
    block raises RuntimeError; other threads are independent.
    """

    def __init__(self, mode: str, scales: Dict[int, np.ndarray],
                 prepared: Optional[dict] = None):
        super().__init__()
        if mode not in ("calibrate", "int8"):
            raise ValueError(f"unknown quant mode {mode!r}; one of calibrate, int8")
        self.mode: Optional[str] = mode
        self.scales = scales
        self.prepared = {} if prepared is None else prepared
        self.idx = 0

    def __enter__(self):
        if _active() is not None:
            raise RuntimeError(
                "quant_mode is already active on this thread: a nested block would "
                "restart the callsite counter under the outer forward")
        self.idx = 0
        super().__enter__()
        _TL.ctx = self
        return self

    def __exit__(self, *exc):
        _TL.ctx = None
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def paused(self):
        """Convolutions inside run in float and count no callsite."""
        mode, self.mode = self.mode, None
        try:
            yield
        finally:
            self.mode = mode

    def next_callsite(self) -> int:
        i = self.idx
        self.idx += 1
        return i

    def scale_of(self, i: int, what: str) -> np.ndarray:
        amax = self.scales.get(i)
        if amax is None:
            raise RuntimeError(f"int8 {what} callsite {i} has no calibration scale: call "
                               f"calibrate() with representative inputs of the same shape first")
        return np.asarray(amax, np.float32)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.conv2d and self.mode is not None:
            return self._conv2d(*args, **kwargs)
        return func(*args, **kwargs)

    def _conv2d(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        if not _quantizable(w, groups):
            return F.conv2d(x, w, b, stride, padding, dilation, groups)
        i = self.next_callsite()
        if self.mode == "calibrate":
            # per INPUT CHANNEL: a dense-chain conv sees concatenated sources
            # of very different ranges
            _record(self.scales, i, x)
            return F.conv2d(x, w, b, stride, padding, dilation, groups)
        s_x, w_q, s_w, bias = self._conv_operands(i, w, b)
        x_q = torch.round(x.float() / s_x).clamp(-127, 127)
        y = int_conv2d(x_q, w_q, stride, padding, dilation).float() * s_w
        return y if bias is None else y + bias

    def _conv_operands(self, i: int, w, b):
        """(s_x, w_q as float64, s_w, bias) of callsite i on w's device, each
        shaped to broadcast over NCHW.  s_x is copied from the host once per
        callsite; the rest is rebuilt only when the weight tensor changes."""
        slot = self.prepared.setdefault(("conv", i), {})
        if "s_x" not in slot:
            amax = self.scale_of(i, "conv")
            if amax.shape != (w.shape[1],):
                raise RuntimeError(f"int8 conv callsite {i}: the calibration has "
                                   f"{amax.shape[0]} channels, the weight {w.shape[1]}")
            s_x = torch.from_numpy(np.maximum(amax, 1e-8) / 127.0).to(w.device)
            slot["s_x"] = s_x.view(1, -1, 1, 1)
        key = _tensor_key(w, b)
        if slot.get("key") != key:
            with torch.no_grad():
                # sum_c x[c] w[o,c] = sum_c x_q[c] * (s_x[c] w[o,c]): fold the input
                # scale into the weight, then one scale per output channel
                w_eff = w.float() * slot["s_x"]
                s_w = (w_eff.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0).clamp_min(1e-30)
                slot["w_q"] = torch.round(w_eff / s_w).clamp(-127, 127).double()
                slot["s_w"] = s_w.view(1, -1, 1, 1)
                slot["bias"] = None if b is None else b.float().view(1, -1, 1, 1)
            slot["key"] = key
        return slot["s_x"], slot["w_q"], slot["s_w"], slot["bias"]

    def rdb5_operands(self, i: int, block) -> rdb5_kernel.Int8Weights:
        """Callsite i's kernel operands for ``block``, built once per weight set."""
        slot = self.prepared.setdefault(("rdb5", i), {})
        key = block.weights_key()
        if slot.get("key") != key:
            amax = self.scale_of(i, "RDB5")
            device = block.conv1.weight.device
            slot["weights"] = rdb5_kernel.prep_int8(
                block.convs(), torch.from_numpy(amax).to(device))
            slot["key"] = key
        return slot["weights"]


def rdb5_dispatch(block, x):
    """Hook at the top of ``ResidualDenseBlock5.forward`` (x NCHW).  Returns
    the block's output when the quantized fused path handles it, else None
    (the caller runs its regular schedule)."""
    ctx = _active()
    if ctx is None or ctx.mode is None or block.training:
        return None
    n, c, h, w = x.shape
    if not rdb5_kernel.supported((n, h, w, c), block.nf, block.gc):
        return None
    i = ctx.next_callsite()
    if ctx.mode == "calibrate":
        # the naive chain with quantization off; the concat's per-channel
        # absmax is this block's single record
        with ctx.paused():
            y, cat = block.forward_with_sources(x)
        _record(ctx.scales, i, cat)
        return y
    weights = ctx.rdb5_operands(i, block)
    with ctx.paused():
        y = rdb5_kernel.rdb5_int8_fused(to_nhwc(x).float().contiguous(), weights)
    return to_nchw(y).to(x.dtype)


def calibrate_fn(fn: Callable, batches: Iterable) -> Dict[int, np.ndarray]:
    """Run ``fn(batch)`` over the calibration batches, recording per-callsite
    input absmax.  Returns the scale table for quant_mode('int8')."""
    scales: Dict[int, np.ndarray] = {}
    for batch in batches:
        with quant_mode("calibrate", scales), torch.no_grad():
            fn(batch)
    return scales
