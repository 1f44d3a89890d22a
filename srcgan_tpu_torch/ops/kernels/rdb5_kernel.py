"""One ResidualDenseBlock_5 per launch, in bf16 or int8: a hand-written sm_90a kernel.

Port of ``srcgan_tpu.ops.pallas.rdb5_kernel``: ``rdb5_bf16_fused`` and
``rdb5_int8_fused`` are two forms of one kernel body (``csrc/rdb5.cu``).  The
block is five 3x3 convolutions over the dense concat [x, x1..x4] with
LeakyReLU(0.2) between them and ``out = conv5 * lemda + x``; NHWC tensors.

  bf16  bf16 operands, fp32 sums over taps and sources, each x_k rounded to
        bf16; x and out bf16.
  int8  the quantized serving path (``srcgan_tpu_torch.quant``): per-input-
        channel activation scales folded into the weights, per-output-channel
        weight scales, exact int32 sums over taps and sources, one fp32
        dequant + bias per stage, each x_k requantized; x and out fp32.

``prep_bf16`` / ``prep_int8`` build the operands from the block's weights
(OIHW), once per weight set (and per calibration): callers cache them.  The
packed per-source matrices are the JAX package's (rows in (dy, dx, c) order,
columns = stages s..4); ``frag`` holds the same numbers in the order the
kernel's tensor-core fragments read them.

Each wrapper launches the kernel for a CUDA tensor and runs the plain version
(``rdb5_bf16_reference`` / ``rdb5_int8_reference``) for a CPU tensor; there is
no fallback from one to the other.  ``launches_bf16`` and ``launches_int8``
count the kernel launches, ``reference_calls`` the runs of a plain version.
Forward only, as the TPU kernel: training takes the module's own schedules.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from srcgan_tpu_torch import config

# Kernel launches, and runs of a plain version, since import (or since a
# caller last set them to 0).
launches_bf16 = 0
launches_int8 = 0
reference_calls = 0

NF, GC = 64, 32              # the widths csrc/rdb5.cu is written for
TILE = 16                    # csrc/rdb5.cu kTile: outputs per block, each way
_WIDTHS = (GC, GC, GC, GC, NF)
_MAX_GRID = 65535            # grid.y and grid.z


def _source_slices(nf: int, gc: int):
    """Input-channel range of each source in the dense concat (x, x1..x4)."""
    return [(0, nf)] + [(nf + (k - 1) * gc, nf + k * gc) for k in range(1, 5)]


def _stage_weights(convs: Sequence[Tuple[torch.Tensor, torch.Tensor | None]], nf: int, gc: int):
    """HWIO weights of the five stages and their fp32 biases padded to nf.
    convs: [(weight (out,in,3,3), bias (out,) or None)] * 5, conv1..conv5."""
    widths = [gc, gc, gc, gc, nf]
    ws, bs = [], []
    for i, (w, b) in enumerate(convs):
        if tuple(w.shape) != (widths[i], nf + i * gc, 3, 3):
            raise ValueError(f"rdb5: conv{i + 1} weight {tuple(w.shape)}, expected "
                             f"{(widths[i], nf + i * gc, 3, 3)}")
        ws.append(w.permute(2, 3, 1, 0))
        b = w.new_zeros((widths[i],), dtype=torch.float32) if b is None else b.float()
        bs.append(F.pad(b, (0, nf - widths[i])))
    return ws, bs


def _pack_sources(w_stage, nf: int, gc: int):
    """Per-source (9*Cs, N_s) matrices from the stages' HWIO weights; rows in
    (dy, dx, c) order, columns = stages s..4 concatenated."""
    out = []
    for s, (lo, hi) in enumerate(_source_slices(nf, gc)):
        w_s = torch.cat([w_stage[i][:, :, lo:hi, :] for i in range(s, 5)], dim=-1)
        out.append(w_s.reshape(9 * (hi - lo), w_s.shape[-1]).contiguous())
    return out


def _fragments(wsrc, quant: bool) -> torch.Tensor:
    """The per-source matrices as int32 words in the order the kernel reads
    them: for stage i, for source j <= i, [tap][k-step][lane][n-tile][reg],
    where one mma.sync B fragment (16x8 bf16 or 32x8 int8) gives lane
    g*4 + t the words reg 0, 1 = elements k = t*E + reg*4*E .. + E - 1 of column
    n-tile*8 + g (E = 2 bf16 or 4 int8 values per word).
    csrc/rdb5.cu::frag_off walks the same order."""
    e = 4 if quant else 2
    parts = []
    for i in range(5):
        for j in range(i + 1):
            col0 = sum(_WIDTHS[j:i])
            w = wsrc[j][:, col0:col0 + _WIDTHS[i]]
            cj, ni = w.shape[0] // 9, _WIDTHS[i]
            # k = ks*8E + reg*4E + t*E + e ; n = nt*8 + g
            w = w.reshape(9, cj // (8 * e), 2, 4, e, ni // 8, 8)
            parts.append(w.permute(0, 1, 6, 3, 5, 2, 4).reshape(-1))
    return torch.cat(parts).contiguous().view(torch.int32)


class Bf16Weights(NamedTuple):
    """wsrc: five bf16 (9*Cs, N_s) per-source matrices; bias (5, 64) fp32;
    frag: wsrc in fragment order, int32 words."""
    wsrc: tuple
    bias: torch.Tensor
    frag: torch.Tensor


class Int8Weights(NamedTuple):
    """wq: five int8 (9*Cs, N_s) per-source matrices; sw (5, 64) per-stage
    dequant scales, rq (5, 64) per-source reciprocal activation scales, bias
    (5, 64), all fp32 and zero-padded to width 64; frag: wq in fragment order."""
    wq: tuple
    sw: torch.Tensor
    rq: torch.Tensor
    bias: torch.Tensor
    frag: torch.Tensor


@torch.no_grad()
def prep_bf16(convs) -> Bf16Weights:
    """bf16 per-source matrices + fp32 biases from the block's five convs
    ([(weight OIHW, bias or None)] * 5, nf = 64, gc = 32)."""
    w_stage, bias = _stage_weights(convs, NF, GC)
    wsrc = _pack_sources([w.to(torch.bfloat16) for w in w_stage], NF, GC)
    return Bf16Weights(tuple(wsrc), torch.stack(bias).contiguous(), _fragments(wsrc, False))


@torch.no_grad()
def prep_int8(convs, absmax) -> Int8Weights:
    """Quantize the block's weights (nf = 64, gc = 32) for the kernel.

    absmax: (nf + 4*gc,) calibrated per-channel absolute maxima of the stage-5
    concat input [x, x1..x4] (every source's activation range), a tensor on
    the weights' device."""
    nf, gc, widths = NF, GC, _WIDTHS
    s_x = absmax.float().clamp_min(1e-8) / 127.0
    w_stage, bias = _stage_weights(convs, nf, gc)
    wq_stage, sw_stage = [], []
    for i in range(5):
        cin = nf + i * gc
        w_eff = w_stage[i].float() * s_x[:cin].reshape(1, 1, -1, 1)
        s_w = (w_eff.abs().amax(dim=(0, 1, 2), keepdim=True) / 127.0).clamp_min(1e-30)
        wq_stage.append(torch.round(w_eff / s_w).clamp(-127, 127).to(torch.int8))
        sw_stage.append(F.pad(s_w.reshape(-1), (0, nf - widths[i])))
    wq = _pack_sources(wq_stage, nf, gc)
    rq = [F.pad(1.0 / s_x[lo:hi], (0, nf - (hi - lo))) for lo, hi in _source_slices(nf, gc)]
    return Int8Weights(tuple(wq), torch.stack(sw_stage).contiguous(),
                       torch.stack(rq).contiguous(), torch.stack(bias).contiguous(),
                       _fragments(wq, True))


def supported(x_shape, nf: int, gc: int) -> bool:
    """The JAX package's shape gate (c == nf == 64, gc == 32, W % 128 == 0,
    W <= 512, H >= 8) plus the card's own limits (the launch grid)."""
    n, h, w, c = x_shape
    return (c == nf and nf == NF and gc == GC and w % 128 == 0 and w <= 512 and h >= 8
            and 0 < n <= _MAX_GRID and -(-h // TILE) <= _MAX_GRID)


def _reference(x, weights, quant: bool, lemda: float, alpha: float):
    """The kernel's arithmetic in torch, by source: one convolution per source
    gives its contributions to every later stage; the sums across sources stay
    int (quant) or fp32; one dequant / bias per stage."""
    global reference_calls
    reference_calls += 1
    slices = _source_slices(NF, GC)
    x32 = x.float()
    mats = weights.wq if quant else weights.wsrc

    def as_source(v, s):  # fp32 NHWC -> the operand the next convolutions read
        cs = slices[s][1] - slices[s][0]
        if quant:
            return torch.round(v * weights.rq[s, :cs]).clamp(-127, 127)
        return v.to(torch.bfloat16).float()

    def conv(src, s):
        # float64 sums of int8 x int8 products are exact integers (the card's
        # convolution algorithms may reorder, hence the round); fp32 with TF32
        # off for the bf16 form, whose products are exact in fp32
        cs = slices[s][1] - slices[s][0]
        w = mats[s].reshape(3, 3, cs, -1).permute(3, 2, 0, 1)
        dt = torch.float64 if quant else torch.float32
        y = F.conv2d(src.permute(0, 3, 1, 2).to(dt), w.to(dt), None, 1, 1).permute(0, 2, 3, 1)
        return torch.round(y).to(torch.int32) if quant else y

    pre = [None] * 5
    src = as_source(x32, 0)
    with config.precision("fp32"):
        for s in range(5):
            acc = conv(src, s)
            o = 0
            for i in range(s, 5):
                c = acc[..., o:o + _WIDTHS[i]]
                pre[i] = c if pre[i] is None else pre[i] + c
                o += _WIDTHS[i]
            if s < 4:
                v = pre[s].float()
                if quant:
                    v = v * weights.sw[s, :_WIDTHS[s]]
                v = v + weights.bias[s, :_WIDTHS[s]]
                src = as_source(torch.where(v >= 0, v, alpha * v), s + 1)
    x5 = pre[4].float()
    if quant:
        x5 = x5 * weights.sw[4, :NF]
    x5 = x5 + weights.bias[4, :NF]
    return (x5 * lemda + x32).to(x.dtype)


def rdb5_int8_reference(x, weights: Int8Weights, lemda: float = 0.2, alpha: float = 0.2):
    """Plain torch version of the int8 form, the statement of the JAX
    package's ``rdb5_int8_xla``.  x (N,H,W,64) fp32, on any device."""
    return _reference(x, weights, True, lemda, alpha)


def rdb5_bf16_reference(x, weights: Bf16Weights, lemda: float = 0.2, alpha: float = 0.2):
    """Plain torch version of the bf16 form: fp32 sums of bf16 products, every
    x_k and the output rounded to bf16.  x (N,H,W,64) bf16, on any device."""
    return _reference(x, weights, False, lemda, alpha)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """csrc/rdb5.cu, built at first use, with its C signatures declared."""
    from srcgan_tpu_torch.ops.kernels import build

    lib = build.load("rdb5")
    lib.rdb5_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.rdb5_launch.restype = ctypes.c_int
    lib.rdb5_error_string.argtypes = [ctypes.c_int]
    lib.rdb5_error_string.restype = ctypes.c_char_p
    return lib


_FRAG_WORDS = {False: 9 * 26624 // 2, True: 9 * 26624 // 4}   # 239,616 weights


def _check(x, weights, quant: bool):
    """Raise on what the kernel (or its plain version) does not take."""
    name = "rdb5_int8" if quant else "rdb5_bf16"
    want = torch.float32 if quant else torch.bfloat16
    if x.dim() != 4 or not supported(x.shape, NF, GC):
        raise ValueError(f"{name}: unsupported input shape {tuple(x.shape)}")
    if x.dtype != want:
        raise ValueError(f"{name}: x must be {want}, got {x.dtype}")
    if x.requires_grad:
        raise ValueError(f"{name}: the fused block has no backward (the TPU kernel has "
                         "none either); training takes the module's own schedules")
    vectors = (("sw", weights.sw), ("rq", weights.rq)) if quant else ()
    for label, t, dtype, shape in ([("frag", weights.frag, torch.int32, (_FRAG_WORDS[quant],)),
                                    ("bias", weights.bias, torch.float32, (5, NF))]
                                   + [(n, t, torch.float32, (5, NF)) for n, t in vectors]):
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} must be {dtype} {shape} on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        # an expanded view has stride 0 and fewer elements in memory than its shape
        if not t.is_contiguous() or 0 in t.stride():
            raise ValueError(f"{name}: {label} must be contiguous")


def _launch(x, weights, quant: bool, lemda: float, alpha: float):
    global launches_bf16, launches_int8
    _check(x, weights, quant)
    name = "rdb5_int8" if quant else "rdb5_bf16"
    lib = _library()
    x = x.contiguous()
    out = torch.empty_like(x)
    sw = weights.sw if quant else None
    rq = weights.rq if quant else None
    for label, t in (("x", x), ("out", out), ("frag", weights.frag), ("bias", weights.bias),
                     ("sw", sw), ("rq", rq)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} is not 16-byte aligned")
    n, h, w, _ = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.rdb5_launch(x.data_ptr(), weights.frag.data_ptr(),
                              sw.data_ptr() if quant else None,
                              rq.data_ptr() if quant else None,
                              weights.bias.data_ptr(), out.data_ptr(), n, h, w, alpha, lemda,
                              int(quant), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.rdb5_error_string(err).decode()}")
    if quant:
        launches_int8 += 1
    else:
        launches_bf16 += 1
    return out


def rdb5_int8_fused(x, weights: Int8Weights, lemda: float = 0.2, alpha: float = 0.2):
    """int8 RDB5 forward.  x: (N,H,W,64) fp32 NHWC; weights from ``prep_int8``.
    Returns fp32 of x's shape.  CUDA tensor: the sm_90a kernel (raises if it
    cannot run).  CPU tensor: the plain version."""
    if x.is_cuda:
        return _launch(x, weights, True, lemda, alpha)
    _check(x, weights, True)
    return rdb5_int8_reference(x, weights, lemda, alpha)


def rdb5_bf16_fused(x, weights: Bf16Weights, lemda: float = 0.2, alpha: float = 0.2):
    """bf16 RDB5 forward (eval).  x: (N,H,W,64) bf16 NHWC; weights from
    ``prep_bf16``.  Returns bf16 of x's shape.  CUDA tensor: the sm_90a kernel
    (raises if it cannot run).  CPU tensor: the plain version."""
    if x.is_cuda:
        return _launch(x, weights, False, lemda, alpha)
    _check(x, weights, False)
    return rdb5_bf16_reference(x, weights, lemda, alpha)
