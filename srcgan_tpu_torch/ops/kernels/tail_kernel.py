"""The x4 RDDBNet upsample tail for eval: a hand-written sm_90a kernel.

Port of ``srcgan_tpu.ops.pallas.tail_kernel.tail_x4_fused``.  In phase space
(see ``ops.fused.phasefold_deconv_tail``) the tail deconv1 + LeakyReLU +
deconv2 + LeakyReLU + conv_last is, per phase block b of deconv1:

    t1_b  = lrelu(t0 @ W1[b])        (M,nf)  x (nf,nf)
    z2_b  = lrelu(t1_b @ W2m)        (M,nf)  x (nf,4nf)
    zall += z2_b @ Wall[b]           (M,4nf) x (4nf, 9*16*ou)

``csrc/tail_x4.cu`` runs the three GEMMs with t1/z2 kept on chip as bf16 and
zall accumulated in fp32; the 9-tap shift-reduce, the bias and the pixel
shuffle then run as torch ops here.  Forward only (eval): training uses the
differentiable fold.

``tail_x4_fused`` launches the kernel for a CUDA tensor and runs the plain
version (``zall_reference``, the kernel's exact staging in torch) for a CPU
tensor; there is no fallback from one to the other.  ``launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from srcgan_tpu_torch.ops import fused
from srcgan_tpu_torch.ops.conv import pixel_shuffle

# Kernel launches since import (or since a caller last set it to 0).
launches = 0

_NF_TILE = 16            # the kernel's wmma fragments are 16 wide
_COL_TILE = 144          # zall columns per block (csrc/tail_x4.cu kColTile)
_WARPS = 8
SMEM_LIMIT = 232_448     # a Hopper block's shared memory, bytes


def smem_bytes(nf: int) -> int:
    """The kernel's shared memory for a (16-padded) nf; csrc/tail_x4.cu::smem_bytes
    (every row padded by 8 bf16 / 4 fp32 values against bank conflicts)."""
    pad = 8
    weights = 2 * (4 * nf * (_COL_TILE + pad) + nf * (4 * nf + pad) + nf * (nf + pad))
    per_warp = 2 * 16 * (nf + pad + 4 * nf + pad) + 4 * 16 * (16 + 4)
    return weights + _WARPS * per_warp


def _pad16(nf: int) -> int:
    return -(-nf // _NF_TILE) * _NF_TILE


def supported(t0_shape, upscale_factor: int, dtype) -> bool:
    """The JAX gate (x4, bf16, H % 8 == W % 8 == nf % 8 == 0), plus the
    card's limit: the weights of one block must fit its shared memory
    (nf <= 64)."""
    n, h, w, nf = t0_shape
    return (upscale_factor == 4 and dtype == torch.bfloat16
            and h % 8 == 0 and w % 8 == 0 and nf % 8 == 0
            and smem_bytes(_pad16(nf)) <= SMEM_LIMIT)


class TailWeights(NamedTuple):
    """Kernel operands, bf16: w1s (4,nfp,nfp), w2m (nfp,4nfp), wall (4,4nfp,144*ou).
    nfp is nf rounded up to 16 (zero channels, which stay zero through the tail)."""
    w1s: torch.Tensor
    w2m: torch.Tensor
    wall: torch.Tensor


@torch.no_grad()
def prepare(w_deconv1, w_deconv2, last_w) -> TailWeights:
    """Assemble the kernel operands from the port's weights, once per weight set.

    w_deconv{1,2}: (nf,nf,2,2) ConvTranspose2d weights (in,out,kh,kw), bias-free;
    last_w: (ou,nf,3,3) conv_last weight."""
    bf = torch.bfloat16
    nf = w_deconv1.shape[0]
    pad = _pad16(nf) - nf
    if pad:
        w_deconv1 = F.pad(w_deconv1, (0, 0, 0, 0, 0, pad, 0, pad))
        w_deconv2 = F.pad(w_deconv2, (0, 0, 0, 0, 0, pad, 0, pad))
        last_w = F.pad(last_w, (0, 0, 0, 0, 0, pad))
    nf += pad
    ou = last_w.shape[0]
    co2 = 16 * ou
    # (in,out,kh,kw) -> (kh,kw,in,out) -> (4,nf,nf) with b = ty*2+tx
    w1s = w_deconv1.to(bf).permute(2, 3, 0, 1).reshape(4, nf, nf)
    # (in,out,kh,kw) -> (in,kh,kw,out) -> (nf, 4nf), column (ty*2+tx)*nf + co
    w2m = w_deconv2.to(bf).permute(0, 2, 3, 1).reshape(nf, 4 * nf)
    wf = fused.fold_last_weight(fused.tail_phases(2), last_w.permute(2, 3, 1, 0),
                                4, nf, bf)
    # (3,3,16nf,16ou) -> (16nf, 9*co2), column tap*co2 + (co*16 + phase)
    wall = wf.reshape(9, 16 * nf, co2).movedim(0, 1).reshape(4, 4 * nf, 9 * co2)
    return TailWeights(w1s.contiguous(), w2m.contiguous(), wall.contiguous())


def zall_reference(t0m, tw: TailWeights, alpha: float = 0.2):
    """Plain torch version of the kernel: (M,nfp) bf16 -> zall (M, 9*16*ou) bf16.

    fp32 matmuls of bf16 operands (their products are exact in fp32), with the
    bf16 roundings where the kernel stages t1, z2 and zall."""
    x = t0m.float()
    acc = None
    for b in range(4):
        t1 = F.leaky_relu(x @ tw.w1s[b].float(), alpha).to(torch.bfloat16)
        z2 = F.leaky_relu(t1.float() @ tw.w2m.float(), alpha).to(torch.bfloat16)
        part = z2.float() @ tw.wall[b].float()
        acc = part if acc is None else acc + part
    return acc.to(torch.bfloat16)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """csrc/tail_x4.cu, built at first use, with its C signatures declared."""
    from srcgan_tpu_torch.ops.kernels import build

    lib = build.load("tail_x4")
    lib.tail_x4_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.tail_x4_launch.restype = ctypes.c_int
    lib.tail_x4_error_string.argtypes = [ctypes.c_int]
    lib.tail_x4_error_string.restype = ctypes.c_char_p
    return lib


def _zall_kernel(t0m, tw: TailWeights, alpha: float):
    global launches
    lib = _library()
    m, nf = t0m.shape
    c9 = tw.wall.shape[2]
    ops = (t0m, tw.w1s, tw.w2m, tw.wall)
    for name, t in zip(("t0", "w1s", "w2m", "wall"), ops):
        if t.device != t0m.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"tail_x4: {name} must be contiguous bf16 on {t0m.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"tail_x4: {name} is not 16-byte aligned")
    zall = torch.empty((m, c9), dtype=torch.bfloat16, device=t0m.device)
    stream = torch.cuda.current_stream(t0m.device).cuda_stream
    with torch.cuda.device(t0m.device):
        err = lib.tail_x4_launch(*(t.data_ptr() for t in ops), zall.data_ptr(),
                                 m, nf, c9, alpha, stream)
    if err:
        raise RuntimeError(f"tail_x4 launch failed: {lib.tail_x4_error_string(err).decode()}")
    launches += 1
    return zall


def _finish(zall, n, h, w, ou, last_b):
    """9-tap shift-reduce over (H, W), bias, pixel shuffle: (M, 9*16*ou) -> (N,4H,4W,ou)."""
    co2 = 16 * ou
    zp = F.pad(zall.view(n, h, w, 9 * co2), (0, 0, 1, 1, 1, 1))
    out = None
    for oy in range(3):
        for ox in range(3):
            t = oy * 3 + ox
            tap = zp[:, oy:oy + h, ox:ox + w, t * co2:(t + 1) * co2]
            out = tap if out is None else out + tap
    if last_b is not None:
        out = out + last_b.to(out.dtype).repeat_interleave(16)
    return pixel_shuffle(out, 4)


def _t0_rows(t0, tw: TailWeights):
    n, h, w, nf = t0.shape
    if not supported(t0.shape, 4, t0.dtype):
        raise ValueError(f"tail_x4: unsupported input {tuple(t0.shape)} {t0.dtype}")
    pad = tw.w1s.shape[1] - nf
    if pad < 0:
        raise ValueError(f"tail_x4: weights for nf={tw.w1s.shape[1]}, input has nf={nf}")
    t0m = (F.pad(t0, (0, pad)) if pad else t0).reshape(n * h * w, nf + pad)
    return t0m.contiguous()


def tail_x4_fused(t0, tw: TailWeights, last_b=None, alpha: float = 0.2):
    """x4 tail from the trunk output t0 (N,H,W,nf) bf16 with weights from
    ``prepare``; last_b (ou,) or None.  Returns (N,4H,4W,ou) bf16.

    CUDA tensor: the sm_90a kernel (raises if it cannot run).  CPU tensor:
    the plain version."""
    n, h, w, _ = t0.shape
    t0m = _t0_rows(t0, tw)
    zall = _zall_kernel(t0m, tw, alpha) if t0.is_cuda else zall_reference(t0m, tw, alpha)
    return _finish(zall, n, h, w, tw.wall.shape[2] // _COL_TILE, last_b)


def tail_x4_reference(t0, w_deconv1, w_deconv2, last_w, last_b=None,
                      alpha: float = 0.2):
    """Plain torch version of the whole tail with the kernel's staging; the
    same arguments as the JAX ``tail_x4_fused`` in the port's weight layouts
    (deconvs (nf,nf,2,2), conv_last (ou,nf,3,3)).  On any device; t0 is cast
    to bf16 as the JAX wrapper casts it."""
    t0 = t0.to(torch.bfloat16)
    n, h, w, _ = t0.shape
    tw = prepare(w_deconv1, w_deconv2, last_w)
    zall = zall_reference(_t0_rows(t0, tw), tw, alpha)
    return _finish(zall, n, h, w, last_w.shape[0], last_b)
