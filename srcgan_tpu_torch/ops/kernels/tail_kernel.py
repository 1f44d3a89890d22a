"""The x4 RDDBNet upsample tail for eval: hand-written sm_90a kernels.

Port of ``srcgan_tpu.ops.pallas.tail_kernel.tail_x4_fused``.  In phase space
(see ``ops.fused.phasefold_deconv_tail``) the tail deconv1 + LeakyReLU +
deconv2 + LeakyReLU + conv_last is, per phase block b of deconv1:

    t1_b  = lrelu(t0 @ W1[b])        (M,nf)  x (nf,nf)
    z2_b  = lrelu(t1_b @ W2m)        (M,nf)  x (nf,4nf)
    zall += z2_b @ Wall[b]           (M,4nf) x (4nf, 9*16*ou)

then the 9-tap shift-reduce over (H, W), the bias and the pixel shuffle.
``csrc/tail_x4.cu`` runs the three GEMMs in one launch (t1 and z2 kept in
registers as bf16, zall summed in fp32; ``launches`` counts it) and the
finish in a second (9 taps gathered per pixel, summed in fp32, the bias, one
rounding to bf16 at the pixel-shuffled place; ``finish_launches``).  The
plain versions, ``zall_reference`` and ``finish_reference``, make the same
roundings in torch.  Forward only (eval): training uses the differentiable
fold.

``tail_x4_fused`` launches the kernels for a CUDA tensor and runs the plain
versions for a CPU tensor; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from srcgan_tpu_torch.ops import fused
from srcgan_tpu_torch.ops.conv import pixel_shuffle

# Launches since import (or since a caller last set them to 0): the main
# kernel (the three GEMMs) and the finish pass.
launches = 0
finish_launches = 0

_NF_TILE = 16            # nf is padded to the wgmma k16 step
COL_TILE = 144           # zall columns per item (csrc/tail_x4.cu kColTile)
CHUNK = 64               # z2 columns per chunk = Wall k-rows per slice (kChunk)
SLOTS = 8                # Wall slices in the ring (kSlots)
SMEM_LIMIT = 232_448     # a Hopper block's shared memory, bytes


def smem_bytes(nf: int) -> int:
    """The main kernel's shared memory for a (16-padded) nf; csrc/tail_x4.cu::smem_bytes:
    W1 (4,nf,nf) and W2m (nf,4nf) resident, the ring of Wall slices, the barriers."""
    return 16 * nf * nf + SLOTS * CHUNK * COL_TILE * 2 + (2 * SLOTS + 1) * 8


def _pad16(nf: int) -> int:
    return -(-nf // _NF_TILE) * _NF_TILE


def supported(t0_shape, upscale_factor: int, dtype) -> bool:
    """The JAX gate (x4, bf16, H % 8 == W % 8 == nf % 8 == 0), plus the
    card's limit: the weights a block keeps must fit its shared memory
    (nf <= 64)."""
    n, h, w, nf = t0_shape
    return (upscale_factor == 4 and dtype == torch.bfloat16
            and h % 8 == 0 and w % 8 == 0 and nf % 8 == 0
            and smem_bytes(_pad16(nf)) <= SMEM_LIMIT)


class TailWeights(NamedTuple):
    """Operands, bf16: w1s (4,nfp,nfp), w2m (nfp,4nfp), wall (4,4nfp,144*ou) for
    the plain version, and ``packed``, the same values as the kernel reads them
    (``pack``).  nfp is nf rounded up to 16 (zero channels, which stay zero
    through the tail)."""
    w1s: torch.Tensor
    w2m: torch.Tensor
    wall: torch.Tensor
    packed: torch.Tensor


def core_matrices(b: torch.Tensor) -> torch.Tensor:
    """A (K, N) operand (K % 16 == N % 8 == 0) in the order a wgmma descriptor
    without swizzle reads it: [K/16 steps][2 halves of k][N/8 groups][8 n][8 k],
    each 8 x 8 block a core matrix of 8 rows of 16 bytes; flat."""
    k, n = b.shape
    return b.reshape(k // 16, 2, 8, n // 8, 8).permute(0, 1, 3, 4, 2).reshape(-1)


def pack(w1s, w2m, wall) -> torch.Tensor:
    """The kernel's weight buffer: W1[0..3], W2m (the part a block keeps), then
    Wall's slices of 64 k-rows x 144 columns in the order [b][column tile][k
    chunk], each one bulk copy; all of them core matrices."""
    k2, c9 = wall.shape[1], wall.shape[2]
    slices = [core_matrices(wall[b, c:c + CHUNK, t:t + COL_TILE])
              for b in range(4) for t in range(0, c9, COL_TILE) for c in range(0, k2, CHUNK)]
    return torch.cat([core_matrices(w) for w in w1s] + [core_matrices(w2m)] + slices)


@torch.no_grad()
def prepare(w_deconv1, w_deconv2, last_w) -> TailWeights:
    """Assemble the operands from the port's weights, once per weight set.

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
    w1s = w_deconv1.to(bf).permute(2, 3, 0, 1).reshape(4, nf, nf).contiguous()
    # (in,out,kh,kw) -> (in,kh,kw,out) -> (nf, 4nf), column (ty*2+tx)*nf + co
    w2m = w_deconv2.to(bf).permute(0, 2, 3, 1).reshape(nf, 4 * nf).contiguous()
    wf = fused.fold_last_weight(fused.tail_phases(2), last_w.permute(2, 3, 1, 0),
                                4, nf, bf)
    # (3,3,16nf,16ou) -> (16nf, 9*co2), column tap*co2 + (co*16 + phase)
    wall = wf.reshape(9, 16 * nf, co2).movedim(0, 1).reshape(4, 4 * nf, 9 * co2).contiguous()
    return TailWeights(w1s, w2m, wall, pack(w1s, w2m, wall))


def zall_reference(t0m, tw: TailWeights, alpha: float = 0.2):
    """Plain torch version of the main kernel: (M,nfp) bf16 -> zall (M, 9*16*ou)
    bf16.  fp32 matmuls of bf16 operands (their products are exact in fp32),
    with the bf16 roundings where the kernel stages t1, z2 and zall."""
    x = t0m.float()
    acc = None
    for b in range(4):
        t1 = F.leaky_relu(x @ tw.w1s[b].float(), alpha).to(torch.bfloat16)
        z2 = F.leaky_relu(t1.float() @ tw.w2m.float(), alpha).to(torch.bfloat16)
        part = z2.float() @ tw.wall[b].float()
        acc = part if acc is None else acc + part
    return acc.to(torch.bfloat16)


def finish_reference(zall, n, h, w, ou, last_b=None):
    """Plain torch version of the finish pass: 9-tap shift-reduce over (H, W),
    bias, pixel shuffle, (M, 9*16*ou) -> (N,4H,4W,ou) bf16.  As the kernel: the
    taps summed in fp32 in tap order, the bias (rounded to bf16, as JAX rounds
    it) added in fp32, one rounding to bf16.  (The JAX wrapper sums in bf16,
    a rounding per add: within the tail's tolerance of this.)"""
    co2 = 16 * ou
    zp = F.pad(zall.view(n, h, w, 9 * co2).float(), (0, 0, 1, 1, 1, 1))
    out = None
    for oy in range(3):
        for ox in range(3):
            t = oy * 3 + ox
            tap = zp[:, oy:oy + h, ox:ox + w, t * co2:(t + 1) * co2]
            out = tap if out is None else out + tap
    if last_b is not None:
        out = out + last_b.to(torch.bfloat16).float().repeat_interleave(16)
    return pixel_shuffle(out.to(torch.bfloat16), 4)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """csrc/tail_x4.cu, built at first use, with its C signatures declared."""
    from srcgan_tpu_torch.ops.kernels import build

    lib = build.load("tail_x4")
    lib.tail_x4_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.tail_x4_launch.restype = ctypes.c_int
    lib.tail_x4_finish_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.tail_x4_finish_launch.restype = ctypes.c_int
    lib.tail_x4_chain_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.tail_x4_chain_launch.restype = ctypes.c_int
    lib.tail_x4_error_string.argtypes = [ctypes.c_int]
    lib.tail_x4_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(device, **tensors):
    for name, t in tensors.items():
        if t.device != device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"tail_x4: {name} must be contiguous bf16 on {device}")
        if t.data_ptr() % 16:
            raise ValueError(f"tail_x4: {name} is not 16-byte aligned")


def _raise_if(lib, err: int, what: str):
    if err:
        raise RuntimeError(f"tail_x4 {what} launch failed: "
                           f"{lib.tail_x4_error_string(err).decode()}")


def _zall_kernel(t0m, tw: TailWeights, alpha: float):
    """The main kernel: (M, nfp) bf16 rows -> zall (M, 144*ou) bf16."""
    global launches
    lib = _library()
    m, nf = t0m.shape
    _check_operands(t0m.device, t0=t0m, packed=tw.packed)
    c9 = tw.wall.shape[2]
    zall = torch.empty((m, c9), dtype=torch.bfloat16, device=t0m.device)
    stream = torch.cuda.current_stream(t0m.device).cuda_stream
    with torch.cuda.device(t0m.device):
        err = lib.tail_x4_launch(t0m.data_ptr(), tw.packed.data_ptr(), zall.data_ptr(), m, nf,
                                 c9 // COL_TILE, alpha, stream)
    _raise_if(lib, err, "main kernel")
    launches += 1
    return zall


def _finish_kernel(zall, n, h, w, ou, last_b):
    """The finish pass on the card: zall -> (N,4H,4W,ou) bf16."""
    global finish_launches
    lib = _library()
    _check_operands(zall.device, zall=zall)
    bias = None if last_b is None else last_b.to(torch.bfloat16).float().contiguous()
    out = torch.empty((n, 4 * h, 4 * w, ou), dtype=torch.bfloat16, device=zall.device)
    stream = torch.cuda.current_stream(zall.device).cuda_stream
    with torch.cuda.device(zall.device):
        err = lib.tail_x4_finish_launch(zall.data_ptr(), None if bias is None else bias.data_ptr(),
                                        out.data_ptr(), n, h, w, ou, stream)
    _raise_if(lib, err, "finish")
    finish_launches += 1
    return out


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

    CUDA tensor: the two sm_90a kernels (raises if they cannot run).  CPU
    tensor: the plain versions."""
    n, h, w, _ = t0.shape
    t0m = _t0_rows(t0, tw)
    ou = tw.wall.shape[2] // COL_TILE
    if t0.is_cuda:
        return _finish_kernel(_zall_kernel(t0m, tw, alpha), n, h, w, ou, last_b)
    return finish_reference(zall_reference(t0m, tw, alpha), n, h, w, ou, last_b)


def tail_x4_reference(t0, w_deconv1, w_deconv2, last_w, last_b=None,
                      alpha: float = 0.2):
    """Plain torch version of the whole tail with the kernels' staging; the
    same arguments as the JAX ``tail_x4_fused`` in the port's weight layouts
    (deconvs (nf,nf,2,2), conv_last (ou,nf,3,3)).  On any device; t0 is cast
    to bf16 as the JAX wrapper casts it."""
    t0 = t0.to(torch.bfloat16)
    n, h, w, _ = t0.shape
    tw = prepare(w_deconv1, w_deconv2, last_w)
    zall = zall_reference(_t0_rows(t0, tw), tw, alpha)
    return finish_reference(zall, n, h, w, last_w.shape[0], last_b)
