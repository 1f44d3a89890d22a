"""Exact fusions of op pairs, as in ``srcgan_tpu.ops.fused``: the
phase-folded RDDBNet upsample tail, and the nearest-upsample + conv of the
legacy generators' up stages.

The tail, log2(r) x [ConvTranspose2d k2s2 (no bias) + LeakyReLU] + conv3x3, is computed at
input resolution ("phase space"): each k2s2 deconv is a 1x1 conv whose output
keeps the r*r output phases packed in channel blocks, and the last 3x3 conv is
re-indexed onto the phase grid (``fold_last_weight``), so one small pixel
shuffle of the ou-channel output makes the image.  Exact up to the order of
float sums, and differentiable.  NHWC tensors, HWIO weights.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from srcgan_tpu_torch.ops.conv import conv2d, pixel_shuffle, to_nchw, to_nhwc


def nearest_up2_conv3x3(x, w, b=None):
    """conv3x3(nearest_upsample_x2(x)) over NHWC x with an HWIO weight: the
    up stage of the legacy RDDB generators (``upconv(F.interpolate(fea, 2,
    'nearest'))``).  The JAX package folds the upsample into four phase
    convolutions; here it is the plain form, F.interpolate then the
    convolution, which computes the same sums."""
    up = to_nhwc(F.interpolate(to_nchw(x), scale_factor=2, mode="nearest"))
    return conv2d(up, w, b, 1, 1)


def tail_phases(n_up: int):
    """Channel-block -> output-phase map after n_up folded k2s2 deconvs."""
    phases = [(0, 0)]
    for _ in range(n_up):
        phases = [(2 * py + ty, 2 * px + tx)
                  for (py, px) in phases for ty in (0, 1) for tx in (0, 1)]
    return phases


@functools.lru_cache(maxsize=16)
def _fold_indices(phases: tuple, r: int):
    """Scatter coordinates of fold_last_weight: for every (input block,
    output phase, tap) that lands within one cell, its (cell offset y, x,
    block, output phase) target and (dy, dx) source tap."""
    idx = []
    for beta, (pyi, pxi) in enumerate(phases):
        for pyo in range(r):
            for pxo in range(r):
                for dy in (-1, 0, 1):
                    if (pyo + dy - pyi) % r:
                        continue
                    oy = (pyo + dy - pyi) // r
                    if abs(oy) > 1:
                        continue
                    for dx in (-1, 0, 1):
                        if (pxo + dx - pxi) % r:
                            continue
                        ox = (pxo + dx - pxi) // r
                        if abs(ox) > 1:
                            continue
                        idx.append((oy + 1, ox + 1, beta, pyo * r + pxo,
                                    dy + 1, dx + 1))
    return tuple(np.asarray(col, np.int64) for col in zip(*idx))


@functools.lru_cache(maxsize=16)
def _fold_index_tensors(phases: tuple, r: int, device: torch.device):
    """_fold_indices as tensors on ``device``, copied there once: a copy from
    pageable host memory makes the host wait for the device, and the training
    tail folds conv_last on every step."""
    return tuple(torch.from_numpy(a).to(device) for a in _fold_indices(phases, r))


def fold_last_weight(phases, last_w, r: int, nf: int, dtype):
    """(3,3,nf,ou) conv_last re-indexed onto the r x r phase grid.

    A full-resolution tap (dy,dx) on output phase (Pyo,Pxo) reads input phase
    Pyi=(Pyo+dy) mod r at cell offset oy=(Pyo+dy-Pyi)/r.  Returns a
    (3,3, r*r*nf, ou*r*r) weight: input channel beta*nf+ci in ``phases`` block
    order; output channel co*r*r+phase (pixel-shuffle order)."""
    g = len(phases)
    ou = last_w.shape[3]
    oy, ox, blk, ph, dy, dx = _fold_index_tensors(tuple(phases), r, last_w.device)
    wf = last_w.new_zeros((3, 3, g, r * r, nf, ou), dtype=dtype)
    wf[oy, ox, blk, ph] = last_w.to(dtype)[dy, dx]             # (K, nf, ou)
    return wf.permute(0, 1, 2, 4, 5, 3).reshape(3, 3, g * nf, ou * r * r)


def phasefold_deconv_tail(x, deconv_ws, last_w, last_b=None, alpha: float = 0.2,
                          fold_last: bool = True, wf=None):
    """The RDDBNet upsample tail on x (N,H,W,nf) -> (N,rH,rW,ou).

    deconv_ws: [(2,2,nf,nf), ...] k2s2 transposed-conv weights (HWIO);
    last_w: (3,3,nf,ou); last_b: (ou,) or None.  fold_last=False pixel-shuffles
    after the deconv folds and runs the last conv at full resolution (for
    large r, where the folded conv would be r*r times wider than useful).
    ``wf``: conv_last already folded by ``fold_last_weight`` (callers build it
    once per weight set), or None to fold it here."""
    nf = x.shape[-1]
    t = x
    phases = [(0, 0)]
    r = 1
    for w in deconv_ws:
        if tuple(w.shape) != (2, 2, nf, nf):
            raise ValueError(f"deconv weight {tuple(w.shape)}, expected (2,2,{nf},{nf})")
        # out pixel (2i+ty, 2j+tx, co) = sum_ci t[i,j,ci] * w[ty,tx,ci,co]:
        # a 1x1 conv to channel (ty*2+tx)*nf + co; every phase block gets it.
        tile = w.to(t.dtype).permute(2, 0, 1, 3).reshape(1, 1, nf, 4 * nf)
        g = len(phases)
        t = conv2d(t, tile.repeat(1, 1, 1, g), None, 1, 0, groups=g)
        t = F.leaky_relu(t, alpha)
        phases = [(2 * py + ty, 2 * px + tx)
                  for (py, px) in phases for ty in (0, 1) for tx in (0, 1)]
        r *= 2

    if tuple(last_w.shape[:3]) != (3, 3, nf):
        raise ValueError(f"conv_last weight {tuple(last_w.shape)}, expected (3,3,{nf},ou)")
    if not fold_last:
        # un-interleave the blocks into pixel-shuffle order (co*r*r + Py*r + Px)
        if r > 1:
            order = {ph: b for b, ph in enumerate(phases)}
            perm = [order[(py, px)] * nf + co
                    for co in range(nf) for py in range(r) for px in range(r)]
            t = pixel_shuffle(t[..., perm], r)
        return conv2d(t, last_w, last_b, 1, 1)

    if wf is None:
        wf = fold_last_weight(phases, last_w, r, nf, t.dtype)
    y = conv2d(t, wf, None, 1, 1)
    if last_b is not None:
        y = y + last_b.to(y.dtype).repeat_interleave(r * r)
    return pixel_shuffle(y, r)
