"""Geometric self-ensemble (x8 dihedral test-time augmentation), as in
``srcgan_tpu.ops.ensemble``.

The "EDSR+" protocol: run the network on all 8 dihedral (D4) transforms of
the input, invert each output, and average.  The transformed copies are
concatenated along the batch and run as ONE forward of 8N rows: on square
inputs every D4 image has the same shape.

Op numbering matches the host-side augmentation (``data.dataset.dihedral``):
0..3 = rot90 CCW by k; 4 = horizontal flip (W); 5 = vertical flip (H);
6 = transpose; 7 = anti-transpose.  Ops 0/2/4/5 preserve (H, W) and are the
legal subset for non-square inputs.
"""
from __future__ import annotations

import torch

# op -> inverse op (rot90 and rot270 swap; everything else is an involution)
DIHEDRAL_INVERSE = (0, 3, 2, 1, 4, 5, 6, 7)
ALL_OPS = (0, 1, 2, 3, 4, 5, 6, 7)
SHAPE_PRESERVING_OPS = (0, 2, 4, 5)


def dihedral_nhwc(x: torch.Tensor, op: int) -> torch.Tensor:
    """Apply D4 symmetry ``op`` (0..7) to an NHWC batch."""
    if op == 0:
        return x
    if op < 4:
        return torch.rot90(x, k=op, dims=(1, 2))
    if op == 4:
        return x.flip(2)
    if op == 5:
        return x.flip(1)
    if op == 6:
        return x.transpose(1, 2)
    return x.transpose(1, 2).flip((1, 2))


def ensemble_ops(h: int, w: int):
    """The D4 subset legal for an (h, w) input: all 8 when square, else the
    four shape-preserving ops (so the transformed copies still stack)."""
    return ALL_OPS if h == w else SHAPE_PRESERVING_OPS


def self_ensemble_apply(fn, x: torch.Tensor, ops=None):
    """fn over the D4 transforms of the NHWC batch ``x``, inverted and averaged.

    fn: (kN, H, W, C) -> a tensor or a tuple of tensors (kN, H', W', C'),
    whose spatial dims may differ from the input's by a uniform scale (D4
    commutes with uniform resampling).  The k transformed copies run as ONE
    call; each output is inverse-transformed per copy and averaged in its own
    dtype (call in fp32 for metric-grade ensembling), summed in op order."""
    if ops is None:
        ops = ensemble_ops(x.shape[1], x.shape[2])
    k = len(ops)
    ys = fn(torch.cat([dihedral_nhwc(x, op) for op in ops], dim=0))

    def avg(y):
        parts = [dihedral_nhwc(p, DIHEDRAL_INVERSE[op]) for p, op in zip(y.chunk(k, dim=0), ops)]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total / float(k)

    return tuple(avg(y) for y in ys) if isinstance(ys, tuple) else avg(ys)
