"""Convolution ops over NHWC tensors and HWIO weights, as in ``srcgan_tpu.ops.conv``.

Thin functions over ``torch.nn.functional``: an NHWC tensor is viewed as NCHW
(a ``channels_last`` tensor, so the view costs no copy), the weight is
permuted to torch's layout, and the result is viewed back as NHWC.  The
JAX package already follows torch's semantics, so these are exact up to the
order of float sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) -> (N,C,H,W) view; channels_last when x is contiguous."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N,C,H,W) -> (N,H,W,C) view; contiguous when x is channels_last."""
    return x.permute(0, 2, 3, 1)


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """torch conv2d on x (N,H,W,Cin) with w (kh,kw,Cin//groups,Cout), b (Cout,).

    The activation sets the compute dtype, as in the JAX package."""
    w = w.to(x.dtype).permute(3, 2, 0, 1)
    b = None if b is None else b.to(x.dtype)
    return to_nhwc(F.conv2d(to_nchw(x), w, b, stride, padding, dilation, groups))


def conv_transpose2d(x, w, b=None, stride=1, padding=0, output_padding=0):
    """torch ConvTranspose2d on x (N,H,W,Cin) with w (kh,kw,Cin,Cout).

    H_out = (H_in-1)*stride - 2*padding + kh + output_padding."""
    w = w.to(x.dtype).permute(2, 3, 0, 1)
    b = None if b is None else b.to(x.dtype)
    return to_nhwc(F.conv_transpose2d(to_nchw(x), w, b, stride, padding,
                                      output_padding))


def pixel_shuffle(x, r: int):
    """(N,H,W,C*r*r) -> (N,H*r,W*r,C); input channel c*r*r + i*r + j, which is
    torch's order, so F.pixel_shuffle on the NCHW view is exact."""
    return to_nhwc(F.pixel_shuffle(to_nchw(x), r))


def pixel_unshuffle(x, r: int):
    """Inverse of pixel_shuffle: (N,H*r,W*r,C) -> (N,H,W,C*r*r)."""
    return to_nhwc(F.pixel_unshuffle(to_nchw(x), r))
