"""The benchmark's own count of the work: FLOPs and bytes from shapes, and
the card's published peaks.

Every count here is of the layers that the reference defines (what the
model's arithmetic needs), never of how the program implements them: a
kernel that folds, pads or recomputes does not change these numbers.  A
multiply-add is two FLOPs; only convolutions and transposed convolutions
are counted (norms, activations and adds are a rounding error beside them).
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def least_time(nbytes: float, flop: float, dtype: str) -> dict:
    """The least time the card could take for work that must move ``nbytes``
    (each input read once, each output written once) and do ``flop``
    operations of ``dtype``: the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / PEAK_FLOPS[dtype]
    return {"seconds": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def conv(cin: int, cout: int, k: int, out_pixels: int) -> int:
    """A k x k convolution: 2 * cin * cout * k^2 per output pixel."""
    return 2 * cin * cout * k * k * out_pixels


def deconv(cin: int, cout: int, k: int, in_pixels: int) -> int:
    """A k x k stride-k transposed convolution: each input pixel meets
    cin * cout * k^2 weights."""
    return 2 * cin * cout * k * k * in_pixels


def rdb5_per_pixel(nf: int = 64, gc: int = 32) -> int:
    """One ResidualDenseBlock5: five 3x3 convs over the growing concat."""
    return sum(conv(nf + i * gc, gc if i < 4 else nf, 3, 1) for i in range(5))


def rdb5_bytes(pixels: int, nf: int = 64, gc: int = 32, itemsize: int = 2) -> int:
    """One block's input read once, output written once, weights once
    (biases in fp32)."""
    weights = sum(9 * (nf + i * gc) * (gc if i < 4 else nf) for i in range(5))
    biases = 4 * gc + nf
    return 2 * pixels * nf * itemsize + weights * itemsize + biases * 4


def tail_per_trunk_pixel(nf: int = 64, ou: int = 1, up: int = 4) -> int:
    """RDDBNet's upsample tail per trunk pixel: log2(up) k2s2 deconvs nf->nf,
    then conv_last 3x3 nf->ou at the output resolution."""
    total, scale = 0, 1
    while scale < up:
        total += deconv(nf, nf, 2, scale * scale)
        scale *= 2
    return total + conv(nf, ou, 3, up * up)


def tail_bytes(pixels: int, nf: int = 64, ou: int = 1, up: int = 4,
               itemsize: int = 2) -> int:
    """The tail's trunk input read once, its output written once, weights once."""
    n_deconv = up.bit_length() - 1
    weights = n_deconv * nf * nf * 4 + 9 * nf * ou
    return pixels * nf * itemsize + pixels * up * up * ou * itemsize + weights * itemsize


def rddbnet(pixels: int, in_ch: int = 1, ou: int = 1, up: int = 4, nf: int = 64,
            nb: int = 3, gc: int = 32) -> int:
    """RDDBNet forward on ``pixels`` input pixels."""
    per_px = (conv(in_ch, nf, 3, 1) + 3 * nb * rdb5_per_pixel(nf, gc) + conv(nf, nf, 3, 1))
    if up == 1:
        return pixels * (per_px + conv(nf, ou, 3, 1))
    return pixels * (per_px + tail_per_trunk_pixel(nf, ou, up))


def _basic_block(inp: int, planes: int, stride: int, out_px: int) -> int:
    flop = conv(inp, planes, 3, out_px) + conv(planes, planes, 3, out_px)
    if stride != 1 or inp != planes:
        flop += conv(inp, planes, 1, out_px)
    return flop


def _stage(inp: int, planes: int, stride: int, out_px: int) -> int:
    return _basic_block(inp, planes, stride, out_px) + _basic_block(planes, planes, 1, out_px)


def resdeconv(h: int, w: int, tar_ch: int = 3) -> int:
    """ResDeconv forward on one h x w image (sides multiples of 16)."""
    px = lambda s: (h // s) * (w // s)  # noqa: E731 - pixels at stride s
    flop = conv(3, 64, 7, px(2))
    flop += _stage(64, 64, 1, px(2)) + _stage(64, 128, 2, px(4))
    flop += _stage(128, 256, 2, px(8)) + _stage(256, 512, 2, px(16))
    flop += deconv(512, 256, 2, px(16)) + _stage(256, 256, 1, px(8))
    flop += deconv(256, 128, 2, px(8)) + _stage(128, 128, 1, px(4))
    flop += deconv(128, 64, 2, px(4)) + _stage(64, 64, 1, px(2))
    flop += deconv(64, 64, 2, px(2)) + conv(64, tar_ch, 3, px(1))
    return flop


def cascade_forward(n: int, h: int, w: int, sr: dict, c: dict) -> int:
    """The SR net on n gray h x w inputs, then the colorizer on its output."""
    up = sr["up"]
    return (rddbnet(n * h * w, sr["in_ch"], sr["ou_ch"], up, sr["nf"], sr["nb"], sr["gc"])
            + n * resdeconv(h * up, w * up, c["tar_ch"]))


def train_step(n: int, hw: int, sr: dict, c: dict) -> int:
    """One CasTrainer step on n targets of hw x hw: stage 1 runs the SR net
    on the hw/up input, stage 2 the colorizer on the hw gray; a backward
    pass costs two forwards, so the step is three."""
    up = sr["up"]
    lo = hw // up
    fwd = (rddbnet(n * lo * lo, sr["in_ch"], sr["ou_ch"], up, sr["nf"], sr["nb"], sr["gc"])
           + n * resdeconv(hw, hw, c["tar_ch"]))
    return 3 * fwd
