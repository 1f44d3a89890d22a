"""RDDBNet and the ResDeconv colorizer as plain functions of a parameter dict.

The layer equations of SRCGAN's ``src/model/rddb.py`` (RDDBNet: conv_first,
nb RRDBs of three 5-conv dense blocks, trunk_conv plus the global residual,
log2(up) k2s2 deconvs with LeakyReLU(0.2), conv_last without bias) and
``src/model/resdeconv.py`` (a ResNet-18-shaped encoder with GroupNorm(32),
four k2s2 deconvs each followed by a residual stage, a 3x3 pred conv).  The
parameter names are the reference's torch names, so one state dict serves
the program's modules and these functions.

``q`` is the precision of every convolution: ``FP32`` the float32
reference; ``FP8`` the control a precision below bf16, as fp8 training
rounds (inputs and weights to e4m3, the gradient that flows back into
each input to e5m2, one scale a tensor).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _round_fp8(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """x rounded to an fp8 format with one scale for the tensor (its absmax
    to the format's largest value)."""
    scale = largest / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round_fp8(grad, torch.float8_e5m2, 57344.0)


class FP32:
    """The reference's own precision: every operand as it is."""

    @staticmethod
    def act(x):
        return x

    @staticmethod
    def weight(w):
        return w


class FP8(FP32):
    @staticmethod
    def act(x):
        return _Fp8Act.apply(x)

    @staticmethod
    def weight(w):
        """e4m3, straight through for the gradient (kept in float32)."""
        return w + (_round_fp8(w.detach(), torch.float8_e4m3fn, 448.0) - w).detach()


QUANTIZERS = {"fp32": FP32, "fp8": FP8}


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuDNN and cuBLAS: float32 means float32 on the card."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


# -- parameters: names, shapes and how they are drawn -----------------------------------

def _conv(name, cout, cin, k, bias=True):
    """A Conv2d: kaiming normal over fan_out, bias uniform over fan_in."""
    specs = [(f"{name}.weight", (cout, cin, k, k), "normal", cout * k * k)]
    if bias:
        specs.append((f"{name}.bias", (cout,), "uniform", cin * k * k))
    return specs


def _deconv(name, cin, cout, k=2):
    """A bias-free ConvTranspose2d, weight (in, out, k, k), fan = out * k * k."""
    return [(f"{name}.weight", (cin, cout, k, k), "normal", cout * k * k)]


def _norm(name, ch):
    return [(f"{name}.weight", (ch,), "ones", 0), (f"{name}.bias", (ch,), "zeros", 0)]


def rddbnet_specs(cfg: dict) -> list:
    """(name, shape, draw, fan) of every RDDBNet parameter."""
    nf, gc, nb = cfg["nf"], cfg["gc"], cfg["nb"]
    specs = _conv("conv_first", nf, cfg["in_ch"], 3)
    for b in range(nb):
        for r in range(1, 4):
            for i in range(5):
                specs += _conv(f"RRDB_trunk.{b}.RDB{r}.conv{i + 1}",
                               gc if i < 4 else nf, nf + i * gc, 3)
    specs += _conv("trunk_conv", nf, nf, 3)
    for j in range(n_up(cfg["up"])):
        specs += _deconv(f"upscale_layers.{2 * j}", nf, nf)
    return specs + _conv("conv_last", cfg["ou_ch"], nf, 3, bias=False)


def n_up(up: int) -> int:
    return up.bit_length() - 1


# (name, inplanes, planes, stride) of ResDeconv's residual stages, in order
_ENCODER = (("layer1", 64, 64, 1), ("layer2", 64, 128, 2), ("layer3", 128, 256, 2),
            ("layer4", 256, 512, 2))
_DECODER = (("deconv10", "upRes1", 512, 256), ("deconv11", "upRes2", 256, 128),
            ("deconv12", "upRes3", 128, 64))


def _stage_specs(name, inp, planes):
    specs = []
    for blk in range(2):
        cin = inp if blk == 0 else planes
        pre = f"{name}.{blk}"
        specs += _conv(f"{pre}.conv1", planes, cin, 3, bias=False) + _norm(f"{pre}.bn1", planes)
        specs += _conv(f"{pre}.conv2", planes, planes, 3, bias=False) + _norm(f"{pre}.bn2", planes)
        if blk == 0 and inp != planes:
            specs += (_conv(f"{pre}.downsample.0", planes, inp, 1, bias=False)
                      + _norm(f"{pre}.downsample.1", planes))
    return specs


def resdeconv_specs(cfg: dict) -> list:
    """(name, shape, draw, fan) of every ResDeconv parameter."""
    specs = _conv("conv1", 64, 3, 7, bias=False) + _norm("bn1", 64)
    for name, inp, planes, _ in _ENCODER:
        specs += _stage_specs(name, inp, planes)
    for dname, sname, cin, cout in _DECODER:
        specs += _deconv(dname, cin, cout) + _stage_specs(sname, cout, cout)
    specs += _deconv("deconv13", 64, 64)
    return specs + _conv("pred", cfg["tar_ch"], 64, 3, bias=False)


# -- the forwards ----------------------------------------------------------------------------

def _conv2d(p, q, x, name, stride=1, pad=1):
    return F.conv2d(q.act(x), q.weight(p[f"{name}.weight"]), p.get(f"{name}.bias"), stride, pad)


def _deconv2d(p, q, x, name):
    return F.conv_transpose2d(q.act(x), q.weight(p[f"{name}.weight"]), None, 2)


def rddbnet(p: dict, x: torch.Tensor, cfg: dict, q=FP32) -> torch.Tensor:
    """(N, in_ch, h, w) -> (N, ou_ch, h*up, w*up)."""
    fea = _conv2d(p, q, x, "conv_first")
    h = fea
    for b in range(cfg["nb"]):
        rrdb_in = h
        for r in range(1, 4):
            pre = f"RRDB_trunk.{b}.RDB{r}"
            feats = [h]
            for i in range(1, 5):
                feats.append(F.leaky_relu(_conv2d(p, q, torch.cat(feats, 1), f"{pre}.conv{i}"),
                                          0.2))
            h = _conv2d(p, q, torch.cat(feats, 1), f"{pre}.conv5") * 0.2 + h
        h = h * 0.2 + rrdb_in
    fea = fea + _conv2d(p, q, h, "trunk_conv")
    for j in range(n_up(cfg["up"])):
        fea = F.leaky_relu(_deconv2d(p, q, fea, f"upscale_layers.{2 * j}"), 0.2)
    return _conv2d(p, q, fea, "conv_last")


def _gn(p, x, name, groups):
    return F.group_norm(x, groups, p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def _stage(p, q, x, name, stride, groups):
    for blk in range(2):
        pre = f"{name}.{blk}"
        s = stride if blk == 0 else 1
        out = F.relu(_gn(p, _conv2d(p, q, x, f"{pre}.conv1", s), f"{pre}.bn1", groups))
        out = _gn(p, _conv2d(p, q, out, f"{pre}.conv2"), f"{pre}.bn2", groups)
        if f"{pre}.downsample.0.weight" in p:
            x = _gn(p, _conv2d(p, q, x, f"{pre}.downsample.0", s, 0), f"{pre}.downsample.1",
                    groups)
        x = F.relu(out + x)
    return x


def resdeconv(p: dict, x: torch.Tensor, cfg: dict, q=FP32) -> torch.Tensor:
    """(N, 1, H, W) gray -> (N, tar_ch, H, W); sides multiples of 16; GroupNorm
    over ``cfg["groups"]`` groups."""
    g = cfg["groups"]
    x = torch.cat([x, x, x], 1)
    x = F.relu(_gn(p, _conv2d(p, q, x, "conv1", 2, 3), "bn1", g))
    for name, _, _, stride in _ENCODER:
        x = _stage(p, q, x, name, stride, g)
    for dname, sname, _, _ in _DECODER:
        x = _stage(p, q, _deconv2d(p, q, x, dname), sname, 1, g)
    return _conv2d(p, q, _deconv2d(p, q, x, "deconv13"), "pred")


@torch.no_grad()
def serve_u8(p_sr: dict, p_c: dict, cfg: dict, gray_u8: torch.Tensor,
             q=FP32) -> torch.Tensor:
    """(N, h, w, 1) uint8 gray -> (N, h*up, w*up, 3) uint8 RGB: /255, the
    cascade of the configuration ``cfg``, clip to [0, 1], x255, round half
    to even."""
    x = gray_u8.permute(0, 3, 1, 2).float() / 255.0
    sr = rddbnet(p_sr, x, cfg["sr_model"], q)
    rgb = resdeconv(p_c, sr, cfg["c_model"], q).clamp(0.0, 1.0)
    return torch.round(rgb * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
