"""The EDSR-derived zoo: VDSR, MDSR, RDN, RCAN, DDBPN and EDSRWeb, as in
``srcgan_tpu.models.edsr_zoo``.

Keyword-constructed from an ``args`` namespace with EDSR-PyTorch's defaults
(``args_namespace``), as the JAX package builds them.  Inputs are in
``rgb_range`` (255), except EDSRWeb's, which are in [0, 1] with its own
+-0.5 shift, and those of RCAN's cascade form, ``RCAN(in_ch, ou_ch, up)``
(``models.create("RCAN", 1, 1, 4)``), in [0, 1].  NCHW modules in
channels_last; each attribute keeps its JAX tree name, which is the
reference torch name where the JAX package chose one, so ``interop``
carries weights across both ways.  Two kinds of leaf need it to:

- ``MeanShift`` is a frozen constant: not in the JAX parameter tree, but the
  reference state_dict holds it as a 1x1 conv (a diagonal weight and a
  bias), so here it is two buffers under those names, which
  ``interop.state_dict_from_jax`` fills from the module and
  ``interop.jax_tree_from_module`` leaves out.
- ``nn.PReLU``'s ``weight`` is the JAX ``alpha``.

Init: torch's default uniform (the reference never re-initializes these),
EDSRWeb's kaiming normal (fan_out, relu).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from srcgan_tpu_torch.ops.initializers import init_kaiming_, init_torch_default_

RGB_MEAN = (0.4488, 0.4371, 0.4040)
# one channel's mean: the BT.601 luma of RGB_MEAN (the published nets are RGB only)
GRAY_MEAN = (0.299 * RGB_MEAN[0] + 0.587 * RGB_MEAN[1] + 0.114 * RGB_MEAN[2],)


def color_mean(n_colors: int) -> tuple:
    """The MeanShift mean of an image of ``n_colors`` channels (1 or 3)."""
    if n_colors not in (1, 3):
        raise ValueError(f"n_colors must be 1 or 3, not {n_colors}")
    return RGB_MEAN if n_colors == 3 else GRAY_MEAN


def args_namespace(**kw) -> SimpleNamespace:
    """Reference-style args object with EDSR-PyTorch defaults."""
    defaults = dict(n_resblocks=16, n_feats=64, scale=[2], rgb_range=255,
                    n_colors=3, res_scale=1.0, n_resgroups=10, reduction=16,
                    G0=64, RDNkSize=3, RDNconfig="B")
    defaults.update(kw)
    return SimpleNamespace(**defaults)


def _conv(in_ch, out_ch, k, bias=True):
    """Same-padding conv (the reference's ``default_conv``)."""
    return nn.Conv2d(in_ch, out_ch, k, 1, k // 2, bias=bias)


def _finish(module: nn.Module, init, generator, device):
    init(module, generator)
    module.to(device=device, memory_format=torch.channels_last)


class MeanShift(nn.Module):
    """Frozen 1x1 channel-wise shift: y = x / std + sign * range * mean / std,
    held as the reference's conv weight (diagonal) and bias, buffers."""

    jax_constant = True         # no JAX tree holds these (see ``interop``)

    def __init__(self, rgb_range, rgb_mean=RGB_MEAN, rgb_std=None, sign=-1):
        super().__init__()
        rgb_std = rgb_std or (1.0,) * len(rgb_mean)
        std = torch.tensor(rgb_std, dtype=torch.float32)
        mean = torch.tensor(rgb_mean, dtype=torch.float32)
        self.register_buffer("weight", torch.diag(1.0 / std)[:, :, None, None])
        self.register_buffer("bias", sign * rgb_range * mean / std)

    def forward(self, x):
        c = (1, -1, 1, 1)
        scale = self.weight[:, :, 0, 0].diagonal().to(x.dtype).view(c)
        return x * scale + self.bias.to(x.dtype).view(c)


class ResBlock(nn.Module):
    """conv - relu - conv, the residual scaled by ``res_scale``."""

    def __init__(self, n_feats: int, kernel_size: int, bias: bool = True,
                 res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.body = nn.Sequential(_conv(n_feats, n_feats, kernel_size, bias), nn.ReLU(),
                                  _conv(n_feats, n_feats, kernel_size, bias))

    def forward(self, x):
        return self.body(x) * self.res_scale + x


class Upsampler(nn.Sequential):
    """[conv to 4 n_feats, PixelShuffle(2)] x log2(scale), or conv to 9
    n_feats and PixelShuffle(3)."""

    def __init__(self, scale: int, n_feats: int, bias: bool = True):
        layers = []
        if (scale & (scale - 1)) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [_conv(n_feats, 4 * n_feats, 3, bias), nn.PixelShuffle(2)]
        elif scale == 3:
            layers += [_conv(n_feats, 9 * n_feats, 3, bias), nn.PixelShuffle(3)]
        else:
            raise NotImplementedError(scale)
        super().__init__(*layers)


class VDSR(nn.Module):
    """MeanShift-wrapped stack of conv-relu pairs (20 convs) with the
    residual in image space; the last conv is a Sequential of its own, as
    in the reference (``body.<last>.0``)."""

    def __init__(self, args: Optional[SimpleNamespace] = None, *, device=None,
                 generator: torch.Generator | None = None, **kw):
        super().__init__()
        a = args or args_namespace(**{"n_resblocks": 20, "n_feats": 64, **kw})
        self.sub_mean = MeanShift(a.rgb_range)
        self.add_mean = MeanShift(a.rgb_range, sign=1)
        body = [nn.Sequential(_conv(a.n_colors, a.n_feats, 3), nn.ReLU())]
        body += [nn.Sequential(_conv(a.n_feats, a.n_feats, 3), nn.ReLU())
                 for _ in range(a.n_resblocks - 2)]
        body.append(nn.Sequential(_conv(a.n_feats, a.n_colors, 3)))
        self.body = nn.Sequential(*body)
        _finish(self, init_torch_default_, generator, device)

    def forward(self, x):
        x = self.sub_mean(x)
        return self.add_mean(self.body(x) + x)


class MDSR(nn.Module):
    """Multi-scale EDSR: a shared head and body, and per scale a
    pre-processing pair of k5 ResBlocks and an Upsampler; ``set_scale``
    picks the scale's index.  Registered in the reference's order."""

    def __init__(self, args: Optional[SimpleNamespace] = None, *, device=None,
                 generator: torch.Generator | None = None, **kw):
        super().__init__()
        a = args or args_namespace(**kw)
        self.scales = list(a.scale)
        self.scale_idx = 0
        self.sub_mean = MeanShift(a.rgb_range)
        self.add_mean = MeanShift(a.rgb_range, sign=1)
        self.pre_process = nn.ModuleList(
            [nn.Sequential(ResBlock(a.n_feats, 5), ResBlock(a.n_feats, 5)) for _ in self.scales])
        self.upsample = nn.ModuleList([Upsampler(s, a.n_feats) for s in self.scales])
        self.head = nn.Sequential(_conv(a.n_colors, a.n_feats, 3))
        self.body = nn.Sequential(*[ResBlock(a.n_feats, 3) for _ in range(a.n_resblocks)],
                                  _conv(a.n_feats, a.n_feats, 3))
        self.tail = nn.Sequential(_conv(a.n_feats, a.n_colors, 3))
        _finish(self, init_torch_default_, generator, device)

    def set_scale(self, scale_idx: int):
        self.scale_idx = scale_idx

    def forward(self, x):
        i = self.scale_idx
        x = self.pre_process[i](self.head(self.sub_mean(x)))
        x = self.upsample[i](self.body(x) + x)
        return self.add_mean(self.tail(x))


class RDBConv(nn.Module):
    """One dense conv of an RDB: conv - relu, its output appended to its input."""

    def __init__(self, c_in: int, g: int, k: int = 3):
        super().__init__()
        self.conv = nn.Sequential(_conv(c_in, g, k), nn.ReLU())

    def forward(self, x):
        return torch.cat([x, self.conv(x)], 1)


class _RDB(nn.Module):
    """C dense convs, a 1x1 local feature fusion (LFF), the residual."""

    def __init__(self, g0: int, g: int, c: int, k: int = 3):
        super().__init__()
        self.convs = nn.Sequential(*[RDBConv(g0 + i * g, g, k) for i in range(c)])
        self.LFF = nn.Conv2d(g0 + c * g, g0, 1, 1, 0)

    def forward(self, x):
        return self.LFF(self.convs(x)) + x


class RDN(nn.Module):
    """Shallow features (SFENet1, SFENet2), D RDBs, global fusion (GFF) with
    the residual to SFENet1's output, PixelShuffle up (UPNet).  Config A is
    (D, C, G) = (20, 6, 32), B (16, 8, 64)."""

    def __init__(self, args: Optional[SimpleNamespace] = None, *, device=None,
                 generator: torch.Generator | None = None, **kw):
        super().__init__()
        a = args or args_namespace(**kw)
        r = a.scale[0]
        g0, k = a.G0, a.RDNkSize
        self.d, c, g = {"A": (20, 6, 32), "B": (16, 8, 64)}[a.RDNconfig]
        self.SFENet1 = _conv(a.n_colors, g0, k)
        self.SFENet2 = _conv(g0, g0, k)
        self.RDBs = nn.ModuleList([_RDB(g0, g, c, k) for _ in range(self.d)])
        self.GFF = nn.Sequential(nn.Conv2d(self.d * g0, g0, 1, 1, 0), _conv(g0, g0, k))
        if r in (2, 3):
            self.UPNet = nn.Sequential(_conv(g0, g * r * r, k), nn.PixelShuffle(r),
                                       _conv(g, a.n_colors, k))
        elif r == 4:
            self.UPNet = nn.Sequential(_conv(g0, g * 4, k), nn.PixelShuffle(2),
                                       _conv(g, g * 4, k), nn.PixelShuffle(2),
                                       _conv(g, a.n_colors, k))
        else:
            raise ValueError("scale must be 2 or 3 or 4.")
        _finish(self, init_torch_default_, generator, device)

    def forward(self, x):
        f1 = self.SFENet1(x)
        x = self.SFENet2(f1)
        outs = []
        for rdb in self.RDBs:
            x = rdb(x)
            outs.append(x)
        return self.UPNet(self.GFF(torch.cat(outs, 1)) + f1)


class CALayer(nn.Module):
    """Channel attention: the mean over H and W, 1x1 conv down by
    ``reduction``, relu, 1x1 conv up, sigmoid; x times that."""

    # a reduction over the whole image, which ``parallel.spatial``'s strips
    # do not all-reduce: the space-sharded predictors refuse it
    global_spatial_reduction = True

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.conv_du = nn.Sequential(nn.Conv2d(channel, channel // reduction, 1, 1, 0),
                                     nn.ReLU(),
                                     nn.Conv2d(channel // reduction, channel, 1, 1, 0),
                                     nn.Sigmoid())

    def forward(self, x):
        return x * self.conv_du(x.mean(dim=(2, 3), keepdim=True))


class RCAB(nn.Module):
    """conv - relu - conv - channel attention, plus the residual."""

    def __init__(self, n_feat: int, kernel_size: int, reduction: int):
        super().__init__()
        self.body = nn.Sequential(_conv(n_feat, n_feat, kernel_size), nn.ReLU(),
                                  _conv(n_feat, n_feat, kernel_size),
                                  CALayer(n_feat, reduction))

    def forward(self, x):
        return self.body(x) + x


class _ResGroup(nn.Module):
    """A residual group: ``body`` plus the residual."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body

    def forward(self, x):
        return self.body(x) + x


class RCAN(nn.Module):
    """MeanShift-wrapped head, ``n_resgroups`` residual groups of
    ``n_resblocks`` RCABs and a conv each, a body conv with the long
    residual, an Upsampler tail.

    ``RCAN(args)`` (or keywords over ``args_namespace``) is the zoo's form,
    in ``rgb_range`` 255 by default; ``RCAN(in_ch, ou_ch, up)`` is an SR
    stage of the cascade at the published x4 widths (10 groups of 20 RCABs,
    64 features, reduction 16, keywords override them) on [0, 1] images
    (``rgb_range`` 1).  A one-channel image shifts by ``GRAY_MEAN``."""

    def __init__(self, args=None, ou_ch: Optional[int] = None, up: Optional[int] = None, *,
                 device=None, generator: torch.Generator | None = None, **kw):
        super().__init__()
        if isinstance(args, int):
            widths = {**dict(n_resgroups=10, n_resblocks=20, n_feats=64, reduction=16), **kw}
            a = args_namespace(scale=[up], rgb_range=1, n_colors=args, **widths)
            in_ch, ou_ch = args, ou_ch
        else:
            a = args or args_namespace(**kw)
            in_ch = ou_ch = a.n_colors

        def group():
            return _ResGroup(nn.Sequential(
                *[RCAB(a.n_feats, 3, a.reduction) for _ in range(a.n_resblocks)],
                _conv(a.n_feats, a.n_feats, 3)))

        self.sub_mean = MeanShift(a.rgb_range, color_mean(in_ch))
        self.head = nn.Sequential(_conv(in_ch, a.n_feats, 3))
        self.body = nn.Sequential(*[group() for _ in range(a.n_resgroups)],
                                  _conv(a.n_feats, a.n_feats, 3))
        self.tail = nn.Sequential(Upsampler(a.scale[0], a.n_feats),
                                  _conv(a.n_feats, ou_ch, 3))
        self.add_mean = MeanShift(a.rgb_range, color_mean(ou_ch), sign=1)
        _finish(self, init_torch_default_, generator, device)

    def forward(self, x):
        x = self.head(self.sub_mean(x))
        return self.add_mean(self.tail(self.body(x) + x))


def _projection(in_ch, out_ch, scale, up: bool) -> nn.Module:
    """(k, s, p) = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}; a transposed
    conv up, a conv down."""
    k, s, pad = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}[scale]
    if up:
        return nn.ConvTranspose2d(in_ch, out_ch, k, s, pad)
    return nn.Conv2d(in_ch, out_ch, k, s, pad)


class DenseProjection(nn.Module):
    """Back-projection unit: (a 1x1 bottleneck), a0 = act(conv_1(x)),
    e = act(conv_2(a0)) - x, out = a0 + act(conv_3(e))."""

    def __init__(self, in_ch: int, nr: int, scale: int, up: bool = True,
                 bottleneck: bool = True):
        super().__init__()
        inter = nr if bottleneck else in_ch
        if bottleneck:
            self.bottleneck = nn.Conv2d(in_ch, nr, 1, 1, 0)
            self.bottleneck_act = nn.PReLU(nr)
        else:
            self.bottleneck = None
        self.conv_1 = _projection(inter, nr, scale, up)
        self.act_1 = nn.PReLU(nr)
        self.conv_2 = _projection(nr, inter, scale, not up)
        self.act_2 = nn.PReLU(inter)
        self.conv_3 = _projection(inter, nr, scale, up)
        self.act_3 = nn.PReLU(nr)

    def forward(self, x):
        if self.bottleneck is not None:
            x = self.bottleneck_act(self.bottleneck(x))
        a0 = self.act_1(self.conv_1(x))
        e = self.act_2(self.conv_2(a0)) - x
        return a0 + self.act_3(self.conv_3(e))


class DDBPN(nn.Module):
    """Dense deep back-projection, depth 6, n0 128, nr 32: initial features,
    up and down projections each fed the concat of the other kind's
    outputs so far, a reconstruction conv over all up outputs."""

    def __init__(self, args: Optional[SimpleNamespace] = None, *, device=None,
                 generator: torch.Generator | None = None, **kw):
        super().__init__()
        a = args or args_namespace(**kw)
        scale = a.scale[0]
        n0, nr = 128, 32
        self.depth = 6
        self.sub_mean = MeanShift(a.rgb_range, RGB_MEAN)
        self.init_conv1 = nn.Conv2d(a.n_colors, n0, 3, 1, 1)
        self.init_act1 = nn.PReLU(n0)
        self.init_conv2 = nn.Conv2d(n0, nr, 1, 1, 0)
        self.init_act2 = nn.PReLU(nr)
        ch = nr
        for i in range(self.depth):
            setattr(self, f"up{i}", DenseProjection(ch, nr, scale, True, i > 1))
            if i != 0:
                ch += nr
        ch = nr
        for i in range(self.depth - 1):
            setattr(self, f"down{i}", DenseProjection(ch, nr, scale, False, i != 0))
            ch += nr
        self.reconstruction = nn.Conv2d(self.depth * nr, a.n_colors, 3, 1, 1)
        self.add_mean = MeanShift(a.rgb_range, RGB_MEAN, sign=1)
        _finish(self, init_torch_default_, generator, device)

    def forward(self, x):
        x = self.init_act1(self.init_conv1(self.sub_mean(x)))
        x = self.init_act2(self.init_conv2(x))
        h_list, l_list = [], []
        for i in range(self.depth - 1):
            low = x if i == 0 else torch.cat(l_list, 1)
            h_list.append(getattr(self, f"up{i}")(low))
            l_list.append(getattr(self, f"down{i}")(torch.cat(h_list, 1)))
        h_list.append(getattr(self, f"up{self.depth - 1}")(torch.cat(l_list, 1)))
        return self.add_mean(self.reconstruction(torch.cat(h_list, 1)))


class EDSRWeb(nn.Module):
    """The classic EDSR baseline (r16f64) with the +-0.5 input/output shift:
    head conv, ``n_resblocks`` ResBlocks and a conv with the global
    residual, Upsampler and tail conv; kaiming (fan_out, relu) on every
    conv.  ``EDSRWeb(in, out, up)`` is an SR stage of the cascade."""

    def __init__(self, in_ch: int, ou_ch: int, upscale_factor: int, n_resblocks: int = 16,
                 n_feats: int = 64, *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.head = nn.Sequential(_conv(in_ch, n_feats, 3))
        self.body = nn.Sequential(*[ResBlock(n_feats, 3) for _ in range(n_resblocks)],
                                  _conv(n_feats, n_feats, 3))
        self.tail = nn.Sequential(Upsampler(upscale_factor, n_feats), _conv(n_feats, ou_ch, 3))
        _finish(self, init_kaiming_, generator, device)

    def forward(self, x):
        x = self.head(x - 0.5)
        return self.tail(self.body(x) + x) + 0.5

