"""The pix2pix / CycleGAN generator kit, as in ``srcgan_tpu.models.pix2pix``.

``ResnetGenerator`` (reflect-padded, 9 or 6 blocks), ``UnetGenerator``
(recursive skip blocks), the norm selector and the ``define_G`` factory,
which the multi-task trainer builds its colorization cycle from.  NCHW
modules in channels_last, as ``models.legacy``.

Names: every generator keeps its layers in an ``nn.Sequential`` named
``model`` (a resnet block in one named ``conv_block``), whose indices are
those of the JAX Sequential; the JAX parameter tree starts below each of
them (``jax_root``, read by ``interop``).  A U-Net nests its blocks, each
in the ``model`` of the block outside it at the JAX index, so the torch
names read ``model.model.1.model.1...``.

- Reflect padding is torch's, which needs the pad smaller than the map: a
  ResnetGenerator input must be at least 8 on a side.  A U-Net input must
  be a multiple of 2^num_downs on both sides (256 for ``unet_256``), or its
  innermost map is empty, in either package.
- ``Dropout`` is inverted dropout (zero with probability p, survivors
  scaled by 1/(1-p)) drawn from its ``generator`` in train mode, identity
  in eval mode; the masks are not JAX's.  ``define_G`` leaves it off, as
  the reference training scripts do.  A checkpointed pass (remat) redraws
  the mask in its recompute unless the draw comes from the default
  generator, whose state the checkpoint restores.
- Init: N(0, 0.02) weights (``ops.initializers.init_normal_``); norm
  affines keep ones and zeros.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from srcgan_tpu_torch.ops import norm as norm_ops
from srcgan_tpu_torch.ops.initializers import init_normal_


class Dropout(nn.Module):
    """Inverted dropout with an explicit ``torch.Generator`` (on the input's
    device; None draws from the default one)."""

    def __init__(self, p: float = 0.5, generator: torch.Generator | None = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def _norm(norm_type: str, ch: int) -> nn.Module:
    """batch | instance | none."""
    if norm_type == "batch":
        return norm_ops.BatchNorm2d(ch)
    if norm_type == "instance":
        return norm_ops.InstanceNorm2d(ch)
    if norm_type == "none":
        return nn.Identity()
    raise NotImplementedError(f"normalization layer [{norm_type}] is not found")


def _finish(module: nn.Module, generator, device):
    init_normal_(module, generator)
    module.to(device=device, memory_format=torch.channels_last)


class Pix2PixResnetBlock(nn.Module):
    """[pad conv norm relu (dropout) pad conv norm] + x."""

    jax_root = "conv_block"

    def __init__(self, dim: int, padding_type: str = "reflect", norm: str = "batch",
                 use_dropout: bool = False, use_bias: bool = False):
        super().__init__()
        layers = []
        for i in range(2):
            if padding_type == "reflect":
                layers.append(nn.ReflectionPad2d(1))
                p = 0
            elif padding_type == "zero":
                p = 1
            else:
                raise NotImplementedError(padding_type)
            layers += [nn.Conv2d(dim, dim, 3, 1, p, bias=use_bias), _norm(norm, dim)]
            if i == 0:
                layers.append(nn.ReLU())
                if use_dropout:
                    layers.append(Dropout(0.5))
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """Reflect-padded 7x7 stem, two stride-2 downs, ``n_blocks`` resnet
    blocks at 4 ngf, two k3 s2 p1 op1 deconv ups, a reflect-padded 7x7 head
    with tanh.  Convs that a norm follows have a bias only with instance
    norm."""

    jax_root = "model"

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64, norm: str = "batch",
                 use_dropout: bool = False, n_blocks: int = 6, padding_type: str = "reflect",
                 *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        use_bias = norm == "instance"
        layers = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7, 1, 0, bias=use_bias),
                  _norm(norm, ngf), nn.ReLU()]
        for i in range(2):
            mult = 2 ** i
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, 2, 1, bias=use_bias),
                       _norm(norm, ngf * mult * 2), nn.ReLU()]
        layers += [Pix2PixResnetBlock(ngf * 4, padding_type, norm, use_dropout, use_bias)
                   for _ in range(n_blocks)]
        for i in range(2):
            mult = 2 ** (2 - i)
            layers += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, 2, padding=1,
                                          output_padding=1, bias=use_bias),
                       _norm(norm, ngf * mult // 2), nn.ReLU()]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7, 1, 0), nn.Tanh()]
        self.model = nn.Sequential(*layers)
        _finish(self, generator, device)

    def forward(self, x):
        return self.model(x)


class UnetSkipConnectionBlock(nn.Module):
    """One level of the U-Net: k4 s2 down, the ``submodule``, k4 s2 up; every
    level but the outermost returns concat([x, y]) on the channel axis."""

    jax_root = "model"

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "batch", use_dropout: bool = False):
        super().__init__()
        self.outermost = outermost
        use_bias = norm == "instance"
        if input_nc is None:
            input_nc = outer_nc
        downconv = nn.Conv2d(input_nc, inner_nc, 4, 2, 1, bias=use_bias)
        if outermost:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1)
            layers = [downconv, submodule, nn.ReLU(), upconv, nn.Tanh()]
        elif innermost:
            upconv = nn.ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1, bias=use_bias)
            layers = [nn.LeakyReLU(0.2), downconv, nn.ReLU(), upconv, _norm(norm, outer_nc)]
        else:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1, bias=use_bias)
            layers = [nn.LeakyReLU(0.2), downconv, _norm(norm, inner_nc), submodule,
                      nn.ReLU(), upconv, _norm(norm, outer_nc)]
            if use_dropout:
                layers.append(Dropout(0.5))
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        y = self.model(x)
        return y if self.outermost else torch.cat([x, y], 1)


class UnetGenerator(nn.Module):
    """Built innermost-out: ``num_downs`` levels (unet_256 = 8, unet_128 =
    7), the inner ones at 8 ngf."""

    jax_root = "model"

    def __init__(self, input_nc: int, output_nc: int, num_downs: int, ngf: int = 64,
                 norm: str = "batch", use_dropout: bool = False, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, norm=norm, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block, norm=norm,
                                            use_dropout=use_dropout)
        block = UnetSkipConnectionBlock(ngf * 4, ngf * 8, submodule=block, norm=norm)
        block = UnetSkipConnectionBlock(ngf * 2, ngf * 4, submodule=block, norm=norm)
        block = UnetSkipConnectionBlock(ngf, ngf * 2, submodule=block, norm=norm)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc,
                                             submodule=block, outermost=True, norm=norm)
        _finish(self, generator, device)

    def forward(self, x):
        return self.model(x)


def define_G(input_nc: int, output_nc: int, ngf: int, netG: str, norm: str = "batch",
             use_dropout: bool = False, *, device=None,
             generator: torch.Generator | None = None) -> nn.Module:
    """Generator factory by name: resnet_9blocks | resnet_6blocks | unet_128 |
    unet_256.  The weights are drawn from N(0, 0.02)."""
    kw = dict(device=device, generator=generator)
    if netG == "resnet_9blocks":
        return ResnetGenerator(input_nc, output_nc, ngf, norm, use_dropout, 9, **kw)
    if netG == "resnet_6blocks":
        return ResnetGenerator(input_nc, output_nc, ngf, norm, use_dropout, 6, **kw)
    if netG == "unet_128":
        return UnetGenerator(input_nc, output_nc, 7, ngf, norm, use_dropout, **kw)
    if netG == "unet_256":
        return UnetGenerator(input_nc, output_nc, 8, ngf, norm, use_dropout, **kw)
    raise NotImplementedError(f"Generator model name [{netG}] is not recognized")
