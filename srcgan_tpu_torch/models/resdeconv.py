"""ResDeconv, the ResNet-encoder / deconv-decoder colorizer, as in
``srcgan_tpu.models.resdeconv``."""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from srcgan_tpu_torch.models.blocks import deconv
from srcgan_tpu_torch.ops import norm
from srcgan_tpu_torch.ops.initializers import init_kaiming_


def make_norm(kind: str, ch: int) -> nn.Module:
    """BN / IN / GN selection; GN is GroupNorm(32, ch)."""
    if kind == "BN":
        return norm.BatchNorm2d(ch)
    if kind == "IN":
        return norm.InstanceNorm2d(ch)
    if kind == "GN":
        return norm.GroupNorm(32, ch)
    raise ValueError(f"unknown norm {kind!r}; one of BN, IN, GN")


class BasicBlock(nn.Module):
    """conv3x3(stride) -> norm -> relu -> conv3x3 -> norm -> (+ downsample(x)) -> relu.
    The ReLUs and the residual add are the norms' epilogues (``ops.norm``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, BN: str = "GN"):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = make_norm(BN, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = make_norm(BN, planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, 0, bias=False),
            make_norm(BN, planes)) if downsample else None)

    def forward(self, x):
        out = self.conv2(self.bn1(self.conv1(x), relu=True))
        # the convolutions in the JAX model's order: int8 scales are keyed by it
        identity = x if self.downsample is None else self.downsample(x)
        return self.bn2(out, residual=identity, relu=True)


def _stage(inplanes: int, planes: int, blocks: int, stride: int, BN: str
           ) -> nn.Sequential:
    downsample = stride != 1 or inplanes != planes
    layers: List[nn.Module] = [BasicBlock(inplanes, planes, stride, downsample, BN)]
    for _ in range(1, blocks):
        layers.append(BasicBlock(planes, planes, 1, False, BN))
    return nn.Sequential(*layers)


class ResDeconv(nn.Module):
    """ResNet-18-shaped encoder (2 BasicBlocks per stage) + 4 x [k2s2 deconv +
    residual stage] decoder -> 3x3 pred conv.  A gray input is repeated to 3
    channels.  Input sides must be multiples of 16 (four stride-2 stages)."""

    def __init__(self, src_ch: int = 1, tar_ch: int = 3, BN: str = "GN", *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.src_ch = src_ch
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = make_norm(BN, 64)
        self.layer1 = _stage(64, 64, 2, 1, BN)
        self.layer2 = _stage(64, 128, 2, 2, BN)
        self.layer3 = _stage(128, 256, 2, 2, BN)
        self.layer4 = _stage(256, 512, 2, 2, BN)
        self.deconv10 = deconv(512, 256, 2)
        self.upRes1 = _stage(256, 256, 2, 1, BN)
        self.deconv11 = deconv(256, 128, 2)
        self.upRes2 = _stage(128, 128, 2, 1, BN)
        self.deconv12 = deconv(128, 64, 2)
        self.upRes3 = _stage(64, 64, 2, 1, BN)
        self.deconv13 = deconv(64, 64, 2)
        self.pred = nn.Conv2d(64, tar_ch, 3, 1, 1, bias=False)
        init_kaiming_(self, generator)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x):
        if self.src_ch == 1:
            x = torch.cat([x, x, x], 1)
        x = self.bn1(self.conv1(x), relu=True)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.upRes1(self.deconv10(x))
        x = self.upRes2(self.deconv11(x))
        x = self.upRes3(self.deconv12(x))
        return self.pred(self.deconv13(x))
