"""The x4 cascade (RDDBNet, then the GroupNorm ResDeconv colorizer) over a
whole scene that no card holds, plain float32, in row blocks.

- The SR net runs block by block: each block of input rows with
  ``SR_HALO`` rows of the scene above and below it (fewer at the scene's
  edges), its output cropped to the block's rows.  RDDBNet's receptive
  field is 48 input rows (47 3x3 convs at 1x, conv_last's one row at 4x),
  so the crop is exact.
- The colorizer runs layer by layer over the whole scene, held as a list
  of row blocks spread over the devices it is given.  Each convolution
  takes ``CONV_HALO`` rows of the neighbouring blocks (at least its
  padding and a multiple of its stride, so a block's output rows are the
  whole scene's) and its own zero padding only at the scene's top and
  bottom; each GroupNorm takes its statistics by two passes over all
  blocks, float64 sums of x, then of (x - mean)^2; the last deconv and
  the pred conv run per block on a one-row halo.

The layer functions (``_conv2d``, ``_deconv2d``) and the colorizer's
stage tables are ``reference.cascade``'s; ``q`` is the precision of every
convolution, as there.  TF32 is off inside ``reference.cascade.exact_fp32``,
which the caller enters.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import cascade

SR_HALO = 64        # input rows, beyond RDDBNet's receptive field of 48
CONV_HALO = 4       # rows at a convolution's input: >= its padding, a multiple of its stride


class Scene:
    """A (N, C, H, W) tensor held as row blocks, each on a device, with one
    copy of the parameters per device."""

    def __init__(self, params: dict, q=cascade.FP32):
        self.params, self.q = params, q
        self._on = {}

    def p(self, device) -> dict:
        key = str(device)
        if key not in self._on:
            self._on[key] = {k: v.to(device) for k, v in self.params.items()}
        return self._on[key]

    # -- layers over a list of blocks ----------------------------------------------------

    def conv(self, blocks: list, name: str, stride: int = 1, pad: int = 1) -> list:
        out = []
        for i, b in enumerate(blocks):
            top = blocks[i - 1][:, :, -CONV_HALO:].to(b.device) if i else None
            bottom = blocks[i + 1][:, :, :CONV_HALO].to(b.device) if i + 1 < len(blocks) else None
            x = torch.cat([t for t in (top, b, bottom) if t is not None], 2)
            y = cascade._conv2d(self.p(b.device), self.q, x, name, stride, pad)
            t0 = CONV_HALO // stride if top is not None else 0
            out.append(y[:, :, t0:t0 + b.shape[2] // stride].contiguous())
        return out

    def deconv(self, blocks: list, name: str) -> list:
        return [cascade._deconv2d(self.p(b.device), self.q, b, name) for b in blocks]

    def group_norm(self, blocks: list, name: str, groups: int, eps: float = 1e-5) -> list:
        n, c = blocks[0].shape[:2]
        home = blocks[0].device
        grouped = lambda b: b.reshape(n, groups, -1)  # noqa: E731
        count = sum(grouped(b).shape[-1] for b in blocks)
        mean = sum(grouped(b).double().sum(-1).to(home) for b in blocks) / count
        var = sum(((grouped(b).double() - mean.to(b.device)[..., None]) ** 2).sum(-1).to(home)
                  for b in blocks) / count
        rstd = torch.rsqrt(var + eps)
        out = []
        for b in blocks:
            p = self.p(b.device)
            m, r = mean.to(b.device, torch.float32), rstd.to(b.device, torch.float32)
            y = ((grouped(b) - m[..., None]) * r[..., None]).reshape(b.shape)
            out.append(y * p[f"{name}.weight"].view(1, -1, 1, 1)
                       + p[f"{name}.bias"].view(1, -1, 1, 1))
        return out

    def stage(self, x: list, name: str, stride: int, groups: int) -> list:
        """``reference.cascade._stage`` over blocks."""
        for blk in range(2):
            pre = f"{name}.{blk}"
            s = stride if blk == 0 else 1
            out = [F.relu(t) for t in self.group_norm(self.conv(x, f"{pre}.conv1", s),
                                                      f"{pre}.bn1", groups)]
            out = self.group_norm(self.conv(out, f"{pre}.conv2"), f"{pre}.bn2", groups)
            if f"{pre}.downsample.0.weight" in self.params:
                x = self.group_norm(self.conv(x, f"{pre}.downsample.0", s, 0),
                                    f"{pre}.downsample.1", groups)
            x = [F.relu(a + b) for a, b in zip(out, x)]
        return x

    def last(self, blocks: list, deconv_name: str, pred_name: str) -> list:
        """The k2s2 deconv and the 3x3 pred conv, per block on a one-row halo."""
        out = []
        for i, b in enumerate(blocks):
            top = blocks[i - 1][:, :, -1:].to(b.device) if i else None
            bottom = blocks[i + 1][:, :, :1].to(b.device) if i + 1 < len(blocks) else None
            x = torch.cat([t for t in (top, b, bottom) if t is not None], 2)
            p = self.p(b.device)
            y = cascade._conv2d(p, self.q, cascade._deconv2d(p, self.q, x, deconv_name),
                                pred_name)
            t0 = 2 if top is not None else 0
            out.append(y[:, :, t0:t0 + 2 * b.shape[2]])
        return out


def sr_blocks(p_sr: dict, scene_u8: torch.Tensor, cfg: dict, devices: list, rows: int,
              q=cascade.FP32) -> list:
    """RDDBNet's (1, 1, H*up, W*up) output of an (H, W, 1) uint8 scene as
    blocks of ``rows`` input rows (times up), block i on the device of its
    place in the scene."""
    h, up = scene_u8.shape[0], cfg["up"]
    net = Scene(p_sr, q)
    n = -(-h // rows)
    out = []
    for i in range(n):
        a, b = i * rows, min((i + 1) * rows, h)
        a0, b0 = max(a - SR_HALO, 0), min(b + SR_HALO, h)
        dev = devices[i * len(devices) // n]
        x = scene_u8[a0:b0].to(dev).permute(2, 0, 1)[None].float() / 255.0
        y = cascade.rddbnet(net.p(dev), x, cfg, q)
        out.append(y[:, :, (a - a0) * up:(b - a0) * up].contiguous())
    return out


def colorize(p_c: dict, blocks: list, cfg: dict, q=cascade.FP32) -> list:
    """``reference.cascade.resdeconv`` over blocks of gray rows (each a
    multiple of 16 rows tall): the RGB blocks."""
    net, g = Scene(p_c, q), cfg["groups"]
    x = [torch.cat([b, b, b], 1) for b in blocks]
    x = [F.relu(t) for t in net.group_norm(net.conv(x, "conv1", 2, 3), "bn1", g)]
    for name, _, _, stride in cascade._ENCODER:
        x = net.stage(x, name, stride, g)
    for dname, sname, _, _ in cascade._DECODER:
        x = net.stage(net.deconv(x, dname), sname, 1, g)
    return net.last(x, "deconv13", "pred")


@torch.no_grad()
def serve_u8(p_sr: dict, p_c: dict, cfg: dict, scene_u8, devices: list, rows: int = 512,
             q=cascade.FP32) -> np.ndarray:
    """(H, W, 1) uint8 gray scene -> (H*up, W*up, 3) uint8 RGB: /255, the
    cascade of the configuration ``cfg`` in blocks of ``rows`` input rows
    over ``devices``, clip to [0, 1], x255, round half to even."""
    scene = torch.as_tensor(np.ascontiguousarray(scene_u8))
    rgb = colorize(p_c, sr_blocks(p_sr, scene, cfg["sr_model"], devices, rows, q),
                   cfg["c_model"], q)
    parts = [torch.round(b.clamp(0.0, 1.0) * 255.0).to(torch.uint8)[0].permute(1, 2, 0).cpu()
             for b in rgb]
    return torch.cat(parts, 0).numpy()
