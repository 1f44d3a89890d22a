"""RCAN as plain functions of a parameter dict, and the cascade with it as the
SR stage.

The layer equations of Zhang et al., "Image Super-Resolution Using Very Deep
Residual Channel Attention Networks" (ECCV 2018), as
github.com/yulunzhang/RCAN ``RCAN_TrainCode/code/model/rcan.py`` writes
them: a mean shift, a head conv, ``n_resgroups`` residual groups of
``n_resblocks`` RCABs (conv, ReLU, conv, channel attention, plus the
residual) and a conv each, plus the group's residual; a body conv plus the
long residual; per factor 2 a conv to 4 ``n_feats`` and a pixel shuffle; a
last conv; the mean shift back.  Channel attention: the mean over H and W,
a 1x1 conv down by ``reduction``, ReLU, a 1x1 conv up, sigmoid, the input
scaled by it per channel.  The parameter names are the port's state-dict
names (``srcgan_tpu_torch.models.edsr_zoo.RCAN``), so one dict serves both.

Departures from the published net (the configuration's ``assumed``):

- one gray channel in and out, shifted by the BT.601 luma of the published
  RGB mean (``GRAY_MEAN``), with ``rgb_range`` 1 (the cascade's [0, 1]);
- the mean shifts are entries of the dict (the port holds them as buffers
  under those names), made here from the constants, not drawn.

``serve_u8`` is ``reference.cascade.serve_u8`` with this net in RDDBNet's
place; ``q`` is the precision of every convolution, as there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import cascade

RGB_MEAN = (0.4488, 0.4371, 0.4040)
GRAY_MEAN = 0.299 * RGB_MEAN[0] + 0.587 * RGB_MEAN[1] + 0.114 * RGB_MEAN[2]


def _mean(ch: int) -> tuple:
    return RGB_MEAN if ch == 3 else (GRAY_MEAN,) * ch


def n_up(up: int) -> int:
    if up & (up - 1):
        raise ValueError(f"the reference builds power-of-two factors, not x{up}")
    return up.bit_length() - 1


def rcab(g: int, b: int) -> str:
    """The name prefix of RCAB ``b`` of group ``g``."""
    return f"body.{g}.body.{b}.body"


def specs(cfg: dict) -> list:
    """(name, shape, draw, fan) of every RCAN parameter, in
    ``reference.cascade``'s form: kaiming normal weights over fan_out,
    uniform biases over fan_in."""
    nf, red = cfg["n_feats"], cfg["reduction"]
    groups, blocks = cfg["n_resgroups"], cfg["n_resblocks"]
    out = cascade._conv("head.0", nf, cfg["in_ch"], 3)
    for g in range(groups):
        for b in range(blocks):
            pre = rcab(g, b)
            out += cascade._conv(f"{pre}.0", nf, nf, 3) + cascade._conv(f"{pre}.2", nf, nf, 3)
            out += (cascade._conv(f"{pre}.3.conv_du.0", nf // red, nf, 1)
                    + cascade._conv(f"{pre}.3.conv_du.2", nf, nf // red, 1))
        out += cascade._conv(f"body.{g}.body.{blocks}", nf, nf, 3)
    out += cascade._conv(f"body.{groups}", nf, nf, 3)
    for j in range(n_up(cfg["up"])):
        out += cascade._conv(f"tail.0.{2 * j}", 4 * nf, nf, 3)
    return out + cascade._conv("tail.1", cfg["ou_ch"], nf, 3)


def constants(cfg: dict, device=None) -> dict:
    """The mean shifts (``rgb_range`` 1, std 1): a diagonal 1x1 weight and a
    bias, ``sub_mean`` over the input's channels, ``add_mean`` the output's."""
    out = {}
    for name, ch, sign in (("sub_mean", cfg["in_ch"], -1.0), ("add_mean", cfg["ou_ch"], 1.0)):
        out[f"{name}.weight"] = torch.eye(ch, device=device)[:, :, None, None]
        out[f"{name}.bias"] = sign * torch.tensor(_mean(ch), device=device)
    return out


def _shift(p, x, name):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"])


def attention(p: dict, u: torch.Tensor, name: str, q=cascade.FP32) -> torch.Tensor:
    """The channel attention's gates, (N, C, 1, 1) in (0, 1)."""
    m = u.mean(dim=(2, 3), keepdim=True)
    z = F.relu(cascade._conv2d(p, q, m, f"{name}.conv_du.0", 1, 0))
    return torch.sigmoid(cascade._conv2d(p, q, z, f"{name}.conv_du.2", 1, 0))


def rcan(p: dict, x: torch.Tensor, cfg: dict, q=cascade.FP32, taps=None) -> torch.Tensor:
    """(N, in_ch, h, w) in [0, 1] -> (N, ou_ch, h*up, w*up).  ``taps``, a
    dict, collects the head's output, each group's and the gates."""
    groups, blocks = cfg["n_resgroups"], cfg["n_resblocks"]
    x = cascade._conv2d(p, q, _shift(p, x, "sub_mean"), "head.0")
    h = x
    for g in range(groups):
        g_in = h
        for b in range(blocks):
            pre = rcab(g, b)
            u = cascade._conv2d(p, q, F.relu(cascade._conv2d(p, q, h, f"{pre}.0")), f"{pre}.2")
            gate = attention(p, u, f"{pre}.3", q)
            if taps is not None:
                taps.setdefault("gates", []).append(gate.flatten())
            h = h + u * gate
        h = cascade._conv2d(p, q, h, f"body.{g}.body.{blocks}") + g_in
        if taps is not None:
            taps.setdefault("groups", []).append(h)
    h = cascade._conv2d(p, q, h, f"body.{groups}") + x
    if taps is not None:
        taps["head"] = x
    for j in range(n_up(cfg["up"])):
        h = F.pixel_shuffle(cascade._conv2d(p, q, h, f"tail.0.{2 * j}"), 2)
    return _shift(p, cascade._conv2d(p, q, h, "tail.1"), "add_mean")


@torch.no_grad()
def serve_u8(p_sr: dict, p_c: dict, cfg: dict, gray_u8: torch.Tensor,
             q=cascade.FP32) -> torch.Tensor:
    """(N, h, w, 1) uint8 gray -> (N, h*up, w*up, 3) uint8 RGB: /255, RCAN,
    the colorizer, clip to [0, 1], x255, round half to even."""
    x = gray_u8.permute(0, 3, 1, 2).float() / 255.0
    sr = rcan(p_sr, x, cfg["sr_model"], q)
    rgb = cascade.resdeconv(p_c, sr, cfg["c_model"], q).clamp(0.0, 1.0)
    return torch.round(rgb * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
