"""SRCGAN's cascade training step (``src/trainCas.py``), plain float32.

Per step, from a uint8 RGB target batch B: gray = luma(B / 255) with
Y = 0.2125 R + 0.7154 G + 0.0721 B; stage 1 trains the SR net on
L1(SR(bilinear_down(gray, 1/up)), gray); stage 2 the colorizer on
L1(C(gray), B / 255).  The two losses are independent; each network takes
one Adam step (torch's defaults: betas 0.9, 0.999, eps 1e-8, no decay).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import cascade

LUMA = (0.2125, 0.7154, 0.0721)
BETAS, EPS = (0.9, 0.999), 1e-8


def inputs(tar_u8: torch.Tensor, up: int):
    """(N, H, W, 3) uint8 -> (gray (N,1,H,W), degraded gray (N,1,H/up,W/up),
    RGB target (N,3,H,W)), float32, NCHW."""
    rgb = tar_u8.permute(0, 3, 1, 2).float() / 255.0
    w = torch.tensor(LUMA, device=rgb.device).view(1, 3, 1, 1)
    gray = (rgb * w).sum(1, keepdim=True)
    h, wd = gray.shape[-2:]
    low = F.interpolate(gray, size=(h // up, wd // up), mode="bilinear", align_corners=False)
    return gray, low, rgb


def adam_(params: dict, grads: dict, state: dict, lr: float, t: int) -> None:
    """One Adam step over every parameter, in place."""
    b1, b2 = BETAS
    for k, p in params.items():
        g = grads[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / (1 - b2 ** t) ** 0.5).add_(EPS)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def run(p_sr: dict, p_c: dict, cfg: dict, batches, lr: float, q=cascade.FP32):
    """Train copies of the two parameter dicts of the configuration ``cfg``
    for len(batches) steps.  Returns (losses [(sr, c)] per step, first step's
    gradients {"sr": {}, "c": {}}, parameters after the last step {"sr": {},
    "c": {}}, first step's inputs as each net's first convolution takes them
    {"sr": degraded gray, "c": gray})."""
    sr_cfg = cfg["sr_model"]
    params = {"sr": {k: v.detach().clone().float() for k, v in p_sr.items()},
              "c": {k: v.detach().clone().float() for k, v in p_c.items()}}
    adam = {"sr": {}, "c": {}}
    losses, first, seen = [], None, None
    for t, tar in enumerate(batches, start=1):
        gray, low, rgb = inputs(tar, sr_cfg["up"])
        if seen is None:
            seen = {"sr": q.act(low).detach(), "c": q.act(gray).detach()}
        step_grads, step_losses = {}, []
        for role in ("sr", "c"):
            p = {k: v.requires_grad_(True) for k, v in params[role].items()}
            if role == "sr":
                loss = (cascade.rddbnet(p, low, sr_cfg, q) - gray).abs().mean()
            else:
                loss = (cascade.resdeconv(p, gray, cfg["c_model"], q) - rgb).abs().mean()
            names = list(p)
            step_grads[role] = dict(zip(names, torch.autograd.grad(loss, [p[k] for k in names])))
            step_losses.append(loss.item())
        with torch.no_grad():
            for role in ("sr", "c"):
                for v in params[role].values():
                    v.requires_grad_(False)
                adam_(params[role], step_grads[role], adam[role], lr, t)
        losses.append(tuple(step_losses))
        if first is None:
            first = step_grads
        del step_grads
    return losses, first, params, seen
