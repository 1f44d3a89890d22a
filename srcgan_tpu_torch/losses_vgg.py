"""VGG16 / VGG19 perceptual losses, as in ``srcgan_tpu.losses_vgg``.

No VGG weights ship with the repository and none are downloaded: pretrained
weights come from a local file (``load_vgg_params``: an ``.npz`` written by
``cli.convert_vgg`` or a torchvision ``.pth`` state_dict, keys
``features.{i}.weight`` / ``features.{i}.bias``), and ``init_vgg_params``
draws random ones for testing.  A parameter set is ``{str(i): {"w", "b"}}``
by torchvision layer index, with the weights in OIHW (the torch layout, so
no transpose on load) and frozen: the gradient of a loss reaches its
``output`` argument only.

VGG16's loss takes four slices, features[0:4) (relu1_2), [4:9) (relu2_2),
[9:16) (relu3_3) and [16:23) (relu4_3), and is the mean of the L1 of the
four slice outputs; a 1-channel input is replicated to 3 channels.
``perception_loss`` is VGG19 features[:35] with MSE.  The convolutions are
cuDNN's ``F.conv2d``, as the JAX package computes them with its plain
conv, outside any Pallas kernel.  Inputs and outputs are NHWC.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc

# torchvision VGG 'features' layouts: channels per conv, 'M' = maxpool.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]

VggParams = Dict[str, Dict[str, torch.Tensor]]


def _features_plan(cfg) -> List[tuple]:
    """[(torchvision layer index, kind, out channels)]: conv then relu for each
    conv entry, maxpool for 'M'."""
    plan, idx = [], 0
    for v in cfg:
        if v == "M":
            plan.append((idx, "pool", None))
            idx += 1
        else:
            plan.append((idx, "conv", v))
            plan.append((idx + 1, "relu", None))
            idx += 2
    return plan


def init_vgg_params(generator: torch.Generator, cfg=VGG16_CFG, device=None) -> VggParams:
    """Random weights (testing only: a perceptual loss needs trained ones),
    each conv's weight then bias drawn uniform in +-1/sqrt(9 * c_in) from
    ``generator``."""
    params, cin = {}, 3
    for idx, kind, cout in _features_plan(cfg):
        if kind != "conv":
            continue
        bound = 1.0 / np.sqrt(9 * cin)
        w = (torch.rand(cout, cin, 3, 3, generator=generator) * 2 - 1) * bound
        b = (torch.rand(cout, generator=generator) * 2 - 1) * bound
        params[str(idx)] = {"w": w.to(device), "b": b.to(device)}
        cin = cout
    return params


def load_vgg_params(path: str, cfg=VGG16_CFG, device=None) -> VggParams:
    """torchvision-layout weights from an ``.npz`` or a ``.pth`` state_dict."""
    if path.endswith(".npz"):
        with np.load(path) as raw:
            sd = {k: torch.from_numpy(raw[k]) for k in raw.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return {str(idx): {"w": sd[f"features.{idx}.weight"].float().to(device),
                       "b": sd[f"features.{idx}.bias"].float().to(device)}
            for idx, kind, _ in _features_plan(cfg) if kind == "conv"}


def vgg_features(params: VggParams, x: torch.Tensor, cfg=VGG16_CFG,
                 cut_points: Sequence[int] = (4, 9, 16, 23)) -> List[torch.Tensor]:
    """Run the VGG trunk on NHWC x; the NHWC activations at each torchvision
    cut index (and the trunk's output where a cut lies past its end).  The
    layers after the last cut are not run."""
    outs, next_cut = [], 0
    h = to_nchw(x)
    for idx, kind, _ in _features_plan(cfg):
        if next_cut < len(cut_points) and idx == cut_points[next_cut]:
            outs.append(to_nhwc(h))
            next_cut += 1
            if next_cut == len(cut_points):
                return outs
        if kind == "conv":
            p = params[str(idx)]
            h = F.conv2d(h, p["w"].to(h.dtype).detach(), p["b"].to(h.dtype).detach(),
                         padding=1)
        elif kind == "relu":
            h = F.relu(h)
        else:
            h = F.max_pool2d(h, 2, 2)
    if next_cut < len(cut_points):
        outs.append(to_nhwc(h))
    return outs


def _to3ch(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x, x], dim=-1) if x.shape[-1] == 1 else x


def vgg16_loss(params: VggParams, output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean of the L1 over the four VGG16 slices."""
    fo = vgg_features(params, _to3ch(output))
    ft = vgg_features(params, _to3ch(target))
    terms = [torch.mean(torch.abs(a - b)) for a, b in zip(fo, ft)]
    return sum(terms) / len(terms)


def vgg16_loss_3d(params: VggParams, output: torch.Tensor, target: torch.Tensor
                  ) -> torch.Tensor:
    """Per-frame mean of ``vgg16_loss`` over (N, F, H, W, C)."""
    vals = [vgg16_loss(params, output[:, i], target[:, i]) for i in range(output.shape[1])]
    return sum(vals) / len(vals)


def perception_loss(params: VggParams, output: torch.Tensor, target: torch.Tensor,
                    feature_layer: int = 35) -> torch.Tensor:
    """MSE of VGG19 features[:feature_layer]."""
    fo = vgg_features(params, _to3ch(output), cfg=VGG19_CFG, cut_points=(feature_layer,))
    ft = vgg_features(params, _to3ch(target), cfg=VGG19_CFG, cut_points=(feature_layer,))
    return torch.mean((fo[0] - ft[0]) ** 2)
