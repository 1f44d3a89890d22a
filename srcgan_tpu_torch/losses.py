"""Training losses over NHWC tensors, as in ``srcgan_tpu.losses``.

Means over every element, as the JAX functions reduce: the cascade's L1 /
MSE / PSNR, the batch losses of the multi-task family (``ce``, ``con``,
``cross``, ``focal``, ``nearest_select``, ``multi_task``), DSSIM and the GAN
objectives.  The VGG perceptual losses are ``losses_vgg``.

``dssim`` takes the plain SSIM (``metrics.ssim_reference``, differentiable)
whenever a gradient is being recorded for one of its inputs: the ``ssim``
kernel has no backward and refuses such tensors, as the TPU kernel does.
Without a gradient it goes through ``metrics.ssim``, the kernel on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from srcgan_tpu_torch import metrics

EPS = 1e-6


def l1(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(output - target))


def mse(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((output - target) ** 2)


def psnr(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / mse(output, target))


def l1_3d(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-frame L1 over (N, F, H, W, C) videos."""
    return torch.mean(torch.abs(output - target))


def dssim(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(1 - SSIM) / 2 with the batch-wide dynamic range."""
    wants_grad = torch.is_grad_enabled() and (output.requires_grad or target.requires_grad)
    ssim = metrics.ssim_reference if wants_grad else metrics.ssim
    return (1.0 - ssim(output, target)) / 2.0


def dssim_3d(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(N, F, H, W, C): the mean over frames of each frame's DSSIM."""
    return torch.stack([dssim(output[:, f], target[:, f])
                        for f in range(output.shape[1])]).mean()


def ce(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy when target has one channel, else the NLL of the
    one-hot target's class under log(output) (channels last)."""
    if target.shape[-1] == 1:
        o = torch.clamp(output, EPS, 1.0 - EPS)
        return -torch.mean(target * torch.log(o) + (1.0 - target) * torch.log(1.0 - o))
    labels = torch.argmax(target, dim=-1, keepdim=True)
    logp = torch.log(torch.clamp(output, min=EPS))
    return -torch.mean(torch.gather(logp, -1, labels))


def con(feats: torch.Tensor) -> torch.Tensor:
    """Batch consistency: the mean square of (max - min) over the batch."""
    return torch.mean((feats.amax(dim=0) - feats.amin(dim=0)).abs() ** 2)


def cross(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between batch-shifted sample pairs."""
    return torch.mean(torch.abs(output[:-1] - target[1:]))


def focal(output: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
          size_average: bool = True) -> torch.Tensor:
    """Focal loss: binary (alpha 0.1) for a one-channel target, else multi-class."""
    o = torch.clamp(output, EPS, 1.0 - EPS)
    if target.shape[-1] == 1:
        alpha = 0.1
        loss = (-(1.0 - alpha) * ((1.0 - o) ** gamma) * (target * torch.log(o))
                - alpha * (o ** gamma) * ((1.0 - target) * torch.log(1.0 - o)))
    else:
        loss = -((1.0 - o) ** gamma) * (target * torch.log(o))
    return torch.mean(loss) if size_average else torch.sum(loss)


# ---------------------------------------------------------------------------
# GAN objectives
# ---------------------------------------------------------------------------

GAN_MODES = ("lsgan", "vanilla", "wgangp", "DSSIM")


def gan_loss(prediction: torch.Tensor, target_is_real: bool, mode: str = "lsgan",
             real_label: float = 1.0, fake_label: float = 0.0) -> torch.Tensor:
    """GAN objective against a constant label map: lsgan MSE, vanilla
    BCE-with-logits, wgangp -+mean, DSSIM (1 - SSIM) / 2."""
    label = real_label if target_is_real else fake_label
    if mode == "lsgan":
        return torch.mean((prediction - label) ** 2)
    if mode == "vanilla":
        return F.binary_cross_entropy_with_logits(
            prediction, torch.full_like(prediction, label))
    if mode == "wgangp":
        return -torch.mean(prediction) if target_is_real else torch.mean(prediction)
    if mode == "DSSIM":
        return dssim(prediction, torch.full_like(prediction, label))
    raise ValueError(f"gan mode {mode} not implemented")


def multi_task(losses_vec, sigma: torch.Tensor) -> torch.Tensor:
    """Uncertainty-weighted multi-task loss:
    0.5 * sum(l_i / sigma_i^2) + log(prod sigma_i)."""
    if not isinstance(losses_vec, torch.Tensor):
        losses_vec = torch.stack([torch.as_tensor(v) for v in losses_vec])
    return torch.sum(0.5 * losses_vec / sigma ** 2) + torch.log(torch.prod(sigma))


def nearest_select(output: torch.Tensor, target: torch.Tensor, shift: int = 2,
                   stride: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output_crop, target_crop): the output's centre crop and, per sample,
    the target crop within +-shift*stride of least L1 to it.  The search is
    detached; the crops themselves carry gradients.  Crops are (h - 2 *
    shift * stride) x (w - 2 * shift * stride), as the JAX function takes
    them (the reference's crop_row for both sides differs only on
    non-square inputs)."""
    n, h, w, c = output.shape
    ch, cw = h - 2 * shift * stride, w - 2 * shift * stride
    off = shift * stride
    out_crop = output[:, off:off + ch, off:off + cw]
    offsets = [(i * stride, j * stride) for i in range(2 * shift) for j in range(2 * shift)]
    cands = torch.stack([target[:, oi:oi + ch, oj:oj + cw] for oi, oj in offsets])
    diffs = torch.sum(torch.abs(cands.detach() - out_crop.detach()[None]), dim=(2, 3, 4))
    best = torch.argmin(diffs, dim=0)                                   # (N,)
    return out_crop, cands[best, torch.arange(n, device=best.device)]


# Aliases under the reference's class names.
L1Loss, MSELoss, PSNRLoss, DSSIMLoss, CELoss, FLoss = l1, mse, psnr, dssim, ce, focal
ConLoss, CrossLoss = con, cross
