"""Adam and the learning-rate schedules, as in ``srcgan_tpu.train.optim``.

``adam`` is ``torch.optim.Adam`` with the torch-default hyperparameters the
JAX package passes to optax: the same bias-corrected update with eps outside
the square root.  The JAX package injects the learning rate into the
optimizer state so a schedule can change it without rebuilding the moments;
here ``set_lr`` writes it into the param groups, which leaves the moments
as they are.

``reference_lr`` reproduces the reference's observable per-epoch schedule
(a fresh torch scheduler built and stepped once every epoch): 'cosine'
multiplies the LR by (1 + cos(pi/num_epochs))/2 each epoch, and 'step' and
'plateau' never move it.  'true_cosine' and 'warmup_cosine' are the
conventional schedules.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch


def reference_lr(policy: str, base_lr: float, num_epochs: int, epoch: int) -> float:
    """LR for ``epoch`` (1-based, held for the whole epoch)."""
    if policy == "cosine":
        factor = (1.0 + math.cos(math.pi / num_epochs)) / 2.0
        return base_lr * factor ** epoch
    # the arc is indexed epoch-1, so epoch 1 trains at base_lr and the last
    # epoch at the last non-zero cosine point
    if policy == "true_cosine":
        return true_cosine(base_lr, num_epochs, epoch - 1)
    if policy == "warmup_cosine":
        warm = max(1, round(0.05 * num_epochs))
        if epoch <= warm:
            return base_lr * epoch / warm
        return true_cosine(base_lr, num_epochs - warm, epoch - warm - 1)
    if policy in ("step", "plateau", "linear", "none"):
        return base_lr
    raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")


def true_cosine(base_lr: float, num_epochs: int, epoch: int,
                eta_min: float = 0.0) -> float:
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * epoch / num_epochs)) / 2


# Torch-default Adam hyperparameters (b1, b2, eps), as the JAX package's.
ADAM_HPARAMS = (0.9, 0.999, 1e-8)


def adam(params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
         b1: float = ADAM_HPARAMS[0], b2: float = ADAM_HPARAMS[1],
         eps: float = ADAM_HPARAMS[2]) -> torch.optim.Adam:
    """Adam over ``params`` with torch-default eps."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every param group in place; the moments stay."""
    for group in opt.param_groups:
        group["lr"] = lr
    return opt
