"""Weight-space tooling: checkpoint averaging (SWA) and ESRGAN-style network
interpolation, as in ``srcgan_tpu.weightspace``.

ESRGAN's deployment trick, network interpolation, ``W = (1-alpha)·W_PSNR +
alpha·W_GAN`` (Wang et al. 2018, §3.4), blends a PSNR-trained and an
adversarially trained generator to trade fidelity against perceptual
sharpness without retraining; the same code averages N checkpoints (SWA over
the last K epoch saves).

Everything works on the port's state_dicts (parameter name -> tensor), read
from the JAX package's ``.npz`` saves or reference ``.pth`` state_dicts
through ``interop.load_params_any``; ``cli.blend`` writes the result back in
the ``.npz`` layout (``interop.jax_tree_from_module``), which both packages
load.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def _assert_same_structure(dicts) -> None:
    keys0 = set(dicts[0])
    for i, d in enumerate(dicts[1:], start=1):
        if set(d) != keys0:
            missing = sorted(keys0 - set(d))[:3]
            extra = sorted(set(d) - keys0)[:3]
            raise ValueError(
                f"input {i} has other parameters than input 0 (missing={missing} "
                f"extra={extra}): blend inputs must be checkpoints of the SAME architecture")
        for k in keys0:
            if d[k].shape != dicts[0][k].shape:
                raise ValueError(f"input {i} tensor {k!r} has shape {tuple(d[k].shape)} vs "
                                 f"{tuple(dicts[0][k].shape)} in input 0")


def blend_params(state_dicts: Sequence[Dict[str, torch.Tensor]],
                 weights: Optional[Sequence[float]] = None) -> Dict[str, torch.Tensor]:
    """Weighted average of state_dicts with the same names and shapes.

    Float tensors are summed in float64, on the device input 0's tensor is
    on, and cast back to its dtype (a bf16 / fp32 mix blends without loss
    beyond the output dtype).
    Integer and bool tensors (BatchNorm's ``num_batches_tracked``) must be
    equal across inputs and pass through.  ``weights`` default to uniform
    (the SWA mean) and are normalized to sum to 1, so ``[1, 1, 2]`` means
    "the last checkpoint counts double"."""
    if not state_dicts:
        raise ValueError("blend_params needs at least one input")
    if weights is None:
        weights = [1.0] * len(state_dicts)
    if len(weights) != len(state_dicts):
        raise ValueError(f"{len(weights)} weights for {len(state_dicts)} inputs")
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("blend weights must sum to a positive value")
    w = [float(x) / total for x in weights]
    dicts = [{k: torch.as_tensor(v).detach() for k, v in d.items()} for d in state_dicts]
    _assert_same_structure(dicts)

    out = {}
    for key, t0 in dicts[0].items():
        if t0.is_floating_point():
            acc = torch.zeros(t0.shape, dtype=torch.float64, device=t0.device)
            for wi, d in zip(w, dicts):
                acc += wi * d[key].to(t0.device, torch.float64)
            out[key] = acc.to(t0.dtype)
        else:
            for i, d in enumerate(dicts[1:], start=1):
                if not torch.equal(d[key].to(t0.device), t0):
                    raise ValueError(f"non-float tensor {key!r} differs between input 0 and "
                                     f"input {i}; refusing to average a counter or index")
            out[key] = t0.clone()
    return out


def interpolate_params(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
                       alpha: float) -> Dict[str, torch.Tensor]:
    """ESRGAN network interpolation: ``(1-alpha)·a + alpha·b`` per tensor.

    With ``a`` the PSNR-oriented generator and ``b`` the GAN generator, alpha
    sweeps fidelity (0) to perceptual sharpness (1).  Dtypes follow ``a``."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"alpha must be in [0, 1], got {alpha}")
    return blend_params([a, b], [1.0 - alpha, alpha])


def load_checkpoint_model(path: str):
    """Load ONE generator checkpoint (.npz of the JAX layout or reference
    .pth), building the model from the reference's name-encoded config, so
    the caller need not name the architecture.

    Returns (model on the CPU, info dict from ``parse_checkpoint_name``)."""
    from srcgan_tpu_torch import models
    from srcgan_tpu_torch.interop import load_params_any
    from srcgan_tpu_torch.train.state import parse_checkpoint_name

    info = parse_checkpoint_name(path)
    lab = info["ver"] == "G2LAB"
    if info["role"] == "A2C":
        model = models.create(info["model"], 1, 1, info["up"])
    else:
        model = models.create(info["model"], 1, 2 if lab else 3)
    return load_params_any(model, path), info


def load_checkpoint_params(path: str):
    """``load_checkpoint_model``, returning (the model's parameters by name, info)."""
    model, info = load_checkpoint_model(path)
    return {k: p.detach() for k, p in model.named_parameters()}, info
