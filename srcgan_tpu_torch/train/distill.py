"""Knowledge distillation for the cascade, as in ``srcgan_tpu.train.distill``.

A cheaper student cascade trains on a convex blend of the ground truth and
a frozen teacher cascade's outputs, per stage (SR and colorizer):

    loss_stage = alpha * L1(student, target) + (1 - alpha) * L1(student, teacher)

``DistillTrainer`` subclasses ``CasTrainer`` and overrides its two loss
hooks, ``_distill_targets`` and ``_stage_loss``, so every step of the base
trainer (bf16 activations, ``fused_input``, K steps per call, EMA,
gradient accumulation, the data-parallel wrappers of ``parallel``) runs
distillation unchanged.  At ``alpha == 1`` the teacher is skipped and the
step is ``CasTrainer``'s, bit for bit.

The teacher is held frozen in eval mode, its parameters without gradients,
and runs under ``torch.no_grad()`` outside remat, its outputs cast to fp32.
So on the card a bf16 RDDBNet x4 teacher at a supported trunk shape runs
its blocks through the RDB5 kernel and its tail through the x4 tail kernel.
Under ``act_dtype`` the teacher's parameters are cast once, at
construction (nothing updates them); its BatchNorm statistics stay fp32
(``config.cast_parameters``).
"""
from __future__ import annotations

import torch

from srcgan_tpu_torch import config, losses
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.train.cas import CasTrainer


def _freeze(net: torch.nn.Module, device, dtype) -> torch.nn.Module:
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    net.requires_grad_(False)
    if dtype is not None:
        config.cast_parameters(net, dtype)
    return net


class DistillTrainer(CasTrainer):
    """CasTrainer with a frozen teacher cascade blended into both stage losses.

    ``teacher_sr`` / ``teacher_c``: the teacher's SR net and colorizer,
    trained modules (their buffers hold any BatchNorm statistics); the
    trainer moves them to its device, freezes them and holds them in eval
    mode."""

    def __init__(self, teacher_sr: torch.nn.Module, teacher_c: torch.nn.Module,
                 alpha: float = 0.5, **cas_kwargs):
        super().__init__(**cas_kwargs)
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.teacher_sr = _freeze(teacher_sr, self.device, self.act_dtype)
        self.teacher_c = _freeze(teacher_c, self.device, self.act_dtype)

    @classmethod
    def from_checkpoints(cls, netGA_path: str, netGB_path: str, alpha: float = 0.5,
                         **cas_kwargs):
        """Build from the teacher's checkpoint files (.npz of the JAX layout or
        reference .pth), the architectures rebuilt from the name-encoded
        config and checked against the student pipeline (up factor,
        RGB/LAB target space)."""
        from srcgan_tpu_torch.weightspace import load_checkpoint_model

        sr_model, sr_info = load_checkpoint_model(netGA_path)
        c_model, c_info = load_checkpoint_model(netGB_path)
        if sr_info["role"] != "A2C" or c_info["role"] != "C2B":
            raise ValueError(
                f"teacher checkpoints must be an (A2C, C2B) pair; got "
                f"{sr_info['role']} + {c_info['role']}")
        up = cas_kwargs.get("up", 2)
        lab = bool(cas_kwargs.get("lab", False))
        const = bool(cas_kwargs.get("const", False))
        # const pipelines run resolution-preserving SR nets; a scale-up
        # teacher would emit the wrong spatial shape for the student's L1
        if not const and sr_info["up"] != up:
            raise ValueError(
                f"teacher SR checkpoint is x{sr_info['up']} but the student "
                f"pipeline is x{up}")
        if (sr_info["ver"] == "G2LAB") != lab:
            raise ValueError(
                f"teacher is a {sr_info['ver'] or 'G2RGB'} checkpoint but "
                f"the student pipeline is {'G2LAB' if lab else 'G2RGB'}")
        return cls(sr_model, c_model, alpha=alpha, **cas_kwargs)

    # -- the two hooks -------------------------------------------------------

    def _distill_targets(self, sr_in, c_in):
        """The frozen teacher's fp32 outputs on the step's (degraded,
        act_dtype-cast) stage inputs, in eval mode with no gradient."""
        if self.alpha == 1.0:               # pure supervision: no teacher at all
            return None, None
        with torch.no_grad():
            y_sr = to_nhwc(self.teacher_sr(to_nchw(sr_in))).float()
            y_c = to_nhwc(self.teacher_c(to_nchw(c_in))).float()
        return y_sr, y_c

    def _stage_loss(self, pred, target, kd_target):
        supervised = super()._stage_loss(pred, target, None)
        if kd_target is None:               # alpha == 1: bitwise the CasTrainer step
            return supervised
        return self.alpha * supervised + (1.0 - self.alpha) * losses.l1(pred, kd_target)
