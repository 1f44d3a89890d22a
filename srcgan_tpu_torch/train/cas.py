"""Cascaded SR -> colorization trainer (CasSRC), as in ``srcgan_tpu.train.cas``.

Stage 1 trains the SR generator (netG_A2C) on
L1(SR(degrade(luma(B))), luma(B)); stage 2 trains the colorizer (netG_C2B) on
L1(C(luma(B)), B).  Stage 2 reads the clean gray, not the SR output, so the
two stages are independent: two losses, two backward passes, two Adam
updates.  PSNR metrics are taken on the detached fp32 outputs.

The math is the JAX trainer's; the form is PyTorch's:

- **State, updated in place.**  ``CasState(sr, c)`` holds per network a
  ``TrainState(model, opt, step)``: the module carries the fp32 master
  parameters and, as buffers, the model state (BatchNorm running
  statistics).  Where JAX donates its state and returns a new one,
  ``apply_grads`` and every ``train_step*`` update the modules, the
  optimizers (and ``train_step_ema``'s EMA tree) IN PLACE and return a
  ``CasState`` over the same objects with the steps advanced.  ``grads``
  changes nothing: it runs the networks through
  ``torch.func.functional_call`` on copies of their buffers and returns the
  updated copies as the model states.
- **act_dtype=torch.bfloat16** casts the parameters and the inputs for the
  step, keeps fp32 masters (the gradients flow back through the cast), casts
  each output to fp32 before its loss, and runs Adam in fp32.  No autocast:
  it would pick a dtype per op and compute another step.
- **K steps per call** (``train_steps_u8``) are a Python loop; **remat** is
  ``torch.utils.checkpoint`` around each network apply.
- **fused_input** routes the uint8 steps' gray + degrade through the
  sm_90a kernel (``ops.kernels.preprocess_kernel``) on a card, and through
  its plain version on the CPU.
- **Loss hooks**: each stage's loss is ``_stage_loss(pred, target,
  kd_target)`` (L1, plus the VGG16 perceptual term with
  ``perceptual_params``), and ``_distill_targets(sr_in, c_in)`` gives the
  ``kd_target``s, None here; ``train.distill.DistillTrainer`` overrides both.
  The PSNR metrics go through ``_psnr``; ``parallel.dp.make_cas_2d_step``
  takes both losses and PSNRs over the whole image of its strips.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from srcgan_tpu_torch import config, losses, losses_vgg, models
from srcgan_tpu_torch.data import preprocess
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.ops.kernels import preprocess_kernel
from srcgan_tpu_torch.train import optim
from srcgan_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


class CasState(NamedTuple):
    """The SR net's and the colorizer's TrainState; each module's buffers
    are its model state."""
    sr: TrainState
    c: TrainState


@contextlib.contextmanager
def _eval_mode(*nets):
    modes = [n.training for n in nets]
    try:
        for n in nets:
            n.eval()
        with torch.no_grad():
            yield
    finally:
        for n, mode in zip(nets, modes):
            n.train(mode)


class CasTrainer:
    """Owns the cascade's configuration; ``init`` makes the two networks (the
    registry's models, as the JAX trainer builds them) and their
    optimizers, and the step methods train them."""

    def __init__(self, sr_model: str = "ESPCN", c_model: str = "ResDeconv",
                 up: int = 2, lr: float = 1e-4, const: bool = False,
                 lab: bool = False, lr_policy: str = "cosine",
                 num_epochs: int = 50, remat: bool = False,
                 perceptual_params=None, perceptual_weight: float = 1.0,
                 act_dtype: Optional[torch.dtype] = None, fused_input: bool = False,
                 *, device=None):
        if perceptual_params is not None and lab:
            raise ValueError("--perceptual requires an RGB pipeline (the LAB "
                             "colorizer predicts 2-channel ab maps)")
        if fused_input and (lab or const):
            raise ValueError("fused_input applies to the G2RGB non-const "
                             "uint8 input path only")
        self.sr_name, self.c_name = sr_model, c_model
        self.up, self.lr, self.const, self.lab = up, lr, const, lab
        self.lr_policy, self.num_epochs = lr_policy, num_epochs
        self.remat = remat
        self.act_dtype = act_dtype
        self.fused_input = fused_input
        self.device = config.resolve_device(device)
        # the optional VGG16 perceptual term of both stage losses (RGB only):
        # loss = L1 + perceptual_weight * vgg16_loss, the VGG weights frozen
        self.perceptual_params = (None if perceptual_params is None else
                                  {k: {n: t.to(self.device) for n, t in p.items()}
                                   for k, p in perceptual_params.items()})
        self.perceptual_weight = perceptual_weight

    # -- setup ---------------------------------------------------------------

    def init(self, seed) -> CasState:
        """Fresh networks (in train mode) and Adam optimizers; ``seed`` is an
        int or a torch.Generator, drawn from for the SR net, then the colorizer."""
        gen = seed if isinstance(seed, torch.Generator) else (
            torch.Generator().manual_seed(int(seed)))
        sr = models.create(self.sr_name, 1, 1, self.up, device=self.device,
                           generator=gen).train()
        c = models.create(self.c_name, 1, 2 if self.lab else 3, device=self.device,
                          generator=gen).train()
        return CasState(TrainState(sr, optim.adam(sr.parameters(), self.lr), 0),
                        TrainState(c, optim.adam(c.parameters(), self.lr), 0))

    def lr_at_epoch(self, epoch: int) -> float:
        return optim.reference_lr(self.lr_policy, self.lr, self.num_epochs, epoch)

    # -- the step ------------------------------------------------------------

    def _tensor(self, x) -> Optional[torch.Tensor]:
        return None if x is None else torch.as_tensor(x, device=self.device)

    def _split_targets(self, realB):
        """(SR target 1ch, colorization target): luma and RGB, or with lab
        the L and the ab channels of a normalized-LAB target."""
        if self.lab:
            return realB[..., :1], realB[..., 1:]
        return preprocess.luma(realB), realB

    def _degrade(self, x):
        if self.const:
            return preprocess.degrade_const(x, self.up)
        return preprocess.degrade_bilinear(x, self.up)

    def _apply(self, net: torch.nn.Module, x: torch.Tensor):
        """Train-mode forward of ``net`` on NHWC x with its parameters cast to
        act_dtype.  Returns (fp32 NHWC output, the updated copies of its
        buffers); the module's own buffers are not touched."""
        params = dict(net.named_parameters())
        if self.act_dtype is not None:
            params = {k: v.to(self.act_dtype) for k, v in params.items()}
        buffers = dict(net.named_buffers())

        def run(v):
            bufs = {k: b.clone() for k, b in buffers.items()}
            y = functional_call(net, {**params, **bufs}, (to_nchw(v),))
            return to_nhwc(y).float(), bufs

        net.train()
        if self.remat:
            return checkpoint(run, x, use_reentrant=False)
        return run(x)

    def _stage_loss(self, pred, target, kd_target):
        """One stage's training loss.  A hook: ``DistillTrainer`` blends in
        ``kd_target``, the frozen teacher's output, which is None here."""
        loss = losses.l1(pred, target)
        if self.perceptual_params is not None:
            loss = loss + self.perceptual_weight * losses_vgg.vgg16_loss(
                self.perceptual_params, pred, target)
        return loss

    def _psnr(self, output, target):
        """A metric hook: PSNR of a stage's detached fp32 output."""
        return losses.psnr(output, target)

    def _distill_targets(self, sr_in, c_in):
        """A hook: ``DistillTrainer`` returns the frozen teacher's outputs on
        the stage inputs; the base trainer has no teacher."""
        return None, None

    def _stage_grads(self, net, x, target, kd_target=None):
        """(loss, fp32 output detached, grads by parameter name, model state)."""
        y, mstate = self._apply(net, x)
        loss = self._stage_loss(y, target, kd_target)
        names, params = zip(*net.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
        return loss.detach(), y.detach(), grads, mstate

    def grads(self, state: CasState, realA, realB, precomputed=None):
        """Gradients of both stages at ``state`` (no update).

        Returns (grads {sr, c} by parameter name, model states {sr, c},
        metrics).  ``precomputed``: (real_BC, real_BA) from the fused
        preprocess kernel; realB is then the stage-2 target directly.
        realA is not used (the transfer cascade reads it)."""
        if precomputed is not None:
            real_BC, real_BA = precomputed
            tgt_B = realB
        else:
            real_BC, tgt_B = self._split_targets(realB)
            real_BA = self._degrade(real_BC)
        sr_in, c_in = real_BA, real_BC
        if self.act_dtype is not None:
            sr_in, c_in = sr_in.to(self.act_dtype), c_in.to(self.act_dtype)
        kd_sr, kd_c = self._distill_targets(sr_in, c_in)
        # stage 1's backward runs before stage 2's forward: one stage's
        # activations are live at a time
        loss_sr, fake_BC, g_sr, ms_sr = self._stage_grads(state.sr.model, sr_in, real_BC, kd_sr)
        loss_c, fake_BB, g_c, ms_c = self._stage_grads(state.c.model, c_in, tgt_B, kd_c)
        metrics = {"loss_SR": loss_sr, "loss_C": loss_c,
                   "psnr_SR": self._psnr(fake_BC, real_BC),
                   "psnr_C": self._psnr(fake_BB, tgt_B)}
        return {"sr": g_sr, "c": g_c}, {"sr": ms_sr, "c": ms_c}, metrics

    @torch.no_grad()
    def apply_grads(self, state: CasState, grads, model_states, lr) -> CasState:
        """One Adam update of each network at ``lr`` and its new model state,
        in place; returns the state with both steps advanced."""
        def update(ts: TrainState, g, mstate) -> TrainState:
            optim.set_lr(ts.opt, float(lr))
            for name, p in ts.model.named_parameters():
                p.grad = g[name]
            ts.opt.step()
            ts.opt.zero_grad(set_to_none=True)
            for name, b in ts.model.named_buffers():
                b.copy_(mstate[name])
            return ts._replace(step=ts.step + 1)

        return CasState(update(state.sr, grads["sr"], model_states["sr"]),
                        update(state.c, grads["c"], model_states["c"]))

    def train_step(self, state: CasState, realA, realB, lr) -> Tuple[CasState, Metrics]:
        """One optimization step on a (realA gray, realB target) float batch,
        NHWC; realB is RGB, or normalized LAB with lab.  Returns (state, metrics {loss_SR, loss_C, psnr_SR, psnr_C})."""
        grads, mstates, metrics = self.grads(state, self._tensor(realA), self._tensor(realB))
        return self.apply_grads(state, grads, mstates, lr), metrics

    def train_step_ema(self, state: CasState, ema, realA, realB, lr, decay):
        """``train_step``, then ema <- decay * ema + (1 - decay) * params, in
        place.  ``ema`` is {"sr": {name: tensor}, "c": ...} from ``ema_init``.
        Returns (state, ema, metrics)."""
        state, metrics = self.train_step(state, realA, realB, lr)
        with torch.no_grad():
            for role, ts in (("sr", state.sr), ("c", state.c)):
                for name, p in ts.model.named_parameters():
                    ema[role][name].mul_(decay).add_(p, alpha=1.0 - decay)
        return state, ema, metrics

    def ema_init(self, state: CasState):
        """A fresh EMA tree, seeded from the current weights."""
        return {role: {n: p.detach().clone() for n, p in ts.model.named_parameters()}
                for role, ts in (("sr", state.sr), ("c", state.c))}

    def train_step_accum(self, state: CasState, realA, realB, lr,
                         microbatches: int) -> Tuple[CasState, Metrics]:
        """One step with gradient accumulation: the batch is split into
        ``microbatches`` equal chunks whose gradients (all taken at ``state``)
        and metrics are averaged, then one Adam update; the model state is the
        last chunk's.  For the L1 losses this equals ``train_step`` on the
        whole batch, with one chunk's activations live at a time."""
        realA, realB = self._tensor(realA), self._tensor(realB)
        n = realA.shape[0]
        if n % microbatches:
            raise ValueError(f"batch {n} not divisible by {microbatches}")
        m = n // microbatches
        g_acc = met_acc = mstates = None
        for a, b in zip(realA.split(m), realB.split(m)):
            g, mstates, met = self.grads(state, a, b)
            if g_acc is None:
                g_acc, met_acc = g, met
            else:
                g_acc = {r: {k: g_acc[r][k] + v for k, v in g[r].items()} for r in g}
                met_acc = {k: met_acc[k] + v for k, v in met.items()}
        inv = 1.0 / microbatches
        g_acc = {r: {k: v * inv for k, v in gr.items()} for r, gr in g_acc.items()}
        met_acc = {k: v * inv for k, v in met_acc.items()}
        return self.apply_grads(state, g_acc, mstates, lr), met_acc

    def _u8_inputs(self, src_u8, tar_u8):
        """(realA, realB, precomputed) for the uint8 steps; fused_input routes
        the gray + degrade chain through the preprocess kernel."""
        if self.fused_input:
            real_BC, real_BA = preprocess_kernel.fused_gray_degrade(tar_u8, self.up)
            realB = tar_u8.float() / 255.0
            return realB, realB, (real_BC, real_BA)
        realA, realB = preprocess.convert_pair(src_u8, tar_u8,
                                               "G2LAB" if self.lab else "G2RGB")
        return realA, realB, None

    def train_step_u8(self, state: CasState, src_u8, tar_u8, lr
                      ) -> Tuple[CasState, Metrics]:
        """One step on a uint8 (src, tar) NHWC RGB batch: decode, colour and
        degradation run on the device, in the step."""
        realA, realB, pre = self._u8_inputs(self._tensor(src_u8), self._tensor(tar_u8))
        grads, mstates, metrics = self.grads(state, realA, realB, precomputed=pre)
        return self.apply_grads(state, grads, mstates, lr), metrics

    def train_steps_u8(self, state: CasState, src_u8_k, tar_u8_k, lr
                       ) -> Tuple[CasState, Metrics]:
        """K ``train_step_u8`` steps over (K, N, H, W, 3) uint8 stacks at one
        lr (the reference holds the lr for a whole epoch).  Metrics come back
        stacked per step, shape (K,)."""
        src_u8_k, tar_u8_k = self._tensor(src_u8_k), self._tensor(tar_u8_k)
        per_step = []
        for s, t in zip(src_u8_k, tar_u8_k):
            state, met = self.train_step_u8(state, s, t, lr)
            per_step.append(met)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    # -- transfer / eval cascade ---------------------------------------------

    @staticmethod
    def _eval_forward(net: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode forward on NHWC x at x's dtype (as the JAX ops compute at
        the activation's dtype): the module itself for fp32, a copy with
        cast parameters otherwise, so the fp32 masters are never cast in place
        and BatchNorm's running statistics stay fp32."""
        if x.dtype != next(net.parameters()).dtype:
            net = config.cast_parameters(copy.deepcopy(net), x.dtype)
        with _eval_mode(net):
            return to_nhwc(net(to_nchw(x)))

    def transfer(self, state: CasState, realA):
        """Zero-shot source-domain cascade in eval mode: bilinear-degrade
        realA (const keeps full size), then SR, then colorize.
        Returns (real_A_in, fake_AC, fake_AB)."""
        realA = self._tensor(realA)
        real_A_in = realA if self.const else preprocess.degrade_bilinear(realA, self.up)
        fake_AC = self._eval_forward(state.sr.model, real_A_in)
        fake_AB = self._eval_forward(state.c.model, fake_AC)
        return real_A_in, fake_AC, fake_AB

    def snapshot(self, state: CasState, realA, realB):
        """The logged image set, recomputed in eval mode."""
        realB = self._tensor(realB)
        real_BC, tgt_B = self._split_targets(realB)
        real_BA = self._degrade(real_BC)
        fake_BC = self._eval_forward(state.sr.model, real_BA)
        fake_BB = self._eval_forward(state.c.model, real_BC)
        real_A_in, fake_AC, fake_AB = self.transfer(state, realA)
        return {"real_A": real_A_in, "fake_AC": fake_AC, "fake_AB": fake_AB,
                "real_BA": real_BA, "real_BC": real_BC, "real_B": realB,
                "fake_BC": fake_BC, "fake_BB": fake_BB}
