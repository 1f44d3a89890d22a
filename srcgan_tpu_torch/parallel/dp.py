"""Data-parallel training over the ``data`` mesh (``srcgan_tpu.parallel.dp``).

The cascade steps follow the JAX package's ``shard_map`` recipe: each rank
takes the gradients of its shard of the batch (``CasTrainer.grads``, its
BatchNorm statistics from its own shard), then one all-reduce averages the
gradients, the metrics and the model states, and every rank applies the same
Adam update to its copy of the state.  DistributedDataParallel is not used:
the trainer takes its gradients with ``torch.autograd.grad`` through
``functional_call``, which DDP's hooks never see, and DDP's
``broadcast_buffers`` would copy rank 0's statistics where the JAX step
averages them.

The GAN steps are GSPMD in the JAX package: one program on the global
batch.  Here each rank runs its shard with the BatchNorm statistics taken
over every rank's batch (``ops.norm.sync_batch_norm``, whose all-reduces
carry the gradient), the gradients and the scalar losses averaged, and the
host ``ImagePool`` drawing on the gathered global batch, so its draws are
the single-process draws (``pool_query``).

The space axis (``parallel.spatial``): ``make_spatial_infer`` runs a model
on this rank's strip of an image, and ``make_cas_2d_step`` is the cascade's
step on a (data, space) mesh, which GSPMD derives in the JAX package from
the sharding of the batch over both axes.  Each rank takes sample shard d
and row strip s of the batch, the L1 losses divide by the whole image's
pixel count, the gradients are summed over ``space`` (each strip's share of
the whole image's loss) and averaged over ``data``, the batch norm's
statistics are the global batch's, and Adam runs replicated.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List

import torch
import torch.distributed as dist

from srcgan_tpu_torch.ops import norm
from srcgan_tpu_torch.parallel import spatial
from srcgan_tpu_torch.parallel.mesh import Mesh, all_gather_batch


@torch.no_grad()
def average_(tensors: List[torch.Tensor], group=None, op=dist.ReduceOp.AVG) -> None:
    """Average (or reduce by ``op``) the float tensors of every rank of
    ``group`` (the default group where None) in place, one all-reduce per
    dtype over their flattened concatenation."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        if t.is_floating_point():
            by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=op, group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def _dp_update(trainer, mesh, state, realA, realB, lr, precomputed=None):
    """One averaged update: the shard's gradients, model states and metrics,
    their means over the data axis, the same Adam update on every rank."""
    grads, mstates, metrics = trainer.grads(state, realA, realB, precomputed=precomputed)
    average_([g for r in grads.values() for g in r.values()]
             + [b for r in mstates.values() for b in r.values()]
             + list(metrics.values()), mesh.group("data"))
    return trainer.apply_grads(state, grads, mstates, lr), metrics


def make_cas_dp_step(trainer, mesh: Mesh):
    """step(state, realA, realB, lr) -> (state, metrics) for a CasTrainer:
    realA / realB are this rank's shard of the batch (``put_batch``), the
    state replicated (``put_replicated``) and updated in place."""
    def step(state, realA, realB, lr):
        return _dp_update(trainer, mesh, state, trainer._tensor(realA),
                          trainer._tensor(realB), lr)

    return step


def make_cas_dp_steps_u8(trainer, mesh: Mesh):
    """K averaged updates per call on the uint8 input path:
    steps(state, src_u8_k, tar_u8_k, lr) over (K, n, H, W, 3) blocks whose n
    is this rank's shard (``put_batch(..., batch_dim=1)``); the gray and
    degrade chain runs through the preprocess kernel under ``fused_input``,
    as in ``CasTrainer.train_steps_u8``.  Metrics are stacked per step,
    shape (K,), averaged over the ranks."""
    def steps(state, src_u8_k, tar_u8_k, lr):
        per_step = []
        for s, t in zip(trainer._tensor(src_u8_k), trainer._tensor(tar_u8_k)):
            realA, realB, pre = trainer._u8_inputs(s, t)
            state, met = _dp_update(trainer, mesh, state, realA, realB, lr, pre)
            per_step.append(met)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return steps


def _average_scalars(aux: dict, mesh: Mesh) -> dict:
    average_([v for v in aux.values() if v.dim() == 0], mesh.group("data"))
    return aux


def make_cyclegan_dp_steps(trainer, mesh: Mesh):
    """(g_step, d_step) of a CycleGAN or multi-task trainer, data-parallel:
    the trainer's own steps on this rank's shard, with BatchNorm on the
    global batch, the gradients averaged before each Adam update and the
    scalar losses averaged after.  The images in g_step's aux stay the
    rank's shards.  The trainer itself is not changed."""
    t = copy.copy(trainer)

    group = mesh.group("data")

    def update(ts, grads, lr):
        average_(list(grads.values()), group)
        return type(trainer)._update(t, ts, grads, lr)

    t._update = update

    def g_step(state, realA, realB, lr):
        with norm.sync_batch_norm(group):
            state, aux = t.g_step(state, realA, realB, lr)
        return state, _average_scalars(aux, mesh)

    def d_step(state, realA, realB, fake_A, fake_B, lr):
        with norm.sync_batch_norm(group):
            state, aux = t.d_step(state, realA, realB, fake_A, fake_B, lr)
        return state, _average_scalars(aux, mesh)

    return g_step, d_step


def pool_query(pool, images: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A host ``ImagePool`` query of the global batch: every rank gathers the
    shards, queries its own copy of the pool (the same seed and the same
    images on every rank, so the same draws as one process on the global
    batch) and keeps its shard of the result."""
    pooled = pool.query(all_gather_batch(images, mesh))
    n = images.shape[0]
    return pooled[mesh.coord("data") * n:(mesh.coord("data") + 1) * n]


def make_gan_dp_iteration(trainer, mesh: Mesh):
    """iteration(state, realA, realB, g_lr, d_lr) -> (state, aux): one
    ``optimize_parameters`` iteration, data-parallel (``make_cyclegan_dp_steps``
    and ``pool_query``).  D_B's real images are the multi-task trainer's
    ``real_C`` where the G step returns one, else realA."""
    g_step, d_step = make_cyclegan_dp_steps(trainer, mesh)

    def iteration(state, realA, realB, g_lr, d_lr):
        state, aux = g_step(state, realA, realB, g_lr)
        fake_A = pool_query(trainer.fake_A_pool, aux["fake_A"], mesh)
        fake_B = pool_query(trainer.fake_B_pool, aux["fake_B"], mesh)
        real_d = aux["real_C"] if "real_C" in aux else realA
        state, d_aux = d_step(state, real_d, realB, fake_A, fake_B, d_lr)
        aux.update(d_aux)
        return state, aux

    return iteration


# -- the space axis ------------------------------------------------------------

def make_spatial_infer(model, mesh: Mesh, axis: str = "space"):
    """infer(x) -> this rank's output strip: ``model`` (any of the zoo, in
    eval mode) on this rank's strip of the NCHW input x (the whole input,
    the same on every rank), under ``spatial.space_scope``.  The strip plan
    follows ``spatial.geometry(model)``; ``infer.plan(h)`` gives it for an
    input of h rows.  ``spatial.gather_strips`` assembles the output on
    space rank 0."""
    align, rows = spatial.geometry(model)

    def plan(h: int) -> spatial.StripPlan:
        return spatial.plan_strips(h, mesh.size(axis), align, rows)

    @torch.no_grad()
    def infer(x):
        p = plan(x.shape[2])
        with spatial.space_scope(mesh, p, axis):
            return model(p.cut(x, mesh.coord(axis), dim=2))

    infer.plan = plan
    return infer


def cas_plan(trainer, h: int, ranks: int) -> spatial.StripPlan:
    """The strips of a (data, space) step over the target's ``h`` rows:
    aligned for the colorizer, the SR net at 1/up of them and the 1/up
    degradation (or the preprocess kernel) on blocks of ``up`` rows."""
    from srcgan_tpu_torch import models

    up = trainer.up
    a_sr, r_sr = spatial.geometry(models.create(trainer.sr_name, 1, 1, up, device="meta"))
    a_c, r_c = spatial.geometry(models.create(trainer.c_name, 1, 3, device="meta"))
    align = math.lcm(a_c, a_sr * up, up)
    return spatial.plan_strips(h, ranks, align, max(r_c, r_sr * up, align))


def _space_trainer(trainer, mesh: Mesh, axis: str):
    """A copy of ``trainer`` whose stage losses are its strip's share of
    the whole image's L1 and whose PSNRs are the whole image's."""
    from srcgan_tpu_torch.train.distill import DistillTrainer

    if (trainer.const or trainer.perceptual_params is not None or trainer.remat
            or isinstance(trainer, DistillTrainer)):
        raise ValueError("the (data, space) step takes the plain L1 cascade: not --const "
                         "(its bilinear re-upsampling is not strip-local), --perceptual, "
                         "distillation or remat (a recompute in another thread would "
                         "leave the strip)")
    group = mesh.group(axis)
    t = copy.copy(trainer)

    def total(*values):
        v = torch.stack([torch.as_tensor(x, dtype=torch.float64, device=trainer.device)
                         for x in values])
        dist.all_reduce(v, group=group)
        return v

    def stage_loss(pred, target, kd_target):
        count = total(float(pred.numel()))[0]
        return (pred - target).abs().sum() / count.to(pred.dtype)

    @torch.no_grad()
    def psnr(output, target):
        se, count = total((output - target).double().pow(2).sum(), float(output.numel()))
        return (10.0 * torch.log10(count / se)).float()

    t._stage_loss, t._psnr = stage_loss, psnr
    return t


def _space_grads(t, mesh: Mesh, state, src, tar, u8: bool, data_axis: str,
                 space_axis: str):
    """(grads, model states, metrics) of one (data, space) step from this
    data shard's full-height batch: summed over space, averaged over data."""
    plan = cas_plan(t, tar.shape[1], mesh.size(space_axis))
    i = mesh.coord(space_axis)
    tar_s = plan.cut(tar, i).contiguous()
    # realA is not read by the step (only the uint8 path's conversion takes it)
    src_s = (plan.cut(src, i).contiguous() if src is not None and src.shape[1] == tar.shape[1]
             else tar_s)
    with spatial.space_scope(mesh, plan, space_axis, stats_group=dist.group.WORLD):
        if u8:
            realA, realB, pre = t._u8_inputs(src_s, tar_s)
        else:
            realA, realB, pre = src_s, tar_s, None
        grads, mstates, metrics = t.grads(state, realA, realB, precomputed=pre)
    gs = [g for r in grads.values() for g in r.values()]
    average_(gs + [metrics["loss_SR"], metrics["loss_C"]], mesh.group(space_axis),
             dist.ReduceOp.SUM)
    if data_axis in mesh.shape:
        average_(gs + [b for r in mstates.values() for b in r.values()]
                 + list(metrics.values()), mesh.group(data_axis))
    return grads, mstates, metrics


def make_cas_2d_step(trainer, mesh: Mesh, data_axis: str = "data", space_axis: str = "space"):
    """step(state, realA, realB, lr) -> (state, metrics) of a CasTrainer on
    a (data, space) mesh: realA / realB this rank's data shard
    (``put_batch``) at full height, the state replicated and updated in
    place; the step cuts the rank's row strip of both (``cas_plan``).
    ``step.grads(state, realA, realB)`` returns the summed and averaged
    gradients without an update, for checks."""
    t = _space_trainer(trainer, mesh, space_axis)

    def grads(state, realA, realB):
        return _space_grads(t, mesh, state, trainer._tensor(realA), trainer._tensor(realB),
                            False, data_axis, space_axis)

    def step(state, realA, realB, lr):
        g, mstates, metrics = grads(state, realA, realB)
        return trainer.apply_grads(state, g, mstates, lr), metrics

    step.grads = lambda state, realA, realB: grads(state, realA, realB)[0]
    return step


def make_cas_2d_steps_u8(trainer, mesh: Mesh, data_axis: str = "data",
                         space_axis: str = "space"):
    """K (data, space) updates per call on (K, n, H, W, 3) uint8 blocks of
    this rank's data shard at full height, as ``make_cas_dp_steps_u8``: the
    gray and degrade chain runs on the rank's strip (through the preprocess
    kernel under ``fused_input``: its 1/up samples read only rows inside a
    block of ``up``, so a strip needs no halo for it)."""
    t = _space_trainer(trainer, mesh, space_axis)

    def steps(state, src_u8_k, tar_u8_k, lr):
        per_step = []
        for s, tar in zip(trainer._tensor(src_u8_k), trainer._tensor(tar_u8_k)):
            g, mstates, met = _space_grads(t, mesh, state, s, tar, True, data_axis,
                                           space_axis)
            state = trainer.apply_grads(state, g, mstates, lr)
            per_step.append(met)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return steps
