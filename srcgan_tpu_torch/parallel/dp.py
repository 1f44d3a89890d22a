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
"""
from __future__ import annotations

import copy
from typing import Dict, List

import torch
import torch.distributed as dist

from srcgan_tpu_torch.ops import norm
from srcgan_tpu_torch.parallel.mesh import Mesh, all_gather_batch


@torch.no_grad()
def average_(tensors: List[torch.Tensor]) -> None:
    """Average the float tensors of every rank in place, one all-reduce per
    dtype over their flattened concatenation."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        if t.is_floating_point():
            by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.AVG)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def _dp_update(trainer, state, realA, realB, lr, precomputed=None):
    """One averaged update: the shard's gradients, model states and metrics,
    their all-reduced means, the same Adam update on every rank."""
    grads, mstates, metrics = trainer.grads(state, realA, realB, precomputed=precomputed)
    average_([g for r in grads.values() for g in r.values()]
             + [b for r in mstates.values() for b in r.values()]
             + list(metrics.values()))
    return trainer.apply_grads(state, grads, mstates, lr), metrics


def make_cas_dp_step(trainer, mesh: Mesh):
    """step(state, realA, realB, lr) -> (state, metrics) for a CasTrainer:
    realA / realB are this rank's shard of the batch (``put_batch``), the
    state replicated (``put_replicated``) and updated in place."""
    def step(state, realA, realB, lr):
        return _dp_update(trainer, state, trainer._tensor(realA),
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
            state, met = _dp_update(trainer, state, realA, realB, lr, pre)
            per_step.append(met)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return steps


def _average_scalars(aux: dict) -> dict:
    average_([v for v in aux.values() if v.dim() == 0])
    return aux


def make_cyclegan_dp_steps(trainer, mesh: Mesh):
    """(g_step, d_step) of a CycleGAN or multi-task trainer, data-parallel:
    the trainer's own steps on this rank's shard, with BatchNorm on the
    global batch, the gradients averaged before each Adam update and the
    scalar losses averaged after.  The images in g_step's aux stay the
    rank's shards.  The trainer itself is not changed."""
    t = copy.copy(trainer)

    def update(ts, grads, lr):
        average_(list(grads.values()))
        return type(trainer)._update(t, ts, grads, lr)

    t._update = update

    def g_step(state, realA, realB, lr):
        with norm.sync_batch_norm():
            state, aux = t.g_step(state, realA, realB, lr)
        return state, _average_scalars(aux)

    def d_step(state, realA, realB, fake_A, fake_B, lr):
        with norm.sync_batch_norm():
            state, aux = t.d_step(state, realA, realB, fake_A, fake_B, lr)
        return state, _average_scalars(aux)

    return g_step, d_step


def pool_query(pool, images: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A host ``ImagePool`` query of the global batch: every rank gathers the
    shards, queries its own copy of the pool (the same seed and the same
    images on every rank, so the same draws as one process on the global
    batch) and keeps its shard of the result."""
    pooled = pool.query(all_gather_batch(images, mesh))
    n = images.shape[0]
    return pooled[mesh.rank * n:(mesh.rank + 1) * n]


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
