"""FSDP (ZeRO-3): the parameters sharded at rest too
(``srcgan_tpu.parallel.fsdp``).

ZeRO-1 (``parallel.zero``) shards Adam's moments and keeps the parameters
on every rank.  Here a network's parameters live only as this rank's row
of the flattened vector (the ``ShardedAdam``'s ``rows``, next to its two
moment rows), and the module's parameters hold no storage between steps:

    at rest:  3 x ceil(n / D) fp32 values a network on each rank
    a step:   rows --all_gather_into_tensor--> full parameters (forward,
              backward); the shard's gradients --reduce_scatter_tensor-->
              this rank's rows; Adam on the rows; the full parameters freed

The volume on the interconnect is ZeRO-1's; only the gather moves, from
the end of a step to its start.  The whole network is gathered at once (the
JAX package does the same: this zoo's networks are megabytes), so the peak
of a step still holds the full parameters and gradients.  Explicit
collectives, not ``FullyShardedDataParallel``: the trainer's gradients come
from ``torch.autograd.grad`` through ``functional_call``, which FSDP's
hooks never see.

Anything that reads the modules between steps (a snapshot, a checkpoint)
does so inside ``gathered(state)``, a collective that every rank enters;
``fsdp_full_params`` returns copies of the full parameters.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from srcgan_tpu_torch.parallel.dp import average_
from srcgan_tpu_torch.parallel.mesh import Mesh
from srcgan_tpu_torch.parallel.zero import ShardedAdam, _chunk, _numel, _shard_state
from srcgan_tpu_torch.train import optim


def _shapes(state) -> Dict[str, Dict[str, tuple]]:
    return {role: dict(zip(ts.opt.names, ts.opt.shapes)) for role, ts in state._asdict().items()}


@torch.no_grad()
def _release(ts) -> None:
    """Free the module's parameters (the rows keep them)."""
    for p in ts.model.parameters():
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


@torch.no_grad()
def _materialize(ts, full: torch.Tensor) -> None:
    """The module's parameters from the full flat vector, each at the strides
    it had (a channels_last conv keeps its layout, and cuDNN its algorithm)."""
    views = ts.opt.unflatten(full)
    for (name, p), stride in zip(ts.model.named_parameters(), ts.opt.strides):
        v = views[name]
        t = torch.empty_strided(v.shape, stride, dtype=p.dtype, device=v.device)
        p.data = t.copy_(v)


def _is_fsdp(ts) -> bool:
    return isinstance(ts.opt, ShardedAdam) and ts.opt.fsdp


@contextlib.contextmanager
def gathered(state):
    """Scope in which an FSDP state's modules hold their full parameters
    (gathered from every rank's rows; a collective) and after which they
    hold none again.  A state of another layout passes through."""
    fsdp_ts = [ts for ts in state._asdict().values() if _is_fsdp(ts)]
    for ts in fsdp_ts:
        _materialize(ts, ts.opt.gather(ts.opt.rows))
    try:
        yield state
    finally:
        for ts in fsdp_ts:
            _release(ts)


def fsdp_from_state(state, mesh: Mesh):
    """The FSDP layout of an initialized CasState: rank 0's parameters cut
    into rows, fresh moments, the modules' parameters freed.  Returns
    (state, shapes), ``shapes`` the {role: {name: shape}} of the full
    parameters."""
    state = _shard_state(state, mesh, keep_moments=False, fsdp=True)
    for ts in state._asdict().values():
        _release(ts)
    return state, _shapes(state)


def fsdp_init(trainer, seed, mesh: Mesh):
    """(FSDP CasState, shapes) from a fresh init."""
    return fsdp_from_state(trainer.init(seed), mesh)


def fsdp_put(state, mesh: Mesh):
    """The FSDP layout of a plain state that holds Adam moments (a restored
    checkpoint): each rank keeps its rows of the parameters and moments."""
    state = _shard_state(state, mesh, keep_moments=True, fsdp=True)
    for ts in state._asdict().values():
        _release(ts)
    return state


def fsdp_full_params(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copies of the full parameters, {role: {name: tensor}}: a collective
    (every rank calls it), where the JAX package reshapes a globally
    addressable array on the host."""
    with gathered(state):
        return {role: {n: p.detach().clone() for n, p in ts.model.named_parameters()}
                for role, ts in state._asdict().items()}


def fsdp_state_bytes_per_device(params, mesh: Mesh, axis: str = "data") -> int:
    """The bytes one rank holds at rest for one network (a module, or its
    parameters or their shapes): its row of the parameters and of both
    moments, 3 x ceil(n / D) fp32 values."""
    return 3 * _chunk(_numel(params), mesh.shape[axis]) * 4


def _fsdp_update(trainer, state, realA, realB, lr, precomputed=None):
    with gathered(state):
        grads, mstates, metrics = trainer.grads(state, realA, realB, precomputed=precomputed)
    average_([b for r in mstates.values() for b in r.values()] + list(metrics.values()),
             state[0].opt.group)
    new = {}
    for role, ts in state._asdict().items():
        opt: ShardedAdam = ts.opt
        optim.set_lr(opt, float(lr))
        row_grad = opt.reduce_scatter(grads[role])
        del grads[role]
        with torch.no_grad():
            opt.rows.grad = row_grad
            opt.opt.step()
            opt.opt.zero_grad(set_to_none=True)
            for name, b in ts.model.named_buffers():
                b.copy_(mstates[role][name])
        new[role] = ts._replace(step=ts.step + 1)
    return type(state)(**new), metrics


def make_cas_fsdp_step(trainer, mesh: Mesh):
    """step(state, realA, realB, lr) -> (state, metrics) for a CasTrainer on
    an FSDP state (``fsdp_init``), this rank's shard of the batch; the same
    math as ``make_cas_dp_step`` with torch's Adam.  (The JAX package's
    wrapper also takes the shapes; the state carries its own here.)"""
    def step(state, realA, realB, lr):
        return _fsdp_update(trainer, state, trainer._tensor(realA),
                            trainer._tensor(realB), lr)

    return step


def make_cas_fsdp_steps_u8(trainer, mesh: Mesh):
    """K FSDP updates per call on (K, n, H, W, 3) uint8 blocks (this rank's
    shard); metrics stacked per step."""
    def steps(state, src_u8_k, tar_u8_k, lr):
        per_step = []
        for s, t in zip(trainer._tensor(src_u8_k), trainer._tensor(tar_u8_k)):
            realA, realB, pre = trainer._u8_inputs(s, t)
            state, met = _fsdp_update(trainer, state, realA, realB, lr, pre)
            per_step.append(met)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return steps
