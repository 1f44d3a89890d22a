"""ZeRO-1: data parallelism with Adam's state sharded over the ranks
(``srcgan_tpu.parallel.zero``).

Plain data parallelism keeps Adam's two moments on every rank, though each
rank applies the same update.  ZeRO-1 keeps the parameters replicated for
the forward and shards the optimizer:

    the shard's gradients --reduce_scatter--> this rank's rows, averaged
    Adam on this rank's rows only (its moments: 8/D bytes a parameter)
    updated rows --all_gather--> the full parameters for the next forward

Each gradient element crosses the interconnect once and each parameter
element once, the volume of plain data parallelism's all-reduce.

Layout.  A network's parameters are flattened in ``named_parameters``
order into one fp32 vector, zero-padded to a multiple of D, and viewed as D
rows; rank i holds row i.  ``ShardedAdam`` keeps the row as a parameter of
a ``torch.optim.Adam`` built with the trainer's own hyperparameters (its
optimizer's betas and eps), so the update is torch's Adam, the plain step's,
on the rows.  (The JAX package pads each leaf to D rows; one vector a
network costs one collective of each kind per step where a leaf's would
cost one per leaf.)  ``zero1_opt_bytes_per_device`` counts what a rank
really holds: 2 x ceil(n / D) fp32 values a network.

A ZeRO state is the trainer's state with each ``TrainState.opt`` a
``ShardedAdam``: ``zero1_from_state`` makes one with fresh moments,
``zero1_put`` one that keeps a plain state's moments (a restored
checkpoint), and ``plain_state`` turns it back into a plain state, with
the moments gathered, for the .npz full-state file.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, List

import torch
import torch.distributed as dist
from torch import nn

from srcgan_tpu_torch.ops import norm
from srcgan_tpu_torch.parallel.dp import average_
from srcgan_tpu_torch.parallel.mesh import Mesh, put_replicated
from srcgan_tpu_torch.train import optim
from srcgan_tpu_torch.train.state import TrainState


# torch 2.13 renamed the two collectives (the old names warn); older ones lack the new
_reduce_scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _chunk(n: int, d: int) -> int:
    return -(-n // d)


def _numel(params) -> int:
    """Elements of a network's parameters: a module, a dict of tensors or
    shapes, or an iterable of them."""
    if isinstance(params, nn.Module):
        params = [p for _, p in params.named_parameters()]
    elif isinstance(params, dict):
        params = list(params.values())
    return sum(math.prod(p.shape) if isinstance(p, torch.Tensor) else math.prod(p)
               for p in params)


class ShardedAdam:
    """Adam over this rank's row of a network's flattened parameters.

    ``rows`` is the row (a leaf tensor that ``opt``, a torch Adam, updates);
    ``param_groups`` is ``opt``'s, so ``optim.set_lr`` works on it.  ``fsdp``: the row also stores the parameters at rest
    (``parallel.fsdp``), and the module's parameters hold nothing between
    steps."""

    def __init__(self, model: nn.Module, mesh: Mesh, lr: float, betas, eps: float,
                 fsdp: bool = False):
        self.mesh, self.fsdp = mesh, fsdp
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        # each parameter's strides (channels_last convs), which FSDP restores
        self.strides = [p.stride() for _, p in named]
        self.numel = sum(math.prod(s) for s in self.shapes)
        self.ranks, self.group = mesh.size("data"), mesh.group("data")
        self.chunk = _chunk(self.numel, self.ranks)
        at = mesh.coord("data")
        flat = self.flatten([p.detach() for _, p in named])
        self.rows = flat[at * self.chunk:(at + 1) * self.chunk].clone()
        self.rows.requires_grad_(True)
        self.opt = torch.optim.Adam([self.rows], lr=lr, betas=tuple(betas), eps=eps)

    @property
    def param_groups(self):
        return self.opt.param_groups

    def flatten(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """The tensors as one fp32 vector padded to D rows of ``chunk``."""
        flat = torch.zeros(self.ranks * self.chunk, dtype=torch.float32,
                           device=self.mesh.device)
        off = 0
        for t in tensors:
            flat[off:off + t.numel()] = t.reshape(-1)
            off += t.numel()
        return flat

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of a full flat vector, by parameter name."""
        out, off = {}, 0
        for name, shape in zip(self.names, self.shapes):
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape)
            off += n
        return out

    def reduce_scatter(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """This rank's row of the ranks' mean gradient."""
        flat = self.flatten([grads[n] for n in self.names])
        out = torch.empty(self.chunk, dtype=flat.dtype, device=flat.device)
        _reduce_scatter(out, flat, op=dist.ReduceOp.SUM, group=self.group)
        return out.div_(self.ranks)

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """Every rank's row of a vector, concatenated (the padded full vector)."""
        out = torch.empty(self.ranks * self.chunk, dtype=rows.dtype, device=rows.device)
        _all_gather(out, rows.detach().contiguous(), group=self.group)
        return out

    @torch.no_grad()
    def step(self, row_grad: torch.Tensor) -> torch.Tensor:
        """One Adam update of the row; returns the updated full vector."""
        self.rows.grad = row_grad
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return self.gather(self.rows)

    def moments(self):
        """(mu rows, nu rows, update count): zeros and 0 before the first step."""
        st = self.opt.state.get(self.rows, {})
        if "exp_avg" not in st:
            z = torch.zeros_like(self.rows.detach())
            return z, z.clone(), 0
        return st["exp_avg"], st["exp_avg_sq"], int(st["step"])

    @torch.no_grad()
    def set_moments(self, mu: torch.Tensor, nu: torch.Tensor, count: int) -> None:
        self.opt.state.clear()
        if count:
            self.opt.state[self.rows] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": mu.to(self.rows.device).clone(),
                "exp_avg_sq": nu.to(self.rows.device).clone()}


def _shard_ts(ts: TrainState, mesh: Mesh, keep_moments: bool, fsdp: bool = False
              ) -> TrainState:
    """The TrainState with its optimizer replaced by a ShardedAdam of the same
    hyperparameters (and, with ``keep_moments``, this rank's rows of the
    plain optimizer's moments)."""
    group = ts.opt.param_groups[0]
    sharded = ShardedAdam(ts.model, mesh, group["lr"], group["betas"], group["eps"], fsdp)
    if keep_moments:
        params = [p for _, p in ts.model.named_parameters()]
        states = [ts.opt.state.get(p, {}) for p in params]
        count = int(states[0]["step"]) if "step" in states[0] else 0
        if count:
            at = mesh.coord("data")
            lo, hi = at * sharded.chunk, (at + 1) * sharded.chunk
            mu = sharded.flatten([s["exp_avg"] for s in states])[lo:hi]
            nu = sharded.flatten([s["exp_avg_sq"] for s in states])[lo:hi]
            sharded.set_moments(mu, nu, count)
    return ts._replace(opt=sharded)


def _shard_state(state, mesh: Mesh, keep_moments: bool, fsdp: bool = False):
    put_replicated(state, mesh)
    return type(state)(**{r: _shard_ts(ts, mesh, keep_moments, fsdp)
                          for r, ts in state._asdict().items()})


def zero1_from_state(state, mesh: Mesh):
    """The ZeRO-1 layout of an initialized state (a CasState, or a
    CycleState: ``zero1_gd_from_state``): rank 0's parameters on every rank,
    each optimizer a ShardedAdam with fresh moments (the plain optimizer's
    moments are dropped; ``zero1_put`` keeps them)."""
    return _shard_state(state, mesh, keep_moments=False)


def zero1_init(trainer, seed, mesh: Mesh):
    """A fresh ZeRO-1 state of ``trainer``."""
    return zero1_from_state(trainer.init(seed), mesh)


def zero1_put(state, mesh: Mesh):
    """The ZeRO-1 layout of a plain state that holds Adam moments (a
    restored checkpoint): each rank keeps its rows of them."""
    return _shard_state(state, mesh, keep_moments=True)


zero1_gd_from_state = zero1_from_state
zero1_gd_put = zero1_put


def zero1_opt_bytes_per_device(params, mesh: Mesh, axis: str = "data") -> int:
    """The bytes one rank holds of Adam's moments for one network (a module,
    or its parameters or their shapes): 2 x ceil(n / D) fp32 values."""
    return 2 * _chunk(_numel(params), mesh.shape[axis]) * 4


@torch.no_grad()
def _set_params(model: nn.Module, full: Dict[str, torch.Tensor]) -> None:
    for name, p in model.named_parameters():
        p.copy_(full[name])


def _zero1_update_ts(ts: TrainState, grads: Dict[str, torch.Tensor], lr) -> TrainState:
    opt: ShardedAdam = ts.opt
    optim.set_lr(opt, float(lr))
    full = opt.step(opt.reduce_scatter(grads))
    _set_params(ts.model, opt.unflatten(full))
    return ts._replace(step=ts.step + 1)


def _zero1_update(trainer, state, realA, realB, lr, precomputed=None):
    grads, mstates, metrics = trainer.grads(state, realA, realB, precomputed=precomputed)
    average_([b for r in mstates.values() for b in r.values()] + list(metrics.values()),
             state[0].opt.group)
    new = {}
    for role, ts in state._asdict().items():
        ts = _zero1_update_ts(ts, grads[role], lr)
        with torch.no_grad():
            for name, b in ts.model.named_buffers():
                b.copy_(mstates[role][name])
        new[role] = ts
    return type(state)(**new), metrics


def make_cas_zero1_step(trainer, mesh: Mesh):
    """step(state, realA, realB, lr) -> (state, metrics) for a CasTrainer on
    a ZeRO-1 state (``zero1_init``): this rank's shard of the batch, the
    same math as ``make_cas_dp_step`` with torch's Adam."""
    def step(state, realA, realB, lr):
        return _zero1_update(trainer, state, trainer._tensor(realA),
                             trainer._tensor(realB), lr)

    return step


def make_cas_zero1_steps_u8(trainer, mesh: Mesh):
    """K ZeRO-1 updates per call on (K, n, H, W, 3) uint8 blocks (this rank's
    shard), as ``dp.make_cas_dp_steps_u8``; metrics stacked per step."""
    def steps(state, src_u8_k, tar_u8_k, lr):
        per_step = []
        for s, t in zip(trainer._tensor(src_u8_k), trainer._tensor(tar_u8_k)):
            realA, realB, pre = trainer._u8_inputs(s, t)
            state, met = _zero1_update(trainer, state, realA, realB, lr, pre)
            per_step.append(met)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return steps


def make_gd_zero1_step(trainer, mesh: Mesh):
    """step(state, realA, realB, g_lr, d_lr) -> (state, aux): one fused G+D
    iteration of a CycleGAN trainer on a ZeRO-1 CycleState
    (``zero1_gd_from_state``), as ``CycleGANTrainer.gd_step`` (the D step on
    this step's fakes, pool_size 0): BatchNorm on the global batch, each
    network's gradients reduce-scattered into its sharded Adam."""
    from srcgan_tpu_torch.parallel.dp import _average_scalars

    t = copy.copy(trainer)
    t._update = lambda ts, grads, lr: _zero1_update_ts(ts, grads, lr)

    def step(state, realA, realB, g_lr, d_lr):
        with norm.sync_batch_norm(mesh.group("data")):
            state, aux = t.gd_step(state, realA, realB, g_lr, d_lr)
        return state, _average_scalars(aux, mesh)

    return step


def plain_state(state, trainer_init):
    """A plain state (torch Adam with full moments) holding a sharded
    state's values, for the .npz full-state file: ``trainer_init()`` makes
    the template.  A collective: every rank calls it."""
    from srcgan_tpu_torch.parallel import fsdp

    out = trainer_init()
    with fsdp.gathered(state):
        for role, ts in state._asdict().items():
            dst = getattr(out, role)
            opt: ShardedAdam = ts.opt
            dst.model.load_state_dict(ts.model.state_dict())
            mu, nu, count = opt.moments()
            mu, nu = (opt.unflatten(opt.gather(m)) for m in (mu, nu))
            dst.opt.state.clear()
            for name, p in dst.model.named_parameters():
                if count:
                    dst.opt.state[p] = {"step": torch.tensor(float(count)),
                                        "exp_avg": mu[name].clone(),
                                        "exp_avg_sq": nu[name].clone()}
            optim.set_lr(dst.opt, opt.param_groups[0]["lr"])
    return type(state)(**{r: getattr(out, r)._replace(step=ts.step)
                          for r, ts in state._asdict().items()})
