"""Pipeline parallelism over the mesh's ``pipe`` axis (``srcgan_tpu.parallel.pipeline``).

The JAX package writes its pipelines as one SPMD program: a scan over ticks
whose stage split is a branch on the axis index, the activations riding a
``ppermute`` ring, the backward derived by autodiff through the ring.  Torch
autograd does not cross a ``send`` / ``recv``, so here each stage is its own
program and the schedules are written out by hand, one process a stage:

- ``make_cascade_pipeline_infer``: SR on pipe rank 0, colorize on rank 1.
  Rank 0 ``isend``s microbatch t while it computes t+1; rank 1 learns the
  activation's shape from a header before its first ``recv``.
- ``make_rddb_trunk_pipeline_infer``: RRDB s on stage s.  Stage 0 stems
  each microbatch (``RDDBNet.head``), every stage runs its RRDB and sends
  ``(fea, h)`` on, the last stage runs ``RDDBNet.finish`` (in bf16 eval at
  W % 128 == 0 that is the RDB5 kernel on every stage and the x4 tail kernel
  on the last).
- ``make_trunk_pipeline_train``: GPipe.  The forward runs every microbatch
  and keeps each tick's graph; the backward runs the ticks in reverse, each
  stage receiving ``(g_fea, g_h)`` from the next, running its backward and
  sending ``(g_fea, g_h_in)`` back; stage 0 takes both into the head.  The
  head and tail gradients are summed over ``pipe`` (each acts on one stage),
  a stage's gradients stay on it, and with ``data_axis`` the loss and every
  gradient are averaged over ``data``.  The update is Adam with optax's
  ``scale_by_adam`` defaults, then ``p - lr * u``, on each stage's own
  parameters: its RRDB's moments live only there.

Microbatch queues are NCHW: (T, m, C, H, W).  Every form returns its
result on every rank of the pipe line, as the JAX functions return
replicated arrays.
"""
from __future__ import annotations

import copy
from typing import Dict, List

import torch
import torch.distributed as dist
from torch import nn

from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.parallel.mesh import Mesh

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.uint8]
_HEAD = 8


class _Line:
    """The pipe line of this rank: its stage, its neighbours, the header
    and tensor messages between them."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.size, self.stage, self.group = mesh.size(axis), mesh.coord(axis), mesh.group(axis)
        self.device = mesh.device

    def rank_of(self, stage: int) -> int:
        return self.mesh.peer(self.axis, stage)

    def send(self, tensors: List[torch.Tensor], stage: int, pending: list) -> None:
        """isend NCHW tensors (as their NHWC bytes) to ``stage``, each led
        by its header; ``pending`` keeps the requests and buffers."""
        for t in tensors:
            t = to_nhwc(t.detach()).contiguous()
            head = torch.zeros(_HEAD, dtype=torch.int64, device=t.device)
            head[0], head[1] = _DTYPES.index(t.dtype), t.dim()
            head[2:2 + t.dim()] = torch.tensor(t.shape)
            for msg in (head, t):
                pending.append((dist.isend(msg, self.rank_of(stage), self.group), msg))

    def recv(self, count: int, stage: int) -> List[torch.Tensor]:
        out = []
        for _ in range(count):
            head = torch.empty(_HEAD, dtype=torch.int64, device=self.device)
            dist.recv(head, self.rank_of(stage), self.group)
            h = head.tolist()
            t = torch.empty(h[2:2 + h[1]], dtype=_DTYPES[h[0]], device=self.device)
            dist.recv(t, self.rank_of(stage), self.group)
            out.append(to_nchw(t))
        return out

    def broadcast_from(self, stage: int, t: torch.Tensor | None) -> torch.Tensor:
        """``t`` of ``stage`` on every rank of the line."""
        src = self.rank_of(stage)
        head = torch.zeros(_HEAD, dtype=torch.int64, device=self.device)
        if self.stage == stage:
            t = t.contiguous()
            head[0], head[1] = _DTYPES.index(t.dtype), t.dim()
            head[2:2 + t.dim()] = torch.tensor(t.shape)
        dist.broadcast(head, src, group=self.group)
        h = head.tolist()
        if self.stage != stage:
            t = torch.empty(h[2:2 + h[1]], dtype=_DTYPES[h[0]], device=self.device)
        dist.broadcast(t, src, group=self.group)
        return t


def _wait(pending: list) -> None:
    for req, _ in pending:
        req.wait()
    pending.clear()


def make_cascade_pipeline_infer(stage0_fn, stage1_fn, mesh: Mesh, axis: str = "pipe"):
    """infer(xq) -> stack over t of stage1_fn(stage0_fn(xq[t])) for a queue
    of T microbatches: stage0_fn (e.g. the SR net) on pipe rank 0,
    stage1_fn (the colorizer) on rank 1.  The axis must have size 2."""
    if mesh.size(axis) != 2:
        raise ValueError(f"2-stage pipeline needs axis '{axis}' of size 2, "
                         f"got {mesh.size(axis)}")
    line = _Line(mesh, axis)

    @torch.no_grad()
    def infer(xq):
        pending: list = []
        out = None
        if line.stage == 0:
            for x in xq:
                line.send([stage0_fn(x)], 1, pending)   # runs on while t+1 computes
            _wait(pending)
        else:
            out = torch.stack([stage1_fn(line.recv(1, 0)[0]) for _ in range(len(xq))])
        return line.broadcast_from(1, out)

    return infer


def stack_trunk_params(trunk: nn.Sequential) -> Dict[str, torch.Tensor]:
    """The blocks' parameters stacked on a leading stage axis, by name."""
    states = [dict(b.named_parameters()) for b in trunk]
    return {k: torch.stack([s[k].detach() for s in states]) for k in states[0]}


def _check_depth(model, mesh: Mesh, axis: str) -> None:
    nb = len(model.RRDB_trunk)
    if mesh.size(axis) != nb:
        raise ValueError(f"trunk pipeline needs axis '{axis}' of size equal to the trunk "
                         f"depth (nb={nb}), got {mesh.size(axis)}")


def place_trunk_pipeline_params(model, mesh: Mesh, axis: str = "pipe"):
    """(head_tail, stage) for this rank: ``head_tail`` shares every module
    of the RDDBNet but its trunk, which it does not hold; ``stage`` is RRDB
    s of pipe stage s.  Once the caller drops the whole model, the rank
    keeps only its own block of the trunk."""
    _check_depth(model, mesh, axis)
    stage = model.RRDB_trunk[mesh.coord(axis)]
    head_tail = copy.copy(model)
    head_tail._modules = dict(model._modules)
    head_tail._modules["RRDB_trunk"] = nn.Sequential()
    return head_tail, stage


def _pair(model, mesh: Mesh, axis: str):
    return model if isinstance(model, tuple) else place_trunk_pipeline_params(model, mesh, axis)


def make_rddb_trunk_pipeline_infer(model, mesh: Mesh, axis: str = "pipe"):
    """infer(params, xq) -> the RDDBNet's output per microbatch, its trunk
    pipelined over ``axis`` (size = the trunk depth).  ``params``: the model
    itself, or the pair of ``place_trunk_pipeline_params``."""
    _check_depth(model, mesh, axis)
    line = _Line(mesh, axis)
    last = line.size - 1

    @torch.no_grad()
    def infer(params, xq):
        head_tail, block = _pair(params, mesh, axis)
        pending: list = []
        outs = []
        for x in xq:
            if line.stage == 0:
                fea = h = head_tail.head(x)
            else:
                fea, h = line.recv(2, line.stage - 1)
            h = block(h)
            if line.stage == last:
                outs.append(head_tail.finish(fea, h))
            else:
                line.send([fea, h], line.stage + 1, pending)
        _wait(pending)
        return line.broadcast_from(last, torch.stack(outs) if outs else None)

    return infer


def make_trunk_pipeline_train(model, mesh: Mesh, axis: str = "pipe", data_axis: str | None = None):
    """GPipe training of the RDDBNet's trunk pipeline on the mean L1 of all
    microbatches.  Returns (init_opt, step, grads):

      init_opt(pair) -> opt_state (Adam's moments of this rank's parameters)
      step(pair, opt_state, xq, yq, lr) -> (pair, opt_state, loss), in place
      grads(pair, xq, yq) -> (loss, g_head_tail, g_stage), by parameter name

    with pair = ``place_trunk_pipeline_params(model, mesh)``, xq the
    (T, m, C, H, W) microbatch queue and yq its (T, m, C, uH, uW) targets,
    the same on every rank; with ``data_axis`` each data rank takes its
    slice of the m samples.  The model is put in train mode: its tail then
    differentiates through conv_last (the eval tail folds it without
    autograd)."""
    _check_depth(model, mesh, axis)
    model.train()
    line = _Line(mesh, axis)
    last = line.size - 1

    def shard(q):
        if data_axis is None:
            return q
        m = q.shape[1] // mesh.size(data_axis)
        return q[:, mesh.coord(data_axis) * m:(mesh.coord(data_axis) + 1) * m]

    def grads(pair, xq, yq):
        head_tail, block = pair
        xq, yq = shard(xq), shard(yq)
        ht = dict(head_tail.named_parameters())
        st = dict(block.named_parameters())
        params = list(ht.values()) + list(st.values())
        acc = [torch.zeros_like(p) for p in params]
        pending: list = []
        ticks = []
        loss = torch.zeros((), dtype=params[0].dtype, device=line.device)
        with torch.enable_grad():
            for t, x in enumerate(xq):          # the forward, every graph kept
                if line.stage == 0:
                    fea = h_in = head_tail.head(x)
                    inputs = []
                else:
                    fea, h_in = (v.requires_grad_(True) for v in line.recv(2, line.stage - 1))
                    inputs = [fea, h_in]
                h = block(h_in)
                if line.stage == last:
                    out = head_tail.finish(fea, h)
                    roots = [(out - yq[t].to(out.dtype)).abs().mean() / len(xq)]
                    loss = loss + roots[0].detach().to(loss.dtype)
                else:
                    line.send([fea, h], line.stage + 1, pending)
                    roots = [fea, h]
                ticks.append((roots, inputs))
        _wait(pending)
        for roots, inputs in reversed(ticks):   # the backward, ticks reversed
            if line.stage == last:
                seeds = [None]
            else:
                seeds = line.recv(2, line.stage + 1)
                seeds = [s.to(r.dtype) for s, r in zip(seeds, roots)]
            got = torch.autograd.grad(roots, inputs + params, seeds, allow_unused=True)
            if inputs:
                line.send(list(got[:2]), line.stage - 1, pending)
            for a, g in zip(acc, got[len(inputs):]):
                if g is not None:
                    a.add_(g)
        _wait(pending)
        g_ht = dict(zip(ht, acc[:len(ht)]))
        g_st = dict(zip(st, acc[len(ht):]))
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1).to(loss.dtype) for g in g_ht.values()])
        dist.all_reduce(flat, group=line.group)
        if data_axis is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=mesh.group(data_axis))
            for g in g_st.values():
                dist.all_reduce(g, op=dist.ReduceOp.AVG, group=mesh.group(data_axis))
        off = 1
        for g in g_ht.values():
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return flat[0], g_ht, g_st

    def init_opt(pair):
        named = {f"ht.{k}": p for k, p in pair[0].named_parameters()}
        named.update({f"tr.{k}": p for k, p in pair[1].named_parameters()})
        return {"mu": {k: torch.zeros_like(p) for k, p in named.items()},
                "nu": {k: torch.zeros_like(p) for k, p in named.items()}, "count": 0}

    @torch.no_grad()
    def step(pair, opt_state, xq, yq, lr):
        loss, g_ht, g_st = grads(pair, xq, yq)
        b1, b2, eps = 0.9, 0.999, 1e-8
        count = opt_state["count"] + 1
        named = {f"ht.{k}": p for k, p in pair[0].named_parameters()}
        named.update({f"tr.{k}": p for k, p in pair[1].named_parameters()})
        gs = {**{f"ht.{k}": g for k, g in g_ht.items()}, **{f"tr.{k}": g for k, g in g_st.items()}}
        for k, p in named.items():
            mu, nu = opt_state["mu"][k], opt_state["nu"][k]
            mu.mul_(b1).add_(gs[k], alpha=1 - b1)
            nu.mul_(b2).addcmul_(gs[k], gs[k], value=1 - b2)
            u = (mu / (1 - b1 ** count)) / ((nu / (1 - b2 ** count)).sqrt() + eps)
            p.sub_(lr * u)
        opt_state["count"] = count
        return pair, opt_state, loss

    return init_opt, step, grads
