"""Tensor (model) parallelism over the mesh's ``model`` axis
(``srcgan_tpu.parallel.tp``).

The JAX package shards every conv kernel's output channels over ``model``
and lets GSPMD place the collectives.  Here they are written out.  A layer
is **split** where its output channels divide by the axis size: a
``Conv2d`` (OIHW) keeps rows ``dim 0`` of its weight and its bias, a
``ConvTranspose2d`` (IOHW) ``dim 1``; every other parameter (the 3- or
1-channel output convs, the norm scales and biases) stays replicated.
``tp_shard_params`` keeps only this rank's slice in the module and hooks
the layer: its input passes unchanged forward and has its gradient summed
over ``model`` backward (each rank's slice contributes its part of it), and
its output slice is all-gathered along C before any consumer, whose work is
then replicated.  The gather's backward hands each rank **its own slice** of
the output gradient: a sum there would scale every gradient by the axis size
(the JAX package's pipeline measured the same trap with a psum at 3x).

``RDDBNet``'s tail reads its deconv and conv_last weights itself and RDB5
hands its convolutions to its kernel, so hooks on module forwards would
miss both; ``make_tp_infer`` and ``make_cas_tp_step`` run under
``models.blocks.tensor_parallel``, an explicit scope that sends RDB5
through its per-conv path and the tail through unfolded deconvs and
conv_last, each a split (or replicated) module call.  No kernel runs on this
path: a channel slice of a dense block cannot go through a kernel that
needs the block's whole weights.

``make_cas_tp_step`` composes this with the ``data`` axis on a (data,
model) mesh: the batch shards over ``data``, gradients of split and
replicated parameters alike are averaged over ``data`` (never summed over
``model``: a replicated parameter's gradient is already whole on every
rank), and Adam runs on the slices, so updates and moments take 1/|model|
of a split layer's memory per rank.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from srcgan_tpu_torch.models.blocks import tensor_parallel
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.parallel.dp import average_
from srcgan_tpu_torch.parallel.mesh import Mesh


def _split_dim(module: nn.Module, name: str, size: int) -> Optional[int]:
    if isinstance(module, nn.Conv2d):
        out = module.out_channels
        dim = 0
    elif isinstance(module, nn.ConvTranspose2d):
        out = module.out_channels
        dim = 1 if name == "weight" else 0
    else:
        return None
    if size <= 1 or out % size or out < size:
        return None
    return dim


def tp_param_shardings(model: nn.Module, mesh: Mesh, axis: str = "model"
                       ) -> Dict[str, Optional[int]]:
    """Parameter name -> the dim split over ``axis``, or None (replicated)."""
    size = mesh.size(axis)
    out = {}
    for mname, m in model.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            out[full] = _split_dim(m, pname, size)
    return out


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """The ranks' channel slices of NCHW x, concatenated in rank order;
    backward: this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.c = rank, x.shape[1]
        t = to_nhwc(x).contiguous()
        buf = torch.empty((size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
            buf.view(-1, *t.shape[1:]), t, group=group)
        n, h, w, c = t.shape
        return to_nchw(buf.permute(1, 2, 3, 0, 4).reshape(n, h, w, size * c))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.c
        return g[:, lo:lo + ctx.c], None, None, None


def tp_shard_params(model: nn.Module, mesh: Mesh, axis: str = "model", opt=None) -> nn.Module:
    """Keep only this rank's slice of every split parameter of ``model`` (in
    place: the Parameter objects stay, so an optimizer over them keeps
    them; ``opt``'s moments of them, where it has any, are sliced too) and
    hook the split layers.  Returns the model."""
    size, rank, group = mesh.size(axis), mesh.coord(axis), mesh.group(axis)
    dims = tp_param_shardings(model, mesh, axis)
    for mname, m in model.named_modules():
        if getattr(m, "_tp_split", False):
            continue
        split = False
        for pname, p in m.named_parameters(recurse=False):
            dim = dims[f"{mname}.{pname}" if mname else pname]
            if dim is None:
                continue
            split = True
            with torch.no_grad():
                if opt is not None:
                    for k, v in opt.state.get(p, {}).items():
                        if isinstance(v, torch.Tensor) and v.shape == p.shape:
                            opt.state[p][k] = v.chunk(size, dim)[rank].clone()
                p.data = p.data.chunk(size, dim)[rank].clone()
        if split:
            m._tp_split = True
            m.register_forward_pre_hook(
                lambda mod, args: (_ReduceGrad.apply(args[0], group),) + tuple(args[1:]))
            m.register_forward_hook(
                lambda mod, args, out: _GatherChannels.apply(out, group, size, rank))
    return model


def make_tp_infer(model: nn.Module, mesh: Mesh, axis: str = "model"):
    """infer(x) -> the whole output on every rank: ``model`` (eval mode)
    with its split layers computing their channel slices.  Pass the model
    through ``tp_shard_params`` first (``make_tp_infer`` does where it has
    not been)."""
    tp_shard_params(model, mesh, axis)

    @torch.no_grad()
    def infer(x):
        with tensor_parallel():
            return model(x)

    return infer


def make_cas_tp_step(trainer, mesh: Mesh, data_axis: str = "data", model_axis: str = "model"):
    """step(state, realA, realB, lr) -> (state, metrics) of a CasTrainer on
    a (data, model) mesh (or a model-only one): realA / realB this rank's data shard
    (``put_batch``), the state replicated (``put_replicated``) and split
    over ``model`` by the first call (its modules and Adam moments keep the
    slices from then on), updated in place.  ``step.grads(state, realA,
    realB)`` returns the averaged gradients (of the slices) without an
    update, for checks."""
    def shard(state):
        for ts in state:
            tp_shard_params(ts.model, mesh, model_axis, ts.opt)

    def grads(state, realA, realB):
        shard(state)
        with tensor_parallel():
            g, mstates, metrics = trainer.grads(state, trainer._tensor(realA),
                                                trainer._tensor(realB))
        if data_axis in mesh.shape:
            average_([v for r in g.values() for v in r.values()]
                     + [b for r in mstates.values() for b in r.values()]
                     + list(metrics.values()), mesh.group(data_axis))
        return g, mstates, metrics

    def step(state, realA, realB, lr):
        g, mstates, metrics = grads(state, realA, realB)
        return trainer.apply_grads(state, g, mstates, lr), metrics

    step.grads = lambda state, realA, realB: grads(state, realA, realB)[0]
    return step
