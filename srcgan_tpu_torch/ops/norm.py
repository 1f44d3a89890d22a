"""Normalization over NHWC tensors with fp32 statistics, as in ``srcgan_tpu.ops.norm``.

The functions take JAX's layout; the modules below are the NCHW
``nn.Module`` forms the models use (torch parameter names, so reference
state_dicts load), and call the functions on an NHWC view.  Whatever the
activation dtype, statistics and the affine map run in fp32 (instance norm:
in float64 for a float64 input) and the result is cast back, as the JAX
package does.

Inside ``sync_batch_norm(group)`` a train-mode batch norm takes its
statistics over the batch of every rank of ``group`` (the data-parallel GAN
steps pass the mesh's data line: the JAX package's GSPMD step normalizes
over the global batch).  The ranks' means go through
``torch.distributed.nn.functional.all_reduce``, which carries the gradient
across ranks; unlike ``nn.SyncBatchNorm`` it runs on any backend, gloo on
the CPU included.  Inside ``moments_by(fn)`` (``parallel.spatial``'s strips,
whose heights differ) ``fn`` gives the moments instead, from sums and
element counts.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc


def group_norm(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """torch.nn.GroupNorm over x (N,H,W,C), in fp32 (float64 stays)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    y = F.group_norm(to_nchw(x).to(dt), num_groups, scale.to(dt), bias.to(dt), eps)
    return to_nhwc(y).to(x.dtype)


def instance_norm(x, scale=None, bias=None, eps: float = 1e-5):
    """InstanceNorm2d (torch defaults: no running stats) over x (N,H,W,C), as
    a GroupNorm with one group per channel: the same statistics.  Unlike
    ``F.instance_norm`` it takes a 1x1 map (zeros, then the affine, as the
    JAX function gives), and on the card its backward is right for a
    channels_last gradient, where ``F.instance_norm``'s was not (a
    resnet_9blocks generator's input gradient came out uncorrelated with
    the CPU's)."""
    dt = torch.promote_types(x.dtype, torch.float32)     # float64 stays
    y = F.group_norm(to_nchw(x).to(dt), x.shape[-1],
                     None if scale is None else scale.to(dt),
                     None if bias is None else bias.to(dt), eps)
    return to_nhwc(y).to(x.dtype)


# The group of an open sync_batch_norm scope (False where none): process-wide,
# not per thread, because on the card the autograd engine recomputes a
# checkpointed pass in a thread of its own, and that recompute must normalize
# as the forward did.
_SYNCED = False
# the moments function of an open moments_by scope
_MOMENTS = None


@contextlib.contextmanager
def sync_batch_norm(group=None):
    """Scope: train-mode ``batch_norm`` takes global batch statistics over
    ``group`` (the default process group where None)."""
    import torch.distributed as dist

    global _SYNCED
    prev, _SYNCED = _SYNCED, dist.group.WORLD if group is None else group
    try:
        yield
    finally:
        _SYNCED = prev


@contextlib.contextmanager
def moments_by(fn):
    """Scope: train-mode ``batch_norm`` takes (mean, biased variance,
    count) from ``fn(xf)`` over NCHW xf."""
    global _MOMENTS
    prev, _MOMENTS = _MOMENTS, fn
    try:
        yield
    finally:
        _MOMENTS = prev


def _moments(xf, synced=False):
    """(mean, biased variance, element count) per channel of NCHW xf, as
    mean((x - mean)^2); ``synced``, a process group: over every rank's batch
    (the ranks' batches are of one size, so the global moments are the means
    of the ranks' own), differentiable through the all-reduces.  On one rank
    the two forms are the same arithmetic."""
    if _MOMENTS is not None:
        return _MOMENTS(xf)
    if synced is False:
        mean = xf.mean(dim=(0, 2, 3))
        d = xf - mean.view(1, -1, 1, 1)
        return mean, (d * d).mean(dim=(0, 2, 3)), xf.numel() // xf.shape[1]
    import warnings

    import torch.distributed as dist
    from torch.distributed.nn import functional as dist_fn

    def avg(t):
        with warnings.catch_warnings():     # torch 2.13 marks the module as deprecated
            warnings.simplefilter("ignore", FutureWarning)
            return dist_fn.all_reduce(t, op=dist.ReduceOp.AVG, group=synced)

    mean = avg(xf.mean(dim=(0, 2, 3)))
    d = xf - mean.view(1, -1, 1, 1)
    var = avg((d * d).mean(dim=(0, 2, 3)))
    return mean, var, xf.numel() // xf.shape[1] * dist.get_world_size(synced)


def batch_norm(x, scale, bias, running_mean, running_var, *, train: bool,
               momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm2d over x (N,H,W,C).  Returns (y, new_mean, new_var).

    train=True normalizes with the batch statistics (biased variance), as
    (x - mean) / sqrt(var + eps) * scale + bias so that gradients flow
    through the statistics, and returns the running statistics (detached)
    updated with the unbiased variance, as torch does; train=False uses and
    returns the running statistics."""
    xf = to_nchw(x).to(torch.promote_types(x.dtype, torch.float32))     # float64 stays
    if not train:
        y = F.batch_norm(xf, running_mean.to(xf.dtype), running_var.to(xf.dtype),
                         scale.to(xf.dtype), bias.to(xf.dtype), training=False, eps=eps)
        return to_nhwc(y).to(x.dtype), running_mean, running_var
    mean, var, count = _moments(xf, _SYNCED)
    with torch.no_grad():
        unbiased = var * count / max(count - 1, 1)
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    c = (1, -1, 1, 1)
    y = ((xf - mean.view(c)) / torch.sqrt(var.view(c) + eps) * scale.to(xf.dtype).view(c)
         + bias.to(xf.dtype).view(c))
    return to_nhwc(y).to(x.dtype), new_mean, new_var


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return to_nchw(group_norm(to_nhwc(x), self.weight, self.bias,
                                  self.num_groups, self.eps))


class InstanceNorm2d(nn.InstanceNorm2d):
    """torch defaults: affine=False, track_running_stats=False."""

    def forward(self, x):
        return to_nchw(instance_norm(to_nhwc(x), self.weight, self.bias, self.eps))


class BatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        y, mean, var = batch_norm(to_nhwc(x), self.weight, self.bias,
                                  self.running_mean, self.running_var,
                                  train=self.training, momentum=self.momentum,
                                  eps=self.eps)
        if self.training:
            self.running_mean.copy_(mean)
            self.running_var.copy_(var)
        return to_nchw(y)
