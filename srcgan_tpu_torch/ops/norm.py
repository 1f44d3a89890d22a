"""Normalization over NHWC tensors with fp32 statistics, as in ``srcgan_tpu.ops.norm``.

The functions take JAX's layout; the modules below are the NCHW
``nn.Module`` forms the models use (torch parameter names, so reference
state_dicts load), and call the functions on an NHWC view.  Whatever the
activation dtype, statistics and the affine map run in fp32 and the result is
cast back, as the JAX package does.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc


def group_norm(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """torch.nn.GroupNorm over x (N,H,W,C)."""
    y = F.group_norm(to_nchw(x).float(), num_groups, scale.float(), bias.float(), eps)
    return to_nhwc(y).to(x.dtype)


def instance_norm(x, scale=None, bias=None, eps: float = 1e-5):
    """InstanceNorm2d (torch defaults: no running stats) over x (N,H,W,C)."""
    y = F.instance_norm(to_nchw(x).float(),
                        weight=None if scale is None else scale.float(),
                        bias=None if bias is None else bias.float(), eps=eps)
    return to_nhwc(y).to(x.dtype)


def batch_norm(x, scale, bias, running_mean, running_var, *, train: bool,
               momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm2d over x (N,H,W,C).  Returns (y, new_mean, new_var).

    train=True normalizes with the batch statistics (biased variance) and
    returns the running statistics updated with the unbiased variance, as
    torch does; train=False uses and returns the running statistics."""
    xf = to_nchw(x).float()
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = xf.var(dim=(0, 2, 3), unbiased=False)
        count = xf.numel() // xf.shape[1]
        unbiased = var * count / max(count - 1, 1)
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    y = F.batch_norm(xf, mean.float(), var.float(), scale.float(), bias.float(),
                     training=False, eps=eps)
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
            self.running_mean.copy_(mean.detach())
            self.running_var.copy_(var.detach())
        return to_nchw(y)
