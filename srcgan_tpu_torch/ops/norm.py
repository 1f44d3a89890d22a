"""Normalization over NHWC tensors with fp32 statistics, as in ``srcgan_tpu.ops.norm``.

The functions take JAX's layout; the modules below are the NCHW
``nn.Module`` forms the models use (torch parameter names, so reference
state_dicts load), and call the functions on an NHWC view.  Whatever the
activation dtype, statistics and the affine map run in fp32 (instance norm:
in float64 for a float64 input) and the result is cast back, as the JAX
package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc


def group_norm(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """torch.nn.GroupNorm over x (N,H,W,C)."""
    y = F.group_norm(to_nchw(x).float(), num_groups, scale.float(), bias.float(), eps)
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


def batch_norm(x, scale, bias, running_mean, running_var, *, train: bool,
               momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm2d over x (N,H,W,C).  Returns (y, new_mean, new_var).

    train=True normalizes with the batch statistics (biased variance), as
    (x - mean) / sqrt(var + eps) * scale + bias so that gradients flow
    through the statistics, and returns the running statistics (detached)
    updated with the unbiased variance, as torch does; train=False uses and
    returns the running statistics."""
    xf = to_nchw(x).float()
    if not train:
        y = F.batch_norm(xf, running_mean.float(), running_var.float(), scale.float(),
                         bias.float(), training=False, eps=eps)
        return to_nhwc(y).to(x.dtype), running_mean, running_var
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.var(dim=(0, 2, 3), unbiased=False)
    count = xf.numel() // xf.shape[1]
    with torch.no_grad():
        unbiased = var * count / max(count - 1, 1)
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = (1 - momentum) * running_var + momentum * unbiased
    c = (1, -1, 1, 1)
    y = ((xf - mean.view(c)) / torch.sqrt(var.view(c) + eps) * scale.float().view(c)
         + bias.float().view(c))
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
