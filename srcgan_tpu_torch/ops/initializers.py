"""Fresh weights with the JAX package's distributions (``srcgan_tpu.ops.initializers``).

Used only for freshly made models; trained weights come in through
``srcgan_tpu_torch.interop``.  The numbers differ from JAX's for the same
seed (different generators); the distributions are the same: kaiming normal
(fan_out, relu) for conv and deconv weights, torch's default uniform for
biases, torch's default uniform for the weights of the models the JAX
package builds with ``weight_init="torch"`` (SRCNN, the PatchGAN, the
legacy Encoder and Decoder), and kaiming normal (fan_in) with zero biases
for SRDenseNet.  Fans are counted as the JAX package counts them on its HWIO weights,
which for a transposed conv is kh*kw*out_channels.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def kaiming_normal_(w: torch.Tensor, fan: int, generator: torch.Generator):
    """Fill w with N(0, 2/fan) (kaiming normal, relu gain)."""
    std = math.sqrt(2.0) / math.sqrt(fan)
    w.copy_(torch.randn(w.shape, generator=generator) * std)


def torch_bias_default_(b: torch.Tensor, fan_in: int, generator: torch.Generator):
    """Fill b with U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    b.copy_((torch.rand(b.shape, generator=generator) * 2 - 1) * bound)


@torch.no_grad()
def init_kaiming_(module: nn.Module, generator: torch.Generator | None = None):
    """Initialize every conv / transposed conv under ``module`` in place, from
    ``generator`` (seed 0 when omitted), in registration order."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            cin, cout, kh, kw = m.weight.shape          # (in, out, kh, kw)
            fan_out = fan_in = cout * kh * kw
        elif isinstance(m, nn.Conv2d):
            cout, cin_g, kh, kw = m.weight.shape        # (out, in/groups, kh, kw)
            fan_out, fan_in = cout * kh * kw, cin_g * kh * kw
        else:
            continue
        kaiming_normal_(m.weight, fan_out, generator)
        if m.bias is not None:
            torch_bias_default_(m.bias, fan_in, generator)


@torch.no_grad()
def init_torch_default_(module: nn.Module, generator: torch.Generator | None = None):
    """Torch's default conv init (kaiming_uniform(a=sqrt(5)), i.e.
    U(+-1/sqrt(fan_in)) for weight and bias) of every conv and transposed
    conv under ``module``, from ``generator`` (seed 0 when omitted), in
    registration order.  A transposed conv's fan_in is out_channels*kh*kw,
    as torch counts it on its (in, out, kh, kw) weight."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            _, cout, kh, kw = m.weight.shape
            fan_in = cout * kh * kw
        elif isinstance(m, nn.Conv2d):
            _, cin_g, kh, kw = m.weight.shape
            fan_in = cin_g * kh * kw
        else:
            continue
        torch_bias_default_(m.weight, fan_in, generator)
        if m.bias is not None:
            torch_bias_default_(m.bias, fan_in, generator)


@torch.no_grad()
def init_kaiming_fan_in_(module: nn.Module, generator: torch.Generator | None = None):
    """Kaiming normal (fan_in, relu) weights and zero biases for every conv
    and transposed conv under ``module`` (SRDenseNet's init).  Fans as the
    JAX package counts them: kh*kw*in_channels for both kinds."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            cin, _, kh, kw = m.weight.shape             # (in, out, kh, kw)
        elif isinstance(m, nn.Conv2d):
            _, cin, kh, kw = m.weight.shape             # (out, in/groups, kh, kw)
        else:
            continue
        kaiming_normal_(m.weight, cin * kh * kw, generator)
        if m.bias is not None:
            m.bias.zero_()
