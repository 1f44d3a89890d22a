"""The GroupNorm kernel's wrapper (``srcgan_tpu_torch.ops.kernels.
group_norm_kernel``) on the CPU: its plain version against the JAX
package's ``group_norm`` with the same residual and ReLU in numpy, the
plain path that ``ops.norm.GroupNorm`` takes where the kernel's rule
(``eligible``) refuses a call, the checked entry's refusal, and the
colorizer's blocks with their ReLUs and residual adds moved into the norms,
bit-equal to the composition they had before.  The kernel itself, and the
rule's admission, run only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from srcgan_tpu import ops as jops
from srcgan_tpu_torch.models import resdeconv
from srcgan_tpu_torch.ops import norm
from srcgan_tpu_torch.ops.kernels import group_norm_kernel as gk


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_plain_version_matches_jax(c, residual, relu, dtype):
    """fp32 statistics, affine, residual and ReLU, one cast: fp32 within the
    order of float sums; bf16 one rounding of the same fp32 value, up to one
    bf16 ulp from it."""
    rng = np.random.default_rng(c + 2 * residual + relu)
    x = randn(rng, 2, 5, 3, c, scale=2.0) + 0.5
    r = randn(rng, 2, 5, 3, c)
    scale, bias = randn(rng, c) + 1.0, randn(rng, c)
    tx, tr = torch.from_numpy(x), torch.from_numpy(r)
    if dtype == "bfloat16":
        tx, tr = tx.bfloat16(), tr.bfloat16()
    # the JAX function on the values the port sees, in fp32
    want = np.array(jops.group_norm(jnp.asarray(tx.float().numpy()), jnp.asarray(scale),
                                    jnp.asarray(bias), 32))
    if residual:
        want = want + tr.float().numpy()
    if relu:
        want = np.maximum(want, 0.0)
    got = gk.group_norm_reference(tx, torch.from_numpy(scale), torch.from_numpy(bias), 32,
                                  residual=tr if residual else None, relu=relu)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(),
                                   torch.from_numpy(want).bfloat16().float().numpy(),
                                   atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("c,groups,ok", [(64, 32, True), (128, 32, True), (256, 32, True),
                                         (512, 32, True), (32, 32, True), (2048, 32, True),
                                         (96, 32, False), (48, 16, False), (24, 8, False),
                                         (4096, 32, False), (64, 3, False), (72, 4, False)])
def test_supported_widths(c, groups, ok):
    """Whole 16-byte vectors of channels, each inside one group or holding
    whole groups, at most 256 vectors a pixel."""
    assert gk.supported(c, groups) is ok


def _dispatch_case(kind):
    """(GroupNorm module, x, residual, context) of one dispatch case: all
    bf16 channels_last with no gradient asked for, but for ``kind``."""
    rng = np.random.default_rng(11)
    cl = dict(memory_format=torch.channels_last)
    x = torch.from_numpy(randn(rng, 2, 64, 4, 6)).to(torch.bfloat16, **cl)
    res = torch.from_numpy(randn(rng, 2, 64, 4, 6)).to(torch.bfloat16, **cl)
    gn = norm.GroupNorm(32, 64)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5)
        gn.bias.uniform_(-0.5, 0.5)
    gn = gn.bfloat16().requires_grad_(False)
    ctx = contextlib.nullcontext()
    if kind == "grad":
        gn.requires_grad_(True)
    elif kind == "fp32":
        x, res, gn = x.float(), res.float(), gn.float()
    elif kind == "residual_nchw":
        res = res.contiguous()
    elif kind == "mode":
        ctx = gk.PlainGroupNorm()
    elif kind == "subclass":
        x = x.as_subclass(_Sub)
    return gn, x, res, ctx


class _Sub(torch.Tensor):
    """A tensor subclass, as a trace's fake and functional tensors are."""


def test_dispatch_refuses_a_cpu_tensor():
    """The kernel runs on the card alone: a bf16 channels_last forward with
    bf16 parameters and no gradient asked for, on the CPU, is refused."""
    gn, x, res, _ = _dispatch_case("cpu")
    assert not gk.eligible(x, gn.weight, gn.bias, 32, res)
    assert not gk.eligible(x, gn.weight, gn.bias, 32, None)


@pytest.mark.parametrize("kind", ["cpu", "grad", "fp32", "residual_nchw", "mode", "subclass"])
def test_plain_path_cases(kind):
    """A CPU tensor, a gradient wanted, fp32, a residual that is not
    channels_last, an active torch-function mode and a tensor subclass each
    take the plain path and count a plain call; the answer is the
    composition the blocks had: the norm, + residual, ReLU in the
    activation dtype."""
    gn, x, res, ctx = _dispatch_case(kind)
    with ctx:
        if kind != "cpu":
            assert not gk.eligible(x, gn.weight, gn.bias, 32, res)
        launches, plain = gk.launches, gk.plain_calls
        got = gn(x, residual=res, relu=True)
        assert (gk.launches, gk.plain_calls) == (launches, plain + 1)
    want = F.relu(norm.GroupNorm.forward(gn, x) + res)
    assert got.dtype == x.dtype
    assert torch.equal(got.as_subclass(torch.Tensor), want.as_subclass(torch.Tensor))


@pytest.mark.parametrize("residual,relu", [(False, False), (False, True), (True, True)])
def test_checked_entry_raises_where_the_rule_refuses(residual, relu):
    """``group_norm`` raises on a call ``eligible`` refuses, here a CPU
    tensor, and launches nothing: nothing falls back to the plain path."""
    gn, x, res, _ = _dispatch_case("cpu")
    launches, plain = gk.launches, gk.plain_calls
    with pytest.raises(ValueError, match="does not take"):
        gk.group_norm(x, gn.weight, gn.bias, 32, gn.eps, res if residual else None, relu)
    assert (gk.launches, gk.plain_calls) == (launches, plain)


def test_plain_group_norm_mode_passes_calls_through():
    """Under ``PlainGroupNorm`` a module's answer is the one without it, on
    the plain path, and a torch-function mode is active."""
    gn, x, res, _ = _dispatch_case("fp32")
    want = gn(x, residual=res, relu=True)
    plain = gk.plain_calls
    with gk.PlainGroupNorm():
        assert torch._C._len_torch_function_stack() == 1
        got = gn(x, residual=res, relu=True)
    assert gk.plain_calls == plain + 1
    assert torch.equal(got, want)


# -- the blocks as they were composed before the epilogues moved into the norms --

def _old_block(b, x):
    out = F.relu(b.bn1(b.conv1(x)))
    out = b.bn2(b.conv2(out))
    identity = x if b.downsample is None else b.downsample(x)
    return F.relu(out + identity)


def _old_stage(stage, x):
    for b in stage:
        x = _old_block(b, x)
    return x


def _old_resdeconv(m, x):
    if m.src_ch == 1:
        x = torch.cat([x, x, x], 1)
    x = F.relu(m.bn1(m.conv1(x)))
    for stage in (m.layer1, m.layer2, m.layer3, m.layer4):
        x = _old_stage(stage, x)
    x = _old_stage(m.upRes1, m.deconv10(x))
    x = _old_stage(m.upRes2, m.deconv11(x))
    x = _old_stage(m.upRes3, m.deconv12(x))
    return m.pred(m.deconv13(x))


def _forward_backward(module, fn, x):
    x = x.clone().requires_grad_(True)
    y = fn(module, x)
    (y * torch.linspace(-1, 1, y.numel()).view_as(y)).sum().backward()
    grads = {k: p.grad for k, p in module.named_parameters()}
    return y, x.grad, grads, {k: b.clone() for k, b in module.named_buffers()}


def _bit_equal(module, old, x):
    a, b = copy.deepcopy(module), copy.deepcopy(module)
    got = _forward_backward(a, lambda m, v: m(v), x)
    want = _forward_backward(b, old, x)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for k in want[2]:
        assert torch.equal(got[2][k], want[2][k]), k
    for k in want[3]:
        assert torch.equal(got[3][k], want[3][k]), k


@pytest.mark.parametrize("downsample", [False, True])
@pytest.mark.parametrize("kind", ["GN", "BN", "IN"])
def test_basic_block_is_bit_equal_to_its_old_composition(kind, downsample):
    """fp32 on the CPU, train mode (BN's batch statistics and running
    statistics too): forward, input gradient and every parameter's."""
    torch.manual_seed(3)
    inplanes = 32 if downsample else 64
    block = resdeconv.BasicBlock(inplanes, 64, 2 if downsample else 1, downsample, kind)
    x = torch.randn(2, inplanes, 8, 8).contiguous(memory_format=torch.channels_last)
    _bit_equal(block.to(memory_format=torch.channels_last), _old_block, x)


@pytest.mark.parametrize("kind", ["GN", "BN", "IN"])
def test_resdeconv_is_bit_equal_to_its_old_composition(kind):
    torch.manual_seed(4)
    m = resdeconv.ResDeconv(1, 3, BN=kind, generator=torch.Generator().manual_seed(4))
    x = torch.rand(2, 1, 32, 32).contiguous(memory_format=torch.channels_last)
    _bit_equal(m, _old_resdeconv, x)


def test_ulps_apart_counts_bf16_ulps_of_the_plain_version():
    """The card's measure of agreement: 0 for the plain version itself, at
    most 1 for values one bf16 ulp off, above 1 for four ulps off."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(randn(rng, 2, 6, 4, 64, scale=2.0)).bfloat16()
    r = torch.from_numpy(randn(rng, 2, 6, 4, 64)).bfloat16()
    w, b = torch.from_numpy(randn(rng, 64)) + 1.0, torch.from_numpy(randn(rng, 64))
    want = gk.group_norm_reference(x, w, b, 32, 1e-5, r, False)
    up = lambda t, k: (t.view(torch.int16) + k).view(torch.bfloat16)  # noqa: E731
    assert gk.ulps_apart(want, x, w, b, 32, 1e-5, r) == 0
    assert gk.ulps_apart(up(want, 1), x, w, b, 32, 1e-5, r) <= 1
    assert gk.ulps_apart(up(want, 4), x, w, b, 32, 1e-5, r) > 1
