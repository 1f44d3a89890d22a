"""Port ops (srcgan_tpu_torch.ops) against the JAX ops on the same inputs.

Both sides run in fp32, JAX at matmul precision "highest", so only the order
of float sums differs: atol = rtol = 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srcgan_tpu import config as jax_config
from srcgan_tpu import ops as jops
from srcgan_tpu.ops import fused as jfused
from srcgan_tpu_torch.ops import color, conv, fused, norm

TOL = dict(atol=1e-5, rtol=1e-5)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.fixture(autouse=True)
def _highest():
    with jax_config.matmul_precision("highest"):
        yield


@pytest.mark.parametrize("stride,padding,groups", [(1, 1, 1), (2, 1, 1), (1, 0, 2)])
def test_conv2d(stride, padding, groups):
    rng = np.random.default_rng(0)
    x = randn(rng, 2, 9, 9, 8)
    w = randn(rng, 3, 3, 8 // groups, 6, scale=0.2)
    b = randn(rng, 6)
    want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride,
                       padding, groups=groups)
    got = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                      stride, padding, groups=groups)
    close(got, want)


@pytest.mark.parametrize("k,s,opad", [(2, 2, 0), (2, 4, 2)])
def test_conv_transpose2d(k, s, opad):
    """The k2s2 deconv of the RDDBNet tail and ResDeconv, and the x4 spec."""
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 5, 6, 8)
    w = randn(rng, k, k, 8, 4, scale=0.3)
    want = jops.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), None, s, 0, opad)
    got = conv.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w), None, s, 0,
                                opad)
    assert tuple(got.shape) == want.shape
    close(got, want)


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle(r):
    x = randn(np.random.default_rng(2), 2, 3, 5, 3 * r * r)
    want = jops.pixel_shuffle(jnp.asarray(x), r)
    close(conv.pixel_shuffle(torch.from_numpy(x), r), want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm(dtype):
    """fp32 statistics either way; a bf16 input is rounded once at the end."""
    rng = np.random.default_rng(3)
    x = randn(rng, 2, 6, 5, 64, scale=3.0) + 1.0
    scale, bias = randn(rng, 64) + 1.0, randn(rng, 64)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    want = jops.group_norm(jx, jnp.asarray(scale), jnp.asarray(bias), 32)
    got = norm.group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), 32)
    assert got.dtype == tx.dtype
    # bf16: one rounding of the same fp32 value, up to one bf16 ulp apart
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    close(got.float(), np.asarray(want, np.float32), **tol)


def test_instance_norm():
    rng = np.random.default_rng(4)
    x = randn(rng, 2, 6, 5, 16)
    scale, bias = randn(rng, 16), randn(rng, 16)
    close(norm.instance_norm(torch.from_numpy(x)), jops.instance_norm(jnp.asarray(x)))
    close(norm.instance_norm(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(bias)),
          jops.instance_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm(train):
    rng = np.random.default_rng(5)
    x = randn(rng, 3, 4, 5, 8)
    scale, bias = randn(rng, 8), randn(rng, 8)
    mean, var = randn(rng, 8), np.abs(randn(rng, 8)) + 0.5
    want = jops.batch_norm(*(jnp.asarray(a) for a in (x, scale, bias, mean, var)),
                           train=train)
    got = norm.batch_norm(*(torch.from_numpy(a) for a in (x, scale, bias, mean, var)),
                          train=train)
    for g, w in zip(got, want):
        close(g, w)


def _vjp_pair(jax_fn, torch_fn, arrays, seed):
    """Gradients of sum(f(*arrays) * c), c random, in both frameworks."""
    import jax

    out = np.asarray(jax_fn(*(jnp.asarray(a) for a in arrays)))
    c = randn(np.random.default_rng(seed), *out.shape)
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * c), argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = torch.autograd.grad((torch_fn(*ts) * torch.from_numpy(c)).sum(), ts)
    return got, want


def test_batch_norm_train_gradients():
    """Train-mode BatchNorm under autograd (the trainer's path): gradients
    of x, scale and bias equal JAX's; the running statistics carry none."""
    rng = np.random.default_rng(15)
    x = randn(rng, 3, 4, 5, 8)
    scale, bias = randn(rng, 8), randn(rng, 8)
    mean, var = randn(rng, 8), np.abs(randn(rng, 8)) + 0.5
    rm, rv = torch.from_numpy(mean), torch.from_numpy(var)
    got, want = _vjp_pair(
        lambda a, s, b: jops.batch_norm(a, s, b, jnp.asarray(mean), jnp.asarray(var),
                                        train=True)[0],
        lambda a, s, b: norm.batch_norm(a, s, b, rm, rv, train=True)[0],
        (x, scale, bias), 16)
    for g, w in zip(got, want):
        close(g, w, atol=1e-4, rtol=1e-4)
    _, new_mean, new_var = norm.batch_norm(torch.from_numpy(x).requires_grad_(),
                                           torch.from_numpy(scale), torch.from_numpy(bias),
                                           rm, rv, train=True)
    assert not new_mean.requires_grad and not new_var.requires_grad


@pytest.mark.parametrize("n_up", [1, 2])
def test_phasefold_deconv_tail_gradients(n_up):
    """The training tail's gradients (input, deconv weights, conv_last) equal JAX's."""
    rng = np.random.default_rng(20 + n_up)
    nf = 8
    arrays = [randn(rng, 2, 5, 4, nf)] + [randn(rng, 2, 2, nf, nf, scale=0.3)
                                          for _ in range(n_up)]
    arrays += [randn(rng, 3, 3, nf, 2, scale=0.3), randn(rng, 2)]
    got, want = _vjp_pair(
        lambda x, *w: jfused.phasefold_deconv_tail(x, list(w[:-2]), w[-2], w[-1]),
        lambda x, *w: fused.phasefold_deconv_tail(x, list(w[:-2]), w[-2], w[-1]),
        arrays, 30 + n_up)
    for g, w in zip(got, want):
        close(g, w, atol=1e-4, rtol=1e-4)


def test_rgb_to_gray():
    x = np.random.default_rng(6).uniform(0, 1, (2, 4, 5, 3)).astype(np.float32)
    close(color.rgb_to_gray(torch.from_numpy(x)), jops.rgb_to_gray(jnp.asarray(x)))


@pytest.mark.parametrize("n_up", [1, 2])
def test_fold_last_weight(n_up):
    """The scatter into the phase grid is a copy: exact."""
    nf, ou, r = 8, 3, 2 ** n_up
    lw = randn(np.random.default_rng(7), 3, 3, nf, ou)
    want = jfused.fold_last_weight(jfused.tail_phases(n_up), jnp.asarray(lw), r, nf,
                                   jnp.float32)
    got = fused.fold_last_weight(fused.tail_phases(n_up), torch.from_numpy(lw), r, nf,
                                 torch.float32)
    assert fused.tail_phases(n_up) == jfused.tail_phases(n_up)
    close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("n_up,ou,fold_last", [(1, 1, True), (2, 1, True),
                                               (2, 3, True), (3, 1, False)])
def test_phasefold_deconv_tail(n_up, ou, fold_last):
    """r = 2, 4, 8: the folded tail, with conv_last folded (r <= 4) or at full
    resolution (r = 8, as the models run it)."""
    rng = np.random.default_rng(8 + n_up)
    nf = 16
    x = randn(rng, 2, 6, 6, nf)
    dws = [randn(rng, 2, 2, nf, nf, scale=0.2) for _ in range(n_up)]
    lw = randn(rng, 3, 3, nf, ou, scale=0.2)
    lb = randn(rng, ou)
    want = jfused.phasefold_deconv_tail(
        jnp.asarray(x), [jnp.asarray(w) for w in dws], jnp.asarray(lw),
        jnp.asarray(lb), fold_last=fold_last)
    got = fused.phasefold_deconv_tail(
        torch.from_numpy(x), [torch.from_numpy(w) for w in dws], torch.from_numpy(lw),
        torch.from_numpy(lb), fold_last=fold_last)
    assert tuple(got.shape) == want.shape == (2, 6 * 2 ** n_up, 6 * 2 ** n_up, ou)
    close(got, want)
