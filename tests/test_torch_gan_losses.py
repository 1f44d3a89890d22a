"""Every loss of srcgan_tpu_torch.losses against srcgan_tpu.losses on the same
numpy-seeded inputs, fp32, within 1e-6 (relative, and absolute for values
near zero).  On the CPU the JAX SSIM is its XLA form and the port's its
plain version; ``dssim`` with a gradient wanted goes through the port's
``ssim_reference``, which is also checked to carry the gradient."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srcgan_tpu import losses as jl
from srcgan_tpu_torch import losses as tl


def arr(seed, *shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def both(fn_name, *arrays, **kw):
    got = getattr(tl, fn_name)(*[torch.from_numpy(a) for a in arrays], **kw)
    want = getattr(jl, fn_name)(*[jnp.asarray(a) for a in arrays], **kw)
    return got, want


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["l1", "mse", "psnr", "cross", "dssim"])
def test_pair_losses(name):
    got, want = both(name, arr(1, 2, 16, 16, 3), arr(2, 2, 16, 16, 3))
    close(got, want)


def test_l1_3d_and_dssim_3d():
    a, b = arr(3, 2, 3, 12, 12, 3), arr(4, 2, 3, 12, 12, 3)
    for name in ("l1_3d", "dssim_3d"):
        close(*both(name, a, b))


@pytest.mark.parametrize("channels", [1, 4])
def test_ce(channels):
    out = arr(5, 2, 6, 6, channels, lo=0.01, hi=0.99)
    if channels == 1:
        tgt = (arr(6, 2, 6, 6, 1) > 0.5).astype(np.float32)
    else:
        tgt = np.eye(channels, dtype=np.float32)[
            np.random.default_rng(6).integers(0, channels, (2, 6, 6))]
    close(*both("ce", out, tgt))


@pytest.mark.parametrize("channels,size_average", [(1, True), (1, False), (3, True)])
def test_focal(channels, size_average):
    out = arr(7, 2, 5, 5, channels, lo=0.01, hi=0.99)
    tgt = (arr(8, 2, 5, 5, channels) > 0.5).astype(np.float32)
    got, want = both("focal", out, tgt, size_average=size_average)
    close(got, want)


def test_con_and_multi_task():
    close(*both("con", arr(9, 4, 8, 8, 2)))
    vec, sigma = arr(10, 3), arr(11, 3, lo=0.5, hi=2.0)
    close(tl.multi_task(torch.from_numpy(vec), torch.from_numpy(sigma)),
          jl.multi_task(jnp.asarray(vec), jnp.asarray(sigma)))
    close(tl.multi_task([torch.tensor(float(v)) for v in vec], torch.from_numpy(sigma)),
          jl.multi_task(list(map(float, vec)), jnp.asarray(sigma)))


@pytest.mark.parametrize("mode", list(jl.GAN_MODES))
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss(mode, real):
    assert tl.GAN_MODES == jl.GAN_MODES
    pred = arr(12, 2, 16, 16, 1, lo=-2.0, hi=2.0)
    if mode == "DSSIM":
        pred = arr(12, 2, 16, 16, 1)
    close(tl.gan_loss(torch.from_numpy(pred), real, mode),
          jl.gan_loss(jnp.asarray(pred), real, mode))


def test_gan_loss_unknown_mode_raises():
    with pytest.raises(ValueError, match="not implemented"):
        tl.gan_loss(torch.zeros(1, 4, 4, 1), True, "hinge")


@pytest.mark.parametrize("shift,stride", [(2, 1), (1, 2)])
def test_nearest_select(shift, stride):
    rng = np.random.default_rng(13)
    target = rng.uniform(0, 1, (3, 20, 20, 2)).astype(np.float32)
    # each sample's output is its target moved by a different offset, plus noise
    out = np.empty_like(target)
    for i, (dy, dx) in enumerate([(0, 0), (1, -1), (-1, 2)]):
        out[i] = np.roll(target[i], (dy * stride, dx * stride), axis=(0, 1))
    out += rng.normal(0, 0.01, out.shape).astype(np.float32)
    got = tl.nearest_select(torch.from_numpy(out), torch.from_numpy(target), shift, stride)
    want = jl.nearest_select(jnp.asarray(out), jnp.asarray(target), shift, stride)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dssim_takes_the_plain_version_for_gradients():
    a = torch.from_numpy(arr(14, 1, 16, 16, 3)).requires_grad_(True)
    b = torch.from_numpy(arr(15, 1, 16, 16, 3))
    loss = tl.dssim(a, b)
    loss.backward()
    assert a.grad is not None and float(a.grad.abs().sum()) > 0
    close(loss.detach(), jl.dssim(jnp.asarray(a.detach().numpy()), jnp.asarray(b.numpy())))


def test_reference_name_aliases():
    assert (tl.L1Loss, tl.MSELoss, tl.PSNRLoss, tl.DSSIMLoss, tl.CELoss, tl.FLoss,
            tl.ConLoss, tl.CrossLoss) == (tl.l1, tl.mse, tl.psnr, tl.dssim, tl.ce, tl.focal,
                                          tl.con, tl.cross)
