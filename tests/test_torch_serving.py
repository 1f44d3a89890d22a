"""The port's CascadePredictor against the JAX CascadePredictor on the same weights.

Tolerances: fp32 uint8 max|diff| <= 1 (a flip at a rounding boundary, as
tests/test_serving.py allows); bf16 mean|diff| <= 1 LSB (bf16 activations
round at other places in the two frameworks; observed on the CPU: mean 0.53,
max 6).

A freshly initialized colorizer has an output std of ~6.6 on these inputs, so
94% of the uint8 pixels saturate and the rest sit on a slope where one bf16
rounding moves them by tens of LSB.  The small cascade's colorizer therefore
has its last conv (``pred``, bias-free) scaled by 0.03, which brings the
output std to ~0.2, the spread of a natural image in [0, 1]; both sides get
the same scaled weights.
"""
import numpy as np
import pytest
import torch

import jax

from srcgan_tpu import models as jax_models
from srcgan_tpu import serving as jax_serving
from srcgan_tpu.train import state as jax_state
from srcgan_tpu.train.state import save_params
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.serving import CascadePredictor
from srcgan_tpu_torch.train import state


def u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def small():
    """x4 cascade at small width: JAX (model, params) pairs and a factory of
    port predictors with the same weights."""
    sr, c = jax_models.RDDBNet(1, 1, 4, nf=16, nb=1), jax_models.ResDeconv(1, 3)
    pA = jax.jit(sr.init)(jax.random.PRNGKey(0))
    pB = jax.jit(c.init)(jax.random.PRNGKey(1))
    pB = {**pB, "pred": {"w": pB["pred"]["w"] * 0.03}}
    npA, npB = jax.device_get(pA), jax.device_get(pB)

    def port(**kw):
        psr, pc = models.RDDBNet(1, 1, 4, nf=16, nb=1), models.ResDeconv(1, 3)
        psr.load_state_dict(interop.state_dict_from_jax(psr, npA), strict=True)
        pc.load_state_dict(interop.state_dict_from_jax(pc, npB), strict=True)
        return CascadePredictor(psr, pc, 4, device="cpu", **kw)

    def jax_pred(**kw):
        return jax_serving.CascadePredictor(sr, pA, c, pB, up=4, **kw)

    return port, jax_pred


@pytest.fixture(scope="module")
def full_ckpts(tmp_path_factory):
    """Full-width checkpoints written by the JAX package under reference names."""
    d = tmp_path_factory.mktemp("ckpt")
    sr, c = jax_models.RDDBNet(1, 1, 4), jax_models.ResDeconv(1, 3)
    pA = jax.jit(sr.init)(jax.random.PRNGKey(2))
    pB = jax.jit(c.init)(jax.random.PRNGKey(3))
    netGA, netGB = str(d / "RDDBNet_A2C_x4_0050.npz"), str(d / "ResDeconv_C2B_x4_0050.npz")
    save_params(netGA, pA)
    save_params(netGB, pB)
    return netGA, netGB, jax_serving.CascadePredictor(sr, pA, c, pB, up=4)


@pytest.mark.parametrize("channels", [1, 3])
def test_fp32_matches_jax(small, channels):
    port, jax_pred = small
    x = u8(channels, (2, 8, 8, channels))
    got, want = port().predict(x), jax_pred().predict(x)
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_bf16_matches_jax(small):
    port, jax_pred = small
    x = u8(4, (2, 8, 8, 1))
    got, want = port(bf16=True).predict(x), jax_pred(bf16=True).predict(x)
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= 1.0, (diff.mean(), diff.max())


def test_pad_batch_to(small):
    """A ragged batch is padded with its last row and the padding stripped."""
    port, jax_pred = small
    x = u8(5, (3, 8, 8, 1))
    got = port(pad_batch_to=4).predict(x)
    want = jax_pred(pad_batch_to=4).predict(x)
    assert got.shape == want.shape == (3, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_predict_stream_matches_predict(small):
    port, _ = small
    pred = port()
    batches = [u8(10 + i, (2, 8, 8, 1)) for i in range(3)]
    streamed = list(pred.predict_stream(iter(batches), lookahead=2))
    assert len(streamed) == 3
    for b, s in zip(batches, streamed):
        np.testing.assert_array_equal(s, pred.predict(b))


def test_from_checkpoints_npz_matches_jax(full_ckpts):
    """Full-width RDDBNet(1,1,4) + ResDeconv(1,3) from .npz written by the
    JAX package's save_params; architecture parsed from the names."""
    netGA, netGB, jax_pred = full_ckpts
    pred = CascadePredictor.from_checkpoints(netGA, netGB, device="cpu")
    assert pred.up == 4 and pred.sr_model.conv_first.out_channels == 64
    x = u8(6, (1, 8, 8, 1))
    got, want = pred.predict(x), jax_pred.predict(x)
    assert got.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_from_checkpoints_pth_and_reload(full_ckpts, tmp_path):
    """Reference-named .pth state_dicts load too; reload_checkpoints swaps in
    new weights only when its installer runs."""
    netGA, netGB, _ = full_ckpts
    ref = CascadePredictor.from_checkpoints(netGA, netGB, device="cpu")
    pthA = str(tmp_path / "RDDBNet_A2C_x4_0007.pth")
    pthB = str(tmp_path / "ResDeconv_C2B_x4_0007.pth")
    torch.save(ref.sr_model.state_dict(), pthA)
    torch.save(ref.c_model.state_dict(), pthB)
    x = u8(7, (1, 8, 8, 1))
    from_pth = CascadePredictor.from_checkpoints(pthA, pthB, device="cpu")
    np.testing.assert_array_equal(from_pth.predict(x), ref.predict(x))

    fresh = CascadePredictor(models.RDDBNet(1, 1, 4), models.ResDeconv(1, 3), 4,
                             device="cpu")
    before = fresh.predict(x)
    install = fresh.reload_checkpoints(netGA, netGB)
    np.testing.assert_array_equal(fresh.predict(x), before)
    install()
    np.testing.assert_array_equal(fresh.predict(x), ref.predict(x))
    with pytest.raises(ValueError, match="A2C, C2B"):
        fresh.reload_checkpoints(netGB, netGA)


@pytest.mark.parametrize("flag,item", [("int8", "A13"), ("self_ensemble", "A12"),
                                       ("lab", "A2")])
def test_unported_modes_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        CascadePredictor(models.RDDBNet(1, 1, 4, nf=16, nb=1), models.ResDeconv(1, 3),
                         4, device="cpu", **{flag: True})


@pytest.mark.parametrize("args", [("RDDBNet", "A2C", 4, 50, None, "npz"),
                                  ("ResDeconv", "C2B", 2, 7, "G2LAB", "pth")])
def test_checkpoint_names_match_jax(args):
    name = state.checkpoint_name(*args)
    assert name == jax_state.checkpoint_name(*args)
    assert state.parse_checkpoint_name(f"/x/{name}") == jax_state.parse_checkpoint_name(name)
    with pytest.raises(ValueError, match="unrecognized"):
        state.parse_checkpoint_name("RDDBNet_x4.npz")
