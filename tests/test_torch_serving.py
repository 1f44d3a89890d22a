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

int8: on one calibration table (JAX's, carried over by
``interop.quant_scales_from_jax``) the two predictors do the same integer
arithmetic, but their fp32 layers between the convolutions (GroupNorm, the
dequantization) sum in other orders, and one flipped requantization round is
1/127 of a channel's range: mean|diff| <= 1 LSB (observed 0.49).  The JAX
package's default RDB5 schedule ("paired") runs other convolutions than the
port's, so the JAX side runs under ``rdb5_schedule("naive")``, where the two
count callsites alike.
"""
import numpy as np
import pytest
import torch

import jax

from srcgan_tpu import models as jax_models
from srcgan_tpu import serving as jax_serving
from srcgan_tpu.models import blocks as jax_blocks
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


def test_int8_matches_jax_on_shared_scales(small):
    port, jax_pred = small
    batches = [u8(20 + i, (2, 16, 16, 1)) for i in range(2)]
    jq, q = jax_pred(int8=True), port(int8=True, bf16=True)
    assert q.bf16 is False and q.dtype == torch.float32       # int8 forces fp32 between convs
    with pytest.raises(RuntimeError, match="calibrate"):
        q.predict(batches[0])
    with jax_blocks.rdb5_schedule("naive"):
        jq.calibrate(batches)
        want = jq.predict(batches[0])
    q.calibrate(batches)
    assert sorted(q.int8_scales) == sorted(jq.int8_scales)
    for i, v in q.int8_scales.items():
        np.testing.assert_allclose(v, np.asarray(jq.int8_scales[i]), rtol=1e-3, atol=1e-6)
    q.int8_scales = interop.quant_scales_from_jax(jq.int8_scales)
    got = q.predict(batches[0])
    assert got.shape == want.shape == (2, 64, 64, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= 1.0, (diff.mean(), diff.max())
    fp32 = port().predict(batches[0])
    assert 0 < np.abs(got.astype(int) - fp32.astype(int)).mean() <= 3.0


def test_int8_predicts_are_deterministic_and_padded(small):
    port, _ = small
    q = port(int8=True, pad_batch_to=4)
    x = u8(30, (3, 16, 16, 1))
    q.calibrate([x])
    first = q.predict(x)
    prepared = dict(q._int8_prepared)
    assert prepared and first.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(q.predict(x), first)
    assert all(q._int8_prepared[k] is v for k, v in prepared.items())   # built once
    for s in q.predict_stream(iter([x, x])):
        np.testing.assert_array_equal(s, first)
    q.calibrate([x, u8(31, (3, 16, 16, 1))])                  # a new table drops the operands
    assert q._int8_prepared == {}


def test_int8_refusals(small, full_ckpts):
    port, _ = small
    with pytest.raises(ValueError, match="only applies to int8"):
        port().calibrate([u8(0, (1, 16, 16, 1))])
    netGA, netGB, _ = full_ckpts
    q = CascadePredictor.from_checkpoints(netGA, netGB, device="cpu", int8=True)
    assert q.int8 and q.int8_scales == {}
    with pytest.raises(ValueError, match="cannot hot-reload"):
        q.reload_checkpoints(netGA, netGB)


@pytest.mark.parametrize("args", [("RDDBNet", "A2C", 4, 50, None, "npz"),
                                  ("ResDeconv", "C2B", 2, 7, "G2LAB", "pth")])
def test_checkpoint_names_match_jax(args):
    name = state.checkpoint_name(*args)
    assert name == jax_state.checkpoint_name(*args)
    assert state.parse_checkpoint_name(f"/x/{name}") == jax_state.parse_checkpoint_name(name)
    with pytest.raises(ValueError, match="unrecognized"):
        state.parse_checkpoint_name("RDDBNet_x4.npz")


# -- a BatchNorm colorizer in bf16: running statistics stay fp32, as JAX's model state --

def float_buffers(pred):
    return [b for m in (pred.sr_model, pred.c_model) for b in m.buffers() if b.is_floating_point()]


def test_bf16_batchnorm_colorizer_keeps_fp32_statistics(tmp_path):
    """ResDeconv(BN="BN") with running statistics that bf16 cannot hold
    (mean ~ N(0, 0.3), var ~ U(0.5, 2)): the JAX predictor casts parameters only
    and applies the statistics in fp32, and so does the port's, at construction
    and after a hot reload; uint8 mean|diff| <= 1 LSB, the bound of
    test_bf16_matches_jax."""
    rng = np.random.default_rng(60)
    sr, c = jax_models.RDDBNet(1, 1, 4, nf=16, nb=1), jax_models.ResDeconv(1, 3, BN="BN")
    pA = jax.jit(sr.init)(jax.random.PRNGKey(8))
    pB = jax.jit(c.init)(jax.random.PRNGKey(9))
    # with these statistics 0.01 brings the output std to ~0.2 (0.03 does for GroupNorm)
    pB = {**pB, "pred": {"w": pB["pred"]["w"] * 0.01}}
    c_state = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 2.0, a.shape) if "var" in jax.tree_util.keystr(path)
                         else rng.normal(0, 0.3, a.shape)).astype(np.float32), c.init_state())
    npA, npB = jax.device_get(pA), jax.device_get(pB)

    def modules():
        psr, pc = models.RDDBNet(1, 1, 4, nf=16, nb=1), models.ResDeconv(1, 3, BN="BN")
        psr.load_state_dict(interop.state_dict_from_jax(psr, npA), strict=True)
        pc.load_state_dict(interop.state_dict_from_jax(pc, npB, c_state), strict=True)
        return psr, pc

    psr, pc = modules()
    mean = pc.bn1.running_mean.clone()
    assert not torch.equal(mean.bfloat16().float(), mean)      # bf16 would lose these
    pthA, pthB = str(tmp_path / "RDDBNet_A2C_x4_0003.pth"), str(tmp_path / "ResDeconv_C2B_x4_0003.pth")
    torch.save(psr.state_dict(), pthA)
    torch.save(pc.state_dict(), pthB)

    pred = CascadePredictor(psr, pc, 4, bf16=True, device="cpu")
    assert pred.c_model.conv1.weight.dtype == torch.bfloat16
    assert len(float_buffers(pred)) > 0
    assert all(b.dtype == torch.float32 for b in float_buffers(pred))
    assert torch.equal(pred.c_model.bn1.running_mean, mean)
    x = u8(61, (2, 16, 16, 1))
    want = jax_serving.CascadePredictor(sr, pA, c, pB, up=4, bf16=True, c_state=c_state).predict(x)
    got = pred.predict(x)
    assert got.shape == want.shape == (2, 64, 64, 3) and len(np.unique(got)) > 8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= 1.0, (diff.mean(), diff.max())

    fresh = CascadePredictor(models.RDDBNet(1, 1, 4, nf=16, nb=1),
                             models.ResDeconv(1, 3, BN="BN"), 4, bf16=True, device="cpu")
    fresh.reload_checkpoints(pthA, pthB)()
    assert all(b.dtype == torch.float32 for b in float_buffers(fresh))
    assert torch.equal(fresh.c_model.bn1.running_mean, mean)
    np.testing.assert_array_equal(fresh.predict(x), got)


# -- G2LAB serving: the SR net's output is L, the colorizer's two channels ab ----

@pytest.fixture(scope="module")
def small_lab(tmp_path_factory):
    """The small x4 cascade with a 2-channel colorizer, as @G2LAB .npz files the
    JAX package wrote, the JAX predictor on them and a factory of port ones."""
    d = tmp_path_factory.mktemp("lab")
    sr, c = jax_models.RDDBNet(1, 1, 4, nf=16, nb=1), jax_models.ResDeconv(1, 2)
    pA = jax.jit(sr.init)(jax.random.PRNGKey(4))
    pB = jax.jit(c.init)(jax.random.PRNGKey(5))
    pB = {**pB, "pred": {"w": pB["pred"]["w"] * 0.03}}
    npA, npB = jax.device_get(pA), jax.device_get(pB)

    def port(**kw):
        psr, pc = models.RDDBNet(1, 1, 4, nf=16, nb=1), models.ResDeconv(1, 2)
        psr.load_state_dict(interop.state_dict_from_jax(psr, npA), strict=True)
        pc.load_state_dict(interop.state_dict_from_jax(pc, npB), strict=True)
        return CascadePredictor(psr, pc, 4, lab=True, device="cpu", **kw)

    def jax_pred(**kw):
        return jax_serving.CascadePredictor(sr, pA, c, pB, up=4, lab=True, **kw)

    return port, jax_pred


@pytest.mark.parametrize("channels", [1, 3])
def test_lab_fp32_matches_jax(small_lab, channels):
    """lab=True: lab_norm_to_rgb(L (+) ab) in fp32 after the cascade; uint8
    within 1 LSB of the JAX predictor, and not the RGB predictor's output."""
    port, jax_pred = small_lab
    x = u8(40 + channels, (2, 8, 8, channels))
    got, want = port().predict(x), jax_pred().predict(x)
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == np.uint8
    assert len(np.unique(got)) > 8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_lab_bf16_matches_jax(small_lab):
    """bf16 networks, the colour conversion in fp32: mean|diff| <= 1 LSB, the
    bound of test_bf16_matches_jax."""
    port, jax_pred = small_lab
    x = u8(44, (2, 8, 8, 1))
    got, want = port(bf16=True).predict(x), jax_pred(bf16=True).predict(x)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and diff.mean() <= 1.0, (diff.mean(), diff.max())


def test_lab_from_checkpoints_and_reload_refusals(full_ckpts, tmp_path):
    """@G2LAB names make a LAB predictor with a 2-channel colorizer from .npz
    files the JAX package wrote; a predictor refuses to reload a pair of the
    other colour space, either way."""
    sr, c = jax_models.RDDBNet(1, 1, 4), jax_models.ResDeconv(1, 2)
    pA = jax.jit(sr.init)(jax.random.PRNGKey(6))
    pB = jax.jit(c.init)(jax.random.PRNGKey(7))
    labA = str(tmp_path / jax_state.checkpoint_name("RDDBNet", "A2C", 4, 50, "G2LAB", "npz"))
    labB = str(tmp_path / jax_state.checkpoint_name("ResDeconv", "C2B", 4, 50, "G2LAB", "npz"))
    save_params(labA, pA)
    save_params(labB, pB)
    pred = CascadePredictor.from_checkpoints(labA, labB, device="cpu")
    want = jax_serving.CascadePredictor.from_checkpoints(labA, labB)
    assert pred.lab and want.lab and pred.c_model.pred.out_channels == 2
    x = u8(45, (1, 8, 8, 1))
    got = pred.predict(x)
    assert got.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.predict(x).astype(int)).max() <= 1
    rgbA, rgbB, _ = full_ckpts
    with pytest.raises(ValueError, match="G2RGB but this predictor serves G2LAB"):
        pred.reload_checkpoints(rgbA, rgbB)
    rgb = CascadePredictor.from_checkpoints(rgbA, rgbB, device="cpu")
    with pytest.raises(ValueError, match="G2LAB but this predictor serves G2RGB"):
        rgb.reload_checkpoints(labA, labB)
    pred.reload_checkpoints(labA, labB)()          # its own colour space reloads


def test_lab_int8_matches_jax_on_shared_scales(small_lab):
    """int8=True with lab=True: the quantized cascade, then the fp32 colour
    conversion, as the JAX predictor; on JAX's calibration table mean|diff| <=
    1 LSB (the bound of test_int8_matches_jax_on_shared_scales)."""
    port, jax_pred = small_lab
    batches = [u8(50 + i, (2, 16, 16, 1)) for i in range(2)]
    jq, q = jax_pred(int8=True), port(int8=True)
    with jax_blocks.rdb5_schedule("naive"):
        jq.calibrate(batches)
        want = jq.predict(batches[0])
    q.calibrate(batches)
    assert sorted(q.int8_scales) == sorted(jq.int8_scales)
    q.int8_scales = interop.quant_scales_from_jax(jq.int8_scales)
    got = q.predict(batches[0])
    assert got.shape == want.shape == (2, 64, 64, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= 1.0, (diff.mean(), diff.max())
