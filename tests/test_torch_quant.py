"""The port's int8 quantization (srcgan_tpu_torch.quant) against the JAX package's.

The same weights (through ``interop.state_dict_from_jax``) and numpy inputs go
through both.  What is held: a single quantized convolution (the integer sums
equal JAX's int32 convolution exactly, also where fp32 sums would not be; the
output within rtol 1e-5); the calibration tables of RDDBNet and ResDeconv
equal JAX's key for key (values rtol 1e-3: fp32 activations of two
frameworks); the int8 RDDBNet forward on JAX's scales within rel-L2 1e-2 of
JAX's int8 forward (its Pallas kernel in interpret mode); and the dispatch
contract: eval only, scoped, per thread, nested entry raises, no host work
after the first int8 forward.

The JAX package takes its fused RDB5 path only on a TPU or with
``quant.FORCE_PALLAS_RDB5`` (set and restored by a fixture), and its default
RDB5 schedule ("paired") runs other convolutions than the port's: where a
shape is not fused, JAX runs under ``rdb5_schedule("naive")``.
"""
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from srcgan_tpu import models as jax_models
from srcgan_tpu import quant as jax_quant
from srcgan_tpu.models import blocks as jax_blocks
from srcgan_tpu.ops import conv as jax_conv
from srcgan_tpu_torch import interop, models, quant
from srcgan_tpu_torch.models.blocks import ResidualDenseBlock5
from srcgan_tpu_torch.ops import conv as port_conv
from srcgan_tpu_torch.ops.kernels import rdb5_kernel


@pytest.fixture
def jax_fused():
    """The JAX package's fused RDB5 dispatch off the TPU (interpret mode)."""
    jax_quant.FORCE_PALLAS_RDB5 = True
    yield
    jax_quant.FORCE_PALLAS_RDB5 = False


def rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def port_of(jax_model, params, make):
    net = make().eval().requires_grad_(False)
    net.load_state_dict(interop.state_dict_from_jax(net, jax.device_get(params)), strict=True)
    return net


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# -- one convolution ----------------------------------------------------------

@pytest.mark.parametrize("cin", [32, 512])
def test_integer_sums_equal_jax_int32_conv(cin):
    """cin = 512: 9 * 512 * 127^2 = 7.4e7 > 2^24, beyond what fp32 sums hold exactly."""
    rng = np.random.default_rng(cin)
    x_q = rng.integers(-127, 128, (2, 8, 8, cin)).astype(np.int8)
    w_q = rng.integers(-127, 128, (3, 3, cin, 16)).astype(np.int8)
    x_q[0, :4] = 127
    w_q[..., 0] = 127                                    # the largest sums there are
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x_q), jnp.asarray(w_q), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    got = quant.int_conv2d(nchw(x_q).float(), torch.from_numpy(w_q).permute(3, 2, 0, 1).double(),
                           1, 1, 1)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))
    assert np.abs(np.asarray(want)).max() > (2 ** 24 if cin == 512 else 0)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0)])
def test_single_quantized_conv_matches_jax(stride, padding):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 32, 32)) * 0.1).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    jscales = jax_quant.calibrate_fn(lambda v: jax_conv.conv2d(v, jw, jb, stride, padding), [jx])
    with jax_quant.quant_mode("int8", jscales), jax.disable_jit():
        want = jax_conv.conv2d(jx, jw, jb, stride, padding)

    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    scales = quant.calibrate_fn(lambda v: port_conv.conv2d(v, tw, tb, stride, padding), [tx])
    assert list(scales) == list(jscales) == [0] and scales[0].dtype == np.float32
    np.testing.assert_allclose(scales[0], np.asarray(jscales[0]), rtol=1e-6)
    prepared = {}
    with quant.quant_mode("int8", interop.quant_scales_from_jax(jscales), prepared):
        got = port_conv.conv2d(tx, tw, tb, stride, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    ref = port_conv.conv2d(tx, tw, tb, stride, padding)
    assert rel_l2(got.numpy(), ref.numpy()) < 0.02       # ~1/127 per operand, averaged

    # the quantized weight is JAX's, value for value
    s_x = jnp.asarray(np.maximum(jscales[0], 1e-8) / 127.0)
    w_eff = jw * s_x.reshape(1, 1, -1, 1)
    s_w = jnp.max(jnp.abs(w_eff), axis=(0, 1, 2), keepdims=True) / 127.0
    w_q = jnp.clip(jnp.round(w_eff / s_w), -127, 127)
    slot = prepared[("conv", 0)]
    np.testing.assert_array_equal(slot["w_q"].permute(2, 3, 1, 0).numpy(), np.asarray(w_q))
    np.testing.assert_allclose(slot["s_w"].reshape(-1).numpy(), np.asarray(s_w).reshape(-1), rtol=1e-6)

    # an nn.Conv2d module passes the same dispatch
    conv = nn.Conv2d(32, 32, 3, stride, padding).requires_grad_(False)
    conv.weight.copy_(tw.permute(3, 2, 0, 1))
    conv.bias.copy_(tb)
    with quant.quant_mode("int8", scales):
        via_module = conv(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(via_module.numpy(), got.numpy(), rtol=1e-5, atol=1e-6)


def test_narrow_grouped_and_transposed_convs_stay_float():
    x = torch.randn(1, 32, 8, 8)
    narrow_in, narrow_out = nn.Conv2d(8, 32, 3, 1, 1), nn.Conv2d(32, 3, 3, 1, 1)
    grouped, deconv = nn.Conv2d(32, 32, 3, 1, 1, groups=2), nn.ConvTranspose2d(32, 32, 2, 2)
    scales = {}
    with quant.quant_mode("calibrate", scales), torch.no_grad():
        narrow_in(x[:, :8]), narrow_out(x), grouped(x), deconv(x)
    assert scales == {}
    with quant.quant_mode("int8", {}), torch.no_grad():   # nothing to look up, nothing raises
        out = narrow_out(x), grouped(x), deconv(x)
    with torch.no_grad():
        for got, mod in zip(out, (narrow_out, grouped, deconv)):
            assert torch.equal(got, mod(x))
    assert quant.MIN_QUANT_CH == jax_quant.MIN_QUANT_CH == 16


def test_missing_scale_raises():
    conv = nn.Conv2d(32, 32, 3, 1, 1)
    with pytest.raises(RuntimeError, match="no calibration scale"):
        with quant.quant_mode("int8", {}), torch.no_grad():
            conv(torch.randn(1, 32, 8, 8))
    with pytest.raises(RuntimeError, match="16 channels, the weight 32"):
        with quant.quant_mode("int8", {0: np.ones(16, np.float32)}), torch.no_grad():
            conv(torch.randn(1, 32, 8, 8))
    with pytest.raises(ValueError, match="unknown quant mode"):
        quant.quant_mode("fp8", {})


# -- calibration tables ------------------------------------------------------

def table_case(name):
    """(JAX model, params, port model, input NHWC, JAX context manager)."""
    rng = np.random.default_rng(7)
    if name == "rddbnet-fused":
        jm = jax_models.RDDBNet(1, 1, 2, nf=64, nb=1)
        make = lambda: models.RDDBNet(1, 1, 2, nf=64, nb=1)          # noqa: E731
        x = rng.uniform(0, 1, (1, 8, 128, 1)).astype(np.float32)
    elif name == "rddbnet-x4-not-fused":
        jm = jax_models.RDDBNet(1, 1, 4, nf=64, nb=1)
        make = lambda: models.RDDBNet(1, 1, 4, nf=64, nb=1)          # noqa: E731
        x = rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    else:
        jm = jax_models.ResDeconv(1, 3)
        make = lambda: models.ResDeconv(1, 3)                        # noqa: E731
        x = rng.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(7))
    return jm, params, port_of(jm, params, make), x


@pytest.mark.parametrize("name", ["rddbnet-fused", "rddbnet-x4-not-fused", "resdeconv"])
def test_calibration_tables_equal_jax(name, jax_fused):
    jm, params, net, x = table_case(name)
    with jax_blocks.rdb5_schedule("naive"):
        want = jax_quant.calibrate_fn(lambda b: jm.fwd(params, b), [jnp.asarray(x)])
    got = quant.calibrate_fn(net, [nchw(x)])
    assert sorted(got) == sorted(want) and len(got) > 0
    for i in sorted(want):
        assert got[i].shape == np.asarray(want[i]).shape, i
        np.testing.assert_allclose(got[i], np.asarray(want[i]), rtol=1e-3, atol=1e-6, err_msg=str(i))
    if name == "rddbnet-fused":
        # three fused blocks, trunk_conv, the x2 tail's folded deconv (64 -> 256)
        assert [v.shape for _, v in sorted(got.items())] == [(192,)] * 3 + [(64,)] * 2
    elif name == "rddbnet-x4-not-fused":
        # 3 x 5 block convs, trunk_conv, the first folded deconv, the folded conv_last (1024 -> 16)
        assert len(got) == 18 and got[17].shape == (1024,)
    else:
        # every conv with >= 16 channels on both sides, and no deconv
        n_quantizable = sum(1 for m in net.modules() if isinstance(m, nn.Conv2d)
                            and min(m.in_channels, m.out_channels) >= 16)
        assert len(got) == n_quantizable
    # a second batch folds in by maximum
    again = quant.calibrate_fn(net, [nchw(x), nchw(2 * x)])
    assert all((again[i] >= got[i]).all() for i in got)


def test_int8_rddbnet_forward_matches_jax(jax_fused):
    """On JAX's scales: three fused RDB5 callsites, trunk_conv and the folded
    tail's convolutions per conv; against JAX's int8 forward rel-L2 < 1e-2,
    and within quantization noise of fp32 (tests/test_quant_kernel.py: 0.1)."""
    jm, params, net, x = table_case("rddbnet-fused")
    jx = jnp.asarray(x)
    jscales = jax_quant.calibrate_fn(lambda b: jm.fwd(params, b), [jx])
    with jax_quant.quant_mode("int8", jscales):
        want = jm.fwd(params, jx)
    before = rdb5_kernel.reference_calls
    with quant.quant_mode("int8", interop.quant_scales_from_jax(jscales)), torch.no_grad():
        got = net(nchw(x)).permute(0, 2, 3, 1)
    assert rdb5_kernel.reference_calls == before + 3
    assert rel_l2(got.numpy(), want) < 1e-2
    with torch.no_grad():
        fp32 = net(nchw(x)).permute(0, 2, 3, 1)
    assert rel_l2(got.numpy(), fp32.numpy()) < 0.1


# -- the dispatch contract ---------------------------------------------------

def small_block(seed=2):
    torch.manual_seed(seed)
    blk = ResidualDenseBlock5(64, 32).eval().requires_grad_(False)
    x = torch.rand(1, 64, 8, 128) * 2 - 0.5
    return blk, x


def test_train_mode_and_no_context_never_dispatch():
    blk, x = small_block()
    assert quant.rdb5_dispatch(blk, x) is None            # outside any quant mode: inert
    table = {0: np.full((192,), 2.0, np.float32)}
    with quant.quant_mode("int8", table) as ctx:
        blk.train()
        assert quant.rdb5_dispatch(blk, x) is None        # forward-only: train bypasses it
        blk.eval()
        assert ctx.idx == 0
        assert quant.rdb5_dispatch(blk, x[:, :, :, :100]) is None   # not a supported shape
        assert quant.rdb5_dispatch(blk, x) is not None and ctx.idx == 1
    per_conv = {}
    with torch.no_grad():
        plain = blk(x)
        with quant.quant_mode("calibrate", per_conv):
            blk(x, lemda=0.5)                                      # another lemda: per conv
        assert torch.equal(blk(x), plain)                          # nothing stays patched
    assert [v.shape[0] for _, v in sorted(per_conv.items())] == [64, 96, 128, 160, 192]


def test_block_is_one_callsite_and_mixes_with_convs():
    """One record of 192 channels per block, between per-conv records, in call order."""
    blk, x = small_block(3)
    head, tail = (nn.Conv2d(64, 64, 3, 1, 1).requires_grad_(False) for _ in range(2))
    net = nn.Sequential(head, blk, tail).eval()
    scales = quant.calibrate_fn(net, [x])
    assert [v.shape for _, v in sorted(scales.items())] == [(64,), (192,), (64,)]
    assert not quant.is_calibrating()
    with torch.no_grad():
        ref = net(x)
        with quant.quant_mode("int8", scales):
            got = net(x)
    assert 0 < rel_l2(got.numpy(), ref.numpy()) < 0.06


def test_is_calibrating():
    seen = []
    quant.calibrate_fn(lambda b: seen.append(quant.is_calibrating()), [0, 1])
    with quant.quant_mode("int8", {}):
        seen.append(quant.is_calibrating())
    assert seen == [True, True, False]


def test_nested_entry_raises():
    with quant.quant_mode("int8", {}):
        with pytest.raises(RuntimeError, match="already active"):
            with quant.quant_mode("calibrate", {}):
                pass
        assert quant._active() is not None       # the failed entry left the outer block whole
    assert quant._active() is None
    with quant.quant_mode("calibrate", {}):
        pass


def test_threads_are_independent():
    """The state is per thread: two threads each hold a block at once, count
    their own callsites, and get the single-thread result."""
    conv = nn.Conv2d(32, 32, 3, 1, 1).requires_grad_(False)
    xs = [torch.randn(1, 32, 8, 8, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    tables = [quant.calibrate_fn(conv, [x]) for x in xs]
    with torch.no_grad():
        want = []
        for x, t in zip(xs, tables):
            with quant.quant_mode("int8", t):
                want.append(conv(x))
    barrier, got, errors = threading.Barrier(2, timeout=30), [None, None], []

    def work(k):
        try:
            with quant.quant_mode("int8", tables[k]) as ctx, torch.no_grad():
                barrier.wait()                   # both blocks are open now
                for _ in range(20):
                    ctx.idx = 0
                    got[k] = conv(xs[k])
                barrier.wait()
        except Exception as e:                   # pragma: no cover - shown below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errors, errors
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert quant._active() is None               # this thread never held one


def test_second_int8_forward_builds_nothing(monkeypatch):
    """With a kept ``prepared`` dict the first int8 forward builds every
    callsite's device operands and copies its scales; later ones look no scale
    up and reuse the same tensors."""
    net = models.RDDBNet(1, 1, 2, nf=64, nb=1).eval().requires_grad_(False)
    x = torch.rand(1, 1, 8, 128)
    scales = quant.calibrate_fn(net, [x])
    lookups = []
    real = quant.quant_mode.scale_of
    monkeypatch.setattr(quant.quant_mode, "scale_of",
                        lambda self, i, what: lookups.append(i) or real(self, i, what))
    prepared = {}
    with quant.quant_mode("int8", scales, prepared), torch.no_grad():
        first = net(x)
    assert sorted(lookups) == sorted(scales)
    kept = {k: {n: id(v) for n, v in slot.items()} for k, slot in prepared.items()}
    assert {k for k, _ in prepared} == {"conv", "rdb5"}
    lookups.clear()
    with quant.quant_mode("int8", scales, prepared), torch.no_grad():
        second = net(x)
    assert lookups == []
    assert torch.equal(first, second)
    for k, slot in prepared.items():
        stable = {n: id(v) for n, v in slot.items() if n in ("s_x", "weights")}
        assert stable == {n: kept[k][n] for n in stable}
    # without a kept dict every forward prepares anew
    with quant.quant_mode("int8", scales), torch.no_grad():
        net(x)
    assert sorted(lookups) == sorted(scales)
    # new weights at a callsite rebuild its operands
    with torch.no_grad():
        net.trunk_conv.weight.mul_(0.5)
    with quant.quant_mode("int8", scales, prepared), torch.no_grad():
        third = net(x)
    assert not torch.equal(third, first)
