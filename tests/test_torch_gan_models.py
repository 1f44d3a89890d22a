"""The adversarial family's models and the satellite EDSR / SRDN against the
JAX models: export -> load parity.

Each case exports the JAX model's parameter tree with
``srcgan_tpu.interop.export_torch_state_dict``, checks that it equals
``srcgan_tpu_torch.interop.state_dict_from_jax`` key for key (in order) and
value for value, loads it into the port model with ``strict=True``, and
compares the two forwards on one numpy-seeded input in fp32 (JAX at
"highest"): max|diff| <= 1e-5 + 1e-5 * max|ref| (the RDDB tails apply one
conv up to 8 times, so an output element's rounding scales with the map's
magnitude, not its own).  The tree comes from a fresh
port model (``jax_tree_from_module``, which is also checked to invert
``state_dict_from_jax``) with its norm parameters and running statistics
moved off their initial values; it stands in for the JAX model's
``init``, which the export calls only for the construction order of the
tree (computing a JAX init costs seconds a model).  The JAX PatchGAN's tree is rooted
at its Sequential, so its export's names lack the reference's ``model.``
prefix, which the port keeps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcgan_tpu import config as jax_config
from srcgan_tpu import interop as jax_interop
from srcgan_tpu import models as jax_models
from srcgan_tpu.ops import fused as jax_fused
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.ops import fused
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc

S = dict(nf=16, nb=1, gc=8)
D = dict(num_blocks=2, num_layers=2)

# name -> (JAX constructor, port constructor, input shape (NHWC), train mode)
CASES = {
    **{f"RDDBNetA-{m}": (lambda m=m: jax_models.RDDBNetA(3, 3, mode=m, **S),
                         lambda g, m=m: models.RDDBNetA(3, 3, mode=m, generator=g, **S),
                         (1, 8, 8, 3), False) for m in ("x1", "x2", "x4")},
    **{f"RDDBNetB-{m}": (lambda m=m: jax_models.RDDBNetB(3, 3, mode=m, **S),
                         lambda g, m=m: models.RDDBNetB(3, 3, mode=m, generator=g, **S),
                         (1, 8, 8, 3), False) for m in ("x2", "x4")},
    **{f"RDDBNetD-{m}": (lambda m=m: jax_models.RDDBNetD(3, 3, mode=m, **S),
                         lambda g, m=m: models.RDDBNetD(3, 3, mode=m, generator=g, **S),
                         (1, 16, 16, 3), False) for m in ("x2", "x4")},
    "SRDenseNetA": (lambda: jax_models.SRDenseNetA(1, 3, **D),
                    lambda g: models.SRDenseNetA(1, 3, generator=g, **D), (1, 8, 8, 1), False),
    "SRDenseNetB": (lambda: jax_models.SRDenseNetB(3, 1, **D),
                    lambda g: models.SRDenseNetB(3, 1, generator=g, **D), (1, 16, 16, 3), False),
    "NLayerD-BN-train": (lambda: jax_models.NLayerDiscriminator(3, 16, 2),
                         lambda g: models.NLayerDiscriminator(3, 16, 2, generator=g),
                         (2, 32, 32, 3), True),
    "NLayerD-BN-eval": (lambda: jax_models.NLayerDiscriminator(3, 16, 2),
                        lambda g: models.NLayerDiscriminator(3, 16, 2, generator=g),
                        (2, 32, 32, 3), False),
    "NLayerD-IN": (lambda: jax_models.NLayerDiscriminator(1, 16, 3, norm="IN"),
                   lambda g: models.NLayerDiscriminator(1, 16, 3, norm="IN", generator=g),
                   (2, 40, 40, 1), True),
    "Encoder": (lambda: jax_models.Encoder(), lambda g: models.Encoder(generator=g),
                (1, 8, 8, 64), False),
    "Decoder": (lambda: jax_models.Decoder(), lambda g: models.Decoder(generator=g),
                (2, 16, 16, 64), True),
    "EDSR": (lambda: jax_models.EDSR(1, 3, 2, base_channel=32, num_residuals=2),
             lambda g: models.EDSR(1, 3, 2, base_channel=32, num_residuals=2, generator=g),
             (1, 8, 8, 1), False),
    "SRDN": (lambda: jax_models.SRDN(1, 3, 2, nf=32, nb=1),
             lambda g: models.SRDN(1, 3, 2, nf=32, nb=1, generator=g), (1, 8, 8, 1), False),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These sizes are tiny: intra-op threads only contend with the other
    test workers' (the suite runs several processes side by side)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _highest():
    with jax_config.matmul_precision("highest"):
        yield


def fresh_port(make, seed):
    """A fresh port model with its norm affines and running statistics
    drawn away from ones and zeros."""
    g = torch.Generator().manual_seed(seed)
    model = make(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
                m.weight.add_(torch.randn(m.weight.shape, generator=g) * 0.1)
                m.bias.add_(torch.randn(m.bias.shape, generator=g) * 0.1)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def jax_export(jm, params, state):
    """export_torch_state_dict of the JAX model.  The export runs ``init``
    only for a template of the tree's construction order; the tree given
    serves (an order that differs from the JAX construction order
    misassigns tensors, which the forward comparison catches)."""
    jm.init = lambda key: params
    return jax_interop.export_torch_state_dict(jm, params, state)


@pytest.mark.parametrize("name", list(CASES))
def test_export_load_parity(name):
    make_jax, make_port, shape, train = CASES[name]
    jm = make_jax()
    src = fresh_port(make_port, sum(map(ord, name)))
    params, state = interop.jax_tree_from_module(src)
    exported = jax_export(jm, params, state)
    prefix = "model." if isinstance(src, models.NLayerDiscriminator) else ""
    exported = {prefix + k: v for k, v in exported.items()}

    own = [k for k in src.state_dict() if not k.endswith("num_batches_tracked")]
    ours = interop.state_dict_from_jax(src, params, state)
    assert list(ours) == list(exported) == own
    for k, v in exported.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)

    port = make_port(torch.Generator().manual_seed(99))
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in exported.items()}, strict=True)
    port.train(train)
    x = np.random.default_rng(len(name)).uniform(0, 1, shape).astype(np.float32)
    run = jax.jit(lambda p, s, v: jm.apply(p, v, state=s, train=train))
    want, want_state = run(params, state, jnp.asarray(x))
    with torch.no_grad():
        got = to_nhwc(port(to_nchw(torch.from_numpy(x)))).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 + 1e-5 * np.abs(want).max(), err
    back_params, back_state = interop.jax_tree_from_module(port)
    pairs = [(back_params, params), (back_state, want_state if train else state)]
    for mine, theirs in pairs:
        a, b = flat(mine), flat(theirs)
        assert a.keys() == b.keys()
        for k in b:          # the tree back; with train, the statistics moved alike
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5 if train else 0,
                                       atol=1e-6 if train else 0, err_msg=k)


def test_discriminator_raises_at_a_degenerate_size():
    d = models.NLayerDiscriminator(3, 16, 3)
    with pytest.raises(ValueError, match="too small"):
        d(torch.zeros(1, 3, 8, 8))
    jd = jax_models.NLayerDiscriminator(3, 16, 3)
    with pytest.raises(ValueError, match="too small"):
        jd._check_spatial(8, 8)
    assert d(torch.zeros(1, 3, 32, 32)).shape == (1, 1, 2, 2)


def test_nearest_up2_conv3x3_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    w = rng.standard_normal((3, 3, 6, 4)).astype(np.float32) * 0.2
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jax_fused.nearest_up2_conv3x3(jnp.asarray(x), jnp.asarray(w),
                                                    jnp.asarray(b)))
    got = fused.nearest_up2_conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_registry_holds_the_reference_exports():
    assert set(models.EXPORTED) <= set(models.REGISTRY)
    assert models.EXPORTED == jax_models.EXPORTED
    for name in ("NLayerDiscriminator", "RDDBNetA", "RDDBNetB", "RDDBNetD", "SRDenseNetA",
                 "SRDenseNetB", "Encoder", "Decoder", "EDSR", "SRDN"):
        assert models.REGISTRY[name].__name__ == jax_models.REGISTRY[name].__name__
