"""The pix2pix generators of the multi-task trainer against the JAX models,
and the port's registry against the JAX package's.

Export -> load parity for the four ``define_G`` nets (ngf 8; ``unet_256``
at ngf 4) in instance, batch and no norm: the tree comes from a fresh port
model (``jax_tree_from_module``), ``srcgan_tpu.interop.export_torch_state_dict``
of the JAX model gives the same tensors in the same order as
``state_dict_from_jax`` (the JAX export's names lack the ``model`` /
``conv_block`` roots the port keeps), the tree loads into a second port
model with ``strict=True``, and the two forwards on one numpy-seeded input,
train mode, agree within rel-L2 1e-5 in fp32 (JAX at "highest").  Inputs are
at least 2^num_downs on a side (a U-Net's innermost map is empty below it):
32^2 for the resnets, 128^2 and 256^2 for the U-Nets.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcgan_tpu import config as jax_config
from srcgan_tpu import interop as jax_interop
from srcgan_tpu import models as jax_models
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.models import pix2pix
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.ops.norm import instance_norm

# name -> (netG, norm, ngf, input channels, output channels, side)
CASES = {
    "resnet_9blocks-instance": ("resnet_9blocks", "instance", 8, 1, 3, 32),
    "resnet_6blocks-batch": ("resnet_6blocks", "batch", 8, 3, 1, 32),
    "resnet_6blocks-none": ("resnet_6blocks", "none", 8, 3, 1, 32),
    "unet_128-batch": ("unet_128", "batch", 8, 1, 3, 128),
    "unet_256-instance": ("unet_256", "instance", 4, 3, 1, 256),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These sizes are small: intra-op threads only contend with the other
    test workers' (the suite runs several processes side by side)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _highest():
    with jax_config.matmul_precision("highest"):
        yield


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_export(jm, params, state):
    """export_torch_state_dict of the JAX model, the tree given standing in
    for its ``init`` (which the export runs only for the tree's order)."""
    jm.init = lambda key: params
    return jax_interop.export_torch_state_dict(jm, params, state)


@pytest.mark.parametrize("name", list(CASES))
def test_define_g_export_load_parity(name):
    net_g, norm, ngf, cin, cout, side = CASES[name]
    jm = jax_models.define_G(cin, cout, ngf, net_g, norm)
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    src = models.define_G(cin, cout, ngf, net_g, norm, generator=g)
    with torch.no_grad():                  # norm affines off ones and zeros
        for m in src.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.add_(torch.randn(m.weight.shape, generator=g) * 0.1)
                m.bias.add_(torch.randn(m.bias.shape, generator=g) * 0.1)
    params, state = interop.jax_tree_from_module(src)
    exported = jax_export(jm, params, state)
    ours = interop.state_dict_from_jax(src, params, state)
    own = [k for k in src.state_dict() if not k.endswith("num_batches_tracked")]
    assert list(ours) == own and len(exported) == len(ours)
    for (k, v), (kj, vj) in zip(ours.items(), exported.items()):
        assert k.replace("model.", "").replace("conv_block.", "") == kj
        np.testing.assert_array_equal(v.numpy(), vj, err_msg=k)

    port = models.define_G(cin, cout, ngf, net_g, norm, generator=torch.Generator().manual_seed(9))
    port.load_state_dict(ours, strict=True)
    port.train()
    x = np.random.default_rng(len(name)).uniform(-1, 1, (2, side, side, cin)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jm.fwd(p, v, train=True))(params, jnp.asarray(x)))
    with torch.no_grad():
        got = to_nhwc(port(to_nchw(torch.from_numpy(x)))).numpy()
    assert got.shape == want.shape == (2, side, side, cout)
    assert rel_l2(got, want) <= 1e-5, rel_l2(got, want)
    back, _ = interop.jax_tree_from_module(port)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(back), flat(params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in b)


def test_unet_nests_its_blocks_at_the_jax_indices():
    net = models.define_G(1, 3, 4, "unet_128", "batch")
    names = list(net.state_dict())
    assert names[:2] == ["model.model.0.weight", "model.model.1.model.1.weight"]
    # seven levels: the outermost holds the next at 1, the five middle ones
    # theirs at 3, the innermost's down conv is its layer 1
    assert "model.model.1" + ".model.3" * 5 + ".model.1.weight" in names
    assert isinstance(net.model.model[1], pix2pix.UnetSkipConnectionBlock)


def test_instance_norm_of_a_1x1_map_is_zero():
    """F.instance_norm refuses a 1x1 map; the JAX function normalizes it to
    0, the port's to 0 up to fp32 rounding scaled by 1/sqrt(eps)."""
    from srcgan_tpu.ops import norm as jnorm

    x = np.random.default_rng(0).standard_normal((2, 1, 1, 5)).astype(np.float32)
    want = np.asarray(jnorm.instance_norm(jnp.asarray(x)))
    got = instance_norm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    scale, bias = torch.full((5,), 2.0), torch.arange(5.0)
    np.testing.assert_allclose(instance_norm(torch.from_numpy(x), scale, bias).numpy(),
                               np.broadcast_to(np.arange(5.0, dtype=np.float32), x.shape),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 9, 7, 5), (1, 4, 4, 16)])
def test_instance_norm_matches_jax(shape):
    from srcgan_tpu.ops import norm as jnorm

    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32) * 3 + 1
    scale, bias = (rng.standard_normal(shape[-1]).astype(np.float32) for _ in range(2))
    for args in ((), (scale, bias)):
        want = np.asarray(jnorm.instance_norm(jnp.asarray(x), *map(jnp.asarray, args)))
        got = instance_norm(torch.from_numpy(x), *map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dropout_is_inverted_and_seeded():
    drop = pix2pix.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    x = torch.ones(4, 8, 16, 16)
    y = drop(x)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.05
    again = pix2pix.Dropout(0.5, generator=torch.Generator().manual_seed(0))(x)
    assert torch.equal(y, again)
    assert torch.equal(drop.eval()(x), x)
    net = models.define_G(1, 3, 4, "unet_128", "batch", use_dropout=True)
    assert sum(isinstance(m, pix2pix.Dropout) for m in net.modules()) == 2   # 128: 7 - 5 levels


def test_define_g_rejects_unknown_names():
    with pytest.raises(NotImplementedError, match="not recognized"):
        models.define_G(1, 3, 8, "resnet_3blocks")
    with pytest.raises(NotImplementedError, match="not found"):
        models.define_G(1, 3, 8, "resnet_6blocks", "group")


def test_registry_holds_the_jax_package_names():
    assert len(models.REGISTRY) == len(jax_models.REGISTRY) == 22
    assert list(models.REGISTRY) == list(jax_models.REGISTRY)
    for name, cls in models.REGISTRY.items():
        assert cls.__name__ == jax_models.REGISTRY[name].__name__, name


def test_register_adds_a_model():
    class Tiny(torch.nn.Module):
        def __init__(self, c):
            super().__init__()
            self.c = c

    try:
        models.register("Tiny", Tiny)
        assert models.create("Tiny", 3).c == 3
    finally:
        models.REGISTRY.pop("Tiny", None)
    with pytest.raises(KeyError, match="unknown model"):
        models.create("Tiny", 3)
