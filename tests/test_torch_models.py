"""Port models against the JAX models on the same weights and inputs.

Weights come from ``model.init(jax.random.PRNGKey(k))`` and cross over with
``srcgan_tpu_torch.interop.state_dict_from_jax``; inputs come from numpy.
Tolerances: fp32 max|diff| <= 1e-4 * max|ref| (JAX at "highest"; the order of
float sums differs through ~20 convs); bf16 relative L2 <= 2e-2 (bf16
activations, as tests/test_quant_kernel.py bounds them).  Observed on the
CPU (the same for 1, 3 and 8 torch threads): fp32 below 4e-6; bf16 RDDBNet
0.005-0.006, ResDeconv 0.018 -- JAX's own bf16 output is 0.015 from its fp32
one there, so that bound sits just above the bf16 noise of the randomly
initialized colorizer.
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


_JAX_MODELS = {
    "RDDBNet-x4": lambda: jax_models.RDDBNet(1, 1, 4, nf=16, nb=1),
    "RDDBNet-x2": lambda: jax_models.RDDBNet(1, 1, 2, nf=16, nb=1),
    "ResDeconv": lambda: jax_models.ResDeconv(1, 3),
    "ESPCN": lambda: jax_models.ESPCN(1, 1, 2),
    "SRCNN": lambda: jax_models.SRCNN(1, 1, 2),
}


@pytest.fixture(scope="module")
def jax_model():
    """(JAX model, params from model.init(PRNGKey(seed))) per name, made once
    per module: init of these models takes ~10 s each on the CPU."""
    cache = {}

    def get(name, seed):
        if name not in cache:
            model = _JAX_MODELS[name]()
            cache[name] = (model, model.init(jax.random.PRNGKey(seed)))
        return cache[name]

    return get


def port_of(jax_model, params, state=None, **kw):
    """The port model of the same name and arguments, with the JAX weights."""
    cls = models.REGISTRY[type(jax_model).__name__]
    model = cls(**kw)
    sd = interop.state_dict_from_jax(model, jax.device_get(params), jax.device_get(state))
    model.load_state_dict(sd, strict=True)
    return model.eval()


def forward_pair(jax_model, params, x, dtype, state=None, **kw):
    """(port output, JAX output) as NHWC float32 numpy."""
    model = port_of(jax_model, params, state, **kw)
    run = jax.jit(lambda p, v: jax_model.apply(p, v, state=state, train=False)[0])
    if dtype == "bf16":
        p = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
        with jax_config.matmul_precision("default"):
            want = run(p, jnp.asarray(x, jnp.bfloat16))
        model = model.to(torch.bfloat16)
    else:
        with jax_config.matmul_precision("highest"):
            want = run(params, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(
        next(model.parameters()).dtype, memory_format=torch.channels_last)
    with torch.no_grad():
        got = model(xt)
    return got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32)


def check(got, want, dtype):
    assert got.shape == want.shape
    if dtype == "fp32":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 2e-2, rel


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("up", [4, 2])
def test_rddbnet_forward(jax_model, up, dtype):
    jm, params = jax_model(f"RDDBNet-x{up}", up)
    x = np.random.default_rng(up).uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    got, want = forward_pair(jm, params, x, dtype, in_ch=1, ou_ch=1,
                             upscale_factor=up, nf=16, nb=1)
    assert got.shape == (2, 8 * up, 8 * up, 1)
    check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_resdeconv_gn_forward(jax_model, dtype):
    jm, params = jax_model("ResDeconv", 7)
    x = np.random.default_rng(7).uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    got, want = forward_pair(jm, params, x, dtype, src_ch=1, tar_ch=3)
    check(got, want, dtype)


def test_resdeconv_bn_eval_fp32(jax_model):
    """make_norm's BatchNorm in eval, with running statistics carried over from
    the JAX model state.  Its parameter tree is the GN model's (norm scale and
    bias either way), so the GN model's initial parameters serve."""
    _, params = jax_model("ResDeconv", 7)
    jm = jax_models.ResDeconv(1, 3, BN="BN")
    rng = np.random.default_rng(8)
    state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        jm.init_state())
    x = np.random.default_rng(9).uniform(0, 1, (1, 32, 32, 1)).astype(np.float32)
    got, want = forward_pair(jm, params, x, "fp32", state=state, src_ch=1, tar_ch=3,
                             BN="BN")
    check(got, want, "fp32")


@pytest.mark.parametrize("name,args,seed", [
    ("RDDBNet-x4", dict(in_ch=1, ou_ch=1, upscale_factor=4, nf=16, nb=1), 4),
    ("ResDeconv", dict(src_ch=1, tar_ch=3), 7),
])
def test_state_dict_from_jax_equals_export(jax_model, monkeypatch, name, args, seed):
    """state_dict_from_jax == srcgan_tpu.interop.export_torch_state_dict, key
    for key (in order) and value for value, and both load with strict=True."""
    jm, ordered = jax_model(name, seed)
    params = jax.device_get(ordered)      # tree utilities sort the keys
    # export re-runs init only for a template of the construction order,
    # which the tree made by init already has
    monkeypatch.setattr(jm, "init", lambda key: ordered)
    exported = jax_interop.export_torch_state_dict(jm, params)
    model = models.create(name.split("-")[0], **args)
    ours = interop.state_dict_from_jax(model, params)
    assert list(ours) == list(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model.load_state_dict(ours, strict=True)
    model.load_state_dict({k: torch.tensor(np.ascontiguousarray(v))
                           for k, v in exported.items()}, strict=True)
    assert list(model.state_dict()) == list(exported)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", ["ESPCN", "SRCNN"])
def test_espcn_srcnn_forward(jax_model, name, dtype):
    jm, params = jax_model(name, {"ESPCN": 12, "SRCNN": 13}[name])   # SRCNN's output is
    # a ReLU: at seed 13 ~78% of it is non-zero
    x = np.random.default_rng(11).uniform(0, 1, (2, 12, 10, 1)).astype(np.float32)
    got, want = forward_pair(jm, params, x, dtype, in_ch=1, ou_ch=1, upscale_factor=2)
    assert got.shape == ((2, 24, 20, 1) if name == "ESPCN" else (2, 12, 10, 1))
    check(got, want, dtype)


@pytest.mark.parametrize("name,args,seed", [
    ("ESPCN", dict(in_ch=1, ou_ch=1, upscale_factor=2), 12),
    ("SRCNN", dict(in_ch=1, ou_ch=1, upscale_factor=2), 13),
])
def test_export_load_parity_espcn_srcnn(jax_model, monkeypatch, name, args, seed):
    """The ESPCN and SRCNN cases of test_state_dict_from_jax_equals_export,
    and the way back: jax_tree_from_module gives the JAX tree again."""
    test_state_dict_from_jax_equals_export(jax_model, monkeypatch, name, args, seed)
    jm, params = jax_model(name, seed)
    model = port_of(jm, params, **args)
    back, state = interop.jax_tree_from_module(model)
    assert state == {}
    want = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_jax_tree_from_module_inverts_state_dict_from_jax():
    """RDDBNet and a BatchNorm ResDeconv: module -> JAX tree (and model state)
    -> state_dict gives the module's state_dict back, tensor for tensor."""
    g = torch.Generator().manual_seed(14)
    for model in (models.RDDBNet(1, 1, 4, nf=16, nb=1, generator=g),
                  models.ResDeconv(1, 3, BN="BN", generator=g)):
        with torch.no_grad():
            for name, b in model.named_buffers():
                if b.is_floating_point():
                    b.uniform_(0.5, 1.5, generator=g)
        params, state = interop.jax_tree_from_module(model)
        sd = interop.state_dict_from_jax(model, params, state)
        own = {k: v for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        assert list(sd) == list(own)
        for k, v in own.items():
            assert torch.equal(sd[k], v.contiguous()), k


def test_create_unknown_model_lists_known():
    with pytest.raises(KeyError, match="RDDBNet"):
        models.create("NoSuchNet", 1, 1, 2)


def test_fresh_weights_seeded_and_kaiming():
    """Fresh weights come from the generator, with the JAX package's
    distribution: kaiming normal with fan_out = out * kh * kw."""
    a = models.RDDBNet(1, 1, 4, generator=torch.Generator().manual_seed(5))
    b = models.RDDBNet(1, 1, 4, generator=torch.Generator().manual_seed(5))
    c = models.RDDBNet(1, 1, 4, generator=torch.Generator().manual_seed(6))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.trunk_conv.weight, c.trunk_conv.weight)
    w = a.RRDB_trunk[0].RDB1.conv5.weight        # (64, 192, 3, 3)
    assert abs(w.std().item() / (2.0 / (64 * 9)) ** 0.5 - 1) < 0.05
    d = a.upscale_layers[0].weight               # (in, out, 2, 2): fan_out = out*4
    assert abs(d.std().item() / (2.0 / (64 * 4)) ** 0.5 - 1) < 0.05
