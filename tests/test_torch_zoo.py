"""The EDSR-derived zoo (VDSR, MDSR, RDN, RCAN, DDBPN, EDSRWeb) against the
JAX models: export -> load parity.

Each case takes the JAX parameter tree of a fresh port model
(``jax_tree_from_module``, PReLU slopes moved off 0.25), checks that
``srcgan_tpu.interop.export_torch_state_dict`` of the JAX model equals
``state_dict_from_jax`` key for key, in order, and value for value (both
write the frozen MeanShift constants as the reference's 1x1 conv weight and
bias), loads it into a second port model with ``strict=True``, and compares
the two forwards on one numpy-seeded input in [0, 255] ([0, 1] for EDSRWeb)
in fp32, JAX at "highest": rel-L2 <= 1e-5.  Tiny widths: n_feats 8, 2
blocks, RCAN 2 groups of 2 (reduction 4); DDBPN and RDN (config B) at their
fixed widths on an 8^2 input; MDSR at every ``set_scale`` index.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srcgan_tpu import config as jax_config
from srcgan_tpu import interop as jax_interop
from srcgan_tpu.models import edsr_zoo as jzoo
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.models import edsr_zoo
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc

TINY = dict(n_feats=8, n_resblocks=2)

# name -> (args namespace kwargs, constructor name, output side of an 8^2 input;
# MDSR's at its last scale index)
CASES = {
    "VDSR": (dict(n_feats=8, n_resblocks=4), "VDSR", 8),
    "MDSR": (dict(scale=[2, 3, 4], **TINY), "MDSR", 32),
    "RDN-x2": (dict(scale=[2]), "RDN", 16),
    "RDN-x4": (dict(scale=[4], RDNconfig="A"), "RDN", 32),
    "RCAN": (dict(n_resgroups=2, reduction=4, **TINY), "RCAN", 16),
    "DDBPN-x2": (dict(scale=[2]), "DDBPN", 16),
    "DDBPN-x4": (dict(scale=[4]), "DDBPN", 32),
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


def fresh(make, seed):
    g = torch.Generator().manual_seed(seed)
    model = make(g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.PReLU):
                m.weight.uniform_(0.05, 0.5, generator=g)
    return model


def check_parity(jm, make, x, set_scale=()):
    """Export -> load -> forward at every scale index of ``set_scale``."""
    src = fresh(make, int(x.sum()) % 1000)
    params, state = interop.jax_tree_from_module(src)
    assert not state
    jm.init = lambda key: params
    exported = jax_interop.export_torch_state_dict(jm, params)
    ours = interop.state_dict_from_jax(src, params)
    assert list(ours) == list(exported) == list(src.state_dict())
    for k, v in exported.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    port = make(torch.Generator().manual_seed(99))
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in exported.items()}, strict=True)
    errs = []
    for idx in set_scale or (None,):
        if idx is not None:
            jm.set_scale(idx)
            port.set_scale(idx)
        want = np.asarray(jax.jit(lambda p, v: jm.fwd(p, v))(params, jnp.asarray(x)))
        with torch.no_grad():
            got = to_nhwc(port(to_nchw(torch.from_numpy(x)))).numpy()
        assert got.shape == want.shape
        errs.append(rel_l2(got, want))
    assert max(errs) <= 1e-5, errs
    back, _ = interop.jax_tree_from_module(port)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(back), flat(params)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in b)
    return want.shape


@pytest.mark.parametrize("name", list(CASES))
def test_zoo_export_load_parity(name):
    kw, cls, side = CASES[name]
    jm = getattr(jzoo, cls)(jzoo.args_namespace(**kw))
    make = lambda g: models.create(cls, edsr_zoo.args_namespace(**kw), generator=g)  # noqa: E731
    x = np.random.default_rng(len(name)).uniform(0, 255, (1, 8, 8, 3)).astype(np.float32)
    scales = list(range(len(kw["scale"]))) if cls == "MDSR" else ()
    shape = check_parity(jm, make, x, scales)
    assert shape == (1, side, side, 3)


@pytest.mark.parametrize("up", [2, 3, 4])
def test_edsrweb_export_load_parity(up):
    jm = jzoo.EDSRWeb(1, 1, up, **TINY)
    make = lambda g: models.create("EDSRWeb", 1, 1, up, generator=g, **TINY)  # noqa: E731
    x = np.random.default_rng(up).uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)
    assert check_parity(jm, make, x) == (2, 8 * up, 8 * up, 1)


def test_meanshift_is_a_frozen_buffer():
    m = edsr_zoo.MeanShift(255)
    assert not list(m.parameters())
    assert [k for k, _ in m.named_buffers()] == ["weight", "bias"]
    j = jzoo.MeanShift(255)
    x = np.random.default_rng(0).uniform(0, 255, (1, 4, 4, 3)).astype(np.float32)
    want = np.asarray(j.fwd({}, jnp.asarray(x)))
    got = to_nhwc(m(to_nchw(torch.from_numpy(x)))).numpy()
    np.testing.assert_array_equal(got, want)
    net = models.create("VDSR", edsr_zoo.args_namespace(n_feats=8, n_resblocks=3))
    assert not any("mean" in k for k in interop.jax_tree_from_module(net)[0])


def test_default_widths_follow_the_jax_constructors():
    """Parameter counts of the default builds equal the JAX trees' (no
    forward: the JAX init runs on shapes only)."""
    for name, port in (("VDSR", models.VDSR()), ("RDN", models.RDN()),
                       ("DDBPN", models.DDBPN()), ("EDSRWeb", models.EDSRWeb(3, 3, 2))):
        jm = getattr(jzoo, name)(3, 3, 2) if name == "EDSRWeb" else getattr(jzoo, name)()
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
        assert sum(p.numel() for p in port.parameters()) == n_jax, name


def test_edsrweb_is_a_cascade_sr_stage(tmp_path, monkeypatch):
    """train_cas --SRModel EDSRWeb for one epoch, then test_cas on its
    checkpoints: a Performs.csv row of finite numbers (EDSRWeb at 2 blocks
    of 8 features)."""
    from srcgan_tpu_torch.cli import test_cas, train_cas

    monkeypatch.setitem(models.REGISTRY, "EDSRWeb",
                        lambda *a, **kw: edsr_zoo.EDSRWeb(*a, **TINY, **kw))
    data_dir = tmp_path / "data"
    from srcgan_tpu_torch import data
    data.make_synthetic_dataset(str(data_dir / "Sat2Aerx1"), n_train=2, n_val=1, n_test=2,
                                size=16, colorizable=True)
    state = train_cas.main(["--data-dir", str(data_dir), "--SRModel", "EDSRWeb", "--up", "2",
                            "--num-epochs", "1", "--save-every", "1",
                            "--checkpoints", str(tmp_path / "ck"),
                            "--run-dir", str(tmp_path / "run"), "--device", "cpu"])
    assert type(state.sr.model).__name__ == "EDSRWeb"
    out = test_cas.main(["--netGA", str(tmp_path / "ck" / "EDSRWeb_A2C_x2_0001.npz"),
                         "--netGB", str(tmp_path / "ck" / "ResDeconv_C2B_x2_0001.npz"),
                         "--data-dir", str(data_dir), "--result-dir", str(tmp_path / "res"),
                         "--device", "cpu"])
    assert out["images"] == 2
    assert all(np.isfinite(out[k]) for k in ("MSE", "PSNR", "AE", "SSIM"))
