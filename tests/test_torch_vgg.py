"""The port's VGG perceptual losses against the JAX package, on one set of
random weights (no trained VGG ships with the repository).

fp32, XLA HIGHEST against cuDNN-free CPU convolutions: the VGG16 features
at every cut, ``vgg16_loss``, ``vgg16_loss_3d`` and VGG19's
``perception_loss`` within rtol 1e-5, the loss's gradient with respect to
the prediction within rel-L2 1e-5 (and none reaches the weights);
``load_vgg_params`` from ``.npz`` and ``.pth``; ``cli.convert_vgg``'s
``.npz`` equal to the JAX tool's on the same ``.pth``; the perceptual term
in ``CasTrainer`` (one fp32 step: losses rtol 1e-5, updates rel-L2 5e-2,
tests/test_torch_train.py's bounds) and on the CycleGAN's reconstructions
(the G loss rtol 1e-5).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from srcgan_tpu import config as jax_config
from srcgan_tpu import losses_vgg as jlv
from srcgan_tpu.cli import convert_vgg as jconvert
from srcgan_tpu.train import cas as jcas
from srcgan_tpu.train import cyclegan as jcyc
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import interop, losses_vgg
from srcgan_tpu_torch.cli import convert_vgg
from srcgan_tpu_torch.train.cas import CasTrainer
from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer

HW = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _highest():
    with jax_config.matmul_precision("highest"):
        yield


def shared_vgg(cfg, seed):
    """(JAX params, the port's params of the same weights): the JAX
    package's {idx: {"w": HWIO, "b"}} layout drawn with numpy (its own init
    draws with one eager split per conv, seconds), uniform within
    +-sqrt(6/fan_in), so that the activations keep their scale through the
    16 convolutions of VGG19 instead of vanishing."""
    rng = np.random.default_rng(seed)
    jp, cin = {}, 3
    for idx, kind, cout in jlv._features_plan(cfg):
        if kind == "conv":
            bound = np.sqrt(6.0 / (9 * cin))
            jp[str(idx)] = {"w": rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
                            "b": rng.uniform(-bound, bound, cout).astype(np.float32)}
            cin = cout
    return jtu.tree_map(jnp.asarray, jp), interop.vgg_params_from_jax(jp)


@pytest.fixture(scope="module")
def vgg16():
    return shared_vgg(jlv.VGG16_CFG, 0)


def images(seed, *shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def close(got, want, rtol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_features_at_every_cut_match_jax(vgg16):
    jp, tp = vgg16
    x = images(1, 2, HW, HW, 3)
    want = jlv.vgg_features(jp, jnp.asarray(x))
    got = losses_vgg.vgg_features(tp, torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("channels", [1, 3])
def test_vgg16_loss_and_its_gradient_match_jax(vgg16, channels):
    """A 1-channel input is replicated to RGB; the gradient reaches the
    prediction and no weight."""
    jp, tp = vgg16
    out, tgt = images(2, 2, HW, HW, channels), images(3, 2, HW, HW, channels)
    want, want_g = jax.value_and_grad(lambda o: jlv.vgg16_loss(jp, o, jnp.asarray(tgt)))(
        jnp.asarray(out))
    pred = torch.from_numpy(out).requires_grad_(True)
    loss = losses_vgg.vgg16_loss(tp, pred, torch.from_numpy(tgt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    g, w = pred.grad.numpy(), np.asarray(want_g)
    assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
    assert all(not t.requires_grad and t.grad is None for p in tp.values() for t in p.values())


def test_vgg16_loss_3d_matches_jax(vgg16):
    jp, tp = vgg16
    out, tgt = images(4, 2, 2, HW, HW, 3), images(5, 2, 2, HW, HW, 3)
    want = jlv.vgg16_loss_3d(jp, jnp.asarray(out), jnp.asarray(tgt))
    got = losses_vgg.vgg16_loss_3d(tp, torch.from_numpy(out), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_perception_loss_vgg19_matches_jax():
    jp, tp = shared_vgg(jlv.VGG19_CFG, 1)
    assert sorted(tp, key=int) == [str(i) for i, k, _ in
                                   losses_vgg._features_plan(losses_vgg.VGG19_CFG) if k == "conv"]
    out, tgt = images(6, 1, 2 * HW, 2 * HW, 1), images(7, 1, 2 * HW, 2 * HW, 1)
    want = jlv.perception_loss(jp, jnp.asarray(out), jnp.asarray(tgt))
    got = losses_vgg.perception_loss(tp, torch.from_numpy(out), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_init_vgg_params_draws_torchvision_shapes_in_bounds():
    p = losses_vgg.init_vgg_params(torch.Generator().manual_seed(0))
    again = losses_vgg.init_vgg_params(torch.Generator().manual_seed(0))
    cin = 3
    for idx, kind, cout in losses_vgg._features_plan(losses_vgg.VGG16_CFG):
        if kind != "conv":
            continue
        w, b = p[str(idx)]["w"], p[str(idx)]["b"]
        assert w.shape == (cout, cin, 3, 3) and b.shape == (cout,)
        bound = 1.0 / np.sqrt(9 * cin)
        assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound
        assert float(w.std()) > bound / 3                     # spread over the range
        assert torch.equal(w, again[str(idx)]["w"])
        cin = cout


def _torchvision_pth(path, arch_cfg, seed=0):
    """A torchvision-layout VGG state_dict (features.* OIHW, and a
    classifier the conversion drops)."""
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for idx, kind, cout in losses_vgg._features_plan(arch_cfg):
        if kind == "conv":
            sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=g)
            sd[f"features.{idx}.bias"] = torch.randn(cout, generator=g)
            cin = cout
    sd["classifier.0.weight"] = torch.randn(4, 8, generator=g)
    torch.save(sd, path)
    return sd


def test_load_and_convert_vgg_match_jax(tmp_path, capsys):
    sd = _torchvision_pth(tmp_path / "vgg16.pth", losses_vgg.VGG16_CFG)
    from_pth = losses_vgg.load_vgg_params(str(tmp_path / "vgg16.pth"))
    convert_vgg.main([str(tmp_path / "vgg16.pth"), str(tmp_path / "port.npz")])
    assert "26 arrays (vgg16 features)" in capsys.readouterr().out
    jconvert.main([str(tmp_path / "vgg16.pth"), str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) and "classifier.0.weight" not in a.files
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])
    from_npz = losses_vgg.load_vgg_params(str(tmp_path / "port.npz"))
    jax_npz = interop.vgg_params_from_jax(jlv.load_vgg_params(str(tmp_path / "port.npz")))
    for idx, p in from_pth.items():
        assert torch.equal(p["w"], sd[f"features.{idx}.weight"])
        for k in ("w", "b"):
            assert torch.equal(from_npz[idx][k], p[k]) and torch.equal(jax_npz[idx][k], p[k])


def test_convert_vgg_refuses_the_wrong_architecture(tmp_path):
    """A conv of another shape fails loudly; a layer the file lacks too."""
    sd = _torchvision_pth(tmp_path / "vgg16.pth", losses_vgg.VGG16_CFG)
    with pytest.raises(KeyError, match="features.16.weight"):
        convert_vgg.convert(str(tmp_path / "vgg16.pth"), str(tmp_path / "x.npz"), "vgg19")
    sd["features.2.weight"] = torch.zeros(64, 32, 3, 3)
    torch.save(sd, tmp_path / "odd.pth")
    with pytest.raises(ValueError, match="wrong --arch"):
        convert_vgg.convert(str(tmp_path / "odd.pth"), str(tmp_path / "x.npz"), "vgg16")


def test_perceptual_cas_step_matches_jax(vgg16):
    jp, tp = vgg16
    tr = CasTrainer("ESPCN", "SRCNN", up=2, lr=1e-4, perceptual_params=tp,
                    perceptual_weight=0.5, device="cpu")
    jtr = jcas.CasTrainer(sr_model="ESPCN", c_model="SRCNN", up=2, lr=1e-4,
                          perceptual_params=jp, perceptual_weight=0.5)
    state = tr.init(0)

    def ts(model):
        params = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(model)[0])
        return jstate.TrainState(params, jtr.opt.init(params), jnp.zeros((), jnp.int32))

    before = {r: interop.jax_tree_from_module(getattr(state, r).model)[0] for r in ("sr", "c")}
    jst = jcas.CasState(ts(state.sr.model), ts(state.c.model), {}, {})
    realA = np.zeros((2, HW, HW, 1), np.float32)
    realB = images(8, 2, HW, HW, 3)
    jst, jm = jtr.train_step(jst, jnp.asarray(realA), jnp.asarray(realB), 1e-4)
    state, m = tr.train_step(state, torch.from_numpy(realA), torch.from_numpy(realB), 1e-4)
    for k in ("loss_SR", "loss_C", "psnr_SR", "psnr_C"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    flat = lambda t: {jtu.keystr(p): np.asarray(v, np.float64)  # noqa: E731
                      for p, v in jtu.tree_flatten_with_path(t)[0]}
    for role, jparams in (("sr", jst.sr.params), ("c", jst.c.params)):
        after = flat(interop.jax_tree_from_module(getattr(state, role).model)[0])
        start, want = flat(before[role]), flat(jparams)
        for k in want:
            d = want[k] - start[k]
            assert np.linalg.norm(after[k] - start[k] - d) <= 5e-2 * np.linalg.norm(d), (role, k)
    # the L1 term alone is below the loss: the perceptual term is in it
    plain = CasTrainer("ESPCN", "SRCNN", up=2, device="cpu")
    _, _, pm = plain.grads(plain.init(0), torch.from_numpy(realA), torch.from_numpy(realB))
    assert float(pm["loss_C"]) < float(m["loss_C"])


def test_perceptual_cyclegan_g_loss_matches_jax(vgg16):
    """The term on both cycle reconstructions (net='SRdens': gray recl_A is
    replicated to RGB), the G step's loss against JAX's."""
    jp, tp = vgg16
    tr = CycleGANTrainer(net="SRdens", remat=False, perceptual_params=tp, perceptual_weight=0.5,
                         device="cpu")
    jtr = jcyc.CycleGANTrainer(net="SRdens", remat=False, perceptual_params=jp,
                               perceptual_weight=0.5)
    state = tr.init(0)
    gp = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(state.g.model)[0])
    dp, ds = (jtu.tree_map(jnp.asarray, t) for t in interop.jax_tree_from_module(state.d.model))
    jst = jcyc.CycleState(jstate.TrainState(gp, jtr.opt_g.init(gp), jnp.zeros((), jnp.int32)),
                          jstate.TrainState(dp, jtr.opt_d.init(dp), jnp.zeros((), jnp.int32)),
                          ds)
    real_a, real_b = images(9, 2, HW, HW, 1), images(10, 2, 2 * HW, 2 * HW, 3)
    _, jaux = jtr.g_step(jst, jnp.asarray(real_a), jnp.asarray(real_b), 1e-4)
    _, aux = tr.g_grads(state, torch.from_numpy(real_a), torch.from_numpy(real_b))
    np.testing.assert_allclose(float(aux["loss_G"]), float(jaux["loss_G"]), rtol=1e-5)
    plain = CycleGANTrainer(net="SRdens", remat=False, device="cpu")
    _, plain_aux = plain.g_grads(state, torch.from_numpy(real_a), torch.from_numpy(real_b))
    assert float(plain_aux["loss_G"]) < float(aux["loss_G"])
