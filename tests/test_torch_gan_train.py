"""The port's CycleGANTrainer against the JAX CycleGANTrainer, and within the port.

Against JAX, in float64 at a matched point (the same parameters, inputs and
fakes on both sides; fp32 trajectories across two frameworks are no check):
``g_grads`` and ``d_grads`` of small net='1' and net='SRdens' builds, batch 2
of 32^2 targets, within rel-L2 1e-6 per tree (the generators and the
discriminators each as one vector); the D step's BatchNorm running statistics
within 1e-6.  Both packages run BatchNorm in fp32 and the G step's frozen
discriminators in fp32 whatever the input dtype, so those parts carry fp32
rounding on both sides.  The L1 terms' gradients are signs: the test
asserts that no residual lies within 1e-9 of zero, where a sign could
differ.  Small builds: RDDBNetB/D at nf=16, nb=1, gc=8, PatchGANs at ndf=16.

Within the port (fp32 unless stated): the G step leaves the
discriminators' running statistics bit-unchanged; ``gd_step`` equals
``g_step`` then ``d_step`` with pool_size 0; ``gd_steps_u8`` with K=2 equals
two ``gd_step``s; ``pack_passes`` equals unpacked (1e-5); remat on equals
off (gradients, 1e-6); ``set_trunk_remat`` is instance-scoped; both EMA
paths; the pools.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from srcgan_tpu import config as jax_config
from srcgan_tpu import models as jax_models
from srcgan_tpu.train import cyclegan as jcyc
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.models.blocks import RRDB, set_trunk_remat
from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer, ImagePool

SMALL = dict(nf=16, nb=1, gc=8)
NDF = 16
N, HW = 2, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These sizes are tiny: intra-op threads only contend with the other
    test workers' (the suite runs several processes side by side)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small_rddb(cls):
    def make(in_nc, out_nc, nf=64, nb=3, gc=32, mode="x2", **kw):
        return cls(in_nc, out_nc, mode=mode, **SMALL, **kw)
    return make


def _small_disc(input_nc, ndf=64, n_layers=3, **kw):
    return models.NLayerDiscriminator(input_nc, NDF, n_layers, **kw)


@pytest.fixture(scope="module", autouse=True)
def small_models():
    """The port trainer builds the small nets; the JAX one gets them in
    ``jax_trainer``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(models.REGISTRY, "RDDBNetB", _small_rddb(models.RDDBNetB))
        mp.setitem(models.REGISTRY, "RDDBNetD", _small_rddb(models.RDDBNetD))
        mp.setitem(models.REGISTRY, "NLayerDiscriminator", _small_disc)
        yield


def jax_trainer(net):
    tr = jcyc.CycleGANTrainer(net=net, mode="x2", remat=False)
    if net == "1":
        tr.netG_A = jax_models.RDDBNetB(3, 3, mode="x2", **SMALL)
        tr.netG_B = jax_models.RDDBNetD(3, 3, mode="x2", **SMALL)
    tr.netD_A = jax_models.NLayerDiscriminator(3, NDF, 2)
    tr.netD_B = jax_models.NLayerDiscriminator(3 if net == "1" else 1, NDF, 2)
    return tr


def port_state(tr, seed=0):
    """A fresh port state whose discriminators' running statistics are moved
    off their initial values (so the state's mapping is exercised)."""
    state = tr.init(seed)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, b in state.d.model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return state


def jax_state_of(jtr, state, dtype):
    cast = lambda t: jtu.tree_map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
    gp = cast(interop.jax_tree_from_module(state.g.model)[0])
    dp, ds = (cast(t) for t in interop.jax_tree_from_module(state.d.model))
    return jcyc.CycleState(
        jstate.TrainState(gp, jtr.opt_g.init(gp), jnp.zeros((), jnp.int32)),
        jstate.TrainState(dp, jtr.opt_d.init(dp), jnp.zeros((), jnp.int32)), ds)


def batch(net, seed):
    """(realA, realB, fake_A, fake_B): float32-representable float64 arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32).astype(np.float64)  # noqa: E731
    real_b = f(N, HW, HW, 3)
    real_a = real_b[:, ::2, ::2].copy() if net == "1" else f(N, HW // 2, HW // 2, 1)
    return real_a, real_b, f(*real_a.shape), f(*real_b.shape)


def flat_vector(tree):
    leaves = [np.asarray(v, np.float64).ravel()
              for _, v in sorted(jtu.tree_flatten_with_path(tree)[0], key=lambda kv: str(kv[0]))]
    return np.concatenate(leaves)


def tree_keys(tree):
    return sorted(jtu.keystr(p) for p, _ in jtu.tree_flatten_with_path(tree)[0])


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(autouse=True)
def _highest():
    with jax_config.matmul_precision("highest"):
        yield


@pytest.fixture(scope="module", params=["1", "SRdens"])
def float64_pair(request, small_models):
    """(net, port grads/aux, JAX grads/aux) of the G and the D half in float64."""
    net = request.param
    tr = CycleGANTrainer(net=net, device="cpu")
    jtr = jax_trainer(net)
    state = port_state(tr)
    real_a, real_b, fake_a, fake_b = batch(net, 1)
    jax.config.update("jax_enable_x64", True)
    try:
        jst = jax_state_of(jtr, state, jnp.float64)
        # both halves in one program: one compile, most of this file's time
        (jg, jaux), (jd, (jla, jlb, jbn)) = jax.jit(
            lambda st, ra, rb, fa, fb: (jtr.g_grads(st, ra, rb), jtr.d_grads(st, ra, rb, fa, fb))
        )(jst, *(jnp.asarray(v) for v in (real_a, real_b, fake_a, fake_b)))
        jax_out = {"g": jax.device_get(jg), "d": jax.device_get(jd),
                   "bn": jax.device_get(jbn), "aux": jax.device_get(jaux),
                   "loss_D": (float(jla), float(jlb))}
    finally:
        jax.config.update("jax_enable_x64", False)
    state.g.model.double()
    state.d.model.double()
    t = [torch.from_numpy(v) for v in (real_a, real_b, fake_a, fake_b)]
    pg, paux = tr.g_grads(state, t[0], t[1])
    pd, (pla, plb, pbn) = tr.d_grads(state, *t)
    port_out = {"g": interop.jax_tree_from_module(state.g.model, pg)[0],
                "d": interop.jax_tree_from_module(state.d.model, pd)[0],
                "bn": interop.jax_tree_from_module(state.d.model, pbn)[1],
                "aux": paux, "loss_D": (float(pla), float(plb))}
    return net, port_out, jax_out, (real_a, real_b)


def test_float64_g_grads_match_jax(float64_pair):
    net, ours, want, (real_a, real_b) = float64_pair
    # no L1 residual near zero, where the two sides' signs could differ
    for img, ref in (("recl_A", real_a), ("recl_B", real_b), ("iden_A", real_b),
                     ("iden_B", real_a)):
        assert np.abs(ours["aux"][img].numpy() - ref).min() > 1e-9, img
    for k in ("loss_G", "loss_G_A", "loss_G_B", "loss_cycle_A", "loss_cycle_B",
              "loss_iden_A", "loss_iden_B"):
        np.testing.assert_allclose(float(ours["aux"][k]), float(want["aux"][k]),
                                   rtol=1e-6, err_msg=k)
    assert tree_keys(ours["g"]) == tree_keys(want["g"])
    err = rel_l2(flat_vector(ours["g"]), flat_vector(want["g"]))
    assert err <= 1e-6, (net, err)


def test_float64_d_grads_and_bn_state_match_jax(float64_pair):
    net, ours, want, _ = float64_pair
    np.testing.assert_allclose(ours["loss_D"], want["loss_D"], rtol=1e-6)
    assert tree_keys(ours["d"]) == tree_keys(want["d"])
    err = rel_l2(flat_vector(ours["d"]), flat_vector(want["d"]))
    assert err <= 1e-6, (net, err)
    assert tree_keys(ours["bn"]) == tree_keys(want["bn"])
    np.testing.assert_allclose(flat_vector(ours["bn"]), flat_vector(want["bn"]),
                               rtol=1e-6, atol=1e-7)


# -- within the port ---------------------------------------------------------

def f32(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, shape)
                            .astype(np.float32))


@pytest.fixture(scope="module")
def fp32_setup(small_models):
    """(trainer with pool 0, a fresh state, realA, realB) at net='1'."""
    tr = CycleGANTrainer(net="1", pool_size=0, device="cpu")
    real_b = f32(2, N, HW, HW, 3)
    return tr, port_state(tr, 3), real_b[:, ::2, ::2].contiguous(), real_b


def params_of(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def test_g_step_leaves_discriminator_statistics_unchanged(fp32_setup):
    tr, state0, real_a, real_b = fp32_setup
    state = copy.deepcopy(state0)
    before = params_of(state.d.model)
    stats = {k: v.clone() for k, v in state.d_model_state.items()}
    assert stats and all(k.endswith(("running_mean", "running_var", "num_batches_tracked"))
                         for k in stats)
    state, _ = tr.g_step(state, real_a, real_b, 1e-4)
    after = params_of(state.d.model)
    assert state.g.step == 1 and state.d.step == 0
    for k in before:
        assert torch.equal(before[k], after[k]), k
    for k, v in state.d_model_state.items():
        assert torch.equal(stats[k], v), k
    assert all(p.grad is None for p in state.d.model.parameters())


def test_gd_step_is_g_step_then_d_step(fp32_setup):
    tr, state0, real_a, real_b = fp32_setup
    a, b = copy.deepcopy(state0), copy.deepcopy(state0)
    a, aux_a = tr.gd_step(a, real_a, real_b, 1e-4, 1e-5)
    b, aux_b = tr.g_step(b, real_a, real_b, 1e-4)
    b, dm = tr.d_step(b, real_a, real_b, aux_b["fake_A"], aux_b["fake_B"], 1e-5)
    aux_b.update(dm)
    assert (a.g.step, a.d.step) == (b.g.step, b.d.step) == (1, 1)
    for k in aux_b:
        assert torch.equal(aux_a[k], aux_b[k]), k
    for net in ("g", "d"):
        pa, pb = params_of(getattr(a, net).model), params_of(getattr(b, net).model)
        assert all(torch.equal(pa[k], pb[k]) for k in pa), net


def test_gd_steps_u8_is_two_gd_steps(fp32_setup):
    tr, state0, _, _ = fp32_setup
    rng = np.random.default_rng(4)
    src, tar = (torch.from_numpy(rng.integers(0, 256, (2, N, HW, HW, 3), dtype=np.uint8))
                for _ in range(2))
    a, imgs, scalars = tr.gd_steps_u8(copy.deepcopy(state0), src, tar, 1e-4, 1e-5)
    b = copy.deepcopy(state0)
    rows = []
    for k in range(2):
        b, aux = tr.gd_step(b, *tr.inputs_u8(src[k], tar[k]), 1e-4, 1e-5)
        rows.append(aux)
    assert a.g.step == b.g.step == 2
    assert set(imgs) == set(CycleGANTrainer._IMAGE_KEYS)
    for k, v in scalars.items():
        assert v.shape == (2,)
        assert torch.equal(v, torch.stack([r[k] for r in rows])), k
    for k in imgs:
        assert torch.equal(imgs[k], rows[-1][k]), k
    pa, pb = params_of(a.g.model), params_of(b.g.model)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


def grads_of(tr, state, real_a, real_b):
    g, aux = tr.g_grads(state, real_a, real_b)
    return torch.cat([v.flatten() for v in g.values()]), aux


def test_pack_passes_equals_unpacked(fp32_setup):
    tr, state, real_a, real_b = fp32_setup
    packed = CycleGANTrainer(net="1", pool_size=0, pack_passes=True, device="cpu")
    g0, aux0 = grads_of(tr, state, real_a, real_b)
    g1, aux1 = grads_of(packed, state, real_a, real_b)
    assert float((g1 - g0).norm() / g0.norm()) <= 1e-5
    for k in CycleGANTrainer._IMAGE_KEYS:
        np.testing.assert_allclose(aux1[k].numpy(), aux0[k].numpy(), rtol=1e-5, atol=1e-5)


def test_remat_on_equals_off(fp32_setup):
    tr, state, real_a, real_b = fp32_setup
    assert tr.remat and all(m.remat for m in state.g.model.modules() if isinstance(m, RRDB))
    off = CycleGANTrainer(net="1", pool_size=0, remat=False, device="cpu")
    state_off = copy.deepcopy(state)
    assert set_trunk_remat(state_off.g.model, False) == 2        # one RRDB per generator
    g_on, _ = grads_of(tr, state, real_a, real_b)
    g_off, _ = grads_of(off, state_off, real_a, real_b)
    assert float((g_on - g_off).norm() / g_off.norm()) <= 1e-6


def test_set_trunk_remat_is_instance_scoped():
    a = models.RDDBNetB(3, 3, 16, nb=2, gc=8, mode="x2")
    b = models.RDDBNetB(3, 3, 16, nb=2, gc=8, mode="x2")
    assert set_trunk_remat(a, True) == 2
    assert [m.remat for m in a.modules() if isinstance(m, RRDB)] == [True, True]
    assert [m.remat for m in b.modules() if isinstance(m, RRDB)] == [False, False]
    assert set_trunk_remat(models.NLayerDiscriminator(3), True) == 0


def test_bf16_step_keeps_fp32_masters(small_models):
    tr = CycleGANTrainer(net="1", pool_size=0, act_dtype=torch.bfloat16, device="cpu")
    state = tr.init(5)
    real_b = f32(6, N, HW, HW, 3)
    state, aux = tr.gd_step(state, real_b[:, ::2, ::2].contiguous(), real_b, 1e-4, 1e-5)
    assert aux["fake_B"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.g.model.parameters())
    assert all(bool(torch.isfinite(v)) for k, v in aux.items() if v.dim() == 0)


def test_both_ema_paths(fp32_setup):
    tr, state0, real_a, real_b = fp32_setup
    decay = 0.9
    s1 = copy.deepcopy(state0)
    ema1 = tr.ema_init(s1)
    start = {k: v.clone() for k, v in ema1.items()}
    s1, ema1, _ = tr.gd_step_ema(s1, ema1, real_a, real_b, 1e-4, 1e-5, decay)
    for name, p in s1.g.model.named_parameters():
        torch.testing.assert_close(ema1[name], decay * start[name] + (1 - decay) * p.detach(),
                                   rtol=0, atol=1e-6)
    pooled = CycleGANTrainer(net="1", pool_size=2, device="cpu")
    s2 = copy.deepcopy(state0)
    ema2 = pooled.ema_init(s2)
    s2, ema2, _ = pooled.optimize_parameters(s2, real_a, real_b, ema=ema2, ema_decay=decay)
    for name in ema1:          # the same G update: the pool only feeds D
        assert torch.equal(ema2[name], ema1[name]), name
    s3 = copy.deepcopy(state0)
    pools = pooled.device_pool_init(s3, real_a, real_b, seed=1)
    ema3 = pooled.ema_init(s3)
    s3, pools, ema3, _ = pooled.gd_step_pooled_ema(s3, pools, ema3, real_a, real_b,
                                                   1e-4, 1e-5, decay)
    for name in ema1:
        assert torch.equal(ema3[name], ema1[name]), name
    assert int(pools["A"]["n"]) == int(pools["B"]["n"]) == N


@pytest.mark.parametrize("seed", [0, 7])
def test_image_pool_bit_equal_to_jax(seed):
    """The same seed and image sequence, as tensors here and numpy arrays
    there, give the same images."""
    rng = np.random.default_rng(seed)
    ours, theirs = ImagePool(3, seed=seed), jcyc.ImagePool(3, seed=seed)
    for step in range(8):
        imgs = rng.uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
        got = ours.query(torch.from_numpy(imgs))
        np.testing.assert_array_equal(got.numpy(), theirs.query(imgs), err_msg=str(step))


def test_device_pool_semantics():
    """As tests/test_train.py checks the JAX device pool: the first
    pool_size images pass through, then each output is either its input or
    an image the pool held (which the input then replaced)."""
    gen = torch.Generator().manual_seed(0)
    pool = {"buf": torch.zeros(3, 2, 2, 1), "n": torch.zeros((), dtype=torch.int64)}
    fed = []
    for step in range(6):
        imgs = float(step * 2) + torch.arange(2.0).view(2, 1, 1, 1).expand(2, 2, 2, 1)
        pool, out = CycleGANTrainer._device_pool_query(pool, imgs, gen)
        for i in range(2):
            x, v = float(imgs[i, 0, 0, 0]), float(out[i, 0, 0, 0])
            assert v == x if len(fed) < 3 else (v == x or v in fed), (step, i)
            fed.append(x)
        assert torch.equal(out[:, 1:], out[:, :1].expand(2, 1, 2, 1))   # whole images
    assert int(pool["n"]) == 3
    assert all(float(v) in fed for v in pool["buf"][:, 0, 0, 0])
    assert len(set(fed) - {float(v) for v in pool["buf"][:, 0, 0, 0]}) == len(fed) - 3


def test_perceptual_params_raise_naming_a13():
    """perceptual_params (brought by ROADMAP A13) no longer raise: the G loss
    gains perceptual_weight x the VGG16 loss of both cycle reconstructions,
    computed in fp32, whose gradient reaches the generators only."""
    from srcgan_tpu_torch import losses_vgg

    vgg = losses_vgg.init_vgg_params(torch.Generator().manual_seed(0))
    with_term = CycleGANTrainer(net="SRdens", remat=False, perceptual_params=vgg,
                                perceptual_weight=2.0, device="cpu")
    plain = CycleGANTrainer(net="SRdens", remat=False, device="cpu")
    state = plain.init(0)
    real_a, real_b = (torch.rand(1, s, s, c, generator=torch.Generator().manual_seed(c))
                      for s, c in ((16, 1), (32, 3)))
    _, aux = with_term.g_grads(state, real_a, real_b)
    _, ref = plain.g_grads(state, real_a, real_b)
    term = 2.0 * (losses_vgg.vgg16_loss(vgg, aux["recl_A"], real_a)
                  + losses_vgg.vgg16_loss(vgg, aux["recl_B"], real_b))
    torch.testing.assert_close(aux["loss_G"], ref["loss_G"] + term, rtol=1e-6, atol=0)
    assert all(not t.requires_grad for p in with_term.perceptual_params.values()
               for t in p.values())


def test_lr_at_epoch_matches_jax():
    ours = CycleGANTrainer(num_epochs=10, device="cpu")
    theirs = jcyc.CycleGANTrainer(num_epochs=10)
    for e in (1, 5, 10):
        np.testing.assert_allclose(ours.lr_at_epoch(e), theirs.lr_at_epoch(e), rtol=1e-12)
    assert ours.adam_hparams == theirs.adam_hparams
