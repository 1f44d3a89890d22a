"""The port's MultiTaskTrainer against the JAX MultiTaskTrainer, and within the port.

Against JAX, in float64 at a matched point (the same parameters, inputs,
real_C and fakes on both sides), a small build (ngf 8, resnet_6blocks,
instance norm; G_C SRDenseNetA with 2 blocks of 2 layers; two
NLayerDiscriminator(., 64, 2)), batch 2 of 32^2 targets:

- the G gradients of the JAX ``g_step``, read off one step of plain SGD at
  learning rate 1 (an optax ``sgd`` in place of its Adam: gradient =
  parameters before - after, exact to ~1e-17 of the parameters in float64),
  within rel-L2 1e-6 as one vector, and the losses within 1e-6.  The JAX
  package takes instance-norm statistics in fp32 whatever the input dtype
  (the port keeps float64 ones for float64), and both run the G step's
  frozen discriminators in fp32, so those parts carry fp32 rounding
  (~8e-7 of the vector here; the images 1e-5);
- the D gradients: the JAX ``d_step`` casts its inputs to fp32, so the
  float64 yardstick is its loss, ``CycleGANTrainer.d_grads`` on the
  multi-task discriminators with real_C as D_B's real, within rel-L2 1e-6,
  with the BatchNorm running statistics it leaves; and the port's own
  ``d_step`` (fp32) against that gradient within 1e-5, its losses and
  statistics against the JAX ``d_step``'s within 1e-5.

The L1 terms' gradients are signs: no residual may lie within 1e-9 of zero.

Within the port (fp32): ``loss_G_C`` is no part of ``loss_G`` and G_C still
trains; ``pack_passes`` equals the unpacked step (1e-5) and ``norm="batch"``
forces it off; with ``norm="batch"`` a G step leaves the generators'
running statistics bit-unchanged; ``gd_step_pooled`` equals the host pools
while the pools fill; the bf16 step keeps fp32 masters; the schedule.
"""
import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from srcgan_tpu import config as jax_config
from srcgan_tpu.train import cyclegan as jcyc
from srcgan_tpu.train import multitask as jmt
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import interop
from srcgan_tpu_torch.train.multitask import MultiTaskTrainer

N, HW = 2, 32
SMALL = dict(ngf=8, netG="resnet_6blocks")


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


def batch(seed):
    """(realA, realB, real_C, fake_A, fake_B): float32-representable float64."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(0, 1, s).astype(np.float32).astype(np.float64)  # noqa: E731
    return (f(N, HW // 2, HW // 2, 1), f(N, HW, HW, 3), f(N, HW, HW, 1), f(N, HW, HW, 1),
            f(N, HW, HW, 3))


def flat_vector(tree):
    leaves = [np.asarray(v, np.float64).ravel()
              for _, v in sorted(jtu.tree_flatten_with_path(tree)[0], key=lambda kv: str(kv[0]))]
    return np.concatenate(leaves)


def tree_keys(tree):
    return sorted(jtu.keystr(p) for p, _ in jtu.tree_flatten_with_path(tree)[0])


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# The port's fp32 D step's SGD rate: large, so that the step dwarfs the
# parameters and (before - after) / rate keeps the gradient's fp32 digits.
D_RATE = 1e4


def sgd_grads(before, after, rate):
    """The gradient of one SGD step at learning rate ``rate``."""
    return {k: (before[k] - after[k]) / rate for k in before}


@pytest.fixture(scope="module")
def float64_pair():
    """(port, JAX, inputs): the G and the D half in float64 and the
    multi-task D step as it runs, in fp32."""
    tr = MultiTaskTrainer(device="cpu", **SMALL)
    state = port_state(tr)
    state32 = copy.deepcopy(state)
    real_a, real_b, real_c, fake_a, fake_b = batch(1)
    jtr = jmt.MultiTaskTrainer(remat=False, **SMALL)
    sgd = optax.inject_hyperparams(optax.sgd)(learning_rate=1.0)
    jtr.opt_g = jtr.opt_d = sgd
    # the D loss of the multi-task step with real_C as D_B's real, without
    # the step's cast of everything to fp32
    jd_loss = jcyc.CycleGANTrainer()
    jd_loss.netD_A, jd_loss.netD_B = jtr.netD_A, jtr.netD_B
    jax.config.update("jax_enable_x64", True)
    try:
        cast = lambda t: jtu.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        gp = cast(interop.jax_tree_from_module(state.g.model)[0])
        dp, ds = (cast(t) for t in interop.jax_tree_from_module(state.d.model))
        zero = jnp.zeros((), jnp.int32)
        jst = jcyc.CycleState(jstate.TrainState(gp, sgd.init(gp), zero),
                              jstate.TrainState(dp, sgd.init(dp), zero), ds)

        def both(st, ra, rb, rc, fa, fb):
            minus = lambda a, b: jtu.tree_map(jnp.subtract, a, b)  # noqa: E731
            g_st, aux = jmt.MultiTaskTrainer.g_step.__wrapped__(jtr, st, ra, rb, 1.0)
            d_st, dm = jmt.MultiTaskTrainer.d_step.__wrapped__(jtr, st, rc, rb, fa, fb, 1.0)
            return (minus(st.g.params, g_st.g.params), aux, jd_loss.d_grads(st, rc, rb, fa, fb),
                    (d_st.d_model_state, dm))

        # the three in one program: one compile, most of this file's time
        jg, jaux, (jd, (jla, jlb, jbn)), jstep = jax.device_get(jax.jit(both)(
            jst, *(jnp.asarray(v) for v in (real_a, real_b, real_c, fake_a, fake_b))))
    finally:
        jax.config.update("jax_enable_x64", False)
    state.g.model.double()
    state.d.model.double()
    t = [torch.from_numpy(v) for v in (real_a, real_b, real_c, fake_a, fake_b)]
    pg, paux = tr.g_grads(state, t[0], t[1])
    pd, (pla, plb, pbn) = tr.d_grads(state, t[2], t[1], t[3], t[4])
    # the port's multi-task D step (float64 inputs cast to fp32 inside), read the same way
    before = {k: p.detach().clone() for k, p in state32.d.model.named_parameters()}
    state32 = state32._replace(d=state32.d._replace(
        opt=torch.optim.SGD(state32.d.model.parameters(), lr=1.0)))
    state32, dm = tr.d_step(state32, t[2], t[1], t[3], t[4], D_RATE)
    step = sgd_grads(before, dict(state32.d.model.named_parameters()), D_RATE)
    ours = {"g": interop.jax_tree_from_module(state.g.model, pg)[0],
            "d": interop.jax_tree_from_module(state.d.model, pd)[0],
            "bn": interop.jax_tree_from_module(state.d.model, pbn)[1],
            "aux": paux, "loss_D": (float(pla), float(plb)),
            "step": (interop.jax_tree_from_module(state32.d.model, step)[0],
                     interop.jax_tree_from_module(state32.d.model)[1], dm)}
    want = {"g": jg, "d": jd, "bn": jbn, "aux": jaux, "loss_D": (float(jla), float(jlb)),
            "step": jstep}
    return ours, want, (real_a, real_b)


def test_float64_g_grads_match_jax(float64_pair):
    ours, want, (_, real_b) = float64_pair
    aux = ours["aux"]
    for img, ref in (("recl_A", aux["real_C"].numpy()), ("recl_B", real_b)):
        assert np.abs(aux[img].numpy() - ref).min() > 1e-9, img
    for k in ("loss_G", "loss_G_A", "loss_G_B", "loss_G_C", "loss_cycle_A", "loss_cycle_B"):
        np.testing.assert_allclose(float(aux[k]), float(want["aux"][k]), rtol=1e-6, err_msg=k)
    # the images carry the instance norms' fp32 statistics of both sides
    for k in MultiTaskTrainer._IMAGE_KEYS:
        assert rel_l2(aux[k].numpy(), np.asarray(want["aux"][k])) <= 1e-5, k
    assert tree_keys(ours["g"]) == tree_keys(want["g"])
    err = rel_l2(flat_vector(ours["g"]), flat_vector(want["g"]))
    assert err <= 1e-6, err


def test_float64_d_grads_and_bn_state_match_jax(float64_pair):
    ours, want, _ = float64_pair
    np.testing.assert_allclose(ours["loss_D"], want["loss_D"], rtol=1e-6)
    assert tree_keys(ours["d"]) == tree_keys(want["d"])
    err = rel_l2(flat_vector(ours["d"]), flat_vector(want["d"]))
    assert err <= 1e-6, err
    assert tree_keys(ours["bn"]) == tree_keys(want["bn"])
    np.testing.assert_allclose(flat_vector(ours["bn"]), flat_vector(want["bn"]),
                               rtol=1e-6, atol=1e-7)


def test_fp32_d_step_matches_jax(float64_pair):
    """The multi-task D step casts real_C, realB and the fakes to fp32 in
    both packages.  The port's step, its gradient read off SGD, against the
    JAX D loss's float64 gradient (rel-L2 1e-5), and its losses and
    statistics against the JAX step's (1e-5).  The JAX step's own fp32
    gradient is no yardstick: its D_B layers stray ~1.5e-3 from float64
    where the port's stay within 2e-6."""
    ours, want, _ = float64_pair
    (grads, bn, dm), (jbn, jdm) = ours["step"], want["step"]
    assert all(v.dtype == np.float32 for v in jtu.tree_leaves(grads))
    for k in ("loss_D_A", "loss_D_B"):
        np.testing.assert_allclose(float(dm[k]), float(jdm[k]), rtol=1e-5, err_msg=k)
    assert tree_keys(grads) == tree_keys(want["d"])
    err = rel_l2(flat_vector(grads), flat_vector(want["d"]))
    assert err <= 1e-5, err
    np.testing.assert_allclose(flat_vector(bn), flat_vector(jbn), rtol=1e-5, atol=1e-6)


# -- within the port ---------------------------------------------------------

def f32(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, shape)
                            .astype(np.float32))


@pytest.fixture(scope="module")
def fp32_setup():
    """(trainer, a fresh state, realA, realB) at the small build."""
    tr = MultiTaskTrainer(device="cpu", **SMALL)
    return tr, port_state(tr, 3), f32(2, N, HW // 2, HW // 2, 1), f32(3, N, HW, HW, 3)


def grads_of(tr, state, real_a, real_b):
    g, aux = tr.g_grads(state, real_a, real_b)
    return torch.cat([v.flatten() for v in g.values()]), aux


def test_loss_g_c_is_reported_not_trained(fp32_setup):
    tr, state, real_a, real_b = fp32_setup
    g, aux = tr.g_grads(state, real_a, real_b)
    parts = ("loss_G_A", "loss_G_B", "loss_cycle_A", "loss_cycle_B")
    assert torch.equal(aux["loss_G"], sum(aux[k] for k in parts))
    want = torch.mean((aux["real_C"].expand(real_b.shape) - real_b) ** 2)
    torch.testing.assert_close(aux["loss_G_C"], want)
    assert float(aux["loss_G_C"]) > 0
    g_c = torch.cat([v.flatten() for k, v in g.items() if k.startswith("G_C.")])
    assert float(g_c.norm()) > 0          # G_C trains through the cycle path


def test_pack_passes_equals_unpacked(fp32_setup):
    tr, state, real_a, real_b = fp32_setup
    packed = MultiTaskTrainer(pack_passes=True, device="cpu", **SMALL)
    assert packed.pack_passes
    g0, aux0 = grads_of(tr, state, real_a, real_b)
    g1, aux1 = grads_of(packed, state, real_a, real_b)
    assert float((g1 - g0).norm() / g0.norm()) <= 1e-5
    for k in MultiTaskTrainer._IMAGE_KEYS:
        np.testing.assert_allclose(aux1[k].numpy(), aux0[k].numpy(), rtol=1e-5, atol=1e-5)
    assert not MultiTaskTrainer(pack_passes=True, norm="batch", device="cpu").pack_passes
    assert not jmt.MultiTaskTrainer(pack_passes=True, norm="batch").pack_passes


def test_batch_norm_generators_keep_their_statistics():
    tr = MultiTaskTrainer(norm="batch", device="cpu", **SMALL)
    state = tr.init(4)
    stats = {k: v.clone() for k, v in state.g.model.named_buffers()}
    assert sum(k.endswith("running_mean") for k in stats) > 10
    params = {k: v.detach().clone() for k, v in state.g.model.named_parameters()}
    state, aux = tr.g_step(state, f32(5, N, 16, 16, 1), f32(6, N, HW, HW, 3), 1e-4)
    for k, v in state.g.model.named_buffers():
        assert torch.equal(stats[k], v), k
    assert any(not torch.equal(params[k], v) for k, v in state.g.model.named_parameters())
    assert all(bool(torch.isfinite(v)) for v in aux.values() if v.dim() == 0)


def test_device_pool_equals_host_pool_while_filling(fp32_setup):
    """While the pools fill, both pass the fakes through: the same updates."""
    tr, state0, real_a, real_b = fp32_setup
    host = MultiTaskTrainer(pool_size=4, device="cpu", **SMALL)
    dev = MultiTaskTrainer(pool_size=4, device="cpu", **SMALL)
    a, b = copy.deepcopy(state0), copy.deepcopy(state0)
    pools = dev.device_pool_init(b, real_a, real_b, seed=3)
    assert pools["A"]["buf"].shape == (4, HW, HW, 1) and pools["B"]["buf"].shape == (4, HW, HW, 3)
    for _ in range(2):
        a, aux_a = host.optimize_parameters(a, real_a, real_b, realB1=real_b[..., :1])
        b, pools, aux_b = dev.gd_step_pooled(b, pools, real_a, real_b, dev.lr, dev.d_lr)
        for k in aux_a:
            assert torch.equal(aux_a[k], aux_b[k]), k
    assert int(pools["A"]["n"]) == int(pools["B"]["n"]) == 4
    for r in ("g", "d"):
        pa, pb = (dict(getattr(s, r).model.state_dict()) for s in (a, b))
        assert all(torch.equal(pa[k], pb[k]) for k in pa), r
    assert (a.g.step, a.d.step) == (b.g.step, b.d.step) == (2, 2)


def test_bf16_step_keeps_fp32_masters():
    tr = MultiTaskTrainer(act_dtype=torch.bfloat16, device="cpu", **SMALL)
    state, aux = tr.optimize_parameters(tr.init(5), f32(6, 1, 16, 16, 1), f32(7, 1, HW, HW, 3))
    assert aux["fake_B"].dtype == aux["real_C"].dtype == torch.bfloat16
    assert aux["loss_G_C"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in state.g.model.parameters())
    assert all(bool(torch.isfinite(v)) for v in aux.values() if v.dim() == 0)


def test_lr_at_epoch_and_networks_match_jax():
    ours = MultiTaskTrainer(num_epochs=10, device="cpu")
    theirs = jmt.MultiTaskTrainer(num_epochs=10)
    for e in (1, 5, 10):
        np.testing.assert_allclose(ours.lr_at_epoch(e), theirs.lr_at_epoch(e), rtol=1e-12)
    state = ours.init(0)
    assert list(state.g.model) == ["G_A", "G_B", "G_C"]
    assert list(state.d.model) == ["D_A", "D_B"]
    counts = {k: sum(p.numel() for p in m.parameters()) for k, m in state.g.model.items()}
    for k, net in (("G_A", theirs.netG_A), ("G_B", theirs.netG_B), ("G_C", theirs.netG_C)):
        shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0))
        assert counts[k] == sum(int(np.prod(s.shape)) for s in jtu.tree_leaves(shapes)), k


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MultiTaskTrainer()
