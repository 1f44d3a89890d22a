"""The port's data axis on two gloo ranks against the JAX package on a
2-device mesh of the conftest's CPU devices.

The two ranks run once for the module (``parallel.launch`` of
``srcgan_tpu_torch.parallel.steps_check``: the workers import the port
alone), from the same seeds as the port states built here, whose weights
cross to JAX through ``interop``.  Each case then holds one of the ranks'
results against the JAX step on the same weights and batch, with
tests/test_torch_train.py's fp32 bounds: metrics rtol 1e-5 (the GAN's
losses 1e-4: its fakes pass a discriminator twice), each tensor's update
within rel-L2 5e-2.  The cascade is ESPCN x2 + SRCNN at 16^2 targets,
batch 4; the CycleGAN the SRDenseNet pair at 32^2, batch 4, remat off, its
PatchGANs' BatchNorm on the global batch (its running statistics within
1e-5 of JAX's GSPMD step and of one port process on the whole batch).  The
step directories: the ranks' ZeRO-1 and FSDP round trips, and a plain state
in one process without a process group.  ``steps_check.compare`` holds the
ranks against the plain steps in one process on the whole batch as well.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.sharding import NamedSharding, PartitionSpec as P

from srcgan_tpu import config as jax_config
from srcgan_tpu import parallel as jparallel
from srcgan_tpu.train import cas as jcas
from srcgan_tpu.train import cyclegan as jcyc
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import interop, parallel
from srcgan_tpu_torch.parallel import steps_check
from srcgan_tpu_torch.train.cyclegan import ImagePool

from srcgan_tpu_torch.parallel.steps_check import (CAS_SEED, D_LR, G_LR, GAN_SEED, K, LR,
                                                   POOL)


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


@pytest.fixture(scope="module")
def problem():
    return steps_check.make_problem(2)


@pytest.fixture(scope="module")
def ranks(problem):
    """The two ranks' results, run once."""
    return steps_check.run_ranks(problem, 2, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jparallel.make_mesh((2,), ("data",))


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def port_params(ranks, run, role):
    cut = len(f"{run}/{role}/")
    return {k[cut:]: v for k, v in ranks.items() if k.startswith(f"{run}/{role}/")}


def assert_updates(ranks, run, before_model, role, jparams, model):
    """Each tensor's update (after - before) within rel-L2 5e-2 of JAX's."""
    start = interop.jax_tree_from_module(before_model)[0]
    after = interop.jax_tree_from_module(model, {
        k: torch.from_numpy(v) for k, v in port_params(ranks, run, role).items()})[0]
    flat = lambda t: {jtu.keystr(p): np.asarray(v, np.float64)  # noqa: E731
                      for p, v in jtu.tree_flatten_with_path(t)[0]}
    a, s, w = flat(after), flat(start), flat(jparams)
    assert a.keys() == w.keys() and len(w) > 0
    for k in w:
        err = rel_l2(a[k] - s[k], w[k] - s[k])
        assert err <= 5e-2, (run, role, k, err)


def assert_metrics(ranks, run, jm, keys, rtol=1e-5):
    for k in keys:
        np.testing.assert_allclose(ranks[f"{run}/metric/{k}"], np.asarray(jm[k]), rtol=rtol,
                                   err_msg=f"{run} {k}")


# -- the cascade ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cas():
    """(port trainer, its initial state, JAX trainer, the JAX state of the
    same weights)."""
    tr = steps_check.cas_trainer(LR, "cpu")
    state = tr.init(CAS_SEED)
    jtr = jcas.CasTrainer(sr_model="ESPCN", c_model="SRCNN", up=2, lr=LR)

    def ts(model):
        params = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(model)[0])
        return jstate.TrainState(params, jtr.opt.init(params), jnp.zeros((), jnp.int32))

    jst = jcas.CasState(ts(state.sr.model), ts(state.c.model), jtr.netG_A2C.init_state(),
                        jtr.netG_C2B.init_state())
    return tr, state, jtr, jst


CAS_METRICS = ("loss_SR", "loss_C", "psnr_SR", "psnr_C")


def _cas_check(ranks, run, cas, jst_after, jm):
    tr, state, _, _ = cas
    assert_metrics(ranks, run, jm, CAS_METRICS)
    for role in ("sr", "c"):
        model = getattr(state, role).model
        assert_updates(ranks, run, model, role, getattr(jst_after, role).params, model)


def _fresh(jst):
    return jtu.tree_map(jnp.array, jst)


def test_cas_dp_step_matches_jax_mesh(ranks, problem, cas, jmesh):
    _, _, jtr, jst = cas
    step = jparallel.make_cas_dp_step(jtr, jmesh)
    st = jparallel.put_replicated(_fresh(jst), jmesh)
    a, b = (jparallel.put_batch(jnp.asarray(problem[k]), jmesh) for k in ("realA", "realB"))
    st, jm = step(st, a, b, LR)
    _cas_check(ranks, "dp", cas, st, jm)


def test_cas_dp_steps_u8_matches_jax_mesh(ranks, problem, cas, jmesh):
    _, _, jtr, jst = cas
    steps = jparallel.make_cas_dp_steps_u8(jtr, jmesh)
    sh = NamedSharding(jmesh, P(None, "data"))
    st, jm = steps(jparallel.put_replicated(_fresh(jst), jmesh),
                   jax.device_put(jnp.asarray(problem["src_k"]), sh),
                   jax.device_put(jnp.asarray(problem["tar_k"]), sh), LR)
    assert ranks["dp_u8/metric/loss_SR"].shape == (K,)
    _cas_check(ranks, "dp_u8", cas, st, jm)


def test_cas_zero1_step_matches_jax_mesh(ranks, problem, cas, jmesh):
    tr, state, jtr, jst = cas
    step = jparallel.make_cas_zero1_step(jtr, jmesh)
    st = jparallel.zero1_from_state(_fresh(jst), jmesh)
    a, b = (jparallel.put_batch(jnp.asarray(problem[k]), jmesh) for k in ("realA", "realB"))
    st, jm = step(st, a, b, LR)
    _cas_check(ranks, "zero1", cas, st, jm)
    # a rank holds its half of one flat vector a network, and says so
    n = sum(p.numel() for p in state.sr.model.parameters())
    assert int(ranks["zero1/rows"][0]) == -(-n // 2)
    assert int(ranks["zero1/opt_bytes"][0]) == 2 * -(-n // 2) * 4


def test_cas_fsdp_step_matches_jax_mesh(ranks, problem, cas, jmesh):
    tr, state, jtr, jst = cas
    fst, shapes = jparallel.fsdp_from_state(_fresh(jst), jmesh)
    step = jparallel.make_cas_fsdp_step(jtr, jmesh, shapes)
    a, b = (jparallel.put_batch(jnp.asarray(problem[k]), jmesh) for k in ("realA", "realB"))
    fst, jm = step(fst, a, b, LR)
    full = jcas.CasState(
        jstate.TrainState(jparallel.fsdp_full_params(fst.sr.params, shapes["sr"]), None, 0),
        jstate.TrainState(jparallel.fsdp_full_params(fst.c.params, shapes["c"]), None, 0),
        None, None)
    _cas_check(ranks, "fsdp", cas, full, jm)
    assert int(ranks["fsdp/held"][0]) == 0          # no parameter storage at rest


def test_checkpoint_round_trip_and_max_to_keep(ranks):
    """The ZeRO-1 state saved at steps 1-3 with max_to_keep=2 keeps 2 and 3
    and restores bit-equal (rows, both moments, count, step, extra); the
    FSDP state restores bit-equal."""
    assert ranks["orbax/steps"].tolist() == [2, 3]
    assert ranks["orbax/zero1_equal"].all()
    assert ranks["orbax/fsdp_equal"].all()


def test_plain_state_round_trip_in_one_process(tmp_path):
    """Without a process group: a trained plain state (parameters, Adam's
    moments, count, lr and steps) through save_train_state_orbax and
    load_train_state_orbax, bit-equal, into a fresh state."""
    from srcgan_tpu_torch.train.orbax_io import load_train_state_orbax, save_train_state_orbax

    tr = steps_check.cas_trainer(LR, "cpu")
    state, _ = tr.train_step(tr.init(0), torch.zeros(2, 16, 16, 1), torch.rand(2, 16, 16, 3),
                             2e-3)
    save_train_state_orbax(str(tmp_path), 7, state, {"epoch": 4})
    got, extra = load_train_state_orbax(str(tmp_path), tr.init(1))
    assert extra == {"epoch": 4} and got.sr.step == got.c.step == 1
    for role in ("sr", "c"):
        a, b = getattr(state, role), getattr(got, role)
        assert b.opt.param_groups[0]["lr"] == 2e-3
        for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
            assert torch.equal(p, q), n
            sa, sb = a.opt.state[p], b.opt.state[q]
            assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


# -- the CycleGAN ----------------------------------------------------------------

@pytest.fixture(scope="module")
def gan():
    def make(pool_size):
        tr = steps_check.gan_trainer(pool_size, "cpu")
        state = tr.init(GAN_SEED)
        jtr = jcyc.CycleGANTrainer(net="SRdens", mode="x2", pool_size=pool_size, remat=False)
        gp = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(state.g.model)[0])
        dp, ds = (jtu.tree_map(jnp.asarray, t)
                  for t in interop.jax_tree_from_module(state.d.model))
        jst = jcyc.CycleState(
            jstate.TrainState(gp, jtr.opt_g.init(gp), jnp.zeros((), jnp.int32)),
            jstate.TrainState(dp, jtr.opt_d.init(dp), jnp.zeros((), jnp.int32)), ds)
        return tr, state, jtr, jst

    return make


GAN_METRICS = ("loss_G", "loss_D_A", "loss_D_B")


def _gan_check(ranks, run, state, jst, jaux):
    assert_metrics(ranks, run, jaux, GAN_METRICS, rtol=1e-4)
    for role, jparams in (("g", jst.g.params), ("d", jst.d.params)):
        model = getattr(state, role).model
        for net in jparams:
            sub = {k[len(net) + 1:]: v for k, v in port_params(ranks, run, role).items()
                   if k.startswith(net + ".")}
            ranks_sub = {f"{run}/{role}/{k}": v for k, v in sub.items()}
            assert_updates(ranks_sub, run, model[net], role, jparams[net], model[net])
    got = {k.split("/d_state/")[1]: v for k, v in ranks.items()
           if k.startswith(f"{run}/d_state/") and not k.endswith("num_batches_tracked")}
    want = interop.state_dict_from_jax(state.d.model, jst.d.params, jst.d_model_state)
    assert got.keys() <= want.keys() and len(got) > 0
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_gan_dp_iteration_matches_jax_mesh(ranks, problem, gan, jmesh):
    """One optimize_parameters iteration through the host pools: G step, the
    pools' draws on the global fakes, D step (JAX: GSPMD on the mesh)."""
    tr, state, jtr, jst = gan(POOL)
    g_step, d_step = jparallel.make_cyclegan_dp_steps(jtr, jmesh)
    st = jparallel.put_replicated(jst, jmesh)
    a, b = jnp.asarray(problem["ganA"]), jnp.asarray(problem["ganB"])
    st, aux = g_step(st, a, b, G_LR)
    fake_a = jtr.fake_A_pool.query(np.asarray(aux["fake_A"]))
    fake_b = jtr.fake_B_pool.query(np.asarray(aux["fake_B"]))
    st, dm = d_step(st, a, b, jnp.asarray(fake_a), jnp.asarray(fake_b), D_LR)
    aux.update(dm)
    _gan_check(ranks, "gan_dp", state, st, aux)
    # the pool drew on the gathered global batch as one process would
    gathered = ranks["gan_dp/fake_A_global"]
    np.testing.assert_allclose(gathered, np.asarray(aux["fake_A"]), rtol=1e-4, atol=1e-5)
    want = ImagePool(POOL).query(torch.from_numpy(gathered)).numpy()
    np.testing.assert_array_equal(ranks["gan_dp/fake_A_pooled"], want)


def test_two_ranks_match_one_process(ranks, problem):
    """steps_check's own comparison: every run of the two ranks against the
    plain steps in one process on the whole batch (losses, updates, and the
    D step's running statistics: the global batch's, where each rank's own
    half would give others)."""
    rows = steps_check.compare(ranks, steps_check.one_process(problem, "cpu"))
    assert len(rows) == 2 * len(steps_check.RUNS) + 2
    for what, err, bound in rows:
        assert err <= bound, (what, err, bound)


def test_gd_zero1_step_matches_jax_mesh(ranks, problem, gan, jmesh):
    tr, state, jtr, jst = gan(0)
    step = jparallel.make_gd_zero1_step(jtr, jmesh)
    st = jparallel.zero1_gd_from_state(jst, jmesh)
    st, aux = step(st, jnp.asarray(problem["ganA"]), jnp.asarray(problem["ganB"]), G_LR, D_LR)
    _gan_check(ranks, "gan_zero1", state, st, aux)


def test_mesh_rules():
    """What a mesh refuses: another axis, a size without processes."""
    with pytest.raises(NotImplementedError, match="A14"):
        parallel.make_mesh((2, 2), ("data", "space"), device="cpu")
    if "WORLD_SIZE" not in os.environ:
        with pytest.raises(ValueError, match="processes"):
            parallel.make_mesh((2,), device="cpu")
    padded, n = parallel.pad_batch_to(np.arange(5)[:, None], 4)
    assert padded.shape == (8, 1) and n == 5 and (padded[5:] == 4).all()
