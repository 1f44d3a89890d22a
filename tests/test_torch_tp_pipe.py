"""The port's 2-D meshes on four gloo ranks against the JAX package on
4-device meshes of the conftest's CPU devices: the (data, space) step, the
(data, model) tensor-parallel step and inference, the cascade pipeline, and
the trunk pipeline alone and with data parallelism.

The four ranks run once for the module (``parallel.launch`` of
``srcgan_tpu_torch.parallel.axes_check``), from the seeds of the models
built here, whose weights cross to JAX through ``interop``.  The steps take
ESPCN + ResDeconv x2 at 32^2, batch 4: the losses within rtol 1e-5 of JAX's,
each tensor's update within rel-L2 5e-2 of JAX's, or within 1.5 times the
rel-L2 by which the port's own one-process step already differs from JAX's
one-device step on that tensor, where that is larger.  Adam's first update
is +-lr wherever a gradient is reduction-order noise: the ResDeconv's fp32
gradients differ between the two frameworks by rel-L2 ~2e-3 on one device
(its first norm's bias, for one), enough to flip the sign of a few near-zero
elements, so one process already misses 5e-2 on such tensors.  What the
mesh must not add is held by the float64 gradients at the initial state,
within rel-L2 1e-6 of one process's on the whole batch: the matched-point
comparison of tests/test_training_dynamics.py, gradients at one parameter
point rather than updates.  The inference forms hold atol 2e-5, rtol 1e-4;
the cascade pipeline holds atol 1e-5, rtol 1e-4 against the port's own
stages run in turn, and JAX's pipeline within 1e-5 of the output's largest
magnitude (the two frameworks' fp32 colorizers differ by that much); the
trunk pipeline's float64 ring gradients hold rel-L2 1e-6 against JAX's
``make_trunk_pipeline_train`` gradients.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from srcgan_tpu import config as jax_config
from srcgan_tpu import models as jmodels
from srcgan_tpu import parallel as jparallel
from srcgan_tpu.models import rddb as jrddb
from srcgan_tpu.train import cas as jcas
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import interop, parallel
from srcgan_tpu_torch.parallel import axes_check


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
    return axes_check.make_problem()


@pytest.fixture(scope="module")
def ranks(problem):
    return axes_check.run_ranks(problem, 4, device="cpu")


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def flat(tree):
    return {jtu.keystr(p): np.asarray(v, np.float64) for p, v in
            jtu.tree_flatten_with_path(tree)[0]}


def port_tree(ranks, prefix, model):
    """The ranks' tensors ``<prefix>/<name>`` in the JAX tree layout."""
    cut = len(prefix) + 1
    named = {k[cut:]: torch.from_numpy(v) for k, v in ranks.items()
             if k.startswith(prefix + "/")}
    return interop.jax_tree_from_module(model, named)[0]


# -- the (data, space) and (data, model) steps ----------------------------------

@pytest.fixture(scope="module")
def cas(problem):
    """(port trainer, its initial state, the JAX trainer, the JAX state of the
    same weights, the JAX batch)."""
    tr = axes_check.cas_trainer("cpu")
    state = tr.init(axes_check.SEEDS["cas"])
    jtr = jcas.CasTrainer(sr_model="ESPCN", c_model="ResDeconv", up=2, lr=axes_check.CAS_LR)

    def ts(model):
        params = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(model)[0])
        return jstate.TrainState(params, jtr.opt.init(params), jnp.zeros((), jnp.int32))

    jst = jcas.CasState(ts(state.sr.model), ts(state.c.model), jtr.netG_A2C.init_state(),
                        jtr.netG_C2B.init_state())
    return tr, state, jtr, jst, (jnp.asarray(problem["realA"]), jnp.asarray(problem["realB"]))


@pytest.fixture(scope="module")
def grads64(cas, problem):
    """One process's float64 gradients on the whole batch, by role and name."""
    tr = axes_check.cas_trainer("cpu")
    state = tr.init(axes_check.SEEDS["cas"])
    for ts in state:
        ts.model.double()
    g, _, _ = tr.grads(state, torch.from_numpy(problem["realA"]).double(),
                       torch.from_numpy(problem["realB"]).double())
    return {f"{role}/{k}": v.numpy() for role, named in g.items() for k, v in named.items()}


STEPS = {"2d": (("data", "space"), jparallel.make_cas_2d_step),
         "tp": (("data", "model"), jparallel.make_cas_tp_step)}


@pytest.fixture(scope="module")
def one_device(cas, problem):
    """(JAX's one-device state after one step, per role and tensor the
    rel-L2 of the port's one-process update against it)."""
    tr, _, jtr, jst, (realA, realB) = cas
    state = tr.init(axes_check.SEEDS["cas"])
    start = {r: flat(interop.jax_tree_from_module(ts.model)[0]) for r, ts in zip("sc", state)}
    state, _ = tr.train_step(state, problem["realA"], problem["realB"], axes_check.CAS_LR)
    jst1, _ = jtr.train_step(jtu.tree_map(jnp.array, jst), realA, realB, axes_check.CAS_LR)
    out = {}
    for r, ts, jts, role in zip("sc", state, (jst1.sr, jst1.c), ("sr", "c")):
        port, want = flat(interop.jax_tree_from_module(ts.model)[0]), flat(jts.params)
        out[role] = {k: rel_l2(port[k] - start[r][k], want[k] - start[r][k]) for k in want}
    return jst1, out


@pytest.mark.parametrize("run", list(STEPS))
def test_step_matches_jax_mesh(ranks, cas, one_device, run):
    """The losses against JAX's step on its mesh of the same shape; the
    updates against JAX's tensor-parallel step, and for the (data, space)
    step against JAX's one-device step: JAX's GSPMD (data, space) step
    moves the colorizer's norm parameters by up to rel-L2 0.9 from its own
    one-device step (PERF.md), where the port's matches one process."""
    tr, state, jtr, jst, (realA, realB) = cas
    axes, make = STEPS[run]
    jmesh = jparallel.make_mesh((2, 2), axes)
    jst2, jm = make(jtr, jmesh)(jparallel.put_replicated(jtu.tree_map(jnp.array, jst), jmesh),
                                realA, realB, axes_check.CAS_LR)
    for k in ("loss_SR", "loss_C"):
        np.testing.assert_allclose(ranks[f"{run}/metric/{k}"], np.asarray(jm[k]), rtol=1e-5,
                                   err_msg=f"{run} {k}")
    ref, gap = one_device
    if run == "2d":
        jst2 = ref
    for role, ts, jts in (("sr", state.sr, jst2.sr), ("c", state.c, jst2.c)):
        start = flat(interop.jax_tree_from_module(ts.model)[0])
        after = flat(port_tree(ranks, f"{run}/{role}", ts.model))
        want = flat(jts.params)
        assert after.keys() == want.keys() and want
        for k in want:
            err = rel_l2(after[k] - start[k], want[k] - start[k])
            assert err <= max(5e-2, 1.5 * gap[role][k]), (run, role, k, err)


@pytest.mark.parametrize("run", list(STEPS))
def test_step_float64_gradients_match_one_process(ranks, grads64, run):
    keys = [k for k in ranks if k.startswith(f"{run}/g64/")]
    assert len(keys) == len(grads64)
    for k in keys:
        name = k[len(f"{run}/g64/"):]
        err = rel_l2(ranks[k], grads64[name])
        assert err <= 1e-6, (run, name, err)


def test_tp_ranks_hold_half_of_each_split_layer(ranks, cas):
    """Each rank keeps 1/2 of every split parameter; the replicated ones
    (the 1- and 3-channel output convs, the norms) whole."""
    tr, state = cas[:2]
    mesh = type("M", (), {"size": lambda self, axis: 2})()
    for role, ts in (("sr", state.sr), ("c", state.c)):
        split = parallel.tp_param_shardings(ts.model, mesh)
        sizes = dict((n, p.numel()) for n, p in ts.model.named_parameters())
        want = sum(n // 2 if split[k] is not None else n for k, n in sizes.items())
        held, whole = ranks[f"tp/held/{role}"]
        assert whole == sum(sizes.values()) and held == want
        assert any(d is not None for d in split.values())


def test_tp_infer_matches_jax(ranks, problem):
    m = jmodels.RDDBNet(1, 1, 4, nf=16, nb=1)
    p = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(axes_check.build("rddb"))[0])
    with jrddb.no_pallas_tail():
        want = m.fwd(p, jnp.asarray(problem["tp_x"]))
    np.testing.assert_allclose(ranks["tp/infer"], np.asarray(want), atol=2e-5, rtol=1e-4)


# -- the pipelines ---------------------------------------------------------------

def test_cascade_pipeline_matches_jax(ranks, problem):
    sr, col = jmodels.ESPCN(1, 1, 2), jmodels.ResDeconv(1, 3)
    p0 = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(axes_check.build("cas_sr"))[0])
    p1 = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(axes_check.build("cas_c"))[0])
    mesh = jparallel.make_mesh((2,), ("pipe",))
    want = jparallel.make_cascade_pipeline_infer(
        lambda p, v: sr.fwd(p, v), lambda p, v: col.fwd(p, v), mesh)(
        p0, p1, jnp.asarray(problem["pipe_x"]))
    got, want = ranks["pipe/cascade"], np.asarray(want)
    assert got.shape == want.shape == (3, 2, 16, 16, 3)
    psr, pc = axes_check.build("cas_sr"), axes_check.build("cas_c")
    with torch.no_grad():
        turns = np.stack([pc(psr(axes_check.nchw(x, "cpu"))).permute(0, 2, 3, 1).numpy()
                          for x in problem["pipe_x"]])
    np.testing.assert_allclose(got, turns, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=1e-4)
    assert "size 2" in str(ranks["pipe/refused"])


def test_trunk_pipeline_infer_matches_jax(ranks, problem):
    m = jmodels.RDDBNet(1, 1, 2, nf=16, nb=2)
    p = jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(axes_check.build("trunk"))[0])
    mesh = jparallel.make_mesh((2,), ("pipe",))
    want = jparallel.make_rddb_trunk_pipeline_infer(m, mesh)(p, jnp.asarray(problem["trunk_x"]))
    np.testing.assert_allclose(ranks["trunk/infer"], np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("run", ["trunk", "trunk_dp"])
def test_trunk_pipeline_float64_grads_match_jax(ranks, problem, run):
    """The hand-scheduled GPipe backward against JAX's ring gradients, on a
    pipe axis of 2 (and with the samples sharded over data 2)."""
    m = jmodels.RDDBNet(1, 1, 2, nf=16, nb=2)
    model = axes_check.build("trunk")
    jax.config.update("jax_enable_x64", True)
    try:
        p = jtu.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                         interop.jax_tree_from_module(model)[0])
        if run == "trunk":
            mesh, kw = jparallel.make_mesh((2,), ("pipe",)), {}
        else:
            mesh, kw = jparallel.make_mesh((2, 2), ("pipe", "data")), {"data_axis": "data"}
        _, _, grads = jparallel.make_trunk_pipeline_train(m, mesh, **kw)
        pair = jparallel.place_trunk_pipeline_params(p, mesh)
        xq = jnp.asarray(problem["trunk_x"], jnp.float64)
        yq = jnp.asarray(problem["trunk_y"], jnp.float64)
        loss, g_ht, g_sp = grads(pair, xq, yq)
        g_ht, g_sp, loss = jax.device_get((g_ht, g_sp, loss))
    finally:
        jax.config.update("jax_enable_x64", False)
    want = dict(g_ht, trunk={str(s): jtu.tree_map(lambda a: a[s], g_sp) for s in range(2)})
    got = flat(port_tree(ranks, f"{run}/g", model))
    want = flat(want)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(ranks[f"{run}/loss"], loss, rtol=1e-10)
    for k in want:
        assert rel_l2(got[k], want[k]) <= 1e-6, (run, k, rel_l2(got[k], want[k]))


def test_trunk_pipeline_adam_steps_descend(ranks):
    losses = ranks["trunk/adam_losses"]
    assert losses[-1] < losses[0]
