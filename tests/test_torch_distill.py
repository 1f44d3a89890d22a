"""The port's DistillTrainer against the JAX DistillTrainer, from the same
weights, and within the port.

Teacher: RDDBNet(1,1,2) at nf=16, nb=1, gc=8 and an SRCNN(1,3) colorizer;
student: ESPCN x2 and SRCNN(1,3); 32^2 targets, batch 2; the weights start
in the port (seeded torch generators) and cross to JAX through ``interop``.
Bounds as tests/test_torch_train.py's: one fp32 uint8 step, losses rtol
1e-5 and each tensor's update within rel-L2 5e-2; float64 gradients of
each stage's distillation loss (alpha 0.3) at a matched point, per layer
rel-L2 <= 3e-5 (no residual where the output is live lies within 1e-9 of
zero, where an L1 sign could differ).  Within the port: alpha=1 is bit for bit the CasTrainer
step and never runs the teacher; the teacher is frozen, in eval mode, cast
once under act_dtype with its BatchNorm statistics in fp32; the checkpoint
checks of ``from_checkpoints``; the train_cas flags.
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
from srcgan_tpu.train import DistillTrainer as JaxDistillTrainer
from srcgan_tpu.train import cas as jcas
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.cli import train_cas
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.train.cas import CasTrainer
from srcgan_tpu_torch.train.distill import DistillTrainer
from srcgan_tpu_torch.train.state import checkpoint_name, save_params

SMALL = dict(nf=16, nb=1, gc=8)
N, HW, LR, ALPHA = 2, 32, 1e-4, 0.3
STUDENT = dict(sr_model="ESPCN", c_model="SRCNN", up=2, lr=LR)


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


def teacher_modules(seed=7):
    g = torch.Generator().manual_seed(seed)
    return (models.RDDBNet(1, 1, 2, **SMALL, generator=g),
            models.create("SRCNN", 1, 3, generator=g))


def jax_tree(model):
    return jtu.tree_map(jnp.asarray, interop.jax_tree_from_module(model)[0])


@pytest.fixture(scope="module")
def pair():
    """(port trainer, its initial state, JAX trainer, the JAX state)."""
    t_sr, t_c = teacher_modules()
    jt_sr, jt_c = jax_models.RDDBNet(1, 1, 2, **SMALL), jax_models.SRCNN(1, 3)
    jtr = JaxDistillTrainer(jt_sr, jax_tree(t_sr), jt_c, jax_tree(t_c), alpha=ALPHA,
                            teacher_sr_state={}, teacher_c_state={}, **STUDENT)
    tr = DistillTrainer(t_sr, t_c, alpha=ALPHA, device="cpu", **STUDENT)
    state = tr.init(0)

    def ts(model):
        params = jax_tree(model)
        return jstate.TrainState(params, jtr.opt.init(params), jnp.zeros((), jnp.int32))

    jst = jcas.CasState(ts(state.sr.model), ts(state.c.model), {}, {})
    return tr, state, jtr, jst


def u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def flat(tree):
    return {jtu.keystr(p): np.asarray(v, np.float64)
            for p, v in jtu.tree_flatten_with_path(tree)[0]}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_fp32_distill_step_matches_jax(pair):
    tr, state0, jtr, jst = pair
    state = copy.deepcopy(state0)
    before = {r: interop.jax_tree_from_module(getattr(state, r).model)[0] for r in ("sr", "c")}
    src, tar = u8(1, N, HW, HW, 3), u8(2, N, HW, HW, 3)
    jst, jm = jtr.train_step_u8(jtu.tree_map(jnp.array, jst), jnp.asarray(src),
                                jnp.asarray(tar), LR)
    state, m = tr.train_step_u8(state, torch.from_numpy(src), torch.from_numpy(tar), LR)
    for k in ("loss_SR", "loss_C", "psnr_SR", "psnr_C"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for role, jparams in (("sr", jst.sr.params), ("c", jst.c.params)):
        after = flat(interop.jax_tree_from_module(getattr(state, role).model)[0])
        start, want = flat(before[role]), flat(jparams)
        for k in want:
            err = rel_l2(after[k] - start[k], want[k] - start[k])
            assert err <= 5e-2, (role, k, err)


def test_float64_distill_gradients_match_jax(pair):
    """Each stage's blended loss, _stage_loss(student(x), target,
    teacher(x)), differentiated in float64 on both sides: the teachers'
    outputs, the students' backward and the blend."""
    tr, state, jtr, jst = pair
    rng = np.random.default_rng(3)
    real_bc = rng.uniform(0, 1, (N, HW, HW, 1))
    tgt_b = rng.uniform(0, 1, (N, HW, HW, 3))
    real_ba = rng.uniform(0, 1, (N, HW // 2, HW // 2, 1))
    jax.config.update("jax_enable_x64", True)
    try:
        to64 = lambda t: jtu.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        jtr64 = JaxDistillTrainer(jtr.teacher_sr, to64(jtr.teacher_sr_params), jtr.teacher_c,
                                  to64(jtr.teacher_c_params), alpha=ALPHA,
                                  teacher_sr_state={}, teacher_c_state={}, **STUDENT)
        kd_sr, kd_c = jtr64._distill_targets(jnp.asarray(real_ba), jnp.asarray(real_bc))

        def stage(net, x, t, kd):
            def loss(p):
                y, _ = net.apply(p, jnp.asarray(x), state={}, train=True)
                return jtr64._stage_loss(y, jnp.asarray(t), kd)
            return loss

        want = {"sr": jax.jit(jax.grad(stage(jtr.netG_A2C, real_ba, real_bc, kd_sr)))(
                    to64(jst.sr.params)),
                "c": jax.jit(jax.grad(stage(jtr.netG_C2B, real_bc, tgt_b, kd_c)))(
                    to64(jst.c.params))}
        kd = {"sr": np.asarray(kd_sr), "c": np.asarray(kd_c)}
    finally:
        jax.config.update("jax_enable_x64", False)

    tr64 = DistillTrainer(copy.deepcopy(tr.teacher_sr).double(),
                          copy.deepcopy(tr.teacher_c).double(), alpha=ALPHA, device="cpu",
                          **STUDENT)
    got_sr, got_c = tr64._distill_targets(torch.from_numpy(real_ba), torch.from_numpy(real_bc))
    for role, got in (("sr", got_sr), ("c", got_c)):
        assert rel_l2(got.double().numpy(), kd[role]) <= 1e-12
    for role, x, t in (("sr", real_ba, real_bc), ("c", real_bc, tgt_b)):
        net64 = copy.deepcopy(getattr(state, role).model).double().train()
        y = to_nhwc(net64(to_nchw(torch.from_numpy(x))))
        t_, kd_ = torch.from_numpy(t.copy()), torch.from_numpy(kd[role].copy())
        # where SRCNN's last ReLU is off no sign reaches a parameter
        live = (y != 0).detach()
        assert float(torch.minimum((y - t_).abs(), (y - kd_).abs())[live].min()) > 1e-9
        loss = tr64._stage_loss(y, t_, kd_)
        names, params = zip(*net64.named_parameters())
        got = dict(zip(names, torch.autograd.grad(loss, params)))
        ours, ref = flat(interop.jax_tree_from_module(net64, got)[0]), flat(want[role])
        assert ours.keys() == ref.keys()
        err = max(rel_l2(ours[k], ref[k]) for k in ref)
        assert err <= 3e-5, (role, err)


def test_alpha1_is_bitwise_castrainer_and_skips_the_teacher(pair):
    tr, _, _, _ = pair
    t_sr, t_c = teacher_modules()
    dist = DistillTrainer(t_sr, t_c, alpha=1.0, device="cpu", **STUDENT)
    dist.teacher_sr.forward = dist.teacher_c.forward = None      # never called
    base = CasTrainer(device="cpu", **STUDENT)
    s_b, s_d = base.init(5), dist.init(5)
    for seed in (11, 12):
        src, tar = (torch.from_numpy(u8(seed + i, N, HW, HW, 3)) for i in (0, 100))
        s_b, m_b = base.train_step_u8(s_b, src, tar, 1e-3)
        s_d, m_d = dist.train_step_u8(s_d, src, tar, 1e-3)
        assert all(torch.equal(m_b[k], m_d[k]) for k in m_b)
    for role in ("sr", "c"):
        for (n, a), (_, b) in zip(getattr(s_b, role).model.named_parameters(),
                                  getattr(s_d, role).model.named_parameters()):
            assert torch.equal(a, b), (role, n)


def test_teacher_is_frozen_and_cast_once():
    g = torch.Generator().manual_seed(1)
    t_c = models.ResDeconv(1, 3, BN="BN", generator=g)
    t_sr = models.create("ESPCN", 1, 1, 2, generator=g)
    tr = DistillTrainer(t_sr, t_c, device="cpu", act_dtype=torch.bfloat16, **STUDENT)
    for net in (tr.teacher_sr, tr.teacher_c):
        assert not net.training
        assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in net.parameters())
    stats = [b for n, b in tr.teacher_c.named_buffers() if "running" in n]
    assert stats and all(b.dtype == torch.float32 for b in stats)
    x = torch.rand(1, 8, 8, 1, generator=g)
    with torch.enable_grad():
        y_sr, y_c = tr._distill_targets(x.bfloat16(), x.bfloat16())
    assert y_sr.dtype == y_c.dtype == torch.float32
    assert not y_sr.requires_grad and not y_c.requires_grad
    with pytest.raises(ValueError, match="alpha"):
        DistillTrainer(t_sr, t_c, alpha=1.5, device="cpu", **STUDENT)


@pytest.fixture(scope="module")
def teacher_files(tmp_path_factory):
    """A saved teacher pair per case: (x2 RGB), (x4 RGB), (x2 LAB), and a
    colorizer saved under the SR role."""
    d = tmp_path_factory.mktemp("teacher")
    g = torch.Generator().manual_seed(2)
    files = {}
    for tag, up, lab in (("x2", 2, False), ("x4", 4, False), ("lab", 2, True)):
        ver = "G2LAB" if lab else None
        sr = models.create("ESPCN", 1, 1, up, generator=g)
        c = models.create("SRCNN", 1, 2 if lab else 3, generator=g)
        a = d / tag / checkpoint_name("ESPCN", "A2C", up, 1, ver=ver)
        b = d / tag / checkpoint_name("SRCNN", "C2B", up, 1, ver=ver)
        a.parent.mkdir()
        save_params(str(a), interop.jax_tree_from_module(sr)[0])
        save_params(str(b), interop.jax_tree_from_module(c)[0])
        files[tag] = (str(a), str(b))
    return files


def test_from_checkpoints_loads_the_teacher(teacher_files):
    a, b = teacher_files["x2"]
    tr = DistillTrainer.from_checkpoints(a, b, alpha=0.5, device="cpu", **STUDENT)
    want = interop.load_params_any(models.create("ESPCN", 1, 1, 2), a)
    for (n, p), (_, q) in zip(tr.teacher_sr.named_parameters(), want.named_parameters()):
        assert torch.equal(p, q), n
    assert tr.alpha == 0.5


@pytest.mark.parametrize("case,kw,match", [
    ("roles", {}, r"\(A2C, C2B\) pair"),
    ("x4", {}, "teacher SR checkpoint is x4 but the student pipeline is x2"),
    ("lab", {}, "teacher is a G2LAB checkpoint but the student pipeline is G2RGB"),
    ("x2", dict(lab=True), "teacher is a G2RGB checkpoint but the student pipeline is G2LAB"),
])
def test_from_checkpoints_refuses_a_mismatched_teacher(teacher_files, case, kw, match):
    a, b = teacher_files["x2" if case == "roles" else case]
    if case == "roles":
        a, b = b, a
    with pytest.raises(ValueError, match=match):
        DistillTrainer.from_checkpoints(a, b, device="cpu", **{**STUDENT, **kw})


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from srcgan_tpu_torch import data

    root = tmp_path_factory.mktemp("distill_data")
    data.make_synthetic_dataset(str(root / "Sat2Aerx1"), n_train=2, n_val=1, n_test=1,
                                size=HW, seed=0, colorizable=True)
    return str(root)


def test_train_cas_distill_flags(teacher_files, synth, tmp_path, capsys):
    a, b = teacher_files["x2"]
    state = train_cas.main(["--data-dir", synth, "--SRModel", "ESPCN", "--CModel", "SRCNN",
                            "--num-epochs", "1", "--save-every", "1", "--batch-size", "2",
                            "--checkpoints", str(tmp_path / "ck"), "--run-dir",
                            str(tmp_path / "run"), "--workers", "0", "--device", "cpu",
                            "--distill-netGA", a, "--distill-netGB", b,
                            "--distill-alpha", "0.25"])
    assert "alpha=0.25" in capsys.readouterr().out
    assert state.sr.step == state.c.step == 1
    assert (tmp_path / "ck" / "ESPCN_A2C_x2_0001.npz").exists()


def test_train_cas_distill_needs_both_teachers(teacher_files, tmp_path):
    with pytest.raises(SystemExit, match="must be given together"):
        train_cas.main(["--device", "cpu", "--distill-netGA", teacher_files["x2"][0]])


def test_train_cas_perceptual_random_trains(synth, tmp_path):
    state = train_cas.main(["--data-dir", synth, "--SRModel", "ESPCN", "--CModel", "SRCNN",
                            "--num-epochs", "1", "--save-every", "1", "--batch-size", "2",
                            "--checkpoints", str(tmp_path / "ck"), "--run-dir",
                            str(tmp_path / "run"), "--workers", "0", "--device", "cpu",
                            "--perceptual", "random", "--perceptual-weight", "0.1"])
    assert state.sr.step == state.c.step == 1
    assert (tmp_path / "ck" / "casstate_latest.npz").exists()
