"""The port's CasTrainer on its own: equalities that hold by construction
(fused vs unfused input, K steps vs K calls, accumulation vs one batch,
resume vs no interruption, remat vs none), in-place state semantics, bf16
activations with fp32 masters, and the retention helpers.

Small models (RDDBNet nf=16, nb=1, gc=8; ESPCN; the full ResDeconv), 32x32
uint8 batches from numpy.  Equalities of the same arithmetic in the same
order are exact; the fused-input tolerances are tests/test_fused.py's (the
plain preprocess differs from the unfused path by rounding only).
"""
import copy
import functools

import numpy as np
import pytest
import torch

from srcgan_tpu_torch import models
from srcgan_tpu_torch.train import retention
from srcgan_tpu_torch.train import state as tstate
from srcgan_tpu_torch.train.cas import CasTrainer

N, HW, LR = 2, 32, 1e-4
SMALL_SR = dict(nf=16, nb=1, gc=8)


@pytest.fixture(scope="module", autouse=True)
def small_models():
    """The registry builds RDDBNet at nf=16, nb=1, gc=8 for this module's
    trainers, and "ResDeconvBN" is the BatchNorm colorizer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(models.REGISTRY, "RDDBNet", functools.partial(models.RDDBNet, **SMALL_SR))
        mp.setitem(models.REGISTRY, "ResDeconvBN", functools.partial(models.ResDeconv, BN="BN"))
        yield


def trainer(sr="RDDBNet", c="ResDeconv", **kw):
    return CasTrainer(sr, c, up=2, lr=LR, device="cpu", **kw)


def u8(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape,
                                                                  dtype=np.uint8))


def params_of(state):
    return {f"{r}.{n}": p.detach().clone() for r in ("sr", "c")
            for n, p in getattr(state, r).model.named_parameters()}


def buffers_of(state):
    return {f"{r}.{n}": b.clone() for r in ("sr", "c")
            for n, b in getattr(state, r).model.named_buffers()}


def assert_same(a: dict, b: dict, **tol):
    assert a.keys() == b.keys()
    for k in a:
        if tol:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), err_msg=k, **tol)
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def init_state():
    """One initial state per model set, deep-copied by each test."""
    cache = {}

    def get(**kw):
        key = repr(sorted(kw.items()))
        if key not in cache:
            cache[key] = trainer(**kw).init(0)
        return copy.deepcopy(cache[key])

    return get


def test_fused_input_step_equals_unfused(init_state):
    src, tar = u8(0, N, HW, HW, 3), u8(1, N, HW, HW, 3)
    st_x, st_f = init_state(), init_state()
    st_x, m_x = trainer().train_step_u8(st_x, src, tar, LR)
    st_f, m_f = trainer(fused_input=True).train_step_u8(st_f, src, tar, LR)
    for k in ("loss_SR", "loss_C"):
        np.testing.assert_allclose(float(m_x[k]), float(m_f[k]), rtol=1e-6)
    assert_same(params_of(st_x), params_of(st_f), atol=1e-6, rtol=1e-5)


def test_fused_input_inputs():
    """realB is tar/255 twice; (real_BC, real_BA) come from the preprocess
    wrapper; realA is not used."""
    tr = trainer(fused_input=True)
    tar = u8(2, N, HW, HW, 3)
    realA, realB, (bc, ba) = tr._u8_inputs(None, tar)
    assert realA is realB
    assert torch.equal(realB, tar.float() / 255.0)
    assert bc.shape == (N, HW, HW, 1) and ba.shape == (N, HW // 2, HW // 2, 1)


def test_train_steps_u8_equals_sequential_steps(init_state):
    tr = trainer(fused_input=True)
    src = torch.stack([u8(10 + k, N, HW, HW, 3) for k in range(3)])
    tar = torch.stack([u8(20 + k, N, HW, HW, 3) for k in range(3)])
    st_k, m_k = tr.train_steps_u8(init_state(), src, tar, LR)
    st_s = init_state()
    seq = []
    for k in range(3):
        st_s, m = tr.train_step_u8(st_s, src[k], tar[k], LR)
        seq.append(m)
    assert st_k.sr.step == st_s.sr.step == 3 and st_k.c.step == 3
    for key, v in m_k.items():
        assert v.shape == (3,)
        assert torch.equal(v, torch.stack([m[key] for m in seq])), key
    assert_same(params_of(st_k), params_of(st_s))


def test_train_step_accum_equals_full_batch(init_state):
    """GroupNorm colorizer: the L1 mean of equal chunks is the batch mean."""
    tr = trainer()
    realB = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (4, HW, HW, 3))
                             .astype(np.float32))
    realA = torch.zeros(4, HW, HW, 1)
    st_a, m_a = tr.train_step_accum(init_state(), realA, realB, LR, 2)
    st_f, m_f = tr.train_step(init_state(), realA, realB, LR)
    for k in ("loss_SR", "loss_C"):
        np.testing.assert_allclose(float(m_a[k]), float(m_f[k]), rtol=1e-5)
    assert_same(params_of(st_a), params_of(st_f), atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        tr.train_step_accum(init_state(), realA, realB, LR, 3)


def test_ema_update(init_state):
    tr = trainer()
    state = init_state()
    ema = tr.ema_init(state)
    e0 = {r: {n: t.clone() for n, t in ema[r].items()} for r in ema}
    src, tar = u8(4, N, HW, HW, 3), u8(5, N, HW, HW, 3)
    realB = tar.float() / 255
    state, ema2, _ = tr.train_step_ema(state, ema, torch.zeros(N, HW, HW, 1), realB, LR, 0.9)
    assert ema2 is ema                                      # updated in place
    for r in ("sr", "c"):
        for n, p in getattr(state, r).model.named_parameters():
            want = 0.9 * e0[r][n] + (1.0 - 0.9) * p.detach()
            np.testing.assert_allclose(ema[r][n].numpy(), want.numpy(), rtol=1e-6, atol=1e-9)
            assert not torch.equal(ema[r][n], p)


def test_state_is_updated_in_place_and_grads_is_pure(init_state):
    """grads leaves the modules (parameters and BN buffers) untouched and
    returns the new running statistics; apply_grads installs them."""
    tr = trainer(c="ResDeconvBN")
    state = init_state(c="ResDeconvBN")
    p0, b0 = params_of(state), buffers_of(state)
    realB = u8(6, N, HW, HW, 3).float() / 255
    grads, mstates, _ = tr.grads(state, None, realB)
    assert_same(params_of(state), p0)
    assert_same(buffers_of(state), b0)
    assert not torch.equal(mstates["c"]["bn1.running_mean"], b0["c.bn1.running_mean"])
    model = state.c.model
    new = tr.apply_grads(state, grads, mstates, LR)
    assert new.c.model is model and new.c.step == state.c.step + 1
    assert torch.equal(model.bn1.running_mean, mstates["c"]["bn1.running_mean"])
    assert not torch.equal(params_of(new)["c.pred.weight"], p0["c.pred.weight"])


def test_remat_equals_plain_step(init_state):
    """torch.utils.checkpoint recomputes the forward in the backward; the
    BatchNorm statistics must still move once."""
    src, tar = u8(7, N, HW, HW, 3), u8(8, N, HW, HW, 3)
    kw = dict(c="ResDeconvBN")
    st_r, m_r = trainer(remat=True, **kw).train_step_u8(init_state(**kw), src, tar, LR)
    st_p, m_p = trainer(**kw).train_step_u8(init_state(**kw), src, tar, LR)
    for k in m_p:
        assert torch.equal(m_r[k], m_p[k]), k
    assert_same(buffers_of(st_r), buffers_of(st_p))
    assert_same(params_of(st_r), params_of(st_p), atol=1e-7, rtol=1e-6)


def test_bf16_activations_keep_fp32_masters(init_state):
    """act_dtype=bf16: fp32 master parameters, grads and Adam moments; fp32
    metrics near the fp32 step's (bf16 tolerance)."""
    src, tar = u8(9, N, HW, HW, 3), u8(10, N, HW, HW, 3)
    st_b, m_b = trainer(act_dtype=torch.bfloat16, fused_input=True).train_step_u8(
        init_state(), src, tar, LR)
    _, m_f = trainer().train_step_u8(init_state(), src, tar, LR)
    for ts in (st_b.sr, st_b.c):
        for p in ts.model.parameters():
            assert p.dtype == torch.float32
            assert ts.opt.state[p]["exp_avg"].dtype == torch.float32
    for k in ("loss_SR", "loss_C"):
        assert m_b[k].dtype == torch.float32
        np.testing.assert_allclose(float(m_b[k]), float(m_f[k]), rtol=2e-2)


def test_save_and_load_train_state_resumes(init_state, tmp_path):
    """Two steps, save, restore into a differently seeded state: the next
    step equals the uninterrupted run's third step exactly."""
    tr = trainer(c="ResDeconvBN")
    batches = [(u8(30 + k, N, HW, HW, 3), u8(40 + k, N, HW, HW, 3)) for k in range(3)]
    state = init_state(c="ResDeconvBN")
    for s, t in batches[:2]:
        state, _ = tr.train_step_u8(state, s, t, LR)
    path = str(tmp_path / "casstate_latest.npz")
    tstate.save_train_state(path, state, extra={"epoch": 7, "val_psnr": 21.5})
    other = tr.init(123)
    resumed, extra = tstate.load_train_state(path, other)
    assert extra == {"epoch": 7, "val_psnr": 21.5}
    assert resumed.sr.step == resumed.c.step == 2
    assert resumed.sr.model is other.sr.model               # restored in place
    assert_same(params_of(resumed), params_of(state))
    assert_same(buffers_of(resumed), buffers_of(state))
    state, m1 = tr.train_step_u8(state, *batches[2], LR * 0.5)
    resumed, m2 = tr.train_step_u8(resumed, *batches[2], LR * 0.5)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert_same(params_of(resumed), params_of(state))


def test_save_train_state_before_any_step(tmp_path):
    tr = trainer(sr="ESPCN")
    state = tr.init(0)
    path = str(tmp_path / "s.npz")
    tstate.save_train_state(path, state)
    resumed, extra = tstate.load_train_state(path, tr.init(1))
    assert extra == {} and resumed.sr.step == 0
    assert all(len(s) == 0 for s in resumed.sr.opt.state.values())
    assert_same(params_of(resumed), params_of(state))


def test_eval_weights_follow_optimizer_steps(init_state):
    """RDDBNet's eval tail caches folded weights; after an in-place Adam step
    the transfer must see the new weights, as a fresh copy does."""
    tr = trainer()
    state = init_state()
    realA = torch.from_numpy(np.random.default_rng(11).uniform(0, 1, (N, HW, HW, 1))
                             .astype(np.float32))
    tr.transfer(state, realA)                              # fills the cache
    state, _ = tr.train_step_u8(state, u8(12, N, HW, HW, 3), u8(13, N, HW, HW, 3), 1e-2)
    _, got, _ = tr.transfer(state, realA)
    fresh = copy.deepcopy(state.sr.model)
    fresh._prepared = (None, None)
    fresh.eval()
    with torch.no_grad():
        want = fresh(tr._degrade(realA).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert torch.equal(got, want)


def test_transfer_at_bf16_leaves_masters_fp32(init_state):
    tr = trainer()
    state = init_state()
    realA = torch.rand(N, HW, HW, 1, generator=torch.Generator().manual_seed(0))
    a_in, fake_ac, fake_ab = tr.transfer(state, realA.bfloat16())
    assert a_in.dtype == fake_ac.dtype == fake_ab.dtype == torch.bfloat16
    assert fake_ac.shape == (N, HW, HW, 1) and fake_ab.shape == (N, HW, HW, 3)
    assert all(p.dtype == torch.float32 for p in state.sr.model.parameters())
    _, want_ac, _ = tr.transfer(state, realA)
    rel = (fake_ac.float() - want_ac).norm() / want_ac.norm()
    assert rel <= 2e-2, rel


@pytest.mark.parametrize("kw,exc,match", [
    (dict(lab=True, perceptual_params={}), ValueError, "perceptual"),
    (dict(lab=True, fused_input=True), ValueError, "fused_input"),
    (dict(sr="SRCNN", const=True, fused_input=True), ValueError, "fused_input"),
])
def test_unsupported_options_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        trainer(**kw)


def test_perceptual_term_joins_both_stage_losses(init_state):
    """perceptual_params (random VGG16 weights): each stage's loss is its L1
    plus perceptual_weight x vgg16_loss of the same output, the VGG weights
    stay as they were, and the step trains."""
    from srcgan_tpu_torch import losses, losses_vgg

    vgg = losses_vgg.init_vgg_params(torch.Generator().manual_seed(0))
    before = {k: {n: t.clone() for n, t in p.items()} for k, p in vgg.items()}
    tr = trainer(perceptual_params=vgg, perceptual_weight=0.5)
    pred, tgt = (torch.rand(N, HW, HW, 3, generator=torch.Generator().manual_seed(s))
                 for s in (1, 2))
    want = losses.l1(pred, tgt) + 0.5 * losses_vgg.vgg16_loss(vgg, pred, tgt)
    assert torch.equal(tr._stage_loss(pred, tgt, None), want)
    state = init_state()
    state, m = tr.train_step_u8(state, u8(14, N, HW, HW, 3), u8(15, N, HW, HW, 3), LR)
    plain = trainer()
    _, _, pm = plain.grads(init_state(), *plain._u8_inputs(u8(14, N, HW, HW, 3),
                                                           u8(15, N, HW, HW, 3))[:2])
    assert state.sr.step == 1 and all(torch.isfinite(v) for v in m.values())
    assert float(m["loss_SR"]) > float(pm["loss_SR"]) and float(m["loss_C"]) > float(pm["loss_C"])
    assert all(torch.equal(vgg[k][n], before[k][n]) for k in vgg for n in vgg[k])


def test_init_is_seeded():
    a, b, c = trainer().init(5), trainer().init(5), trainer().init(6)
    assert_same(params_of(a), params_of(b))
    assert not torch.equal(params_of(a)["sr.conv_first.weight"],
                           params_of(c)["sr.conv_first.weight"])
    g = torch.Generator().manual_seed(5)
    assert_same(params_of(trainer().init(g)), params_of(a))


def test_retention_and_early_stopping_match_jax(tmp_path):
    """Pure Python, ported line for line: the same decisions as the JAX
    package's on the same sequence."""
    from srcgan_tpu.train import retention as jret

    outs = []
    for mod, sub in ((retention, "port"), (jret, "jax")):
        d = tmp_path / sub
        d.mkdir()
        mgr = mod.CheckpointManager(str(d), keep_last=2, keep_best=1)
        stop = mod.EarlyStopper(patience=2, min_delta=0.1)
        log = []
        for epoch, metric in enumerate([20.0, 25.0, 24.0, 23.0, 25.05, 22.0], 1):
            f = d / f"e{epoch}.npz"
            f.write_bytes(b"x")
            removed = mgr.register(epoch, [str(f)], metric)
            log.append(([p.rsplit("/", 1)[1] for p in removed], stop.update(metric)))
        log.append(mgr.best_epoch())
        log.append(mod.CheckpointManager(str(d)).best_epoch())    # ledger reloads
        outs.append(log)
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        retention.EarlyStopper(mode="median")


# -- lab=True ---------------------------------------------------------------

def test_lab_u8_step_equals_float_step_on_converted_pair(init_state):
    """train_step_u8 with lab converts with G2LAB in the step: the same update
    as train_step on convert_pair's output; the colorizer has two channels."""
    from srcgan_tpu_torch.data import preprocess

    tr = trainer(lab=True)
    src, tar = u8(30, N, HW, HW, 3), u8(31, N, HW, HW, 3)
    st_u8, st_f = init_state(lab=True), init_state(lab=True)
    assert st_u8.c.model.pred.weight.shape[0] == 2
    st_u8, m_u8 = tr.train_step_u8(st_u8, src, tar, LR)
    realA, realB = preprocess.convert_pair(src, tar, "G2LAB")
    assert realB.shape == (N, HW, HW, 3) and 0 <= float(realB.min()) and float(realB.max()) <= 1
    st_f, m_f = tr.train_step(st_f, realA, realB, LR)
    for k in m_u8:
        assert torch.equal(m_u8[k], m_f[k]), k
    assert_same(params_of(st_u8), params_of(st_f))


def test_lab_targets_and_bf16_step(init_state):
    """_split_targets with lab is (L, ab); a bf16-activation lab step keeps fp32
    masters and finite losses; K steps per call run the same conversion."""
    tr = trainer(lab=True, act_dtype=torch.bfloat16)
    x = torch.rand(N, HW, HW, 3, generator=torch.Generator().manual_seed(1))
    lum, ab = tr._split_targets(x)
    assert torch.equal(lum, x[..., :1]) and torch.equal(ab, x[..., 1:])
    src = torch.stack([u8(40 + k, N, HW, HW, 3) for k in range(2)])
    tar = torch.stack([u8(50 + k, N, HW, HW, 3) for k in range(2)])
    state, m = tr.train_steps_u8(init_state(lab=True), src, tar, LR)
    assert all(v.shape == (2,) and bool(torch.isfinite(v).all()) for v in m.values())
    assert all(p.dtype == torch.float32 for p in state.c.model.parameters())
    assert state.sr.step == state.c.step == 2
