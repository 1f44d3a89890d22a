"""The port's CasTrainer against the JAX CasTrainer, from the same weights.

Weights start in the port (a seeded torch generator) and cross to JAX
through ``interop.jax_tree_from_module``; batches come from numpy.  Models:
RDDBNet(1,1,2) at nf=16, nb=1, gc=8 and the full ResDeconv(1,3) with
GroupNorm, 32x32 targets, up=2.  Tolerances (tests/test_training_dynamics.py
explains the drift model):

- one fp32 step: losses rtol 1e-5; each tensor's Adam update within
  rel-L2 5e-2, the fp32 cross-framework envelope (L1's gradient is a sign,
  and reduction order differs);
- float64 matched-point gradients of the residual-masked L1 (mask
  |residual| > 1e-4 from one fp32 forward, shared by both sides): per-layer
  rel-L2 <= 3e-5;
- eval forwards (transfer, snapshot, weights loaded across): fp32,
  max|diff| <= 1e-4 * max|ref|, as tests/test_torch_models.py.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from srcgan_tpu import config as jax_config
from srcgan_tpu import models as jax_models
from srcgan_tpu.train import CasTrainer as JaxCasTrainer
from srcgan_tpu.train import cas as jcas
from srcgan_tpu.train import state as jstate
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
from srcgan_tpu_torch.train import state as tstate
from srcgan_tpu_torch.train.cas import CasTrainer

UP, LR, N, HW = 2, 1e-4, 2, 32
SMALL_SR = dict(nf=16, nb=1, gc=8)
MASK_TAU = 1e-4


@pytest.fixture(scope="module", autouse=True)
def small_models():
    """For every port trainer of this module, the registry builds RDDBNet at
    nf=16, nb=1, gc=8 and SRCNN at base 16 (the JAX trainers get the same
    models), and "ResDeconvBN" is the BatchNorm colorizer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(models.REGISTRY, "RDDBNet", functools.partial(models.RDDBNet, **SMALL_SR))
        mp.setitem(models.REGISTRY, "SRCNN", functools.partial(models.SRCNN, base_kernel=16))
        mp.setitem(models.REGISTRY, "ResDeconvBN", functools.partial(models.ResDeconv, BN="BN"))
        yield


def port_trainer(c_model="ResDeconv", **kw):
    return CasTrainer("RDDBNet", c_model, up=UP, lr=LR, device="cpu", **kw)


def jax_trainer(**kw):
    tr = JaxCasTrainer(sr_model="RDDBNet", c_model="ResDeconv", up=UP, lr=LR, **kw)
    tr.netG_A2C = jax_models.RDDBNet(1, 1, UP, **SMALL_SR)
    return tr


def to_jax(tree):
    return jtu.tree_map(jnp.asarray, tree)


def jax_state_of(jtr, state):
    """The JAX CasState holding the port state's weights, fresh optimizers."""
    def ts(model):
        params, _ = interop.jax_tree_from_module(model)
        params = to_jax(params)
        return jstate.TrainState(params, jtr.opt.init(params), jnp.zeros((), jnp.int32))

    return jcas.CasState(ts(state.sr.model), ts(state.c.model),
                         jtr.netG_A2C.init_state(), jtr.netG_C2B.init_state())


def flat(tree):
    return {jtu.keystr(p): np.asarray(v, np.float64)
            for p, v in jtu.tree_flatten_with_path(tree)[0]}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def per_layer_max_rel(ours, ref):
    a, b = flat(ours), flat(ref)
    assert a.keys() == b.keys()
    return max(rel_l2(a[k], b[k]) for k in b)


def u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(autouse=True)
def _highest():
    with jax_config.matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def pair():
    """(port trainer, its initial state, JAX trainer): made once, the state
    is deep-copied by every test that trains it."""
    tr = port_trainer()
    return tr, tr.init(0), jax_trainer()


def test_fp32_train_step_u8_matches_jax(pair):
    tr, state0, jtr = pair
    state = copy.deepcopy(state0)
    before = {r: interop.jax_tree_from_module(getattr(state, r).model)[0] for r in ("sr", "c")}
    jst = jax_state_of(jtr, state)
    src, tar = u8(1, N, HW, HW, 3), u8(2, N, HW, HW, 3)
    jst, jm = jtr.train_step_u8(jst, jnp.asarray(src), jnp.asarray(tar), LR)
    state, m = tr.train_step_u8(state, torch.from_numpy(src), torch.from_numpy(tar), LR)
    assert state.sr.step == state.c.step == 1
    for k in ("loss_SR", "loss_C", "psnr_SR", "psnr_C"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for role, jparams in (("sr", jst.sr.params), ("c", jst.c.params)):
        after = flat(interop.jax_tree_from_module(getattr(state, role).model)[0])
        start, want = flat(before[role]), flat(jparams)
        for k in want:
            err = rel_l2(after[k] - start[k], want[k] - start[k])
            assert err <= 5e-2, (role, k, err)


def test_float64_masked_gradients_match_jax(pair):
    """The networks' train-mode forward and backward (GroupNorm, the
    phase-folded tail's gradients) against JAX in float64."""
    tr, state, jtr = pair
    tar = np.random.default_rng(3).uniform(0, 1, (N, HW, HW, 3))
    lum = np.array([0.2125, 0.7154, 0.0721])
    real_BC = (tar * lum).sum(-1, keepdims=True)
    real_BA = np.asarray(jtr._degrade(jnp.asarray(real_BC, jnp.float32)), np.float64)
    jst = jax_state_of(jtr, state)

    # one shared residual mask per stage, from JAX's fp32 forward
    fwd = lambda net: jax.jit(lambda p, x: net.apply(p, x, state={}, train=True)[0])
    fa = fwd(jtr.netG_A2C)(jst.sr.params, jnp.asarray(real_BA, jnp.float32))
    fb = fwd(jtr.netG_C2B)(jst.c.params, jnp.asarray(real_BC, jnp.float32))
    mask_a = (np.abs(np.asarray(fa) - real_BC) > MASK_TAU).astype(np.float64)
    mask_b = (np.abs(np.asarray(fb) - tar) > MASK_TAU).astype(np.float64)
    assert mask_a.sum() > 0 and mask_b.sum() > 0

    jax.config.update("jax_enable_x64", True)
    try:
        def masked(net, x, t, mask):
            def loss(p):
                y, _ = net.apply(p, jnp.asarray(x), state={}, train=True)
                return jnp.sum(mask * jnp.abs(y - t)) / jnp.sum(mask)
            return loss

        to64 = lambda t: jtu.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        want_a = jax.jit(jax.grad(masked(jtr.netG_A2C, real_BA, real_BC, mask_a)))(
            to64(jst.sr.params))
        want_b = jax.jit(jax.grad(masked(jtr.netG_C2B, real_BC, tar, mask_b)))(
            to64(jst.c.params))
    finally:
        jax.config.update("jax_enable_x64", False)

    for net, x, t, mask, want in ((state.sr.model, real_BA, real_BC, mask_a, want_a),
                                  (state.c.model, real_BC, tar, mask_b, want_b)):
        net64 = copy.deepcopy(net).double().train()
        y = to_nhwc(net64(to_nchw(torch.from_numpy(x))))
        m = torch.from_numpy(mask)
        loss = (m * (y - torch.from_numpy(t)).abs()).sum() / m.sum()
        names, params = zip(*net64.named_parameters())
        got = dict(zip(names, torch.autograd.grad(loss, params)))
        ours = interop.jax_tree_from_module(net64, got)[0]
        err = per_layer_max_rel(ours, want)
        assert err <= 3e-5, (type(net).__name__, err)


def test_transfer_and_snapshot_match_jax(pair):
    tr, state, jtr = pair
    jst = jax_state_of(jtr, state)
    realA = np.random.default_rng(4).uniform(0, 1, (N, HW, HW, 1)).astype(np.float32)
    realB = np.random.default_rng(5).uniform(0, 1, (N, HW, HW, 3)).astype(np.float32)
    modes = (state.sr.model.training, state.c.model.training)
    got = tr.snapshot(state, torch.from_numpy(realA), torch.from_numpy(realB))
    want = jtr.snapshot(jst, jnp.asarray(realA), jnp.asarray(realB))
    assert (state.sr.model.training, state.c.model.training) == modes   # restored
    assert got.keys() == want.keys()
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        assert np.abs(got[k].numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    got_t = tr.transfer(state, torch.from_numpy(realA))
    for g, k in zip(got_t, ("real_A", "fake_AC", "fake_AB")):
        np.testing.assert_array_equal(g.numpy(), got[k].numpy())


def test_const_step_matches_jax():
    """const=True (down+up degradation at full size) with SRCNN, one fp32 step."""
    tr = CasTrainer("SRCNN", "ResDeconv", up=UP, lr=LR, const=True, device="cpu")
    jtr = JaxCasTrainer(sr_model="SRCNN", c_model="ResDeconv", up=UP, lr=LR, const=True)
    jtr.netG_A2C = jax_models.SRCNN(1, 1, UP, base_kernel=16)
    state = tr.init(1)
    jst = jax_state_of(jtr, state)
    realA = np.zeros((N, HW, HW, 1), np.float32)
    realB = np.random.default_rng(6).uniform(0, 1, (N, HW, HW, 3)).astype(np.float32)
    _, jm = jtr.train_step(jst, jnp.asarray(realA), jnp.asarray(realB), LR)
    _, m = tr.train_step(state, torch.from_numpy(realA), torch.from_numpy(realB), LR)
    for k in ("loss_SR", "loss_C", "psnr_SR", "psnr_C"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("role", ["sr", "c"])
def test_port_trained_weights_load_in_jax(pair, tmp_path, role):
    """A port-trained net saved with save_params loads in the JAX package
    (load_params against the JAX model's own init tree) and gives the same
    fp32 eval forward there."""
    tr, state0, jtr = pair
    state = copy.deepcopy(state0)
    state, _ = tr.train_step_u8(state, torch.from_numpy(u8(7, N, HW, HW, 3)),
                                torch.from_numpy(u8(8, N, HW, HW, 3)), 1e-3)
    net = getattr(state, role).model
    jnet = jtr.netG_A2C if role == "sr" else jtr.netG_C2B
    path = str(tmp_path / ("RDDBNet_A2C_x2_0001.npz" if role == "sr"
                           else "ResDeconv_C2B_x2_0001.npz"))
    tstate.save_params(path, interop.jax_tree_from_module(net)[0])
    like = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    params = jstate.load_params(path, like=like)
    x = np.random.default_rng(9).uniform(0, 1, (N, 16, 16, 1)).astype(np.float32)
    want = jax.jit(lambda p, v: jnet.apply(p, v, state=jnet.init_state(), train=False)[0])(
        params, jnp.asarray(x))
    net.eval()
    with torch.no_grad():
        got = to_nhwc(net(to_nchw(torch.from_numpy(x)))).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_adam_matches_optax_over_five_steps():
    """torch.optim.Adam (port optim.adam) and the JAX package's optax adam
    apply the same update: the same gradients for 5 steps, with an lr change
    (set_lr) in the middle that keeps the moments."""
    import optax

    from srcgan_tpu.train import optim as joptim
    from srcgan_tpu_torch.train import optim

    rng = np.random.default_rng(10)
    p0 = rng.standard_normal((3, 5, 4)).astype(np.float32)
    gs = [rng.standard_normal(p0.shape).astype(np.float32) * 10.0 ** -i for i in range(5)]
    lrs = [1e-3, 1e-3, 1e-3, 3e-4, 3e-4]
    jopt = joptim.adam(lrs[0])
    jp = jnp.asarray(p0)
    jo = jopt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = optim.adam([tp], lrs[0])
    for g, lr in zip(gs, lrs):
        jo = joptim.set_lr(jo, lr)
        upd, jo = jopt.update(jnp.asarray(g), jo, jp)
        jp = optax.apply_updates(jp, upd)
        optim.set_lr(topt, lr)
        tp.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=0)
    mu = np.asarray(jo.inner_state[0].mu)
    np.testing.assert_allclose(topt.state[tp]["exp_avg"].numpy(), mu, rtol=1e-6)
    assert optim.ADAM_HPARAMS == joptim.ADAM_HPARAMS
    assert topt.param_groups[0]["betas"] == joptim.ADAM_HPARAMS[:2]
    assert topt.param_groups[0]["eps"] == joptim.ADAM_HPARAMS[2]


@pytest.mark.parametrize("policy", ["cosine", "true_cosine", "warmup_cosine", "step",
                                    "plateau", "none"])
def test_lr_schedules_equal_jax(policy):
    from srcgan_tpu.train import optim as joptim
    from srcgan_tpu_torch.train import optim

    for epoch in (1, 2, 7, 49, 50):
        assert optim.reference_lr(policy, 2e-4, 50, epoch) == joptim.reference_lr(
            policy, 2e-4, 50, epoch)
    assert port_trainer().lr_at_epoch(3) == jax_trainer().lr_at_epoch(3)


def test_batchnorm_colorizer_step_matches_jax():
    """ResDeconv with BatchNorm: the step's losses and the running statistics
    it returns as model state (momentum 0.1, unbiased variance) match JAX."""
    tr = port_trainer("ResDeconvBN")
    jtr = jax_trainer()
    jtr.netG_C2B = jax_models.ResDeconv(1, 3, BN="BN")
    state = tr.init(2)
    jst = jax_state_of(jtr, state)
    src, tar = u8(11, N, HW, HW, 3), u8(12, N, HW, HW, 3)
    jst, jm = jtr.train_step_u8(jst, jnp.asarray(src), jnp.asarray(tar), LR)
    state, m = tr.train_step_u8(state, torch.from_numpy(src), torch.from_numpy(tar), LR)
    for k in ("loss_SR", "loss_C"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    got = flat(interop.jax_tree_from_module(state.c.model)[1])
    want = flat(jst.c_model_state)
    assert got.keys() == want.keys() and len(want) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_bf16_transfer_with_batchnorm_keeps_fp32_statistics():
    """transfer on a bf16 input with a BatchNorm colorizer whose running
    statistics bf16 cannot hold: the eval copy casts parameters only, as the
    JAX ops compute at the activation's dtype and leave the model state in
    fp32.  fake_AB
    within rel-L2 2e-2 of JAX's (bf16 rounds at other places in the two
    frameworks), the trainer's own fp32 model untouched."""
    rng = np.random.default_rng(21)
    tr = port_trainer("ResDeconvBN")
    jtr = jax_trainer()
    jtr.netG_C2B = jax_models.ResDeconv(1, 3, BN="BN")
    state = tr.init(3)
    with torch.no_grad():
        for name, b in state.c.model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(rng.normal(0, 0.3, b.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, b.shape).astype(np.float32)))
    jst = jax_state_of(jtr, state)
    jst = jst._replace(c_model_state=to_jax(interop.jax_tree_from_module(state.c.model)[1]))
    realA = rng.uniform(0, 1, (N, HW, HW, 1)).astype(np.float32)
    copies = []
    deepcopy = copy.deepcopy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(copy, "deepcopy", lambda obj, *a: copies.append(deepcopy(obj, *a)) or copies[-1])
        _, fake_ac, fake_ab = tr.transfer(state, torch.from_numpy(realA).bfloat16())
    nets = [m for m in copies if isinstance(m, torch.nn.Module)]
    assert len(nets) == 2                                     # one cast copy per network
    bn = [b for b in nets[1].buffers() if b.is_floating_point()]
    assert len(bn) > 0 and all(b.dtype == torch.float32 for b in bn)
    assert all(p.dtype == torch.bfloat16 for p in nets[1].parameters())
    assert all(p.dtype == torch.float32 for p in state.c.model.parameters())
    assert fake_ab.dtype == torch.bfloat16
    _, want_ac, want_ab = jtr.transfer(jst, jnp.asarray(realA).astype(jnp.bfloat16))
    assert rel_l2(fake_ac.float().numpy(), np.asarray(want_ac, np.float32)) <= 2e-2
    assert rel_l2(fake_ab.float().numpy(), np.asarray(want_ab, np.float32)) <= 2e-2


# -- the LAB cascade (lab=True): L to the SR net, 2-channel ab from the colorizer --

@pytest.fixture(scope="module")
def lab_pair():
    tr = port_trainer(lab=True)
    return tr, tr.init(2), jax_trainer(lab=True)


def lab_targets(seed):
    """A normalized-LAB batch in float64 from a numpy-seeded RGB batch (JAX's
    fp32 conversion: both sides then start from the same numbers)."""
    from srcgan_tpu.ops import color as jcolor

    rgb = np.random.default_rng(seed).uniform(0, 1, (N, HW, HW, 3)).astype(np.float32)
    return np.asarray(jcolor.rgb_to_lab_norm(jnp.asarray(rgb)), np.float64)


def test_lab_float64_masked_gradients_match_jax(lab_pair):
    """lab=True: the SR net learns L, the 2-channel colorizer ab.  Float64
    gradients of the residual-masked L1 at the matched point, per-layer
    rel-L2 <= 3e-5 (the bound of test_float64_masked_gradients_match_jax)."""
    tr, state, jtr = lab_pair
    assert state.c.model.pred.weight.shape[0] == 2
    tar = lab_targets(7)
    real_BC, tgt = tar[..., :1], tar[..., 1:]
    got_BC, got_tgt = tr._split_targets(torch.from_numpy(tar))
    assert torch.equal(got_BC, torch.from_numpy(real_BC)) and got_tgt.shape[-1] == 2
    real_BA = np.asarray(jtr._degrade(jnp.asarray(real_BC, jnp.float32)), np.float64)
    jst = jax_state_of(jtr, state)

    fwd = lambda net: jax.jit(lambda p, x: net.apply(p, x, state={}, train=True)[0])
    fa = fwd(jtr.netG_A2C)(jst.sr.params, jnp.asarray(real_BA, jnp.float32))
    fb = fwd(jtr.netG_C2B)(jst.c.params, jnp.asarray(real_BC, jnp.float32))
    mask_a = (np.abs(np.asarray(fa) - real_BC) > MASK_TAU).astype(np.float64)
    mask_b = (np.abs(np.asarray(fb) - tgt) > MASK_TAU).astype(np.float64)
    assert mask_a.sum() > 0 and mask_b.sum() > 0 and mask_b.shape[-1] == 2

    jax.config.update("jax_enable_x64", True)
    try:
        def masked(net, x, t, mask):
            def loss(p):
                y, _ = net.apply(p, jnp.asarray(x), state={}, train=True)
                return jnp.sum(mask * jnp.abs(y - t)) / jnp.sum(mask)
            return loss

        to64 = lambda t: jtu.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        want_a = jax.jit(jax.grad(masked(jtr.netG_A2C, real_BA, real_BC, mask_a)))(
            to64(jst.sr.params))
        want_b = jax.jit(jax.grad(masked(jtr.netG_C2B, real_BC, tgt, mask_b)))(
            to64(jst.c.params))
    finally:
        jax.config.update("jax_enable_x64", False)

    for net, x, t, mask, want in ((state.sr.model, real_BA, real_BC, mask_a, want_a),
                                  (state.c.model, real_BC, tgt, mask_b, want_b)):
        net64 = copy.deepcopy(net).double().train()
        y = to_nhwc(net64(to_nchw(torch.from_numpy(x))))
        m = torch.from_numpy(mask)
        loss = (m * (y - torch.from_numpy(t)).abs()).sum() / m.sum()
        names, params = zip(*net64.named_parameters())
        got = dict(zip(names, torch.autograd.grad(loss, params)))
        err = per_layer_max_rel(interop.jax_tree_from_module(net64, got)[0], want)
        assert err <= 3e-5, (type(net).__name__, err)


@pytest.mark.parametrize("const", [False, True])
def test_lab_train_step_u8_matches_jax(const):
    """One fp32 uint8 step with lab=True (and with const): convert_pair(G2LAB)
    runs in the step on both sides.  Losses and PSNRs rtol 1e-5, each tensor's
    Adam update within rel-L2 5e-2 (test_fp32_train_step_u8_matches_jax's)."""
    if const:        # the const pipeline keeps the size: SRCNN, as test_const_step_matches_jax
        tr = CasTrainer("SRCNN", "ResDeconv", up=UP, lr=LR, const=True, lab=True, device="cpu")
        jtr = JaxCasTrainer(sr_model="SRCNN", c_model="ResDeconv", up=UP, lr=LR, const=True,
                            lab=True)
        jtr.netG_A2C = jax_models.SRCNN(1, 1, UP, base_kernel=16)
    else:
        tr, jtr = port_trainer(lab=True), jax_trainer(lab=True)
    state = tr.init(3)
    before = {r: interop.jax_tree_from_module(getattr(state, r).model)[0] for r in ("sr", "c")}
    jst = jax_state_of(jtr, state)
    src, tar = u8(11, N, HW, HW, 3), u8(12, N, HW, HW, 3)
    jst, jm = jtr.train_step_u8(jst, jnp.asarray(src), jnp.asarray(tar), LR)
    state, m = tr.train_step_u8(state, torch.from_numpy(src), torch.from_numpy(tar), LR)
    for k in ("loss_SR", "loss_C", "psnr_SR", "psnr_C"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for role, jparams in (("sr", jst.sr.params), ("c", jst.c.params)):
        after = flat(interop.jax_tree_from_module(getattr(state, role).model)[0])
        start, want = flat(before[role]), flat(jparams)
        for k in want:
            err = rel_l2(after[k] - start[k], want[k] - start[k])
            assert err <= 5e-2, (role, k, err)


def test_lab_snapshot_matches_jax(lab_pair):
    """The logged image set with lab=True: real_BC is L, fake_BB and fake_AB
    are 2-channel ab maps; fp32, max|diff| <= 1e-4 * max|ref|."""
    tr, state, jtr = lab_pair
    jst = jax_state_of(jtr, state)
    realA = np.random.default_rng(8).uniform(0, 1, (N, HW, HW, 1)).astype(np.float32)
    realB = lab_targets(9).astype(np.float32)
    got = tr.snapshot(state, torch.from_numpy(realA), torch.from_numpy(realB))
    want = jtr.snapshot(jst, jnp.asarray(realA), jnp.asarray(realB))
    assert got.keys() == want.keys()
    assert got["fake_BB"].shape[-1] == got["fake_AB"].shape[-1] == 2
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        assert np.abs(got[k].numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
