"""srcgan_tpu_torch on an NVIDIA card: the sm_90a kernels against their plain
versions, the model gate that routes the x4 bf16 tail through them, and the
trainer's fused-input path through the gray+degrade kernel.

Every test here needs a card (marker ``cuda``) and skips without one.  The
file imports no jax, so it also runs where jax is not installed; there the
suite's conftest (which pins jax to the CPU) is left out:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Kernel tolerances, as for the Pallas kernels: tail_x4 max|diff| <=
0.02 * max(max|ref|, 1) (bf16 staging of t1, z2 and zall, different sum
orders); gray_degrade max|diff| <= 1e-6 (fp32, the same taps and order).
"""
import pytest
import torch

from srcgan_tpu_torch import models
from srcgan_tpu_torch.ops.kernels import preprocess_kernel, tail_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sm_90a kernel has no CPU mode")
    return torch.device("cuda")


def tail_args(seed, n, h, w, nf, ou, dev):
    g = torch.Generator().manual_seed(seed)
    t0 = torch.randn(n, h, w, nf, generator=g).to(dev, torch.bfloat16)
    d1, d2 = (torch.randn(nf, nf, 2, 2, generator=g) * 0.2 for _ in range(2))
    lw = torch.randn(ou, nf, 3, 3, generator=g) * 0.2
    lb = torch.randn(ou, generator=g)
    return t0, d1.to(dev), d2.to(dev), lw.to(dev), lb.to(dev)


@pytest.mark.parametrize("n,h,w,nf,ou", [(2, 16, 16, 16, 1), (1, 24, 40, 64, 1),
                                         (2, 32, 32, 64, 3), (3, 8, 16, 24, 2)])
def test_tail_kernel_matches_plain_version(dev, n, h, w, nf, ou):
    """Shapes include a ragged last block (M % 128 != 0), every column-tile
    count, and an nf padded to the 16-wide tiles."""
    t0, d1, d2, lw, lb = tail_args(n + nf + ou, n, h, w, nf, ou, dev)
    before = tail_kernel.launches
    got = tail_kernel.tail_x4_fused(t0, tail_kernel.prepare(d1, d2, lw), lb)
    ref = tail_kernel.tail_x4_reference(t0, d1, d2, lw, lb)
    torch.cuda.synchronize()
    assert tail_kernel.launches == before + 1
    assert got.shape == ref.shape == (n, 4 * h, 4 * w, ou)
    err, scale = (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
    assert err <= 0.02 * max(scale, 1.0), (err, scale)


def test_tail_kernel_rejects_what_it_cannot_run(dev):
    t0, d1, d2, lw, lb = tail_args(0, 1, 16, 16, 16, 1, dev)
    tw = tail_kernel.prepare(d1, d2, lw)
    with pytest.raises(ValueError):
        tail_kernel.tail_x4_fused(t0.float(), tw, lb)
    with pytest.raises(ValueError):
        tail_kernel.tail_x4_fused(t0[:, :12], tw, lb)


def test_rddbnet_gate(dev):
    """Eval bf16 x4 on the card takes the kernel, once per forward; fp32,
    training mode and x2 take the phase-folded tail.  Both tails agree."""
    g = torch.Generator().manual_seed(3)
    net = models.RDDBNet(1, 1, 4, nf=16, nb=1, device=dev, generator=g).eval()
    x = torch.rand(2, 1, 16, 16, generator=g).to(dev, memory_format=torch.channels_last)
    with torch.no_grad():
        before = tail_kernel.launches
        y32 = net(x)
        assert tail_kernel.launches == before
        net.to(torch.bfloat16)
        y16 = net(x.bfloat16())
        assert tail_kernel.launches == before + 1
        net.train()
        y16_fold = net(x.bfloat16())
        assert tail_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert y16.shape == y32.shape == (2, 1, 64, 64)
    scale = y16_fold.float().abs().max().item()
    assert (y16.float() - y16_fold.float()).abs().max().item() <= 0.02 * max(scale, 1.0)
    rel = (y16.float() - y32).norm() / y32.norm()
    assert rel <= 2e-2, rel


def test_predictor_on_card_matches_cpu(dev):
    """fp32 on the card (TF32 off) within 1 LSB of the CPU; the bf16
    predictor's stream equals its predict, one kernel launch per forward."""
    import copy

    import numpy as np

    from srcgan_tpu_torch.serving import CascadePredictor

    g = torch.Generator().manual_seed(4)
    sr, c = models.RDDBNet(1, 1, 4, nf=16, nb=1, generator=g), models.ResDeconv(1, 3, generator=g)
    with torch.no_grad():
        c.pred.weight.mul_(0.03)
    x = np.random.default_rng(4).integers(0, 256, (2, 16, 16, 1), dtype=np.uint8)
    on_cpu = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device="cpu")
    on_card = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device=dev)
    diff = np.abs(on_cpu.predict(x).astype(int) - on_card.predict(x).astype(int))
    assert diff.max() <= 1

    pred = CascadePredictor(sr, c, 4, bf16=True, device=dev)
    batches = [np.random.default_rng(i).integers(0, 256, (2, 16, 16, 1), dtype=np.uint8)
               for i in range(3)]
    before = tail_kernel.launches
    streamed = list(pred.predict_stream(iter(batches)))
    assert tail_kernel.launches == before + 3
    for b, s in zip(batches, streamed):
        np.testing.assert_array_equal(s, pred.predict(b))


def u8(seed, shape, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).to(dev)


@pytest.mark.parametrize("shape,up", [((8, 256, 256, 3), 2), ((8, 256, 256, 3), 4),
                                      ((3, 250, 198, 3), 4), ((2, 33, 47, 3), 3),
                                      ((1, 64, 3000, 3), 2)])
def test_gray_degrade_matches_plain_version(dev, shape, up):
    """Training shape, up=4, ragged sizes, a width wider than a block."""
    x = u8(sum(shape) + up, shape, dev)
    before = preprocess_kernel.launches
    got = preprocess_kernel.fused_gray_degrade(x, up)
    ref = preprocess_kernel.gray_degrade_reference(x, up)
    torch.cuda.synchronize()
    assert preprocess_kernel.launches == before + 1
    n, h, w, _ = shape
    assert got[0].shape == ref[0].shape == (n, h, w, 1)
    assert got[1].shape == ref[1].shape == (n, h // up, w // up, 1)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-6


def test_gray_degrade_rejects_what_it_cannot_take(dev):
    x = u8(0, (2, 32, 32, 3), dev)
    before = preprocess_kernel.launches
    for bad in (x.float(), x[:, :, ::2], x[..., :2].contiguous(), x[:, :1, :1].contiguous()):
        with pytest.raises(ValueError):
            preprocess_kernel.fused_gray_degrade(bad, 2)
    assert preprocess_kernel.launches == before


@pytest.fixture
def small_rddbnet(monkeypatch):
    """The registry's RDDBNet at nf=16, nb=1, gc=8 for the trainers of a test."""
    import functools

    monkeypatch.setitem(models.REGISTRY, "RDDBNet",
                        functools.partial(models.RDDBNet, nf=16, nb=1, gc=8))


def test_trainer_fused_input_launches_the_kernel(dev, small_rddbnet):
    """A CUDA batch never reaches the plain version: every uint8 step of a
    fused-input trainer launches the kernel once, and its step equals the
    unfused step to the fp32 tolerance of tests/test_fused.py."""
    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.train.cas import CasTrainer

    kw = dict(sr_model="RDDBNet", c_model="ResDeconv", up=2, device=dev)
    src, tar = u8(1, (2, 32, 32, 3), dev), u8(2, (2, 32, 32, 3), dev)
    with config.precision("fp32"):
        fused, plain = CasTrainer(fused_input=True, **kw), CasTrainer(**kw)
        st_f, st_p = fused.init(0), plain.init(0)
        before = preprocess_kernel.launches
        st_f, m_f = fused.train_step_u8(st_f, src, tar, 1e-4)
        st_f, m_k = fused.train_steps_u8(st_f, torch.stack([src] * 2), torch.stack([tar] * 2),
                                         1e-4)
        assert preprocess_kernel.launches == before + 3
        assert m_k["loss_SR"].shape == (2,)
        _, m_p = plain.train_step_u8(st_p, src, tar, 1e-4)
    for k in ("loss_SR", "loss_C"):
        assert abs(m_f[k].item() - m_p[k].item()) <= 1e-6 * abs(m_p[k].item()) + 1e-7


def test_transfer_sees_weights_after_adam_step(dev, small_rddbnet):
    """Adam updates the parameters in place on the card; RDDBNet's cached eval
    weights must follow (the eval x4 bf16 transfer takes the tail kernel)."""
    import copy

    from srcgan_tpu_torch.train.cas import CasTrainer

    tr = CasTrainer(sr_model="RDDBNet", c_model="ResDeconv", up=4, device=dev)
    state = tr.init(1)
    real_a = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(1)).to(dev)
    before = tail_kernel.launches
    tr.transfer(state, real_a.bfloat16())
    assert tail_kernel.launches == before + 1
    tr.transfer(state, real_a)                          # fills the fp32 fold cache
    state, _ = tr.train_step_u8(state, u8(3, (2, 64, 64, 3), dev), u8(4, (2, 64, 64, 3), dev),
                                1e-2)
    _, got, _ = tr.transfer(state, real_a)
    fresh = copy.deepcopy(state.sr.model).eval()
    fresh._prepared = (None, None)
    with torch.no_grad():
        want = fresh(tr._degrade(real_a).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)   # stale weights: O(1e-2)


@pytest.mark.parametrize("fused", [True, False])
def test_train_step_never_waits_for_the_card(dev, small_rddbnet, fused):
    """After the first step (which copies the cached constants: sampling
    matrices, tap tables, luma weights, the tail's fold indices), a bf16
    uint8 step enqueues its work without one synchronizing call, so the host
    can run ahead of the card."""
    from srcgan_tpu_torch.train.cas import CasTrainer

    tr = CasTrainer(sr_model="RDDBNet", c_model="ResDeconv", up=2, device=dev,
                    act_dtype=torch.bfloat16, fused_input=fused)
    state = tr.init(0)
    src, tar = u8(5, (2, 32, 32, 3), dev), u8(6, (2, 32, 32, 3), dev)
    state, _ = tr.train_step_u8(state, src, tar, 1e-4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = tr.train_step_u8(state, src, tar, 1e-4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
