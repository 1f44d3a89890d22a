"""srcgan_tpu_torch on an NVIDIA card: the sm_90a kernels against their plain
versions, the model gate that routes the x4 bf16 tail through them, the
trainer's fused-input path through the gray+degrade kernel, and the metrics
and the eval tool through the ssim kernel, and the RDB5 kernel (both forms),
the fused RDB5 schedule and the int8 predictor through it, the six probe
kernels, the LAB predictor, the CycleGAN step and eval tool (one ssim
launch per test image), the multi-task GAN step (no kernel), a full-width
instance-norm generator's gradients, two zoo models' forwards, and the serve
daemon's one predictor serving requests and scenes from two threads at once.

Every test here needs a card (marker ``cuda``) and skips without one.  The
file imports no jax, so it also runs where jax is not installed; there the
suite's conftest (which pins jax to the CPU) is left out:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Kernel tolerances, as for the Pallas kernels: tail_x4 max|diff| <=
0.02 * max(max|ref|, 1) (bf16 staging of t1, z2 and zall, different sum
orders); gray_degrade max|diff| <= 1e-6 (fp32, the same taps and order);
ssim max|diff| <= 1e-6 on SSIM and cs (fp32; the kernel sums 2 x 11 taps, its
plain version 121: the bound the JAX package holds its two forms to);
rdb5_int8 rel-L2 <= 1e-2 and rdb5_bf16 rel-L2 <= 2e-2 (the bounds of
tests/test_quant_kernel.py; the int8 form is expected bit-equal, since both
sides sum exact integers and round the same fp32 steps); the probes' int8
forms and the roll bit-equal, their bf16 dots rel-L2 <= 1e-3 on fp32 outputs
and <= 1e-2 on probe_matmul's bf16 output.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from srcgan_tpu_torch import models
from srcgan_tpu_torch.ops.kernels import (preprocess_kernel, probe_kernels, rdb5_kernel,
                                          ssim_kernel, tail_kernel)
from srcgan_tpu_torch.probes import common

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


@pytest.mark.parametrize("ou", [1, 3])
@pytest.mark.parametrize("nf", [16, 32, 48, 64])
@pytest.mark.parametrize("size", ["small", "full"])
def test_tail_kernel_every_width(dev, size, nf, ou):
    """Every nf the gate takes (padded to 16) and ou in {1, 3}, at a small
    shape with a ragged last tile and at the serving shape (8,128,128,nf)."""
    n, h, w = (3, 8, 16) if size == "small" else (8, 128, 128)
    t0, d1, d2, lw, lb = tail_args(nf + ou, n, h, w, nf, ou, dev)
    before = tail_kernel.launches, tail_kernel.finish_launches
    got = tail_kernel.tail_x4_fused(t0, tail_kernel.prepare(d1, d2, lw), lb)
    ref = tail_kernel.tail_x4_reference(t0, d1, d2, lw, lb)
    torch.cuda.synchronize()
    assert (tail_kernel.launches, tail_kernel.finish_launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == ref.shape == (n, 4 * h, 4 * w, ou)
    err, scale = (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
    assert err <= 0.02 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("nf", [16, 32, 48, 64])
def test_tail_accumulator_chains_into_the_next_product(dev, nf):
    """GEMM 1's wgmma accumulator, through LeakyReLU and bf16, is GEMM 2's A
    operand in registers: the first 64 rows and the first z2 chunk alone."""
    from srcgan_tpu_torch.probes import tail_ablate

    t0m, tw = tail_ablate.inputs(torch.Generator().manual_seed(nf), 1, dev, (1, 8, 8, nf))
    got, ref = tail_ablate.chain(t0m, tw), tail_ablate.chain_reference(t0m, tw)
    torch.cuda.synchronize()
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-3


@pytest.mark.parametrize("ou", [1, 3])
def test_tail_finish_kernel_equals_plain_version(dev, ou):
    """The finish pass sums the taps in fp32 in the plain version's order and
    rounds once: the two agree bit for bit."""
    g = torch.Generator().manual_seed(ou)
    n, h, w = 2, 16, 24
    zall = torch.randn(n * h * w, 144 * ou, generator=g).to(dev, torch.bfloat16)
    lb = torch.randn(ou, generator=g).to(dev)
    for bias in (None, lb):
        got = tail_kernel._finish_kernel(zall, n, h, w, ou, bias)
        ref = tail_kernel.finish_reference(zall, n, h, w, ou, bias)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


def test_tail_kernel_rejects_what_it_cannot_run(dev):
    t0, d1, d2, lw, lb = tail_args(0, 1, 16, 16, 16, 1, dev)
    tw = tail_kernel.prepare(d1, d2, lw)
    with pytest.raises(ValueError):
        tail_kernel.tail_x4_fused(t0.float(), tw, lb)
    with pytest.raises(ValueError):
        tail_kernel.tail_x4_fused(t0[:, :12], tw, lb)


def test_rddbnet_gate(dev):
    """Eval bf16 x4 on the card takes the kernels, the main one and the
    finish once each per forward; fp32, training mode and x2 take the
    phase-folded tail.  Both tails agree."""
    g = torch.Generator().manual_seed(3)
    net = models.RDDBNet(1, 1, 4, nf=16, nb=1, device=dev, generator=g).eval()
    x = torch.rand(2, 1, 16, 16, generator=g).to(dev, memory_format=torch.channels_last)
    with torch.no_grad():
        before = tail_kernel.launches
        finish = tail_kernel.finish_launches
        y32 = net(x)
        assert tail_kernel.launches == before
        net.to(torch.bfloat16)
        y16 = net(x.bfloat16())
        assert tail_kernel.launches == before + 1 and tail_kernel.finish_launches == finish + 1
        net.train()
        y16_fold = net(x.bfloat16())
        assert tail_kernel.launches == before + 1 and tail_kernel.finish_launches == finish + 1
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


@pytest.mark.parametrize("shape,up", [((3, 25, 41, 3), 2), ((2, 17, 18, 3), 2),
                                      ((2, 36, 22, 3), 3), ((1, 40, 198, 3), 4)])
def test_gray_degrade_widths_that_are_no_multiple_of_4(dev, shape, up):
    """Rows that start and end off a 4-pixel group (the scalar head and tail),
    ragged heights whose blocks read a tap row from the bytes, and an input
    whose address is not 4-byte aligned (the scalar path throughout)."""
    n = shape[0]
    big = u8(sum(shape), (n + 1,) + shape[1:], dev)
    for x in (big[:n], big[1:]):
        assert x.is_contiguous()
        got = preprocess_kernel.fused_gray_degrade(x, up)
        ref = preprocess_kernel.gray_degrade_reference(x, up)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert (g - r).abs().max().item() <= 1e-6


def test_gray_degrade_is_one_kernel_a_call(dev):
    x = u8(7, (8, 256, 256, 3), dev)
    names = common.device_kernels(lambda: preprocess_kernel.fused_gray_degrade(x, 2))
    assert sum(names.values()) == 1 and all("gray_degrade_kernel" in k for k in names), names


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


def ssim_pair(seed, shape, scale, dev):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=g)
    y = (x + 0.1 * torch.randn(shape, generator=g)).clamp(0, 1)
    return (x * scale).to(dev), (y * scale).to(dev)


@pytest.mark.parametrize("shape", [(8, 256, 256, 3), (2, 512, 512, 3), (3, 250, 198, 1),
                                   (1, 24, 40, 1), (2, 43, 75, 2), (1, 11, 11, 3)])
@pytest.mark.parametrize("scale", [1.0, 255.0])
def test_ssim_kernel_matches_plain_version(dev, shape, scale):
    """The eval shape, 512^2, ragged tiles, a single-output plane; every mode."""
    from srcgan_tpu_torch import config

    x, y = ssim_pair(sum(shape), shape, scale, dev)
    if shape[0] > 1:
        x[0], y[0] = x[0] / scale, y[0] / scale          # mixed per-sample ranges
    for kw in (dict(), dict(size_average=False), dict(full=True),
               dict(size_average=False, per_sample_range=True, full=True)):
        before = ssim_kernel.launches
        got = ssim_kernel.ssim_fused(x, y, **kw)
        assert ssim_kernel.launches == before + 1
        with config.precision("fp32"):
            ref = ssim_kernel.ssim_reference(x, y, **kw)
        torch.cuda.synchronize()
        for g, r in zip(got if kw.get("full") else (got,), ref if kw.get("full") else (ref,)):
            assert g.shape == r.shape and g.is_cuda
            assert (g - r).abs().max().item() <= 1e-6, (kw, (g - r).abs().max().item())


def test_ssim_other_windows_and_determinism(dev):
    from srcgan_tpu_torch import config

    x, y = ssim_pair(1, (2, 64, 80, 3), 1.0, dev)
    for w_size in (3, 5, 7, 9):
        with config.precision("fp32"):
            ref = ssim_kernel.ssim_reference(x, y, w_size=w_size)
        assert (ssim_kernel.ssim_fused(x, y, w_size=w_size) - ref).abs().item() <= 1e-6
    runs = [ssim_kernel.ssim_fused(x, y, size_average=False, full=True) for _ in range(3)]
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))    # no float atomics


SSIM_MODES = [dict(size_average=True), dict(size_average=False),
              dict(size_average=True, full=True),
              dict(size_average=False, per_sample_range=True),
              dict(size_average=False, full=True, per_sample_range=True)]


@pytest.mark.parametrize("mode", range(len(SSIM_MODES)))
def test_ssim_is_two_kernels_a_call_and_bit_equal(dev, mode):
    """At the eval shape with mixed per-sample ranges: at most two device
    kernels a call (the range pass, the main pass with its finish), three
    calls bit-equal, and the L the range pass wrote is the plain version's."""
    kw = SSIM_MODES[mode]
    x, y = ssim_pair(11, (8, 256, 256, 3), 255.0, dev)
    x[1::2], y[1::2] = x[1::2] / 255.0, y[1::2] / 255.0
    names = common.device_kernels(lambda: ssim_kernel.ssim_fused(x, y, **kw))
    assert 1 <= sum(names.values()) <= 2, names
    runs = [ssim_kernel.ssim_fused(x, y, **kw) for _ in range(3)]
    for again in runs[1:]:
        for a, b in zip(again if kw.get("full") else (again,), runs[0] if kw.get("full") else (runs[0],)):
            assert torch.equal(a, b)
    per_sample = kw.get("per_sample_range", False)
    key = (8, 256, 256, 3, 11, ssim_kernel.strip_width(3), ssim_kernel.TILE)
    stream = torch.cuda.current_stream().cuda_stream
    written = ssim_kernel.sample_ranges(torch.cuda.current_device(), stream, key)
    assert torch.equal(written, ssim_kernel.dynamic_range(x, per_sample))


def test_ssim_bf16_inputs_are_filtered_in_fp32(dev):
    from srcgan_tpu_torch import config

    x, y = ssim_pair(12, (2, 64, 64, 3), 1.0, dev)
    xb, yb = x.bfloat16(), y.bfloat16()
    for kw in SSIM_MODES:
        got = ssim_kernel.ssim_fused(xb, yb, **kw)
        same = ssim_kernel.ssim_fused(xb.float(), yb.float(), **kw)
        with config.precision("fp32"):
            ref = ssim_kernel.ssim_reference(xb.float(), yb.float(), **kw)
        for g, s, r in zip(*((t if kw.get("full") else (t,)) for t in (got, same, ref))):
            assert g.dtype == torch.float32 and torch.equal(g, s)
            assert (g - r).abs().max().item() <= 1e-6


def test_ssim_dispatch_and_refusals(dev):
    """A CUDA tensor launches or raises; it never reaches the plain version."""
    from srcgan_tpu_torch import metrics

    x, y = ssim_pair(2, (2, 32, 32, 3), 1.0, dev)
    before = ssim_kernel.launches
    metrics.ssim(x, y)
    metrics.ssim_per_sample(x, y)
    metrics.SSIM()(x.bfloat16(), y.bfloat16())
    assert ssim_kernel.launches == before + 3
    metrics.ssim(x.cpu(), y.cpu())
    assert ssim_kernel.launches == before + 3
    for call in (lambda: metrics.ssim(x.requires_grad_(), y), lambda: metrics.ssim(x[:, :8], y[:, :8]),
                 lambda: metrics.ssim(x.detach(), y.cpu()),
                 lambda: metrics.ssim(x.detach(), y, w_size=4)):
        with pytest.raises(ValueError):
            call()
    assert ssim_kernel.launches == before + 3


def test_metrics_never_wait_for_the_card(dev):
    """The dynamic-range detection is branchless: after the first call (which
    builds and loads the kernel) the four per-sample metrics enqueue without
    one synchronizing call."""
    from srcgan_tpu_torch import metrics

    x, y = ssim_pair(3, (4, 64, 64, 3), 255.0, dev)
    evals = metrics.per_sample_evaluators()
    [fn(x, y) for _, fn in evals]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = torch.stack([fn(x, y) for _, fn in evals])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.shape == (4, 4) and bool(torch.isfinite(out).all())


def test_eval_cli_on_the_card(dev, tmp_path, small_rddbnet):
    """train_cas and test_cas default to the card; every eval batch launches
    the ssim kernel once; the row agrees with --device cpu."""
    from srcgan_tpu_torch import data
    from srcgan_tpu_torch.cli import test_cas, train_cas

    data.make_synthetic_dataset(str(tmp_path / "Sat2Aerx1"), n_train=4, n_val=1, n_test=5,
                                size=32, colorizable=True)
    ck = tmp_path / "ck"
    state = train_cas.main(["--data-dir", str(tmp_path), "--SRModel", "RDDBNet", "--up", "2",
                            "--num-epochs", "1", "--save-every", "1", "--batch-size", "2",
                            "--checkpoints", str(ck), "--run-dir", str(tmp_path / "run")])
    assert next(state.sr.model.parameters()).is_cuda
    args = ["--netGA", str(ck / "RDDBNet_A2C_x2_0001.npz"), "--netGB",
            str(ck / "ResDeconv_C2B_x2_0001.npz"), "--data-dir", str(tmp_path), "--batch-size", "2"]
    before = ssim_kernel.launches
    on_card = test_cas.main(args + ["--result-dir", str(tmp_path / "card")])
    assert ssim_kernel.launches == before + 3 and on_card["device"].startswith("cuda")
    on_cpu = test_cas.main(args + ["--result-dir", str(tmp_path / "cpu"), "--device", "cpu"])
    assert ssim_kernel.launches == before + 3
    assert abs(on_card["PSNR"] - on_cpu["PSNR"]) <= 0.01
    assert abs(on_card["SSIM"] - on_cpu["SSIM"]) <= 1e-4


def test_entry_points_default_to_the_card(dev):
    from srcgan_tpu_torch.serving import CascadePredictor
    from srcgan_tpu_torch.train.cas import CasTrainer

    assert CasTrainer("ESPCN", "ResDeconv").device.type == "cuda"
    pred = CascadePredictor(models.ESPCN(1, 1, 2), models.ResDeconv(1, 3), 2)
    assert pred.device.type == "cuda" and next(pred.sr_model.parameters()).is_cuda


# ---------------------------------------------------------------------------
# The RDB5 kernel, the fused schedule and the int8 predictor
# ---------------------------------------------------------------------------

def rdb5_case(seed, shape, dev):
    from srcgan_tpu_torch.models.blocks import ResidualDenseBlock5

    g = torch.Generator().manual_seed(seed)
    blk = ResidualDenseBlock5(64, 32).eval().requires_grad_(False)
    with torch.no_grad():
        for _, b in blk.convs():
            b.normal_(0, 0.1, generator=g)       # the border mask only shows with biases
    blk.to(dev)
    x = (torch.rand(shape, generator=g) * 2 - 0.5).to(dev)
    with torch.no_grad():
        _, cat = blk.forward_with_sources(x.permute(0, 3, 1, 2))
    return blk, x, cat.abs().amax(dim=(0, 2, 3))


@pytest.mark.parametrize("shape", [(8, 128, 128, 64), (1, 15, 128, 64), (2, 24, 512, 64),
                                   (2, 40, 512, 64)])
def test_rdb5_kernel_matches_plain_versions(dev, shape):
    """The serving shape, a ragged one-tile-row image and two 512-wide ones
    whose heights are no multiples of the tile's (two and three tile rows):
    every image edge and a ragged last tile.  The int8 form sums exact
    integers and rounds the same fp32 steps as its plain version: no element
    differs."""
    assert 15 % rdb5_kernel.TILE_H and 24 % rdb5_kernel.TILE_H and 40 % rdb5_kernel.TILE_H
    blk, x, absmax = rdb5_case(sum(shape), shape, dev)
    w8, wb = rdb5_kernel.prep_int8(blk.convs(), absmax), rdb5_kernel.prep_bf16(blk.convs())
    before = rdb5_kernel.launches_int8, rdb5_kernel.launches_bf16, rdb5_kernel.reference_calls
    got8 = rdb5_kernel.rdb5_int8_fused(x, w8)
    got16 = rdb5_kernel.rdb5_bf16_fused(x.bfloat16(), wb)
    torch.cuda.synchronize()
    assert (rdb5_kernel.launches_int8, rdb5_kernel.launches_bf16,
            rdb5_kernel.reference_calls) == (before[0] + 1, before[1] + 1, before[2])
    ref8 = rdb5_kernel.rdb5_int8_reference(x, w8)
    ref16 = rdb5_kernel.rdb5_bf16_reference(x.bfloat16(), wb)
    assert got8.shape == ref8.shape == shape and got8.dtype == torch.float32
    assert got16.shape == shape and got16.dtype == torch.bfloat16
    assert ((got8 - ref8).norm() / ref8.norm()).item() <= 1e-2
    assert int((got8 != ref8).sum()) == 0
    assert ((got16.float() - ref16.float()).norm() / ref16.float().norm()).item() <= 2e-2
    with torch.no_grad():
        fp32 = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert ((got8 - fp32).norm() / fp32.norm()).item() <= 0.06
    assert ((got16.float() - fp32).norm() / fp32.norm()).item() <= 2e-2


def test_rdb5_design_variants_match_plain_versions(dev):
    """Every compile-time variant of csrc/rdb5.cu that the ablation times
    (weights from L2 or staged, scalar A reads or ldmatrix, mma.sync or
    wgmma) computes the same block: int8 bit-equal, bf16 rel-L2 <= 2e-2."""
    from srcgan_tpu_torch.probes import rdb5_ablate

    shape = (1, 40, 128, 64)
    blk, x, absmax = rdb5_case(5, shape, dev)
    w8, wb = rdb5_kernel.prep_int8(blk.convs(), absmax), rdb5_kernel.prep_bf16(blk.convs())
    ref8 = rdb5_kernel.rdb5_int8_reference(x, w8)
    ref16 = rdb5_kernel.rdb5_bf16_reference(x.bfloat16(), wb).float()
    for label, defines in rdb5_ablate.VARIANTS:
        got8 = rdb5_ablate.launch_variant(x, w8, True, defines)
        got16 = rdb5_ablate.launch_variant(x.bfloat16(), wb, False, defines).float()
        torch.cuda.synchronize()
        assert int((got8 != ref8).sum()) == 0, label
        assert ((got16 - ref16).norm() / ref16.norm()).item() <= 2e-2, label


def test_no_schedule_scoped_takes_the_kernel_on_the_card(dev):
    """An eval bf16 block on a supported shape with no schedule scoped: one
    rdb5_bf16 launch, the fused schedule's output; rdb5_schedule("naive"),
    fp32, training mode or a gradient asked for keep the cuDNN forms."""
    from srcgan_tpu_torch.models.blocks import rdb5_schedule

    blk, x, _ = rdb5_case(7, (1, 16, 128, 64), dev)
    blk = blk.to(torch.bfloat16)
    xb = x.bfloat16().permute(0, 3, 1, 2)
    with torch.no_grad():
        before = rdb5_kernel.launches_bf16
        got = blk(xb)
        assert rdb5_kernel.launches_bf16 == before + 1
        with rdb5_schedule("fused"):
            assert torch.equal(blk(xb), got)
        before = rdb5_kernel.launches_bf16
        with rdb5_schedule("naive"):
            naive = blk(xb)
        blk.float()(x.permute(0, 3, 1, 2))
        blk.to(torch.bfloat16).train()(xb)
        blk.eval()
    leaf = xb.clone().requires_grad_(True)
    blk(leaf).sum().backward()
    assert leaf.grad is not None and rdb5_kernel.launches_bf16 == before
    assert ((got.float() - naive.float()).norm() / naive.float().norm()).item() <= 2e-2


def test_bf16_predictor_keeps_batchnorm_statistics_fp32(dev):
    """bf16 serving casts parameters only: BatchNorm's running statistics stay
    fp32 on the card, and the output is that of the CPU predictor."""
    import copy

    import numpy as np

    from srcgan_tpu_torch.serving import CascadePredictor

    g = torch.Generator().manual_seed(3)
    sr, c = models.RDDBNet(1, 1, 4, nf=16, nb=1, generator=g), models.ResDeconv(1, 3, BN="BN",
                                                                                 generator=g)
    with torch.no_grad():
        c.pred.weight.mul_(0.01)
        for name, b in c.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(0, 0.3, generator=g)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 2.0, generator=g)
    mean = c.bn1.running_mean.clone()
    on_cpu = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True, device="cpu")
    pred = CascadePredictor(sr, c, 4, bf16=True, device=dev)
    buffers = [b for b in pred.c_model.buffers() if b.is_floating_point()]
    assert buffers and all(b.dtype == torch.float32 and b.is_cuda for b in buffers)
    assert pred.c_model.conv1.weight.dtype == torch.bfloat16
    assert torch.equal(pred.c_model.bn1.running_mean.cpu(), mean)
    x = np.random.default_rng(4).integers(0, 256, (2, 16, 16, 1), dtype=np.uint8)
    diff = np.abs(pred.predict(x).astype(int) - on_cpu.predict(x).astype(int))
    assert diff.mean() <= 1.0, (diff.mean(), diff.max())


def test_rdb5_kernel_rejects_what_it_cannot_run(dev):
    blk, x, absmax = rdb5_case(0, (1, 16, 128, 64), dev)
    w8, wb = rdb5_kernel.prep_int8(blk.convs(), absmax), rdb5_kernel.prep_bf16(blk.convs())
    for bad in (lambda: rdb5_kernel.rdb5_int8_fused(x.bfloat16(), w8),
                lambda: rdb5_kernel.rdb5_bf16_fused(x, wb),
                lambda: rdb5_kernel.rdb5_int8_fused(x[:, :, :100], w8),
                lambda: rdb5_kernel.rdb5_int8_fused(x, w8._replace(sw=w8.sw[:1].expand(5, 64))),
                lambda: rdb5_kernel.rdb5_int8_fused(x, w8._replace(rq=w8.rq.cpu())),
                lambda: rdb5_kernel.rdb5_bf16_fused(x.bfloat16(), wb._replace(frag=w8.frag))):
        with pytest.raises(ValueError, match="rdb5"):
            bad()
    # a strided view of x is made contiguous, not refused
    wide = torch.cat([x, x], 2)
    got = rdb5_kernel.rdb5_int8_fused(wide[:, :, :128], w8)
    assert torch.equal(got, rdb5_kernel.rdb5_int8_fused(x, w8))


def test_fused_schedule_runs_the_trunk_through_the_kernel(dev):
    """RDDBNet nb=3 in bf16 under rdb5_schedule("fused"), and with no schedule
    scoped: 9 launches per eval forward, none in training mode, fp32 or at an
    unsupported width, and none under rdb5_schedule("naive")."""
    from srcgan_tpu_torch.models.blocks import rdb5_schedule

    g = torch.Generator().manual_seed(11)
    net = models.RDDBNet(1, 1, 4, generator=g).to(dev, torch.bfloat16).eval().requires_grad_(False)
    x = torch.rand(2, 1, 16, 128, generator=g).to(dev, torch.bfloat16,
                                                   memory_format=torch.channels_last)
    with torch.no_grad():
        before = rdb5_kernel.launches_bf16
        with rdb5_schedule("naive"):
            plain = net(x)
        assert rdb5_kernel.launches_bf16 == before
        with rdb5_schedule("fused"):
            fused = net(x)
            assert rdb5_kernel.launches_bf16 == before + 9
            net(x[:, :, :, :100])
            net.float()(x.float())
            net.bfloat16().train()
            net(x)
            net.eval()
            assert rdb5_kernel.launches_bf16 == before + 9
        assert torch.equal(net(x), fused)
        assert rdb5_kernel.launches_bf16 == before + 18
    torch.cuda.synchronize()
    assert ((fused.float() - plain.float()).norm() / plain.float().norm()).item() <= 2e-2


def test_int8_predictor_on_the_card(dev):
    """Full-width x4 cascade: 9 rdb5_int8 launches per forward and no plain
    version; after the first predict no int8 forward waits for the card or
    copies from the host; close to the same predictor on the CPU."""
    import copy

    import numpy as np

    from srcgan_tpu_torch import quant
    from srcgan_tpu_torch.serving import CascadePredictor

    g = torch.Generator().manual_seed(12)
    sr, c = models.RDDBNet(1, 1, 4, generator=g), models.ResDeconv(1, 3, generator=g)
    with torch.no_grad():
        c.pred.weight.mul_(0.03)
    rng = np.random.default_rng(12)
    batches = [rng.integers(0, 256, (2, 16, 128, 1), dtype=np.uint8) for _ in range(2)]
    on_cpu = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device="cpu", int8=True)
    pred = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device=dev, int8=True)
    with pytest.raises(RuntimeError, match="calibrate"):
        pred.predict(batches[0])
    pred.calibrate(batches)
    on_cpu.int8_scales = pred.int8_scales
    before = rdb5_kernel.launches_int8, rdb5_kernel.reference_calls
    first = pred.predict(batches[0])
    assert rdb5_kernel.launches_int8 == before[0] + 9
    assert rdb5_kernel.reference_calls == before[1]
    x = torch.from_numpy(batches[0]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with quant.quant_mode("int8", pred.int8_scales, pred._int8_prepared):
            again = pred._run(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.array_equal(again.cpu().numpy(), first)
    assert rdb5_kernel.launches_int8 == before[0] + 18
    # the same integers on both; the fp32 layers between them sum in other
    # orders and flip requantization rounds: closer to each other than to fp32
    want = on_cpu.predict(batches[0])
    fp32 = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device=dev).predict(batches[0])
    noise = np.abs(first.astype(int) - fp32.astype(int)).mean()
    assert np.abs(first.astype(int) - want.astype(int)).mean() <= noise


# -- the probes ---------------------------------------------------------------

def probe_operand(seed, shape, dtype, dev):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-100, 100, shape, generator=g).to(dev, torch.int8)
    return (torch.rand(shape, generator=g) * 2 - 1).to(dev, torch.bfloat16)


def probe_rel_l2(got, ref):
    got, ref = got.double(), ref.double()
    return ((got - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("m,k,n", [(16384, 64, 64), (16384, 576, 192), (128, 192, 128)])
def test_probe_matmul_matches_plain_version(dev, dtype, m, k, n):
    x, w = probe_operand(k, (m, k), dtype, dev), probe_operand(n, (k, n), dtype, dev)
    before = probe_kernels.launches["probe_matmul"], probe_kernels.matmul_int8_launches
    got, ref = probe_kernels.probe_matmul(x, w), probe_kernels.probe_matmul_reference(x, w)
    torch.cuda.synchronize()
    assert probe_kernels.launches["probe_matmul"] == before[0] + 1
    assert probe_kernels.matmul_int8_launches == before[1] + (dtype == torch.int8)
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape == (m, n)
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert probe_rel_l2(got, ref) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n", [64, 128, 192])
@pytest.mark.parametrize("k", [64, 192, 576])
def test_probe_matmul_every_sweep_shape(dev, k, n, dtype):
    """Every (K, N) of the matmul sweep at M = 16384: the bf16 form (its own
    wgmma kernel) within rel-L2 1e-2, the int8 form bit-equal."""
    x, w = probe_operand(k + n, (16384, k), dtype, dev), probe_operand(n, (k, n), dtype, dev)
    before = probe_kernels.launches["probe_matmul"]
    got, ref = probe_kernels.probe_matmul(x, w), probe_kernels.probe_matmul_reference(x, w)
    torch.cuda.synchronize()
    assert probe_kernels.launches["probe_matmul"] == before + 1
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert probe_rel_l2(got, ref) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("k,n", [(576, 192), (192, 128), (288, 128), (32, 192), (64, 64)])
def test_probe_mxu_and_dots_match_plain_versions(dev, dtype, k, n):
    """The int8 chain is tried on a pair whose selection alternates: y[0,0] is
    odd for x and even for clip(x + 1)."""
    x, w = probe_operand(k, (8320, k), dtype, dev), probe_operand(n, (k, n), dtype, dev)
    if dtype == torch.int8:
        common.alternate_int8(x, w)
        y = int(probe_kernels._dot(x[:1], w[:, :1])[0, 0])
        y2 = int(probe_kernels._dot(probe_kernels._int8_next(x[:1]), w[:, :1])[0, 0])
        assert y % 2 == 1 and y2 % 2 == 0
        got, ref = probe_kernels.probe_mxu(x, w, 16), probe_kernels.probe_mxu_reference(x, w, 16)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and torch.equal(got, ref)
        assert not torch.equal(got, 16 * probe_kernels._dot(x, w))
        return
    for fn, plain in ((probe_kernels.probe_mxu, probe_kernels.probe_mxu_reference),
                      (probe_kernels.probe_dots, probe_kernels.probe_dots_reference)):
        got, ref = fn(x, w, 16), plain(x, w, 16)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and probe_rel_l2(got, ref) <= 1e-3


CHAIN_SWEEP = ([("probe_mxu", 8320, k, n, dt) for dt in (torch.bfloat16, torch.int8)
                for k, n in ((576, 128), (576, 192), (192, 128), (288, 128))]
               + [("probe_dots", 16384, k, n, torch.bfloat16)
                  for k, n in ((32, 192), (64, 192), (64, 64), (128, 192), (128, 128), (576, 192))])


@pytest.mark.parametrize("name,m,k,n,dtype", CHAIN_SWEEP,
                         ids=[f"{p}-{'int8' if d == torch.int8 else 'bf16'}-{k}-{n}"
                              for p, m, k, n, d in CHAIN_SWEEP])
def test_chain_kernel_every_sweep_shape(dev, name, m, k, n, dtype):
    """The chain kernel at every shape of both sweeps: int8 bit-equal to the
    plain version on operands whose chain takes both, bf16 within rel-L2
    1e-3; three calls bit-equal; one count a call."""
    fn, plain = {"probe_mxu": (probe_kernels.probe_mxu, probe_kernels.probe_mxu_reference),
                 "probe_dots": (probe_kernels.probe_dots, probe_kernels.probe_dots_reference)}[name]
    x, w = probe_operand(k + 3, (m, k), dtype, dev), probe_operand(n + 5, (k, n), dtype, dev)
    if dtype == torch.int8:
        common.alternate_int8(x, w)
    before = probe_kernels.launches[name]
    got = [fn(x, w, 16) for _ in range(3)]
    ref = plain(x, w, 16)
    torch.cuda.synchronize()
    assert probe_kernels.launches[name] == before + 3
    assert all(torch.equal(g, got[0]) for g in got[1:])
    if dtype == torch.int8:
        assert got[0].dtype == torch.int32 and torch.equal(got[0], ref)
        assert not torch.equal(got[0], 16 * probe_kernels._dot(x, w))
    else:
        assert got[0].dtype == torch.float32 and probe_rel_l2(got[0], ref) <= 1e-3


# The kernels a probe_mxu call runs, read by the profiler in a fresh process:
# after many launches in one process the profiler has been seen to drop most
# device events of a window, so a count read in the test's own process is no
# count.  Prints a JSON object, kernel name -> launches a call.
PROFILE_CHAIN = """
import json, sys, torch
from srcgan_tpu_torch.ops.kernels import probe_kernels as pk
from srcgan_tpu_torch.probes import common
dtype = getattr(torch, sys.argv[1])
g = torch.Generator().manual_seed(9)
if dtype == torch.int8:
    x, w = (torch.randint(-100, 100, s, generator=g).to("cuda", dtype) for s in ((8320, 576), (576, 192)))
else:
    x, w = ((torch.rand(s, generator=g) * 2 - 1).to("cuda", dtype) for s in ((8320, 576), (576, 192)))
print(json.dumps(common.device_kernels(lambda: pk.probe_mxu(x, w, 16))))
"""


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_chain_kernel_launches_and_memory(dev, dtype):
    """bf16: the chain kernel is the one device kernel a call runs, and
    nothing is allocated but the output; int8: w's image, then the chain, one
    launch of each a call, and a scratch of chain_plan's size."""
    root = Path(__file__).resolve().parents[1]
    x, w = probe_operand(9, (8320, 576), dtype, dev), probe_operand(10, (576, 192), dtype, dev)
    plan = probe_kernels.chain_plan(8320, 576, 192, dtype)
    run = subprocess.run([sys.executable, "-c", PROFILE_CHAIN, str(dtype).split(".")[-1]],
                         capture_output=True, text=True, timeout=600, cwd=root, check=True,
                         env={**os.environ, "PYTHONPATH": str(root)})
    kernels = json.loads(run.stdout.strip().splitlines()[-1])
    known = ("chain_kernel", "s8_image_kernel")
    assert all(any(name in key for name in known) for key in kernels), kernels
    ran = {name for name in known if any(name in key for key in kernels)}
    want = {"chain_kernel"} if dtype == torch.bfloat16 else set(known)
    assert ran == want and len(want) == plan["launches"], kernels
    assert all(count == 1 for count in kernels.values()), kernels
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = probe_kernels.probe_mxu(x, w, 16)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
    assert extra == plan["scratch_bytes"]
    assert probe_kernels._library().probes_chain_scratch_bytes(576, 192, int(dtype == torch.int8)) \
        == plan["scratch_bytes"]


def test_chain_kernel_agrees_with_the_first_design(dev):
    """The PROBES_CHAIN=0 build (the chain on dots_kernel, the yardstick of
    the ablation and of chip_smoke.py) still computes the same chain."""
    from srcgan_tpu_torch.ops.kernels import build

    before = probe_kernels.declare(build.load("probes", ("PROBES_CHAIN=0",)))
    for dtype, (k, n) in ((torch.bfloat16, (64, 192)), (torch.int8, (576, 192))):
        x, w = probe_operand(11, (8320, k), dtype, dev), probe_operand(12, (k, n), dtype, dev)
        if dtype == torch.int8:
            common.alternate_int8(x, w)
        old = probe_kernels.chain(before, "probe_mxu", x, w, 16)
        new = probe_kernels.probe_mxu(x, w, 16)
        torch.cuda.synchronize()
        if dtype == torch.int8:
            assert torch.equal(old, new)
        else:
            assert probe_rel_l2(old, new) <= 1e-3


@pytest.mark.parametrize("form", ["concat", "twodots"])
@pytest.mark.parametrize("m,steps", [(16384, 8), (16384, 1), (320, 3)])
def test_probe_concat_dot_matches_plain_version(dev, form, m, steps):
    """The chain kernel's forms within rel-L2 1e-3 of the plain version, three
    calls bit-equal, one count a call."""
    a, w = probe_operand(1, (m, 64), torch.bfloat16, dev), probe_operand(
        2, (128, 192), torch.bfloat16, dev)
    before = probe_kernels.launches["probe_concat_dot"]
    got = [probe_kernels.probe_concat_dot(a, w, steps, form) for _ in range(3)]
    ref = probe_kernels.probe_concat_dot_reference(a, w, steps, form)
    torch.cuda.synchronize()
    assert probe_kernels.launches["probe_concat_dot"] == before + 3
    assert all(torch.equal(g, got[0]) for g in got[1:])
    assert probe_rel_l2(got[0], ref) <= 1e-3


@pytest.mark.parametrize("shift", [0, 1, 128, -1, 16383])
@pytest.mark.parametrize("steps", [1, 2, 16])
def test_probe_roll_is_bit_equal(dev, shift, steps):
    """The cluster kernel bit-equal to the plain version, three calls
    bit-equal, one count a call, the input not written."""
    a = probe_operand(3, (16384, 64), torch.bfloat16, dev)
    a[0, :3] = torch.tensor([0.0, 1e-8, -1e-8], device=dev).bfloat16()
    keep = a.clone()
    before = probe_kernels.launches["probe_roll"]
    got = [probe_kernels.probe_roll(a, shift, steps) for _ in range(3)]
    ref = probe_kernels.probe_roll_reference(a, shift, steps)
    torch.cuda.synchronize()
    assert probe_kernels.launches["probe_roll"] == before + 3
    assert torch.equal(got[0].view(torch.int16), ref.view(torch.int16))
    assert all(torch.equal(g, got[0]) for g in got[1:])
    assert torch.equal(a, keep)                                  # the input is not written


@pytest.mark.parametrize("cluster,piece", [(8, 16), (16, 16), (1, 4)])
@pytest.mark.parametrize("m,shift", [(16384, 128), (16384, 16383), (2048, 700), (512, 1)])
def test_roll_layouts_bit_equal(dev, cluster, piece, m, shift):
    """Every layout the kernel is built for (the ablation's), bit-equal to the
    plain version at 16 steps, shifts within a block's rows and across them."""
    a = probe_operand(13, (m, 64), torch.bfloat16, dev)
    plan = probe_kernels.roll_plan(m, 64, shift, cluster, piece)
    got = probe_kernels.roll(probe_kernels._library(), a, shift, 16, plan)
    ref = probe_kernels.probe_roll_reference(a, shift, 16)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("form", ["im2col", "shifted"])
@pytest.mark.parametrize("m,stride", [(16384, 128), (256, 16)])
def test_probe_stage1_matches_plain_version(dev, form, m, stride):
    x, w = probe_operand(4, (m, 64), torch.bfloat16, dev), probe_operand(
        5, (576, 192), torch.bfloat16, dev)
    got = probe_kernels.probe_stage1(x, w, 4, stride, form)
    ref = probe_kernels.probe_stage1_reference(x, w, 4, stride)
    torch.cuda.synchronize()
    assert probe_rel_l2(got, ref) <= 1e-3


@pytest.mark.parametrize("m,k,n", [(16384, k, n) for k in (64, 192, 576) for n in (64, 128, 192)])
def test_probe_matmul_int8_wraps_bit_equal(dev, m, k, n):
    """The int8 GEMM at every sweep shape: bit-equal to the plain version on
    sums that leave int8 (the cast keeps the low byte), one count a call."""
    x, w = probe_operand(k + 7, (m, k), torch.int8, dev), probe_operand(n + 1, (k, n), torch.int8, dev)
    before = probe_kernels.launches["probe_matmul"], probe_kernels.matmul_int8_launches
    got = probe_kernels.probe_matmul(x, w)
    full = probe_kernels._dot(x, w)
    torch.cuda.synchronize()
    assert probe_kernels.launches["probe_matmul"] == before[0] + 1
    assert probe_kernels.matmul_int8_launches == before[1] + 1
    assert bool((full.abs() > 127).any())                        # the cast really wraps
    assert got.dtype == torch.int8 and torch.equal(got, full.to(torch.int8))


# The device kernels a probe call runs, read by the profiler in a fresh
# process (see PROFILE_CHAIN); argv: the probe and its dtype.
PROFILE_PROBE = """
import json, sys, torch
from srcgan_tpu_torch.ops.kernels import probe_kernels as pk
from srcgan_tpu_torch.probes import common
g = torch.Generator().manual_seed(9)
if sys.argv[1] == "probe_matmul":
    x, w = (torch.randint(-100, 100, s, generator=g).to("cuda", torch.int8) for s in ((16384, 576), (576, 192)))
    fn = lambda: pk.probe_matmul(x, w)
elif sys.argv[1] == "probe_roll":
    x = (torch.rand((16384, 64), generator=g) * 2 - 1).to("cuda", torch.bfloat16)
    fn = lambda: pk.probe_roll(x, int(sys.argv[2]), 16)
elif sys.argv[1] == "probe_concat_dot":
    x, w = ((torch.rand(s, generator=g) * 2 - 1).to("cuda", torch.bfloat16) for s in ((16384, 64), (128, 192)))
    fn = lambda: pk.probe_concat_dot(x, w, 8, sys.argv[2])
else:
    x, w = ((torch.rand(s, generator=g) * 2 - 1).to("cuda", torch.bfloat16) for s in ((16384, 64), (576, 192)))
    fn = lambda: pk.probe_stage1(x, w, 4, 128, sys.argv[2])
print(json.dumps(common.device_kernels(fn)))
"""


@pytest.mark.parametrize("probe,arg,want", [
    ("probe_matmul", "int8", ("s8_image_kernel", "matmul8_kernel")),
    ("probe_stage1", "im2col", ("s1_image_kernel", "stage1_kernel")),
    ("probe_stage1", "shifted", ("s1_image_kernel", "stage1_kernel")),
    ("probe_roll", "128", ("roll_smem_kernel",)),
    ("probe_roll", "1", ("roll_smem_kernel",)),
    ("probe_concat_dot", "concat", ("chain_kernel",)),
    ("probe_concat_dot", "twodots", ("chain_kernel",))])
def test_redesigned_probes_run_their_kernels_only(dev, probe, arg, want):
    """probe_matmul's int8 form and probe_stage1 (both forms) run w's image
    and their own kernel once each a call, probe_roll its cluster kernel and
    probe_concat_dot the chain kernel once a call: no dots_kernel, no
    transpose, no cooperative roll_kernel."""
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", PROFILE_PROBE, probe, arg], capture_output=True,
                         text=True, timeout=600, cwd=root, check=True,
                         env={**os.environ, "PYTHONPATH": str(root)})
    kernels = json.loads(run.stdout.strip().splitlines()[-1])
    assert all(any(name in key for name in want) for key in kernels), kernels
    assert {name for name in want if any(name in key for key in kernels)} == set(want), kernels
    assert all(count == 1 for count in kernels.values()), kernels


@pytest.mark.parametrize("form", ["im2col", "shifted"])
@pytest.mark.parametrize("m,stride", [(16384, 128), (16384, 16), (1024, 100)])
def test_probe_stage1_three_calls_bit_equal(dev, form, m, stride):
    """The stage kernel within rel-L2 1e-3 of the plain version, three calls
    bit-equal, one count a call."""
    x, w = probe_operand(14, (m, 64), torch.bfloat16, dev), probe_operand(
        15, (576, 192), torch.bfloat16, dev)
    before = probe_kernels.launches["probe_stage1"]
    got = [probe_kernels.probe_stage1(x, w, 4, stride, form) for _ in range(3)]
    ref = probe_kernels.probe_stage1_reference(x, w, 4, stride)
    torch.cuda.synchronize()
    assert probe_kernels.launches["probe_stage1"] == before + 3
    assert all(torch.equal(g, got[0]) for g in got[1:])
    assert probe_rel_l2(got[0], ref) <= 1e-3


def test_redesigned_probes_agree_with_their_first_design(dev):
    """The PROBES_MM8=0 PROBES_STAGE1=0 PROBES_ROLL=0 PROBES_CONCAT=0 build
    (the first designs, the yardstick of the ablations and of chip_smoke.py)
    computes the same functions: int8 and the roll bit-equal, the stages and
    the pairs within rel-L2 1e-3."""
    from srcgan_tpu_torch.ops.kernels import build

    first = probe_kernels.declare(build.load("probes", ("PROBES_MM8=0", "PROBES_STAGE1=0",
                                                        "PROBES_ROLL=0", "PROBES_CONCAT=0")))
    x, w = probe_operand(16, (16384, 576), torch.int8, dev), probe_operand(17, (576, 192), torch.int8, dev)
    assert torch.equal(probe_kernels.matmul_int8(first, x, w), probe_kernels.probe_matmul(x, w))
    x, w = probe_operand(18, (16384, 64), torch.bfloat16, dev), probe_operand(
        19, (576, 192), torch.bfloat16, dev)
    for form in ("im2col", "shifted"):
        old = probe_kernels.stage1(first, x, w, 4, 128, form)
        new = probe_kernels.probe_stage1(x, w, 4, 128, form)
        torch.cuda.synchronize()
        assert probe_rel_l2(old, new) <= 1e-3
    w = probe_operand(20, (128, 192), torch.bfloat16, dev)
    for form in ("concat", "twodots"):
        old = probe_kernels.concat(first, x, w, 8, form)
        new = probe_kernels.probe_concat_dot(x, w, 8, form)
        torch.cuda.synchronize()
        assert probe_rel_l2(old, new) <= 1e-3
    for shift in (1, 128):
        assert torch.equal(probe_kernels.roll(first, x, shift, 16), probe_kernels.probe_roll(x, shift, 16))


def test_probes_reject_what_the_kernels_cannot_run(dev):
    """On a CUDA tensor a wrapper launches or raises: nothing runs the plain
    version instead."""
    x, w = probe_operand(6, (100, 64), torch.bfloat16, dev), probe_operand(
        7, (64, 64), torch.bfloat16, dev)
    before = dict(probe_kernels.launches)
    with pytest.raises(ValueError, match="M % 64"):
        probe_kernels.probe_mxu(x, w)
    with pytest.raises(ValueError, match="N in"):
        probe_kernels.probe_matmul(x[:64], w[:, :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        probe_kernels.probe_matmul(x[:64], w.t())
    with pytest.raises(ValueError, match="N=192"):
        probe_kernels.probe_concat_dot(x[:64], probe_operand(8, (128, 64), torch.bfloat16, dev))
    with pytest.raises(ValueError, match="does not fit"):
        probe_kernels.probe_stage1(x[:64], probe_operand(9, (576, 192), torch.bfloat16, dev), 4, 200)
    with pytest.raises(ValueError, match="K <= 640"):
        probe_kernels.probe_matmul(probe_operand(10, (64, 672), torch.int8, dev),
                                   probe_operand(11, (672, 64), torch.int8, dev))
    with pytest.raises(ValueError, match="8 must divide M"):
        probe_kernels.probe_roll(x, 1)                           # 100 rows, clusters of 8
    with pytest.raises(ValueError, match="does not cut"):
        probe_kernels.probe_roll(probe_operand(12, (64, 60), torch.bfloat16, dev), 1)
    with pytest.raises(ValueError, match="fit its"):
        probe_kernels.probe_roll(probe_operand(12, (8 * 8192, 64), torch.bfloat16, dev), 1)
    with pytest.raises(ValueError, match="a \\(M, 64\\)"):
        probe_kernels.probe_concat_dot(probe_operand(13, (64, 32), torch.bfloat16, dev),
                                       probe_operand(14, (64, 192), torch.bfloat16, dev))
    assert probe_kernels.launches == before


def test_probe_entry_points_run_on_the_card(dev, capsys):
    from srcgan_tpu_torch.probes import __main__ as probes_main

    for name in probe_kernels.NAMES:
        probe_kernels.launches[name] = 0
    rows = probes_main.main([])
    out = capsys.readouterr().out
    assert all(probe_kernels.launches[name] > 0 for name in probe_kernels.NAMES)
    assert len(rows["matmul"]) == 18 and len(rows["mxu"]) == 8 and len(rows["layout"]) == 12
    assert torch.cuda.get_device_name(0).split()[0] in out and " W" in out
    assert "TFLOP/s" in out and "TOP/s" in out and "GB/s" in out


# -- the LAB predictor ----------------------------------------------------------

def test_lab_predictor_on_card_matches_cpu(dev):
    """lab=True at small width: fp32 on the card within 1 LSB of the CPU; the
    bf16 x4 forward goes through the tail kernel."""
    import copy

    import numpy as np

    from srcgan_tpu_torch.serving import CascadePredictor

    gen = torch.Generator().manual_seed(3)
    sr, c = models.RDDBNet(1, 1, 4, nf=16, nb=1, generator=gen), models.ResDeconv(
        1, 2, generator=gen)
    with torch.no_grad():
        c.pred.weight.mul_(0.03)
    x = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 1), dtype=np.uint8)
    on_cpu = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, lab=True, device="cpu")
    on_card = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, lab=True, device=dev)
    a, b = on_cpu.predict(x).astype(int), on_card.predict(x).astype(int)
    assert a.shape == (2, 64, 64, 3) and np.abs(a - b).max() <= 1
    before = tail_kernel.launches
    y = CascadePredictor(sr, c, 4, lab=True, bf16=True, device=dev).predict(x)
    assert tail_kernel.launches == before + 1 and y.shape == (2, 64, 64, 3)


# -- the CycleGAN slice ---------------------------------------------------------

@pytest.fixture
def small_gan(monkeypatch):
    """The GAN trainer's generators at nf=16, nb=1, gc=8 for a test."""
    def small(cls):
        def make(in_nc, out_nc, nf=64, nb=3, gc=32, mode="x2", **kw):
            return cls(in_nc, out_nc, 16, nb=1, gc=8, mode=mode, **kw)
        return make

    monkeypatch.setitem(models.REGISTRY, "RDDBNetB", small(models.RDDBNetB))
    monkeypatch.setitem(models.REGISTRY, "RDDBNetD", small(models.RDDBNetD))


def test_gan_step_on_card_matches_cpu(dev, small_gan):
    """Two fp32 gd_steps (TF32 off, remat on): step 1 from the same weights,
    step 2 from the card's state after step 1 (parameters, D's BatchNorm
    state, both Adam moments copied to the CPU side: Adam's first update
    moves a near-zero gradient's element by +-lr whatever its rounding, so
    two trajectories part at once).  Each step: losses within rtol 1e-4 of
    the CPU's, D's running statistics within rel-L2 1e-4, each network's
    update within rel-L2 5e-2 and its parameter norm within rtol 1e-5.  The
    bf16 step on the card stays off the RDB5 kernel (training forwards keep
    the generators in train mode)."""
    import copy

    import numpy as np

    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer

    def snapshot(state):
        out = {r: torch.cat([p.detach().cpu().double().flatten()
                             for p in getattr(state, r).model.parameters()]) for r in "gd"}
        out["bn"] = torch.cat([b.detach().cpu().double().flatten()
                               for n, b in state.d.model.named_buffers() if "running" in n])
        return out

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    rng = np.random.default_rng(0)
    sides = ("cpu", dev)
    with config.precision("fp32"):
        trs = {w: CycleGANTrainer(pool_size=0, device=w) for w in sides}
        states = {w: trs[w].init(0) for w in sides}
        assert trs[dev].remat
        for step in range(2):
            real_b = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
            real_a = real_b[:, ::2, ::2].contiguous()
            if step:
                src, dst = states[dev], states["cpu"]
                for r in "gd":
                    getattr(dst, r).model.load_state_dict(getattr(src, r).model.state_dict())
                    getattr(dst, r).opt.load_state_dict(
                        copy.deepcopy(getattr(src, r).opt.state_dict()))
            before = {w: snapshot(states[w]) for w in sides}
            losses = {}
            for w in sides:
                states[w], aux = trs[w].gd_step(states[w], real_a.to(w), real_b.to(w),
                                                1e-4, 1e-5)
                losses[w] = {k: float(v) for k, v in aux.items() if v.dim() == 0}
            after = {w: snapshot(states[w]) for w in sides}
            for k, v in losses["cpu"].items():
                assert abs(losses[dev][k] - v) <= 1e-4 * abs(v), (step, k)
            assert rel(after[dev]["bn"], after["cpu"]["bn"]) <= 1e-4, step
            for r in "gd":
                assert rel(after[dev][r] - before[dev][r],
                           after["cpu"][r] - before["cpu"][r]) <= 5e-2, (step, r)
                assert abs(float(after[dev][r].norm() / after["cpu"][r].norm()) - 1) <= 1e-5
    tr = CycleGANTrainer(act_dtype=torch.bfloat16, device=dev)
    before = rdb5_kernel.launches_bf16
    _, aux = tr.optimize_parameters(tr.init(1), real_a.to(dev), real_b.to(dev))
    assert rdb5_kernel.launches_bf16 == before
    assert all(bool(torch.isfinite(v)) for v in aux.values() if v.dim() == 0)


def test_test_cyclegan_launches_ssim_once_per_image(dev, tmp_path, small_gan):
    """train_cyclegan and test_cyclegan default to the card; every test image
    launches the ssim kernel once; the row agrees with --device cpu."""
    from srcgan_tpu_torch import data
    from srcgan_tpu_torch.cli import test_cyclegan, train_cyclegan

    data.make_synthetic_dataset(str(tmp_path / "Sat2Aerx2"), n_train=2, n_val=1, n_test=3,
                                size=32, scale=2)
    ck = tmp_path / "ck"
    state = train_cyclegan.main(["--data-dir", str(tmp_path), "--num-epochs", "1",
                                 "--save-every", "1", "--checkpoints", str(ck),
                                 "--run-dir", str(tmp_path / "run")])
    assert next(state.g.model.parameters()).is_cuda
    args = ["--netGA", str(ck / "netG_A2B_SRtask_x2_0001.npz"), "--netGB",
            str(ck / "netG_B2A_SRtask_x2_0001.npz"), "--data-dir", str(tmp_path)]
    before = ssim_kernel.launches
    on_card = test_cyclegan.main(args + ["--result-dir", str(tmp_path / "card")])
    assert ssim_kernel.launches == before + 3 and on_card["device"].startswith("cuda")
    on_cpu = test_cyclegan.main(args + ["--result-dir", str(tmp_path / "cpu"),
                                        "--device", "cpu"])
    assert ssim_kernel.launches == before + 3
    assert abs(on_card["PSNR"] - on_cpu["PSNR"]) <= 0.01
    assert abs(on_card["SSIM"] - on_cpu["SSIM"]) <= 1e-4


# -- the multi-task GAN and the zoo ---------------------------------------------

def test_multitask_step_on_card_matches_cpu(dev):
    """Two fp32 gd_step_pooled steps (TF32 off, remat on) of a small
    MultiTaskTrainer (ngf 8, resnet_6blocks, batch 2 of 32^2 targets; the
    device pools pass the fakes through while they fill), step 2 from the
    card's state on both sides: losses within rtol 1e-4, D's running
    statistics within rel-L2 1e-4, each network's update within rel-L2 5e-2
    and its parameter norm within rtol 1e-5.  The bf16 iteration on the card
    launches no kernel."""
    import copy

    import numpy as np

    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.train.multitask import MultiTaskTrainer

    def snapshot(state):
        out = {r: torch.cat([p.detach().cpu().double().flatten()
                             for p in getattr(state, r).model.parameters()]) for r in "gd"}
        out["bn"] = torch.cat([b.detach().cpu().double().flatten()
                               for n, b in state.d.model.named_buffers() if "running" in n])
        return out

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    rng = np.random.default_rng(0)
    sides = ("cpu", dev)
    small = dict(ngf=8, netG="resnet_6blocks")
    with config.precision("fp32"):
        trs = {w: MultiTaskTrainer(device=w, **small) for w in sides}
        states = {w: trs[w].init(0) for w in sides}
        pools = None
        for step in range(2):
            real_b = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
            real_a = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32))
            if pools is None:
                pools = {w: trs[w].device_pool_init(states[w], real_a, real_b) for w in sides}
            if step:
                src, dst = states[dev], states["cpu"]
                for r in "gd":
                    getattr(dst, r).model.load_state_dict(getattr(src, r).model.state_dict())
                    getattr(dst, r).opt.load_state_dict(
                        copy.deepcopy(getattr(src, r).opt.state_dict()))
            before = {w: snapshot(states[w]) for w in sides}
            losses = {}
            for w in sides:
                states[w], pools[w], aux = trs[w].gd_step_pooled(
                    states[w], pools[w], real_a.to(w), real_b.to(w), 1e-4, 1e-5)
                losses[w] = {k: float(v) for k, v in aux.items() if v.dim() == 0}
            after = {w: snapshot(states[w]) for w in sides}
            for k, v in losses["cpu"].items():
                assert abs(losses[dev][k] - v) <= 1e-4 * abs(v), (step, k)
            assert rel(after[dev]["bn"], after["cpu"]["bn"]) <= 1e-4, step
            for r in "gd":
                assert rel(after[dev][r] - before[dev][r],
                           after["cpu"][r] - before["cpu"][r]) <= 5e-2, (step, r)
                assert abs(float(after[dev][r].norm() / after["cpu"][r].norm()) - 1) <= 1e-5
    tr = MultiTaskTrainer(act_dtype=torch.bfloat16, device=dev, **small)
    counts = (rdb5_kernel.launches_bf16, ssim_kernel.launches, tail_kernel.launches,
              preprocess_kernel.launches)
    _, aux = tr.optimize_parameters(tr.init(1), real_a.to(dev), real_b.to(dev))
    assert (rdb5_kernel.launches_bf16, ssim_kernel.launches, tail_kernel.launches,
            preprocess_kernel.launches) == counts
    assert all(bool(torch.isfinite(v)) for v in aux.values() if v.dim() == 0)


@pytest.mark.parametrize("name", ["DDBPN", "RCAN"])
def test_zoo_forward_on_card_matches_cpu(dev, name):
    """A zoo model's fp32 forward (TF32 off) on the card against the CPU at
    1x3x24x24 in [0, 255]: rel-L2 <= 1e-5.  DDBPN at its fixed widths
    (transposed projections, PReLU), RCAN at 2 groups of 2 (channel
    attention)."""
    import copy

    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.models.edsr_zoo import args_namespace

    kw = {"DDBPN": {}, "RCAN": dict(n_resgroups=2, n_resblocks=2)}[name]
    net = models.create(name, args_namespace(**kw),
                        generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(1, 3, 24, 24, generator=torch.Generator().manual_seed(1)) * 255
    with torch.no_grad(), config.precision("fp32"):
        want = net(x)
        got = copy.deepcopy(net).to(dev)(x.to(dev)).cpu()
    assert got.shape == want.shape == (1, 3, 48, 48)
    assert float((got - want).norm() / want.norm()) <= 1e-5


def test_instance_norm_generator_gradients_on_card_match_cpu(dev):
    """A full-width resnet_9blocks generator (ngf 64, instance norm,
    channels_last) at 128^2, fp32 TF32 off: output, input gradient and
    weight gradients on the card against the CPU.  fp32 leaves this net's
    gradient ~5e-3 apart across devices (bound 2e-2); ``F.instance_norm``'s
    backward on a channels_last gradient gave rel-L2 1.4 (uncorrelated)."""
    import copy

    from srcgan_tpu_torch import config

    g = torch.Generator().manual_seed(0)
    base = models.define_G(1, 3, 64, "resnet_9blocks", "instance", generator=g)
    x = torch.rand(1, 1, 128, 128, generator=g)
    r = torch.randn(1, 3, 128, 128, generator=g)
    out = {}
    with config.precision("fp32"):
        for w in ("cpu", dev):
            net = copy.deepcopy(base).to(w)
            xi = x.to(w).contiguous(memory_format=torch.channels_last).detach().clone()
            y = net(xi.requires_grad_(True))
            (y * r.to(w)).sum().backward()
            out[w] = [y.detach().cpu(), xi.grad.cpu(),
                      torch.cat([p.grad.flatten().cpu() for p in net.parameters()])]

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    errs = [rel(a, b) for a, b in zip(out[dev], out["cpu"])]
    assert errs[0] <= 1e-4 and errs[1] <= 2e-2 and errs[2] <= 2e-2, errs


def test_daemon_predictors_serve_shared_modules_from_two_threads(dev, tmp_path):
    """``cli.serve.make_server`` with --tile serves /predict (the Batcher's
    worker) and /predict_scene (an HTTP thread) through one TiledPredictor:
    fresh modules on one CUDA stream, whose cached operands (the tail's
    folded weights, the RDB5 kernel's packed weights) are built by whichever
    thread runs first.  Served from two threads at once, bf16, every output
    equals a sequential run on a second daemon over the same files."""
    import threading

    import numpy as np

    from srcgan_tpu_torch.cli import serve
    from srcgan_tpu_torch.interop import jax_tree_from_module
    from srcgan_tpu_torch.train.state import save_params

    g = torch.Generator().manual_seed(0)
    ga, gb = str(tmp_path / "RDDBNet_A2C_x4_0001.npz"), str(tmp_path / "SRCNN_C2B_x4_0001.npz")
    save_params(ga, jax_tree_from_module(models.RDDBNet(1, 1, 4, generator=g))[0])
    save_params(gb, jax_tree_from_module(models.SRCNN(1, 3, 1, generator=g))[0])
    args = serve.build_parser().parse_args(
        ["--netGA", ga, "--netGB", gb, "--port", "0", "--bf16", "--max-batch", "8",
         "--pad-batch", "4", "--tile", "256"])
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (128, 128, 1), dtype=np.uint8) for _ in range(6)]
    scene = rng.integers(0, 256, (300, 400), dtype=np.uint8)

    def serve_both(srv, together: bool):
        out = {"requests": [], "scenes": []}
        start = threading.Barrier(2 if together else 1)

        def requests():
            start.wait(60)
            out["requests"] = [srv.batcher.submit(im) for im in imgs]

        def scenes():
            start.wait(60)
            out["scenes"] = [srv.tiled.predict_scene(scene) for _ in range(3)]

        if together:
            threads = [threading.Thread(target=f) for f in (requests, scenes)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive()
        else:
            requests()
            scenes()
        return out

    outs = {}
    for together in (True, False):
        srv = serve.make_server(args)
        try:
            assert srv.tiled is srv.batcher.predictor and srv.tiled.stream is not None
            outs[together] = serve_both(srv, together)
        finally:
            serve.close(srv)
    assert len(outs[True]["requests"]) == 6 and len(outs[True]["scenes"]) == 3
    for a, b in zip(outs[True]["requests"], outs[False]["requests"]):
        assert a.shape == (512, 512, 3) and np.array_equal(a, b)
    for a in outs[True]["scenes"]:
        assert a.shape == (1200, 1600, 3) and np.array_equal(a, outs[False]["scenes"][0])
