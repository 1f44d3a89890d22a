"""srcgan_tpu_torch on an NVIDIA card: the sm_90a kernels against their plain
versions, and the model gate that routes the x4 bf16 tail through them.

Every test here needs a card (marker ``cuda``) and skips without one.  The
file imports no jax, so it also runs where jax is not installed; there the
suite's conftest (which pins jax to the CPU) is left out:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py

Kernel tolerance: max|diff| <= 0.02 * max(max|ref|, 1), as for the Pallas
kernel (bf16 staging of t1, z2 and zall, different sum orders).
"""
import pytest
import torch

from srcgan_tpu_torch import models
from srcgan_tpu_torch.ops.kernels import tail_kernel

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
