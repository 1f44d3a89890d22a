"""The x4 tail kernel's module (srcgan_tpu_torch.ops.kernels.tail_kernel).

The plain version against the JAX Pallas kernel run in interpret mode and
against the port's phase-folded tail, the weight assembly against the JAX
wrapper's, and the wrapper's device dispatch.  The sm_90a kernel itself is
tested on the card by tests/test_torch_cuda.py.

Tolerance of the bf16 comparisons: max|diff| <= 0.02 * max(max|ref|, 1), the
bound of tests/test_fused.py for the Pallas kernel; t1, z2 and zall are
staged in bf16 and the sums run in different orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srcgan_tpu.ops import fused as jfused
from srcgan_tpu.ops.pallas.tail_kernel import tail_x4_fused as jax_tail_x4_fused
from srcgan_tpu_torch.ops import fused
from srcgan_tpu_torch.ops.kernels import tail_kernel


def within_bound(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 0.02 * max(scale, 1.0), (err, scale)


def tail_inputs(seed, nf=16, ou=1, n=2, h=16, w=16):
    """numpy inputs in the JAX layouts: t0 (bf16-representable), deconvs
    (2,2,nf,nf), conv_last (3,3,nf,ou), bias (ou,)."""
    rng = np.random.default_rng(seed)
    t0 = np.asarray(jnp.asarray(rng.standard_normal((n, h, w, nf)), jnp.bfloat16),
                    np.float32)
    d1, d2 = (rng.standard_normal((2, 2, nf, nf)).astype(np.float32) * .2
              for _ in range(2))
    lw = rng.standard_normal((3, 3, nf, ou)).astype(np.float32) * .2
    lb = rng.standard_normal(ou).astype(np.float32)
    return t0, d1, d2, lw, lb


def port_args(t0, d1, d2, lw, lb):
    """The same values in the port's layouts: deconvs (in,out,kh,kw),
    conv_last (ou,nf,3,3)."""
    f = torch.from_numpy
    return (f(t0).bfloat16(), f(d1.transpose(2, 3, 0, 1).copy()),
            f(d2.transpose(2, 3, 0, 1).copy()), f(lw.transpose(3, 2, 0, 1).copy()),
            f(lb))


@pytest.mark.parametrize("nf,ou", [(16, 1), (16, 3), (24, 1)])
def test_reference_matches_jax_pallas_interpret(nf, ou):
    """nf=24 also covers the zero padding of nf to the kernel's 16-wide tiles."""
    t0, d1, d2, lw, lb = tail_inputs(10 + ou + nf, nf=nf, ou=ou)
    want = jax_tail_x4_fused(jnp.asarray(t0, jnp.bfloat16), jnp.asarray(d1),
                             jnp.asarray(d2), jnp.asarray(lw), jnp.asarray(lb),
                             interpret=True)
    got = tail_kernel.tail_x4_reference(*port_args(t0, d1, d2, lw, lb))
    assert got.dtype == torch.bfloat16
    within_bound(got.float(), want)


@pytest.mark.parametrize("ou", [1, 3])
def test_reference_matches_port_phasefold(ou):
    t0, d1, d2, lw, lb = tail_inputs(20 + ou, ou=ou)
    ref = fused.phasefold_deconv_tail(
        torch.from_numpy(t0).bfloat16(), [torch.from_numpy(d1), torch.from_numpy(d2)],
        torch.from_numpy(lw), torch.from_numpy(lb))
    got = tail_kernel.tail_x4_reference(*port_args(t0, d1, d2, lw, lb))
    within_bound(got.float(), ref.float())


@pytest.mark.parametrize("ou", [1, 3])
def test_prepare_matches_jax_weight_assembly(ou):
    """W1s, W2m and Wall equal the JAX wrapper's assembly bit for bit: a wrong
    permutation of the port's (in,out,kh,kw) weights shows up here."""
    nf = 16
    _, d1, d2, lw, lb = tail_inputs(30 + ou, nf=nf, ou=ou)
    bf = jnp.bfloat16
    w1s = jnp.asarray(d1).astype(bf).reshape(4, nf, nf)
    w2m = jnp.asarray(d2).astype(bf).transpose(2, 0, 1, 3).reshape(nf, 4 * nf)
    wf = jfused.fold_last_weight(jfused.tail_phases(2), jnp.asarray(lw), 4, nf, bf)
    wall = jnp.moveaxis(wf.reshape(9, 16 * nf, 16 * ou), 0, 1).reshape(
        4, 4 * nf, 9 * 16 * ou)
    _, pd1, pd2, plw, _ = port_args(*tail_inputs(30 + ou, nf=nf, ou=ou))
    tw = tail_kernel.prepare(pd1, pd2, plw)
    for got, want in zip(tw, (w1s, w2m, wall)):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_wrapper_runs_plain_version_on_cpu():
    t0, d1, d2, lw, lb = tail_inputs(40)
    pt0, pd1, pd2, plw, plb = port_args(t0, d1, d2, lw, lb)
    before = tail_kernel.launches
    got = tail_kernel.tail_x4_fused(pt0, tail_kernel.prepare(pd1, pd2, plw), plb)
    assert tail_kernel.launches == before
    assert torch.equal(got, tail_kernel.tail_x4_reference(pt0, pd1, pd2, plw, plb))


def test_supported_and_rejects():
    bf = torch.bfloat16
    assert tail_kernel.supported((8, 128, 128, 64), 4, bf)
    assert tail_kernel.supported((1, 8, 16, 24), 4, bf)
    assert not tail_kernel.supported((8, 128, 128, 64), 4, torch.float32)
    assert not tail_kernel.supported((8, 128, 128, 64), 2, bf)
    assert not tail_kernel.supported((1, 12, 16, 64), 4, bf)
    assert not tail_kernel.supported((1, 16, 16, 12), 4, bf)
    # the weights of nf=80 do not fit a block's shared memory
    assert tail_kernel.smem_bytes(64) <= tail_kernel.SMEM_LIMIT < tail_kernel.smem_bytes(80)
    assert not tail_kernel.supported((1, 16, 16, 80), 4, bf)
    t0, d1, d2, lw, lb = tail_inputs(41)
    pt0, pd1, pd2, plw, plb = port_args(t0, d1, d2, lw, lb)
    tw = tail_kernel.prepare(pd1, pd2, plw)
    with pytest.raises(ValueError, match="unsupported"):
        tail_kernel.tail_x4_fused(pt0.float(), tw, plb)
    with pytest.raises(ValueError, match="unsupported"):
        tail_kernel.tail_x4_fused(pt0[:, :12], tw, plb)
