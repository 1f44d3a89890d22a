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


# -- the layouts the sm_90a kernels read, restated in numpy --------------------

def operand_at(buf, start, k, n, lbo, step):
    """The (k, n) operand a wgmma descriptor without swizzle reads from ``buf``
    (bf16 values, addressed in bytes) at byte ``start``, as csrc/tail_x4.cu's
    w1_desc / w2_desc / wall_desc describe it: element (r, c) of k16 step r//16
    at start + (r//16)*step + ((r%16)//8)*lbo + (c//8)*128 + (c%8)*16 + (r%8)*2."""
    r, c = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    byte = (start + (r // 16) * step + ((r % 16) // 8) * lbo + (c // 8) * 128
            + (c % 8) * 16 + (r % 8) * 2)
    return buf[byte // 2], byte // 2


@pytest.mark.parametrize("nf,ou", [(16, 1), (16, 3), (64, 1), (64, 3)])
def test_packed_weights_are_what_the_descriptors_read(nf, ou):
    """prepare's packed buffer read back through the descriptors' addressing
    gives W1[b], W2m's 64-column chunks and Wall's 64 x 144 slices, and the
    reads cover every element of the buffer exactly once."""
    _, d1, d2, lw, _ = port_args(*tail_inputs(50 + nf + ou, nf=nf, ou=ou))
    tw = tail_kernel.prepare(d1, d2, lw)
    buf = tw.packed.float().numpy()
    w1s, w2m, wall = (t.float().numpy() for t in tw[:3])
    ks, res = nf // 16, 16 * nf * nf
    assert buf.size * 2 == res + 4 * ou * ks * 18432
    seen = []
    for b in range(4):
        got, at = operand_at(buf, b * nf * nf * 2, nf, nf, 16 * nf, 32 * nf)
        np.testing.assert_array_equal(got, w1s[b])
        seen.append(at)
    for c in range(ks):
        got, at = operand_at(buf, 8 * nf * nf + c * 1024, nf, 64, 64 * nf, 128 * nf)
        np.testing.assert_array_equal(got, w2m[:, 64 * c:64 * c + 64])
        seen.append(at)
    for b in range(4):
        for t in range(ou):
            for c in range(ks):
                start = res + ((b * ou + t) * ks + c) * 18432
                got, at = operand_at(buf, start, 64, 144, 16 * 144, 32 * 144)
                np.testing.assert_array_equal(got, wall[b, 64 * c:64 * c + 64, 144 * t:144 * t + 144])
                seen.append(at)
    seen = np.concatenate([a.ravel() for a in seen])
    np.testing.assert_array_equal(np.sort(seen), np.arange(buf.size))


@pytest.mark.parametrize("n", [16, 32, 48, 64])
def test_accumulator_is_the_next_a_fragment(n):
    """PTX's layouts for wgmma m64nNk16: the fp32 accumulator (thread t, register
    4j + i) holds row 16w + g + 8(i//2), column 8j + 2q + i%2 (w = t//32, g =
    t%32//4, q = t%4); the bf16 A operand from registers (step s, register e,
    half h) holds row 16w + g + 8(e%2), k 16s + 8(e//2) + 2q + h.  The rule of
    csrc/tail_x4.cu's to_a, A[s][e] half h = D[8s + 2e + h], hands every
    thread exactly its own elements, and covers the 64 x N block once."""
    owned = set()
    for t in range(128):
        w, g, q = t // 32, t % 32 // 4, t % 4
        for s in range(n // 16):
            for e in range(4):
                for h in range(2):
                    reg = 8 * s + 2 * e + h
                    j, i = divmod(reg, 4)
                    acc = (16 * w + g + 8 * (i // 2), 8 * j + 2 * q + i % 2)
                    frag = (16 * w + g + 8 * (e % 2), 16 * s + 8 * (e // 2) + 2 * q + h)
                    assert acc == frag, (t, s, e, h)
                    owned.add(frag)
    assert owned == {(r, c) for r in range(64) for c in range(n)}


def tile_plan(m, ncol, sms):
    """csrc/tail_x4.cu's persistent grid restated: min(items, sms) blocks;
    item i is row tile i // ncol (rows 128 i .. 128 i + 127) and column tile
    i % ncol; block k takes items k, k + gridDim.x, ..."""
    items = -(-m // 128) * ncol
    blocks = min(items, sms)
    return [[(i // ncol, i % ncol) for i in range(k, items, blocks)] for k in range(blocks)]


@pytest.mark.parametrize("m,ncol,blocks", [(131072, 1, 132), (131072, 3, 132),
                                           (320, 1, 132), (192, 2, 4)],
                         ids=["serving", "ou3", "ragged", "ragged-few-blocks"])
def test_tile_plan_covers_each_tile_once(m, ncol, blocks):
    """The persistent grid: every (row tile, column tile) once, blocks take
    items in order, and the row tiles cover rows 0..m-1 once (the last one
    ragged when m % 128 == 64)."""
    plan = tile_plan(m, ncol, blocks)
    tiles = -(-m // 128)
    items = [it for block in plan for it in block]
    assert len(plan) == min(tiles * ncol, blocks)
    assert sorted(items) == [(r, c) for r in range(tiles) for c in range(ncol)]
    for k, block in enumerate(plan):
        assert [r * ncol + c for r, c in block] == list(range(k, tiles * ncol, blocks))
    rows = np.zeros(m, int)
    for r in range(tiles):
        rows[r * 128:min(r * 128 + 128, m)] += 1
    assert (rows == 1).all()
    assert max(len(b) for b in plan) - min(len(b) for b in plan) <= 1


def jax_shift_reduce(zall, n, h, w, ou, lb):
    """The JAX wrapper's finish (srcgan_tpu/ops/pallas/tail_kernel.py:116-126)
    restated in float64 numpy on its own (H, W*N, C) layout."""
    co2 = 16 * ou
    z = zall.reshape(n, h, w, 9 * co2).transpose(1, 2, 0, 3).reshape(h, w * n, 9 * co2)
    zp = np.pad(z.astype(np.float64), ((1, 1), (n, n), (0, 0)))
    out = sum(zp[oy:oy + h, ox * n:ox * n + w * n, (oy * 3 + ox) * co2:(oy * 3 + ox + 1) * co2]
              for oy in range(3) for ox in range(3))
    out = out.reshape(h, w, n, co2).transpose(2, 0, 1, 3)
    if lb is not None:
        out = out + np.repeat(lb, 16)
    # pixel shuffle: channel c*16 + i*4 + j -> (4y + i, 4x + j, c)
    return out.reshape(n, h, w, ou, 4, 4).transpose(0, 1, 4, 2, 5, 3).reshape(n, 4 * h, 4 * w, ou)


@pytest.mark.parametrize("ou,bias", [(1, False), (1, True), (3, True)])
def test_finish_plain_matches_jax_shift_reduce(monkeypatch, ou, bias):
    """finish_reference on a given zall against JAX's own shift-reduce, bias
    and pixel shuffle, reached through tail_x4_fused(interpret=True) with its
    pallas_call made to return that zall; and against the float64 numpy form
    within one bf16 rounding (the port sums in fp32 and rounds once, JAX in
    bf16 with a rounding per add)."""
    import srcgan_tpu.ops.pallas.tail_kernel as jax_tail

    n, h, w, nf = 2, 8, 16, 16
    t0, d1, d2, lw, lb = tail_inputs(60 + ou, nf=nf, ou=ou, n=n, h=h, w=w)
    rng = np.random.default_rng(61 + ou)
    zall = np.asarray(jnp.asarray(rng.standard_normal((n * h * w, 9 * 16 * ou)), jnp.bfloat16),
                      np.float32)
    lb = np.asarray(jnp.asarray(lb, jnp.bfloat16), np.float32) if bias else None
    layout = jnp.asarray(zall.reshape(n, h, w, -1).transpose(1, 2, 0, 3).reshape(h, w * n, -1),
                         jnp.bfloat16)
    monkeypatch.setattr(jax_tail.pl, "pallas_call", lambda *a, **k: lambda *args: layout)
    want = jax_tail_x4_fused(jnp.asarray(t0, jnp.bfloat16), jnp.asarray(d1), jnp.asarray(d2),
                             jnp.asarray(lw), None if lb is None else jnp.asarray(lb),
                             interpret=True)
    got = tail_kernel.finish_reference(torch.from_numpy(zall).bfloat16(), n, h, w, ou,
                                       None if lb is None else torch.from_numpy(lb))
    assert got.dtype == torch.bfloat16 and got.shape == (n, 4 * h, 4 * w, ou)
    within_bound(got.float(), want)
    exact = jax_shift_reduce(zall, n, h, w, ou, lb)
    err = np.abs(got.float().numpy() - exact)
    assert (err <= 2.0 ** -8 * np.abs(exact) + 1e-30).all(), err.max()
