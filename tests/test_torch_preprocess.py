"""The port's resize ops, preprocessing and the gray+degrade kernel's plain
version against the JAX package on the same numpy inputs.

Both sides compute in fp32 with the same sampling matrices and the same
order of sums (rows, then columns), so only rounding differs: atol 1e-6,
the bound tests/test_fused.py holds the Pallas kernel to.  The JAX kernel
runs in interpret mode, as the JAX package's own tests run it on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srcgan_tpu import ops as jops
from srcgan_tpu.data import preprocess as jpre
from srcgan_tpu.ops import resize as jresize
from srcgan_tpu.ops.pallas.preprocess_kernel import fused_gray_degrade as jax_fused
from srcgan_tpu_torch.data import preprocess
from srcgan_tpu_torch.ops import resize
from srcgan_tpu_torch.ops.kernels import preprocess_kernel

ATOL = 1e-6


def u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def close(got: torch.Tensor, want, atol=ATOL):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("in_size,out_size", [(32, 16), (32, 8), (250, 62), (198, 49),
                                              (16, 32), (7, 21), (30, 30)])
def test_sampling_matrices_equal_jax(in_size, out_size):
    for ours, theirs in ((resize._bilinear_matrix, jresize._bilinear_matrix),
                         (resize._nearest_matrix, jresize._nearest_matrix)):
        a, b = ours(in_size, out_size), theirs(in_size, out_size)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("scale,size", [(0.5, None), (0.25, None), (2.0, None),
                                        (3.0, None), (None, (13, 22))])
def test_interpolate_equals_jax(mode, scale, size):
    x = np.random.default_rng(1).standard_normal((2, 12, 18, 3)).astype(np.float32)
    want = jops.interpolate(jnp.asarray(x), scale_factor=scale, size=size, mode=mode)
    got = resize.interpolate(torch.from_numpy(x), scale_factor=scale, size=size, mode=mode)
    close(got, want)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_interpolate_is_f_interpolate(mode):
    """The matrices reproduce torch's own F.interpolate (NHWC at the boundary)
    for a given output size, and for a scale factor that divides the input
    (otherwise F.interpolate samples at 1/scale, the matrices at in/out)."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 24, 16, 1))
                         .astype(np.float32))
    nchw = x.permute(0, 3, 1, 2)
    for scale in (0.5, 0.25, 2.0):
        want = torch.nn.functional.interpolate(nchw, scale_factor=scale, mode=mode)
        close(resize.interpolate(x, scale_factor=scale, mode=mode),
              want.permute(0, 2, 3, 1).numpy(), atol=2e-6)
    for size in ((10, 7), (37, 29)):
        want = torch.nn.functional.interpolate(nchw, size=size, mode=mode)
        close(resize.interpolate(x, size=size, mode=mode),
              want.permute(0, 2, 3, 1).numpy(), atol=2e-6)
    with pytest.raises(ValueError):
        resize.interpolate(x, scale_factor=0.5, mode="bicubic")


@pytest.mark.parametrize("fn", ["degrade_bilinear", "degrade_const", "degrade_nearest",
                                "degrade_const_nearest"])
@pytest.mark.parametrize("up", [2, 4])
def test_degradations_equal_jax(fn, up):
    x = np.random.default_rng(up).uniform(0, 1, (2, 32, 24, 1)).astype(np.float32)
    close(getattr(preprocess, fn)(torch.from_numpy(x), up),
          getattr(jpre, fn)(jnp.asarray(x), up))


def test_convert_pair_and_luma_equal_jax():
    src, tar = u8(3, 2, 16, 20, 3), u8(4, 2, 16, 20, 3)
    want_a, want_b = jpre.convert_pair(jnp.asarray(src), jnp.asarray(tar), "G2RGB")
    got_a, got_b = preprocess.convert_pair(torch.from_numpy(src), torch.from_numpy(tar))
    close(got_a, want_a)
    close(got_b, want_b)        # XLA divides by 255 as a multiply by 1/255
    close(preprocess.luma(got_b), jpre.luma(want_b))
    want_a, want_b = jpre.convert_pair(jnp.asarray(src), jnp.asarray(tar), "G2LAB")
    got_a, got_b = preprocess.convert_pair(torch.from_numpy(src), torch.from_numpy(tar), "G2LAB")
    close(got_a, want_a)
    # normalized LAB: two frameworks' pow and cube root, bound 2e-5
    assert got_b.shape == (2, 16, 20, 3)
    assert np.abs(got_b.numpy() - np.asarray(want_b)).max() <= 2e-5
    with pytest.raises(ValueError, match="unknown dataset version"):
        preprocess.convert_pair(torch.from_numpy(src), torch.from_numpy(tar), "G2XYZ")


@pytest.mark.parametrize("shape,up", [((2, 32, 32, 3), 2), ((2, 32, 32, 3), 4),
                                      ((3, 30, 22, 3), 4), ((1, 25, 40, 3), 2),
                                      ((2, 18, 36, 3), 3)])
def test_gray_degrade_reference_equals_jax(shape, up):
    """Against the Pallas kernel (interpret mode) and against JAX's own
    luma + degrade_bilinear, square, non-square and non-multiple sizes."""
    tar = u8(sum(shape) + up, *shape)
    before = preprocess_kernel.launches
    gray, low = preprocess_kernel.fused_gray_degrade(torch.from_numpy(tar), up)
    assert preprocess_kernel.launches == before   # a CPU tensor never reaches the kernel
    k_gray, k_low = jax_fused(jnp.asarray(tar), up, interpret=True)
    close(gray, k_gray)
    close(low, k_low)
    _, rgb = jpre.convert_pair(jnp.asarray(tar), jnp.asarray(tar), "G2RGB")
    x_gray = jpre.luma(rgb)
    close(gray, x_gray)
    close(low, jpre.degrade_bilinear(x_gray, up))


@pytest.mark.parametrize("in_size,out_size", [(256, 128), (256, 64), (250, 62),
                                              (198, 49), (25, 12)])
def test_tap_tables_rebuild_the_matrix(in_size, out_size):
    """The kernel's (lo, hi, w_lo, w_hi) tables hold the matrix entries
    exactly, and lo/hi are adjacent (or equal, with w_hi = 0)."""
    idx, wts = preprocess_kernel.taps(in_size, out_size)
    m = np.zeros((out_size, in_size), np.float32)
    for d in range(out_size):
        lo, hi = idx[d]
        assert hi - lo in (0, 1)
        m[d, lo] += wts[d, 0]
        if hi != lo:
            m[d, hi] += wts[d, 1]
        else:
            assert wts[d, 1] == 0
    np.testing.assert_array_equal(m, resize._bilinear_matrix(in_size, out_size))


def test_taps_stencil_equals_matrix_products():
    """The kernel's arithmetic, written out in numpy over the tap tables (rows
    first, then columns), equals the plain version."""
    tar = u8(5, 2, 30, 22, 3)
    up = 4
    gray, low = preprocess_kernel.gray_degrade_reference(torch.from_numpy(tar), up)
    g = gray.numpy()[..., 0]
    ri, rw = preprocess_kernel.taps(30, 30 // up)
    ci, cw = preprocess_kernel.taps(22, 22 // up)
    tmp = rw[:, 0, None] * g[:, ri[:, 0]] + rw[:, 1, None] * g[:, ri[:, 1]]
    out = cw[:, 0] * tmp[:, :, ci[:, 0]] + cw[:, 1] * tmp[:, :, ci[:, 1]]
    np.testing.assert_allclose(out, low.numpy()[..., 0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("bad,match", [
    (lambda t: t.float(), "uint8"),
    (lambda t: t[..., :1], "uint8"),
    (lambda t: t[:, :, ::2], "contiguous"),
    (lambda t: t[:, :1, :1].contiguous(), "cannot be degraded"),
])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad, match):
    t = torch.from_numpy(u8(6, 2, 16, 16, 3))
    with pytest.raises(ValueError, match=match):
        preprocess_kernel.fused_gray_degrade(bad(t), 2)


def emulate_gray_degrade(tar: np.ndarray, up: int):
    """csrc/gray_degrade.cu in numpy, block by block: block o of image n
    converts its own input rows (``strip``) once, keeps them, and forms low
    row o from them, or from the bytes where a tap row is not one of its rows
    (``in_strip``); each pixel's luma in the plain version's order."""
    n, h, w, _ = tar.shape
    h2, w2 = h // up, w // up
    ri, rw = preprocess_kernel.taps(h, h2)
    ci, cw = preprocess_kernel.taps(w, w2)
    held = preprocess_kernel.in_strip(h, h2)

    def luma(px):
        f = px.astype(np.float32) / np.float32(255.0)
        wts = np.float32([0.2125, 0.7154, 0.0721])
        return (f[..., 0] * wts[0] + f[..., 1] * wts[1]) + f[..., 2] * wts[2]

    gray = np.full((n, h, w), np.nan, np.float32)
    low = np.full((n, h2, w2), np.nan, np.float32)
    for img in range(n):
        for o in range(h2):
            hb, he = preprocess_kernel.strip(o, h, h2)
            assert np.isnan(gray[img, hb:he]).all()           # each row once
            rows = luma(tar[img, hb:he])
            gray[img, hb:he] = rows
            lo, hi = (rows[r - hb] if held[o, k] else luma(tar[img, r])
                      for k, r in enumerate(ri[o]))
            tmp = rw[o, 1] * hi + rw[o, 0] * lo
            low[img, o] = cw[:, 1] * tmp[ci[:, 1]] + cw[:, 0] * tmp[ci[:, 0]]
    return gray[..., None], low[..., None]


@pytest.mark.parametrize("h,h2", [(256, 128), (256, 64), (250, 62), (198, 49), (25, 12),
                                  (9, 4), (37, 18), (30, 7)])
def test_strip_plan_partitions_the_image(h, h2):
    """The blocks' input rows cover [0, h) once each, and no block holds more
    than ceil(h / h2) rows, what its shared memory is sized for."""
    bounds = [preprocess_kernel.strip(o, h, h2) for o in range(h2)]
    assert bounds[0][0] == 0 and bounds[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert max(e - b for b, e in bounds) <= -(-h // h2)
    assert preprocess_kernel.smem_bytes(h, 64, h2) == (-(-h // h2) * 64 + 4) * 4


@pytest.mark.parametrize("up", [2, 3, 4])
@pytest.mark.parametrize("h2", [128, 12, 3])
def test_integer_ratio_taps_lie_in_their_own_rows(h2, up):
    """For h = up * h2 output row o's taps are rows up*o + up/2 - 1 and
    up*o + up/2 (even up, weights 1/2) or up*o + (up-1)/2 alone (odd up),
    all inside the block's own up rows: the kernel never reads the bytes
    twice."""
    h = up * h2
    idx, wts = preprocess_kernel.taps(h, h2)
    o = np.arange(h2)
    if up % 2 == 0:
        np.testing.assert_array_equal(idx, np.stack([up * o + up // 2 - 1, up * o + up // 2], 1))
        np.testing.assert_array_equal(wts, np.full((h2, 2), 0.5, np.float32))
    else:
        np.testing.assert_array_equal(idx, np.stack([up * o + (up - 1) // 2] * 2, 1))
        np.testing.assert_array_equal(wts, np.stack([np.ones(h2), np.zeros(h2)], 1))
    assert preprocess_kernel.in_strip(h, h2).all()
    assert all(preprocess_kernel.strip(k, h, h2) == (up * k, up * k + up) for k in o)


@pytest.mark.parametrize("shape,up", [((2, 32, 32, 3), 2), ((2, 36, 24, 3), 3),
                                      ((2, 32, 40, 3), 4), ((1, 25, 41, 3), 2),
                                      ((3, 30, 22, 3), 4), ((1, 17, 18, 3), 2)])
def test_strip_emulation_matches_pallas_interpret(shape, up):
    """The kernel's block plan against the Pallas kernel (interpret mode):
    integer ratios at up 2, 3, 4, and ragged heights (25, 17 at up=2), whose
    blocks read some tap rows from the bytes, with widths that are no
    multiple of 4 (41, 22, 18)."""
    tar = u8(sum(shape) * up, *shape)
    h, h2 = shape[1], shape[1] // up
    assert preprocess_kernel.in_strip(h, h2).all() == (h not in (25, 17))
    gray, low = emulate_gray_degrade(tar, up)
    k_gray, k_low = jax_fused(jnp.asarray(tar), up, interpret=True)
    close(torch.from_numpy(gray), k_gray)
    close(torch.from_numpy(low), k_low)


def test_wrapper_refuses_rows_beyond_shared_memory():
    """A block's rows must fit its shared memory: checked before the
    library is loaded."""
    t = torch.zeros(1, 8, 8000, 3, dtype=torch.uint8)
    assert preprocess_kernel.smem_bytes(8, 8000, 1) > preprocess_kernel._MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        preprocess_kernel._kernel(t, 8)
