"""The SSIM kernel's wrapper on the CPU: everything around the launch.

The sm_90a kernels themselves run only on a card (tests/test_torch_cuda.py);
what the CPU can hold is their algorithm and the arithmetic the wrapper
hands them: the taps, the strips of the grid, the range selection, the
fixed-order finish of the means, and what the wrapper refuses.
``emulate_range`` and ``emulate_kernel`` below repeat csrc/ssim.cu's two
launches in torch (per sample min and max, then L; strips of ``strip_width``
output columns of all channels by ``TILE`` rows, the input rows zero-filled
beyond the image, the row pass of each incoming row into a ring of WS rows,
one output a row once the ring is full, masked columns, one partial per
block), and ``finish`` is the kernel's finish, so the design is held to
the plain version and to the Pallas kernel in interpret mode at 1e-6, the
bound of the JAX package's own two forms.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcgan_tpu.ops.pallas import ssim_kernel as jax_ssim_kernel
from srcgan_tpu_torch.ops.kernels import ssim_kernel as sk

MODES = [dict(size_average=True), dict(size_average=False),
         dict(size_average=True, full=True),
         dict(size_average=False, per_sample_range=True),
         dict(size_average=False, full=True, per_sample_range=True)]


def rand(seed, *shape, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).uniform(0, 1, shape) * scale).astype(np.float32))


def emulate_range(x, per_sample):
    """(N,) L: csrc/ssim.cu's range pass in torch (each sample's min and max;
    the main pass's blocks then take L from their sample's, or from the
    batch's)."""
    mn = x.reshape(x.shape[0], -1).min(dim=1).values
    mx = x.reshape(x.shape[0], -1).max(dim=1).values
    if not per_sample:
        mn, mx = mn.min().expand_as(mn), mx.max().expand_as(mx)
    return (torch.where(mx > 128.0, 255.0, 1.0) - torch.where(mn < -0.5, -1.0, 0.0)).float()


def emulate_kernel(x, y, dyn, w_size=11):
    """(ssim partials, cs partials), each (N, blocks of a sample) in the
    kernel's order: csrc/ssim.cu ssim_kernel in torch.  A thread is one
    (column, channel) of a strip; here the threads of all strips of one row
    band walk the band's input rows together."""
    n, h, w, c = x.shape
    sw = sk.strip_width(c)
    vh, vw, ty, tx = sk.tiling(h, w, w_size, sw)
    g = torch.tensor(sk.gauss_taps(w_size))
    width = tx * sw + w_size - 1            # every strip's input columns, zero beyond w
    parts = torch.zeros(2, n, ty, tx)
    for img in range(n):
        px = torch.zeros(h, width, c)
        py = torch.zeros(h, width, c)
        px[:, :w], py[:, :w] = x[img], y[img]
        cols = torch.arange(tx * sw)
        counted = (cols < vw).float()[:, None]                      # (tx*sw, 1)
        for by in range(ty):
            r0 = by * sk.TILE
            in_rows = min(sk.TILE + w_size - 1, h - r0)
            ring, sums = [], torch.zeros(2, tx * sw, c)
            for i in range(in_rows):
                rx, ry = px[r0 + i], py[r0 + i]                     # (width, c)
                row = [sum(t[k:k + tx * sw] * g[k] for k in range(w_size))
                       for t in (rx, ry, rx * rx, ry * ry, rx * ry)]
                ring = (ring + [row])[-w_size:]
                if i < w_size - 1:
                    continue
                mu1, mu2, xx, yy, xy = (sum(ring[k][m] * g[k] for k in range(w_size))
                                        for m in range(5))
                s1, s2, s12 = xx - mu1 * mu1, yy - mu2 * mu2, xy - mu1 * mu2
                c1, c2 = (0.01 * dyn[img]) ** 2, (0.03 * dyn[img]) ** 2
                v1, v2 = 2.0 * s12 + c2, s1 + s2 + c2
                sums[0] += ((2.0 * mu1 * mu2 + c1) * v1) / ((mu1 * mu1 + mu2 * mu2 + c1) * v2) * counted
                sums[1] += v1 / v2 * counted
            parts[:, img, by] = sums.reshape(2, tx, sw * c).sum(dim=2)
    return parts[0].reshape(n, -1), parts[1].reshape(n, -1)


def finish(ssim_sums, cs_sums, n, c, valid, size_average, full):
    """The kernel's finish: ``ssim_sums`` and ``cs_sums`` hold the block
    partials of sample 0, then of sample 1, ...  Each sample's partials are
    summed in float64 in order (its last block), then the samples (the
    batch's last block); the means are rounded to float32."""
    per_ssim = ssim_sums.double().reshape(n, -1).sum(dim=1)
    per_cs = cs_sums.double().reshape(n, -1).sum(dim=1)
    count = n * c * valid
    cs = (per_cs.sum() / count).float()
    ret = (per_ssim.sum() / count).float() if size_average else (per_ssim / (c * valid)).float()
    return (ret, cs) if full else ret


def emulate_call(x, y, w_size=11, size_average=True, full=False, per_sample_range=False):
    """The whole call as the kernel pair makes it: range, strips, finish."""
    n, h, w, c = x.shape
    vh, vw, _, _ = sk.tiling(h, w, w_size)
    ssim_p, cs_p = emulate_kernel(x, y, emulate_range(x, per_sample_range), w_size)
    return finish(ssim_p.reshape(-1), cs_p.reshape(-1), n, c, vh * vw, size_average, full)


def pallas(x, y, **kw):
    out = jax_ssim_kernel.ssim_pallas(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                      interpret=True, **kw)
    return tuple(np.asarray(o) for o in out) if kw.get("full") else (np.asarray(out),)


def close(got, want, atol=1e-6):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        r = r.numpy() if isinstance(r, torch.Tensor) else r
        assert g.shape == r.shape, (g.shape, r.shape)
        np.testing.assert_allclose(g, r, atol=atol, rtol=0)


def test_taps_equal_the_pallas_kernels():
    for w_size in (3, 7, 11):
        assert sk.gauss_taps(w_size) == jax_ssim_kernel._gauss_taps(w_size)
    taps = np.array(sk.gauss_taps(), np.float64)
    np.testing.assert_allclose(np.outer(taps, taps), sk.gaussian_window(), atol=1e-8)
    assert abs(taps.sum() - 1.0) < 1e-6


@pytest.mark.parametrize("h,w,want", [(256, 256, (246, 246, 8, 8)), (512, 512, (502, 502, 16, 16)),
                                      (24, 40, (14, 30, 1, 1)), (250, 198, (240, 188, 8, 6)),
                                      (42, 43, (32, 33, 1, 2)), (11, 11, (1, 1, 1, 1))])
def test_tiling(h, w, want):
    assert sk.tiling(h, w, 11) == want


@pytest.mark.parametrize("h,w", [(10, 64), (64, 10), (8, 8)])
def test_a_plane_smaller_than_the_window_is_refused(h, w):
    x = torch.zeros(1, h, w, 3)
    with pytest.raises(ValueError, match="no valid region"):
        sk.ssim_fused(x, x)
    with pytest.raises(ValueError, match="no valid region"):
        sk.ssim_reference(x, x)


@pytest.mark.parametrize("shape,scale", [((2, 32, 32, 3), 1.0), ((1, 24, 40, 1), 1.0),
                                         ((1, 50, 70, 2), 255.0), ((2, 43, 75, 1), 1.0)])
def test_tiled_algorithm_matches_plain_version(shape, scale):
    """The strip algorithm: ragged strips (14x30, 40x60, 33x65 valid) add
    nothing from beyond the edge, and a band shorter than TILE rows emits
    only valid rows."""
    x, y = rand(2, *shape, scale=scale), rand(3, *shape, scale=scale)
    for per_sample in (False, True):
        got = emulate_call(x, y, size_average=False, full=True, per_sample_range=per_sample)
        want = sk.ssim_reference(x, y, size_average=False, full=True,
                                 per_sample_range=per_sample)
        close(got, want)


@pytest.mark.parametrize("shape", [(2, 45, 38, 3), (1, 33, 30, 5), (3, 20, 64, 1)])
def test_strip_algorithm_matches_pallas_interpret(shape):
    """Against the Pallas kernel itself (interpret mode): three channels in a
    strip of 32 columns, five in strips of 25, one channel in two strips."""
    x = rand(sum(shape), *shape)
    y = torch.clamp(x + 0.1 * torch.from_numpy(
        np.random.default_rng(1).normal(size=shape).astype(np.float32)), 0, 1)
    close(emulate_call(x, y, size_average=False, full=True),
          pallas(x, y, size_average=False, full=True))


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("lo,hi,want", [(0.0, 1.0, 1.0), (-1.0, 1.0, 2.0),
                                        (0.0, 255.0, 255.0), (-1.0, 255.0, 256.0)])
def test_range_selection_matches_pallas(lo, hi, want, per_sample):
    """Each of the four L the protocol can pick, over the batch and per
    sample: the emulated range pass picks it and the whole call agrees with
    the Pallas kernel.  Sample 1 spans [0, 1] alone, so per sample it keeps
    L = 1 while the batch takes sample 0's range."""
    x = torch.cat([lo + (hi - lo) * rand(10, 1, 24, 28, 3), rand(11, 1, 24, 28, 3)])
    y = torch.clamp(x + 0.05 * (hi - lo) * (rand(12, 2, 24, 28, 3) - 0.5), lo, hi)
    got = emulate_range(x, per_sample)
    assert got.tolist() == ([want, 1.0] if per_sample else [want, want])
    assert torch.equal(got, sk.dynamic_range(x, per_sample))
    kw = dict(size_average=False, full=True, per_sample_range=per_sample)
    close(emulate_call(x, y, **kw), pallas(x, y, **kw))
    close(sk.ssim_fused(x, y, **kw), pallas(x, y, **kw))


@pytest.mark.parametrize("mode", range(len(MODES)))
def test_fixed_order_finish_in_every_mode(mode):
    """The kernel's finish (float64 sums of each sample's block partials in
    order, then of the samples) gives every mode of the plain version: the
    mean, per-sample means over channels, and cs, at a mixed range."""
    kw = MODES[mode]
    x = torch.cat([rand(20, 1, 30, 36, 3), rand(21, 1, 30, 36, 3, scale=255.0),
                   rand(22, 1, 30, 36, 3)])
    y = torch.clamp(x * 0.9 + 0.02 * x.amax(dim=(1, 2, 3), keepdim=True), 0, 255)
    got = emulate_call(x, y, **kw)
    want = sk.ssim_reference(x, y, **kw)
    close(got, want)
    for g in (got if kw.get("full") else (got,)):
        assert g.dtype == torch.float32
    # the same partials give the same result, whatever else ran in between
    again = emulate_call(x, y, **kw)
    for a, b in zip(again if kw.get("full") else (again,), got if kw.get("full") else (got,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("c,width", [(1, 32), (3, 32), (4, 32), (5, 25), (64, 2), (128, 1)])
def test_strip_width_fills_a_block_with_pairs(c, width):
    """A block holds at most 128 (column, channel) pairs, one a thread, and
    at least one column; C <= 4 keeps TILE columns, as the eval's C = 3 does.
    (Whether the ring of such a strip fits in shared memory is the wrapper's
    other check: C = 128 fits under windows up to 9, not 11.)"""
    assert sk.strip_width(c) == width
    assert 1 <= width * c <= 128


def test_finish_follows_the_pallas_wrapper():
    ssim_sums, cs_sums = torch.arange(6.0), torch.arange(6.0) * 2
    mean = finish(ssim_sums, cs_sums, 2, 3, 10, True, False)
    assert mean.item() == pytest.approx(15.0 / 60)
    per, cs = finish(ssim_sums, cs_sums, 2, 3, 10, False, True)
    np.testing.assert_allclose(per.numpy(), [0.1, 0.4], rtol=1e-6)
    assert cs.item() == pytest.approx(30.0 / 60)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    x = rand(4, 1, 16, 16, 3)
    with pytest.raises(ValueError, match="no backward"):
        sk.ssim_fused(x.clone().requires_grad_(), x)
    with pytest.raises(ValueError, match="one shape"):
        sk.ssim_fused(x, x[:, :12])
    with pytest.raises(ValueError, match="floating"):
        sk.ssim_fused((x * 255).to(torch.uint8), (x * 255).to(torch.uint8))
    dims = sk._check(x, x, 4)
    with pytest.raises(ValueError, match="built for windows"):
        sk._kernel(x, x, dims, 4)
    # the plain version is differentiable: the losses take it
    xg = x.clone().requires_grad_()
    sk.ssim_reference(xg, rand(5, 1, 16, 16, 3)).backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0


@pytest.mark.parametrize("shape,match", [((1, 16, 16, 129), "channels exceed"),
                                         ((65536, 11, 11, 1), "planes exceed"),
                                         ((700, 11, 11, 100), "planes exceed"),
                                         ((1, 16, 16, 128), "shared memory"),
                                         ((1, 16, 16, 121), "shared memory")])
def test_wrapper_refuses_beyond_the_kernels_grid(shape, match):
    """Checked before the library is loaded: more (column, channel) pairs
    than a block's threads, more planes than the kernel takes, and at the
    11-tap window more than 120 channels, whose two chunks of input rows
    exceed a block's shared memory."""
    x = torch.empty(shape)
    with pytest.raises(ValueError, match=match):
        sk._kernel(x, x, sk._check(x, x, 11), 11)


def test_bf16_inputs_are_filtered_in_fp32():
    x, y = rand(6, 1, 16, 16, 3), rand(7, 1, 16, 16, 3)
    want = sk.ssim_reference(x.bfloat16().float(), y.bfloat16().float())
    for fn in (sk.ssim_fused, sk.ssim_reference):
        got = fn(x.bfloat16(), y.bfloat16())
        assert got.dtype == torch.float32
        assert torch.equal(got, want)


@pytest.mark.parametrize("w_size,most", [(3, 128), (5, 128), (7, 128), (9, 128), (11, 120)])
def test_the_ring_fits_up_to_the_stated_channels(w_size, most):
    """The channels each window takes, as ssim_fused's docstring states them:
    the most C whose two chunks of w_size input rows fit a block's shared
    memory (csrc/ssim.cu kMaxSmem), within the 128 pairs of a block."""
    fits = [c for c in range(1, sk._MAX_PAIRS + 1) if sk.smem_bytes(c, w_size) <= sk._MAX_SMEM]
    assert fits == list(range(1, most + 1))
