"""The SSIM kernel's wrapper on the CPU: everything around the launch.

The sm_90a kernel itself runs only on a card (tests/test_torch_cuda.py); what
the CPU can hold is the arithmetic the wrapper hands it and takes back: the
taps, the tiling of the valid region, the per-plane range vector, the finish
of the means, and what the wrapper refuses.  ``emulate_kernel`` below repeats
the kernel's algorithm in torch (32x32 output tiles of one plane, a zero
halo beyond the image, rows then columns, masked ragged edges, one partial
per tile), so the design is held to the plain version at 1e-6, the bound of
the JAX package's own two forms.
"""
import numpy as np
import pytest
import torch

from srcgan_tpu.ops.pallas import ssim_kernel as jax_ssim_kernel
from srcgan_tpu_torch.ops.kernels import ssim_kernel as sk


def rand(seed, *shape, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).uniform(0, 1, shape) * scale).astype(np.float32))


def emulate_kernel(x, y, dyn_planes, w_size=11):
    """(ssim partials, cs partials), each (N*C, tiles): csrc/ssim.cu in torch."""
    n, h, w, c = x.shape
    vh, vw, ty, tx = sk.tiling(h, w, w_size)
    g = torch.tensor(sk.gauss_taps(w_size))
    halo = sk.TILE + w_size - 1
    parts = torch.zeros(2, n * c, ty * tx)
    for plane in range(n * c):
        px, py = x[plane // c, :, :, plane % c], y[plane // c, :, :, plane % c]
        for by in range(ty):
            for bx in range(tx):
                sx, sy = torch.zeros(halo, halo), torch.zeros(halo, halo)
                h0, w0 = by * sk.TILE, bx * sk.TILE
                rows, cols = min(halo, h - h0), min(halo, w - w0)
                sx[:rows, :cols] = px[h0:h0 + rows, w0:w0 + cols]
                sy[:rows, :cols] = py[h0:h0 + rows, w0:w0 + cols]
                f = []
                for img in (sx, sy, sx * sx, sy * sy, sx * sy):
                    row = sum(img[:, k:k + sk.TILE] * g[k] for k in range(w_size))
                    f.append(sum(row[k:k + sk.TILE] * g[k] for k in range(w_size)))
                mu1, mu2, xx, yy, xy = f
                s1, s2, s12 = xx - mu1 * mu1, yy - mu2 * mu2, xy - mu1 * mu2
                c1, c2 = (0.01 * dyn_planes[plane]) ** 2, (0.03 * dyn_planes[plane]) ** 2
                v1, v2 = 2.0 * s12 + c2, s1 + s2 + c2
                ssim_map = ((2.0 * mu1 * mu2 + c1) * v1) / ((mu1 * mu1 + mu2 * mu2 + c1) * v2)
                oy = torch.arange(sk.TILE)[:, None] + h0 < vh
                ox = torch.arange(sk.TILE)[None, :] + w0 < vw
                mask = (oy & ox).float()
                parts[0, plane, by * tx + bx] = (ssim_map * mask).sum()
                parts[1, plane, by * tx + bx] = (v1 / v2 * mask).sum()
    return parts[0], parts[1]


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


def test_plane_ranges_is_one_stored_value_per_plane():
    """The kernel indexes the vector by plane: a stride-0 view of one value
    would send it past the end of the storage."""
    x = torch.cat([rand(0, 1, 16, 16, 3), rand(1, 1, 16, 16, 3, scale=255.0)])
    for per_sample, want in ((True, [1.0] * 3 + [255.0] * 3), (False, [255.0] * 6)):
        r = sk.plane_ranges(x, per_sample)
        assert r.shape == (6,) and r.dtype == torch.float32
        assert r.is_contiguous() and r.stride() == (1,)
        assert r.untyped_storage().nbytes() >= 6 * 4
        assert r.tolist() == want


@pytest.mark.parametrize("shape,scale", [((2, 32, 32, 3), 1.0), ((1, 24, 40, 1), 1.0),
                                         ((1, 50, 70, 2), 255.0), ((2, 43, 75, 1), 1.0)])
def test_tiled_algorithm_matches_plain_version(shape, scale):
    """Ragged tiles (14x30, 40x60, 33x65 valid) add nothing from beyond the edge."""
    x, y = rand(2, *shape, scale=scale), rand(3, *shape, scale=scale)
    n, h, w, c = shape
    vh, vw, _, _ = sk.tiling(h, w)
    for per_sample in (False, True):
        ssim_p, cs_p = emulate_kernel(x, y, sk.plane_ranges(x, per_sample))
        got = sk._finish(ssim_p.sum(1), cs_p.sum(1), n, c, vh * vw, False, True)
        want = sk.ssim_reference(x, y, size_average=False, full=True,
                                 per_sample_range=per_sample)
        for g, r in zip(got, want):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-6, rtol=0)


def test_finish_follows_the_pallas_wrapper():
    ssim_sums, cs_sums = torch.arange(6.0), torch.arange(6.0) * 2
    mean = sk._finish(ssim_sums, cs_sums, 2, 3, 10, True, False)
    assert mean.item() == pytest.approx(15.0 / 60)
    per, cs = sk._finish(ssim_sums, cs_sums, 2, 3, 10, False, True)
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
        sk._kernel(x, x, sk.plane_ranges(x, False), dims, 4)
    # the plain version is differentiable: the losses take it
    xg = x.clone().requires_grad_()
    sk.ssim_reference(xg, rand(5, 1, 16, 16, 3)).backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0


def test_bf16_inputs_are_filtered_in_fp32():
    x, y = rand(6, 1, 16, 16, 3), rand(7, 1, 16, 16, 3)
    want = sk.ssim_reference(x.bfloat16().float(), y.bfloat16().float())
    for fn in (sk.ssim_fused, sk.ssim_reference):
        got = fn(x.bfloat16(), y.bfloat16())
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
