"""The port's colour ops (``ops.color``) and ``pixel_unshuffle`` against the
JAX package's, on numpy-seeded inputs.

Tolerances: 2e-5 absolute on normalized LAB, XYZ and RGB (two frameworks'
pow and cube root; observed under 1e-6); un-normalized LAB scales that by
its ranges (L by 100, ab by 255): 5e-3; the round trip within 1e-4; the
skimage goldens of tests/test_ops_parity.py within their 0.02 on LAB.  The
inputs include the edges of every branch (0.04045, 0.0031308, 0.008856,
0.2068966) and values outside [0, 1], which the colorizer's ab output
produces.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srcgan_tpu import ops as jops
from srcgan_tpu.ops import color as jcolor
from srcgan_tpu_torch import ops
from srcgan_tpu_torch.ops import color, conv

EDGES = (0.04045, 0.0031308, 0.008856, 0.2068966)


def seeded(seed, lo, hi, shape=(2, 12, 10, 3)):
    x = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    flat = x.reshape(-1)
    probes = [0.0, 1.0]
    for e in EDGES:                       # each edge, and one fp32 step to either side
        e32 = np.float32(e)
        probes += [e32, np.nextafter(e32, np.float32(0)), np.nextafter(e32, np.float32(1))]
    flat[:len(probes)] = probes
    return x


FUNCTIONS = [("rgb_to_xyz", 2e-5), ("xyz_to_rgb", 2e-5), ("rgb_to_lab", 5e-3),
             ("lab_to_rgb", 2e-5), ("rgb_to_lab_norm", 2e-5), ("lab_norm_to_rgb", 2e-5),
             ("rgb_to_ab_norm", 2e-5), ("rgb_to_gray", 1e-6), ("luma", 1e-6)]


@pytest.mark.parametrize("name,atol", FUNCTIONS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.4, 1.6)], ids=["unit", "out-of-range"])
def test_colour_function_equals_jax(name, atol, lo, hi):
    x = seeded(len(name), lo, hi)
    if name == "lab_to_rgb":              # un-normalized LAB in, over and beyond its ranges
        x = x * np.array([100.0, 255.0, 255.0], np.float32) - np.array([0, 128, 128], np.float32)
    want = np.asarray(getattr(jcolor, name)(jnp.asarray(x)))
    got = getattr(color, name)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.isfinite(got.numpy()).all() and np.isfinite(want).all()
    assert np.abs(got.numpy() - want).max() <= atol


def test_lab_known_values():
    """Golden values from skimage.color.rgb2lab (D65, 2-degree observer), as
    tests/test_ops_parity.py holds the JAX package to them."""
    rgb = torch.tensor([[[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                          [1.0, 1.0, 1.0], [0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]]])
    golden = np.array([[53.2406, 80.0942, 67.2015], [87.7351, -86.1813, 83.1775],
                       [32.2957, 79.1875, -107.8602], [100.0, 0.0, 0.0],
                       [0.0, 0.0, 0.0], [53.3890, 0.0, 0.0]])
    np.testing.assert_allclose(color.rgb_to_lab(rgb).numpy()[0, 0], golden, atol=0.02)


@pytest.mark.parametrize("norm", [False, True])
def test_lab_round_trip(norm):
    rgb = torch.from_numpy(seeded(5, 0.0, 1.0))
    there, back = ((color.rgb_to_lab_norm, color.lab_norm_to_rgb) if norm
                   else (color.rgb_to_lab, color.lab_to_rgb))
    lab = there(rgb)
    if norm:
        assert 0.0 <= float(lab.min()) and float(lab.max()) <= 1.0
    assert (back(lab) - rgb).abs().max().item() <= 1e-4


def test_inverse_matrix_is_the_fp32_inverse_and_cached():
    inv = np.array(color._rgb_from_xyz(), np.float32)
    np.testing.assert_allclose(inv, np.asarray(jcolor._RGB_FROM_XYZ), rtol=2e-6)
    np.testing.assert_allclose(inv @ np.array(color._XYZ_FROM_RGB, np.float32), np.eye(3),
                               atol=1e-6)
    assert color._rgb_from_xyz() is color._rgb_from_xyz()


def test_colour_ops_keep_dtype_and_leading_shape():
    x = torch.rand(5, 3, dtype=torch.float64)
    assert color.rgb_to_lab_norm(x).dtype == torch.float64
    assert color.rgb_to_ab_norm(x).shape == (5, 2)
    assert color.lab_norm_to_rgb(torch.rand(2, 4, 4, 3)).shape == (2, 4, 4, 3)


@pytest.mark.parametrize("r", [2, 3, 4])
def test_pixel_unshuffle_equals_jax_and_inverts_pixel_shuffle(r):
    x = np.random.default_rng(r).uniform(-1, 1, (2, 4 * r, 3 * r, 5)).astype(np.float32)
    got = conv.pixel_unshuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.pixel_unshuffle(jnp.asarray(x), r)))
    assert got.shape == (2, 4, 3, 5 * r * r)
    y = torch.from_numpy(np.random.default_rng(r + 9).uniform(-1, 1, (2, 4, 3, 2 * r * r))
                         .astype(np.float32))
    assert torch.equal(conv.pixel_unshuffle(conv.pixel_shuffle(y, r), r), y)
    assert torch.equal(conv.pixel_shuffle(got, r), torch.from_numpy(x))
    assert ops.pixel_unshuffle is conv.pixel_unshuffle
