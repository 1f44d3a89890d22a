"""The port's evaluation metrics against the JAX package on the same numpy
inputs, and against the framework-free golden values.

Both sides compute in fp32 on the CPU: MSE, PSNR and SSIM within atol 1e-6,
AE within rtol 1e-5 (acos amplifies the last bit near 0 and 180 degrees).
``ssim_reference`` (one 11x11 convolution per map) is held to ``ssim_xla``
(the same form) and to the interpreted Pallas kernel (the separable form) at
1e-6, the bound the JAX package holds its own two forms to.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srcgan_tpu import metrics as jmetrics
from srcgan_tpu.ops.pallas.ssim_kernel import ssim_pallas
from srcgan_tpu_torch import metrics
from srcgan_tpu_torch.ops.kernels import ssim_kernel

GOLDEN = "tests/golden/golden_v1.npz"


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).uniform(0, 1, shape) * scale).astype(np.float32)


def pair(seed, *shape, scale=1.0):
    return rand(seed, *shape, scale=scale), rand(seed + 100, *shape, scale=scale)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def num(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("name,tol", [("mse", dict(atol=1e-6, rtol=0)),
                                      ("psnr", dict(atol=1e-6, rtol=1e-6)),
                                      ("angular_error", dict(atol=0, rtol=1e-5)),
                                      ("mse_per_sample", dict(atol=1e-6, rtol=0)),
                                      ("psnr_per_sample", dict(atol=1e-6, rtol=1e-6)),
                                      ("ae_per_sample", dict(atol=0, rtol=1e-5))])
@pytest.mark.parametrize("shape", [(2, 24, 24, 3), (3, 16, 20, 1)])
def test_pointwise_metrics_match_jax(name, tol, shape):
    a, b = pair(1, *shape)
    got = getattr(metrics, name)(t(a), t(b))
    want = getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b))
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(num(got), np.asarray(want), **tol)


def test_angular_error_clips_and_handles_zero_vectors():
    """Parallel vectors give cos slightly above 1 before the clip; a zero
    vector gives cos 0 (eps in the denominator), 90 degrees, as in JAX."""
    a = np.zeros((1, 4, 4, 3), np.float32)
    a[0, :2] = [0.3, 0.6, 0.9]
    b = np.full((1, 4, 4, 3), 0.5, np.float32)
    b[0, :2] = [0.1, 0.2, 0.3]
    got = metrics.angular_error(t(a), t(b))
    want = jmetrics.angular_error(jnp.asarray(a), jnp.asarray(b))
    assert np.isfinite(num(got)).all()
    np.testing.assert_allclose(num(got), np.asarray(want), rtol=1e-5)


# the four cases the JAX package holds its Pallas kernel to
# (tests/test_metrics_losses.py::TestPallasSSIM)
SSIM_CASES = {
    "mean-rgb": ((2, 32, 32, 3), 1.0, dict()),
    "mean-ragged-gray": ((1, 24, 40, 1), 1.0, dict()),
    "range-255-full": ((1, 32, 32, 3), 255.0, dict(full=True)),
    "per-sample": ((3, 24, 24, 3), 1.0, dict(size_average=False)),
}


@pytest.mark.parametrize("case", sorted(SSIM_CASES))
@pytest.mark.parametrize("other", ["ssim_xla", "ssim_pallas-interpret"])
def test_ssim_reference_matches_jax(case, other):
    shape, scale, kw = SSIM_CASES[case]
    a, b = pair(2, *shape, scale=scale)
    got = metrics.ssim_reference(t(a), t(b), **kw)
    if other == "ssim_xla":
        want = jmetrics.ssim_xla(jnp.asarray(a), jnp.asarray(b), **kw)
    else:
        want = ssim_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True, **kw)
    for g, w in zip(got if kw.get("full") else (got,), want if kw.get("full") else (want,)):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(num(g), np.asarray(w), atol=1e-6, rtol=0)


def mixed_range_batch():
    a0 = rand(3, 1, 24, 24, 3)
    a1 = rand(4, 1, 24, 24, 3, scale=255.0)
    a2 = rand(5, 1, 24, 24, 3) - 0.7          # min < -0.5: range 2
    return np.concatenate([a0, a1, a2]), rand(6, 3, 24, 24, 3)


def test_ssim_per_sample_range_matches_batch_one_replay():
    """Per-sample dynamic range == feeding one sample at a time, mixed
    ranges (1, 255 and 2) in one batch; also the interpreted Pallas kernel."""
    a, b = mixed_range_batch()
    got = metrics.ssim_per_sample(t(a), t(b))
    replay = np.array([float(jmetrics.ssim_xla(jnp.asarray(a[i:i + 1]), jnp.asarray(b[i:i + 1])))
                       for i in range(3)])
    pallas = ssim_pallas(jnp.asarray(a), jnp.asarray(b), size_average=False,
                         per_sample_range=True, interpret=True)
    np.testing.assert_allclose(num(got), replay, atol=1e-6, rtol=0)
    np.testing.assert_allclose(num(got), np.asarray(pallas), atol=1e-6, rtol=0)
    own = torch.stack([metrics.ssim(t(a[i:i + 1]), t(b[i:i + 1])) for i in range(3)])
    np.testing.assert_allclose(num(got), num(own), atol=1e-7, rtol=0)


def test_dynamic_range_is_branchless_and_matches_the_protocol():
    a, _ = mixed_range_batch()
    per = ssim_kernel.dynamic_range(t(a), per_sample=True)
    np.testing.assert_array_equal(num(per), [1.0, 255.0, 2.0])
    whole = ssim_kernel.dynamic_range(t(a), per_sample=False)
    np.testing.assert_array_equal(num(whole), [256.0] * 3)     # max 255, min -1
    assert per.dtype == whole.dtype == torch.float32


def test_ssim_dispatch_on_cpu_is_the_plain_version():
    a, b = pair(7, 2, 24, 24, 3)
    before = ssim_kernel.launches
    for kw in (dict(), dict(size_average=False), dict(full=True)):
        got, want = metrics.ssim(t(a), t(b), **kw), metrics.ssim_reference(t(a), t(b), **kw)
        for g, w in zip(got if kw.get("full") else (got,), want if kw.get("full") else (want,)):
            assert torch.equal(g, w)
    assert ssim_kernel.launches == before


def test_ssim_window_sizes_match_jax():
    a, b = pair(8, 1, 20, 20, 3)
    for w_size in (7, 11):
        got = metrics.ssim(t(a), t(b), w_size=w_size)
        want = jmetrics.ssim_xla(jnp.asarray(a), jnp.asarray(b), w_size=w_size)
        np.testing.assert_allclose(num(got), np.asarray(want), atol=1e-6, rtol=0)


def test_metric_objects_are_the_csv_columns():
    evs = metrics.default_evaluators()
    assert [repr(e) for e in evs] == [repr(e) for e in jmetrics.default_evaluators()]
    assert [repr(e) for e in evs] == ["MSE", "PSNR", "AE", "SSIM"]
    assert [n for n, _ in metrics.per_sample_evaluators()] == ["MSE", "PSNR", "AE", "SSIM"]
    a, b = pair(9, 2, 16, 16, 3)
    for ev, jev in zip(evs, jmetrics.default_evaluators()):
        np.testing.assert_allclose(num(ev(t(a), t(b))), np.asarray(jev(jnp.asarray(a),
                                                                      jnp.asarray(b))),
                                   atol=1e-6, rtol=1e-5)


def test_per_sample_means_equal_the_batch_one_protocol():
    """The mean of the per-sample values is the protocol's average over
    one-sample evaluations, for every column."""
    a, b = pair(10, 4, 16, 16, 3)
    for (name, fn), ev in zip(metrics.per_sample_evaluators(), metrics.default_evaluators()):
        batched = num(fn(t(a), t(b)))
        single = np.array([float(ev(t(a[i:i + 1]), t(b[i:i + 1])).mean()) for i in range(4)])
        np.testing.assert_allclose(batched, single, atol=1e-6, rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# The golden anchor: values recorded once, independent of either framework
# (tolerances of tests/test_golden.py).
# ---------------------------------------------------------------------------

# The golden SSIM is 0.0022 (two unrelated noise images), where rtol 1e-5 is
# 2e-8: less than one fp32 rounding of the SSIM map's mean, whose terms span
# [-1, 1].  The port's value is held to 1e-7 absolute there as well.
@pytest.mark.parametrize("name,key,rtol,atol", [("mse", "metric/mse", 1e-6, 0),
                                                ("psnr", "metric/psnr", 1e-6, 0),
                                                ("angular_error", "metric/ae", 1e-5, 0),
                                                ("ssim_reference", "metric/ssim", 1e-5, 1e-7),
                                                ("ssim", "metric/ssim", 1e-5, 1e-7)])
def test_golden_metric_values(name, key, rtol, atol):
    g = np.load(GOLDEN)
    a, b = t(g["metric/in_a"]), t(g["metric/in_b"])
    np.testing.assert_allclose(num(getattr(metrics, name)(a, b)), g[key], rtol=rtol, atol=atol)
