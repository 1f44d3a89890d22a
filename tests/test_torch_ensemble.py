"""The port's dihedral self-ensemble (``ops.ensemble``) and the
self-ensembled ``CascadePredictor`` against the JAX package's.

Dihedral ops are index maps: element-equal to JAX's ``dihedral_nhwc`` and to
the host-side ``data.dataset.dihedral``, each inverse exact.
``self_ensemble_apply`` averages in fp32 in the same order as JAX's: within
1e-6.  The self-ensembled predictor (ESPCN x2 + ResDeconv, 2x16^2, RGB and
LAB) averages eight fp32 outputs that each agree with JAX's to float
rounding, then rounds once: uint8 max|diff| <= 1.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from srcgan_tpu import models as jax_models
from srcgan_tpu import serving as jax_serving
from srcgan_tpu.ops import ensemble as jax_ensemble
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.data.dataset import dihedral
from srcgan_tpu_torch.ops import ensemble
from srcgan_tpu_torch.serving import CascadePredictor
from tests.torch_params import numpy_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("op", range(8))
def test_dihedral_matches_jax_and_host(op):
    x = np.random.default_rng(op).normal(size=(2, 5, 5, 3)).astype(np.float32)
    got = ensemble.dihedral_nhwc(torch.from_numpy(x), op).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ensemble.dihedral_nhwc(jnp.asarray(x), op)))
    for i in range(2):
        np.testing.assert_array_equal(got[i], dihedral(x[i], op))


@pytest.mark.parametrize("op", range(8))
def test_inverse_is_exact(op):
    x = torch.from_numpy(np.random.default_rng(10 + op).normal(size=(1, 4, 4, 2)).astype(np.float32))
    back = ensemble.dihedral_nhwc(ensemble.dihedral_nhwc(x, op), ensemble.DIHEDRAL_INVERSE[op])
    assert torch.equal(back, x)


def test_non_square_inputs_get_the_four_shape_preserving_ops():
    assert ensemble.ensemble_ops(4, 6) == ensemble.SHAPE_PRESERVING_OPS == (0, 2, 4, 5)
    assert ensemble.ensemble_ops(5, 5) == ensemble.ALL_OPS
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 4, 6, 1)).astype(np.float32))
    calls = []

    def fn(v):
        calls.append(tuple(v.shape))
        return v * 2.0

    out = ensemble.self_ensemble_apply(fn, x)
    assert calls == [(8, 4, 6, 1)]
    torch.testing.assert_close(out, x * 2.0, rtol=0, atol=1e-6)


# a fixed nonlinear fn of both frameworks: a 2x nearest upsample, a per-pixel
# nonlinearity and a spatially varying term (which D4 does not commute with)
def _torch_fn(v):
    up = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
    ramp = torch.arange(up.shape[2], dtype=up.dtype).view(1, 1, -1, 1) / 10.0
    return torch.tanh(up * 1.5) + ramp * up


def _jax_fn(v):
    up = jnp.repeat(jnp.repeat(v, 2, 1), 2, 2)
    ramp = jnp.arange(up.shape[2], dtype=up.dtype).reshape(1, 1, -1, 1) / 10.0
    return jnp.tanh(up * 1.5) + ramp * up


@pytest.mark.parametrize("outputs", ["tensor", "tuple"])
def test_self_ensemble_apply_matches_jax(outputs):
    x = np.random.default_rng(5).uniform(size=(2, 6, 6, 1)).astype(np.float32)
    if outputs == "tensor":
        tfn, jfn = _torch_fn, _jax_fn
    else:
        tfn = lambda v: (v * 0.5, _torch_fn(v))          # noqa: E731
        jfn = lambda v: (v * 0.5, _jax_fn(v))            # noqa: E731
    got = ensemble.self_ensemble_apply(tfn, torch.from_numpy(x))
    want = jax_ensemble.self_ensemble_apply(jfn, jnp.asarray(x))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (1 if outputs == "tensor" else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def espcn_resdeconv():
    """ESPCN x2 + ResDeconv (RGB: 3 outputs, LAB: 2) weights from numpy; the
    colorizer's last conv scaled by 0.03 so the outputs span [0, 1]."""
    out = {}
    for lab in (False, True):
        sr, c = jax_models.ESPCN(1, 1, 2), jax_models.ResDeconv(1, 2 if lab else 3)
        pb = numpy_params(c, 1)
        out[lab] = (sr, numpy_params(sr, 0), c, {**pb, "pred": {"w": pb["pred"]["w"] * 0.03}})
    return out


class _SpyNet(torch.nn.Module):
    """Records the batch and the memory format each forward of ``net`` sees."""

    def __init__(self, net, seen):
        super().__init__()
        self.net, self.seen = net, seen

    def forward(self, x):
        self.seen.append((x.shape[0], x.is_contiguous(memory_format=torch.channels_last)))
        return self.net(x)


@pytest.mark.parametrize("lab", [False, True], ids=["rgb", "lab"])
def test_predictor_self_ensemble_matches_jax(espcn_resdeconv, lab):
    sr, pa, c, pb = espcn_resdeconv[lab]
    psr, pc = models.ESPCN(1, 1, 2), models.ResDeconv(1, 2 if lab else 3)
    psr.load_state_dict(interop.state_dict_from_jax(psr, pa), strict=True)
    pc.load_state_dict(interop.state_dict_from_jax(pc, pb), strict=True)
    pred = CascadePredictor(psr, pc, 2, lab=lab, self_ensemble=True, device="cpu")
    seen = []
    pred.sr_model = _SpyNet(pred.sr_model, seen)
    x = u8(40 + lab, (2, 16, 16, 1))
    got = pred.predict(x)
    assert seen == [(16, True)]                  # the 8 copies of 2 rows in ONE channels_last batch
    want = jax_serving.CascadePredictor(sr, pa, c, pb, up=2, lab=lab,
                                        self_ensemble=True).predict(x)
    assert got.shape == want.shape == (2, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    plain = CascadePredictor(psr, pc, 2, lab=lab, device="cpu").predict(x)
    assert np.abs(got.astype(int) - plain.astype(int)).mean() > 0   # the ensemble changed it
