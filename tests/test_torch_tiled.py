"""The port's TiledPredictor against its own whole-image program and the JAX
package's TiledPredictor, on the same weights (ESPCN x2 + SRCNN: both local,
so an overlap at least the receptive-field radius makes stitching exact).

Stitched against the port's whole-image call: bit for bit.  Against JAX's
stitched scene: uint8 max|diff| <= 1 (fp32 convolutions sum in other
orders in the two frameworks; a value at a rounding boundary may fall
either way), also per-tile self-ensembled.
"""
import numpy as np
import pytest
import torch

from srcgan_tpu import models as jax_models
from srcgan_tpu import serving as jax_serving
from srcgan_tpu_torch import interop, models
from srcgan_tpu_torch.serving import CascadePredictor, TiledPredictor
from tests.torch_params import numpy_params


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.fixture(scope="module")
def local_cascade():
    """ESPCN x2 SR + SRCNN colorizer: JAX (model, params) pairs and a factory
    of port (sr, c) modules with the same weights."""
    sr, c = jax_models.create("ESPCN", 1, 1, 2), jax_models.create("SRCNN", 1, 3, 1)
    pa, pb = numpy_params(sr, 0), numpy_params(c, 1)

    def port():
        psr, pc = models.create("ESPCN", 1, 1, 2), models.create("SRCNN", 1, 3, 1)
        psr.load_state_dict(interop.state_dict_from_jax(psr, pa), strict=True)
        pc.load_state_dict(interop.state_dict_from_jax(pc, pb), strict=True)
        return psr, pc

    return port, (sr, pa, c, pb)


@pytest.mark.parametrize("n,t,ov", [(37, 28, 10), (45, 28, 10), (28, 28, 10), (29, 28, 10),
                                    (256, 256, 32), (700, 256, 64), (1000, 256, 64),
                                    (100, 24, 8), (53, 24, 8), (30, 24, 8), (64, 32, 8),
                                    (33, 16, 7)])
def test_axis_windows_match_jax(n, t, ov):
    got = TiledPredictor._axis_windows(n, t, ov)
    assert got == jax_serving.TiledPredictor._axis_windows(n, t, ov)
    covered = sorted((c0, c0 + ln) for _, _, c0, ln in got)
    assert covered[0][0] == 0 and covered[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))
    assert all(0 <= w <= n - t for w, _, _, _ in got)          # flush, never padded


def test_scene_bit_exact_vs_whole_image(local_cascade):
    """37x45 scene, tile 28, overlap 10 (ESPCN's LR radius 5 plus the HR
    radius 7 of its last conv and SRCNN, 9 at LR): stitched == one call."""
    port, _ = local_cascade
    sr, c = port()
    whole = CascadePredictor(sr, c, 2, device="cpu")
    tiled = TiledPredictor(sr, c, 2, tile=28, overlap=10, max_batch=4, device="cpu")
    scene = u8(0, (37, 45))
    want = whole.predict(scene[None, ..., None])[0]
    got = tiled.predict_scene(scene)
    assert got.shape == (74, 90, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("self_ensemble", [False, True], ids=["plain", "self_ensemble"])
def test_scene_matches_jax(local_cascade, self_ensemble):
    port, (sr, pa, c, pb) = local_cascade
    tiled = TiledPredictor(*port(), 2, tile=28, overlap=10, max_batch=4,
                           self_ensemble=self_ensemble, device="cpu")
    jax_tiled = jax_serving.TiledPredictor(sr, pa, c, pb, up=2, tile=28, overlap=10,
                                           max_batch=4, self_ensemble=self_ensemble)
    scene = u8(1, (37, 45))
    got, want = tiled.predict_scene(scene), jax_tiled.predict_scene(scene)
    assert got.shape == want.shape == (74, 90, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_rgb_scene(local_cascade):
    port, _ = local_cascade
    sr, c = port()
    tiled = TiledPredictor(sr, c, 2, tile=28, overlap=10, max_batch=4, device="cpu")
    scene = u8(2, (30, 34, 3))
    out = tiled.predict_scene(scene)
    assert out.shape == (60, 68, 3) and out.dtype == np.uint8
    whole = CascadePredictor(sr, c, 2, device="cpu").predict(scene[None])[0]
    np.testing.assert_array_equal(out, whole)


def test_scale_one_cascade_infers_the_scale(local_cascade):
    """A resolution-preserving SR net: the stitcher reads the scale off the
    first output tile rather than trusting ``up``."""
    sr, c = models.create("SRCNN", 1, 1, 2), local_cascade[0]()[1]
    tiled = TiledPredictor(sr, c, 2, tile=24, overlap=8, max_batch=4, device="cpu")
    out = tiled.predict_scene(u8(3, (30, 53)))
    assert out.shape == (30, 53, 3)


def test_subtile_scene_is_one_call_of_one_row(local_cascade):
    """A scene below the tile in either dimension runs as one call at its own
    shape, a batch of 1, not padded to max_batch."""
    port, _ = local_cascade
    sr, c = port()
    tiled = TiledPredictor(sr, c, 2, tile=28, overlap=10, max_batch=8, device="cpu")
    seen = []
    run = tiled._run

    def spy(x):
        seen.append(tuple(x.shape))
        return run(x)

    tiled._run = spy
    scene = u8(4, (20, 40))
    out = tiled.predict_scene(scene)
    assert seen == [(1, 20, 40, 1)] and out.shape == (40, 80, 3)
    tiled._run = run
    np.testing.assert_array_equal(out, CascadePredictor(sr, c, 2, device="cpu").predict(
        scene[None, ..., None])[0])


def test_full_batches_and_bounded_flight(local_cascade):
    """64x64 at tile 28, overlap 10 (core 8): 8x8 windows = 64 tiles = 8
    batches of 8, at most two in flight behind the one enqueued last."""
    port, _ = local_cascade
    tiled = TiledPredictor(*port(), 2, tile=28, overlap=10, max_batch=8, device="cpu")
    enqueued, collected = [], []
    async_, collect = tiled._predict_async, tiled._collect

    def spy_async(x, pad=None):
        enqueued.append(x.shape[0])
        return async_(x, pad)

    def spy_collect(host, done):
        collected.append(len(enqueued))
        return collect(host, done)

    tiled._predict_async, tiled._collect = spy_async, spy_collect
    out = tiled.predict_scene(u8(5, (64, 64)))
    assert out.shape == (128, 128, 3)
    assert enqueued == [8] * 8
    # the first wait comes after the third batch is enqueued, then one per batch
    assert collected == [3, 4, 5, 6, 7, 8, 8, 8]


def test_tile_overlap_validation(local_cascade):
    sr, c = local_cascade[0]()
    with pytest.raises(ValueError, match="2\\*overlap"):
        TiledPredictor(sr, c, 2, tile=16, overlap=8, device="cpu")
