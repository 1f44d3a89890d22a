"""The port's counters (``srcgan_tpu_torch.utils.trace``) and the tiler's
pixel counters, on the CPU at small sizes."""
import sys
import threading

import numpy as np
import pytest
import torch

from srcgan_tpu_torch import models
from srcgan_tpu_torch.serving import TiledPredictor
from srcgan_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def clean_counters():
    torch.set_num_threads(min(torch.get_num_threads(), 2))
    trace.reset()
    yield
    trace.reset()


def test_counters_add_copy_and_reset():
    trace.count("a")
    trace.count("a", 4)
    trace.count("b", 7)
    seen = trace.counters()
    assert seen == {"a": 5, "b": 7}
    seen["a"] = 0                                       # a copy
    assert trace.counters()["a"] == 5
    trace.reset()
    assert trace.counters() == {}


def test_threads_lose_no_count():
    n_threads, n = 12, 2000

    def work():
        for _ in range(n):
            trace.count("c")

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert trace.counters() == {"c": n_threads * n}


def hand_count(h, w, tile, overlap, max_batch, up):
    """(kept px, computed px) of one scene, from the window plan."""
    kept = h * w * up * up
    if h < tile or w < tile:
        return kept, kept
    n = (len(TiledPredictor._axis_windows(h, tile, overlap))
         * len(TiledPredictor._axis_windows(w, tile, overlap)))
    rows_run = -(-n // max_batch) * max_batch
    return kept, rows_run * (tile * up) ** 2


@pytest.mark.parametrize("shape", [(45, 37), (24, 64), (20, 40)],
                         ids=["padded-rows", "full-batches", "smaller-than-a-tile"])
def test_tiler_counters_match_the_window_plan(shape):
    tile, overlap, max_batch, up = 24, 8, 4, 2
    gen = torch.Generator().manual_seed(0)
    tiled = TiledPredictor(models.create("ESPCN", 1, 1, up, generator=gen),
                           models.create("SRCNN", 1, 3, 1, generator=gen), up, tile=tile,
                           overlap=overlap, max_batch=max_batch, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):                                  # counted once per scene
        out = tiled.predict_scene(rng.integers(0, 256, shape, dtype=np.uint8))
    assert out.shape == (shape[0] * up, shape[1] * up, 3)
    kept, computed = hand_count(*shape, tile, overlap, max_batch, up)
    assert trace.counters() == {"tiler.kept_px": 2 * kept, "tiler.computed_px": 2 * computed}
    n = (len(TiledPredictor._axis_windows(shape[0], tile, overlap))
         * len(TiledPredictor._axis_windows(shape[1], tile, overlap)))
    if shape == (45, 37):
        assert n % max_batch and computed > n * (tile * up) ** 2
    if shape == (24, 64):
        assert n % max_batch == 0 and computed == n * (tile * up) ** 2
    if shape == (20, 40):
        assert kept == computed
