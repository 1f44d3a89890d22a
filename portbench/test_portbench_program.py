"""The readers of the program's own counters (``srcgan_tpu_torch.utils.trace``),
on the CPU: a traced run of the tiny tiled cell reports the useful share of
the computed pixels that the window plan gives for the scenes the process
served, and the reader gives nothing where the program keeps no counters."""
import random
import sys

import pytest
import torch

from portbench import harness
from portbench.reference import tiles as plan
from portbench.test_portbench_harness import BENCH, TINY

SEED = 2_147_483_777


def read(counters=None):
    module = harness.load_module(BENCH / "metrics" / "useful_px_pct.scene.py", "useful_px")
    return module.read(None, counters or {})


def plan_share(sizes, tile, overlap, max_batch, up):
    kept = computed = 0
    for h, w in sizes:
        rows = -(-len(plan.plan(h, w, tile, overlap)) // max_batch) * max_batch
        kept += h * w * up * up
        computed += rows * (tile * up) ** 2
    return 100.0 * kept / computed


def test_a_traced_tiled_run_reports_the_plans_useful_share():
    from srcgan_tpu_torch.utils import trace

    torch.set_num_threads(min(torch.get_num_threads(), 4))
    trace.reset()
    cell, entry, b = harness.cell_from_files("x4_scenes_tiled", SEED, 1.0, True)
    cell.traffic.update(TINY["x4_scenes_tiled"])
    cell.device = torch.device("cpu")
    outcome = harness.run_driver(cell)
    line = harness.report(cell, entry, b, outcome, "cpu")
    t = cell.traffic
    sizes = [tuple(s) for s in t["scenes"]]
    random.Random(harness.derive_seed(SEED, "order")).shuffle(sizes)
    served = [min(sizes, key=lambda s: s[0] * s[1])]            # the set-up's warm scene
    served += [sizes[k % len(sizes)] for k in range(line["attempted"])]
    up = cell.config["sr_model"]["up"]
    want = plan_share(served, t["tile"], t["overlap"], t["max_batch"], up)
    assert line["correct"], line["check"]
    assert line["metrics"]["useful_px_pct.scene"]["value"] == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


def test_the_reader_gives_nothing_without_the_programs_counters(monkeypatch):
    from srcgan_tpu_torch.utils import trace

    trace.reset()
    assert read() is None
    trace.count("tiler.kept_px", 463)
    trace.count("tiler.computed_px", 1000)
    assert read() == pytest.approx(46.3)
    # a program without the module
    import srcgan_tpu_torch.utils

    monkeypatch.delattr(srcgan_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "srcgan_tpu_torch.utils.trace", None)
    assert read() is None
    trace.reset()
