"""The four-card scene cell's readers on the CPU: the halo megabytes from the
program's counter, the share of the ranks' summed peak, and NCCL's share of
the device slice, each giving nothing where there is nothing to read."""
import sys
from types import SimpleNamespace

import pytest

from portbench import flops, harness

BENCH = harness.BENCH


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py", name.replace(".", "_"))


def test_halo_mb_reads_the_programs_counter_a_scene(monkeypatch):
    from srcgan_tpu_torch.utils import trace

    read = reader("halo_mb.space4").read
    trace.reset()
    assert read(None, {"scenes_served": 3}) is None
    trace.count("space.halo_bytes", 3_000_000)
    trace.count("space.halo_bytes", 3_000_000)
    assert read(None, {"scenes_served": 3}) == pytest.approx(2.0)
    assert read(None, {}) is None
    import srcgan_tpu_torch.utils

    monkeypatch.delattr(srcgan_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "srcgan_tpu_torch.utils.trace", None)
    assert read(None, {"scenes_served": 3}) is None
    trace.reset()


def test_mfu_space4_over_the_ranks_peak():
    read = reader("mfu.space4").read
    counters = {"window_s": 2.0, "model_flop": 4 * 989e12, "dtype": "bf16", "ranks": 4}
    assert read(None, counters) == pytest.approx(50.0)
    assert flops.PEAK_FLOPS["bf16"] == 989e12
    assert read(None, {}) is None


def test_nccl_pct_clips_to_the_device_slice():
    read = reader("nccl_pct.space4").read
    device = [(0, 100, "ncclDevKernel_AllReduce_Sum_f32", 1, 0),
              (100, 400, "cudnn_fprop", 2, 0),
              (900, 1300, "ncclDevKernel_SendRecv", 3, 0)]       # 100 ns inside
    s = SimpleNamespace(device=device, start_ns=0, stop_ns=1000)
    trace = SimpleNamespace(device_slice=s)
    assert read(trace, {}) == pytest.approx(100.0 * 200 / 500)
    assert read(SimpleNamespace(device_slice=SimpleNamespace(device=[], start_ns=0,
                                                             stop_ns=1)), {}) is None
    assert read(None, {}) is None
