"""The harness on the CPU at a size a test run holds: every cell's run as the
benchmark makes it, with the card's look skipped; its control and each
fault the cell can have must come out not correct; the files the harness
finds by name; the readers; and the modules a run loads."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, tracing, variants

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
# each cell at a size the CPU holds: full widths, small tiles, short windows
TINY = {
    "x4_stream_b8": {"batch": 2, "side": 16, "pool": 3, "warmup": 1, "check": 2},
    "x4_scenes_tiled": {"tile": 32, "overlap": 8, "max_batch": 4, "check": 1,
                        "scenes": [[48, 64], [32, 48]]},
    "x2_train_b32": {"batch": 4, "side": 32, "pool": 3, "checked": 2, "warmup": 1},
}
# The CPU's bf16 convolutions round otherwise than the card's: at this size a
# sound bf16 training run reads a median gradient gap of up to ~0.009 here
# against 0.0024 on the card, so the training cell runs in float32 on the
# CPU (the control is the reference in fp8 and the faults break either).
CPU_CONFIG = {"x2_train_b32": {"train": {"act_dtype": "float32"}}}
FAULTS = {"x4_stream_b8": ("answer_altered",), "x4_scenes_tiled": ("answer_altered",),
          "x2_train_b32": ("state_unchanged", "half_batch")}


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_run(workload: str, variant: str = "program", seed: int = 2_147_483_777) -> dict:
    """One run of the cell as the benchmark makes it, on the CPU, small."""
    cell, entry, b = harness.cell_from_files(workload, seed, 1.0, False)
    cell.traffic.update(TINY[workload])
    for key, value in CPU_CONFIG.get(workload, {}).items():
        cell.config[key] = {**cell.config[key], **value}
    cell.device, cell.variant = torch.device("cpu"), variant
    return harness.report(cell, entry, b, harness.run_driver(cell), "cpu")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", list(TINY))
def test_a_run_is_correct_and_reports_its_metrics(workload):
    line = tiny_run(workload)
    assert line["correct"], line["check"]
    assert line["failed"] == 0 and line["attempted"] > 0
    ends = {m["name"] for m in bench()["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}
    assert set(line["metrics"]) == ends
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "check"


@pytest.mark.parametrize("workload", list(TINY))
def test_the_control_is_not_correct(workload):
    assert not tiny_run(workload, "control")["correct"]


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in FAULTS.items() for f in fs])
def test_a_fault_is_not_correct(workload, fault):
    assert fault in variants.FAULTS
    assert not tiny_run(workload, fault)["correct"]


def test_the_files_of_every_cell_and_metric_are_there():
    b = bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert harness.load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    reported = {}
    for w in b["workloads"]:
        traffic = harness.load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        reported[w["name"]] = {m["name"] for m in b["end_to_end"]
                               if "workloads" not in m or w["name"] in m["workloads"]}
    names = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert m["moves"] in reported[w], (m["name"], w)
    for m in b["end_to_end"] + b["per_layer"] + b["workloads"] + b["configs"]:
        assert names.match(m["name"])
    assert len(json.dumps(b)) < 64 * 1024


def test_readers_take_their_numbers_from_the_trace():
    class Event:
        def __init__(self, kind, name, start, dur, corr=0, tid=1):
            self.k, self.n, self.s, self.d, self.c, self.t = kind, name, start, dur, corr, tid

        def activity_type(self):
            return self.k

        def name(self):
            return self.n

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

        def correlation_id(self):
            return self.c

        def linked_correlation_id(self):
            return 0

        def start_thread_id(self):
            return self.t

    ms = 1_000_000
    events = [Event("user_annotation", "portbench.colorizer", 0, 10 * ms),
              Event("user_annotation", "portbench.rdb5", 20 * ms, 5 * ms),
              Event("cuda_runtime", "cudaLaunchKernel", 1 * ms, 1000, corr=1),
              Event("cuda_runtime", "cudaLaunchKernel", 21 * ms, 1000, corr=2),
              Event("cuda_runtime", "cudaLaunchKernel", 30 * ms, 1000, corr=3),
              Event("kernel", "gn_kernel", 2 * ms, 6 * ms, corr=1),
              Event("kernel", "rdb5_kernel<bf16>", 22 * ms, 2 * ms, corr=2),
              Event("kernel", "tail_x4_kernel", 31 * ms, 1 * ms, corr=3),
              Event("kernel", "finish_kernel", 33 * ms, 1 * ms, corr=0),
              Event("cpu_op", "aten::copy_", 8 * ms, 14 * ms)]
    s = tracing.Summary(events, 0, 36 * ms, {"rdb5": {(8, 64, 128, 128)},
                                             "sr_net": {(8, 1, 128, 128)}})
    assert s.busy_s == pytest.approx(0.010) and s.window_s == pytest.approx(0.036)
    assert s.span_instances("colorizer") == [pytest.approx(0.006)]

    def read(name, counters=None):
        path = BENCH / "metrics" / f"{name}.py"
        return harness.load_module(path, name.replace(".", "_")).read(s, counters or {"dtype": "bf16"})

    assert read("idle_pct.serve") == pytest.approx(100 * (1 - 10 / 36))
    assert read("colorizer_pct.serve") == pytest.approx(60.0)
    assert read("group_norm_pct.serve") is None
    assert read("rdb5_bf16_roofline") == pytest.approx(100 * 0.0635e-3 / 0.002, rel=1e-2)
    assert read("tail_x4_roofline") == pytest.approx(100 * 24.16e-6 / 0.002, rel=1e-2)
    assert read("mfu.serve", {"model_flop": 989e12, "window_s": 10.0, "dtype": "bf16"}) == \
        pytest.approx(10.0)
    assert read("enqueue_ms.train", {"steps": 10, "enqueue_s": 0.5}) == pytest.approx(50)
    gaps = s.breakdown()["idle_gaps"]
    assert gaps[0][0] == "aten::copy_"            # the host's call across the longest gaps
    assert sum(g for _, g in gaps) == pytest.approx(0.026)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("srcgan_tpu_torch",) + harness.FORBIDDEN, \
                    (path.name, name)


def test_no_run_loads_jax_or_the_jax_package():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "torch.set_num_threads(2)\n"
        "from portbench import harness, test_portbench_harness as t\n"
        "for w in t.TINY:\n"
        "    t.tiny_run(w)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this checks the run on a machine without a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "x4_stream_b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
