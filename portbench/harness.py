"""One run of one cell: find its files by name, check for the card, hand the
cell to its driver, read the per-layer metrics from the trace, decide
``correct`` and print the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names the driver that
generates it (``drivers/<kind>.py``), and ``limits/<cell>.json`` holds the
limits of the numbers that decide ``correct``.  A per-layer metric is
``metrics/<name>.py``, whose ``read(trace, counters)`` returns a number or
None.  Nothing here names a cell, a configuration or a metric: adding one is
adding its files.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may load (compared whole: the program's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "srcgan_tpu")


def setup_env() -> None:
    """Every compiler cache of the run at a fixed place inside the checkout;
    no library may load JAX on the port's behalf.  Before torch is imported."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def process_seconds() -> float:
    """Seconds since this process started, from the kernel's record of it."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return float(Path("/proc/uptime").read_text().split()[0]) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's seed (weights, inputs, order)."""
    digest = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    """Everything a driver needs for one run.  ``variant`` is "program" for
    every run of the benchmark's command; the control and fault runs of
    ``control.py`` and the tests set it otherwise."""
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object = None
    variant: str = "program"

    def say(self, msg: str) -> None:
        print(f"[portbench {self.name}] {msg}", file=sys.stderr, flush=True)

    def generator(self, purpose: str):
        import torch

        gen = torch.Generator(device=self.device)
        return gen.manual_seed(derive_seed(self.seed, purpose))


@dataclass
class Outcome:
    """What a driver hands back."""
    metrics: dict                 # end-to-end name -> value
    attempted: int
    failed: int
    numbers: dict                 # compared name -> value (limits in the cell's file)
    memory_peak_bytes: int
    counters: dict = field(default_factory=dict)   # for the per-layer readers
    trace: object = None          # tracing.Trace of the profiled slices
    notes: dict = field(default_factory=dict)      # printed to stderr, not judged


def cell_from_files(workload: str, seed: int, seconds: float, trace: bool,
                    bench: dict | None = None) -> tuple:
    """(Cell, the workload's entry, BENCHMARK.json) from the files."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    return Cell(workload, config, traffic, limits, seed, seconds, trace), entry, bench


def run_driver(cell: Cell) -> Outcome:
    driver = load_module(BENCH / "drivers" / f"{cell.traffic['driver']}.py",
                         f"portbench_driver_{cell.traffic['driver']}")
    return driver.run(cell)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and every limit met by a number."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        table[name] = {"value": value, "limit": limit}
    return ok, table


def per_layer(bench: dict, workload: str, outcome: Outcome) -> dict:
    """The per-layer metrics that list this cell, each read by its file."""
    out = {}
    for m in bench["per_layer"]:
        if workload not in m["workloads"]:
            continue
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             f"portbench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(outcome.trace, outcome.counters)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, entry, bench = cell_from_files(args.workload, args.seed, args.seconds,
                                         bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell.device = torch.device("cuda", 0)
    outcome = run_driver(cell)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port must run without them",
              file=sys.stderr)
        return 4
    if cell.trace and (outcome.trace is None or outcome.trace.busy_s <= 0):
        print("portbench: the traced slice holds no device activity", file=sys.stderr)
        return 5
    line = report(cell, entry, bench, outcome, torch.cuda.get_device_name(0))
    if outcome.trace is not None:
        cell.say(outcome.trace.describe())
    for k, v in outcome.notes.items():
        cell.say(f"{k}: {v}")
    for k, v in line["check"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def report(cell: Cell, entry: dict, bench: dict, outcome: Outcome, kind: str) -> dict:
    """The result line of a run: with --trace 0 the cell's end-to-end metrics,
    with --trace 1 its per-layer ones; ``check`` last."""
    end_to_end = {m["name"] for m in bench["end_to_end"]
                  if "workloads" not in m or cell.name in m["workloads"]}
    if cell.trace:
        metrics = per_layer(bench, cell.name, outcome)
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in outcome.metrics.items()
                   if k in end_to_end}
    correct, table = judge(outcome.numbers, cell.limits)
    device = {"platform": "gpu", "kind": kind, "count": entry["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if cell.trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["check"] = table
    return line
