"""The readings behind the limits of ``correct``, taken on the card at a cell's
own size and load, many seeds in one process:

    python3 portbench/control.py --workload x4_stream_b8 --variant control \\
        --seconds 3 --seeds 11 12 13

``--variant program`` reads the program itself (the lower readings),
``control`` a precision below the configuration's (the program's int8 path
where it has one, else the reference in fp8 in its place), and a fault of
``variants.FAULTS`` the timed path broken underneath.  Prints one JSON line
a run: the numbers compared, the end-to-end metrics and the notes.  The
benchmark's own runs never run it.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness, variants  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="control",
                    choices=("program", "control") + variants.FAULTS)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.setup_env()
    import torch

    if not torch.cuda.is_available():
        print("control.py reads the card; no CUDA card found", file=sys.stderr)
        return 3
    for seed in args.seeds:
        cell, _, _ = harness.cell_from_files(args.workload, seed, args.seconds, False)
        cell.device, cell.variant = torch.device("cuda", 0), args.variant
        out = harness.run_driver(cell)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "numbers": out.numbers, "metrics": out.metrics,
                          "notes": {k: str(v) for k, v in out.notes.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
