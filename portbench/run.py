"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload x4_stream_b8 --seed 7 --seconds 30 --trace 0

Prints one JSON line (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with --trace 1 ``breakdown``, and ``check``, the numbers that
decide ``correct`` beside their limits) as the last line of its output.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.setup_env()
    sys.exit(harness.main(sys.argv[1:]))
