"""The benchmark of srcgan_tpu_torch on NVIDIA cards: ``python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line."""
