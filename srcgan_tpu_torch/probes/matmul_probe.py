"""One (M,K) @ (K,N) dot fed from device memory, bf16 and int8: the sweep of
the JAX package's ``scripts/pallas_matmul_probe.py``.

A 3x3 convolution written as tap matmuls has the depth K = taps * Cin: 64 (a
loop over taps), 192 (three taps stacked) or 576 (full im2col).  M is one
128 x 128 plane.  Each line gives the hand-written kernel's time and rate and
beside it the library call's (``torch.matmul``; ``torch._int_mm`` for int8,
whose output is int32).  The operands rotate over copies larger than the L2
cache together, so every launch reads its x from device memory.
"""
from __future__ import annotations

import numpy as np
import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.ops.kernels import probe_kernels as pk
from srcgan_tpu_torch.probes import common

M = 16384                      # one 128 x 128 plane
DEPTHS, WIDTHS = (64, 192, 576), (64, 128, 192)
DTYPES = ((torch.bfloat16, "bf16"), (torch.int8, "int8"))


def copies(m: int, k: int, n: int, element_size: int = 1) -> int:
    """Copies of x a shape rotates over: enough that x and the outputs of all
    of them exceed twice the L2 (between 2 and 64).  ``common.graph_ms`` calls
    the kernel three times a copy (two warm-ups, one capture)."""
    moved = (m * k + m * n) * element_size
    return max(2, min(64, -(-2 * common.L2_BYTES // moved)))


def main(argv=None) -> list:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = config.resolve_device(args.device)
    on_card = dev.type == "cuda"
    m = M if on_card else common.CPU_ROWS
    print(f"matmul probe on {common.card_line(dev)}")
    rng = np.random.default_rng(0)
    rows = []
    for dtype, name in DTYPES:
        unit = "TOP/s" if name == "int8" else "TFLOP/s"
        for k in DEPTHS:
            for n in WIDTHS:
                x = common.operand(rng, (m, k), dtype, dev)
                w = common.operand(rng, (k, n), dtype, dev)
                if not on_card:
                    out = pk.probe_matmul(x, w)
                    print(f"{name} M={m} K={k:4d} N={n:4d}: plain version, out "
                          f"{tuple(out.shape)} {out.dtype}")
                    continue
                xs = [x.clone() for _ in range(copies(m, k, n, x.element_size()))]
                before = pk.launches["probe_matmul"]
                ms = common.graph_ms([lambda v=v: pk.probe_matmul(v, w) for v in xs])
                lib = torch._int_mm if name == "int8" else torch.matmul
                lib_ms = common.graph_ms([lambda v=v: lib(v, w) for v in xs])
                ops = 2 * m * k * n
                print(f"{name} M={m} K={k:4d} N={n:4d}: {ms * 1e3:8.1f} us  "
                      f"{common.rate(ops, ms):7.1f} {unit}   library {lib_ms * 1e3:8.1f} us  "
                      f"{common.rate(ops, lib_ms):7.1f} {unit}")
                rows.append({"dtype": name, "M": m, "K": k, "N": n, "ms": ms,
                             "library_ms": lib_ms,
                             "launches": pk.launches["probe_matmul"] - before})
    return rows


if __name__ == "__main__":
    main()
