"""16 dependent dots on operands that stay on the SM, bf16 and int8: the sweep
of the JAX package's ``scripts/pallas_mxu_probe.py``.

Unlike the matmul probe (one dot fed from device memory, which measures the
memory system as much as the tensor cores), each launch here runs 16 dots
back to back on a tile of x held in shared memory, and every dot's operand
depends on the dot before it, so the time per dot is the matmul engine's.
There is no single PyTorch call that computes this chain.
"""
from __future__ import annotations

import numpy as np
import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.ops.kernels import probe_kernels as pk
from srcgan_tpu_torch.probes import common

M, STEPS = 8320, 16            # 130 tiles of 64 rows; 16 dots back to back
SHAPES = ((576, 128), (576, 192), (192, 128), (288, 128))
DTYPES = ((torch.bfloat16, "bf16"), (torch.int8, "int8"))


def main(argv=None) -> list:
    args = common.parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = config.resolve_device(args.device)
    on_card = dev.type == "cuda"
    m = M if on_card else common.CPU_ROWS
    print(f"mxu probe on {common.card_line(dev)}")
    rng = np.random.default_rng(0)
    rows = []
    for dtype, name in DTYPES:
        unit = "TOP/s" if name == "int8" else "TFLOP/s"
        for k, n in SHAPES:
            x = common.operand(rng, (m, k), dtype, dev)
            w = common.operand(rng, (k, n), dtype, dev)
            if not on_card:
                out = pk.probe_mxu(x, w, STEPS)
                print(f"{name} K={k:4d} N={n:4d}: plain version, M={m}, out "
                      f"{tuple(out.shape)} {out.dtype}")
                continue
            ms = common.graph_ms([lambda: pk.probe_mxu(x, w, STEPS)] * 4) / STEPS
            print(f"{name} K={k:4d} N={n:4d}: {ms * 1e3:7.2f} us/dot  "
                  f"{common.rate(2 * m * k * n, ms):6.1f} {unit}")
            rows.append({"dtype": name, "M": m, "K": k, "N": n, "ms_per_dot": ms})
    return rows


if __name__ == "__main__":
    main()
