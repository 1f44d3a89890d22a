"""Layout probes for a whole-RDB5 kernel design: the four parts of the JAX
package's ``scripts/pallas_layout_probe3.py``.

  A. dot rates at the shallow K a tap decomposition implies (K = 32 .. 576),
     16 dependent dots per launch on a resident tile;
  B. tap-pair stacking: [a, a/2] as one K=128 dot against two K=64 dots;
  C. the cost of a roll along rows (the tap shift) by 1 and by 128, beside
     ``torch.roll``;
  D. a stage-1 candidate: nine shifted views and one K=576 dot, with the
     views gathered in shared memory (im2col) or read shifted.

    python -m srcgan_tpu_torch.probes layout [abcd]
"""
from __future__ import annotations

import numpy as np
import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.ops.kernels import probe_kernels as pk
from srcgan_tpu_torch.probes import common

M = 16384                      # one 128 x 128 plane
DOT_SHAPES = ((32, 192), (64, 192), (64, 64), (128, 192), (128, 128), (576, 192))
DOT_STEPS, PAIR_STEPS, ROLL_STEPS, STAGE_STEPS = 16, 8, 16, 4
BF16 = torch.bfloat16


def probe_dots(dev, m: int) -> list:
    rng = np.random.default_rng(0)
    print(f"A. bf16 dot rates on a resident tile, M={m} ({DOT_STEPS} dependent dots per launch)")
    rows = []
    for k, n in DOT_SHAPES:
        x, w = common.operand(rng, (m, k), BF16, dev), common.operand(rng, (k, n), BF16, dev)
        if dev.type != "cuda":
            print(f"  K={k:4d} N={n:4d}: plain version, out {tuple(pk.probe_dots(x, w).shape)}")
            continue
        ms = common.graph_ms([lambda: pk.probe_dots(x, w, DOT_STEPS)] * 4) / DOT_STEPS
        print(f"  K={k:4d} N={n:4d}: {ms * 1e3:7.2f} us/dot "
              f"{common.rate(2 * m * k * n, ms):6.1f} TFLOP/s")
        rows.append({"part": "a", "K": k, "N": n, "ms_per_dot": ms})
    return rows


def probe_concat_dot(dev, m: int, n: int = 192) -> list:
    rng = np.random.default_rng(1)
    a, w = common.operand(rng, (m, 64), BF16, dev), common.operand(rng, (128, n), BF16, dev)
    print(f"B. tap-pair stacking, M={m} N={n} ({PAIR_STEPS} dependent pairs per launch)")
    rows = []
    for label, form in (("concat+K128 dot", "concat"), ("two K=64 dots", "twodots")):
        if dev.type != "cuda":
            out = pk.probe_concat_dot(a, w, PAIR_STEPS, form)
            print(f"  {label:18s}: plain version, out {tuple(out.shape)}")
            continue
        ms = common.graph_ms([lambda: pk.probe_concat_dot(a, w, PAIR_STEPS, form)] * 4) / PAIR_STEPS
        print(f"  {label:18s}: {ms * 1e3:7.2f} us  {common.rate(2 * m * 128 * n, ms):6.1f} TFLOP/s")
        rows.append({"part": "b", "form": form, "ms_per_step": ms})
    return rows


def probe_roll(dev, m: int, c: int = 64) -> list:
    rng = np.random.default_rng(2)
    a = common.operand(rng, (m, c), BF16, dev)
    print(f"C. roll along rows of ({m},{c}) bf16 ({ROLL_STEPS} dependent rolls per launch)")
    rows = []
    for shift in (1, 128):
        if dev.type != "cuda":
            print(f"  roll {shift:4d}: plain version, out {tuple(pk.probe_roll(a, shift).shape)}")
            continue
        ms = common.graph_ms([lambda: pk.probe_roll(a, shift, ROLL_STEPS)] * 4) / ROLL_STEPS
        lib_ms = common.graph_ms([lambda: torch.roll(a, shift, dims=0)] * 16)
        nbytes = m * c * 2
        print(f"  roll {shift:4d}: {ms * 1e3:7.2f} us  {nbytes / ms / 1e6:6.0f} GB/s   "
              f"one torch.roll {lib_ms * 1e3:7.2f} us  {nbytes / lib_ms / 1e6:6.0f} GB/s")
        rows.append({"part": "c", "shift": shift, "ms_per_roll": ms, "library_ms": lib_ms})
    return rows


def probe_stage1(dev, m: int, stride: int = 128) -> list:
    rng = np.random.default_rng(3)
    x, w = common.operand(rng, (m, 64), BF16, dev), common.operand(rng, (576, 192), BF16, dev)
    print(f"D. stage-1 candidate (nine shifted views + K=576 dot), M={m} "
          f"({STAGE_STEPS} dependent stages per launch)")
    rows = []
    for label, form in (("im2col+dot", "im2col"), ("shifted reads", "shifted")):
        if dev.type != "cuda":
            out = pk.probe_stage1(x, w, STAGE_STEPS, stride, form)
            print(f"  {label:14s}: plain version, out {tuple(out.shape)}")
            continue
        ms = common.graph_ms([lambda: pk.probe_stage1(x, w, STAGE_STEPS, stride, form)] * 4)
        ms /= STAGE_STEPS
        print(f"  {label:14s}: {ms * 1e3:7.2f} us  "
              f"{common.rate(2 * m * 576 * 192, ms):6.1f} TFLOP/s")
        rows.append({"part": "d", "form": form, "ms_per_stage": ms})
    return rows


PARTS = {"a": probe_dots, "b": probe_concat_dot, "c": probe_roll, "d": probe_stage1}


def main(argv=None) -> list:
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("which", nargs="?", default="abcd", help="the parts to run, e.g. 'ad'")
    args = p.parse_args(argv)
    if not args.which or set(args.which) - set(PARTS):
        p.error(f"parts are letters of 'abcd', got {args.which!r}")
    dev = config.resolve_device(args.device)
    m = M if dev.type == "cuda" else common.CPU_ROWS
    print(f"layout probes on {common.card_line(dev)}")
    rows = []
    for letter in "abcd":
        if letter in args.which:
            rows += PARTS[letter](dev, m)
    return rows


if __name__ == "__main__":
    main()
