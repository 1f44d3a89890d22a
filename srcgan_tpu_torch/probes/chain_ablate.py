"""What each choice of the dependent-dot chain kernel buys, timed on the card.

    python -m srcgan_tpu_torch.probes chain [--rounds 3]

``probe_mxu`` (bf16 and int8) and ``probe_dots`` launch the chain kernel of
``csrc/probes.cu``: w resident in shared memory, loaded once; two
warpgroups over a tile of 64 rows, splitting its k steps or (bf16 at K <=
128) its columns; bf16 A in registers, int8 A (x and clip(x + 1)) in shared
memory; every warp computing the y[0,0] chain itself.  Its choices are compile-time switches of the
source, so this builds every variant (one nvcc each, all started together;
``ops/kernels/build.py`` keys its cache by the switches), holds each
variant that computes the chain against the plain version at each probe's
table shape (int8 bit-equal, on operands whose chain takes both; bf16 rel-L2
<= 1e-3), and only then times them all, in turns (forwards, backwards, ...):
a CUDA graph of 4 whole calls of 16 dots, µs a call.

The variants that compute the chain, against the design that ships:

  one block an SM at K <= 128 (``PROBES_CHAIN_BLOCKS=1``: ptxas may use more
  registers, and a block walks over two tiles, where the design that ships
  holds two blocks of one tile) | A double-buffered in the column split
  (``PROBES_CHAIN_DB=1``: two sets of A registers in turn and a master copy,
  so that the next dot's operand is made while the dot runs), alone and with
  one block an SM | the other split of a tile between the
  warpgroups: by k steps where the design that ships splits the columns
  (bf16 at K <= 128, N >= 128), by columns where it splits K, each
  warpgroup then holding all of K's A in registers
  (``PROBES_CHAIN_SPLIT=0`` / ``=1``) | A in shared memory beside w, each
  warpgroup rewriting its own k columns between dots behind its own barrier
  (only where x fits beside w: not at K=576, N=192) | int8 w transposed by
  every block itself, one launch a call, where the design that ships writes
  w's K-major image once by a launch of its own and every block copies it
  chunk by chunk (``PROBES_CHAIN_S8_IMAGE=0``) | the first design, the
  ``mma.sync`` dots_kernel with its transpose launch (``PROBES_CHAIN=0``)

The splits and A in shared memory change the bf16 form only.  Then builds with work left
out (``PROBES_CHAIN_LEAVE_OUT``; their results are wrong, only their times
mean something): the products; the dots too (the operands' loads, the
exchange and the stores); the loads as well (the start, the exchange and the
stores).  There is no CPU mode: the variants exist only as CUDA kernels.
"""
from __future__ import annotations

import argparse
import statistics
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.probes import common

STEPS = 16
# (probe, M, K, N, type): the two probes' table shapes, and K=576 at N=128,
# where x still fits beside w
SHAPES = (("probe_mxu", 8320, 576, 192, torch.bfloat16),
          ("probe_mxu", 8320, 576, 128, torch.bfloat16),
          ("probe_mxu", 8320, 576, 192, torch.int8),
          ("probe_dots", 16384, 64, 192, torch.bfloat16))
# (label, the switches of csrc/probes.cu, whether it changes the int8 form);
# the first is the default build, the one the wrappers launch
VARIANTS = (
    ("ships (the default build)", (), True),
    ("one block an SM", ("PROBES_CHAIN_BLOCKS=1",), True),
    ("A double-buffered", ("PROBES_CHAIN_DB=1",), False),
    ("A double-buffered, one block an SM", ("PROBES_CHAIN_DB=1", "PROBES_CHAIN_BLOCKS=1"), False),
    ("K split (the tile's k steps)", ("PROBES_CHAIN_SPLIT=0",), False),
    ("N split (the tile's columns)", ("PROBES_CHAIN_SPLIT=1",), False),
    ("bf16 A in shared memory", ("PROBES_CHAIN_A_SMEM=1",), False),
    ("int8 w transposed by every block", ("PROBES_CHAIN_S8_IMAGE=0",), True),
    ("first design (PROBES_CHAIN=0)", ("PROBES_CHAIN=0",), True),
)
LEAVE_OUT = (("products left out", ("PROBES_CHAIN_LEAVE_OUT=1",), True),
             ("dots left out", ("PROBES_CHAIN_LEAVE_OUT=2",), True),
             ("operand loads left out too", ("PROBES_CHAIN_LEAVE_OUT=3",), True))


def takes(defines: tuple, m: int, k: int, n: int, dtype: torch.dtype) -> bool:
    """Whether a variant's build runs the shape (differently from the design
    that ships): one block an SM changes K <= 128 only, double-buffered A
    the column split only, a split the shapes
    the design that ships splits the other way; A in shared memory
    needs x (64 rows x K bf16, in chunks of 64 k) beside all of w in a
    block's shared memory, and K a depth class."""
    from srcgan_tpu_torch.ops.kernels import probe_kernels as pk

    plan = pk.chain_plan(m, k, n, dtype)
    if "PROBES_CHAIN_DB=1" in defines:
        return plan["split"] == "N"
    if "PROBES_CHAIN_S8_IMAGE=0" in defines:
        return dtype == torch.int8
    if "PROBES_CHAIN_BLOCKS=1" in defines:
        return plan["k_class"] <= 128
    for split in ("K", "N"):
        if f"PROBES_CHAIN_SPLIT={'KN'.index(split)}" in defines:
            return dtype == torch.bfloat16 and plan["split"] != split
    if "PROBES_CHAIN_A_SMEM=1" in defines and dtype == torch.bfloat16:
        chunks = -(-k // 64)                    # its sums exchanged in the operands' bytes
        return (k == plan["k_class"] and
                1024 + chunks * (n * 128 + 8192) + 8 * chunks <= pk.SMEM_PER_BLOCK)
    return True


def main(argv=None) -> list:
    from srcgan_tpu_torch.ops.kernels import build, probe_kernels as pk

    p = argparse.ArgumentParser(prog="python -m srcgan_tpu_torch.probes chain",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card to run on (an error without one; there is no CPU mode)")
    p.add_argument("--rounds", type=int, default=3, help="timing rounds, in turns (default 3)")
    args = p.parse_args(argv)
    dev = config.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the chain ablation times CUDA kernels built for sm_90a on an NVIDIA "
                           "card (an H100); it has no CPU mode")
    print(f"# chain ablation, {STEPS} dots a call, on {common.card_line(dev)}")
    switches = [v[1] for v in VARIANTS + LEAVE_OUT]
    with ThreadPoolExecutor(len(switches)) as pool:
        built = list(pool.map(lambda d: build.build("probes", d), switches))
    for defines, (path, seconds, _) in zip(switches, built):
        print(f"# built {path.name} in {seconds:.1f} s [{' '.join(defines) or 'default'}]")
    libs = {d: pk.declare(build.load("probes", d)) for d in switches}

    rng = np.random.default_rng(13)
    count = dict(pk.launches)
    rows = []
    for name, m, k, n, dtype in SHAPES:
        x, w = common.operand(rng, (m, k), dtype, dev), common.operand(rng, (k, n), dtype, dev)
        if dtype == torch.int8:
            common.alternate_int8(x, w)         # the chain takes both operands
        tname = "int8" if dtype == torch.int8 else "bf16"
        shape = f"{name} {tname} ({m},{k})@({k},{n})"
        with config.precision("fp32"):
            ref = pk.probe_mxu_reference(x, w, STEPS)
        run = [(label, d) for label, d, s8 in VARIANTS + LEAVE_OUT
               if (s8 or dtype == torch.bfloat16) and takes(d, m, k, n, dtype)]
        for label, defines, _ in VARIANTS:
            if (label, defines) not in run:
                print(f"# {shape}, {label}: not run (the variant does not take this shape or type)")
                continue
            got = pk.chain(libs[defines], name, x, w, STEPS)
            torch.cuda.synchronize()
            if dtype == torch.int8:
                bad = int((got != ref).sum())
                print(f"# {shape}, {label}: {bad} elements differ from the plain version (bound 0)")
                ok = bad == 0
            else:
                rel = ((got.double() - ref.double()).norm() / ref.double().norm()).item()
                print(f"# {shape}, {label}: rel-L2 against the plain version {rel:.3g} (bound 1e-3)")
                ok = rel <= 1e-3
            if not ok:
                raise RuntimeError(f"chain variant {defines} disagrees with the plain version at {shape}")

        ops = STEPS * 2 * m * k * n
        peak = common.PEAK_OPS["int8" if dtype == torch.int8 else "bf16"]
        times = {label: [] for label, _ in run}
        order = list(run)
        for _ in range(args.rounds):
            for label, defines in order:
                fn = lambda d=defines: pk.chain(libs[d], name, x, w, STEPS)
                times[label].append(common.graph_ms([fn] * 4) * 1e3)
            order.reverse()
        print(f"{shape}: bound {ops / peak * 1e6:.2f} us by operations")
        print(f"  {'variant':<38} {'us a call (min-max)':>24} {'of the bound':>13}")
        for label, defines in run:
            t = times[label]
            med = statistics.median(t)
            print(f"  {label:<38} {f'{med:.2f} ({min(t):.2f}-{max(t):.2f})':>24} "
                  f"{ops / peak * 1e6 / med:>12.0%}")
            rows.append({"shape": shape, "variant": label, "switches": list(defines),
                         "us": med, "rounds": t, "bound_us": ops / peak * 1e6})
    pk.launches.update(count)           # none of these calls is the main path's
    return rows


if __name__ == "__main__":
    main()
