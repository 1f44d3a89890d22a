"""What each choice of the SSIM kernel's design buys, timed on the card.

    python -m srcgan_tpu_torch.probes ssim [--rounds 3]

``csrc/ssim.cu`` keeps its design's choices and the parts of its main pass
behind compile-time switches.  This builds every variant (one nvcc each, all
started together; ``ops/kernels/build.py`` keys its cache by the switches),
holds each variant that computes SSIM against the plain version at the eval
shape (8,256,256,3) fp32, per-sample range, per-sample means and cs (1e-6,
the wrapper's bound) and only then times them all, in turns (forwards,
backwards, ...): the main pass and the range pass on the device (profiler,
mean of 10 calls) and a CUDA graph of 10 calls (µs a call).

The variants that compute SSIM, against the design that ships (a static ring
of 2 chunks of 11 input rows, 32 output rows a block):

  the dynamic ring, which every C but 1 and 3 takes | a ring of 3 chunks
  16 or 64 output rows a block (the default build on another grid)

Then builds with work left out of the main pass, from the end of its loop
back (their results are wrong; only their times mean something): the maps
and divides; the column pass too; the row pass too, which leaves the
staging of the rows and one read of each.  There is no CPU mode: the
variants exist only as CUDA kernels.
"""
from __future__ import annotations

import argparse
import statistics
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.probes import common

SHAPE = (8, 256, 256, 3)
# (label, the switches of csrc/ssim.cu, output rows a block); the first is the
# default build at the wrapper's TILE rows, the one that ships
VARIANTS = (
    ("ships: static ring, 2 chunks, 32 rows", (), 32),
    ("dynamic ring", ("SSIM_STATIC_RING=0",), 32),
    ("ring of 3 chunks", ("SSIM_SLOTS=3",), 32),
    ("16 rows a block", (), 16),
    ("64 rows a block", (), 64),
)
LEAVE_OUT = (
    ("no maps or divides", ("SSIM_LEAVE_OUT=1",), 32),
    ("no column pass either", ("SSIM_LEAVE_OUT=2",), 32),
    ("no row pass either", ("SSIM_LEAVE_OUT=3",), 32),
)
MODE = dict(size_average=False, full=True, per_sample_range=True)


def inputs(dev, shape=SHAPE):
    """x in [0, 1] and y = x plus noise, clipped, as chip_smoke.py draws them."""
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 1, shape).astype(np.float32)
    noisy = np.clip(base + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return torch.from_numpy(base).to(dev), torch.from_numpy(noisy).to(dev)


def main(argv=None) -> list:
    from srcgan_tpu_torch.ops.kernels import build, ssim_kernel as sk

    p = argparse.ArgumentParser(prog="python -m srcgan_tpu_torch.probes ssim",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card to run on (an error without one; there is no CPU mode)")
    p.add_argument("--rounds", type=int, default=3, help="timing rounds, in turns (default 3)")
    args = p.parse_args(argv)
    dev = config.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the SSIM ablation times CUDA kernels built for sm_90a on an NVIDIA "
                           "card (an H100); it has no CPU mode")
    print(f"# ssim ablation at {SHAPE} fp32, per-sample range, on {common.card_line(dev)}")
    switches = sorted({v[1] for v in VARIANTS + LEAVE_OUT})
    with ThreadPoolExecutor(len(switches)) as pool:
        built = list(pool.map(lambda d: build.build("ssim", d), switches))
    for defines, (path, seconds, _) in zip(switches, built):
        print(f"# built {path.name} in {seconds:.1f} s [{' '.join(defines) or 'default'}]")
    libs = {d: sk._declare(build.load("ssim", d)) for d in switches}

    x, y = inputs(dev)
    dims = sk._check(x, y, 11)
    count = sk.launches

    def call(defines, rows):
        return lambda: sk._kernel(x, y, dims, 11, **MODE, lib=libs[defines], rows=rows)

    with config.precision("fp32"):
        ref = sk.ssim_reference(x, y, **MODE)
    ships = call(*VARIANTS[0][1:])()
    for label, defines, rows in VARIANTS:
        got = call(defines, rows)()
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        same = all(torch.equal(g, s) for g, s in zip(got, ships))
        print(f"# {label}: max|kernel - plain| over SSIM and cs {err:.3g} (bound 1e-6); "
              f"bit-equal to the shipped build: {'yes' if same else 'no'}")
        if not err <= 1e-6:
            raise RuntimeError(f"ssim variant {defines} at {rows} rows disagrees with the plain "
                               f"version")

    timed = VARIANTS + LEAVE_OUT
    times = {label: {"graph_us": [], "main_us": [], "range_us": []} for label, _, _ in timed}
    order = list(timed)
    for _ in range(args.rounds):
        for label, defines, rows in order:
            fn = call(defines, rows)
            times[label]["graph_us"].append(common.graph_ms([fn] * 10) * 1e3)
            times[label]["main_us"].append(common.device_us(fn, "ssim_kernel"))
            times[label]["range_us"].append(common.device_us(fn, "range_kernel"))
        order.reverse()
    sk.launches = count                   # none of these calls is the main path's

    rows_out = []
    fmt = lambda v: "not measured" if v is None else f"{v:.2f}"
    print(f"{'variant':<40} {'main us (min-max)':>22} {'range us':>9} {'graph us/call':>14}")
    for label, defines, rows in timed:
        t = times[label]
        main_us = None if None in t["main_us"] else statistics.median(t["main_us"])
        range_us = None if None in t["range_us"] else statistics.median(t["range_us"])
        graph_us = statistics.median(t["graph_us"])
        spread = ("" if main_us is None else
                  f" ({min(t['main_us']):.2f}-{max(t['main_us']):.2f})")
        print(f"{label:<40} {fmt(main_us) + spread:>22} {fmt(range_us):>9} {graph_us:>14.2f}")
        rows_out.append({"variant": label, "switches": list(defines), "rows": rows,
                         "main_us": main_us, "range_us": range_us, "graph_us": graph_us,
                         "rounds": t})
    return rows_out


if __name__ == "__main__":
    main()
