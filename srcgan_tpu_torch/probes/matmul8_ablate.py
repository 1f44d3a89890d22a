"""What each choice of probe_matmul's int8 kernel buys, timed on the card.

    python -m srcgan_tpu_torch.probes matmul8 [--rounds 3]

``probe_matmul`` on int8 operands launches ``csrc/probes.cu``'s s8 ``wgmma``
GEMM after a launch that writes w's K-major image (8-bit operands have no
transpose bit): a block of two warpgroups takes 128 rows, every chunk of 128
k of x (a TMA box) and of the image resident, all loaded at the start.  The
choices are compile-time switches of the source, so this builds every
variant (one nvcc each, all started together), holds each variant that
computes the dot bit-equal to the plain version at every shape of the
matmul sweep, and then times them all in turns (forwards, backwards, ...),
x rotating over copies that exceed the L2 as the sweep has it (every launch
reads its x from HBM): µs a call, beside ``torch._int_mm`` (int32 out).

The variants, against the design that ships: every block transposing w
into its shared memory itself, one launch a call
(``PROBES_MM8_IMAGE=0``) | the GEMM launched after the image is written,
where the design that ships lets it start under that launch and wait only
where it copies the image (``PROBES_PDL=0``) | PR 5's design, the ``mma.sync`` dots_kernel with
its transpose launch (``PROBES_MM8=0``) | the products left out
(``PROBES_MM_PRODUCTS=0``: loads, the image and the stores; the result is
wrong).  Last, the timeline build (``PROBES_MM8_TIMELINE=1``): SM cycles of
block 0 from its start to each chunk landing, the products and the stores,
at K=576, N=192.  No CPU mode: the variants exist only as CUDA kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.probes import common, matmul_probe

HBM_BYTES_PER_S = 3.35e12
# (label, the switches of csrc/probes.cu, whether it computes the dot); the
# first is the default build, the one the wrapper launches
VARIANTS = (
    ("ships (the default build)", (), True),
    ("w transposed by every block", ("PROBES_MM8_IMAGE=0",), True),
    ("no early launch", ("PROBES_PDL=0",), True),
    ("PR 5 design (PROBES_MM8=0)", ("PROBES_MM8=0",), True),
    ("products left out", ("PROBES_MM_PRODUCTS=0",), False),
)
TIMELINE = ("PROBES_MM8_TIMELINE=1",)
NOTES = ["chunk 0 landed", "chunk 1 landed", "chunk 2 landed", "chunk 3 landed",
         "chunk 4 landed", "products done", "stored"]


def main(argv=None) -> list:
    from srcgan_tpu_torch.ops.kernels import build, probe_kernels as pk

    p = argparse.ArgumentParser(prog="python -m srcgan_tpu_torch.probes matmul8",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card to run on (an error without one; there is no CPU mode)")
    p.add_argument("--rounds", type=int, default=3, help="timing rounds, in turns (default 3)")
    args = p.parse_args(argv)
    dev = config.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the matmul8 ablation times CUDA kernels built for sm_90a on an NVIDIA "
                           "card (an H100); it has no CPU mode")
    print(f"# probe_matmul int8 ablation on {common.card_line(dev)}")
    switches = [d for _, d, _ in VARIANTS] + [TIMELINE]
    with ThreadPoolExecutor(len(switches)) as pool:
        built = list(pool.map(lambda d: build.build("probes", d), switches))
    for defines, (path, seconds, _) in zip(switches, built):
        print(f"# built {path.name} in {seconds:.1f} s [{' '.join(defines) or 'default'}]")
    libs = {d: pk.declare(build.load("probes", d)) for d in switches}

    rng = np.random.default_rng(19)
    m = matmul_probe.M
    count = dict(pk.launches)
    rows = []
    print(f"  {'K':>4} {'N':>4} {'variant':<32} {'us a call (min-max)':>24} {'bound':>7} "
          f"{'launches':>8}")
    for k in matmul_probe.DEPTHS:
        for n in matmul_probe.WIDTHS:
            x = common.operand(rng, (m, k), torch.int8, dev)
            w = common.operand(rng, (k, n), torch.int8, dev)
            ref = pk.probe_matmul_reference(x, w)
            for label, defines, computes in VARIANTS:
                if computes:
                    bad = int((pk.matmul_int8(libs[defines], x, w) != ref).sum())
                    if bad:
                        raise RuntimeError(f"matmul8 variant {defines} differs from the plain "
                                           f"version in {bad} elements at K={k} N={n}")
            xs = [x.clone() for _ in range(matmul_probe.copies(m, k, n))]
            calls = {label: [lambda v=v, d=defines: pk.matmul_int8(libs[d], v, w) for v in xs]
                     for label, defines, _ in VARIANTS}
            calls["torch._int_mm (int32 out)"] = [lambda v=v: torch._int_mm(v, w) for v in xs]
            times = {label: [] for label in calls}
            order = list(calls)
            for _ in range(args.rounds):
                for label in order:
                    times[label].append(common.graph_ms(calls[label]) * 1e3)
                order.reverse()
            bound = (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e6
            ships = lambda: pk.matmul_int8(libs[()], x, w)
            image, gemm = (common.device_us(ships, name)
                           for name in ("s8_image_kernel", "matmul8_kernel"))
            print(f"  {k:>4} {n:>4} device us a call of the design that ships, x in L2: w's image "
                  f"{image}, the GEMM {gemm} (profiler)")
            for label, t in times.items():
                med = statistics.median(t)
                print(f"  {k:>4} {n:>4} {label:<32} {f'{med:.2f} ({min(t):.2f}-{max(t):.2f})':>24} "
                      f"{bound:>7.3f} {3 * len(xs):>8}")
                rows.append({"K": k, "N": n, "variant": label, "us": med, "rounds": t,
                             "bound_us": bound, "sweep_launches": 3 * len(xs)})
            del xs
    # one block's phases at the deepest, widest shape, x from HBM
    k, n = matmul_probe.DEPTHS[-1], matmul_probe.WIDTHS[-1]
    x = common.operand(rng, (m, k), torch.int8, dev)
    w = common.operand(rng, (k, n), torch.int8, dev)
    xs = [x.clone() for _ in range(matmul_probe.copies(m, k, n))]
    for v in xs:
        pk.matmul_int8(libs[TIMELINE], v, w)
    torch.cuda.synchronize()
    notes = (ctypes.c_longlong * 16)()
    err = libs[TIMELINE].probes_matmul8_timeline(notes)
    if err:
        raise RuntimeError(f"probes_matmul8_timeline: {libs[TIMELINE].probes_error_string(err).decode()}")
    print(f"timeline of block 0 at K={k} N={n}, the last of {len(xs)} calls: SM cycles since "
          f"warpgroup 0 started")
    for wg in range(2):
        for i, name in enumerate(NOTES, 1):
            if notes[8 * wg + i]:
                print(f"  warpgroup {wg}  {name:<16} {notes[8 * wg + i] - notes[0]:>8}")
                rows.append({"timeline": f"K={k} N={n}", "warpgroup": wg, "phase": name,
                             "cycles": notes[8 * wg + i] - notes[0]})
    pk.launches.update(count)           # none of these calls is the main path's
    return rows


if __name__ == "__main__":
    main()
