"""What each choice of probe_stage1's kernel buys, timed on the card.

    python -m srcgan_tpu_torch.probes stage1 [--rounds 3]

``probe_stage1`` launches ``csrc/probes.cu``'s stage kernel after a launch
that writes w's K-major image in halves: a block holds one half of w's
columns for all its tiles and stages, a tile's rows with their halo load
once, two warpgroups split each stage's k steps, and every warp computes the
y[0,0] chain itself.  Both forms are the same function: "shifted" reads A
into registers by ldmatrix at the taps' shifted rows, "im2col" rebuilds a 64
x 576 tile every stage as the TPU kernel does.  The choices are compile-time
switches of the source, so this builds every variant (one nvcc each, all
started together), holds each variant that computes the stages against the
plain version at M = 16384, strides 16 and 128 (rel-L2 <= 1e-3, three calls
bit-equal), and then times them all in turns (forwards, backwards, ...): a
CUDA graph of 4 whole calls of 4 stages, µs a call.

The variants, against the design that ships: the stage kernel launched after w's image is
written, where the design that ships lets it start under that launch and wait
only where it copies the image (``PROBES_PDL=0``) | PR 5's design, the ``mma.sync`` dots_kernel with
its transpose launch (``PROBES_STAGE1=0``).  Then builds with work left out
(``PROBES_STAGE1_LEAVE_OUT``; their results are wrong, only their times mean
something): the products; the operands (the im2col tile's rebuild, the
ldmatrix loads and their perturbations); both.  Last, the timeline build
(``PROBES_STAGE1_TIMELINE=1``): SM cycles of block 0 from its start to each
phase (w landed; per tile: halo landed, the products of each stage but the
last done, all its products done, the sums stored), per warpgroup, also with the products and
the operands left out.  No CPU mode: the variants
exist only as CUDA kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.probes import common

M, STEPS, STRIDES = 16384, 4, (128, 16)
# (label, the switches of csrc/probes.cu); the first is the default build, the
# one the wrapper launches
VARIANTS = (
    ("ships (the default build)", ()),
    ("no early launch", ("PROBES_PDL=0",)),
    ("PR 5 design (PROBES_STAGE1=0)", ("PROBES_STAGE1=0",)),
)
LEAVE_OUT = (("products left out", ("PROBES_STAGE1_LEAVE_OUT=1",)),
             ("operands left out", ("PROBES_STAGE1_LEAVE_OUT=2",)),
             ("both left out", ("PROBES_STAGE1_LEAVE_OUT=3",)))
TIMELINE = ("PROBES_STAGE1_TIMELINE=1",)
# the same with the products and the operands left out: what else a tile costs
TIMELINE_BARE = ("PROBES_STAGE1_TIMELINE=1", "PROBES_STAGE1_LEAVE_OUT=3")
NOTES = 2 + 4 * 7              # csrc/probes.cu kS1Notes: notes a warpgroup


def timeline(lib: ctypes.CDLL, steps: int = STEPS) -> list:
    """The notes of the last call of a timeline build, as rows (warpgroup,
    phase, SM cycles since warpgroup 0 started its tiles)."""
    notes = (ctypes.c_longlong * (2 * NOTES))()
    err = lib.probes_stage1_timeline(notes)
    if err:
        raise RuntimeError(f"probes_stage1_timeline: {lib.probes_error_string(err).decode()}")
    # 7 notes a tile (csrc/probes.cu kS1Notes); the last stage's is never
    # taken (its products end with the tile's), so it reads 0 and is skipped
    names = ["w landed"] + [f"tile {t}: {what}" for t in range(4) for what in
                            ["halo landed"] + [f"stage {s} done" for s in range(steps)]
                            + ["products done", "sums stored"]]
    rows, start = [], notes[0]            # both warpgroups from warpgroup 0's start (one SM's clock)
    for wg in range(2):
        for i, name in enumerate(names, 1):
            value = notes[wg * NOTES + i]
            if value:
                rows.append((wg, name, value - start))
    return rows


def main(argv=None) -> list:
    from srcgan_tpu_torch.ops.kernels import build, probe_kernels as pk

    p = argparse.ArgumentParser(prog="python -m srcgan_tpu_torch.probes stage1",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card to run on (an error without one; there is no CPU mode)")
    p.add_argument("--rounds", type=int, default=3, help="timing rounds, in turns (default 3)")
    args = p.parse_args(argv)
    dev = config.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the stage1 ablation times CUDA kernels built for sm_90a on an NVIDIA "
                           "card (an H100); it has no CPU mode")
    print(f"# probe_stage1 ablation, {STEPS} stages a call, M={M}, on {common.card_line(dev)}")
    switches = [d for _, d in VARIANTS + LEAVE_OUT] + [TIMELINE, TIMELINE_BARE]
    with ThreadPoolExecutor(len(switches)) as pool:
        built = list(pool.map(lambda d: build.build("probes", d), switches))
    for defines, (path, seconds, _) in zip(switches, built):
        print(f"# built {path.name} in {seconds:.1f} s [{' '.join(defines) or 'default'}]")
    libs = {d: pk.declare(build.load("probes", d)) for d in switches}

    rng = np.random.default_rng(17)
    x = common.operand(rng, (M, 64), torch.bfloat16, dev)
    w = common.operand(rng, (576, 192), torch.bfloat16, dev)
    count = dict(pk.launches)
    for stride in STRIDES:
        with config.precision("fp32"):
            ref = pk.probe_stage1_reference(x, w, STEPS, stride)
        for label, defines in VARIANTS + (("timeline build", TIMELINE),):
            for form in pk.STAGE1_FORMS:
                got = [pk.stage1(libs[defines], x, w, STEPS, stride, form) for _ in range(3)]
                torch.cuda.synchronize()
                rel = ((got[0].double() - ref.double()).norm() / ref.double().norm()).item()
                same = all(torch.equal(g, got[0]) for g in got[1:])
                print(f"# stride {stride}, {form}, {label}: rel-L2 against the plain version "
                      f"{rel:.3g} (bound 1e-3), three calls bit-equal {same}")
                if rel > 1e-3 or not same:
                    raise RuntimeError(f"stage1 variant {defines} disagrees with the plain version "
                                       f"({form}, stride {stride})")

    ops = STEPS * 2 * M * 576 * 192
    bound = ops / common.PEAK_OPS["bf16"] * 1e6
    run = [(f"{label}, {form}", d, form) for label, d in VARIANTS + LEAVE_OUT
           for form in pk.STAGE1_FORMS]
    times = {label: [] for label, _, _ in run}
    order = list(run)
    for _ in range(args.rounds):
        for label, defines, form in order:
            fn = lambda d=defines, f=form: pk.stage1(libs[d], x, w, STEPS, 128, f)
            times[label].append(common.graph_ms([fn] * 4) * 1e3)
        order.reverse()
    print(f"probe_stage1 ({M},64) w (576,192), stride 128: bound {bound:.2f} us by operations")
    print(f"  {'variant':<48} {'us a call (min-max)':>24} {'of the bound':>13}")
    rows = []
    for label, defines, form in run:
        t = times[label]
        med = statistics.median(t)
        print(f"  {label:<48} {f'{med:.2f} ({min(t):.2f}-{max(t):.2f})':>24} {bound / med:>12.0%}")
        rows.append({"variant": label, "switches": list(defines), "form": form, "us": med,
                     "rounds": t, "bound_us": bound})
    for form in pk.STAGE1_FORMS:
        fn = lambda f=form: pk.stage1(libs[()], x, w, STEPS, 128, f)
        image, stages = (common.device_us(fn, name) for name in ("s1_image_kernel", "stage1_kernel"))
        print(f"device us a call, {form}: w's image {image}, the stages {stages} (profiler)")
        rows.append({"device_us": form, "image": image, "stages": stages})
    for build, what in ((TIMELINE, ""), (TIMELINE_BARE, ", products and operands left out")):
        for form in pk.STAGE1_FORMS:
            pk.stage1(libs[build], x, w, STEPS, 128, form)
            torch.cuda.synchronize()
            print(f"timeline of block 0, {form}{what}, stride 128: SM cycles since its start")
            for wg, name, cycles in timeline(libs[build]):
                print(f"  warpgroup {wg}  {name:<28} {cycles:>9}")
                rows.append({"timeline": form + what, "warpgroup": wg, "phase": name,
                             "cycles": cycles})
    pk.launches.update(count)           # none of these calls is the main path's
    return rows


if __name__ == "__main__":
    main()
