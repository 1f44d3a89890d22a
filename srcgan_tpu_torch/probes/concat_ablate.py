"""What each choice of probe_concat_dot's kernel buys, timed on the card.

    python -m srcgan_tpu_torch.probes concat [--rounds 3]

``probe_concat_dot`` (8 dependent steps of [a, a/2] @ w128, a (16384, 64),
w128 (128, 192), as one K=128 dot "concat" or two K=64 dots "twodots") runs
on ``csrc/probes.cu``'s chain kernel as two more of its forms: w128 resident,
A in registers (a's fragments and their halves), the warpgroups splitting the
columns, every warp computing the y[0,0] chain.  Its choices are
compile-time switches of the source, so this builds every variant (one nvcc
each, all started together), holds each variant that computes the function
against the plain version in both forms (rel-L2 <= 1e-3, three calls
bit-equal), and then times them all in turns (forwards, backwards, ...): a
CUDA graph of 4 whole calls of 8 steps, µs a call.

The variants, against the design that ships: "twodots" summing each dot
into an accumulator set of its own and adding the two after
wgmma.wait_group, as the JAX kernel does, where the design that ships runs
both dots into the running sums, the instruction stream of "concat"
(``PROBES_CONCAT_SETS=2``: one block an SM, for its 3 x 64 sums) | one
block an SM, each walking over tiles with w128 resident, so that a tile's
stores overlap the next one's loads and products (``PROBES_CONCAT_WALK=1``)
| the first design, the ``mma.sync`` dots_kernel with its transpose launch
(``PROBES_CONCAT=0``).  Then builds with work left out
(``PROBES_CHAIN_LEAVE_OUT``; their results are wrong, only their times mean
something): the wgmmas; the dots (the operands' loads, w's copy and the
stores remain).  Last, the chain kernel's device µs a call (profiler).  No
CPU mode: the variants exist only as CUDA kernels.
"""
from __future__ import annotations

import argparse
import statistics
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.probes import common

M, N, STEPS = 16384, 192, 8
# (label, the switches of csrc/probes.cu); the first is the default build, the
# one the wrapper launches
VARIANTS = (
    ("ships (the default build)", ()),
    ("twodots in two accumulator sets", ("PROBES_CONCAT_SETS=2",)),
    ("one block an SM, walking tiles", ("PROBES_CONCAT_WALK=1",)),
    ("first design (PROBES_CONCAT=0)", ("PROBES_CONCAT=0",)),
)
LEAVE_OUT = (("wgmmas left out", ("PROBES_CHAIN_LEAVE_OUT=1",)),
             ("dots left out", ("PROBES_CHAIN_LEAVE_OUT=2",)))


def main(argv=None) -> list:
    from srcgan_tpu_torch.ops.kernels import build, probe_kernels as pk

    p = argparse.ArgumentParser(prog="python -m srcgan_tpu_torch.probes concat",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card to run on (an error without one; there is no CPU mode)")
    p.add_argument("--rounds", type=int, default=3, help="timing rounds, in turns (default 3)")
    args = p.parse_args(argv)
    dev = config.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the concat ablation times CUDA kernels built for sm_90a on an NVIDIA "
                           "card (an H100); it has no CPU mode")
    print(f"# probe_concat_dot ablation, {STEPS} steps a call, M={M}, N={N}, on "
          f"{common.card_line(dev)}")
    switches = [d for _, d in VARIANTS + LEAVE_OUT]
    with ThreadPoolExecutor(len(switches)) as pool:
        built = list(pool.map(lambda d: build.build("probes", d), switches))
    for defines, (path, seconds, _) in zip(switches, built):
        print(f"# built {path.name} in {seconds:.1f} s [{' '.join(defines) or 'default'}]")
    libs = {d: pk.declare(build.load("probes", d)) for d in switches}

    rng = np.random.default_rng(1)
    a = common.operand(rng, (M, 64), torch.bfloat16, dev)
    w = common.operand(rng, (128, N), torch.bfloat16, dev)
    with config.precision("fp32"):
        refs = {form: pk.probe_concat_dot_reference(a, w, STEPS, form) for form in pk.CONCAT_FORMS}
    outs = {}
    for label, defines in VARIANTS:
        for form in pk.CONCAT_FORMS:
            got = [pk.concat(libs[defines], a, w, STEPS, form) for _ in range(3)]
            torch.cuda.synchronize()
            ref = refs[form].double()
            rel = ((got[0].double() - ref).norm() / ref.norm()).item()
            same = all(torch.equal(g, got[0]) for g in got[1:])
            outs[label, form] = got[0]
            print(f"# {form}, {label}: rel-L2 against the plain version {rel:.3g} (bound 1e-3), "
                  f"three calls bit-equal {same}")
            if rel > 1e-3 or not same:
                raise RuntimeError(f"concat variant {defines} disagrees with the plain version "
                                   f"({form})")
    for label, _ in VARIANTS:
        print(f"# {label}: concat and twodots bit-equal "
              f"{torch.equal(outs[label, 'concat'], outs[label, 'twodots'])}")

    ops = STEPS * 2 * M * 128 * N
    bound = ops / common.PEAK_OPS["bf16"] * 1e6
    run = [(f"{label}, {form}", d, form) for label, d in VARIANTS + LEAVE_OUT
           for form in pk.CONCAT_FORMS]
    times = {label: [] for label, _, _ in run}
    order = list(run)
    for _ in range(args.rounds):
        for label, defines, form in order:
            fn = lambda d=defines, f=form: pk.concat(libs[d], a, w, STEPS, f)
            times[label].append(common.graph_ms([fn] * 4) * 1e3)
        order.reverse()
    print(f"probe_concat_dot ({M},64) w ({128},{N}), {STEPS} steps: bound {bound:.2f} us by "
          f"operations (half of its rate at {bound * 2:.2f} us)")
    print(f"  {'variant':<52} {'us a call (min-max)':>24} {'of the bound':>13}")
    rows = []
    for label, defines, form in run:
        t = times[label]
        med = statistics.median(t)
        print(f"  {label:<52} {f'{med:.2f} ({min(t):.2f}-{max(t):.2f})':>24} {bound / med:>12.0%}")
        rows.append({"variant": label, "switches": list(defines), "form": form, "us": med,
                     "rounds": t, "bound_us": bound})
    for form in pk.CONCAT_FORMS:
        us = common.device_us(lambda f=form: pk.concat(libs[()], a, w, STEPS, f), "chain_kernel")
        print(f"device us a call, {form}: the chain kernel {us} (profiler)")
        rows.append({"device_us": form, "chain_kernel": us})
    return rows


if __name__ == "__main__":
    main()
