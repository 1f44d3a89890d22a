"""What each layout of probe_roll's kernel buys, timed on the card.

    python -m srcgan_tpu_torch.probes roll [--rounds 3]

``probe_roll`` runs 16 dependent rolls of a (16384, 64) bf16 along rows,
each followed by + bf16(1e-8), in one launch of ``csrc/probes.cu``'s roll
kernel: a column of pieces of every row (16 or 4 bytes) lives in the
shared memory of a cluster of blocks for all the steps, each block owning a
range of rows, the rows it reads from another block read from that block's
buffer after a cluster barrier, and no barrier falls across the grid
(``probe_kernels.roll_plan``).  The layout is an argument of the launch, so
one build holds them all.  This builds the default build and the first design
(``PROBES_ROLL=0``: a cooperative launch, a grid-wide barrier between steps)
together, holds every layout bit-equal to the plain version at shifts 0, 1,
128 and M - 1 (three calls bit-equal), prints how many clusters of each the
card holds at once, and then times every layout and the first design in turns
(forwards, backwards, ...) at shifts 1 and 128: a CUDA graph of 4 whole
calls, µs a call of 16 rolls, beside two bounds (the 4 MB the function moves
once through HBM; 16 passes of 4 MB through the shared memory of the SMs the
layout holds, 128 bytes a cycle at the card's highest SM clock); then, for
each, the µs of 1, 2, 16 and 48 rolls a call and what each roll past the
16th adds: the steps are run, not composed, and the split of a call between
its fixed part and its steps.  No CPU mode: the kernels exist only on the
card.
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

M, C, STEPS, SHIFTS = 16384, 64, 16, (1, 128)
# (label, cluster, piece bytes), probe_kernels.ROLL_LAYOUTS; the first is the
# layout roll_plan picks
LAYOUTS = (("16 B pieces, cluster of 8", 8, 16), ("16 B pieces, cluster of 16", 16, 16),
           ("4 B pieces, one block a column", 1, 4))
FIRST_DESIGN = ("PROBES_ROLL=0",)


def max_clusters(lib: ctypes.CDLL, cluster: int, piece: int) -> str:
    """The clusters of a layout the card holds at once, as text."""
    n = ctypes.c_int(0)
    err = lib.probes_roll_max_clusters(M, C, cluster, piece, ctypes.byref(n))
    return str(n.value) if err == 0 else lib.probes_error_string(err).decode()


def main(argv=None) -> list:
    from srcgan_tpu_torch.ops.kernels import build, probe_kernels as pk

    p = argparse.ArgumentParser(prog="python -m srcgan_tpu_torch.probes roll",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card to run on (an error without one; there is no CPU mode)")
    p.add_argument("--rounds", type=int, default=3, help="timing rounds, in turns (default 3)")
    args = p.parse_args(argv)
    dev = config.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the roll ablation times CUDA kernels built for sm_90a on an NVIDIA "
                           "card (an H100); it has no CPU mode")
    card = common.card_line(dev)
    mhz = common.max_sm_clock_mhz(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"# probe_roll ablation, {STEPS} rolls a call of ({M},{C}) bf16, on {card}, "
          f"{sms} SMs, highest SM clock {mhz} MHz")
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(lambda d: build.build("probes", d), [(), FIRST_DESIGN]))
    for defines, (path, seconds, _) in zip([(), FIRST_DESIGN], built):
        print(f"# built {path.name} in {seconds:.1f} s [{' '.join(defines) or 'default'}]")
    lib, first = pk._library(), pk.declare(build.load("probes", FIRST_DESIGN))

    a = common.operand(np.random.default_rng(2), (M, C), torch.bfloat16, dev)
    a[0, :3] = torch.tensor([0.0, 1e-8, -1e-8], device=dev).bfloat16()   # where the add shows
    plans = {label: pk.roll_plan(M, C, 1, cluster, piece) for label, cluster, piece in LAYOUTS}
    for shift in (0, 1, 128, M - 1):
        ref = pk.probe_roll_reference(a, shift, STEPS).view(torch.int16)
        for label, *_ in LAYOUTS:
            got = [pk.roll(lib, a, shift, STEPS, plans[label]) for _ in range(3)]
            torch.cuda.synchronize()
            bad = int((got[0].view(torch.int16) != ref).sum())
            same = all(torch.equal(g, got[0]) for g in got[1:])
            print(f"# shift {shift}, {label}: {bad} of {ref.numel()} elements differ from the "
                  f"plain version, three calls bit-equal {same}")
            if bad or not same:
                raise RuntimeError(f"probe_roll layout {label} disagrees at shift {shift}")
        old = pk.roll(first, a, shift, STEPS)
        torch.cuda.synchronize()
        if not torch.equal(old.view(torch.int16), ref):
            raise RuntimeError(f"the first probe_roll disagrees at shift {shift}")
    for label, cluster, piece in LAYOUTS:
        plan = plans[label]
        print(f"# {label}: {plan['blocks']} blocks of {plan['rows_per_block']} rows, "
              f"{plan['smem_bytes']} bytes of shared memory a block; clusters held at once "
              f"{max_clusters(lib, cluster, piece)} of {plan['piece_columns']}")

    nbytes = 2 * M * C * 2
    bound = nbytes / common.HBM_BYTES_PER_S * 1e6
    calls = {}
    for shift in SHIFTS:
        for label, *_ in LAYOUTS:
            calls[f"{label}, shift {shift}"] = (
                lambda s=shift, pl=plans[label]: pk.roll(lib, a, s, STEPS, pl))
        calls[f"first design, shift {shift}"] = lambda s=shift: pk.roll(first, a, s, STEPS)
    times = {key: [] for key in calls}
    order = list(calls)
    for _ in range(args.rounds):
        for key in order:
            times[key].append(common.graph_ms([calls[key]] * 4) * 1e3)
        order.reverse()
    print(f"probe_roll ({M},{C}) bf16, {STEPS} rolls a call: byte bound {bound:.3f} us (4 MB once)")
    print(f"  {'layout':<52} {'us a call (min-max)':>22} {'16 passes bound':>16}"
          f" {'us a roll past 16':>18}")
    rows = []
    for shift in SHIFTS:
        for label, cluster, piece in LAYOUTS + (("first design", 0, 0),):
            key = f"{label}, shift {shift}"
            t = times[key]
            med = statistics.median(t)
            if cluster:
                plan = plans[label]
                passes = STEPS * nbytes / (min(plan["blocks"], sms) * 128 * mhz * 1e6) * 1e6
                fn = lambda b, s=shift, pl=plan: pk.roll(lib, a, s, b, pl)
            else:
                passes = None
                fn = lambda b, s=shift: pk.roll(first, a, s, b)
            t1, t2, t16, t48 = (common.graph_ms([lambda b=b: fn(b)] * 4) * 1e3
                                for b in (1, 2, STEPS, 3 * STEPS))
            per = (t48 - t16) / (2 * STEPS)
            print(f"    one roll {t1:.2f} us, two {t2:.2f}, 16 {t16:.2f}, 48 {t48:.2f}")
            shown = "-" if passes is None else f"{passes:.3f}"
            print(f"  {key:<52} {f'{med:.2f} ({min(t):.2f}-{max(t):.2f})':>22} {shown:>16}"
                  f" {per:>18.3f}")
            rows.append({"layout": label, "shift": shift, "cluster": cluster, "piece_bytes": piece,
                         "us": med, "rounds": t, "bound_us": bound, "passes_bound_us": passes,
                         "us_per_added_roll": per, "us_one_roll": t1, "us_two_rolls": t2})
    return rows


if __name__ == "__main__":
    main()
