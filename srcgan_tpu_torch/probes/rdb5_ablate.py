"""What each step of the RDB5 kernel's design bought, timed on the card.

    python -m srcgan_tpu_torch.probes rdb5 [--rounds 3]

``csrc/rdb5.cu`` keeps parts of its earlier design behind compile-time
switches.  This builds every variant (one nvcc each, all started together;
``ops/kernels/build.py`` keys its cache by the switches), holds each against
the plain version at the serving shape (8,128,128,64) in both forms (int8: no
element may differ; bf16: rel-L2 <= 2e-2) and only then times it: a CUDA
graph of four launches replayed between events, the variants in turns
(forwards, backwards, ...) so that a drift of the card or the host cannot
favour one, beside the cuDNN block (the nn.Module in bf16) as yardstick.

The variants, from the first port's design to the one that ships:

  weights read from L2 by every warp | staged once per block (bulk copies)
  A fragments as four 32-bit reads   | one ldmatrix.x4
  mma.sync                           | wgmma (A from registers)

One tile shape was built, 16x16 outputs with a 5-pixel halo: the others were
ruled out by their bytes and their recompute factor before building (PERF.md).

Then where a tile's time goes: builds of the shipped design that note the
clock at the end of every phase of one block of a late wave (x's load, each
stage's products and epilogue, the barriers), whole and with the products,
the loads of the A fragments, or both left out (those results are wrong; only
their times mean something).  Cycles of the SM's clock, one block, one launch.
There is no CPU mode: the variants exist only as CUDA kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
from concurrent.futures import ThreadPoolExecutor

import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.probes import common

SHAPE = (8, 128, 128, 64)
FLOP = 2 * 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64) * SHAPE[0] * SHAPE[1] * SHAPE[2]
# (label, the switches of csrc/rdb5.cu); the last one is the default build
VARIANTS = (
    ("L2 weights, scalar A, mma.sync", ("RDB5_WGMMA=0", "RDB5_WEIGHTS_L2=1", "RDB5_SCALAR_A=1")),
    ("staged weights, scalar A, mma.sync", ("RDB5_WGMMA=0", "RDB5_SCALAR_A=1")),
    ("L2 weights, ldmatrix, mma.sync", ("RDB5_WGMMA=0", "RDB5_WEIGHTS_L2=1")),
    ("staged weights, ldmatrix, mma.sync", ("RDB5_WGMMA=0",)),
    ("staged weights, ldmatrix, wgmma (ships)", ()),
)
# the shipped design with the clock noted per phase: whole, and with work left out
TIMELINES = (
    ("as shipped", ("RDB5_TIMELINE=1",)),
    ("no A fragment loads", ("RDB5_TIMELINE=1", "RDB5_LEAVE_OUT=2")),
    ("no products", ("RDB5_TIMELINE=1", "RDB5_LEAVE_OUT=1")),
    ("neither", ("RDB5_TIMELINE=1", "RDB5_LEAVE_OUT=3")),
)
PHASES = 3 + 3 * 5             # csrc/rdb5.cu kPhases: clock notes per warpgroup


@functools.lru_cache(maxsize=None)
def variant(defines: tuple) -> ctypes.CDLL:
    """csrc/rdb5.cu built with the switches ``defines``, its C signatures declared."""
    from srcgan_tpu_torch.ops.kernels import build, rdb5_kernel

    lib = rdb5_kernel._declare(build.load("rdb5", defines))
    if "RDB5_TIMELINE=1" in defines:
        lib.rdb5_timeline.argtypes = [ctypes.c_void_p]
        lib.rdb5_timeline.restype = ctypes.c_int
    return lib


def launch_variant(x, weights, quant: bool, defines: tuple):
    """One block through the variant ``defines``: x and weights as the wrappers
    of ``ops.kernels.rdb5_kernel`` take them, the same checks, no launch counted."""
    from srcgan_tpu_torch.ops.kernels import rdb5_kernel

    return rdb5_kernel._run(variant(defines), x, weights, quant, 0.2, 0.2)


def timeline(defines: tuple):
    """Clock cycles per phase of one block of the last launch of the
    ``RDB5_TIMELINE=1`` build ``defines``, per warpgroup: {"x load": ...,
    "products 1": ..., "epilogue 1": ..., "barriers": ...}.  Waits for the card."""
    lib = variant(defines)
    notes = (ctypes.c_longlong * (2 * PHASES))()
    err = lib.rdb5_timeline(ctypes.addressof(notes))
    if err:
        raise RuntimeError(f"rdb5 timeline: {lib.rdb5_error_string(err).decode()}")
    out = []
    for wg in range(2):
        t = list(notes[wg * PHASES:(wg + 1) * PHASES])
        row = {"x load": t[1] - t[0], "barriers": t[2] - t[1]}
        for i in range(5):
            row[f"products {i + 1}"] = t[3 + 3 * i] - t[2 + 3 * i]
            row[f"epilogue {i + 1}"] = t[4 + 3 * i] - t[3 + 3 * i]
            if i < 4:
                row["barriers"] += t[5 + 3 * i] - t[4 + 3 * i]
        row["total"] = t[16] - t[0]
        out.append(row)
    return out


def _block(dev, gen):
    """A ResidualDenseBlock5 at the kernel's widths with kaiming weights and
    non-zero biases (the border rule only shows with them)."""
    from srcgan_tpu_torch.models.blocks import ResidualDenseBlock5

    blk = ResidualDenseBlock5(64, 32).eval().requires_grad_(False)
    with torch.no_grad():
        for w, b in blk.convs():
            w.normal_(0, (2 / (9 * w.shape[0])) ** 0.5, generator=gen)
            b.normal_(0, 0.1, generator=gen)
    return blk.to(dev, memory_format=torch.channels_last)


def main(argv=None) -> list:
    from srcgan_tpu_torch.models.blocks import rdb5_schedule
    from srcgan_tpu_torch.ops.kernels import build, rdb5_kernel as rk

    p = argparse.ArgumentParser(prog="python -m srcgan_tpu_torch.probes rdb5",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card to run on (an error without one; there is no CPU mode)")
    p.add_argument("--rounds", type=int, default=3, help="timing rounds, in turns (default 3)")
    args = p.parse_args(argv)
    dev = config.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the RDB5 ablation times CUDA kernels built for sm_90a on an NVIDIA "
                           "card (an H100); it has no CPU mode")
    print(f"# rdb5 ablation at {SHAPE} on {common.card_line(dev)}")
    with ThreadPoolExecutor(len(VARIANTS) + len(TIMELINES)) as pool:
        built = list(pool.map(lambda v: build.build("rdb5", v[1]), VARIANTS + TIMELINES))
    for (label, defines), (path, seconds, _) in zip(VARIANTS + TIMELINES, built):
        print(f"# built {path.name} in {seconds:.1f} s: {label} [{' '.join(defines) or 'default'}]")

    gen = torch.Generator().manual_seed(9)
    blk = _block(dev, gen)
    x = (torch.rand(SHAPE, generator=gen) * 2 - 0.5).to(dev)
    xb = x.bfloat16()
    with torch.no_grad(), config.precision("fp32"):
        _, cat = blk.forward_with_sources(x.permute(0, 3, 1, 2))
    wb, w8 = rk.prep_bf16(blk.convs()), rk.prep_int8(blk.convs(), cat.abs().amax(dim=(0, 2, 3)))
    ref16, ref8 = rk.rdb5_bf16_reference(xb, wb).float(), rk.rdb5_int8_reference(x, w8)
    forms = {"bf16": (xb, wb, False), "int8": (x, w8, True)}

    def launch(form, defines):
        return launch_variant(*forms[form], defines)

    for label, defines in VARIANTS:
        got16, got8 = launch("bf16", defines).float(), launch("int8", defines)
        torch.cuda.synchronize()
        rel = ((got16 - ref16).norm() / ref16.norm()).item()
        bad = int((got8 != ref8).sum())
        print(f"# {label}: bf16 rel-L2 vs plain {rel:.3g} (bound 2e-2), int8 {bad} of "
              f"{got8.numel()} elements differ (bound 0)")
        if not rel <= 2e-2 or bad:
            raise RuntimeError(f"rdb5 variant {defines} disagrees with the plain version")

    cudnn = _block(dev, gen)
    cudnn.load_state_dict(blk.state_dict())
    cudnn.to(dev, torch.bfloat16, memory_format=torch.channels_last)
    xn = xb.permute(0, 3, 1, 2)
    times = {(label, form): [] for label, _ in VARIANTS for form in forms}
    times[("the cuDNN block (nn.Module)", "bf16")] = []
    order = list(VARIANTS)
    for _ in range(args.rounds):
        for label, defines in order:
            for form in forms:
                times[(label, form)].append(
                    common.graph_ms([lambda f=form, d=defines: launch(f, d)] * 4))
        # "naive" keeps the module on cuDNN: unscoped, an eval bf16 block on the
        # card goes through the kernel that ships
        count = rk.launches_bf16
        with torch.no_grad(), rdb5_schedule("naive"):
            times[("the cuDNN block (nn.Module)", "bf16")].append(common.graph_ms([lambda: cudnn(xn)] * 4))
        if rk.launches_bf16 != count:
            raise RuntimeError("the cuDNN yardstick went through the rdb5 kernel")
        order.reverse()
    rows = []
    print(f"{'variant':<42} {'form':<5} {'median ms':>10} {'min':>8} {'max':>8} {'T(FL)OP/s':>10}")
    for (label, form), ts in times.items():
        med = statistics.median(ts)
        rows.append({"variant": label, "form": form, "ms": med, "min_ms": min(ts), "max_ms": max(ts)})
        print(f"{label:<42} {form:<5} {med:>10.4f} {min(ts):>8.4f} {max(ts):>8.4f} "
              f"{common.rate(FLOP, med):>10.1f}")
    print(f"# where a tile's time goes: SM clock cycles per phase of one block (warpgroup 0), "
          f"{SHAPE}; products = a stage's loop over sources, taps and k-steps")
    for form in forms:
        for label, defines in TIMELINES:
            launch(form, defines)
            line = timeline(defines)[0]
            rows.append({"variant": f"timeline, {label}", "form": form, "cycles": line})
            stages = " ".join(f"{line[f'products {i}']}+{line[f'epilogue {i}']}" for i in range(1, 6))
            print(f"{form} {label:<20} total {line['total']:>7}: x load {line['x load']:>6}, stages "
                  f"(products+epilogue) {stages}, barriers {line['barriers']}")
    return rows


if __name__ == "__main__":
    main()
