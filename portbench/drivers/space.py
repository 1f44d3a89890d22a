"""Whole gray scenes too large for one card, one at a time, through
``SpatialShardedPredictor`` over the space ranks of several cards: each rank
runs the cascade on its row strip, with halo rows from its neighbours and
the GroupNorm statistics all-reduced over the strips, and space rank 0
gathers the uint8 strips and copies the scene to the host.

This process is space rank 0 on the cell's device; it spawns the other
ranks (``follow``, on the next cards, over NCCL; gloo on the CPU).  Every
rank builds the program's models and takes rank 0's weights.

Traffic keys: ``ranks`` (the space ranks), ``side`` (the scenes' height and
width), ``pool`` (distinct scenes made from the seed, their pixels drawn as
the tiled cell's, served in a seeded order), ``warmup`` (scenes before the
window), ``trace_s`` (the profiled slice, the window's last seconds),
``block`` (the side of an answer: the window's first scene is held to the
reference in blocks of this many output rows and columns), ``seam_rows``
(output rows either side of a seam between two strips whose values make
``seam_share_off``).

The window closes at the first scene returned ``seconds`` after it opened;
``scene_mp_s`` is the output megapixels of the scenes returned in it over
its length.  Then rank 0 stops the other ranks and the reference
(``reference.scene``) runs over the window's first scene on the cards the
ranks held.
"""
from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from portbench import cascade as cs
from portbench import faults, flops, harness, tracing, variants
from portbench.reference import cascade as ref
from portbench.reference import scene as scene_ref

FOLLOW = "portbench.drivers.space:follow"


def _build(cell, mesh):
    """The program's space-sharded predictor on this rank, holding rank 0's
    weights (every rank draws the seed's and takes rank 0's by broadcast)."""
    from srcgan_tpu_torch import parallel
    from srcgan_tpu_torch.serving import SpatialShardedPredictor

    p_sr, p_c = cs.make_weights(cell)
    sr, col = cs.program_models(cell, p_sr, p_c)
    parallel.put_replicated((sr, col), mesh)
    pred = SpatialShardedPredictor(sr, col, cell.config["sr_model"]["up"],
                                   bf16=cell.config["precision"] == "bf16", mesh=mesh,
                                   device=mesh.device)
    return pred, p_sr, p_c


def follow(argv) -> None:
    """A follower rank: rank 0's predictor on this rank's card, serving its
    calls until it stops."""
    from srcgan_tpu_torch import parallel

    spec = argv[0]
    faults.strips(spec["variant"])
    mesh = parallel.make_mesh((spec["traffic"]["ranks"],), ("space",), device=spec["device"])
    cell = harness.Cell(spec["name"], spec["config"], spec["traffic"], {}, spec["seed"], 0.0,
                        False, mesh.device, spec["variant"])
    pred, _, _ = _build(cell, mesh)
    pred.follow()


def run(cell) -> harness.Outcome:
    from srcgan_tpu_torch.parallel import mesh as mesh_lib

    t, dev = cell.traffic, cell.device
    cs.expect(cell.config, cs.BUILT)
    spec = {"name": cell.name, "config": cell.config, "traffic": t, "seed": cell.seed,
            "variant": cell.variant, "device": dev.type}
    faults.strips(cell.variant)
    mesh, followers = mesh_lib.lead(FOLLOW, [spec], t["ranks"], ("space",), dev.type)
    try:
        return _lead(cell, mesh, followers)
    except BaseException:
        followers.kill()
        raise


def _lead(cell, mesh, followers) -> harness.Outcome:
    from srcgan_tpu_torch.parallel import mesh as mesh_lib

    t, dev = cell.traffic, mesh.device
    sr_cfg, c_cfg = cell.config["sr_model"], cell.config["c_model"]
    up, side = sr_cfg["up"], t["side"]
    pred, p_sr, p_c = _build(cell, mesh)
    variants.serving(cell, pred)
    gen = cell.generator("inputs")
    scenes = [torch.randint(0, 256, (side, side, 1), generator=gen, device=dev,
                            dtype=torch.uint8).cpu().numpy() for _ in range(t["pool"])]
    rng = random.Random(harness.derive_seed(cell.seed, "order"))
    order = list(range(t["pool"]))
    rng.shuffle(order)
    tracer = tracing.Tracer(cell.trace, t["trace_s"])
    for k in range(t["warmup"]):
        pred.predict(scenes[order[k % len(order)]][None])
    cs.device_sync(dev)

    scene_flop = flops.cascade_forward(1, side, side, sr_cfg, c_cfg)
    gc.collect()
    setup_s = harness.process_seconds()
    t0 = time.perf_counter()
    end = t0 + cell.seconds
    tracer.open(end)
    k, kept = 0, None
    while True:
        i = order[k % len(order)]
        out = pred.predict(scenes[i][None])[0]
        now = time.perf_counter()
        k += 1
        tracer.tick(now, k)
        if kept is None:
            kept = (i, out)
        if now >= end:
            break
    tracer.stop()
    window = now - t0
    counted_s, counted = tracer.untraced_part(t0, now, k)
    counters = {"window_s": counted_s, "scenes": counted, "model_flop": counted * scene_flop,
                "dtype": cell.config["precision"], "ranks": t["ranks"],
                "scenes_served": t["warmup"] + k}
    peak = cs.memory_peak(dev)
    plan = pred.plan(side)
    seams = [s * up for s, n in zip(plan.starts[1:], plan.heights[1:]) if n]
    pred.stop()
    # leave the mesh, once the stop has gone out, before waiting for the
    # followers: NCCL's teardown waits for every rank, and a program whose
    # ``Followers.join`` waits first hangs
    cs.device_sync(dev)
    mesh_lib.destroy_mesh()
    followers.join()
    del pred, out
    cs.free(dev)

    i, got = kept
    devices = ([torch.device("cuda", r) for r in range(t["ranks"])] if dev.type == "cuda"
               else [dev])
    with ref.exact_fp32():
        want = scene_ref.serve_u8(p_sr, p_c, cell.config, scenes[i], devices)
        if cell.variant == "control":
            got = scene_ref.serve_u8(p_sr, p_c, cell.config, scenes[i], devices, q=ref.FP8)
    numbers, notes = compare_scene(got, want, t["block"], seams, t["seam_rows"])
    notes["window"] = f"{k} scenes in {window:.4f} s; seams at output rows {seams}"
    return harness.Outcome(
        metrics={"scene_mp_s": k * (side * up) ** 2 / 1e6 / window, "setup_s": setup_s},
        attempted=k, failed=0, numbers=numbers, memory_peak_bytes=peak,
        counters=counters, trace=tracer.finish(), notes=notes)


def compare_scene(got: np.ndarray, want: np.ndarray, block: int, seams: list,
                  seam_rows: int) -> tuple:
    """The numbers of a scene's uint8 answer: ``worst_answer_share_off``
    over its ``block`` x ``block`` answers, as ``cascade.compare`` takes it,
    and ``seam_share_off``, the share of values more than ``OFF_LSB`` off
    within ``seam_rows`` output rows of a seam; notes: the blocks' shares
    by row of blocks, the shares by distance to the nearest seam, the mean
    and largest differences."""
    h, w = got.shape[:2]
    off_rows = np.zeros(h, np.int64)
    shares = np.zeros((-(-h // block), -(-w // block)))
    total, big = 0, 0
    for by in range(0, h, block):
        for bx in range(0, w, block):
            d = np.abs(got[by:by + block, bx:bx + block].astype(np.int16)
                       - want[by:by + block, bx:bx + block].astype(np.int16))
            off = d > cs.OFF_LSB
            off_rows[by:by + block] += off.sum(axis=(1, 2))
            shares[by // block, bx // block] = off.mean()
            total += int(d.sum())
            big = max(big, int(d.max()))
    per_row = off_rows / (w * got.shape[2])
    dist = np.full(h, h)
    for s in seams:
        dist = np.minimum(dist, np.abs(np.arange(h) - s + 0.5).astype(np.int64))
    near = dist < seam_rows
    bands = {}
    for lo, hi in ((0, seam_rows), (seam_rows, 128), (128, 512), (512, h + 1)):
        rows = (dist >= lo) & (dist < hi)
        if rows.any():
            bands[f"{lo}-{hi}"] = float(per_row[rows].mean())
    numbers = {"worst_answer_share_off": float(shares.max()),
               "seam_share_off": float(per_row[near].mean()) if near.any() else 0.0}
    notes = {"answers compared": shares.size,
             "share off by block row": [round(float(v), 6) for v in shares.max(axis=1)],
             "share off by rows from a seam": bands, "mean_lsb": total / got.size,
             "max_lsb": big}
    return numbers, notes
