"""Whole scenes, one at a time, through ``TiledPredictor.predict_scene``: the
host cuts each into overlapping windows, the card runs them in batches, the
host stitches the cores.

Traffic keys: ``tile``, ``overlap``, ``max_batch`` (the predictor's
settings), ``scenes`` (the [height, width] of each scene: the same set in
every run, replayed in an order drawn from the seed, their pixels made from
the seed), ``check`` (scenes held to the reference: the first ones the
window finishes, and the largest), ``trace_s`` (the profiled slice, the
window's last seconds).

The window closes at the first scene finished ``seconds`` after it opened;
``scene_mp_s`` is the output megapixels of the scenes finished in it over
its length.
"""
from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from portbench import cascade as cs
from portbench import flops, harness, tracing
from portbench.reference import tiles as plan


def run(cell) -> harness.Outcome:
    from srcgan_tpu_torch.serving import TiledPredictor

    t, dev = cell.traffic, cell.device
    sr_cfg, c_cfg = cell.config["sr_model"], cell.config["c_model"]
    up, tile, ov = sr_cfg["up"], t["tile"], t["overlap"]
    p_sr, p_c = cs.make_weights(cell)
    gen = cell.generator("inputs")
    sizes = [tuple(s) for s in t["scenes"]]
    rng = random.Random(harness.derive_seed(cell.seed, "order"))
    rng.shuffle(sizes)
    scenes = [torch.randint(0, 256, (h, w, 1), generator=gen, device=dev,
                            dtype=torch.uint8).cpu().numpy() for h, w in sizes]
    largest = max(range(len(sizes)), key=lambda i: sizes[i][0] * sizes[i][1])
    calibration = [plan.crops(scenes[0], plan.plan(*sizes[0], tile, ov), tile)[:t["max_batch"]]]
    pred = cs.predictor(cell, p_sr, p_c, TiledPredictor, calibration=calibration, tile=tile,
                        overlap=ov, max_batch=t["max_batch"])
    tracer = tracing.Tracer(cell.trace, t["trace_s"])
    smallest = min(range(len(sizes)), key=lambda i: sizes[i][0] * sizes[i][1])
    pred.predict_scene(scenes[smallest])
    cs.device_sync(dev)

    tile_flop = flops.cascade_forward(1, tile, tile, sr_cfg, c_cfg)
    gc.collect()
    setup_s = harness.process_seconds()
    t0 = time.perf_counter()
    end = t0 + cell.seconds
    tracer.open(end)
    k, out_mp, flop, kept = 0, 0.0, 0, {}
    want_kept = t["check"]
    while True:
        i = k % len(scenes)
        canvas = pred.predict_scene(scenes[i])
        now = time.perf_counter()
        k += 1
        h, w = sizes[i]
        out_mp += h * w * up * up / 1e6
        flop += len(plan.plan(h, w, tile, ov)) * tile_flop
        tracer.tick(now, (k, flop))
        if i not in kept and (len(kept) < want_kept or i == largest):
            kept[i] = canvas
        if now >= end:
            break
    tracer.stop()
    window = now - t0
    counted_s, (counted, counted_flop) = tracer.untraced_part(t0, now, (k, flop))
    counters = {"window_s": counted_s, "scenes": counted, "model_flop": counted_flop,
                "dtype": cell.config["precision"]}
    peak = cs.memory_peak(dev)
    del pred
    cs.free(dev)

    answers = []
    for i, canvas in kept.items():
        h, w = sizes[i]
        windows = plan.plan(h, w, tile, ov)
        outs = np.concatenate(cs.reference_u8(cell, p_sr, p_c, [plan.crops(scenes[i], windows,
                                                                           tile)]))
        # each window's core is an answer of its own
        for (ys, xs, ty, tx), ref_tile in zip(plan.cores(windows, up), outs):
            answers.append((canvas[ys, xs], ref_tile[ty, tx]))
    numbers, notes = cs.compare(answers)
    notes["window"] = (f"{k} scenes in {window:.4f} s; scenes held to the reference "
                       f"{sorted(sizes[i] for i in kept)}")
    return harness.Outcome(
        metrics={"scene_mp_s": out_mp / window, "setup_s": setup_s},
        attempted=k, failed=0, numbers=numbers, memory_peak_bytes=peak,
        counters=counters, trace=tracer.finish(), notes=notes)
