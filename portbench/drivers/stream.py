"""A closed-loop bulk conversion: an endless stream of equal batches of gray
uint8 tiles through ``CascadePredictor.predict_stream``, results back to the
host.

Traffic keys: ``batch`` and ``side`` (the input tiles), ``lookahead``
(batches in flight), ``pool`` (distinct batches made from the seed and
replayed in a seeded order), ``warmup`` (batches before the window),
``check`` (results kept, by reservoir sampling over the window, and held to
the reference), ``trace_s`` (the profiled slice, the window's last seconds).

The window opens at the first timed batch and closes at the first result
that reaches the host ``seconds`` after it opened; ``serve_mp_s`` is the
output megapixels of every result in it over its length.
"""
from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from portbench import cascade as cs
from portbench import flops, harness, tracing


def run(cell) -> harness.Outcome:
    t, dev = cell.traffic, cell.device
    sr_cfg = cell.config["sr_model"]
    up = sr_cfg["up"]
    p_sr, p_c = cs.make_weights(cell)
    gen = cell.generator("inputs")
    pool = torch.randint(0, 256, (t["pool"], t["batch"], t["side"], t["side"], 1),
                         generator=gen, device=dev, dtype=torch.uint8).cpu().numpy()
    pred = cs.predictor(cell, p_sr, p_c, pad_batch_to=t["batch"], calibration=pool[:2])
    tracer = tracing.Tracer(cell.trace, t["trace_s"])
    if cell.trace:
        cs.hook_spans(tracer.spans, pred)
    for _ in pred.predict_stream(iter(pool[:t["warmup"]]), t["lookahead"]):
        pass
    cs.device_sync(dev)

    rng = random.Random(harness.derive_seed(cell.seed, "order"))
    order = list(range(t["pool"]))
    rng.shuffle(order)
    gc.collect()
    setup_s = harness.process_seconds()
    t0 = time.perf_counter()
    end = t0 + cell.seconds
    tracer.open(end)
    fed = []

    def feed():
        while time.perf_counter() < end:
            k = order[len(fed) % len(order)]
            fed.append(k)
            yield pool[k]

    done, closed_at, kept = 0, None, []
    for out in pred.predict_stream(feed(), t["lookahead"]):
        now = time.perf_counter()
        k = fed[done]
        done += 1
        tracer.tick(now, done)
        if closed_at is None:
            if len(kept) < t["check"]:
                kept.append((k, out))
            elif (j := rng.randrange(done)) < t["check"]:
                kept[j] = (k, out)
            if now >= end:
                closed_at, in_window = now, done
                tracer.stop()
    if closed_at is None:
        closed_at, in_window = time.perf_counter(), done
        tracer.stop()
    window = closed_at - t0
    n, side = t["batch"], t["side"]
    out_mp = in_window * n * (side * up) ** 2 / 1e6
    counted_s, counted = tracer.untraced_part(t0, closed_at, in_window)
    counters = {"window_s": counted_s, "batches": counted,
                "model_flop": counted * flops.cascade_forward(n, side, side, sr_cfg,
                                                                cell.config["c_model"]),
                "dtype": cell.config["precision"]}
    peak = cs.memory_peak(dev)
    tracer.spans.remove()
    del pred
    cs.free(dev)

    distinct = sorted({k for k, _ in kept})
    want = dict(zip(distinct, cs.reference_u8(cell, p_sr, p_c, [pool[k] for k in distinct])))
    answers = [(got[i], want[k][i]) for k, got in kept for i in range(len(got))]
    numbers, notes = cs.compare(answers)
    notes["window"] = f"{in_window} batches in {window:.4f} s, {done} fed in all"
    return harness.Outcome(
        metrics={"serve_mp_s": out_mp / window, "setup_s": setup_s},
        attempted=len(fed), failed=len(fed) - done, numbers=numbers, memory_peak_bytes=peak,
        counters=counters, trace=tracer.finish(), notes=notes)
