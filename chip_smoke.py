#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (srcgan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; the first failure raises and the script exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every kernel of the serving path from csrc/;
  3. kernels - each kernel's wrapper against its plain PyTorch version at the
               shapes the main path gives it, with both times (CUDA events,
               median of 25 calls after 3 warm-up calls);
  4. fp32    - the full-width cascade on the card against the same cascade on
               the CPU, in fp32 with TF32 off;
  5. serve   - the bf16 CascadePredictor at full width answers requests, every
               forward goes through the tail kernel (launch counter), and the
               steady batch-8 throughput is measured.
Then one JSON line of kernel results, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Weights are random, from fixed seeds.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, LR = 8, 128           # the bench shape: batch 8 of 128x128 gray, x4
NF = 64
# The colorizer's last conv is scaled so the random cascade's output spans
# [0, 1] (std ~0.2) instead of saturating: uint8 checks then see the values.
PRED_SCALE = 0.03
WARMUP, REPS = 3, 25         # calls per timing: warm-up, then the median of REPS


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def median_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def tail_inputs(gen, ou, dev):
    """Trunk output and tail weights at the bench shape, kaiming-scaled."""
    t0 = torch.randn(BATCH, LR, LR, NF, generator=gen).to(dev, torch.bfloat16)
    d1, d2 = (torch.randn(NF, NF, 2, 2, generator=gen) * (2 / (4 * NF)) ** 0.5
              for _ in range(2))
    lw = torch.randn(ou, NF, 3, 3, generator=gen) * (2 / (9 * ou)) ** 0.5
    lb = torch.randn(ou, generator=gen) * 0.1
    return t0, d1.to(dev), d2.to(dev), lw.to(dev), lb.to(dev)


def phase_kernels(dev, card: str) -> dict:
    from srcgan_tpu_torch.ops import fused
    from srcgan_tpu_torch.ops.kernels import tail_kernel

    gen = torch.Generator().manual_seed(0)
    result = None
    for ou in (1, 3):
        t0, d1, d2, lw, lb = tail_inputs(gen, ou, dev)
        tw = tail_kernel.prepare(d1, d2, lw)
        got = tail_kernel.tail_x4_fused(t0, tw, lb)
        ref = tail_kernel.tail_x4_reference(t0, d1, d2, lw, lb)
        torch.cuda.synchronize()
        check(got.shape == ref.shape == (BATCH, 4 * LR, 4 * LR, ou),
              f"tail_x4 shape {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        bound = 0.02 * max(scale, 1.0)
        print(f"[kernels] tail_x4 ou={ou}: max|kernel - plain| = {err:.6g} "
              f"(bound 0.02*max(max|ref|,1) = {bound:.6g}) "
              f"{'PASS' if err <= bound else 'FAIL'}")
        check(err <= bound, f"tail_x4 ou={ou} disagrees with its plain version")

        ms = median_ms(lambda: tail_kernel.tail_x4_fused(t0, tw, lb))
        plain_ms = median_ms(lambda: tail_kernel.tail_x4_reference(t0, d1, d2, lw, lb))
        t0m = t0.reshape(-1, NF)
        k_ms = median_ms(lambda: tail_kernel._zall_kernel(t0m, tw, 0.2))
        kp_ms = median_ms(lambda: tail_kernel.zall_reference(t0m, tw))
        dws = [d.permute(2, 3, 0, 1) for d in (d1, d2)]
        lw_hwio = lw.permute(2, 3, 1, 0)
        wf = fused.fold_last_weight(fused.tail_phases(2), lw_hwio, 4, NF, torch.bfloat16)
        fold_ms = median_ms(lambda: fused.phasefold_deconv_tail(t0, dws, lw_hwio, lb, wf=wf))
        flop = 4 * 2 * (NF * NF + NF * 4 * NF + 4 * NF * 144 * ou) * t0m.shape[0]
        print(f"[kernels] tail_x4 ou={ou} on {card}: wrapper {ms:.4f} ms, plain "
              f"version {plain_ms:.4f} ms; kernel alone {k_ms:.4f} ms "
              f"({flop / k_ms / 1e9:.1f} TFLOP/s), its plain zall {kp_ms:.4f} ms; "
              f"bf16 phase-folded tail (cuDNN) {fold_ms:.4f} ms")
        if ou == 1:
            result = {"name": "tail_x4", "route": "cuda",
                      "source": "srcgan_tpu_torch/csrc/tail_x4.cu",
                      "replaces": "srcgan_tpu/ops/pallas/tail_kernel.py:66",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return result


def cascade(gen):
    """Full-width RDDBNet(1,1,4) (nf=64, nb=3, gc=32) and ResDeconv(1,3), GN."""
    from srcgan_tpu_torch import models

    sr = models.RDDBNet(1, 1, 4, generator=gen)
    c = models.ResDeconv(1, 3, generator=gen)
    with torch.no_grad():
        c.pred.weight.mul_(PRED_SCALE)
    return sr, c


def phase_fp32(dev, sr, c):
    from srcgan_tpu_torch.serving import CascadePredictor

    x = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 1), dtype=np.uint8)
    on_cpu = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device="cpu")
    on_card = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device=dev)
    a, b = on_cpu.predict(x).astype(int), on_card.predict(x).astype(int)
    diff = np.abs(a - b).max()
    print(f"[fp32] card vs CPU, (2,32,32,1) uint8: max|diff| = {diff} (bound 1) "
          f"{'PASS' if diff <= 1 else 'FAIL'}")
    check(diff <= 1, "fp32 cascade on the card disagrees with the CPU")
    return x, b


def phase_serve(dev, card, sr, c, x_small, fp32_small) -> int:
    from srcgan_tpu_torch.ops.kernels import tail_kernel
    from srcgan_tpu_torch.serving import CascadePredictor

    pred = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True,
                            pad_batch_to=BATCH, device=dev)
    rng = np.random.default_rng(2)
    gray = rng.integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8)
    rgb = rng.integers(0, 256, (BATCH, LR, LR, 3), dtype=np.uint8)
    stream_in = [rng.integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8)
                 for _ in range(3)]

    tail_kernel.launches = 0
    y = pred.predict(gray)
    y3 = pred.predict(gray[:3])             # ragged: padded to 8 with the last row
    yrgb = pred.predict(rgb)
    ys = list(pred.predict_stream(iter(stream_in), lookahead=2))
    launches = tail_kernel.launches
    forwards = 6
    print(f"[serve] {forwards} forwards, tail_x4 launches {launches}")
    check(launches == forwards, "a bf16 forward did not go through the tail kernel once")

    full = (BATCH, 4 * LR, 4 * LR, 3)
    check(y.shape == full and y.dtype == np.uint8, f"output {y.shape} {y.dtype}")
    check(y3.shape == (3,) + full[1:] and yrgb.shape == full, "ragged / RGB shapes")
    check(len(np.unique(y)) > 1 and len(np.unique(yrgb)) > 1, "constant output")
    d3 = np.abs(y3.astype(int) - y[:3].astype(int)).max()
    check(d3 <= 1, f"padded batch rows differ from the unpadded ones by {d3}")
    for b, s in zip(stream_in, ys):
        check(np.array_equal(s, pred.predict(b)), "predict_stream differs from predict")
    small = pred.predict(x_small).astype(int)
    bf_diff = np.abs(small - fp32_small).mean()
    # the port's bf16-vs-fp32 mean on the CPU for these weights is 1.04 LSB
    print(f"[serve] bf16 vs fp32 on the card, (2,32,32,1): mean|diff| = {bf_diff:.4f} "
          f"LSB (bound 2) {'PASS' if bf_diff <= 2 else 'FAIL'}")
    check(bf_diff <= 2, "bf16 output strays from fp32")
    print("[serve] shapes, dtype, non-constant output, padding and stream: PASS")

    x = torch.from_numpy(gray).to(dev)
    before = tail_kernel.launches
    ms = median_ms(lambda: pred._run(x))
    xin = (x.float() / 255).permute(0, 3, 1, 2).to(torch.bfloat16,
                                                   memory_format=torch.channels_last)
    with torch.no_grad():
        sr_ms = median_ms(lambda: pred.sr_model(xin))
    check(tail_kernel.launches - before == 2 * (WARMUP + REPS),
          "a timed forward missed the tail kernel")
    mp = BATCH * (4 * LR) ** 2 / 1e6
    print(f"[serve] steady batch-8 128^2 -> 512^2 bf16 on {card}: cascade "
          f"{ms:.3f} ms = {mp / ms * 1e3:.2f} MP/s; RDDBNet x4 alone {sr_ms:.3f} ms "
          f"= {mp / sr_ms * 1e3:.2f} MP/s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs "
              "only on an NVIDIA card", file=sys.stderr)
        return 1
    from srcgan_tpu_torch.ops.kernels import build

    dev = torch.device("cuda:0")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {card}; nvidia-smi name, power.limit: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    path, seconds, log = build.build("tail_x4")
    print(f"[build] {path.name}: nvcc {seconds:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    kernel = phase_kernels(dev, f"{card} ({smi})")
    sr, c = cascade(torch.Generator().manual_seed(1))
    x_small, fp32_small = phase_fp32(dev, sr, c)
    kernel["launches"] = phase_serve(dev, f"{card} ({smi})", sr, c, x_small, fp32_small)

    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
