#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (srcgan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; the first failure raises and the script exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every kernel (tail_x4, gray_degrade, ssim) from
               csrc/, one process per source, all started together;
  3. kernels - each kernel's wrapper against its plain PyTorch version at the
               shapes the main paths give it, with both times (CUDA events,
               median of 25 calls after 3 warm-up calls) and its bound: the
               least time the card could take, from the bytes the function
               must move and the operations it does;
  4. fp32    - the full-width serving cascade on the card against the same
               cascade on the CPU, in fp32 with TF32 off;
  5. serve   - the bf16 CascadePredictor at full width answers requests, every
               forward goes through the tail kernel (launch counter), and the
               steady batch-8 throughput is measured;
  6. train   - the cascade training step (CasTrainer, RDDBNet x2 + ResDeconv,
               full width): one fp32 uint8 step on the card against the CPU;
               10 bf16 fused-input steps at batch 8, 256^2, each launching
               the gray_degrade kernel once, with both losses falling; a
               K=4 train_steps_u8 call; the step time with fused_input on and
               off; and the eval transfer cascade;
  7. eval    - the evaluation protocol through the command-line tools, at
               full width and depth: a synthetic Sat2Aerx1-layout set of 256^2
               pairs on disk, cli.train_cas for one short epoch (RDDBNet x2 +
               ResDeconv, bf16 activations, 4 steps per dispatch), then
               cli.test_cas on its checkpoints (batch 8, fp32): every eval
               batch launches the ssim kernel once, the PNGs decode, and the
               Performs.csv row agrees with the same tool on the CPU.
Then one JSON line of kernel results, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Weights are random, from fixed seeds.
"""
from __future__ import annotations

import copy
import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BATCH, LR = 8, 128           # the bench shape: batch 8 of 128x128 gray, x4
NF = 64
# The colorizer's last conv is scaled so the random cascade's output spans
# [0, 1] (std ~0.2) instead of saturating: uint8 checks then see the values.
PRED_SCALE = 0.03
WARMUP, REPS = 3, 25         # calls per timing: warm-up, then the median of REPS
KERNELS = ("tail_x4", "gray_degrade", "ssim")
# The card's published peaks (H100 SXM, dense): what a bound is taken against.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
# The training slice: CasTrainer(RDDBNet, ResDeconv, up=2), batch 8 of 256^2 targets.
TRAIN_BATCH, TRAIN_HW, TRAIN_UP, TRAIN_LR = 8, 256, 2, 1e-4
TRAIN_STEPS, TRAIN_K, TRAIN_REPS = 10, 4, 10
# The eval slice: 16 test pairs of 256^2 in batches of 8; 32 training pairs.
EVAL_HW, EVAL_BATCH, EVAL_TEST, EVAL_TRAIN = 256, 8, 16, 32


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def median_ms(fn, reps: int = REPS) -> float:
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(fn, match: str, calls: int = 10):
    """Mean device time in microseconds, per call of ``fn``, of the kernels
    whose name contains ``match`` (torch.profiler over ``calls`` calls); None
    where the profiler reports no device time."""
    from torch import profiler

    fn()
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                if match in e.key)
    return total / calls if total > 0 else None


def least_time(nbytes: float, flop: float, dtype: str) -> dict:
    """The least time the card could take for a function that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``flop`` operations of ``dtype``: the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
        least = least_time(tensor_bytes(t0, d1, d2, lw, lb, got), flop, "bf16")
        print(f"[kernels] tail_x4 ou={ou} on {card}: wrapper {ms:.4f} ms, plain "
              f"version {plain_ms:.4f} ms; kernel alone {k_ms:.4f} ms "
              f"({flop / k_ms / 1e9:.1f} TFLOP/s), its plain zall {kp_ms:.4f} ms; "
              f"bf16 phase-folded tail (cuDNN, a chain of calls) {fold_ms:.4f} ms; "
              f"bound {least['bound_ms']:.4f} ms by {least['bound_by']} "
              f"({flop / 1e9:.1f} GFLOP at the bf16 peak)")
        if ou == 1:
            # no single PyTorch call computes the tail: library_ms is null
            result = {"name": "tail_x4", "route": "cuda",
                      "source": "srcgan_tpu_torch/csrc/tail_x4.cu",
                      "replaces": "srcgan_tpu/ops/pallas/tail_kernel.py:66",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **least,
                      "library_ms": None}
    return result


def phase_gray_degrade(dev, card: str) -> dict:
    """gray_degrade against its plain version at the training shape (up=2),
    at up=4, and at a ragged shape; bound 1e-6 on both outputs, the Pallas
    kernel's own (tests/test_fused.py)."""
    from srcgan_tpu_torch.ops.kernels import preprocess_kernel as pk

    rng = np.random.default_rng(5)
    worst, first = 0.0, None
    for shape, up in (((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3), TRAIN_UP),
                      ((TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3), 4), ((3, 250, 198, 3), 4)):
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        got = pk.fused_gray_degrade(x, up)
        ref = pk.gray_degrade_reference(x, up)
        torch.cuda.synchronize()
        n, h, w, _ = shape
        check(got[0].shape == ref[0].shape == (n, h, w, 1)
              and got[1].shape == ref[1].shape == (n, h // up, w // up, 1),
              f"gray_degrade shapes {got[0].shape} {got[1].shape}")
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        worst = max(worst, err)
        print(f"[kernels] gray_degrade {shape} up={up}: max|kernel - plain| over both "
              f"outputs = {err:.3g} (bound 1e-6) {'PASS' if err <= 1e-6 else 'FAIL'}")
        check(err <= 1e-6, f"gray_degrade {shape} up={up} disagrees with its plain version")
        ms = median_ms(lambda: pk.fused_gray_degrade(x, up))
        plain_ms = median_ms(lambda: pk.gray_degrade_reference(x, up))
        nbytes = tensor_bytes(x, *got)
        # per pixel 3 divides, 3 multiplies, 2 adds; per output two 2-tap stencils
        least = least_time(nbytes, 8 * n * h * w + 6 * n * (h // up) * (w // up), "fp32")
        print(f"[kernels] gray_degrade {shape} up={up} on {card}: kernel {ms:.4f} ms "
              f"({nbytes / 1e6 / ms:.1f} GB/s of {nbytes / 1e6:.2f} MB), plain version "
              f"{plain_ms:.4f} ms; bound {least['bound_ms']:.5f} ms by {least['bound_by']}")
        if first is None:
            first = {"ms": ms, "plain_ms": plain_ms, **least}
    # no single PyTorch call computes luma + degradation: library_ms is null
    return {"name": "gray_degrade", "route": "cuda",
            "source": "srcgan_tpu_torch/csrc/gray_degrade.cu",
            "replaces": "srcgan_tpu/ops/pallas/preprocess_kernel.py:44",
            "max_abs_err": worst, **first, "library_ms": None}


def ssim_flop(n: int, h: int, w: int, c: int, ws: int = 11) -> int:
    """Operations of the separable form: three products per pixel, the row pass
    of five maps over H x (W-ws+1), the column pass over the valid region, and
    about 20 operations of map arithmetic per valid pixel."""
    vh, vw = h - ws + 1, w - ws + 1
    return n * c * (3 * h * w + 5 * (2 * ws - 1) * (h * vw + vh * vw) + 20 * vh * vw)


def phase_ssim(dev, card: str) -> dict:
    """The ssim wrapper against its plain version (the depthwise-conv form,
    fp32 with TF32 off) at the eval shape, at 512^2 and at a ragged shape; in
    [0,1], in [0,255] and with mixed per-sample ranges; every mode of the
    wrapper.  Bound 1e-6 absolute on SSIM and cs, the bound the JAX package
    holds its two forms to on the CPU (they sum 121 taps in different orders;
    1.8e-7 was the most seen on an H100)."""
    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.ops.kernels import ssim_kernel as sk

    modes = [dict(size_average=True), dict(size_average=False),
             dict(size_average=True, full=True),
             dict(size_average=False, per_sample_range=True),
             dict(size_average=False, full=True, per_sample_range=True)]
    rng = np.random.default_rng(8)
    worst, first = 0.0, None
    for shape in ((EVAL_BATCH, EVAL_HW, EVAL_HW, 3), (8, 512, 512, 3), (3, 250, 198, 1)):
        base = rng.uniform(0, 1, shape).astype(np.float32)
        # y is x plus noise, as a prediction is to its target: SSIM near 0.5
        noisy = np.clip(base + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
        mixed = np.where(np.arange(shape[0]).reshape(-1, 1, 1, 1) % 2 == 0, 255.0, 1.0)
        for label, scale in (("[0,1]", 1.0), ("[0,255]", 255.0), ("mixed ranges", mixed)):
            x = torch.from_numpy((base * scale).astype(np.float32)).to(dev)
            y = torch.from_numpy((noisy * scale).astype(np.float32)).to(dev)
            err = 0.0
            for kw in modes:
                before = sk.launches
                got = sk.ssim_fused(x, y, **kw)
                check(sk.launches == before + 1, "ssim_fused did not launch its kernel")
                with config.precision("fp32"):
                    ref = sk.ssim_reference(x, y, **kw)
                torch.cuda.synchronize()
                for g, r in zip(got if kw.get("full") else (got,),
                                ref if kw.get("full") else (ref,)):
                    check(g.shape == r.shape and bool(torch.isfinite(g).all()),
                          f"ssim {shape} {label} {kw}: shape {tuple(g.shape)} or not finite")
                    err = max(err, (g - r).abs().max().item())
            worst = max(worst, err)
            print(f"[kernels] ssim {shape} {label}: max|kernel - plain| over SSIM and cs, "
                  f"{len(modes)} modes = {err:.3g} (bound 1e-6) "
                  f"{'PASS' if err <= 1e-6 else 'FAIL'}")
            check(err <= 1e-6, f"ssim {shape} {label} disagrees with its plain version")
        x = torch.from_numpy(base).to(dev)
        y = torch.from_numpy(noisy).to(dev)
        ms = median_ms(lambda: sk.ssim_fused(x, y, size_average=False, per_sample_range=True))
        with config.precision("fp32"):
            plain_ms = median_ms(lambda: sk.ssim_reference(x, y, size_average=False,
                                                           per_sample_range=True))
        n, h, w, c = shape
        ranges, dims = sk.plane_ranges(x, True), sk._check(x, y, 11)
        kernel_ms = median_ms(lambda: sk._kernel(x, y, ranges, dims, 11))
        on_device = device_us(lambda: sk._kernel(x, y, ranges, dims, 11), "ssim_kernel")
        least = least_time(tensor_bytes(x, y) + 4 * n, ssim_flop(n, h, w, c), "fp32")
        print(f"[kernels] ssim per-sample {shape} on {card}: wrapper {ms:.4f} ms (launch "
              f"and the sum of its partials alone {kernel_ms:.4f} ms; the kernel on the device "
              f"{'not measured' if on_device is None else f'{on_device:.2f} us'}, profiler), plain "
              f"version {plain_ms:.4f} ms; bound {least['bound_ms']:.5f} ms by "
              f"{least['bound_by']} ({tensor_bytes(x, y) / 1e6:.2f} MB, "
              f"{ssim_flop(n, h, w, c) / 1e9:.3f} GFLOP at the fp32 rate)")
        if first is None:
            first = {"ms": ms, "plain_ms": plain_ms, **least}
    small = torch.zeros(1, 8, 32, 3, device=dev)
    try:
        sk.ssim_fused(small, small)
    except ValueError:
        pass
    else:
        raise SmokeFailure("ssim accepted a plane smaller than its window")
    # five depthwise convolutions and the maps are a chain: library_ms is null
    return {"name": "ssim", "route": "cuda", "source": "srcgan_tpu_torch/csrc/ssim.cu",
            "replaces": "srcgan_tpu/ops/pallas/ssim_kernel.py:76",
            "max_abs_err": worst, **first, "library_ms": None}


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


def slice_trainer(dev, **kw):
    """The training slice at full width: RDDBNet(1,1,2) nf=64, nb=3, gc=32 and
    ResDeconv(1,3) with GroupNorm (bench.py's sec_train_bf16 pair)."""
    from srcgan_tpu_torch.train.cas import CasTrainer

    return CasTrainer(sr_model="RDDBNet", c_model="ResDeconv", up=TRAIN_UP,
                      lr=TRAIN_LR, device=dev, **kw)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def phase_train_fp32(dev):
    """One fp32 fused-input uint8 step (TF32 off) on the card against the
    CPU, batch 2 of 64^2: losses within rtol 1e-4; every tensor's gradient,
    and each network's Adam update, within rel-L2 5e-2 (the fp32 envelope of
    L1 gradients across backends, tests/test_training_dynamics.py).  A
    tensor's own first Adam update is lr * g / (|g| + eps), about +-lr per
    element, so one sign flip of a near-zero gradient in a 64-element
    GroupNorm bias moves it by rel-L2 0.25: that number is printed, not bound."""
    from srcgan_tpu_torch import config

    rng = np.random.default_rng(6)
    src, tar = (torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
                for _ in range(2))
    runs = []
    with config.precision("fp32"):
        for where in ("cpu", dev):
            tr = slice_trainer(where, fused_input=True)
            state = tr.init(3)
            before = {r: {n: p.detach().cpu().clone() for n, p in
                          getattr(state, r).model.named_parameters()} for r in ("sr", "c")}
            real_a, real_b, pre = tr._u8_inputs(src.to(where), tar.to(where))
            grads, mstates, m = tr.grads(state, real_a, real_b, precomputed=pre)
            grads = {r: {n: g.cpu() for n, g in grads[r].items()} for r in grads}
            state = tr.apply_grads(state, grads if where == "cpu" else
                                   {r: {n: g.to(where) for n, g in grads[r].items()}
                                    for r in grads}, mstates, TRAIN_LR)
            delta = {r: {n: p.detach().cpu() - before[r][n] for n, p in
                         getattr(state, r).model.named_parameters()} for r in ("sr", "c")}
            runs.append(({k: float(v) for k, v in m.items()}, grads, delta))
    (m_cpu, g_cpu, d_cpu), (m_card, g_card, d_card) = runs
    loss_err = max(abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k]) for k in ("loss_SR", "loss_C"))
    grad_err, grad_at = max((rel_l2(g_card[r][n], g_cpu[r][n]), f"{r}.{n}")
                            for r in g_cpu for n in g_cpu[r])
    net_err = max(rel_l2(torch.cat([t.flatten() for t in d_card[r].values()]),
                         torch.cat([t.flatten() for t in d_cpu[r].values()])) for r in d_cpu)
    upd_err, upd_at = max((rel_l2(d_card[r][n], d_cpu[r][n]), f"{r}.{n}")
                          for r in d_cpu for n in d_cpu[r])
    ok = loss_err <= 1e-4 and grad_err <= 5e-2 and net_err <= 5e-2
    print(f"[train] fp32 step card vs CPU (batch 2, 64^2, TF32 off): losses "
          f"{m_card['loss_SR']:.6f}/{m_card['loss_C']:.6f} vs {m_cpu['loss_SR']:.6f}/"
          f"{m_cpu['loss_C']:.6f}, max rel {loss_err:.2e} (bound 1e-4); max per-tensor "
          f"gradient rel-L2 {grad_err:.2e} at {grad_at} (bound 5e-2); per-network update "
          f"rel-L2 {net_err:.2e} (bound 5e-2); max per-tensor update rel-L2 {upd_err:.2e} "
          f"at {upd_at} (not bound) {'PASS' if ok else 'FAIL'}")
    check(ok, "the fp32 train step on the card disagrees with the CPU")


def phase_train(dev, card: str) -> int:
    """The slice's main path: bf16 activations, fused_input, batch 8 of 256^2."""
    from srcgan_tpu_torch.ops.kernels import preprocess_kernel as pk

    rng = np.random.default_rng(7)
    shape = (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3)
    src, tar = (torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
                for _ in range(2))
    tr = slice_trainer(dev, act_dtype=torch.bfloat16, fused_input=True)
    state = tr.init(4)

    pk.launches = 0
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = tr.train_step_u8(state, src, tar, TRAIN_LR)
        metrics.append(m)
    torch.cuda.synchronize()
    launches = pk.launches
    print(f"[train] {TRAIN_STEPS} bf16 fused-input steps, gray_degrade launches {launches}")
    check(launches == TRAIN_STEPS, "a train step did not launch gray_degrade exactly once")
    loss = {k: [float(m[k]) for m in metrics] for k in ("loss_SR", "loss_C")}
    finite = all(math.isfinite(v) for vs in loss.values() for v in vs)
    falls = all(vs[-1] < vs[0] for vs in loss.values())
    print(f"[train] loss_SR {loss['loss_SR'][0]:.5f} -> {loss['loss_SR'][-1]:.5f}, loss_C "
          f"{loss['loss_C'][0]:.5f} -> {loss['loss_C'][-1]:.5f}; finite {finite}, both "
          f"fall {falls} {'PASS' if finite and falls else 'FAIL'}")
    check(finite and falls, "bf16 training: a loss is not finite or does not fall")
    check(state.sr.step == state.c.step == TRAIN_STEPS, "steps not counted")

    before = pk.launches
    state, mk = tr.train_steps_u8(state, torch.stack([src] * TRAIN_K),
                                  torch.stack([tar] * TRAIN_K), TRAIN_LR)
    torch.cuda.synchronize()
    check(all(v.shape == (TRAIN_K,) and bool(torch.isfinite(v).all()) for v in mk.values()),
          "train_steps_u8 metrics")
    check(pk.launches - before == TRAIN_K, "train_steps_u8 missed the kernel")
    print(f"[train] train_steps_u8 K={TRAIN_K}: metrics of shape ({TRAIN_K},), "
          f"{pk.launches - before} launches PASS")

    real_a = torch.from_numpy(rng.uniform(0, 1, (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 1))
                              .astype(np.float32)).to(dev)
    a_in, fake_ac, fake_ab = tr.transfer(state, real_a)
    h = TRAIN_HW // TRAIN_UP
    check(a_in.shape == (TRAIN_BATCH, h, h, 1) and fake_ac.shape == real_a.shape
          and fake_ab.shape == (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3), "transfer shapes")
    check(all(bool(torch.isfinite(t).all()) and t.std().item() > 0
              for t in (fake_ac, fake_ab)), "transfer output constant or not finite")
    print("[train] transfer (eval, up=2): shapes, finite, non-constant PASS")
    del state, tr

    # step time, fused_input on and off in turns: the step is host-bound
    # (PERF.md), so one pair of runs does not resolve a difference
    times = {True: [], False: []}
    for fused in (True, False, False, True, True, False):
        t = slice_trainer(dev, act_dtype=torch.bfloat16, fused_input=fused)
        st = t.init(5)
        times[fused].append(median_ms(lambda: t.train_step_u8(st, src, tar, TRAIN_LR),
                                      reps=TRAIN_REPS))
        del st, t
    mp = TRAIN_BATCH * TRAIN_HW ** 2 / 1e6
    for fused in (True, False):
        ms = statistics.median(times[fused])
        print(f"[train] bf16 step, batch {TRAIN_BATCH} of {TRAIN_HW}^2, fused_input="
              f"{fused} on {card}: {ms:.3f} ms (runs {', '.join(f'{v:.3f}' for v in times[fused])})"
              f" = {TRAIN_BATCH / ms * 1e3:.2f} samples/s = {mp / ms * 1e3:.2f} target MP/s")
    return launches


def read_performs(result_dir: str) -> dict:
    with open(os.path.join(result_dir, "Performs.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1 and list(rows[0]) == ["time", "checkpoint", "MSE", "PSNR", "AE",
                                               "SSIM"], f"Performs.csv layout: {rows}")
    return rows[0]


def phase_eval(dev, card: str) -> int:
    """The evaluation path through the command-line tools (see the module
    docstring).  Returns the ssim launches of the card's test_cas run."""
    from PIL import Image

    from srcgan_tpu_torch import config, data
    from srcgan_tpu_torch.cli import test_cas, train_cas
    from srcgan_tpu_torch.data import native, preprocess
    from srcgan_tpu_torch.metrics import per_sample_evaluators
    from srcgan_tpu_torch.ops.kernels import ssim_kernel as sk

    print(f"[eval] PNG codec: {native.codec()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        data.make_synthetic_dataset(os.path.join(tmp, "Sat2Aerx1"), n_train=EVAL_TRAIN,
                                    n_val=2, n_test=EVAL_TEST, size=EVAL_HW, seed=0,
                                    colorizable=True)
        ck = os.path.join(tmp, "checkpoints")
        train_cas.main(["--data-dir", tmp, "--SRModel", "RDDBNet", "--CModel", "ResDeconv",
                        "--up", str(TRAIN_UP), "--batch-size", str(EVAL_BATCH), "--bf16-acts",
                        "--steps-per-dispatch", "4", "--num-epochs", "1", "--save-every", "1",
                        "--log-every", "4", "--checkpoints", ck,
                        "--run-dir", os.path.join(tmp, "run")])
        net_a = os.path.join(ck, f"RDDBNet_A2C_x{TRAIN_UP}_0001.npz")
        net_b = os.path.join(ck, f"ResDeconv_C2B_x{TRAIN_UP}_0001.npz")
        check(os.path.exists(net_a) and os.path.exists(net_b)
              and os.path.exists(os.path.join(ck, "casstate_latest.npz")),
              "train_cas left no checkpoints")
        print()

        def evaluate(result, *extra):
            return test_cas.main(["--netGA", net_a, "--netGB", net_b, "--data-dir", tmp,
                                  "--result-dir", os.path.join(tmp, result), "--batch-size",
                                  str(EVAL_BATCH), "--precision", "highest", *extra])

        sk.launches = 0
        on_card = evaluate("result")
        launches = sk.launches
        n_batches = -(-EVAL_TEST // EVAL_BATCH)
        print(f"[eval] {on_card['images']} images in {on_card['batches']} batches on "
              f"{on_card['device']}, ssim launches {launches}")
        check(on_card["images"] == EVAL_TEST and on_card["batches"] == n_batches
              and on_card["device"].startswith("cuda"), "the eval did not run on the card")
        check(launches == n_batches, "an eval batch did not launch the ssim kernel exactly once")

        row = read_performs(os.path.join(tmp, "result"))
        means = {k: float(row[k]) for k in ("MSE", "PSNR", "AE", "SSIM")}
        check(all(math.isfinite(v) for v in means.values()), f"Performs.csv row {row}")
        for side in "AB":
            out = os.path.join(tmp, "result", f"{side}_RDDBNet_x{TRAIN_UP}_0001")
            names = sorted(os.listdir(out))
            check(len(names) == EVAL_TEST, f"{out}: {len(names)} PNGs")
            for name in names:
                with Image.open(os.path.join(out, name)) as im:
                    check(im.size == (EVAL_HW, EVAL_HW) and im.mode == "RGB",
                          f"{name}: {im.size} {im.mode}")
        print(f"[eval] Performs.csv row {row}; 2x{EVAL_TEST} PNGs decode to "
              f"{EVAL_HW}^2 RGB PASS")

        on_cpu = evaluate("result_cpu", "--device", "cpu")
        d_psnr = abs(on_card["PSNR"] - on_cpu["PSNR"])
        d_ssim = abs(on_card["SSIM"] - on_cpu["SSIM"])
        rel = {k: abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k]) for k in ("MSE", "AE")}
        ok = d_psnr <= 0.01 and d_ssim <= 1e-4
        print(f"[eval] card vs CPU means: PSNR {on_card['PSNR']:.5f} vs {on_cpu['PSNR']:.5f} "
              f"(|d| {d_psnr:.2e}, bound 0.01 dB), SSIM {on_card['SSIM']:.6f} vs "
              f"{on_cpu['SSIM']:.6f} (|d| {d_ssim:.2e}, bound 1e-4), MSE rel "
              f"{rel['MSE']:.2e}, AE rel {rel['AE']:.2e} {'PASS' if ok else 'FAIL'}")
        check(ok, "the card's Performs.csv row disagrees with the CPU's")

        # a second pass, warm: the loop's rate and its host PNG encode time
        warm = evaluate("result_warm")
        print(f"[eval] test_cas loop, {EVAL_TEST} images of {EVAL_HW}^2, batch {EVAL_BATCH}, "
              f"fp32 on {card}: first pass {on_card['eval_seconds']:.3f} s = "
              f"{EVAL_TEST / on_card['eval_seconds']:.2f} images/s; warm pass "
              f"{warm['eval_seconds']:.3f} s = {EVAL_TEST / warm['eval_seconds']:.2f} images/s, "
              f"of which PNG encode on the host {warm['encode_seconds']:.3f} s "
              f"({native.codec()})")

        # the device side of one eval batch: the cascade on both domains, the
        # four metrics, and SSIM alone
        info, sr_net, c_net = test_cas.load_cascade(net_a, net_b, dev, torch.float32)
        cascade = test_cas.make_cascade(sr_net, c_net, info["up"], False, "fp32")
        testset = data.FileListDataset("Sat2Aerx1", "test", "G2RGB", tmp)
        src, tar, _ = next(data.batches(testset, EVAL_BATCH))
        real_a, real_b = preprocess.convert_pair(torch.from_numpy(src).to(dev),
                                                 torch.from_numpy(tar).to(dev))
        fake_bb = cascade(real_a, real_b)[3]
        evals = per_sample_evaluators()
        casc_ms = median_ms(lambda: cascade(real_a, real_b), reps=TRAIN_REPS)
        all_ms = median_ms(lambda: [fn(fake_bb, real_b) for _, fn in evals])
        ssim_ms = median_ms(lambda: evals[3][1](fake_bb, real_b))
        print(f"[eval] one batch of {EVAL_BATCH} on {card}: cascade (both domains, fp32, "
              f"TF32 off) {casc_ms:.3f} ms; the four per-sample metrics {all_ms:.4f} ms, of "
              f"which SSIM {ssim_ms:.4f} ms = {100 * ssim_ms / (casc_ms + all_ms):.2f}% of "
              f"the batch's device work")
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

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build.build, KERNELS))
    for path, seconds, log in built:
        print(f"[build] {path.name}: nvcc {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    where = f"{card} ({smi})"
    tail = phase_kernels(dev, where)
    gray = phase_gray_degrade(dev, where)
    ssim = phase_ssim(dev, where)
    sr, c = cascade(torch.Generator().manual_seed(1))
    x_small, fp32_small = phase_fp32(dev, sr, c)
    tail["launches"] = phase_serve(dev, where, sr, c, x_small, fp32_small)
    del sr, c
    phase_train_fp32(dev)
    gray["launches"] = phase_train(dev, where)
    ssim["launches"] = phase_eval(dev, where)

    print(json.dumps({"kernels": [tail, gray, ssim]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
