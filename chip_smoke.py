#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (srcgan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; the first failure raises and the script exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every kernel (tail_x4, gray_degrade) from csrc/,
               one process per source, all started together;
  3. kernels - each kernel's wrapper against its plain PyTorch version at the
               shapes the main paths give it, with both times (CUDA events,
               median of 25 calls after 3 warm-up calls);
  4. fp32    - the full-width serving cascade on the card against the same
               cascade on the CPU, in fp32 with TF32 off;
  5. serve   - the bf16 CascadePredictor at full width answers requests, every
               forward goes through the tail kernel (launch counter), and the
               steady batch-8 throughput is measured;
  6. train   - the cascade training step (CasTrainer, RDDBNet x2 + ResDeconv,
               full width): one fp32 uint8 step on the card against the CPU;
               20 bf16 fused-input steps at batch 8, 256^2, each launching
               the gray_degrade kernel once, with both losses falling; a
               K=4 train_steps_u8 call; the step time with fused_input on and
               off; and the eval transfer cascade.
Then one JSON line of kernel results, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Weights are random, from fixed seeds.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BATCH, LR = 8, 128           # the bench shape: batch 8 of 128x128 gray, x4
NF = 64
# The colorizer's last conv is scaled so the random cascade's output spans
# [0, 1] (std ~0.2) instead of saturating: uint8 checks then see the values.
PRED_SCALE = 0.03
WARMUP, REPS = 3, 25         # calls per timing: warm-up, then the median of REPS
KERNELS = ("tail_x4", "gray_degrade")
# The training slice: CasTrainer(RDDBNet, ResDeconv, up=2), batch 8 of 256^2 targets.
TRAIN_BATCH, TRAIN_HW, TRAIN_UP, TRAIN_LR = 8, 256, 2, 1e-4
TRAIN_STEPS, TRAIN_K, TRAIN_REPS = 20, 4, 10


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


def phase_gray_degrade(dev, card: str) -> dict:
    """gray_degrade against its plain version at the training shape (up=2),
    at up=4, and at a ragged shape; bound 1e-6 on both outputs, the Pallas
    kernel's own (tests/test_fused.py)."""
    from srcgan_tpu_torch.ops.kernels import preprocess_kernel as pk

    rng = np.random.default_rng(5)
    worst, times = 0.0, None
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
        mb = (x.numel() + 4 * (n * h * w + n * (h // up) * (w // up))) / 1e6
        print(f"[kernels] gray_degrade {shape} up={up} on {card}: kernel {ms:.4f} ms "
              f"({mb / ms:.1f} GB/s of {mb:.2f} MB), plain version {plain_ms:.4f} ms")
        if times is None:
            times = ms, plain_ms
    return {"name": "gray_degrade", "route": "cuda",
            "source": "srcgan_tpu_torch/csrc/gray_degrade.cu",
            "replaces": "srcgan_tpu/ops/pallas/preprocess_kernel.py:44",
            "max_abs_err": worst, "ms": times[0], "plain_ms": times[1]}


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
    sr, c = cascade(torch.Generator().manual_seed(1))
    x_small, fp32_small = phase_fp32(dev, sr, c)
    tail["launches"] = phase_serve(dev, where, sr, c, x_small, fp32_small)
    del sr, c
    phase_train_fp32(dev)
    gray["launches"] = phase_train(dev, where)

    print(json.dumps({"kernels": [tail, gray]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
