#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (srcgan_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; the first failure raises and the script exits non-zero:
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - nvcc builds every kernel (tail_x4, gray_degrade, ssim, rdb5,
               probes, group_norm) from csrc/, one process per source, all
               started together;
  3. kernels - each kernel's wrapper against its plain PyTorch version at the
               shapes the main paths give it, with both times (CUDA events,
               median of 25 calls after 3 warm-up calls) and its bound: the
               least time the card could take, from the bytes the function
               must move and the operations it does; the tail's two kernels
               (the three GEMMs, the finish) each on the device (profiler),
               the wrapper in rounds, and the main kernel in turns with its
               first design (csrc/tail_x4_wmma.cu, built for this reading
               only, through ``probes.tail_ablate``); gray_degrade (one
               device kernel a call) and ssim (at most two: the range pass
               and the main pass with its finish; every mode three calls
               bit-equal, the range it wrote against the plain version's),
               each with its device time beside its first design's recorded
               one, and its wrapper in five rounds in turns with its plain
               version, with the spread; the RDB5 kernel in both
               forms (bf16, int8) at the serving shape (8,128,128,64), a
               ragged one (1,15,128,64), a 512-wide one and phase 15's
               tiles (8,256,256,64), timed in turns with the cuDNN block;
               the tail also on phase 15's 256^2 trunk; group_norm, through
               the entry the module runs on channels_last views, at the
               colorizer's four stream shapes and the tiled windows' four
               with each epilogue (at most one bf16 ulp from its plain
               version, two device kernels a call, three calls bit-equal),
               timed at the stream shapes in turns with its plain version
               and F.group_norm, with its device time against the 6-byte
               bound;
  4. fp32    - the full-width serving cascade on the card against the same
               cascade on the CPU, in fp32 with TF32 off;
  5. serve   - the bf16 CascadePredictor at full width answers requests, every
               forward goes through the tail's main kernel and its finish once
               each, the rdb5_bf16 kernel nine times and the group_norm
               kernel 32 times with no plain GroupNorm call (launch counters),
               and the steady batch-8 throughput is measured;
  6. trunk   - the serving RDDBNet in bf16 under rdb5_schedule("fused") and
               with no schedule scoped: 9 rdb5_bf16 launches per forward,
               against the naive forward (cuDNN), in turns;
  7. int8    - CascadePredictor(int8=True) at full width: predict before
               calibrate raises, calibrate on 2 batches, 9 rdb5_int8 launches
               per forward and no plain version, two predicts bit-equal, the
               RDDBNet stage against fp32, the card against the CPU, and the
               batch time beside the fp32 and bf16 predictors';
  8. train   - the cascade training step (CasTrainer, RDDBNet x2 + ResDeconv,
               full width): one fp32 uint8 step on the card against the CPU;
               10 bf16 fused-input steps at batch 8, 256^2, each launching
               the gray_degrade kernel once, with both losses falling; a
               K=4 train_steps_u8 call; the step time with fused_input on and
               off; and the eval transfer cascade;
  9. eval    - the evaluation protocol through the command-line tools, at
               full width and depth: a synthetic Sat2Aerx1-layout set of 256^2
               pairs on disk, cli.train_cas for one short epoch (RDDBNet x2 +
               ResDeconv, bf16 activations, 4 steps per dispatch), then
               cli.test_cas on its checkpoints (batch 8, fp32): every eval
               batch calls the ssim kernels once, the PNGs decode, and the
               Performs.csv row agrees with the same tool on the CPU.
 10. probes  - the six probe kernels (csrc/probes.cu) against their plain
               versions at their full shapes (int8 forms and the roll bit-equal,
               bf16 dots rel-L2 1e-3, probe_matmul's bf16 output 1e-2), each
               with its time, its bound and, where one PyTorch call computes
               the same function, that call's time (probe_matmul's bf16 form,
               its build without products and torch.matmul also in turns, x
               warm in L2 and x from HBM; its int8 form at every shape of its
               sweep bit-equal where the cast wraps and, x from HBM, in turns
               with PR 5's design and torch._int_mm, which it must beat);
               probe_mxu (both types) and probe_dots at every
               shape of their sweeps through the chain kernel, three calls
               bit-equal, in turns with PR 5's design (the yardstick build
               PROBES_CHAIN=0 PROBES_MM8=0 PROBES_STAGE1=0 PROBES_ROLL=0
               PROBES_CONCAT=0), and 48 dots
               taking more than twice 16 at K=576, N=192; probe_stage1 in
               both forms at strides 128 and 16, three calls bit-equal, and in
               turns with the first design, which it must beat; probe_concat_dot
               in both forms and probe_roll at shifts 1 and 128 (and 0, M - 1),
               three calls bit-equal, each in turns with the first design, which
               it must beat, the roll with its two bounds (4 MB once through
               HBM; 16 passes through the shared memory of the SMs its layout
               holds) and each roll past the 16th no faster than a pass;
               then the three sweeps
               through ``python -m srcgan_tpu_torch.probes``'s entry points,
               which must reach every kernel (launch counters);
 11. lab     - the LAB cascade at full width: CascadePredictor(lab=True) in
               fp32 on the card against the CPU and in bf16 through the tail's
               two kernels and rdb5_bf16, beside the RGB predictor; three bf16 CasTrainer(lab=True)
               steps; cli.train_cas --lab for a short epoch and cli.test_cas on
               its @G2LAB checkpoints (the ssim kernels once per eval batch, the
               PNGs decode, the row agrees with --device cpu).
 12. gan     - the CycleGAN slice (CycleGANTrainer, net='1' x2: RDDBNetB and
               RDDBNetD at nf 64, nb 3, gc 32, two NLayerDiscriminator(3,64,2)):
               two fp32 gd_steps, remat on, on the card against the CPU at a
               128^2 target, the second from the card's state on both sides
               (each step's losses within rtol 1e-4, D's running statistics,
               each network's update and parameter norm held);
               five bf16 optimize_parameters
               iterations through the host pool (4) at batch 1 of 256^2 and one
               gd_steps_pooled_u8 call of K=4 through the device pool, all
               losses finite and no rdb5_bf16 launch; the ms per iteration of
               optimize_parameters and gd_step at batch 1 and 4, remat on and
               off in turns, with peak memory and a host yardstick before each
               turn, and one iteration's host/device split (profiler, device
               time required); cli.train_cyclegan for one epoch on a
               synthetic Sat2Aerx2 set of 256^2 with --eval-after-save, then
               cli.test_cyclegan on its checkpoints: one ssim launch per test
               image, the PNGs decode, the row within 0.01 dB / 1e-4 SSIM of
               --device cpu.
 13. mt      - the multi-task GAN (MultiTaskTrainer() at the JAX defaults: x2,
               ngf 64, resnet_9blocks, instance norm, G_C SRDenseNetA with 2
               blocks of 2 layers, two NLayerDiscriminator(., 64, 2), pool 4,
               remat on): two fp32 gd_step_pooled steps on the card against
               the CPU at a 128^2 target, each from the card's state on both
               sides after a warm-up step (phase 12's bounds); three bf16
               optimize_parameters iterations at batch 1 of 256^2 with every
               kernel's launch count 0; one profiled iteration (device time
               required) and its FLOPs; the iteration's ms and peak memory
               with remat on and off in turns; cli.train_multitask for one
               epoch on a synthetic Sat2Aerx2 set, its three checkpoints
               loading back into the port's nets.
 14. zoo     - VDSR, MDSR (every scale index), RDN, RCAN, DDBPN and EDSRWeb at
               the JAX constructors' defaults: fp32 (TF32 off) on the card
               against the CPU at 1x3x48^2 within rel-L2 1e-5; bf16 ms, peak
               memory, FLOPs and bound at batch 16 of 48^2; no kernel launch;
               then cli.train_cas --SRModel EDSRWeb for one epoch and
               cli.test_cas on its checkpoints, their last convs scaled into
               range: one ssim launch per eval batch and nothing else, the
               row within 0.01 dB / 1e-4 SSIM of --device cpu, whose SSIM
               must be above 1e-2.
 15. extras  - the serving extras: (a) a 700x1000 gray scene through a bf16
               TiledPredictor (RDDBNet x4 at full width + an SRCNN(1,3,1)
               colorizer, tile 256, overlap 64: 6 batches of 8, each with 9
               rdb5_bf16 launches and one tail_x4 main and finish launch),
               within a mean of 2 LSB of the whole-scene fp32 program (TF32
               off), the fp32 tiles within 1 LSB max, output MP/s; then with
               the ResDeconv colorizer, as the benchmark's tiled cell: 32
               group_norm launches a tile batch, no plain GroupNorm call,
               within a mean of 1 LSB (2% of the values beyond 8) of the
               same predictor with its GroupNorms on the plain path; (b) the
               serve cascade self-ensembled, bf16, batch 8 of 128^2 as ONE
               forward of 64 rows (9 + 1 + 1 launches), in fp32 within 1 LSB
               of the mean of 8 predictor calls on the transformed inputs,
               ms against plain predict; (c) cli.serve's make_server (bf16,
               --max-batch 8 --pad-batch 4 --tile 256) under 32 clients of
               128^2 PNGs: every response its group's row, every group within
               1 LSB of predict on the same batch, each image alone within a
               bound, mean batch above 1, rdb5_bf16 launches 9 x the groups;
               bf16 predict of a batch against its images alone, with the
               kernels and on cuDNN alone; /reload to a cli.blend output of
               two checkpoint pairs; requests/s, p50/p90/p99 and each
               request's seconds in PNG decode, queue, forward and PNG
               encode at concurrency 1, 8, 32, 64, from a client process, at
               least 100 requests and a few seconds a level; close()
               answering a queued backlog; the same daemon in fp32 (TF32
               off): every response within 1 LSB of predict on its image
               alone; (d)
               a bf16 torch.export artifact at 128^2 with a symbolic batch,
               loaded on the card, batches 8 and 3 within 1 LSB of the
               predictor under the kernel-off scopes and no kernel launch,
               ms against the predictor with its kernels; (e) cli.test_cas
               --self-ensemble (RDDBNet x2 + ResDeconv, 8 pairs of 256^2,
               batch 4, fp32): one ssim launch per batch, a finite row.
 16. distill - distillation and the perceptual term: the serve cascade saved as
               a checkpoint pair is the teacher of DistillTrainer.from_checkpoints
               (alpha 0.5, student ESPCN x4 + a fresh ResDeconv, bf16,
               fused_input): 10 steps at batch 8 of 512^2 uint8 targets (the
               teacher's trunk at the serving shape), each launching rdb5_bf16
               9 times, tail_x4's main kernel and finish once each and
               gray_degrade once, the losses finite and falling, the peak
               memory; the step's ms in turns with the plain CasTrainer step and
               the teacher's share of its device time (profiler); alpha=1 bit-
               equal to the CasTrainer step (cuDNN deterministic); one fp32
               distill step on the card against the CPU (phase 8's bounds, the
               step after a warm-up step of the card's, both sides from its
               state, as phase 12 does); CasTrainer with random VGG16 weights:
               3 bf16 steps at phase 8's shape and its fp32 step against the
               CPU, likewise; cli.convert_vgg on a
               torchvision-layout .pth written here; cli.train_cas
               --distill-netGA/--distill-netGB for one epoch, then cli.test_cas
               on the student: one ssim launch per batch, the row within 0.01
               dB / 1e-4 SSIM of --device cpu.
 17. axis    - the data axis over an NCCL process group of world size 1 (the
               run has one card: no scaling is read here; the two-rank
               arithmetic is held against the JAX package's 2-device mesh by
               tests/test_torch_parallel.py on the CPU): at phase 8's slice
               (bf16, fused_input, batch 8 of 256^2), make_cas_dp_step and
               make_cas_dp_steps_u8 (K=2, two gray_degrade launches) bit-equal
               to the plain steps (cuDNN deterministic), the ZeRO-1 and FSDP
               updates within rel-L2 1e-6 of the plain step's; the CycleGAN's
               make_gd_zero1_step against gd_step (fp32, 128^2) likewise; a
               torch.distributed.checkpoint save and restore of a ZeRO-1 and an
               FSDP state, bit-equal, with their seconds; the world-1 DP step's
               ms in turns with the plain step.
 18. axes    - the space, model and pipe axes: the serving cascade (bf16,
               batch 8 of 128^2) cut into 2 and 4 row strips in this process,
               one thread a strip in turns, each strip's halos taken from its
               neighbours' rows as the ranks' exchanges bring them
               (parallel.spatial under a local message backend): the
               stitched uint8 within 1 LSB of CascadePredictor, the RDDBNet
               output's max |diff| printed, rdb5_bf16 9 and tail_x4 1 + 1
               launches a strip; on NCCL meshes of one rank, the
               SpatialShardedPredictor within 1 LSB (bit-equal or not
               printed), the fp32 gradients (TF32 off) of the (space),
               (data, space), (model) and (data, model) steps within rel-L2
               1e-5 of the plain step's, and a bf16 fused-input (data, space)
               uint8 step (one gray_degrade launch).  With 2 or more cards
               the readings of parallel.axes_check --cards (the sharded
               predictor at 2 and 4 ranks on a 2048x512 input, ms and peak
               memory a rank; the cascade and trunk pipelines against the
               unsharded forward) and steps_check --axes; with one card, a
               line saying what was not run.
Then one JSON line of kernel results (with each kernel's launches on the
paths of phases 13 to 18), the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Weights are random, from fixed seeds.
"""
from __future__ import annotations

import contextlib
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
KERNELS = ("tail_x4", "gray_degrade", "ssim", "rdb5", "probes", "group_norm")
# builds timed beside a kernel and never on a path: the tail's first design;
# probe_matmul with its products left out (loads and stores only, both types);
# the first design of the six probes redesigned since (probe_mxu's and
# probe_dots' chain, probe_matmul's int8 form, probe_stage1 and
# probe_concat_dot on its mma.sync dots_kernel; probe_roll's cooperative
# kernel with a grid-wide barrier)
YARDSTICKS = (("tail_x4_wmma", ()), ("probes", ("PROBES_MM_PRODUCTS=0",)),
              ("probes", ("PROBES_CHAIN=0", "PROBES_MM8=0", "PROBES_STAGE1=0", "PROBES_ROLL=0",
                          "PROBES_CONCAT=0")))
# The card's published peaks (H100 SXM, dense): what a bound is taken against.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# The training slice: CasTrainer(RDDBNet, ResDeconv, up=2), batch 8 of 256^2 targets.
TRAIN_BATCH, TRAIN_HW, TRAIN_UP, TRAIN_LR = 8, 256, 2, 1e-4
TRAIN_STEPS, TRAIN_K, TRAIN_REPS = 10, 4, 10
# The eval slice: 16 test pairs of 256^2 in batches of 8; 32 training pairs.
EVAL_HW, EVAL_BATCH, EVAL_TEST, EVAL_TRAIN = 256, 8, 16, 32
# The LAB slice: the same widths; 3 train steps, 16 training and 8 test pairs.
LAB_STEPS, LAB_EVAL_BATCH, LAB_TEST, LAB_TRAIN = 3, 4, 8, 16
# The probes: one 128x128 plane of rows (130 tiles of 64 for the resident dots).
PROBE_M, MXU_M = 16384, 8320


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


def in_turns_ms(fns: dict, rounds: int = 5, reps: int = REPS) -> dict:
    """``median_ms`` of every function of ``fns`` in each of ``rounds`` rounds,
    the order reversed from round to round, so that a drift of the host or the
    card falls on all of them alike: name -> the rounds' medians."""
    times = {name: [] for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order:
            times[name].append(median_ms(fns[name], reps))
        order.reverse()
    return times


def spread(ts) -> str:
    return (f"median {statistics.median(ts):.4f} ms, min {min(ts):.4f}, max {max(ts):.4f} over "
            f"{len(ts)} rounds in turns")


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


def tail_inputs(gen, ou, dev, hw=LR):
    """Trunk output and tail weights at the bench shape (or an hw x hw trunk),
    kaiming-scaled."""
    t0 = torch.randn(BATCH, hw, hw, NF, generator=gen).to(dev, torch.bfloat16)
    d1, d2 = (torch.randn(NF, NF, 2, 2, generator=gen) * (2 / (4 * NF)) ** 0.5
              for _ in range(2))
    lw = torch.randn(ou, NF, 3, 3, generator=gen) * (2 / (9 * ou)) ** 0.5
    lb = torch.randn(ou, generator=gen) * 0.1
    return t0, d1.to(dev), d2.to(dev), lw.to(dev), lb.to(dev)


def phase_kernels(dev, card: str) -> dict:
    """The tail: its wrapper (the main kernel, then the finish) against the
    plain version at ou = 1 and 3, and at ou = 1 on the 256^2 trunk of a
    scene's tiles (phase 15); at ou=1 and the bench shape the wrapper in
    rounds, each kernel alone and on the device, and the main kernel in turns
    with its first design (graph timing, 4 rounds)."""
    from srcgan_tpu_torch.ops import fused
    from srcgan_tpu_torch.ops.kernels import tail_kernel
    from srcgan_tpu_torch.probes import common, tail_ablate

    gen = torch.Generator().manual_seed(0)
    result = None
    for ou, hw in ((1, LR), (3, LR), (1, TILE)):
        t0, d1, d2, lw, lb = tail_inputs(gen, ou, dev, hw)
        tw = tail_kernel.prepare(d1, d2, lw)
        before = tail_kernel.launches, tail_kernel.finish_launches
        got = tail_kernel.tail_x4_fused(t0, tw, lb)
        ref = tail_kernel.tail_x4_reference(t0, d1, d2, lw, lb)
        torch.cuda.synchronize()
        check((tail_kernel.launches, tail_kernel.finish_launches) == (before[0] + 1, before[1] + 1),
              "tail_x4_fused did not launch its main kernel and its finish once each")
        check(got.shape == ref.shape == (BATCH, 4 * hw, 4 * hw, ou),
              f"tail_x4 shape {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        bound = 0.02 * max(scale, 1.0)
        print(f"[kernels] tail_x4 ou={ou}, trunk {BATCH}x{hw}^2: max|kernel - plain| = "
              f"{err:.6g} (bound 0.02*max(max|ref|,1) = {bound:.6g}) "
              f"{'PASS' if err <= bound else 'FAIL'}")
        check(err <= bound, f"tail_x4 ou={ou} at {hw}^2 disagrees with its plain version")
        t0m = t0.reshape(-1, NF)
        zall = tail_kernel.zall_reference(t0m, tw)
        fin = tail_kernel._finish_kernel(zall, BATCH, hw, hw, ou, lb)
        check(torch.equal(fin, tail_kernel.finish_reference(zall, BATCH, hw, hw, ou, lb)),
              f"the tail's finish pass ou={ou} at {hw}^2 is not bit-equal to its plain version")
        print(f"[kernels] tail_x4 finish ou={ou}, trunk {BATCH}x{hw}^2: bit-equal to its "
              f"plain version PASS")
        if (ou, hw) != (1, LR):
            continue

        turns = in_turns_ms({"wrapper": lambda: tail_kernel.tail_x4_fused(t0, tw, lb)}, rounds=4)
        ms = statistics.median(turns["wrapper"])
        plain_ms = median_ms(lambda: tail_kernel.tail_x4_reference(t0, d1, d2, lw, lb), reps=5)
        k_ms = median_ms(lambda: tail_kernel._zall_kernel(t0m, tw, 0.2))
        f_ms = median_ms(lambda: tail_kernel._finish_kernel(zall, BATCH, LR, LR, ou, lb))
        k_us = common.device_us(lambda: tail_kernel._zall_kernel(t0m, tw, 0.2), "tail_x4_kernel")
        f_us = common.device_us(lambda: tail_kernel._finish_kernel(zall, BATCH, LR, LR, ou, lb),
                         "finish_kernel")
        dws = [d.permute(2, 3, 0, 1) for d in (d1, d2)]
        lw_hwio = lw.permute(2, 3, 1, 0)
        wf = fused.fold_last_weight(fused.tail_phases(2), lw_hwio, 4, NF, torch.bfloat16)
        fold_ms = median_ms(lambda: fused.phasefold_deconv_tail(t0, dws, lw_hwio, lb, wf=wf))
        flop = tail_ablate.flop(t0m.shape[0], NF, ou)
        least = least_time(tensor_bytes(t0, d1, d2, lw, lb, got), flop, "bf16")
        fin_least = least_time(tensor_bytes(zall, got), 0, "bf16")
        # the main kernel in turns with its first design, both under graph
        # timing (4 launches a replay)
        first = {"ships": lambda: tail_kernel._zall_kernel(t0m, tw, 0.2),
                 "first design": lambda: tail_ablate.first_design(t0m, tw)}
        graph = {k: [] for k in first}
        order = list(first)
        for _ in range(4):
            for k in order:
                graph[k].append(common.graph_ms([first[k]] * 4))
            order.reverse()
        first_us = common.device_us(first["first design"], "tail_x4_kernel")
        fmt = lambda v: "not measured" if v is None else f"{v:.1f} us"
        print(f"[kernels] tail_x4 ou={ou} on {card}: wrapper {spread(turns['wrapper'])}; plain "
              f"version {plain_ms:.4f} ms; main kernel alone {k_ms:.4f} ms, on the device "
              f"{fmt(k_us)} ({flop / 1e6 / k_us if k_us else 0:.1f} TFLOP/s on the device); "
              f"finish alone {f_ms:.4f} ms, on the device {fmt(f_us)} (bound "
              f"{fin_least['bound_ms'] * 1e3:.2f} us by bytes); bf16 phase-folded tail (cuDNN, a "
              f"chain of calls) {fold_ms:.4f} ms; bound {least['bound_ms']:.4f} ms by "
              f"{least['bound_by']} ({flop / 1e9:.1f} GFLOP at the bf16 peak)")
        print(f"[kernels] tail_x4 main kernel in turns with its first design (graph of 4 "
              f"launches, ms per launch): ships {' / '.join(f'{t:.4f}' for t in graph['ships'])}; "
              f"first design {' / '.join(f'{t:.4f}' for t in graph['first design'])} (on the "
              f"device {fmt(first_us)})")
        # no single PyTorch call computes the tail: library_ms is null
        result = {"name": "tail_x4", "route": "cuda",
                  "source": "srcgan_tpu_torch/csrc/tail_x4.cu",
                  "replaces": "srcgan_tpu/ops/pallas/tail_kernel.py:66",
                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **least,
                  "library_ms": None, "device_us": k_us, "finish_device_us": f_us,
                  "first_design_graph_ms": statistics.median(graph["first design"]),
                  "graph_ms": statistics.median(graph["ships"])}
    return result


# Device times of the first designs of gray_degrade and ssim, recorded by
# chip_smoke.py runs on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6):
# the yardsticks of the redesigned kernels, whose old sources are gone.
GRAY_DEGRADE_FIRST_US = 6.93
SSIM_FIRST_US = 28.92


def phase_gray_degrade(dev, card: str) -> dict:
    """gray_degrade against its plain version at the training shape (up=2),
    at up=4, and at a ragged shape; bound 1e-6 on both outputs, the Pallas
    kernel's own (tests/test_fused.py).  At the training shape: one device
    kernel a call, its device time (profiler) beside its first design's, the wrapper in
    five rounds in turns with the plain version."""
    from srcgan_tpu_torch.ops.kernels import preprocess_kernel as pk
    from srcgan_tpu_torch.probes import common

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
        # the wrapper's time moves with the host: the training shape is read
        # in rounds, in turns with the plain version, and its spread printed
        turns = in_turns_ms({"kernel": lambda: pk.fused_gray_degrade(x, up),
                             "plain": lambda: pk.gray_degrade_reference(x, up)},
                            rounds=5 if first is None else 1)
        ms, plain_ms = (statistics.median(turns[k]) for k in ("kernel", "plain"))
        nbytes = tensor_bytes(x, *got)
        # per pixel 3 divides, 3 multiplies, 2 adds; per output two 2-tap stencils
        least = least_time(nbytes, 8 * n * h * w + 6 * n * (h // up) * (w // up), "fp32")
        print(f"[kernels] gray_degrade {shape} up={up} on {card}: kernel {ms:.4f} ms "
              f"({nbytes / 1e6 / ms:.1f} GB/s of {nbytes / 1e6:.2f} MB), plain version "
              f"{plain_ms:.4f} ms; bound {least['bound_ms']:.5f} ms by {least['bound_by']}")
        if first is not None:
            continue
        names = common.device_kernels(lambda: pk.fused_gray_degrade(x, up))
        per_call = sum(names.values())
        check(per_call == 1 and all("gray_degrade_kernel" in k for k in names),
              f"gray_degrade ran {per_call} device kernels a call: {names}")
        on_device = common.device_us(lambda: pk.fused_gray_degrade(x, up), "")
        graph_ms = common.graph_ms([lambda: pk.fused_gray_degrade(x, up)] * 10)
        print(f"[kernels] gray_degrade {shape} up={up} wrapper: {spread(turns['kernel'])}; "
              f"plain version: {spread(turns['plain'])}")
        print(f"[kernels] gray_degrade {shape} up={up} on {card}: {per_call:g} device kernel a "
              f"call; on the device {'not measured' if on_device is None else f'{on_device:.2f} us'}"
              f" (profiler; the first design {GRAY_DEGRADE_FIRST_US} us, recorded), graph of 10 calls "
              f"{graph_ms * 1e3:.2f} us a call; bound {least['bound_ms'] * 1e3:.2f} us by "
              f"{least['bound_by']}")
        first = {"ms": ms, "plain_ms": plain_ms, **least, "device_us": on_device,
                 "graph_us": graph_ms * 1e3, "kernels_per_call": per_call}
    # no single PyTorch call computes luma + degradation: library_ms is null
    return {"name": "gray_degrade", "route": "cuda",
            "source": "srcgan_tpu_torch/csrc/gray_degrade.cu",
            "replaces": "srcgan_tpu/ops/pallas/preprocess_kernel.py:44",
            "max_abs_err": worst, **first, "library_ms": None}


# The colorizer's GroupNorm(32) inputs (NHWC) in a bf16 forward: the stream
# cell's batch 8 of 128^2 -> 512^2 (9 + 9 + 9 + 5 calls), and the tiled
# scenes' windows, batch 8 of 256^2 -> 1024^2
GN_SHAPES = ((8, 256, 256, 64), (8, 128, 128, 128), (8, 64, 64, 256), (8, 32, 32, 512))
GN_TILED_SHAPES = ((8, 512, 512, 64), (8, 256, 256, 128), (8, 128, 128, 256), (8, 64, 64, 512))


def phase_group_norm(dev, card: str) -> dict:
    """The GroupNorm kernel through the entry the module runs, on the
    channels_last (N,C,H,W) view of each shape, against its plain version
    at the colorizer's four stream shapes and the tiled windows' four, each
    with no epilogue, ReLU, and residual + ReLU: at most one bf16 ulp apart
    (``ulps_apart``), one call = two device kernels, three calls bit-equal.
    At the stream shapes, with residual + ReLU: the entry, the plain version
    and ``F.group_norm`` on the bf16 channels_last input (the yardstick: one
    PyTorch call of the norm alone, never called by the port) in rounds in
    turns, the device time (profiler) and the bound, 6 bytes an element at
    3.35 TB/s (x read once, the residual read, y written), beside the two-
    pass design's own least time (8: x read twice)."""
    import torch.nn.functional as F

    from srcgan_tpu_torch.ops.kernels import group_norm_kernel as gk
    from srcgan_tpu_torch.probes import common

    rows, worst = [], 0.0
    for i, shape in enumerate(GN_SHAPES + GN_TILED_SHAPES):
        g = torch.Generator().manual_seed(70 + i)
        c = shape[-1]
        x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dev, torch.bfloat16)
        res = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        w = (torch.rand(c, generator=g) + 0.5).to(dev, torch.bfloat16)
        b = (torch.rand(c, generator=g) - 0.5).to(dev, torch.bfloat16)
        xv, rv = x.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)
        with torch.no_grad():
            for label, r, relu in (("none", None, False), ("relu", None, True),
                                   ("residual_relu", res, True)):
                before = gk.launches
                got = [gk.group_norm(xv, w, b, 32, 1e-5, None if r is None else rv, relu)
                       for _ in range(3)]
                torch.cuda.synchronize()
                same = all(torch.equal(got[0], t) for t in got[1:])
                layout = got[0].is_contiguous(memory_format=torch.channels_last)
                gap = gk.ulps_apart(got[0].permute(0, 2, 3, 1), x, w, b, 32, 1e-5, r, relu)
                worst = max(worst, gap)
                ok = gap <= 1.0 and same and layout and gk.launches == before + 3
                print(f"[kernels] group_norm {shape} {label}: {gap:.3f} of the bound (one bf16 "
                      f"ulp + fp32's rounding of the operands), three calls bit-equal {same}, "
                      f"channels_last {layout} {'PASS' if ok else 'FAIL'}")
                check(ok, f"group_norm {shape} {label} disagrees with its plain version")
            del got
            if shape not in GN_SHAPES:
                del x, res, xv, rv
                continue
            fns = {"kernel": lambda: gk.group_norm(xv, w, b, 32, 1e-5, rv, True),
                   "plain": lambda: gk.group_norm_reference(x, w, b, 32, 1e-5, res, True),
                   "library": lambda: F.group_norm(xv, 32, w, b, 1e-5)}
            turns = in_turns_ms(fns, rounds=3)
            names = common.device_kernels(fns["kernel"])
            per_call = sum(names.values())
            check(per_call == 2 and all("gn_" in k for k in names),
                  f"group_norm ran {per_call} device kernels a call: {names}")
            on_device = common.device_us(fns["kernel"], "")
            graph_ms = common.graph_ms([fns["kernel"]] * 10)
        ms, plain_ms, lib_ms = (statistics.median(turns[k]) for k in fns)
        elems = x.numel()
        bound = least_time(6 * elems, 0, "bf16")
        two_pass = least_time(8 * elems, 0, "bf16")
        ratio = "" if on_device is None else f" = {on_device / (bound['bound_ms'] * 1e3):.2f}x"
        print(f"[kernels] group_norm {shape} residual+ReLU on {card}: wrapper {ms:.4f} ms "
              f"({spread(turns['kernel'])}), device "
              f"{'not measured' if on_device is None else f'{on_device:.2f} us'}, graph of 10 "
              f"calls {graph_ms * 1e3:.2f} us a call; bound {bound['bound_ms'] * 1e3:.2f} us "
              f"(6 B an element, x read once){ratio}; the two-pass design's "
              f"{two_pass['bound_ms'] * 1e3:.2f} us (8 B); plain version {plain_ms:.4f} ms; "
              f"F.group_norm alone {lib_ms:.4f} ms; {per_call:g} device kernels a call "
              f"{sorted(names)}")
        rows.append({"shape": list(shape), "ms": ms, "device_us": on_device,
                     "graph_us": graph_ms * 1e3, "bound_ms": bound["bound_ms"],
                     "two_pass_ms": two_pass["bound_ms"], "plain_ms": plain_ms,
                     "library_ms": lib_ms, "kernels_per_call": per_call})
        del x, res, xv, rv
    return {"name": "group_norm", "route": "cuda", "source": "srcgan_tpu_torch/csrc/group_norm.cu",
            "replaces": None, "max_ulps": worst, "shapes": rows}


def ssim_flop(n: int, h: int, w: int, c: int, ws: int = 11) -> int:
    """Operations of the separable form: three products per pixel, the row pass
    of five maps over H x (W-ws+1), the column pass over the valid region, and
    about 20 operations of map arithmetic per valid pixel."""
    vh, vw = h - ws + 1, w - ws + 1
    return n * c * (3 * h * w + 5 * (2 * ws - 1) * (h * vw + vh * vw) + 20 * vh * vw)


SSIM_MODES = [dict(size_average=True), dict(size_average=False),
              dict(size_average=True, full=True),
              dict(size_average=False, per_sample_range=True),
              dict(size_average=False, full=True, per_sample_range=True)]


def phase_ssim(dev, card: str) -> dict:
    """The ssim wrapper against its plain version (the depthwise-conv form,
    fp32 with TF32 off) at the eval shape, at 512^2 and at a ragged shape; in
    [0,1], in [0,255] and with mixed per-sample ranges; every mode of the
    wrapper, each three times bit-equal, and the range the kernel wrote
    against the plain version's.  Bound 1e-6 absolute on SSIM and cs, the
    bound the JAX package holds its two forms to on the CPU (they sum 121
    taps in different orders).  At the eval shape: the device kernels a call
    (at most two), their device time (profiler) beside the first design's, a graph of
    calls, and the wrapper in five rounds in turns with the plain version."""
    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.ops.kernels import ssim_kernel as sk
    from srcgan_tpu_torch.probes import common

    rng = np.random.default_rng(8)
    worst, first = 0.0, None
    for shape in ((EVAL_BATCH, EVAL_HW, EVAL_HW, 3), (8, 512, 512, 3), (3, 250, 198, 1)):
        base = rng.uniform(0, 1, shape).astype(np.float32)
        # y is x plus noise, as a prediction is to its target: SSIM near 0.5
        noisy = np.clip(base + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
        mixed = np.where(np.arange(shape[0]).reshape(-1, 1, 1, 1) % 2 == 0, 255.0, 1.0)
        n, h, w, c = shape
        key = (n, h, w, c, 11, sk.strip_width(c), sk.TILE)
        for label, scale in (("[0,1]", 1.0), ("[0,255]", 255.0), ("mixed ranges", mixed)):
            x = torch.from_numpy((base * scale).astype(np.float32)).to(dev)
            y = torch.from_numpy((noisy * scale).astype(np.float32)).to(dev)
            err = 0.0
            for kw in SSIM_MODES:
                full = kw.get("full", False)
                before = sk.launches
                runs = [sk.ssim_fused(x, y, **kw) for _ in range(3)]
                check(sk.launches == before + 3, "ssim_fused did not launch its kernels")
                written = sk.sample_ranges(dev.index or 0, torch.cuda.current_stream().cuda_stream,
                                           key).clone()
                with config.precision("fp32"):
                    ref = sk.ssim_reference(x, y, **kw)
                torch.cuda.synchronize()
                check(torch.equal(written, sk.dynamic_range(x, kw.get("per_sample_range", False))),
                      f"ssim {shape} {label} {kw}: the range pass wrote {written.tolist()}")
                for again in runs[1:]:
                    check(all(torch.equal(a, b) for a, b in
                              zip(again if full else (again,), runs[0] if full else (runs[0],))),
                          f"ssim {shape} {label} {kw}: three calls are not bit-equal")
                for g, r in zip(runs[0] if full else (runs[0],), ref if full else (ref,)):
                    check(g.shape == r.shape and bool(torch.isfinite(g).all()),
                          f"ssim {shape} {label} {kw}: shape {tuple(g.shape)} or not finite")
                    err = max(err, (g - r).abs().max().item())
            worst = max(worst, err)
            print(f"[kernels] ssim {shape} {label}: max|kernel - plain| over SSIM and cs, "
                  f"{len(SSIM_MODES)} modes = {err:.3g} (bound 1e-6), each mode 3 calls "
                  f"bit-equal, the range pass's L = the plain version's "
                  f"{'PASS' if err <= 1e-6 else 'FAIL'}")
            check(err <= 1e-6, f"ssim {shape} {label} disagrees with its plain version")
        x = torch.from_numpy(base).to(dev)
        y = torch.from_numpy(noisy).to(dev)
        call = lambda: sk.ssim_fused(x, y, size_average=False, per_sample_range=True)
        # the wrapper's time moves with the host: the eval shape in rounds,
        # in turns with the plain version
        with config.precision("fp32"):
            turns = in_turns_ms(
                {"kernel": call,
                 "plain": lambda: sk.ssim_reference(x, y, size_average=False,
                                                    per_sample_range=True)},
                rounds=5 if first is None else 1)
        ms, plain_ms = (statistics.median(turns[k]) for k in ("kernel", "plain"))
        least = least_time(tensor_bytes(x, y) + 4 * n, ssim_flop(n, h, w, c), "fp32")
        names = common.device_kernels(call)
        per_call = sum(names.values())
        check(1 <= per_call <= 2, f"ssim ran {per_call} device kernels a call: {names}")
        on_device = common.device_us(call, "")
        range_us = common.device_us(call, "range_kernel")
        main_us = common.device_us(call, "ssim_kernel")
        graph_ms = common.graph_ms([call] * 10)
        fmt = lambda v: "not measured" if v is None else f"{v:.2f} us"
        if first is None:
            print(f"[kernels] ssim per-sample {shape} wrapper: {spread(turns['kernel'])}; "
                  f"plain version: {spread(turns['plain'])}")
        print(f"[kernels] ssim per-sample {shape} on {card}: wrapper {ms:.4f} ms, plain "
              f"version {plain_ms:.4f} ms; {per_call:g} device kernels a call, on the device "
              f"{fmt(on_device)} (range pass {fmt(range_us)}, main pass and finish "
              f"{fmt(main_us)}; profiler; the first design {SSIM_FIRST_US} us at the eval shape, "
              f"recorded), graph of 10 calls {graph_ms * 1e3:.2f} us a call; bound "
              f"{least['bound_ms'] * 1e3:.2f} us by {least['bound_by']} "
              f"({tensor_bytes(x, y) / 1e6:.2f} MB, {ssim_flop(n, h, w, c) / 1e9:.3f} GFLOP "
              f"at the fp32 rate)")
        if first is None:
            first = {"ms": ms, "plain_ms": plain_ms, **least, "device_us": on_device,
                     "range_device_us": range_us, "main_device_us": main_us,
                     "graph_us": graph_ms * 1e3, "kernels_per_call": per_call}
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


def phase_serve(dev, card, sr, c, x_small, fp32_small) -> tuple:
    """The bf16 serving path; returns its tail_x4 and group_norm launches."""
    from srcgan_tpu_torch.ops.kernels import group_norm_kernel, rdb5_kernel, tail_kernel
    from srcgan_tpu_torch.serving import CascadePredictor

    pred = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True,
                            pad_batch_to=BATCH, device=dev)
    rng = np.random.default_rng(2)
    gray = rng.integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8)
    rgb = rng.integers(0, 256, (BATCH, LR, LR, 3), dtype=np.uint8)
    stream_in = [rng.integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8)
                 for _ in range(3)]

    tail_kernel.launches = tail_kernel.finish_launches = 0
    rdb5_kernel.launches_bf16 = rdb5_kernel.reference_calls = 0
    group_norm_kernel.launches = group_norm_kernel.plain_calls = 0
    y = pred.predict(gray)
    y3 = pred.predict(gray[:3])             # ragged: padded to 8 with the last row
    yrgb = pred.predict(rgb)
    ys = list(pred.predict_stream(iter(stream_in), lookahead=2))
    launches, blocks = tail_kernel.launches, rdb5_kernel.launches_bf16
    finishes = tail_kernel.finish_launches
    forwards = 6
    print(f"[serve] {forwards} forwards, tail_x4 launches {launches} (finish {finishes}), "
          f"rdb5_bf16 launches {blocks}")
    check(launches == finishes == forwards,
          "a bf16 forward did not go through the tail's main kernel and finish once each")
    check(blocks == 9 * forwards and rdb5_kernel.reference_calls == 0,
          "a bf16 forward did not run its nine RDB5 blocks through the rdb5_bf16 kernel")
    norms = group_norm_kernel.launches
    print(f"[serve] group_norm launches {norms}, plain GroupNorm calls "
          f"{group_norm_kernel.plain_calls} (want {32 * forwards} and 0)")
    check(norms == 32 * forwards and group_norm_kernel.plain_calls == 0,
          "a bf16 forward did not run the colorizer's 32 GroupNorms through the kernel")

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
    before = tail_kernel.launches, tail_kernel.finish_launches
    ms = median_ms(lambda: pred._run(x))
    xin = (x.float() / 255).permute(0, 3, 1, 2).to(torch.bfloat16,
                                                   memory_format=torch.channels_last)
    with torch.no_grad():
        sr_ms = median_ms(lambda: pred.sr_model(xin))
    check(tail_kernel.launches - before[0] == tail_kernel.finish_launches - before[1]
          == 2 * (WARMUP + REPS), "a timed forward missed a tail kernel")
    mp = BATCH * (4 * LR) ** 2 / 1e6
    print(f"[serve] steady batch-8 128^2 -> 512^2 bf16 on {card}: cascade "
          f"{ms:.3f} ms = {mp / ms * 1e3:.2f} MP/s; RDDBNet x4 alone {sr_ms:.3f} ms "
          f"= {mp / sr_ms * 1e3:.2f} MP/s")
    return launches, norms


def slice_trainer(dev, **kw):
    """The training slice at full width: RDDBNet(1,1,2) nf=64, nb=3, gc=32 and
    ResDeconv(1,3) with GroupNorm (bench.py's sec_train_bf16 pair)."""
    from srcgan_tpu_torch.train.cas import CasTrainer

    return CasTrainer(sr_model="RDDBNet", c_model="ResDeconv", up=TRAIN_UP,
                      lr=TRAIN_LR, device=dev, **kw)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def cas_match(dst, src):
    """``dst`` (a CasState) holding ``src``'s parameters, buffers and Adam
    state (copied first: see ``gan_match``), for the next step of both."""
    for r in ("sr", "c"):
        getattr(dst, r).model.load_state_dict(getattr(src, r).model.state_dict())
        getattr(dst, r).opt.load_state_dict(copy.deepcopy(getattr(src, r).opt.state_dict()))
    return dst._replace(sr=dst.sr._replace(step=src.sr.step), c=dst.c._replace(step=src.c.step))


def phase_train_fp32(dev, make=None, tag="train", warmup=False):
    """One fp32 fused-input uint8 step (TF32 off) on the card against the
    CPU, batch 2 of 64^2: losses within rtol 1e-4; every tensor's gradient,
    and each network's Adam update, within rel-L2 5e-2 (the fp32 envelope of
    L1 gradients across backends, tests/test_training_dynamics.py).  A
    tensor's own first Adam update is lr * g / (|g| + eps), about +-lr per
    element, so one sign flip of a near-zero gradient in a 64-element
    GroupNorm bias moves it by rel-L2 0.25: that number is printed, not bound.
    ``make(device)`` builds the trainer (default: the training slice's).
    ``warmup``: the card first takes one step alone and the CPU's state
    becomes a copy of the card's (parameters, Adam's moments and count);
    the step compared is the second, from that one point, where Adam's
    update no longer is the sign of each gradient element (phase 12's
    procedure): for losses with more near-zero gradient elements, as
    distillation's blend of two L1 terms."""
    from srcgan_tpu_torch import config

    make = make or (lambda where: slice_trainer(where, fused_input=True))
    rng = np.random.default_rng(6)
    src, tar = (torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
                for _ in range(2))
    runs = []
    with config.precision("fp32"):
        trainers = {where: make(where) for where in ("cpu", dev)}
        states = {where: t.init(3) for where, t in trainers.items()}
        if warmup:
            states[dev], _ = trainers[dev].train_step_u8(states[dev], src.to(dev), tar.to(dev),
                                                         TRAIN_LR)
            states["cpu"] = cas_match(states["cpu"], states[dev])
        for where in ("cpu", dev):
            tr, state = trainers[where], states[where]
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
    print(f"[{tag}] fp32 step card vs CPU (batch 2, 64^2, TF32 off"
          f"{', the second from the card state' if warmup else ''}): losses "
          f"{m_card['loss_SR']:.6f}/{m_card['loss_C']:.6f} vs {m_cpu['loss_SR']:.6f}/"
          f"{m_cpu['loss_C']:.6f}, max rel {loss_err:.2e} (bound 1e-4); max per-tensor "
          f"gradient rel-L2 {grad_err:.2e} at {grad_at} (bound 5e-2); per-network update "
          f"rel-L2 {net_err:.2e} (bound 5e-2); max per-tensor update rel-L2 {upd_err:.2e} "
          f"at {upd_at} (not bound) {'PASS' if ok else 'FAIL'}")
    check(ok, f"the fp32 {tag} step on the card disagrees with the CPU")


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


def phase_eval(dev, card: str, lab: bool = False) -> int:
    """The evaluation path through the command-line tools (see the module
    docstring); with ``lab`` the LAB slice's: train_cas --lab, then test_cas
    on its @G2LAB checkpoints, at a smaller set and without the timings.
    Returns the ssim launches of the card's test_cas run."""
    from PIL import Image

    from srcgan_tpu_torch import config, data
    from srcgan_tpu_torch.cli import test_cas, train_cas
    from srcgan_tpu_torch.data import native, preprocess
    from srcgan_tpu_torch.metrics import per_sample_evaluators
    from srcgan_tpu_torch.ops.kernels import ssim_kernel as sk

    tag = "lab" if lab else "eval"
    n_train, n_test, batch = ((LAB_TRAIN, LAB_TEST, LAB_EVAL_BATCH) if lab
                              else (EVAL_TRAIN, EVAL_TEST, EVAL_BATCH))
    ver = "@G2LAB" if lab else ""
    print(f"[{tag}] PNG codec: {native.codec()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        data.make_synthetic_dataset(os.path.join(tmp, "Sat2Aerx1"), n_train=n_train,
                                    n_val=2, n_test=n_test, size=EVAL_HW, seed=0,
                                    colorizable=True)
        ck = os.path.join(tmp, "checkpoints")
        train_cas.main(["--data-dir", tmp, "--SRModel", "RDDBNet", "--CModel", "ResDeconv",
                        "--up", str(TRAIN_UP), "--batch-size", str(EVAL_BATCH), "--bf16-acts",
                        "--steps-per-dispatch", "2" if lab else "4", "--num-epochs", "1",
                        "--save-every", "1", "--log-every", "2" if lab else "4",
                        "--checkpoints", ck, "--run-dir", os.path.join(tmp, "run"),
                        *(["--lab"] if lab else [])])
        net_a = os.path.join(ck, f"RDDBNet{ver}_A2C_x{TRAIN_UP}_0001.npz")
        net_b = os.path.join(ck, f"ResDeconv{ver}_C2B_x{TRAIN_UP}_0001.npz")
        check(os.path.exists(net_a) and os.path.exists(net_b)
              and os.path.exists(os.path.join(ck, "casstate_latest.npz")),
              "train_cas left no checkpoints")
        print()

        def evaluate(result, *extra):
            return test_cas.main(["--netGA", net_a, "--netGB", net_b, "--data-dir", tmp,
                                  "--result-dir", os.path.join(tmp, result), "--batch-size",
                                  str(batch), "--precision", "highest", *extra])

        sk.launches = 0
        on_card = evaluate("result")
        launches = sk.launches
        n_batches = -(-n_test // batch)
        print(f"[{tag}] {on_card['images']} images in {on_card['batches']} batches on "
              f"{on_card['device']}, ssim launches {launches}")
        check(on_card["images"] == n_test and on_card["batches"] == n_batches
              and on_card["device"].startswith("cuda"), "the eval did not run on the card")
        check(launches == n_batches, "an eval batch did not call the ssim kernels exactly once")

        row = read_performs(os.path.join(tmp, "result"))
        means = {k: float(row[k]) for k in ("MSE", "PSNR", "AE", "SSIM")}
        check(all(math.isfinite(v) for v in means.values()), f"Performs.csv row {row}")
        for side in "AB":
            out = os.path.join(tmp, "result", f"{side}_RDDBNet_x{TRAIN_UP}_0001")
            names = sorted(os.listdir(out))
            check(len(names) == n_test, f"{out}: {len(names)} PNGs")
            for name in names:
                with Image.open(os.path.join(out, name)) as im:
                    check(im.size == (EVAL_HW, EVAL_HW) and im.mode == "RGB",
                          f"{name}: {im.size} {im.mode}")
        check(("@G2LAB" in row["checkpoint"]) == lab, f"checkpoint {row['checkpoint']}")
        print(f"[{tag}] Performs.csv row {row}; 2x{n_test} PNGs decode to "
              f"{EVAL_HW}^2 RGB PASS")

        on_cpu = evaluate("result_cpu", "--device", "cpu")
        d_psnr = abs(on_card["PSNR"] - on_cpu["PSNR"])
        d_ssim = abs(on_card["SSIM"] - on_cpu["SSIM"])
        rel = {k: abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k]) for k in ("MSE", "AE")}
        ok = d_psnr <= 0.01 and d_ssim <= 1e-4
        print(f"[{tag}] card vs CPU means: PSNR {on_card['PSNR']:.5f} vs {on_cpu['PSNR']:.5f} "
              f"(|d| {d_psnr:.2e}, bound 0.01 dB), SSIM {on_card['SSIM']:.6f} vs "
              f"{on_cpu['SSIM']:.6f} (|d| {d_ssim:.2e}, bound 1e-4), MSE rel "
              f"{rel['MSE']:.2e}, AE rel {rel['AE']:.2e} {'PASS' if ok else 'FAIL'}")
        check(ok, "the card's Performs.csv row disagrees with the CPU's")
        if lab:
            return launches

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


RDB5_FLOP_PER_PIXEL = 2 * 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)


def phase_rdb5(dev, card: str):
    """The RDB5 kernel in both forms against their plain versions.  Bounds:
    bf16 rel-L2 <= 2e-2 (bf16 staging of x1..x4 rounds differently where fp32
    sums differ in order), int8 rel-L2 <= 1e-2 (the JAX package's bounds for
    its Pallas kernel; the int8 form sums exact integers and rounds the same
    fp32 steps as its plain version, so no element is expected to differ)."""
    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.models.blocks import ResidualDenseBlock5, rdb5_schedule
    from srcgan_tpu_torch.ops.kernels import rdb5_kernel as rk
    from srcgan_tpu_torch.probes import common

    gen = torch.Generator().manual_seed(9)
    blk = ResidualDenseBlock5(64, 32).eval().requires_grad_(False)
    with torch.no_grad():
        for w, b in blk.convs():
            w.normal_(0, (2 / (9 * w.shape[0])) ** 0.5, generator=gen)    # kaiming, fan_out
            b.normal_(0, 0.1, generator=gen)       # the border mask only shows with biases
    blk.to(dev, memory_format=torch.channels_last)
    wb = rk.prep_bf16(blk.convs())
    worst = {"bf16": 0.0, "int8": 0.0}
    first = {}
    # the serving shape, a ragged height, the widest rows, and the tiles of a
    # phase-15 scene
    for shape in ((BATCH, LR, LR, NF), (1, 15, 128, NF), (2, 24, 512, NF),
                  (BATCH, TILE, TILE, NF)):
        x = (torch.rand(shape, generator=gen) * 2 - 0.5).to(dev)
        xb = x.bfloat16()
        with torch.no_grad(), config.precision("fp32"):
            fp32, cat = blk.forward_with_sources(x.permute(0, 3, 1, 2))
            fp32 = fp32.permute(0, 2, 3, 1)
        w8 = rk.prep_int8(blk.convs(), cat.abs().amax(dim=(0, 2, 3)))
        before = rk.launches_int8, rk.launches_bf16
        got8, got16 = rk.rdb5_int8_fused(x, w8), rk.rdb5_bf16_fused(xb, wb)
        torch.cuda.synchronize()
        check((rk.launches_int8, rk.launches_bf16) == (before[0] + 1, before[1] + 1),
              "an rdb5 wrapper did not launch its kernel")
        ref8, ref16 = rk.rdb5_int8_reference(x, w8), rk.rdb5_bf16_reference(xb, wb)
        for form, got, ref, bound in (("int8", got8, ref8, 1e-2), ("bf16", got16.float(),
                                                                   ref16.float(), 2e-2)):
            check(got.shape == ref.shape == shape and bool(torch.isfinite(got).all()),
                  f"rdb5_{form} {shape}: shape or not finite")
            rel, err = rel_l2(got, ref), (got - ref).abs().max().item()
            worst[form] = max(worst[form], err)
            print(f"[rdb5] rdb5_{form} {shape}: rel-L2 kernel vs plain = {rel:.3g} (bound "
                  f"{bound:g}), max|diff| {err:.3g}, {int((got != ref).sum())} of {got.numel()} "
                  f"elements differ; vs the fp32 block rel-L2 {rel_l2(got, fp32):.3g} "
                  f"{'PASS' if rel <= bound else 'FAIL'}")
            check(rel <= bound, f"rdb5_{form} {shape} disagrees with its plain version")
        if first:
            continue
        # times at the serving shape; the cuDNN block is the nn.Module itself
        n, h, w, _ = shape
        flop = RDB5_FLOP_PER_PIXEL * n * h * w
        blk16 = ResidualDenseBlock5(64, 32).eval().requires_grad_(False)
        blk16.load_state_dict(blk.state_dict())
        blk16.to(dev, torch.bfloat16, memory_format=torch.channels_last)
        xn, xbn = x.permute(0, 3, 1, 2), xb.permute(0, 3, 1, 2)
        # both forms and the cuDNN block in turns, so that one drift of the
        # host or the card cannot decide the comparison.  "naive" keeps the
        # module on cuDNN: under the default schedule an eval bf16 block on the
        # card would go through rdb5_bf16 itself
        with torch.no_grad(), rdb5_schedule("naive"):
            cudnn_tf32 = median_ms(lambda: blk(xn))
            count = rk.launches_bf16
            turns = in_turns_ms({"bf16": lambda: rk.rdb5_bf16_fused(xb, wb),
                                 "cudnn16": lambda: blk16(xbn),
                                 "int8": lambda: rk.rdb5_int8_fused(x, w8)}, rounds=4)
            check(rk.launches_bf16 - count == 4 * (WARMUP + REPS),
                  "the cuDNN block in bf16 went through the rdb5_bf16 kernel")
            with config.precision("fp32"):
                turns["cudnn32"] = in_turns_ms({"cudnn32": lambda: blk(xn)}, rounds=2,
                                               reps=10)["cudnn32"]
        cudnn16, cudnn32 = (statistics.median(turns[k]) for k in ("cudnn16", "cudnn32"))
        print(f"[rdb5] {shape} in turns, ms per round: rdb5_bf16 "
              f"{' / '.join(f'{t:.4f}' for t in turns['bf16'])}, the cuDNN block in bf16 "
              f"{' / '.join(f'{t:.4f}' for t in turns['cudnn16'])}, rdb5_int8 "
              f"{' / '.join(f'{t:.4f}' for t in turns['int8'])}")
        for form, fn, plain, xin, wts, lib in (
                ("int8", rk.rdb5_int8_fused, rk.rdb5_int8_reference, x, w8, cudnn32),
                ("bf16", rk.rdb5_bf16_fused, rk.rdb5_bf16_reference, xb, wb, cudnn16)):
            ms = statistics.median(turns[form])
            plain_ms = median_ms(lambda: plain(xin, wts), reps=5)
            on_device = common.device_us(lambda: fn(xin, wts), "rdb5_kernel")
            count = rk.launches_bf16
            with torch.no_grad(), rdb5_schedule("naive"), \
                    config.precision("bf16" if form == "bf16" else "fp32"):
                # every kernel of the cuDNN block (about fifteen launches) on the device
                lib_device = common.device_us(
                    (lambda: blk16(xbn)) if form == "bf16" else (lambda: blk(xn)), "")
            check(rk.launches_bf16 == count, "the cuDNN block went through the rdb5_bf16 kernel")
            vectors = (wts.sw, wts.rq, wts.bias) if form == "int8" else (wts.bias,)
            nbytes = 2 * tensor_bytes(xin) + tensor_bytes(wts.frag, *vectors)
            least = least_time(nbytes, flop, form)
            print(f"[rdb5] rdb5_{form} {shape} on {card}: wrapper {ms:.4f} ms "
                  f"({flop / ms / 1e9:.1f} T{'OP' if form == 'int8' else 'FLOP'}/s; the kernel "
                  f"on the device {'not measured' if on_device is None else f'{on_device:.1f} us'}"
                  f", profiler), plain version {plain_ms:.4f} ms; bound {least['bound_ms']:.4f} "
                  f"ms by {least['bound_by']} ({flop / 1e9:.1f} G{'OP' if form == 'int8' else 'FLOP'}"
                  f" at the {form} peak; {nbytes / 1e6:.2f} MB is "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms); the cuDNN block (nn.Module): bf16 "
                  f"{cudnn16:.4f} ms, fp32 TF32 off {cudnn32:.4f} ms, fp32 TF32 on "
                  f"{cudnn_tf32:.4f} ms; its kernels on the device, "
                  f"{'bf16' if form == 'bf16' else 'fp32 TF32 off'}: "
                  f"{'not measured' if lib_device is None else f'{lib_device:.1f} us'} (profiler)")
            first[form] = {"ms": ms, "plain_ms": plain_ms, **least, "library_ms": lib}
    small = torch.zeros(1, 16, 100, NF, device=dev)
    try:
        rk.rdb5_int8_fused(small, w8)
    except ValueError:
        pass
    else:
        raise SmokeFailure("rdb5 accepted a width its gate refuses")
    common = {"route": "cuda", "source": "srcgan_tpu_torch/csrc/rdb5.cu"}
    return ({"name": "rdb5_bf16", **common,
             "replaces": "srcgan_tpu/ops/pallas/rdb5_kernel.py:272",
             "max_abs_err": worst["bf16"], **first["bf16"]},
            {"name": "rdb5_int8", **common,
             "replaces": "srcgan_tpu/ops/pallas/rdb5_kernel.py:263",
             "max_abs_err": worst["int8"], **first["int8"]})


def phase_trunk(dev, card: str, sr, c) -> int:
    """The serving RDDBNet in bf16 with its nine blocks through rdb5_bf16
    (rdb5_schedule("fused"), and the forward with no schedule scoped, which on
    the card takes the kernel too), against the naive forward (cuDNN,
    rdb5_schedule("naive")): RDDBNet's output within rel-L2 2e-2, the
    cascade's uint8 output within the serve phase's 2 LSB mean.  Returns the
    rdb5_bf16 launches of one fused forward."""
    from srcgan_tpu_torch.models.blocks import rdb5_schedule
    from srcgan_tpu_torch.ops.kernels import rdb5_kernel as rk
    from srcgan_tpu_torch.serving import CascadePredictor

    pred = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True, device=dev)
    gray = np.random.default_rng(2).integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8)
    x = torch.from_numpy(gray).to(dev)
    xin = (x.float() / 255).permute(0, 3, 1, 2).to(torch.bfloat16,
                                                   memory_format=torch.channels_last)
    with torch.no_grad():
        rk.launches_bf16 = rk.launches_int8 = rk.reference_calls = 0
        with rdb5_schedule("naive"):
            plain = pred.sr_model(xin)
            u8_plain = pred._run(x)
        check(rk.launches_bf16 == 0, "rdb5_schedule(\"naive\") went through the kernel")
        unscoped = pred.sr_model(xin)
        torch.cuda.synchronize()
        by_default = rk.launches_bf16
        rk.launches_bf16 = 0
        with rdb5_schedule("fused"):
            fused = pred.sr_model(xin)
            torch.cuda.synchronize()
            launches = rk.launches_bf16
            u8_fused = pred._run(x)
        # in turns: the naive forward enqueues ~15 launches per block and is
        # close to host-bound, so its time drifts with the host
        times = {"fused": [], "naive": []}
        for sched in ("naive", "fused", "fused", "naive"):
            with rdb5_schedule(sched):
                times[sched].append(median_ms(lambda: pred.sr_model(xin)))
        unscoped_ms = median_ms(lambda: pred.sr_model(xin))
    check(launches == 9 and rk.reference_calls == 0,
          f"a fused-schedule forward launched rdb5_bf16 {launches} times, not 9")
    check(by_default == 9 and torch.equal(unscoped, fused),
          f"the forward with no schedule scoped launched rdb5_bf16 {by_default} times, not 9, "
          "or differs from the fused schedule's")
    rel = rel_l2(fused.float(), plain.float())
    lsb = (u8_fused.int() - u8_plain.int()).abs().float().mean().item()
    ok = rel <= 2e-2 and lsb <= 2
    print(f"[trunk] RDDBNet x4 bf16, batch {BATCH} of {LR}^2 on {card}: {launches} rdb5_bf16 "
          f"launches per forward (under rdb5_schedule(\"fused\") and with no schedule scoped); fused vs "
          f"naive forward rel-L2 {rel:.3g} (bound 2e-2), cascade uint8 mean|diff| {lsb:.4f} LSB "
          f"(bound 2); in turns, fused {' / '.join(f'{t:.3f}' for t in times['fused'])} ms, "
          f"naive (cuDNN) {' / '.join(f'{t:.3f}' for t in times['naive'])} ms; no schedule "
          f"scoped {unscoped_ms:.3f} ms {'PASS' if ok else 'FAIL'}")
    check(ok, "the fused-schedule trunk strays from the naive forward")
    return launches


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-9)))


def phase_int8(dev, card: str, sr, c) -> int:
    """The int8 serving path at full width (see the module docstring).
    Returns the rdb5_int8 launches of its forwards."""
    from srcgan_tpu_torch import config, quant
    from srcgan_tpu_torch.ops.kernels import rdb5_kernel as rk
    from srcgan_tpu_torch.serving import CascadePredictor

    rng = np.random.default_rng(10)
    gray, other = (rng.integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8) for _ in range(2))
    pred = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, int8=True,
                            pad_batch_to=BATCH, device=dev)
    try:
        pred.predict(gray)
    except RuntimeError as e:
        check("calibrate" in str(e), f"predict before calibrate raised {e!r}")
    else:
        raise SmokeFailure("an int8 predictor answered before calibrate()")
    try:
        pred.reload_checkpoints("RDDBNet_A2C_x4_0001.npz", "ResDeconv_C2B_x4_0001.npz")
    except ValueError:
        pass
    else:
        raise SmokeFailure("an int8 predictor accepted a hot reload")
    pred.calibrate([gray, other])
    n_rdb5 = sum(1 for v in pred.int8_scales.values() if v.shape == (192,))
    print(f"[int8] calibrated {len(pred.int8_scales)} callsites on 2 batches, {n_rdb5} of them "
          f"fused RDB5 blocks")
    check(n_rdb5 == 9, "the nine RDB5 blocks are not one callsite each")

    rk.launches_bf16 = rk.launches_int8 = rk.reference_calls = 0
    y = pred.predict(gray)
    y_again = pred.predict(gray)
    y3 = pred.predict(gray[:3])                  # ragged: padded to 8 with the last row
    launches, forwards = rk.launches_int8, 3
    print(f"[int8] {forwards} forwards, rdb5_int8 launches {launches}, plain-version runs "
          f"{rk.reference_calls}")
    check(launches == 9 * forwards and rk.reference_calls == 0 and rk.launches_bf16 == 0,
          "an int8 forward did not go through the rdb5_int8 kernel nine times")
    full = (BATCH, 4 * LR, 4 * LR, 3)
    check(y.shape == full and y.dtype == np.uint8 and len(np.unique(y)) > 1,
          f"int8 output {y.shape} {y.dtype}")
    check(np.array_equal(y, y_again), "two int8 predicts of one batch differ")
    d3 = np.abs(y3.astype(int) - y[:3].astype(int)).max()
    check(d3 <= 1, f"padded int8 rows differ from the unpadded ones by {d3}")

    # the second forward waits for nothing and copies nothing from the host
    x = torch.from_numpy(gray).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with quant.quant_mode("int8", pred.int8_scales, pred._int8_prepared):
            pred._run(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[int8] a later forward makes no synchronizing call: PASS")

    # the RDDBNet stage alone against fp32 (its callsites are the table's first)
    xin = (x.float() / 255).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad(), config.precision("fp32"):
        sr_fp32 = pred.sr_model(xin)
        with quant.quant_mode("int8", pred.int8_scales, {}):
            sr_int8 = pred.sr_model(xin)
    rel = rel_l2(sr_int8, sr_fp32)
    fp32 = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device=dev)
    bf16 = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True, device=dev)
    y_fp32 = fp32.predict(gray)
    lsb = np.abs(y.astype(int) - y_fp32.astype(int)).mean()
    print(f"[int8] RDDBNet stage int8 vs fp32: rel-L2 {rel:.4f} (bound 0.1) "
          f"{'PASS' if rel <= 0.1 else 'FAIL'}; cascade uint8 int8 vs fp32: PSNR "
          f"{psnr_u8(y, y_fp32):.2f} dB, mean|diff| {lsb:.3f} LSB (random weights; not bound)")
    check(rel <= 0.1, "the int8 RDDBNet stage strays from fp32")

    # the card against the CPU on one calibration table, at a small supported
    # shape.  The integer arithmetic is the same on both; the fp32 layers
    # between the convolutions sum in other orders, and one flipped
    # requantization round is 1/127 of a channel's range, so the two int8
    # outputs are held to be closer to each other than int8 is to fp32.
    small = rng.integers(0, 256, (1, 16, 128, 1), dtype=np.uint8)
    card_small = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, int8=True, device=dev)
    cpu_small = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, int8=True, device="cpu")
    card_small.calibrate([small])
    cpu_small.int8_scales = card_small.int8_scales
    a, b = card_small.predict(small).astype(int), cpu_small.predict(small).astype(int)
    d, noise = np.abs(a - b), np.abs(a - fp32.predict(small).astype(int)).mean()
    ok = d.mean() <= noise
    print(f"[int8] card vs CPU, int8 on one table, (1,16,128,1): mean|diff| {d.mean():.4f} LSB, "
          f"max {d.max()} (bound: the int8-vs-fp32 mean|diff| there, {noise:.4f} LSB) "
          f"{'PASS' if ok else 'FAIL'}")
    check(ok, "int8 on the card is further from int8 on the CPU than from fp32")

    def int8_forward(fn, arg):
        # one quant_mode block per forward: the callsite counter starts at 0
        with torch.no_grad(), config.precision("fp32"), quant.quant_mode(
                "int8", pred.int8_scales, pred._int8_prepared):
            return fn(arg)

    mp = BATCH * (4 * LR) ** 2 / 1e6
    int8_ms = median_ms(lambda: int8_forward(pred._run, x), reps=10)
    sr_ms = median_ms(lambda: int8_forward(pred.sr_model, xin), reps=10)
    fp32_ms = median_ms(lambda: fp32._run(x), reps=10)
    bf16_ms = median_ms(lambda: bf16._run(x), reps=10)
    print(f"[int8] steady batch-{BATCH} {LR}^2 -> {4 * LR}^2 on {card}: int8 cascade "
          f"{int8_ms:.3f} ms = {mp / int8_ms * 1e3:.2f} MP/s (RDDBNet alone {sr_ms:.3f} ms); "
          f"fp32 (TF32 off) {fp32_ms:.3f} ms = {mp / fp32_ms * 1e3:.2f} MP/s; bf16 "
          f"{bf16_ms:.3f} ms = {mp / bf16_ms * 1e3:.2f} MP/s")
    by_kernel = int8_profile(pred, x)
    if by_kernel:
        print("[int8] device time of one int8 forward by kernel (profiler): "
              + "; ".join(f"{name} {us / 1e3:.2f} ms" for name, us in by_kernel))
    return launches


def int8_profile(pred, x, top: int = 6):
    """The largest device-time entries of one int8 forward, (name, microseconds)."""
    from torch import profiler

    from srcgan_tpu_torch import quant

    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as prof:
        with quant.quant_mode("int8", pred.int8_scales, pred._int8_prepared):
            pred._run(x)
        torch.cuda.synchronize()
    rows = [(e.key[:60], getattr(e, "self_device_time_total", 0)) for e in prof.key_averages()]
    return sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])[:top]


def probe_entry(name: str, line: int, worst: float, timed: dict) -> dict:
    script = {"probe_matmul": "scripts/pallas_matmul_probe.py",
              "probe_mxu": "scripts/pallas_mxu_probe.py"}.get(name, "scripts/pallas_layout_probe3.py")
    return {"name": name, "route": "cuda", "source": "srcgan_tpu_torch/csrc/probes.cu",
            "replaces": f"{script}:{line}", "max_abs_err": worst, **timed}


def phase_probes(dev, card: str) -> list:
    """The six probe kernels against their plain versions at their full
    shapes, with times and bounds; then the sweeps through the entry points.
    Bounds: int8 forms and the roll bit-equal; bf16 dots rel-L2 <= 1e-3 on
    fp32 outputs (fp32 sums in another order), <= 1e-2 on probe_matmul's bf16
    output (one bf16 rounding of the sum).  A kernel's time is a CUDA graph of
    its launches replayed between events (the host's enqueue time is not in
    it); the time in the kernels line is one whole call (all its dependent
    steps).  Returns the six entries of the kernels line."""
    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.ops.kernels import build, probe_kernels as pk
    from srcgan_tpu_torch.probes import __main__ as probes_main
    from srcgan_tpu_torch.probes import common, layout_probe3, matmul_probe, mxu_probe

    bf16, int8 = torch.bfloat16, torch.int8
    rng = np.random.default_rng(11)
    worst = dict.fromkeys(pk.NAMES, 0.0)
    timed, timed_int8, timed_shifted, timed_twodots, timed_shift1 = {}, {}, {}, {}, {}

    def compare(name, label, got, ref, bound):
        """bound None: bit-equal; else rel-L2 in float64."""
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.dtype == ref.dtype, f"{name} {label}: shape or type")
        err = (got.double() - ref.double()).abs().max().item()
        worst[name] = max(worst[name], err)
        if bound is None:
            bad = int((got != ref).sum())
            print(f"[probes] {name} {label}: {bad} of {got.numel()} elements differ from the "
                  f"plain version (bound 0) {'PASS' if bad == 0 else 'FAIL'}")
            check(bad == 0, f"{name} {label} is not bit-equal to its plain version")
        else:
            rel = rel_l2(got.double(), ref.double())
            print(f"[probes] {name} {label}: rel-L2 kernel vs plain = {rel:.3g} (bound {bound:g}), "
                  f"max|diff| {err:.3g} {'PASS' if rel <= bound else 'FAIL'}")
            check(rel <= bound, f"{name} {label} disagrees with its plain version")

    def times(name, label, fn, plain, nbytes, ops, dtype, lib=None, steps=1, into=timed):
        ms = common.graph_ms([fn] * 4)
        with config.precision("fp32"):
            plain_ms = median_ms(plain, reps=5)
        lib_ms = None if lib is None else common.graph_ms([lib] * 4)
        least = least_time(nbytes, ops, dtype)
        unit = "TOP/s" if dtype == "int8" else "TFLOP/s"
        print(f"[probes] {name} {label} on {card}: {ms:.4f} ms per call of {steps} step(s)"
              + (f" ({ops / ms / 1e9:.1f} {unit})" if ops else f" ({steps * nbytes / ms / 1e6:.0f} GB/s over the steps)")
              + f", plain version {plain_ms:.4f} ms, "
              + ("no single PyTorch call" if lib_ms is None else f"the PyTorch call {lib_ms:.4f} ms")
              + f"; bound {least['bound_ms']:.5f} ms by {least['bound_by']}")
        into[name] = {"ms": ms, "plain_ms": plain_ms, **least, "library_ms": lib_ms}

    def pair(m, k, n, dtype):
        x, w = common.operand(rng, (m, k), dtype, dev), common.operand(rng, (k, n), dtype, dev)
        if dtype == int8:
            common.alternate_int8(x, w)        # the chain takes both operands
        return x, w

    with config.precision("fp32"):             # the plain versions' fp32 matmuls: TF32 off
        # 6a probe_matmul: the smallest and the largest (K, N), both types
        for dtype, tname in ((bf16, "bf16"), (int8, "int8")):
            for k, n in ((64, 64), (576, 192)):
                x, w = pair(PROBE_M, k, n, dtype)
                before = pk.launches["probe_matmul"]
                got = pk.probe_matmul(x, w)
                check(pk.launches["probe_matmul"] == before + 1, "probe_matmul did not launch")
                compare("probe_matmul", f"{tname} M={PROBE_M} K={k} N={n}", got,
                        pk.probe_matmul_reference(x, w), None if dtype == int8 else 1e-2)
                if (k, n) == (576, 192) and dtype == bf16:
                    times("probe_matmul", f"bf16 K={k} N={n}", lambda: pk.probe_matmul(x, w),
                          lambda: pk.probe_matmul_reference(x, w), tensor_bytes(x, w, got),
                          2 * PROBE_M * k * n, "bf16", lib=lambda: torch.matmul(x, w))
                elif (k, n) == (576, 192):      # the int8 form, beside torch._int_mm (int32 out)
                    times("probe_matmul", f"int8 K={k} N={n}", lambda: pk.probe_matmul(x, w),
                          lambda: pk.probe_matmul_reference(x, w), tensor_bytes(x, w, got),
                          2 * PROBE_M * k * n, "int8", lib=lambda: torch._int_mm(x, w),
                          into=timed_int8)
        # probe_matmul's int8 form at every shape of the sweep: bit-equal (the
        # cast wraps), then in turns with PR 5's design and torch._int_mm
        # (int32 out), x from HBM (copies rotating as the sweep has them)
        first = pk.declare(build.load(*YARDSTICKS[2]))
        for k in matmul_probe.DEPTHS:
            for n in matmul_probe.WIDTHS:
                x, w = pair(PROBE_M, k, n, int8)
                got = pk.probe_matmul(x, w)
                full = pk._dot(x, w)
                check(bool((full.abs() > 127).any()), "the int8 sums never leave int8")
                compare("probe_matmul", f"int8 M={PROBE_M} K={k} N={n} (the cast wraps)", got,
                        full.to(int8), None)
                check(torch.equal(pk.matmul_int8(first, x, w), got),
                      f"probe_matmul int8 K={k} N={n}: PR 5's design disagrees")
                xs = [x.clone() for _ in range(matmul_probe.copies(PROBE_M, k, n))]
                calls = {"kernel": [lambda v=v: pk.probe_matmul(v, w) for v in xs],
                         "PR 5 design": [lambda v=v: pk.matmul_int8(first, v, w) for v in xs],
                         "torch._int_mm": [lambda v=v: torch._int_mm(v, w) for v in xs]}
                rounds, order = {key: [] for key in calls}, list(calls)
                for _ in range(2):
                    for key in order:
                        rounds[key].append(common.graph_ms(calls[key]) * 1e3)
                    order.reverse()
                bound = (PROBE_M * k + k * n + PROBE_M * n) / HBM_BYTES_PER_S * 1e6
                print(f"[probes] probe_matmul int8 K={k} N={n} x from HBM in turns on {card}, us "
                      f"a call: " + "; ".join(f"{key} {' / '.join(f'{t:.2f}' for t in v)}"
                                              for key, v in rounds.items())
                      + f"; bound {bound:.3f} us by bytes")
                check(max(rounds["kernel"]) < min(rounds["torch._int_mm"]),
                      f"probe_matmul int8 K={k} N={n} is slower than torch._int_mm")
                del xs
        # probe_matmul's bf16 form, its ablation build and torch.matmul in
        # turns, graph timing: the same x every launch (warm in L2), then
        # copies of x rotating over three times the L2 (read from HBM)
        x, w = pair(PROBE_M, 576, 192, bf16)
        xs = [x.clone() for _ in range(-(-3 * common.L2_BYTES // tensor_bytes(x)))]
        loads = pk.declare(build.load(*YARDSTICKS[1]))
        fns = {"kernel": pk.probe_matmul,
               "loads and stores only": lambda v, u: pk.matmul_bf16(loads, v, u),
               "torch.matmul": torch.matmul}
        calls = {f"{k}, {where}": ([lambda f=f: f(x, w)] * 4 if where == "x in L2"
                                   else [lambda f=f, v=v: f(v, w) for v in xs])
                 for where in ("x in L2", "x from HBM") for k, f in fns.items()}
        rounds, order = {k: [] for k in calls}, list(calls)
        for _ in range(4):
            for k in order:
                rounds[k].append(common.graph_ms(calls[k]))
            order.reverse()
        print(f"[probes] probe_matmul bf16 K=576 N=192 against torch.matmul in turns on {card}, "
              f"ms per call in 4 rounds: " + "; ".join(
                  f"{k} {' / '.join(f'{t:.4f}' for t in v)}" for k, v in rounds.items()))
        del xs
        # 6b/6c probe_mxu (both types) and probe_dots: 16 dependent dots through
        # the chain kernel at every shape of their sweeps, against the plain
        # version, three calls bit-equal, then in turns with the first design
        fns = {"probe_mxu": (pk.probe_mxu, pk.probe_mxu_reference),
               "probe_dots": (pk.probe_dots, pk.probe_dots_reference)}
        sweep = [("probe_mxu", MXU_M, k, n, dt) for dt in (bf16, int8) for k, n in mxu_probe.SHAPES]
        sweep += [("probe_dots", PROBE_M, k, n, bf16) for k, n in layout_probe3.DOT_SHAPES]
        for name, m, k, n, dtype in sweep:
            x, w = pair(m, k, n, dtype)
            fn, plain = fns[name]
            tname = "int8" if dtype == int8 else "bf16"
            label = f"{tname} M={m} K={k} N={n}"
            got = [fn(x, w, 16) for _ in range(3)]
            compare(name, label, got[0], plain(x, w, 16), None if dtype == int8 else 1e-3)
            check(all(torch.equal(g, got[0]) for g in got[1:]),
                  f"{name} {label}: three calls are not bit-equal")
            if dtype == int8:
                check(not torch.equal(got[0], 16 * pk._dot(x, w)),
                      "the int8 chain never switched operands")
            before = pk.chain(first, name, x, w, 16)
            torch.cuda.synchronize()
            agree = (torch.equal(before, got[0]) if dtype == int8
                     else rel_l2(before.double(), got[0].double()) <= 1e-3)
            check(agree, f"{name} {label}: the first design disagrees with the chain kernel")
            turns = {"chain kernel": [], "first design": []}
            calls = {"chain kernel": lambda: fn(x, w, 16),
                     "first design": lambda: pk.chain(first, name, x, w, 16)}
            for order in (("chain kernel", "first design"), ("first design", "chain kernel")):
                for key in order:
                    turns[key].append(common.graph_ms([calls[key]] * 4))
            print(f"[probes] {name} {label} in turns on {card}, us a call of 16 dots: chain kernel "
                  f"{' / '.join(f'{t * 1e3:.2f}' for t in turns['chain kernel'])}, first design "
                  f"{' / '.join(f'{t * 1e3:.2f}' for t in turns['first design'])}")
            table = (k, n) == ((576, 192) if name == "probe_mxu" else (64, 192))
            if table:
                times(name, label, lambda: fn(x, w, 16), lambda: plain(x, w, 16),
                      tensor_bytes(x, w, got[0]), 16 * 2 * m * k * n, tname, steps=16,
                      into=timed_int8 if dtype == int8 else timed)
            if (k, n) == (576, 192):
                # the dots are executed, not hoisted: the time grows with their number
                t16, t48 = (common.graph_ms([lambda b=b: fn(x, w, b)] * 4) for b in (16, 48))
                per = (t48 - t16) / 32
                print(f"[probes] {name} {tname} K={k} N={n} on {card}: 16 dots {t16:.4f} ms, "
                      f"48 dots {t48:.4f} ms: {per * 1e3:.2f} us per added dot = "
                      f"{common.rate(2 * m * k * n, per):.1f} "
                      f"{'TOP/s' if dtype == int8 else 'TFLOP/s'}")
                check(t48 > 2 * t16, f"{name}'s time does not grow with its dots")
        # 6d probe_concat_dot: both forms against their plain versions, three
        # calls bit-equal, the first design agreeing; then both in turns with it
        a, w = pair(PROBE_M, 64, 192, bf16)
        w = torch.cat([w, pair(1, 64, 192, bf16)[1]])
        outs = {}
        for form in pk.CONCAT_FORMS:
            got = [pk.probe_concat_dot(a, w, 8, form) for _ in range(3)]
            compare("probe_concat_dot", f"{form} M={PROBE_M} N=192", got[0],
                    pk.probe_concat_dot_reference(a, w, 8, form), 1e-3)
            check(all(torch.equal(g, got[0]) for g in got[1:]),
                  f"probe_concat_dot {form}: three calls are not bit-equal")
            old = pk.concat(first, a, w, 8, form)
            torch.cuda.synchronize()
            check(rel_l2(old.double(), got[0].double()) <= 1e-3,
                  f"probe_concat_dot {form}: the first design disagrees")
            outs[form] = got[0]
        print(f"[probes] probe_concat_dot: concat and twodots bit-equal "
              f"{torch.equal(outs['concat'], outs['twodots'])} (one instruction stream)")
        calls = {f"{form}, {label}": (lambda f=form, lib=lib: pk.concat(lib, a, w, 8, f))
                 for form in pk.CONCAT_FORMS for label, lib in (("kernel", pk._library()),
                                                                 ("first design", first))}
        rounds, order = {key: [] for key in calls}, list(calls)
        for _ in range(2):
            for key in order:
                rounds[key].append(common.graph_ms([calls[key]] * 4) * 1e3)
            order.reverse()
        print(f"[probes] probe_concat_dot in turns on {card}, us a call of 8 steps: "
              + "; ".join(f"{key} {' / '.join(f'{t:.2f}' for t in v)}" for key, v in rounds.items()))
        for form in pk.CONCAT_FORMS:
            check(max(rounds[f"{form}, kernel"]) < min(rounds[f"{form}, first design"]),
                  f"probe_concat_dot {form} is slower than the first design")
        for form in pk.CONCAT_FORMS:
            times("probe_concat_dot", f"{form} N=192", lambda f=form: pk.probe_concat_dot(a, w, 8, f),
                  lambda f=form: pk.probe_concat_dot_reference(a, w, 8, f), tensor_bytes(a, w, got[0]),
                  8 * 2 * PROBE_M * 128 * 192, "bf16", steps=8,
                  into=timed if form == "concat" else timed_twodots)
        # 6e probe_roll: bit-equal at shifts 1 and 128 (and 0, M - 1), with
        # values where the added constant shows, three calls bit-equal, the first
        # design bit-equal; both shifts in turns with it; each roll past the
        # 16th adds no less than a pass through shared memory can take
        a[0, :3] = torch.tensor([0.0, 1e-8, -1e-8], device=dev).bfloat16()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        mhz = common.max_sm_clock_mhz(dev)
        for shift in (1, 128, 0, PROBE_M - 1):
            ref = pk.probe_roll_reference(a, shift, 16).view(torch.int16)
            got = [pk.probe_roll(a, shift, 16) for _ in range(3)]
            compare("probe_roll", f"shift {shift} ({PROBE_M},64)", got[0].view(torch.int16), ref, None)
            check(all(torch.equal(g, got[0]) for g in got[1:]),
                  f"probe_roll shift {shift}: three calls are not bit-equal")
            check(torch.equal(pk.roll(first, a, shift, 16).view(torch.int16), ref),
                  f"probe_roll shift {shift}: the first design disagrees")
        plan = pk.roll_plan(PROBE_M, 64, 128)
        passes = 16 * 2 * tensor_bytes(a) / (min(plan["blocks"], sms) * 128 * mhz * 1e6) * 1e3
        print(f"[probes] probe_roll plan at shift 128: {plan}; 16 passes of 4 MB through the "
              f"shared memory of {min(plan['blocks'], sms)} SMs at 128 B a cycle, {mhz} MHz: "
              f"{passes * 1e3:.3f} us")
        calls = {f"shift {shift}, {label}": (lambda s=shift, lib=lib: pk.roll(lib, a, s, 16))
                 for shift in (1, 128) for label, lib in (("kernel", pk._library()),
                                                          ("first design", first))}
        rounds, order = {key: [] for key in calls}, list(calls)
        for _ in range(2):
            for key in order:
                rounds[key].append(common.graph_ms([calls[key]] * 4) * 1e3)
            order.reverse()
        print(f"[probes] probe_roll in turns on {card}, us a call of 16 rolls: "
              + "; ".join(f"{key} {' / '.join(f'{t:.2f}' for t in v)}" for key, v in rounds.items()))
        for shift in (1, 128):
            check(max(rounds[f"shift {shift}, kernel"]) < min(rounds[f"shift {shift}, first design"]),
                  f"probe_roll shift {shift} is slower than the first design")
            t16, t48 = (common.graph_ms([lambda b=b: pk.probe_roll(a, shift, b)] * 4) for b in (16, 48))
            per = (t48 - t16) / 32
            print(f"[probes] probe_roll shift {shift} on {card}: 16 rolls {t16 * 1e3:.2f} us, 48 rolls "
                  f"{t48 * 1e3:.2f} us: {per * 1e3:.3f} us per added roll (a pass through shared "
                  f"memory: {passes / 16 * 1e3:.3f} us at least)")
            check(per >= passes / 16, f"probe_roll shift {shift}: a roll took less than a pass")
        # torch.roll is the PyTorch call beside it: ONE call does one of the 16 steps
        for shift in (128, 1):
            times("probe_roll", f"shift {shift}", lambda s=shift: pk.probe_roll(a, s, 16),
                  lambda s=shift: pk.probe_roll_reference(a, s, 16), 2 * tensor_bytes(a), 0, "bf16",
                  lib=lambda s=shift: torch.roll(a, s, dims=0), steps=16,
                  into=timed if shift == 128 else timed_shift1)
        timed["probe_roll"]["passes_bound_ms"] = passes
        timed_shift1["probe_roll"]["passes_bound_ms"] = passes
        # 6f probe_stage1: both forms against the one plain version at the
        # sweep's stride and at 16, three calls bit-equal; then in turns with
        # PR 5's design
        x, w = pair(PROBE_M, 64, 192, bf16)[0], pair(576, 576, 192, bf16)[1]
        for stride in (128, 16):
            ref = pk.probe_stage1_reference(x, w, 4, stride)
            for form in pk.STAGE1_FORMS:
                got = [pk.probe_stage1(x, w, 4, stride, form) for _ in range(3)]
                compare("probe_stage1", f"{form} M={PROBE_M} stride {stride}", got[0], ref, 1e-3)
                check(all(torch.equal(g, got[0]) for g in got[1:]),
                      f"probe_stage1 {form} stride {stride}: three calls are not bit-equal")
                old = pk.stage1(first, x, w, 4, stride, form)
                torch.cuda.synchronize()
                check(rel_l2(old.double(), got[0].double()) <= 1e-3,
                      f"probe_stage1 {form} stride {stride}: PR 5's design disagrees")
        calls = {f"{form}, {label}": (lambda f=form, lib=lib: pk.stage1(lib, x, w, 4, 128, f))
                 for form in pk.STAGE1_FORMS for label, lib in (("kernel", pk._library()),
                                                                 ("first design", first))}
        rounds, order = {key: [] for key in calls}, list(calls)
        for _ in range(2):
            for key in order:
                rounds[key].append(common.graph_ms([calls[key]] * 4) * 1e3)
            order.reverse()
        print(f"[probes] probe_stage1 stride 128 in turns on {card}, us a call of 4 stages: "
              + "; ".join(f"{key} {' / '.join(f'{t:.2f}' for t in v)}" for key, v in rounds.items()))
        for form in pk.STAGE1_FORMS:
            check(max(rounds[f"{form}, kernel"]) < min(rounds[f"{form}, first design"]),
                  f"probe_stage1 {form} is slower than PR 5's design")
        for form in pk.STAGE1_FORMS:
            times("probe_stage1", form, lambda f=form: pk.probe_stage1(x, w, 4, 128, f),
                  lambda: pk.probe_stage1_reference(x, w, 4, 128), tensor_bytes(x, w, got[0]),
                  4 * 2 * PROBE_M * 576 * 192, "bf16", steps=4,
                  into=timed if form == "im2col" else timed_shifted)

    # the main path of this slice: the three sweeps through their entry points
    for name in pk.NAMES:
        pk.launches[name] = 0
    pk.matmul_int8_launches = 0
    rows = probes_main.main([])
    counts, int8_launches = dict(pk.launches), pk.matmul_int8_launches
    print(f"[probes] sweeps: {', '.join(f'{k} {len(v)} lines' for k, v in rows.items())}; "
          f"launches {counts}, of probe_matmul's {int8_launches} int8")
    int8_rows = [r for r in rows["matmul"] if r["dtype"] == "int8"]
    print("[probes] probe_matmul int8 launches a shape (K, N): "
          + ", ".join(f"({r['K']}, {r['N']}) {r['launches']}" for r in int8_rows))
    check(int8_launches > 0 and sum(r["launches"] for r in int8_rows) == int8_launches,
          "the matmul sweep's int8 shapes did not launch the int8 kernel as counted")
    check(len(rows["matmul"]) == 18 and len(rows["mxu"]) == 8 and len(rows["layout"]) == 12,
          "a sweep printed fewer lines than its script's")
    check(all(counts[name] > 0 for name in pk.NAMES), "a sweep did not reach its kernel")
    lines = {"probe_matmul": 29, "probe_mxu": 23, "probe_dots": 66, "probe_concat_dot": 103,
             "probe_roll": 154, "probe_stage1": 186}
    # the int8 forms' readings (and probe_matmul's int8 launches), the shifted
    # form of probe_stage1, twodots and the roll at shift 1 ride in their
    # probes' entries
    timed_int8["probe_matmul"]["launches"] = int8_launches
    extra = {"int8": timed_int8, "shifted": timed_shifted, "twodots": timed_twodots,
             "shift1": timed_shift1}
    return [{**probe_entry(name, lines[name], worst[name], timed[name]), "launches": counts[name],
             **{key: d[name] for key, d in extra.items() if name in d}}
            for name in pk.NAMES]


def lab_cascade(gen):
    """Full-width RDDBNet(1,1,4) and the 2-channel ResDeconv(1,2), GroupNorm."""
    from srcgan_tpu_torch import models

    sr = models.RDDBNet(1, 1, 4, generator=gen)
    c = models.ResDeconv(1, 2, generator=gen)
    with torch.no_grad():
        c.pred.weight.mul_(PRED_SCALE)
    return sr, c


def phase_lab(dev, card: str, rgb_sr, rgb_c, x_small) -> dict:
    """The LAB slice at full width (see the module docstring).  Returns its
    launch counts: tail_x4 over the bf16 forwards, ssim over the eval."""
    from srcgan_tpu_torch.ops import color
    from srcgan_tpu_torch.ops.kernels import rdb5_kernel, tail_kernel
    from srcgan_tpu_torch.serving import CascadePredictor

    sr, c = lab_cascade(torch.Generator().manual_seed(12))
    on_cpu = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, lab=True, device="cpu")
    on_card = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, lab=True, device=dev)
    a, b = on_cpu.predict(x_small).astype(int), on_card.predict(x_small).astype(int)
    diff = np.abs(a - b).max()
    print(f"[lab] fp32 LAB predictor, card vs CPU, (2,32,32,1) uint8: max|diff| = {diff} "
          f"(bound 1), {len(np.unique(b))} distinct values {'PASS' if diff <= 1 else 'FAIL'}")
    check(diff <= 1 and len(np.unique(b)) > 1, "the LAB cascade on the card disagrees with the CPU")

    pred = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, lab=True, bf16=True,
                            pad_batch_to=BATCH, device=dev)
    rgb = CascadePredictor(copy.deepcopy(rgb_sr), copy.deepcopy(rgb_c), 4, bf16=True, device=dev)
    rng = np.random.default_rng(13)
    gray = rng.integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8)
    tail_kernel.launches = tail_kernel.finish_launches = rdb5_kernel.launches_bf16 = 0
    y, y3 = pred.predict(gray), pred.predict(gray[:3])
    ys = list(pred.predict_stream(iter([gray, gray]), lookahead=2))
    tail_launches, blocks, forwards = tail_kernel.launches, rdb5_kernel.launches_bf16, 4
    finishes = tail_kernel.finish_launches
    print(f"[lab] {forwards} bf16 LAB forwards, tail_x4 launches {tail_launches} (finish "
          f"{finishes}), rdb5_bf16 launches {blocks}")
    check(tail_launches == finishes == forwards,
          "a bf16 LAB forward did not go through the tail's main kernel and finish once each")
    check(blocks == 9 * forwards, "a bf16 LAB forward did not run its nine RDB5 blocks through "
          "the rdb5_bf16 kernel")
    full = (BATCH, 4 * LR, 4 * LR, 3)
    check(y.shape == full and y.dtype == np.uint8 and len(np.unique(y)) > 1,
          f"LAB output {y.shape} {y.dtype}")
    check(np.abs(y3.astype(int) - y[:3].astype(int)).max() <= 1, "padded LAB rows differ")
    check(all(np.array_equal(s, y) for s in ys), "LAB predict_stream differs from predict")
    small = pred.predict(x_small).astype(int)
    bf_diff = np.abs(small - b).mean()
    print(f"[lab] bf16 vs fp32 LAB on the card, (2,32,32,1): mean|diff| = {bf_diff:.4f} LSB "
          f"(not bound: the gamma curve is steep near black)")

    x = torch.from_numpy(gray).to(dev)
    times = {"lab": [], "rgb": []}
    for which in ("rgb", "lab", "lab", "rgb"):
        fn = pred._run if which == "lab" else rgb._run
        times[which].append(median_ms(lambda: fn(x)))
    lab_img = torch.rand(BATCH, 4 * LR, 4 * LR, 3, device=dev)
    colour_ms = median_ms(lambda: color.lab_norm_to_rgb(lab_img))
    lab_ms = statistics.median(times["lab"])
    mp = BATCH * (4 * LR) ** 2 / 1e6
    print(f"[lab] steady batch-{BATCH} {LR}^2 -> {4 * LR}^2 bf16 on {card}, in turns: LAB cascade "
          f"{' / '.join(f'{t:.3f}' for t in times['lab'])} ms = {mp / lab_ms * 1e3:.2f} MP/s, RGB "
          f"cascade {' / '.join(f'{t:.3f}' for t in times['rgb'])} ms; lab_norm_to_rgb alone on "
          f"({BATCH},{4 * LR},{4 * LR},3) fp32 {colour_ms:.4f} ms = "
          f"{100 * colour_ms / lab_ms:.2f}% of the LAB forward")
    del pred, rgb, on_card, on_cpu

    # three bf16 training steps of the LAB trainer on one batch
    shape = (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3)
    src, tar = (torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
                for _ in range(2))
    tr = slice_trainer(dev, act_dtype=torch.bfloat16, lab=True)
    state = tr.init(14)
    check(state.c.model.pred.out_channels == 2, "the LAB colorizer does not have 2 channels")
    metrics = []
    for _ in range(LAB_STEPS):
        state, m = tr.train_step_u8(state, src, tar, TRAIN_LR)
        metrics.append({k: float(v) for k, v in m.items()})
    loss = {k: [m[k] for m in metrics] for k in ("loss_SR", "loss_C")}
    finite = all(math.isfinite(v) for vs in loss.values() for v in vs)
    falls = all(vs[-1] < vs[0] for vs in loss.values())
    print(f"[lab] {LAB_STEPS} bf16 LAB train steps, batch {TRAIN_BATCH} of {TRAIN_HW}^2: loss_SR "
          f"{' -> '.join(f'{v:.5f}' for v in loss['loss_SR'])}, loss_C "
          f"{' -> '.join(f'{v:.5f}' for v in loss['loss_C'])}; finite {finite}, both fall {falls} "
          f"{'PASS' if finite and falls else 'FAIL'}")
    check(finite and falls, "LAB training: a loss is not finite or does not fall")
    step_ms = median_ms(lambda: tr.train_step_u8(state, src, tar, TRAIN_LR), reps=5)
    print(f"[lab] bf16 LAB step on {card}: {step_ms:.3f} ms (host-bound, as the RGB step)")
    del state, tr

    ssim_launches = phase_eval(dev, card, lab=True)
    return {"tail_x4": tail_launches, "ssim": ssim_launches}


# The GAN slice: CycleGANTrainer(net='1', x2) at full width, batch 1 of 256^2
# targets; its fp32 card-vs-CPU check at 128^2; 4 training and 3 test pairs.
GAN_HW, GAN_CHECK_HW, GAN_ITERS, GAN_K, GAN_REPS = 256, 128, 5, 4, 5
GAN_TRAIN, GAN_TEST = 4, 3


def gan_u8(rng, n: int, hw: int) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8))


def gan_snapshot(state) -> dict:
    """Each network's parameters and D's running statistics, flat float64 on
    the CPU."""
    flat = {r: torch.cat([p.detach().cpu().double().flatten()
                          for p in getattr(state, r).model.parameters()]) for r in ("g", "d")}
    flat["bn"] = torch.cat([b.detach().cpu().double().flatten()
                            for n, b in state.d.model.named_buffers() if "running" in n])
    return flat


def gan_match(dst, src):
    """``dst`` (a CycleState) holding ``src``'s parameters, BatchNorm state and
    Adam moments: the point at which both sides take the next step.  The
    optimizer state is copied first: ``load_state_dict`` keeps Adam's host
    step counter by reference, and both sides would then count it."""
    for r in ("g", "d"):
        getattr(dst, r).model.load_state_dict(getattr(src, r).model.state_dict())
        getattr(dst, r).opt.load_state_dict(copy.deepcopy(getattr(src, r).opt.state_dict()))
    return dst._replace(g=dst.g._replace(step=src.g.step), d=dst.d._replace(step=src.d.step))


def phase_gan_fp32(dev):
    """Two fp32 gd_steps (TF32 off, remat on as the configuration has it) on
    the card against the CPU, batch 1 of 128^2 (the CPU side at 256^2 would
    take minutes).  Step 1 from the same initial weights; step 2 from the
    card's state after step 1 (parameters, D's BatchNorm state and both Adam
    moments copied to the CPU side), so that it holds the forward of updated
    networks, Adam with moments and the checkpoint recompute at a matched
    point (Adam's first update moves a near-zero gradient's element by +-lr
    whatever its rounding, so two trajectories part at once).  Each step:
    every scalar loss within rtol 1e-4; D's running statistics after it
    within rel-L2 1e-4; each network's update within rel-L2 5e-2 (the train
    phase's envelope) and its parameter norm within rtol 1e-5."""
    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.models.blocks import RRDB
    from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer

    rng = np.random.default_rng(20)
    tars = [gan_u8(rng, 1, GAN_CHECK_HW) for _ in range(2)]
    sides = ("cpu", dev)
    ok, lines = True, []
    with config.precision("fp32"):
        trs = {w: CycleGANTrainer(pool_size=0, device=w) for w in sides}
        states = {w: trs[w].init(21) for w in sides}
        remat = sum(m.remat for m in states[dev].g.model.modules() if isinstance(m, RRDB))
        check(trs[dev].remat and remat == 6, f"remat off or on {remat} of 6 RRDBs")
        for step, tar in enumerate(tars, 1):
            if step > 1:
                states["cpu"] = gan_match(states["cpu"], states[dev])
            before = {w: gan_snapshot(states[w]) for w in sides}
            loss = {}
            for w in sides:
                real_a, real_b = trs[w].inputs_u8(tar, tar)
                states[w], aux = trs[w].gd_step(states[w], real_a, real_b, trs[w].lr,
                                                trs[w].d_lr)
                loss[w] = {k: float(v) for k, v in aux.items() if v.dim() == 0}
            after = {w: gan_snapshot(states[w]) for w in sides}
            cpu, card = loss["cpu"], loss[dev]
            err, at = max((abs(card[k] - cpu[k]) / abs(cpu[k]), k) for k in cpu)
            bn = rel_l2(after[dev]["bn"], after["cpu"]["bn"])
            upd = {r: rel_l2(after[dev][r] - before[dev][r], after["cpu"][r] - before["cpu"][r])
                   for r in ("g", "d")}
            norm = {r: abs(float(after[dev][r].norm() / after["cpu"][r].norm()) - 1)
                    for r in ("g", "d")}
            ok &= (err <= 1e-4 and bn <= 1e-4 and all(v <= 5e-2 for v in upd.values())
                   and all(v <= 1e-5 for v in norm.values()))
            lines.append(f"step {step}: loss_G {card['loss_G']:.6f} vs {cpu['loss_G']:.6f}, "
                         f"max rel over {len(cpu)} losses {err:.2e} at {at}, D running "
                         f"statistics rel-L2 {bn:.2e}, update rel-L2 G {upd['g']:.2e} D "
                         f"{upd['d']:.2e}, norm rel G {norm['g']:.2e} D {norm['d']:.2e}")
    print(f"[gan] two fp32 gd_steps card vs CPU (net='1' x2 full width, remat on: 6 RRDBs "
          f"and every pass checkpointed, batch 1, {GAN_CHECK_HW}^2 target, TF32 off; step 2 "
          f"from the card's state on both sides): " + "; ".join(lines)
          + f" (bounds 1e-4, 1e-4, 5e-2, 1e-5) {'PASS' if ok else 'FAIL'}")
    check(ok, "the fp32 GAN steps on the card disagree with the CPU")


def gan_iteration_profile(tr, state, real_a, real_b):
    """(wall ms, device-busy ms, the largest kernels) of one
    optimize_parameters iteration under torch.profiler: the busy time sums
    the device kernels' own entries (an op's entry repeats its kernels')."""
    import time

    from torch import profiler

    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.optimize_parameters(state, real_a, real_b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key[:48], e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows[:5]


def host_yardstick_ms(dev, n: int = 2000) -> float:
    """The host's pace at enqueueing work: ms for ``n`` one-element adds on
    the card, each a launch that the device finishes at once.  The GAN
    iteration is host-bound (its profile), so its times move with this."""
    import time

    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_gan(dev, card: str) -> int:
    """Phase 12, the CycleGAN slice (see the module docstring).  Returns the
    ssim launches of test_cyclegan on the card."""
    import time

    from PIL import Image

    from srcgan_tpu_torch import data
    from srcgan_tpu_torch.cli import test_cyclegan, train_cyclegan
    from srcgan_tpu_torch.ops.kernels import rdb5_kernel
    from srcgan_tpu_torch.ops.kernels import ssim_kernel as sk
    from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer

    t_phase = time.perf_counter()
    phase_gan_fp32(dev)

    # (b) bf16 iterations through the host pool, then K iterations through the device pool
    rng = np.random.default_rng(22)
    tr = CycleGANTrainer(act_dtype=torch.bfloat16, pool_size=4, device=dev)
    state = tr.init(23)
    u8 = gan_u8(rng, 1, GAN_HW).to(dev)
    real_a, real_b = tr.inputs_u8(u8, u8)
    rdb5_before = rdb5_kernel.launches_bf16
    rows = []
    for _ in range(GAN_ITERS):
        state, aux = tr.optimize_parameters(state, real_a, real_b)
        rows.append({k: float(v) for k, v in aux.items() if v.dim() == 0})
    pools = tr.device_pool_init(state, real_a, real_b, seed=1)
    blk = gan_u8(rng, GAN_K, GAN_HW).unsqueeze(1).to(dev)
    state, pools, imgs, scalars = tr.gd_steps_pooled_u8(state, pools, blk, blk, tr.lr, tr.d_lr)
    finite = (all(math.isfinite(v) for r in rows for v in r.values())
              and all(v.shape == (GAN_K,) and bool(torch.isfinite(v).all())
                      for v in scalars.values()))
    fills = (int(pools["A"]["n"]), int(pools["B"]["n"]))
    loss_g = " -> ".join("%.3f" % r["loss_G"] for r in rows)
    loss_d = " -> ".join("%.4f" % (r["loss_D_A"] + r["loss_D_B"]) for r in rows)
    print(f"[gan] {GAN_ITERS} bf16 optimize_parameters (host pool 4), batch 1 of {GAN_HW}^2: "
          f"loss_G {loss_g}, loss_D {loss_d}; "
          f"gd_steps_pooled_u8 K={GAN_K} (device pool): loss_G "
          f"{' '.join(f'{v:.3f}' for v in scalars['loss_G'].tolist())}, pools filled {fills}; "
          f"all finite {finite}; rdb5_bf16 launches {rdb5_kernel.launches_bf16 - rdb5_before} "
          f"(train mode keeps the generators off it) {'PASS' if finite else 'FAIL'}")
    check(finite, "a bf16 GAN loss is not finite")
    check(fills == (4, 4) and state.g.step == GAN_ITERS + GAN_K, "the device pool or the steps")
    check(rdb5_kernel.launches_bf16 == rdb5_before, "a GAN training pass reached rdb5_bf16")
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as flops:
        tr.optimize_parameters(state, real_a, real_b)
    tflop = flops.get_total_flops() / 1e12
    print(f"[gan] one bf16 optimize_parameters iteration (batch 1, remat on): {tflop:.4f} "
          f"TFLOP (torch.utils.flop_counter: convolutions and matmuls, forward, recompute and "
          f"backward); at the card's {PEAK_FLOPS['bf16'] / 1e12:.0f} TFLOP/s bf16 "
          f"{tflop / PEAK_FLOPS['bf16'] * 1e15:.3f} ms")
    wall, busy, top = gan_iteration_profile(tr, state, real_a, real_b)
    print(f"[gan] one bf16 optimize_parameters iteration (batch 1, remat on) on {card}: "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms = {100 * busy / wall:.1f}% (idle "
          f"{100 * (1 - busy / wall):.1f}%); largest kernels "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top) + " (profiler)")
    check(busy > 0, "the profiler saw no device kernel in a GAN iteration")
    del state, tr, pools, imgs

    # (c) ms per iteration and peak memory, remat on and off in turns
    for n in (1, 4):
        u8 = gan_u8(rng, n, GAN_HW).to(dev)
        for method in ("optimize_parameters", "gd_step"):
            times, peaks = {True: [], False: []}, {True: [], False: []}
            host = []
            for remat in (True, False, False, True):
                host.append(host_yardstick_ms(dev))
                t = CycleGANTrainer(act_dtype=torch.bfloat16, remat=remat, device=dev,
                                    pool_size=4 if method == "optimize_parameters" else 0)
                st = t.init(24)
                a, b = t.inputs_u8(u8, u8)
                fn = ((lambda: t.optimize_parameters(st, a, b)) if method == "optimize_parameters"
                      else (lambda: t.gd_step(st, a, b, t.lr, t.d_lr)))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times[remat].append(median_ms(fn, reps=GAN_REPS))
                peaks[remat].append(torch.cuda.max_memory_allocated() / 2 ** 30)
                del st, t, a, b, fn
            print(f"[gan] bf16 {method} (pool {4 if method == 'optimize_parameters' else 0}), "
                  f"batch {n} of {GAN_HW}^2 on {card}: remat on "
                  f"{' / '.join(f'{v:.3f}' for v in times[True])} ms, peak "
                  f"{max(peaks[True]):.3f} GiB; remat off "
                  f"{' / '.join(f'{v:.3f}' for v in times[False])} ms, peak "
                  f"{max(peaks[False]):.3f} GiB (in turns; {n * GAN_HW ** 2 / 1e6 / statistics.median(times[True]) * 1e3:.3f} target MP/s with remat); "
                  f"host yardstick before each turn {' / '.join(f'{v:.3f}' for v in host)} ms")
        del u8
    torch.cuda.empty_cache()

    # (d) the command-line tools: train_cyclegan for one epoch with
    # --eval-after-save, then test_cyclegan on the card and on the CPU
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gan_") as tmp:
        data.make_synthetic_dataset(os.path.join(tmp, "Sat2Aerx2"), n_train=GAN_TRAIN, n_val=1,
                                    n_test=GAN_TEST, size=GAN_HW, seed=0, scale=2)
        ck = os.path.join(tmp, "checkpoints")
        cwd = os.getcwd()
        os.chdir(tmp)                           # --eval-after-save writes ./result
        try:
            train_cyclegan.main(["--data-dir", tmp, "--bf16-acts", "--num-epochs", "1",
                                 "--save-every", "1", "--log-every", "2", "--eval-after-save",
                                 "--checkpoints", ck, "--run-dir", os.path.join(tmp, "run")])
        finally:
            os.chdir(cwd)
        net_a = os.path.join(ck, "netG_A2B_SRtask_x2_0001.npz")
        net_b = os.path.join(ck, "netG_B2A_SRtask_x2_0001.npz")
        check(all(os.path.exists(p) for p in (net_a, net_b, os.path.join(
            ck, "cyclestate_latest.npz"), os.path.join(tmp, "result", "Performs.csv"))),
            "train_cyclegan left no checkpoints or no --eval-after-save row")
        print()

        def evaluate(result, *extra):
            return test_cyclegan.main(["--netGA", net_a, "--netGB", net_b, "--data-dir", tmp,
                                       "--result-dir", os.path.join(tmp, result), *extra])

        sk.launches = 0
        on_card = evaluate("result_card")
        launches = sk.launches
        print(f"[gan] test_cyclegan: {on_card['images']} images on {on_card['device']} in "
              f"{on_card['eval_seconds']:.3f} s, ssim launches {launches}")
        check(on_card["images"] == GAN_TEST and on_card["device"].startswith("cuda"),
              "test_cyclegan did not run on the card")
        check(launches == GAN_TEST, "a test image did not launch the ssim kernel exactly once")
        row = read_performs(os.path.join(tmp, "result_card"))
        check(all(math.isfinite(float(row[k])) for k in ("MSE", "PSNR", "AE", "SSIM")),
              f"Performs.csv row {row}")
        for side, hw in (("fakeB", GAN_HW), ("fakeA", GAN_HW // 2)):
            out = os.path.join(tmp, "result_card", f"cyc_{side}_netG_A2B_SRtask_x2_0001")
            names = sorted(os.listdir(out))
            check(len(names) == GAN_TEST, f"{out}: {len(names)} PNGs")
            for name in names:
                with Image.open(os.path.join(out, name)) as im:
                    check(im.size == (hw, hw) and im.mode == "RGB", f"{name}: {im.size} {im.mode}")
        on_cpu = evaluate("result_cpu", "--device", "cpu")
        d_psnr = abs(on_card["PSNR"] - on_cpu["PSNR"])
        d_ssim = abs(on_card["SSIM"] - on_cpu["SSIM"])
        ok = d_psnr <= 0.01 and d_ssim <= 1e-4
        print(f"[gan] Performs.csv row {row}; PNGs decode; card vs CPU: PSNR "
              f"{on_card['PSNR']:.5f} vs {on_cpu['PSNR']:.5f} (|d| {d_psnr:.2e}, bound 0.01 dB), "
              f"SSIM {on_card['SSIM']:.6f} vs {on_cpu['SSIM']:.6f} (|d| {d_ssim:.2e}, bound 1e-4) "
              f"{'PASS' if ok else 'FAIL'}")
        check(ok, "the card's test_cyclegan row disagrees with the CPU's")
    print(f"[gan] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches

# The multi-task slice: MultiTaskTrainer() at its defaults, batch 1 of 256^2
# targets (realA their 128^2 gray); the fp32 check at 128^2.
MT_HW, MT_CHECK_HW, MT_ITERS, MT_REPS, MT_TRAIN = 256, 128, 3, 5, 4
# The zoo: fp32 card vs CPU at 1x3x48x48, bf16 timing at batch 16 of 48^2.
ZOO_HW, ZOO_BATCH, ZOO_REPS = 48, 16, 10
ZOO_TRAIN, ZOO_TEST, ZOO_EVAL_BATCH = 8, 8, 4


def kernel_launches() -> dict:
    """Every kernel's launch count, by kernel."""
    from srcgan_tpu_torch.ops.kernels import (preprocess_kernel, probe_kernels, rdb5_kernel,
                                              ssim_kernel, tail_kernel)

    return {"tail_x4": tail_kernel.launches + tail_kernel.finish_launches,
            "gray_degrade": preprocess_kernel.launches, "ssim": ssim_kernel.launches,
            "rdb5_bf16": rdb5_kernel.launches_bf16, "rdb5_int8": rdb5_kernel.launches_int8,
            "probes": sum(probe_kernels.launches.values()) + probe_kernels.matmul_int8_launches}


def reset_launches():
    """Every launch count to 0, just before a path is driven."""
    from srcgan_tpu_torch.ops.kernels import (preprocess_kernel, probe_kernels, rdb5_kernel,
                                              ssim_kernel, tail_kernel)

    tail_kernel.launches = tail_kernel.finish_launches = 0
    preprocess_kernel.launches = ssim_kernel.launches = 0
    rdb5_kernel.launches_bf16 = rdb5_kernel.launches_int8 = 0
    probe_kernels.launches.update(dict.fromkeys(probe_kernels.launches, 0))
    probe_kernels.matmul_int8_launches = 0


def mt_inputs(tar_u8: torch.Tensor, dev):
    """(realA, realB) of a uint8 RGB target batch: realA the gray of its
    nearest half-size sample, as a Sat2Aerx2 source."""
    from srcgan_tpu_torch.data import preprocess

    tar = tar_u8.to(dev)
    return preprocess.convert_pair(tar[:, ::2, ::2].contiguous(), tar, "G2RGB")


def phase_multitask_fp32(dev):
    """Two fp32 gd_step_pooled steps (TF32 off, remat on) of MultiTaskTrainer()
    on the card against the CPU at a 128^2 target, by phase 12's matched-point
    method: each step from the card's state on both sides, the first after
    one warm-up step on the card, so that both hold Adam with moments.  (From
    a fresh state Adam's first update is lr * sign(g), and this net's fp32
    gradient at batch 1 flips signs: its rel-L2 is ~5e-3 between the card and
    the CPU, ~1e-2 between fp32 and float64 on one CPU; the first update
    then parts by ~0.1 on either device.)  The device pools pass the fakes
    through while they fill, on either side.  Bounds as phase 12: losses
    rtol 1e-4, D's running statistics rel-L2 1e-4, each network's update
    rel-L2 5e-2 and its parameter norm rtol 1e-5."""
    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.train.multitask import MultiTaskTrainer

    rng = np.random.default_rng(30)
    warm, *tars = [gan_u8(rng, 1, MT_CHECK_HW) for _ in range(3)]
    sides = ("cpu", dev)
    ok, lines = True, []
    with config.precision("fp32"):
        trs = {w: MultiTaskTrainer(device=w) for w in sides}
        states = {w: trs[w].init(31) for w in sides}
        pools = {w: trs[w].device_pool_init(states[w], *mt_inputs(warm, w), seed=1)
                 for w in sides}
        states[dev], pools[dev], _ = trs[dev].gd_step_pooled(
            states[dev], pools[dev], *mt_inputs(warm, dev), trs[dev].lr, trs[dev].d_lr)
        for step, tar in enumerate(tars, 1):
            states["cpu"] = gan_match(states["cpu"], states[dev])
            before = {w: gan_snapshot(states[w]) for w in sides}
            loss = {}
            for w in sides:
                states[w], pools[w], aux = trs[w].gd_step_pooled(
                    states[w], pools[w], *mt_inputs(tar, w), trs[w].lr, trs[w].d_lr)
                loss[w] = {k: float(v) for k, v in aux.items() if v.dim() == 0}
            after = {w: gan_snapshot(states[w]) for w in sides}
            cpu, card = loss["cpu"], loss[dev]
            err, at = max((abs(card[k] - cpu[k]) / abs(cpu[k]), k) for k in cpu)
            bn = rel_l2(after[dev]["bn"], after["cpu"]["bn"])
            upd = {r: rel_l2(after[dev][r] - before[dev][r], after["cpu"][r] - before["cpu"][r])
                   for r in ("g", "d")}
            norm = {r: abs(float(after[dev][r].norm() / after["cpu"][r].norm()) - 1)
                    for r in ("g", "d")}
            ok &= (err <= 1e-4 and bn <= 1e-4 and all(v <= 5e-2 for v in upd.values())
                   and all(v <= 1e-5 for v in norm.values()))
            lines.append(f"step {step}: loss_G {card['loss_G']:.6f} vs {cpu['loss_G']:.6f}, "
                         f"loss_G_C {card['loss_G_C']:.6f} vs {cpu['loss_G_C']:.6f}, max rel "
                         f"over {len(cpu)} losses {err:.2e} at {at}, D running statistics "
                         f"rel-L2 {bn:.2e}, update rel-L2 G {upd['g']:.2e} D {upd['d']:.2e}, "
                         f"norm rel G {norm['g']:.2e} D {norm['d']:.2e}")
    print(f"[mt] two fp32 gd_step_pooled card vs CPU (MultiTaskTrainer(): x2, ngf 64, "
          f"resnet_9blocks, instance norm, remat on, batch 1, {MT_CHECK_HW}^2 target, TF32 "
          f"off; each step from the card's state on both sides, after a warm-up step): "
          + "; ".join(lines)
          + f" (bounds 1e-4, 1e-4, 5e-2, 1e-5) {'PASS' if ok else 'FAIL'}")
    check(ok, "the fp32 multi-task steps on the card disagree with the CPU")


def phase_multitask(dev, card: str) -> dict:
    """Phase 13, the multi-task GAN (see the module docstring).  Returns the
    launch counts of the bf16 iterations (every kernel 0)."""
    import time

    from torch.utils.flop_counter import FlopCounterMode

    from srcgan_tpu_torch import data, interop, models
    from srcgan_tpu_torch.cli import train_multitask
    from srcgan_tpu_torch.train.multitask import MultiTaskTrainer

    t_phase = time.perf_counter()
    phase_multitask_fp32(dev)

    # (b) bf16 iterations through the host pools, every kernel's count read
    rng = np.random.default_rng(32)
    real_a, real_b = mt_inputs(gan_u8(rng, 1, MT_HW), dev)
    tr = MultiTaskTrainer(act_dtype=torch.bfloat16, device=dev)
    state = tr.init(33)
    reset_launches()
    rows = []
    for _ in range(MT_ITERS):
        state, aux = tr.optimize_parameters(state, real_a, real_b)
        rows.append({k: float(v) for k, v in aux.items() if v.dim() == 0})
    torch.cuda.synchronize()
    launches = kernel_launches()
    finite = all(math.isfinite(v) for r in rows for v in r.values())
    print(f"[mt] {MT_ITERS} bf16 optimize_parameters (host pools 4), batch 1 of {MT_HW}^2: "
          f"loss_G {' -> '.join('%.3f' % r['loss_G'] for r in rows)}, loss_G_C "
          f"{' -> '.join('%.4f' % r['loss_G_C'] for r in rows)}, loss_D "
          f"{' -> '.join('%.4f' % (r['loss_D_A'] + r['loss_D_B']) for r in rows)}; all finite "
          f"{finite}; kernel launches {launches} {'PASS' if finite else 'FAIL'}")
    check(finite, "a bf16 multi-task loss is not finite")
    check(not any(launches.values()), "a multi-task training pass launched a kernel")
    with FlopCounterMode(display=False) as flops:
        tr.optimize_parameters(state, real_a, real_b)
    tflop = flops.get_total_flops() / 1e12
    wall, busy, top = gan_iteration_profile(tr, state, real_a, real_b)
    print(f"[mt] one bf16 optimize_parameters iteration (batch 1, remat on) on {card}: "
          f"{tflop:.4f} TFLOP (torch.utils.flop_counter: convolutions and matmuls, forward, "
          f"recompute and backward), bound at the {PEAK_FLOPS['bf16'] / 1e12:.0f} TFLOP/s bf16 "
          f"peak {tflop / PEAK_FLOPS['bf16'] * 1e15:.3f} ms; wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms = {100 * busy / wall:.1f}% (idle {100 * (1 - busy / wall):.1f}%); "
          f"largest kernels " + "; ".join(f"{k} {v:.3f} ms" for k, v in top) + " (profiler)")
    check(busy > 0, "the profiler saw no device kernel in a multi-task iteration")
    del state, tr

    # (c) ms per iteration and peak memory, remat on and off in turns
    times, peaks, host = {True: [], False: []}, {True: [], False: []}, []
    for remat in (True, False, False, True):
        host.append(host_yardstick_ms(dev))
        t = MultiTaskTrainer(act_dtype=torch.bfloat16, remat=remat, device=dev)
        st = t.init(34)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[remat].append(median_ms(lambda: t.optimize_parameters(st, real_a, real_b),
                                      reps=MT_REPS))
        peaks[remat].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        del st, t
    print(f"[mt] bf16 optimize_parameters, batch 1 of {MT_HW}^2 on {card}: remat on "
          f"{' / '.join(f'{v:.3f}' for v in times[True])} ms, peak {max(peaks[True]):.3f} GiB; "
          f"remat off {' / '.join(f'{v:.3f}' for v in times[False])} ms, peak "
          f"{max(peaks[False]):.3f} GiB (in turns, median of {MT_REPS}); host yardstick "
          f"before each turn {' / '.join(f'{v:.3f}' for v in host)} ms")
    torch.cuda.empty_cache()

    # (d) train_multitask for one epoch; the three checkpoints load back
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mt_") as tmp:
        data.make_synthetic_dataset(os.path.join(tmp, "Sat2Aerx2"), n_train=MT_TRAIN, n_val=1,
                                    n_test=1, size=MT_HW, seed=0, scale=2)
        ck = os.path.join(tmp, "checkpoints")
        t0 = time.perf_counter()
        state = train_multitask.main(["--data-dir", tmp, "--bf16-acts", "--num-epochs", "1",
                                      "--save-every", "1", "--log-every", "2",
                                      "--checkpoints", ck, "--run-dir", os.path.join(tmp, "run")])
        secs = time.perf_counter() - t0
        check(state.g.step == MT_TRAIN and next(state.g.model.parameters()).is_cuda,
              "train_multitask did not take its steps on the card")
        nets = {"G_A": models.define_G(1, 3, 64, "resnet_9blocks", "instance"),
                "G_B": models.define_G(3, 1, 64, "resnet_9blocks", "instance"),
                "G_C": models.create("SRDenseNetA", 1, 1, mode="x2", num_blocks=2,
                                     num_layers=2)}
        for name, net in nets.items():
            interop.load_params_any(net, os.path.join(ck, f"netG_{name}_MTtask_x2_0001.npz"))
            want = state.g.model[name].state_dict()
            check(all(torch.equal(v, want[k].cpu()) for k, v in net.state_dict().items()),
                  f"the {name} checkpoint does not hold the trained generator")
    print(f"\n[mt] train_multitask --bf16-acts, one epoch of {MT_TRAIN} pairs of {MT_HW}^2 on "
          f"{card}: {secs:.2f} s; netG_{{G_A,G_B,G_C}}_MTtask_x2_0001.npz load back into the "
          f"port's nets (strict) PASS")
    print(f"[mt] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def zoo_models():
    """The six zoo models at the JAX constructors' defaults (the others at
    scale 2; MDSR at [2, 3, 4]): name -> (constructor, input range)."""
    from srcgan_tpu_torch import models
    from srcgan_tpu_torch.models.edsr_zoo import args_namespace

    g = lambda: torch.Generator().manual_seed(40)  # noqa: E731
    return {"VDSR": (lambda: models.VDSR(generator=g()), 255.0),
            "MDSR": (lambda: models.MDSR(args_namespace(scale=[2, 3, 4]), generator=g()), 255.0),
            "RDN": (lambda: models.RDN(generator=g()), 255.0),
            "RCAN": (lambda: models.RCAN(generator=g()), 255.0),
            "DDBPN": (lambda: models.DDBPN(generator=g()), 255.0),
            "EDSRWeb": (lambda: models.EDSRWeb(3, 3, 2, generator=g()), 1.0)}


def phase_zoo(dev, card: str):
    """Phase 14, the zoo (see the module docstring).  Returns the launch
    counts of the zoo forwards (every kernel 0) and of the EDSRWeb test_cas
    on the card (ssim once per batch)."""
    import time

    from torch.utils.flop_counter import FlopCounterMode

    from srcgan_tpu_torch import config, data
    from srcgan_tpu_torch.cli import test_cas, train_cas
    from srcgan_tpu_torch.train.state import load_params, save_params

    t_phase = time.perf_counter()
    rng = np.random.default_rng(41)
    x01 = torch.from_numpy(rng.uniform(0, 1, (1, 3, ZOO_HW, ZOO_HW)).astype(np.float32))
    xb01 = torch.from_numpy(rng.uniform(0, 1, (ZOO_BATCH, 3, ZOO_HW, ZOO_HW))
                            .astype(np.float32)).to(dev, torch.bfloat16)
    reset_launches()
    worst = 0.0
    for name, (make, rng_max) in zoo_models().items():
        net = make().eval()
        scales = range(len(net.scales)) if name == "MDSR" else (None,)
        errs = []
        with torch.no_grad(), config.precision("fp32"):
            card_net = copy.deepcopy(net).to(dev)
            for idx in scales:
                if idx is not None:
                    net.set_scale(idx)
                    card_net.set_scale(idx)
                want = net(x01 * rng_max)
                got = card_net((x01 * rng_max).to(dev)).cpu()
                check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                      f"{name}: {tuple(got.shape)}")
                errs.append(rel_l2(got, want))
        worst = max(worst, *errs)
        # bf16 at batch 16: time, peak memory, FLOPs and the bound
        bf = config.cast_parameters(card_net, torch.bfloat16)
        xb = xb01 * rng_max
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = median_ms(lambda: bf(xb), reps=ZOO_REPS)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            with FlopCounterMode(display=False) as flops:
                y = bf(xb)
        nbytes = tensor_bytes(xb, y, *bf.parameters())
        bound = least_time(nbytes, flops.get_total_flops(), "bf16")
        print(f"[zoo] {name}{' (scale index ' + str(scales[-1]) + ' timed)' if name == 'MDSR' else ''}: "
              f"{sum(p.numel() for p in net.parameters()) / 1e6:.3f} M params; fp32 card vs CPU "
              f"at 1x3x{ZOO_HW}^2 in [0,{rng_max:g}] (TF32 off) rel-L2 "
              f"{' / '.join(f'{e:.2e}' for e in errs)}; bf16 forward, batch {ZOO_BATCH} of "
              f"{ZOO_HW}^2 -> {tuple(y.shape[2:])} on {card}: {ms:.3f} ms, peak {peak:.3f} GiB, "
              f"{flops.get_total_flops() / 1e9:.2f} GFLOP, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}) = {100 * bound['bound_ms'] / ms:.1f}% of the time")
        del net, card_net, bf, y
    torch.cuda.synchronize()
    fwd_launches = kernel_launches()
    ok = worst <= 1e-5
    print(f"[zoo] six models, worst fp32 card-vs-CPU rel-L2 {worst:.2e} (bound 1e-5); kernel "
          f"launches over the zoo forwards {fwd_launches} {'PASS' if ok else 'FAIL'}")
    check(ok, "a zoo model's fp32 forward on the card disagrees with the CPU")
    check(not any(fwd_launches.values()), "a zoo forward launched a kernel")
    torch.cuda.empty_cache()

    # EDSRWeb as the cascade's SR stage: train_cas for one epoch, then test_cas
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        data.make_synthetic_dataset(os.path.join(tmp, "Sat2Aerx1"), n_train=ZOO_TRAIN, n_val=1,
                                    n_test=ZOO_TEST, size=EVAL_HW, seed=0, colorizable=True)
        ck = os.path.join(tmp, "checkpoints")
        train_cas.main(["--data-dir", tmp, "--SRModel", "EDSRWeb", "--CModel", "ResDeconv",
                        "--up", "2", "--batch-size", str(ZOO_EVAL_BATCH), "--bf16-acts",
                        "--num-epochs", "1", "--save-every", "1", "--log-every", "1",
                        "--checkpoints", ck, "--run-dir", os.path.join(tmp, "run")])
        net_a = os.path.join(ck, "EDSRWeb_A2C_x2_0001.npz")
        net_b = os.path.join(ck, "ResDeconv_C2B_x2_0001.npz")
        check(os.path.exists(net_a) and os.path.exists(net_b), "train_cas left no checkpoints")
        print()
        # One epoch leaves both stages near their init, where EDSRWeb's output
        # has a std of ~3,000 and ResDeconv's ~6.6, and SSIM is ~0.  Their last
        # convs are scaled (as the serving tests scale ResDeconv's) so that the
        # scored output lies in range and the SSIM bound below can fail.
        tree_a, tree_b = load_params(net_a), load_params(net_b)
        tree_a["tail"]["1"] = {k: v * 1e-4 for k, v in tree_a["tail"]["1"].items()}
        tree_b["pred"]["w"] = tree_b["pred"]["w"] * 0.03
        save_params(net_a, tree_a)
        save_params(net_b, tree_b)

        def evaluate(result, *extra):
            return test_cas.main(["--netGA", net_a, "--netGB", net_b, "--data-dir", tmp,
                                  "--result-dir", os.path.join(tmp, result), "--batch-size",
                                  str(ZOO_EVAL_BATCH), "--precision", "highest", *extra])

        reset_launches()
        on_card = evaluate("result")
        launches = kernel_launches()
        n_batches = -(-ZOO_TEST // ZOO_EVAL_BATCH)
        check(on_card["images"] == ZOO_TEST and on_card["device"].startswith("cuda"),
              "the EDSRWeb eval did not run on the card")
        check(launches["ssim"] == n_batches and sum(launches.values()) == n_batches,
              f"kernel launches of the EDSRWeb eval {launches}, want ssim {n_batches}")
        on_cpu = evaluate("result_cpu", "--device", "cpu")
        d_psnr = abs(on_card["PSNR"] - on_cpu["PSNR"])
        d_ssim = abs(on_card["SSIM"] - on_cpu["SSIM"])
        ok = d_psnr <= 0.01 and d_ssim <= 1e-4 and on_cpu["SSIM"] > 1e-2
        print(f"[zoo] train_cas --SRModel EDSRWeb -> test_cas, {ZOO_TEST} images of {EVAL_HW}^2 "
              f"in {n_batches} batches on {card}: kernel launches {launches}; card vs CPU PSNR "
              f"{on_card['PSNR']:.5f} vs {on_cpu['PSNR']:.5f} (|d| {d_psnr:.2e}, bound 0.01 dB), "
              f"SSIM {on_card['SSIM']:.6f} vs {on_cpu['SSIM']:.6f} (|d| {d_ssim:.2e}, bound "
              f"1e-4; the CPU's SSIM above 1e-2) {'PASS' if ok else 'FAIL'}")
        check(ok, "the card's EDSRWeb Performs.csv row disagrees with the CPU's")
    print(f"[zoo] phase took {time.perf_counter() - t_phase:.1f} s")
    return fwd_launches, launches


# Phase 15, the serving extras: a 700x1000 scene through tiles of 256 at
# overlap 64 (6 x 8 windows = 6 batches of 8).  The overlap covers the
# cascade's receptive field at LR: RDDBNet nb 3 reaches 47 pixels (conv_first
# 1 + 9 dense blocks x 5 convs + trunk_conv 1), its folded conv_last one more,
# and SRCNN's 9x9 and 5x5 convs 6 HR pixels = 2 LR: 50 <= 64.
SCENE_HW, TILE, TILE_OVERLAP = (700, 1000), 256, 64
# the daemon's load levels (clients), each run until it has lasted
# DAEMON_SECONDS and answered DAEMON_REQUESTS (a p99 over 100 samples) and
# DAEMON_PER_CLIENT requests a client
DAEMON_CLIENTS, DAEMON_SECONDS, DAEMON_REQUESTS, DAEMON_PER_CLIENT = (1, 8, 32, 64), 3.0, 100, 3
# the bf16 daemon's answers against predict on each image alone (a batch of
# 4 copies; their groups hold 4 or 8 different images): bounds from the
# phase's readings on an H100 (max 3-4 LSB, mean 0.023-0.031 LSB), with
# room for a batch that moves more rows; in fp32 the bound is 1 LSB
ALONE_MAX, ALONE_MEAN = 6, 0.1
EXTRAS_REPS = 5


def host_median_ms(fn, reps: int = EXTRAS_REPS) -> float:
    """Median host time of ``fn``, which returns with its result on the host
    (it waits for the card itself), after one warm-up call."""
    import time

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tile_colorizer(gen):
    """SRCNN(1, 3, 1), its last conv scaled by 0.5 around a bias of 0.5, so that
    the random cascade's output spreads over [0, 1] (std ~20 LSB): local, so
    the tiled scene can be held to the whole-scene program."""
    from srcgan_tpu_torch import models

    col = models.SRCNN(1, 3, 1, generator=gen)
    with torch.no_grad():
        col.conv3.weight.mul_(0.5)
        col.conv3.bias.fill_(0.5)
    return col


def extras_tiled(dev, card: str, sr, c) -> dict:
    """(a) the tiled scene: bf16 launch counts, bf16 and fp32 against the
    whole-scene fp32 program, output MP/s, with a local colorizer; then with
    the ResDeconv colorizer, as the benchmark's tiled cell serves it: 32
    group_norm launches a tile batch, no plain GroupNorm call, and the scene
    against the same predictor with every GroupNorm on the plain path."""
    from srcgan_tpu_torch.ops.kernels import group_norm_kernel, tail_kernel
    from srcgan_tpu_torch.serving import CascadePredictor, TiledPredictor

    col = tile_colorizer(torch.Generator().manual_seed(3))
    scene = np.random.default_rng(15).integers(0, 256, SCENE_HW, dtype=np.uint8)
    tiled = TiledPredictor(copy.deepcopy(sr), copy.deepcopy(col), 4, bf16=True, tile=TILE,
                           overlap=TILE_OVERLAP, max_batch=BATCH, device=dev)
    rows = len(tiled._axis_windows(SCENE_HW[0], TILE, TILE_OVERLAP))
    cols = len(tiled._axis_windows(SCENE_HW[1], TILE, TILE_OVERLAP))
    n_batches = -(-rows * cols // BATCH)
    reset_launches()
    out = tiled.predict_scene(scene)
    torch.cuda.synchronize()
    launches = kernel_launches()
    mains, finishes = tail_kernel.launches, tail_kernel.finish_launches
    print(f"[extras] tiled scene {SCENE_HW[0]}x{SCENE_HW[1]}, tile {TILE}, overlap "
          f"{TILE_OVERLAP}: {rows}x{cols} windows in {n_batches} batches of {BATCH}; bf16 "
          f"rdb5_bf16 launches {launches['rdb5_bf16']} (want {9 * n_batches}), tail_x4 main "
          f"{mains} finish {finishes} (want {n_batches} each)")
    check(out.shape == (4 * SCENE_HW[0], 4 * SCENE_HW[1], 3) and out.dtype == np.uint8,
          f"tiled scene output {out.shape} {out.dtype}")
    check(launches["rdb5_bf16"] == 9 * n_batches and mains == finishes == n_batches,
          "a tile batch did not run its nine blocks through rdb5_bf16 and its tail through "
          "tail_x4 once")
    check(len(np.unique(out)) > 16, "constant tiled output")

    whole = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(col), 4, device=dev)
    want = whole.predict(scene[None, ..., None])[0].astype(int)
    tiled32 = TiledPredictor(copy.deepcopy(sr), copy.deepcopy(col), 4, tile=TILE,
                             overlap=TILE_OVERLAP, max_batch=BATCH, device=dev)
    got32 = tiled32.predict_scene(scene).astype(int)
    d16 = np.abs(out.astype(int) - want)
    d32 = np.abs(got32 - want)
    ok = d16.mean() <= 2 and d32.max() <= 1
    print(f"[extras] against the whole-scene fp32 program (TF32 off): bf16 tiles mean|diff| "
          f"{d16.mean():.4f} LSB (bound 2), max {d16.max()}; fp32 tiles max|diff| {d32.max()} "
          f"(bound 1), bit-equal {100 * (d32 == 0).mean():.4f}% of the values "
          f"{'PASS' if ok else 'FAIL'}")
    check(ok, "the stitched scene strays from the whole-scene program")
    ms = host_median_ms(lambda: tiled.predict_scene(scene))
    wx = [w for w, _, _, _ in tiled._axis_windows(SCENE_HW[1], TILE, TILE_OVERLAP)]
    first = np.stack([scene[:TILE, w:w + TILE, None] for w in wx[:BATCH]])
    batch_ms = host_median_ms(lambda: tiled.predict(first))
    mp = out.shape[0] * out.shape[1] / 1e6
    print(f"[extras] tiled scene bf16 on {card}: {ms:.3f} ms per scene (median of "
          f"{EXTRAS_REPS}, host clock) = {mp / ms * 1e3:.2f} output MP/s; one predict of "
          f"{BATCH} tiles alone {batch_ms:.3f} ms (x {n_batches} in sequence = "
          f"{n_batches * batch_ms:.3f} ms)")

    gn_tiled = TiledPredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True, tile=TILE,
                              overlap=TILE_OVERLAP, max_batch=BATCH, device=dev)
    group_norm_kernel.launches = group_norm_kernel.plain_calls = 0
    got = gn_tiled.predict_scene(scene).astype(int)
    torch.cuda.synchronize()
    norms, plain = group_norm_kernel.launches, group_norm_kernel.plain_calls
    with group_norm_kernel.PlainGroupNorm():
        want = gn_tiled.predict_scene(scene).astype(int)
    d = np.abs(got - want)
    ok = (norms == 32 * n_batches and plain == 0 and len(np.unique(got)) > 16
          and d.mean() <= 1 and (d > 8).mean() <= 0.02)
    print(f"[extras] tiled scene with the ResDeconv colorizer (its GroupNorms at "
          f"{list(GN_TILED_SHAPES)}), bf16: group_norm launches {norms} (want "
          f"{32 * n_batches}), plain GroupNorm calls {plain} (want 0); against the same "
          f"predictor with every GroupNorm on the plain path: mean|diff| {d.mean():.4f} LSB "
          f"(bound 1), max {d.max()}, {(d > 8).mean():.5f} of the values beyond 8 LSB (bound "
          f"0.02) {'PASS' if ok else 'FAIL'}")
    check(ok, "a tile batch did not run the colorizer's 32 GroupNorms through the kernel, "
              "or its answer strays from the plain path's")
    launches["group_norm"] = norms
    return launches


def extras_ensemble(dev, card: str, sr, c) -> dict:
    """(b) the self-ensemble: one forward of 8N rows, fp32 against the mean of
    eight predictor calls, ms against plain predict."""
    from srcgan_tpu_torch.ops import ensemble
    from srcgan_tpu_torch.ops.kernels import tail_kernel
    from srcgan_tpu_torch.serving import CascadePredictor

    gray = np.random.default_rng(16).integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8)
    ens = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True,
                           self_ensemble=True, device=dev)
    plain = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True, device=dev)
    plain.predict(gray)
    reset_launches()
    y = ens.predict(gray)
    torch.cuda.synchronize()
    launches = kernel_launches()
    mains, finishes = tail_kernel.launches, tail_kernel.finish_launches
    print(f"[extras] self-ensemble bf16, batch {BATCH} of {LR}^2 (one forward of "
          f"{8 * BATCH} rows): rdb5_bf16 launches {launches['rdb5_bf16']} (want 9), tail_x4 "
          f"main {mains} finish {finishes} (want 1 each)")
    check(y.shape == (BATCH, 4 * LR, 4 * LR, 3) and len(np.unique(y)) > 16,
          f"ensembled output {y.shape}")
    check(launches["rdb5_bf16"] == 9 and mains == finishes == 1,
          "the ensembled batch did not run as one forward through the kernels")

    ens32 = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, self_ensemble=True,
                             device=dev)
    plain32 = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, device=dev)
    x = torch.from_numpy(gray)
    acc = torch.zeros((BATCH, 4 * LR, 4 * LR, 3), dtype=torch.float64)
    for op in ensemble.ALL_OPS:
        xo = ensemble.dihedral_nhwc(x, op).numpy()
        yo = torch.from_numpy(plain32.predict(np.ascontiguousarray(xo)))
        acc += ensemble.dihedral_nhwc(yo, ensemble.DIHEDRAL_INVERSE[op]).double()
    want = torch.round(acc / len(ensemble.ALL_OPS)).numpy().astype(int)
    got = ens32.predict(gray).astype(int)
    d = np.abs(got - want)
    print(f"[extras] fp32 self-ensemble against the mean of 8 predictor calls on the "
          f"transformed inputs, each inverted: max|diff| {d.max()} LSB (bound 1), mean "
          f"{d.mean():.4f} {'PASS' if d.max() <= 1 else 'FAIL'}")
    check(d.max() <= 1, "the self-ensemble strays from the mean of its eight calls")
    xd = x.to(dev)
    times = in_turns_ms({"plain": lambda: plain._run(xd), "ensemble": lambda: ens._run(xd)},
                        rounds=2, reps=10)
    print(f"[extras] self-ensemble bf16 on {card}: {' / '.join(f'{t:.3f}' for t in times['ensemble'])} "
          f"ms per batch against plain predict {' / '.join(f'{t:.3f}' for t in times['plain'])} "
          f"ms (in turns)")
    return launches


def _post(port: int, path: str, body: bytes, timeout: float = 60.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _png(img) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _unpng(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def _burst(port: int, bodies) -> list:
    """POST every body to /predict at once, one client thread each: the
    (status, body) answers in order."""
    import threading

    results = [None] * len(bodies)

    def client(i):
        results[i] = _post(port, "/predict", bodies[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        check(not t.is_alive(), "a client did not get its answer within 120 s")
    check(all(r is not None and r[0] == 200 for r in results),
          f"daemon answers {[r and r[0] for r in results]}")
    return results


def _load_client(port, levels, bodies_dir, min_seconds, min_requests, per_client):
    """The daemon's load generator, run in a process of its own (stdlib only:
    ``extras_daemon`` runs its source with ``python -c``), so that the
    clients do not share the daemon's interpreter lock.  Each level runs
    ``conc`` clients, each posting the bodies in turn on a new connection,
    until the level has lasted ``min_seconds`` and answered ``min_requests``
    and ``per_client`` requests a client; then the clients finish the
    request in hand.  Prints one JSON line a
    level: the (status, seconds) of every request, the wall time, and the
    daemon's /stats before and after."""
    import http.client
    import json
    import os
    import threading
    import time

    bodies = [open(os.path.join(bodies_dir, n), "rb").read()
              for n in sorted(os.listdir(bodies_dir))]

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    for conc in levels:
        lat, lock, stop = [], threading.Lock(), threading.Event()

        def worker(i):
            k = i
            while not stop.is_set():
                t0 = time.perf_counter()
                status, _ = call("POST", "/predict", bodies[k % len(bodies)])
                dt = time.perf_counter() - t0
                with lock:
                    lat.append((status, dt))
                k += conc

        stats0 = json.loads(call("GET", "/stats")[1])
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(conc)]
        for t in threads:
            t.start()
        while (time.perf_counter() - t0 < min_seconds
               or len(lat) < max(min_requests, per_client * conc)):
            if not any(t.is_alive() for t in threads):
                break
            time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        wall = time.perf_counter() - t0
        stats1 = json.loads(call("GET", "/stats")[1])
        print(json.dumps({"conc": conc, "lat": lat, "wall": wall, "stats0": stats0,
                          "stats1": stats1, "hung": sum(t.is_alive() for t in threads)}),
              flush=True)


def daemon_load(port: int, bodies, card: str) -> list:
    """Requests/s, latency quantiles and each request's split at the
    DAEMON_CLIENTS levels, from ``_load_client`` in a child process."""
    import inspect

    with tempfile.TemporaryDirectory(prefix="chip_smoke_load_") as d:
        for i, b in enumerate(bodies):
            with open(os.path.join(d, f"{i:03d}.png"), "wb") as f:
                f.write(b)
        src = (inspect.getsource(_load_client)
               + f"\n_load_client({port}, {list(DAEMON_CLIENTS)!r}, {d!r}, "
                 f"{DAEMON_SECONDS!r}, {DAEMON_REQUESTS!r}, {DAEMON_PER_CLIENT!r})\n")
        run = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                             timeout=600)
    check(run.returncode == 0, f"the load client failed: {run.stderr[-2000:]}")
    levels = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    check([lv["conc"] for lv in levels] == list(DAEMON_CLIENTS), "a load level is missing")
    for lv in levels:
        conc, lat = lv["conc"], lv["lat"]
        check(not lv["hung"] and len(lat) >= max(DAEMON_REQUESTS, DAEMON_PER_CLIENT * conc)
              and all(st == 200 for st, _ in lat), f"a load request failed at {conc} clients")
        xs = np.sort([dt for _, dt in lat]) * 1e3
        q = {p: xs[min(len(xs) - 1, int(p / 100 * len(xs)))] for p in (50, 90, 99)}
        d = {k: lv["stats1"][k] - lv["stats0"].get(k, 0)
             for k in ("requests", "batches", "batched_samples", "decode_seconds",
                       "queue_seconds", "forward_seconds", "encode_seconds")}
        check(d["requests"] == len(lat), "the daemon counted other requests than were sent")
        split = {k: d[f"{k}_seconds"] / d["requests"] * 1e3
                 for k in ("decode", "queue", "forward", "encode")}
        rest = xs.mean() - sum(split.values())
        lv.update(rate=len(lat) / lv["wall"], q=q, split=split, rest=rest, mean=xs.mean())
        print(f"[extras] daemon at {conc} clients on {card}: {len(lat)} requests in "
              f"{lv['wall']:.3f} s = {lv['rate']:.2f} requests/s ({len(lat) / conc:.1f} a "
              f"client); latency p50 {q[50]:.2f} ms, p90 {q[90]:.2f}, p99 {q[99]:.2f} (of "
              f"{len(xs)}), mean {xs.mean():.2f}; mean batch "
              f"{d['batched_samples'] / d['batches']:.2f}; a request's mean ms: PNG decode "
              f"{split['decode']:.3f}, queue {split['queue']:.3f}, forward of its group "
              f"{split['forward']:.3f}, PNG encode {split['encode']:.3f}, the rest (HTTP, "
              f"sockets, threads) {rest:.3f}")
    return levels


def extras_daemon(dev, card: str, sr, c) -> dict:
    """(c) the daemon: 32 clients, the launch count per group, each answer
    against its image alone (bf16 bounded, fp32 1 LSB), /reload to a
    cli.blend output, load levels from a client process, a drained backlog."""
    import threading
    import time

    from srcgan_tpu_torch import interop
    from srcgan_tpu_torch.cli import blend, serve
    from srcgan_tpu_torch.models.blocks import rdb5_schedule
    from srcgan_tpu_torch.models.rddb import no_tail_kernel
    from srcgan_tpu_torch.ops.kernels import group_norm_kernel
    from srcgan_tpu_torch.serving import CascadePredictor
    from srcgan_tpu_torch.train.state import save_params

    rng = np.random.default_rng(17)
    imgs = [rng.integers(0, 256, (LR, LR), dtype=np.uint8) for _ in range(32)]
    bodies = [_png(im) for im in imgs]

    def against_alone(outs, predict):
        d = np.stack([np.abs(predict(im[None, ..., None])[0].astype(int) - o.astype(int))
                      for o, im in zip(outs, imgs)])
        return int(d.max()), float(d.mean())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        def save_pair(sr_net, c_net, epoch):
            paths = (os.path.join(tmp, f"RDDBNet_A2C_x4_{epoch:04d}.npz"),
                     os.path.join(tmp, f"ResDeconv_C2B_x4_{epoch:04d}.npz"))
            save_params(paths[0], interop.jax_tree_from_module(sr_net)[0])
            save_params(paths[1], interop.jax_tree_from_module(c_net)[0])
            return paths

        def start(*flags):
            srv = serve.make_server(serve.build_parser().parse_args(
                ["--netGA", first[0], "--netGB", first[1], "--port", "0",
                 "--max-batch", "8", "--pad-batch", "4", *flags]))
            server = threading.Thread(target=srv.serve_forever, daemon=True)
            server.start()
            return srv, server

        def stop(srv, server):
            srv.shutdown()
            if srv.batcher._thread.is_alive():
                serve.close(srv)
            server.join(timeout=30)

        first = save_pair(sr, c, 1)
        srv, server = start("--bf16", "--tile", str(TILE), "--warmup", f"{LR}x{LR}")
        try:
            port = srv.server_address[1]
            pred = srv.batcher.predictor
            groups = []
            predict = pred.predict

            def recording(batch):
                out = predict(batch)
                groups.append((batch, out))
                return out

            pred.predict = recording
            stats0 = dict(srv.batcher.stats)
            reset_launches()
            results = _burst(port, bodies)
            torch.cuda.synchronize()
            launches = kernel_launches()
            pred.predict = predict
            batches = srv.batcher.stats["batches"] - stats0["batches"]
            samples = srv.batcher.stats["batched_samples"] - stats0["batched_samples"]
            outs = [_unpng(r[1]) for r in results]
            # every response is its group's row; every group's output is what the
            # predictor gives for the same batch (the daemon's shapes: 4 or 8 rows)
            row_of = {}
            for batch, out in groups:
                for j in range(len(batch)):
                    row_of[batch[j].tobytes()] = out[j]
            worst = max(int(np.abs(o.astype(int) - row_of[im[..., None].tobytes()].astype(int)).max())
                        for o, im in zip(outs, imgs))
            regroup = max(int(np.abs(predict(b).astype(int) - o.astype(int)).max())
                          for b, o in groups)
            alone_max, alone_mean = against_alone(outs, predict)
            mean_batch = samples / batches
            ok = (worst == 0 and regroup <= 1 and mean_batch > 1
                  and alone_max <= ALONE_MAX and alone_mean <= ALONE_MEAN
                  and launches["rdb5_bf16"] == 9 * batches)
            print(f"[extras] daemon bf16, 32 clients of {LR}^2 PNG: {batches} groups, mean "
                  f"batch {mean_batch:.2f} (bound > 1), rdb5_bf16 launches "
                  f"{launches['rdb5_bf16']} (want 9 x {batches}), tail_x4 {launches['tail_x4']}; "
                  f"responses against their group's rows max|diff| {worst} (want 0), groups "
                  f"against predict on the same batch {regroup} (bound 1), each image alone "
                  f"(a batch of 4 copies) max|diff| {alone_max} (bound {ALONE_MAX}), mean "
                  f"{alone_mean:.4f} (bound {ALONE_MEAN}) {'PASS' if ok else 'FAIL'}")
            check(ok, "the daemon's answers, batching or launch counts are wrong")

            # what moves a bf16 row with its batch: a batch of 8 images against
            # each alone, with the port's kernels and with none (cuDNN only)
            batch = np.stack(imgs[:BATCH])[..., None]
            batch_moves = {}
            for path in ("kernels", "cuDNN only"):
                with contextlib.ExitStack() as scopes:
                    if path == "cuDNN only":
                        scopes.enter_context(rdb5_schedule("naive"))
                        scopes.enter_context(no_tail_kernel())
                        scopes.enter_context(group_norm_kernel.PlainGroupNorm())
                    together = predict(batch).astype(int)
                    alone = np.stack([predict(im[None, ..., None])[0] for im in imgs[:BATCH]])
                    again = predict(batch).astype(int)
                d = np.abs(together - alone.astype(int))
                batch_moves[path] = (int(d.max()), float(d.mean()),
                                     int(np.abs(again - together).max()))
            print("[extras] bf16 predict, a batch of 8 images against each alone (a batch of "
                  "4 copies): " + "; ".join(
                      f"{k}: max|diff| {m} mean {a:.4f} (the batch twice: {r})"
                      for k, (m, a, r) in batch_moves.items()))

            # /reload to a cli.blend output of two checkpoint pairs
            sr2, c2 = cascade(torch.Generator().manual_seed(2))
            second = save_pair(sr2, c2, 2)
            blended = (os.path.join(tmp, "blend", "RDDBNet_A2C_x4_0003.npz"),
                       os.path.join(tmp, "blend", "ResDeconv_C2B_x4_0003.npz"))
            os.makedirs(os.path.dirname(blended[0]))
            for k in range(2):
                blend.main([first[k], second[k], "--alpha", "0.5", "--out", blended[k]])
            status, body = _post(port, "/reload", json.dumps(
                {"netGA": blended[0], "netGB": blended[1]}).encode())
            check(status == 200, f"/reload answered {status} {body!r}")
            status, body = _post(port, "/predict", bodies[0])
            after = _unpng(body).astype(int)
            fresh = CascadePredictor.from_checkpoints(*blended, bf16=True, pad_batch_to=4,
                                                      device=dev)
            want = fresh.predict(imgs[0][None, ..., None])[0].astype(int)
            d = np.abs(after - want).max()
            moved = np.abs(after - outs[0].astype(int)).mean()
            ok = status == 200 and d <= 1 and moved > 1
            print(f"[extras] /reload to the cli.blend (alpha 0.5) of two checkpoint pairs: "
                  f"against a fresh predictor on the blended files max|diff| {d} (bound 1); "
                  f"the output moved by {moved:.2f} LSB on average {'PASS' if ok else 'FAIL'}")
            check(ok, "the reloaded daemon does not serve the blended weights")

            daemon_load(port, bodies, card)

            # draining shutdown: a queued backlog is answered, none lost
            srv.shutdown()
            backlog = [rng.integers(0, 256, (2 * LR, 2 * LR, 1), dtype=np.uint8)
                       for _ in range(24)]
            got, errors = {}, []

            def submit(i):
                try:
                    got[i] = srv.batcher.submit(backlog[i])
                except Exception as e:  # noqa: BLE001 - counted below
                    errors.append(e)

            subs = [threading.Thread(target=submit, args=(i,)) for i in range(len(backlog))]
            requests0 = srv.batcher.stats["requests"]
            for t in subs:
                t.start()
            deadline = time.monotonic() + 30
            while (srv.batcher.stats["requests"] - requests0 < len(backlog)
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            with srv.batcher._lock:
                queued = sum(map(len, srv.batcher._queues.values()))
            serve.close(srv)
            for t in subs:
                t.join(timeout=60)
            ok = (not errors and len(got) == len(backlog) and queued > 0
                  and all(v.shape == (8 * LR, 8 * LR, 3) for v in got.values()))
            print(f"[extras] close() with {queued} of {len(backlog)} requests still queued: "
                  f"{len(got)} answered, {len(errors)} lost {'PASS' if ok else 'FAIL'}")
            check(ok, "the draining shutdown lost a request")
        finally:
            stop(srv, server)

        # fp32 (TF32 off), where a batch's shape cannot move a row by more
        # than rounding: every answer within 1 LSB of predict on its image alone
        srv, server = start()
        try:
            pred = srv.batcher.predictor
            b0 = srv.batcher.stats["batches"]
            outs = [_unpng(r[1]) for r in _burst(srv.server_address[1], bodies)]
            n_groups = srv.batcher.stats["batches"] - b0
            alone_max, alone_mean = against_alone(outs, pred.predict)
            ok = alone_max <= 1 and n_groups < len(imgs)
            print(f"[extras] daemon fp32 (TF32 off), 32 clients: {n_groups} groups; each "
                  f"response against predict on its image alone max|diff| {alone_max} (bound "
                  f"1), mean {alone_mean:.4f} {'PASS' if ok else 'FAIL'}")
            check(ok, "the fp32 daemon's answers stray from predict on each image alone")
        finally:
            stop(srv, server)
    return launches


def extras_export(dev, card: str, sr, c) -> dict:
    """(d) the torch.export artifact: bf16 at 128^2 with a symbolic batch,
    loaded on the card, against the predictor with its kernels scoped off."""
    import time

    from srcgan_tpu_torch.deploy import export_cascade, load_exported
    from srcgan_tpu_torch.models.blocks import rdb5_schedule
    from srcgan_tpu_torch.models.rddb import no_tail_kernel
    from srcgan_tpu_torch.ops.kernels import group_norm_kernel
    from srcgan_tpu_torch.serving import CascadePredictor

    pred = CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4, bf16=True, device=dev)
    t0 = time.perf_counter()
    blob = export_cascade(pred, h=LR, w=LR)
    t_export = time.perf_counter() - t0
    run = load_exported(blob, device=dev)
    rng = np.random.default_rng(18)
    xs = {n: rng.integers(0, 256, (n, LR, LR, 1), dtype=np.uint8) for n in (BATCH, 3)}
    reset_launches()
    outs = {n: run(x) for n, x in xs.items()}
    torch.cuda.synchronize()
    launches = kernel_launches()
    worst = 0
    with no_tail_kernel(), rdb5_schedule("naive"), group_norm_kernel.PlainGroupNorm():
        for n, x in xs.items():
            check(outs[n].shape == (n, 4 * LR, 4 * LR, 3), f"artifact output {outs[n].shape}")
            worst = max(worst, int(np.abs(outs[n].astype(int)
                                          - pred.predict(x).astype(int)).max()))
    ok = worst <= 1 and not any(launches.values())
    print(f"[extras] torch.export artifact, bf16, {LR}^2, symbolic batch: {len(blob) / 1e6:.2f} "
          f"MB, traced in {t_export:.1f} s; batches {BATCH} and 3 against the predictor with "
          f"its kernels scoped off max|diff| {worst} (bound 1); kernel launches while it ran "
          f"{launches} (want all 0) {'PASS' if ok else 'FAIL'}")
    check(ok, "the exported artifact strays from the predictor, or launched a kernel")
    x = xs[BATCH]
    art_ms = host_median_ms(lambda: run(x))
    pred_ms = host_median_ms(lambda: pred.predict(x))
    art_ms2 = host_median_ms(lambda: run(x))
    print(f"[extras] artifact at batch {BATCH} on {card}: {art_ms:.3f} / {art_ms2:.3f} ms "
          f"against the predictor with its kernels {pred_ms:.3f} ms (host clock, median of "
          f"{EXTRAS_REPS}, in turns)")
    return launches


def extras_eval_ensemble(dev, card: str) -> dict:
    """(e) cli.test_cas --self-ensemble on the card: RDDBNet x2 + ResDeconv at
    full width from random weights, 8 test pairs of 256^2 in batches of 4,
    fp32: one ssim launch per batch, a finite row, the PNGs written."""
    from srcgan_tpu_torch import data, interop, models
    from srcgan_tpu_torch.cli import test_cas
    from srcgan_tpu_torch.train.state import save_params

    gen = torch.Generator().manual_seed(19)
    sr, c = models.RDDBNet(1, 1, TRAIN_UP, generator=gen), models.ResDeconv(1, 3, generator=gen)
    with torch.no_grad():
        c.pred.weight.mul_(PRED_SCALE)
    n_test, batch = 8, 4
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ens_") as tmp:
        data.make_synthetic_dataset(os.path.join(tmp, "Sat2Aerx1"), n_train=2, n_val=2,
                                    n_test=n_test, size=EVAL_HW, seed=0, colorizable=True)
        nets = (os.path.join(tmp, f"RDDBNet_A2C_x{TRAIN_UP}_0001.npz"),
                os.path.join(tmp, f"ResDeconv_C2B_x{TRAIN_UP}_0001.npz"))
        for path, net in zip(nets, (sr, c)):
            save_params(path, interop.jax_tree_from_module(net)[0])
        reset_launches()
        row = test_cas.main(["--netGA", nets[0], "--netGB", nets[1], "--data-dir", tmp,
                             "--result-dir", os.path.join(tmp, "result"), "--batch-size",
                             str(batch), "--precision", "highest", "--self-ensemble"])
        torch.cuda.synchronize()
        launches = kernel_launches()
        n_pngs = sum(len(os.listdir(os.path.join(tmp, "result", f"{side}_RDDBNet_x{TRAIN_UP}_0001")))
                     for side in "AB")
    n_batches = n_test // batch
    ok = (row["images"] == n_test and row["device"].startswith("cuda")
          and launches["ssim"] == n_batches and n_pngs == 2 * n_test
          and all(math.isfinite(row[k]) for k in ("MSE", "PSNR", "AE", "SSIM")))
    print(f"[extras] cli.test_cas --self-ensemble on {card}: {row['images']} images in "
          f"{row['batches']} batches, ssim launches {launches['ssim']} (want {n_batches}), "
          f"PSNR {row['PSNR']:.5f} dB, SSIM {row['SSIM']:.6f}, {n_pngs} PNGs, "
          f"{row['eval_seconds']:.3f} s {'PASS' if ok else 'FAIL'}")
    check(ok, "test_cas --self-ensemble did not score every batch through the ssim kernel")
    return launches


def phase_serve_extras(dev, card: str) -> dict:
    """Phase 15, the serving extras (see the module docstring).  Returns each
    path's launch counts: tiled, ensemble, daemon, export, ensemble_eval."""
    import time

    t_phase = time.perf_counter()
    sr, c = cascade(torch.Generator().manual_seed(1))
    counts = {"tiled": extras_tiled(dev, card, sr, c),
              "ensemble": extras_ensemble(dev, card, sr, c),
              "daemon": extras_daemon(dev, card, sr, c),
              "export": extras_export(dev, card, sr, c),
              "ensemble_eval": extras_eval_ensemble(dev, card)}
    print(f"[extras] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


# The distillation slice: the serve cascade as teacher, ESPCN x4 + a fresh
# ResDeconv as student, batch 8 of 512^2 uint8 targets (the teacher's trunk at
# the serving shape (8,128,128,64)).
DISTILL_HW, DISTILL_STEPS, DISTILL_REPS, DISTILL_ALPHA = 512, 10, 5, 0.5
DISTILL_TRAIN, DISTILL_TEST, DISTILL_EVAL_HW = 16, 8, 256


def save_teacher(sr, c, directory: str):
    """The serve cascade as a name-encoded checkpoint pair (RDDBNet x4 +
    ResDeconv); returns the two paths."""
    from srcgan_tpu_torch import interop
    from srcgan_tpu_torch.train.state import checkpoint_name, save_params

    net_a = os.path.join(directory, checkpoint_name("RDDBNet", "A2C", 4, 1))
    net_b = os.path.join(directory, checkpoint_name("ResDeconv", "C2B", 4, 1))
    save_params(net_a, interop.jax_tree_from_module(sr)[0])
    save_params(net_b, interop.jax_tree_from_module(c)[0])
    return net_a, net_b


def distill_trainer(dev, teacher, **kw):
    from srcgan_tpu_torch.train.distill import DistillTrainer

    return DistillTrainer.from_checkpoints(*teacher, alpha=kw.pop("alpha", DISTILL_ALPHA),
                                           sr_model="ESPCN", c_model="ResDeconv", up=4,
                                           lr=TRAIN_LR, device=dev, **kw)


def device_busy_ms(fn) -> float:
    """Device time of one call of ``fn``: the sum of its kernels' own times
    (profiler)."""
    from torch import profiler

    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, for comparisons that must be bit-equal
    (a nondeterministic backward sums in another order on each call)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def phase_distill(dev, card: str) -> dict:
    """Phase 16, distillation and the perceptual term (see the module
    docstring).  Returns the launch counts of the distill steps and of
    test_cas on the student."""
    import time

    from srcgan_tpu_torch import data, losses_vgg
    from srcgan_tpu_torch.cli import convert_vgg, test_cas, train_cas
    from srcgan_tpu_torch.ops.kernels import tail_kernel
    from srcgan_tpu_torch.train.cas import CasTrainer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_distill_") as tmp:
        teacher = save_teacher(*cascade(torch.Generator().manual_seed(1)), tmp)

        # (a) the slice's path: 10 bf16 fused-input distill steps at batch 8 of 512^2
        rng = np.random.default_rng(40)
        shape = (TRAIN_BATCH, DISTILL_HW, DISTILL_HW, 3)
        src, tar = (torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
                    for _ in range(2))
        tr = distill_trainer(dev, teacher, act_dtype=torch.bfloat16, fused_input=True)
        state = tr.init(41)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        metrics = []
        for _ in range(DISTILL_STEPS):
            state, m = tr.train_step_u8(state, src, tar, TRAIN_LR)
            metrics.append(m)
        torch.cuda.synchronize()
        counts = kernel_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {"rdb5_bf16": 9 * DISTILL_STEPS, "gray_degrade": DISTILL_STEPS,
                "tail_x4": 2 * DISTILL_STEPS, "ssim": 0, "rdb5_int8": 0, "probes": 0}
        print(f"[distill] {DISTILL_STEPS} bf16 fused-input DistillTrainer steps (alpha "
              f"{DISTILL_ALPHA}, teacher RDDBNet x4 nf 64 nb 3 + ResDeconv, student ESPCN x4 + "
              f"ResDeconv, batch {TRAIN_BATCH} of {DISTILL_HW}^2, remat off): launches {counts} "
              f"(main {tail_kernel.launches}, finish {tail_kernel.finish_launches}); peak "
              f"{peak:.3f} GiB")
        check(counts == want and tail_kernel.launches == DISTILL_STEPS,
              f"a distill step did not launch 9 rdb5_bf16, 1 + 1 tail_x4 and 1 gray_degrade: "
              f"{counts}")
        loss = {k: [float(m[k]) for m in metrics] for k in ("loss_SR", "loss_C")}
        finite = all(math.isfinite(v) for vs in loss.values() for v in vs)
        falls = all(vs[-1] < vs[0] for vs in loss.values())
        print(f"[distill] loss_SR {loss['loss_SR'][0]:.5f} -> {loss['loss_SR'][-1]:.5f}, "
              f"loss_C {loss['loss_C'][0]:.5f} -> {loss['loss_C'][-1]:.5f}; finite {finite}, "
              f"both fall {falls} {'PASS' if finite and falls else 'FAIL'}")
        check(finite and falls, "distillation: a loss is not finite or does not fall")

        # (b) the step's ms in turns with the plain CasTrainer step; the teacher's device share
        plain = CasTrainer("ESPCN", "ResDeconv", up=4, lr=TRAIN_LR, act_dtype=torch.bfloat16,
                           fused_input=True, device=dev)
        p_state = plain.init(41)
        turns = in_turns_ms({"distill": lambda: tr.train_step_u8(state, src, tar, TRAIN_LR),
                             "plain": lambda: plain.train_step_u8(p_state, src, tar,
                                                                   TRAIN_LR)},
                            rounds=2, reps=DISTILL_REPS)
        real_bc, real_ba = tr._u8_inputs(src, tar)[2]
        sr_in, c_in = real_ba.to(torch.bfloat16), real_bc.to(torch.bfloat16)
        step_busy = device_busy_ms(lambda: tr.train_step_u8(state, src, tar, TRAIN_LR))
        teacher_busy = device_busy_ms(lambda: tr._distill_targets(sr_in, c_in))
        ms = {k: statistics.median(v) for k, v in turns.items()}
        print(f"[distill] bf16 step, batch {TRAIN_BATCH} of {DISTILL_HW}^2 on {card}: distill "
              f"{' / '.join(f'{v:.3f}' for v in turns['distill'])} ms, plain CasTrainer "
              f"{' / '.join(f'{v:.3f}' for v in turns['plain'])} ms (in turns, median of "
              f"{DISTILL_REPS}); +{ms['distill'] - ms['plain']:.3f} ms for the teacher; device "
              f"busy {step_busy:.3f} ms a step, of which the teacher's forward {teacher_busy:.3f}"
              f" ms = {100 * teacher_busy / step_busy:.1f}% (profiler)")
        check(step_busy > 0 and teacher_busy > 0, "the profiler saw no device time")
        del state, tr, plain, p_state
        torch.cuda.empty_cache()

        # (c) alpha = 1 is the CasTrainer step, bit for bit, on the card
        s_u8, t_u8 = (torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8))
                      .to(dev) for _ in range(2))
        with deterministic_cudnn():
            runs = []
            for t in (distill_trainer(dev, teacher, alpha=1.0, act_dtype=torch.bfloat16,
                                      fused_input=True),
                      CasTrainer("ESPCN", "ResDeconv", up=4, lr=TRAIN_LR,
                                 act_dtype=torch.bfloat16, fused_input=True, device=dev)):
                st = t.init(42)
                st, m = t.train_step_u8(st, s_u8, t_u8, TRAIN_LR)
                runs.append(([p.detach().clone() for r in ("sr", "c")
                              for p in getattr(st, r).model.parameters()], m))
        same = (all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
                and all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1]))
        print(f"[distill] alpha=1 step bit-equal to CasTrainer's on the card (cuDNN "
              f"deterministic): {'PASS' if same else 'FAIL'}")
        check(same, "the alpha=1 distill step differs from the CasTrainer step")

        # (d) one fp32 distill step (TF32 off) on the card against the CPU, phase 8's bounds
        phase_train_fp32(dev, lambda where: distill_trainer(where, teacher, fused_input=True),
                         tag="distill", warmup=True)

        # (e) the perceptual term: 3 bf16 steps at phase 8's shape, and its fp32 step vs the CPU
        vgg = losses_vgg.init_vgg_params(torch.Generator().manual_seed(0))
        ptr = slice_trainer(dev, act_dtype=torch.bfloat16, fused_input=True,
                            perceptual_params=vgg)
        pst = ptr.init(43)
        ps, pt = (torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3),
                                                dtype=np.uint8)).to(dev) for _ in range(2))
        pm = []
        for _ in range(3):
            pst, m = ptr.train_step_u8(pst, ps, pt, TRAIN_LR)
            pm.append({k: float(v) for k, v in m.items()})
        check(all(math.isfinite(v) for m in pm for v in m.values()),
              "a perceptual step's metrics are not finite")
        print(f"[perceptual] 3 bf16 CasTrainer steps with random VGG16 weights (batch "
              f"{TRAIN_BATCH} of {TRAIN_HW}^2): loss_SR {pm[0]['loss_SR']:.5f} -> "
              f"{pm[-1]['loss_SR']:.5f}, loss_C {pm[0]['loss_C']:.5f} -> {pm[-1]['loss_C']:.5f}, "
              f"finite PASS")
        del ptr, pst
        phase_train_fp32(dev, lambda where: slice_trainer(
            where, fused_input=True, perceptual_params=vgg), tag="perceptual", warmup=True)

        # (f) cli.convert_vgg on a torchvision-layout .pth written here
        g = torch.Generator().manual_seed(44)
        sd, cin = {}, 3
        for idx, kind, cout in losses_vgg._features_plan(losses_vgg.VGG16_CFG):
            if kind == "conv":
                sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=g)
                sd[f"features.{idx}.bias"] = torch.randn(cout, generator=g)
                cin = cout
        torch.save(sd, os.path.join(tmp, "vgg16.pth"))
        n = convert_vgg.convert(os.path.join(tmp, "vgg16.pth"), os.path.join(tmp, "vgg16.npz"))
        back = losses_vgg.load_vgg_params(os.path.join(tmp, "vgg16.npz"))
        same = n == 26 and all(torch.equal(p["w"], sd[f"features.{i}.weight"])
                               and torch.equal(p["b"], sd[f"features.{i}.bias"])
                               for i, p in back.items())
        print(f"[perceptual] cli.convert_vgg: {n} arrays, load_vgg_params gives the .pth's "
              f"tensors {'PASS' if same else 'FAIL'}")
        check(same, "convert_vgg's .npz does not hold the .pth's weights")

        # (g) cli.train_cas --distill-* for one epoch, then cli.test_cas on the student
        data_dir = os.path.join(tmp, "data")
        data.make_synthetic_dataset(os.path.join(data_dir, "Sat2Aerx1"), n_train=DISTILL_TRAIN,
                                    n_val=1, n_test=DISTILL_TEST, size=DISTILL_EVAL_HW, seed=0,
                                    colorizable=True)
        ck = os.path.join(tmp, "student")
        state = train_cas.main(["--data-dir", data_dir, "--SRModel", "ESPCN", "--CModel",
                                "ResDeconv", "--up", "4", "--batch-size", str(EVAL_BATCH),
                                "--bf16-acts", "--num-epochs", "1", "--save-every", "1",
                                "--log-every", "2", "--checkpoints", ck, "--run-dir",
                                os.path.join(tmp, "run"), "--distill-netGA", teacher[0],
                                "--distill-netGB", teacher[1]])
        check(state.sr.step == DISTILL_TRAIN // EVAL_BATCH, "train_cas --distill steps")
        net_a = os.path.join(ck, "ESPCN_A2C_x4_0001.npz")
        net_b = os.path.join(ck, "ResDeconv_C2B_x4_0001.npz")
        print()

        def evaluate(result, *extra):
            return test_cas.main(["--netGA", net_a, "--netGB", net_b, "--data-dir", data_dir,
                                  "--result-dir", os.path.join(tmp, result), "--batch-size",
                                  str(EVAL_BATCH), "--precision", "highest", *extra])

        reset_launches()
        on_card = evaluate("result")
        eval_counts = kernel_launches()
        n_batches = -(-DISTILL_TEST // EVAL_BATCH)
        on_cpu = evaluate("result_cpu", "--device", "cpu")
        d_psnr = abs(on_card["PSNR"] - on_cpu["PSNR"])
        d_ssim = abs(on_card["SSIM"] - on_cpu["SSIM"])
        ok = (eval_counts["ssim"] == n_batches and d_psnr <= 0.01 and d_ssim <= 1e-4
              and on_card["images"] == DISTILL_TEST)
        print(f"[distill] cli.train_cas --distill-netGA/--distill-netGB, one epoch of "
              f"{DISTILL_TRAIN} pairs of {DISTILL_EVAL_HW}^2, then cli.test_cas on the student "
              f"(batch {EVAL_BATCH}, fp32): launches {eval_counts} for {n_batches} batches; PSNR "
              f"{on_card['PSNR']:.5f} vs CPU {on_cpu['PSNR']:.5f} (|d| {d_psnr:.2e}, bound 0.01),"
              f" SSIM {on_card['SSIM']:.6f} vs {on_cpu['SSIM']:.6f} (|d| {d_ssim:.2e}, bound "
              f"1e-4) {'PASS' if ok else 'FAIL'}")
        check(ok, "test_cas on the distilled student: ssim launches or the row vs the CPU")
    print(f"[distill] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"distill": counts, "distill_eval": eval_counts}


# The data axis on one card: the training slice's step, world size 1.
AXIS_REPS = 10


def phase_data_axis(dev, card: str) -> dict:
    """Phase 17, the data axis over an NCCL process group of world size 1
    (see the module docstring).  One card shows no scaling: the two-rank
    arithmetic is held against the JAX package's 2-device mesh by the CPU
    tests (tests/test_torch_parallel.py, gloo).  Returns the launch counts
    of the data-parallel steps."""
    import time

    from srcgan_tpu_torch import config, parallel
    from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer
    from srcgan_tpu_torch.train.orbax_io import OrbaxCheckpointer

    t_phase = time.perf_counter()
    mesh = parallel.make_mesh((1,), ("data",))
    check(mesh.backend == "nccl" and mesh.device == dev, f"the mesh: {mesh}")
    rng = np.random.default_rng(50)
    shape = (TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3)
    src, tar = (torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
                for _ in range(2))
    tr = slice_trainer(dev, act_dtype=torch.bfloat16, fused_input=True)
    real_a, real_b, _ = tr._u8_inputs(src, tar)

    def params(state):
        return torch.cat([p.detach().reshape(-1).float() for r in ("sr", "c")
                          for p in getattr(state, r).model.parameters()])

    start = params(tr.init(51))
    try:
        with deterministic_cudnn():
            plain, _ = tr.train_step(tr.init(51), real_a, real_b, TRAIN_LR)
            want = params(plain)
            dp, _ = parallel.make_cas_dp_step(tr, mesh)(
                parallel.put_replicated(tr.init(51), mesh), real_a, real_b, TRAIN_LR)
            dp_same = torch.equal(params(dp), want)
            k_plain, _ = tr.train_steps_u8(tr.init(51), src[None].expand(2, *shape),
                                           tar[None].expand(2, *shape), TRAIN_LR)
            reset_launches()
            k_dp, _ = parallel.make_cas_dp_steps_u8(tr, mesh)(
                parallel.put_replicated(tr.init(51), mesh), src[None].expand(2, *shape),
                tar[None].expand(2, *shape), TRAIN_LR)
            torch.cuda.synchronize()
            counts = kernel_launches()
            u8_same = torch.equal(params(k_dp), params(k_plain))
            rel = {}
            z, _ = parallel.make_cas_zero1_step(tr, mesh)(parallel.zero1_init(tr, 51, mesh),
                                                          real_a, real_b, TRAIN_LR)
            rel["zero1"] = rel_l2(params(z) - start, want - start)
            f, _ = parallel.make_cas_fsdp_step(tr, mesh)(parallel.fsdp_init(tr, 51, mesh)[0],
                                                         real_a, real_b, TRAIN_LR)
            with parallel.gathered(f):
                rel["fsdp"] = rel_l2(params(f) - start, want - start)
        print(f"[data-axis] NCCL world 1 on {dev}: make_cas_dp_step bit-equal to the plain "
              f"step {dp_same}; make_cas_dp_steps_u8 (K=2, fused_input) bit-equal to "
              f"train_steps_u8 {u8_same}, launches {counts}; updates against the plain step's: "
              f"ZeRO-1 rel-L2 {rel['zero1']:.2e}, FSDP {rel['fsdp']:.2e} (bound 1e-6) "
              f"{'PASS' if dp_same and u8_same and max(rel.values()) <= 1e-6 else 'FAIL'}")
        check(dp_same and u8_same, "a world-1 DP step is not bit-equal to the plain step")
        check(counts["gray_degrade"] == 2, "the DP uint8 steps missed the gray_degrade kernel")
        check(max(rel.values()) <= 1e-6, "a ZeRO-1 / FSDP update strays from the plain step's")

        # the GAN's ZeRO-1 fused G+D iteration against gd_step, fp32 (TF32 off), 128^2
        with config.precision("fp32"), deterministic_cudnn():
            gtr = CycleGANTrainer(pool_size=0, device=dev)
            ga = torch.from_numpy(rng.uniform(0, 1, (2, GAN_CHECK_HW // 2, GAN_CHECK_HW // 2, 3))
                                  .astype(np.float32)).to(dev)
            gb = torch.from_numpy(rng.uniform(0, 1, (2, GAN_CHECK_HW, GAN_CHECK_HW, 3))
                                  .astype(np.float32)).to(dev)

            def gan_params(st):
                return torch.cat([p.detach().reshape(-1) for r in ("g", "d")
                                  for p in getattr(st, r).model.parameters()])

            g0 = gan_params(gtr.init(52))
            ref, _ = gtr.gd_step(gtr.init(52), ga, gb, 1e-4, 1e-5)
            zg, _ = parallel.make_gd_zero1_step(gtr, mesh)(
                parallel.zero1_gd_from_state(gtr.init(52), mesh), ga, gb, 1e-4, 1e-5)
            g_rel = rel_l2(gan_params(zg) - g0, gan_params(ref) - g0)
        print(f"[data-axis] make_gd_zero1_step (CycleGAN net='1', batch 2 of {GAN_CHECK_HW}^2, "
              f"fp32) against gd_step: update rel-L2 {g_rel:.2e} (bound 1e-6) "
              f"{'PASS' if g_rel <= 1e-6 else 'FAIL'}")
        check(g_rel <= 1e-6, "the GAN ZeRO-1 update strays from gd_step's")
        del gtr, ref, zg

        # torch.distributed.checkpoint: a ZeRO-1 and an FSDP state, saved and restored
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dcp_") as tmp:
            secs = {}
            for name, state, fresh in (("zero1", z, lambda: parallel.zero1_init(tr, 53, mesh)),
                                       ("fsdp", f, lambda: parallel.fsdp_init(tr, 53, mesh)[0])):
                ck = OrbaxCheckpointer(os.path.join(tmp, name), max_to_keep=1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ck.save(1, state, {"epoch": 1})
                secs[f"{name} save"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                like, extra = ck.restore(fresh())
                torch.cuda.synchronize()
                secs[f"{name} restore"] = time.perf_counter() - t0
                a, b = parallel.fsdp_full_params(state), parallel.fsdp_full_params(like)
                same = (extra == {"epoch": 1} and all(torch.equal(a[r][k], b[r][k])
                                                      for r in a for k in a[r])
                        and all(torch.equal(x, y) for t1, t2 in zip(state, like)
                                for x, y in zip(t1.opt.moments()[:2], t2.opt.moments()[:2])))
                check(same, f"the {name} state does not restore bit-equal")
        nbytes = sum(p.numel() for r in ("sr", "c") for p in getattr(tr.init(0), r)
                     .model.parameters()) * 4
        print(f"[data-axis] torch.distributed.checkpoint round trip bit-equal (parameters, "
              f"both moments): " + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items())
              + f" ({nbytes / 2 ** 20:.1f} MiB of parameters, x3 with the moments) PASS")
        del z, f

        # the world-1 DP step's ms in turns with the plain step
        st_p = tr.init(54)
        st_d = parallel.put_replicated(tr.init(54), mesh)
        dp_step = parallel.make_cas_dp_step(tr, mesh)
        turns = in_turns_ms({"plain": lambda: tr.train_step(st_p, real_a, real_b, TRAIN_LR),
                             "dp": lambda: dp_step(st_d, real_a, real_b, TRAIN_LR)},
                            rounds=2, reps=AXIS_REPS)
        print(f"[data-axis] bf16 step, batch {TRAIN_BATCH} of {TRAIN_HW}^2 on {card}: plain "
              f"{' / '.join(f'{v:.3f}' for v in turns['plain'])} ms, world-1 DP (one NCCL "
              f"all-reduce of the gradients, model states and metrics) "
              f"{' / '.join(f'{v:.3f}' for v in turns['dp'])} ms (in turns, median of "
              f"{AXIS_REPS})")
    finally:
        parallel.destroy_mesh()
    print(f"[data-axis] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


class _Lockstep:
    """Runs n strip functions in threads on one card, one thread at a time:
    a thread runs until it waits for a neighbour's halo rows or a sum, then
    hands the turn on.  The strips' messages go through mailboxes in this
    process, so each strip's halo comes from its neighbours' rows as the
    ranks' exchanges would bring it; one thread at a time keeps the launch
    counters exact."""

    def __init__(self, n: int):
        import threading

        self.n, self.cv, self.turn = n, threading.Condition(), 0
        self.done = [False] * n
        self.mail = {}
        self.sums = {}

    def _hand_on(self, i: int) -> None:
        for k in range(1, self.n + 1):
            j = (i + k) % self.n
            if not self.done[j]:
                self.turn = j
                break
        self.cv.notify_all()

    def wait_for(self, i: int, ready) -> None:
        """Hand the turn on until ``ready()`` holds on this thread's turn
        (called with the lock held)."""
        while not ready():
            self._hand_on(i)
            self.cv.wait_for(lambda: self.turn == i)

    def run(self, fns) -> list:
        import threading

        out, errors = [None] * self.n, []

        def body(i):
            with self.cv:
                self.cv.wait_for(lambda: self.turn == i)
            try:
                out[i] = fns[i]()
            except BaseException as e:       # raised again in the caller
                errors.append(e)
                raise
            finally:
                with self.cv:
                    self.done[i] = True
                    self._hand_on(i)

        threads = [threading.Thread(target=body, args=(i,)) for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def _local_strip(lockstep: _Lockstep, i: int):
    """A ``parallel.spatial.SpaceScope`` for strip i of the lockstep, its
    messages through the lockstep's mailboxes."""
    from collections import deque

    from srcgan_tpu_torch.parallel.spatial import SpaceScope

    class LocalStrip(SpaceScope):
        def __init__(self):
            n = lockstep.n
            super().__init__(None, i - 1 if i > 0 else None, i + 1 if i + 1 < n else None,
                             True)
            self.calls = 0

        def transfer(self, sends, recvs):
            peers = {"prev": self.prev, "next": self.next}
            with lockstep.cv:
                for side, t in sends:
                    if peers[side] is not None and t.numel():
                        lockstep.mail.setdefault((i, peers[side]), deque()).append(t.clone())
                for side, b in recvs:
                    if peers[side] is not None and b.numel():
                        box = lockstep.mail.setdefault((peers[side], i), deque())
                        lockstep.wait_for(i, lambda: len(box) > 0)
                        b.copy_(box.popleft())

        def total(self, t, stats=False):
            key, self.calls = self.calls, self.calls + 1
            with lockstep.cv:
                parts = lockstep.sums.setdefault(key, {})
                parts[i] = t
                lockstep.wait_for(i, lambda: len(parts) == lockstep.n)
                return sum(parts[j] for j in range(lockstep.n))

    return LocalStrip()


def strips_in_turns(n: int, fn) -> list:
    """fn(i) of each of n strips under its local scope, in lockstep."""
    from srcgan_tpu_torch.parallel import spatial

    lock = _Lockstep(n)

    def run(i):
        with spatial.activate(_local_strip(lock, i)):
            return fn(i)

    return lock.run([lambda i=i: run(i) for i in range(n)])


AXES_GRAD_HW = 64


def phase_axes(dev, card: str) -> dict:
    """Phase 18, the space, model and pipe axes (see the module docstring).
    Returns the launch counts of the strip runs, the world-1 sharded
    predictor and the world-1 (data, space) uint8 step."""
    import time

    from srcgan_tpu_torch import config, parallel
    from srcgan_tpu_torch.parallel import axes_check, spatial, steps_check
    from srcgan_tpu_torch.serving import CascadePredictor, SpatialShardedPredictor

    t_phase = time.perf_counter()
    sr, c = cascade(torch.Generator().manual_seed(1))
    preds = {mode: CascadePredictor(copy.deepcopy(sr), copy.deepcopy(c), 4,
                                    bf16=mode == "bf16", device=dev) for mode in ("fp32", "bf16")}
    pred = preds["bf16"]
    x = np.random.default_rng(60).integers(0, 256, (BATCH, LR, LR, 1), dtype=np.uint8)
    wants = {mode: p.predict(x).astype(int) for mode, p in preds.items()}
    want = wants["bf16"]
    # the bf16 cascade's own rounding noise, against fp32
    noise = np.abs(want - wants["fp32"])
    xd = torch.from_numpy(x).to(dev)
    x_sr = (xd.float() / 255.0).permute(0, 3, 1, 2).to(torch.bfloat16,
                                                       memory_format=torch.channels_last)
    with torch.no_grad(), config.precision("bf16"):
        trunk_want = pred.sr_model(x_sr)
    totals = dict.fromkeys(kernel_launches(), 0)

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    def within_noise(got: np.ndarray):
        """(max and mean |got - fp32 cascade|, whether they stay within the
        bf16 cascade's own: its mean + 10%, its share of values beyond 1 LSB
        + 10% + 1 point)"""
        d = np.abs(got.astype(int) - wants["fp32"])
        return d.max(), d.mean(), (d.mean() <= 1.1 * noise.mean()
                                   and (d > 1).mean() <= 1.1 * (noise > 1).mean() + 0.01)

    geometry = spatial.cascade_geometry(pred.sr_model, pred.c_model, 4)
    print(f"[axes] the bf16 CascadePredictor against the fp32 one, (batch {BATCH} of {LR}^2): "
          f"max |diff| {noise.max()} LSB, mean {noise.mean():.4f}, {(noise > 1).mean():.2%} "
          f"of values beyond 1 LSB: the bf16 cascade's own rounding noise")
    for n in (2, 4):
        plan = spatial.plan_strips(LR, n, *geometry)
        stitched = {}
        for mode in ("fp32", "bf16"):
            reset_launches()
            outs = strips_in_turns(n, lambda i: preds[mode]._run(plan.cut(xd, i)))
            torch.cuda.synchronize()
            counts = kernel_launches()
            stitched[mode] = torch.cat(outs, 1).cpu().numpy()
        add(counts)
        diff32 = int(np.abs(stitched["fp32"].astype(int) - wants["fp32"]).max())
        diff = int(np.abs(stitched["bf16"].astype(int) - want).max())
        dmax, dmean, quiet = within_noise(stitched["bf16"])

        def trunk(i):
            with torch.no_grad(), config.precision("bf16"):
                return pred.sr_model(plan.cut(x_sr, i, dim=2))

        trunk_got = torch.cat(strips_in_turns(n, trunk), 2)
        dtrunk = (trunk_got.float() - trunk_want.float()).abs().max().item()
        ok = (diff32 <= 1 and quiet and counts["rdb5_bf16"] == 9 * n
              and counts["tail_x4"] == 2 * n
              and counts["gray_degrade"] == counts["ssim"] == counts["rdb5_int8"] == 0)
        print(f"[axes] cascade, batch {BATCH} of {LR}^2, in {n} strips {plan.heights} (halos "
              f"from the neighbours' rows, one thread a strip in turns): fp32 stitched vs "
              f"CascadePredictor max |diff| {diff32} LSB (bound 1); bf16 stitched vs the bf16 "
              f"CascadePredictor max |diff| {diff} LSB, vs the fp32 cascade max {dmax} / mean "
              f"{dmean:.4f} (bound: the bf16 predictor's own mean +10%, its share beyond 1 LSB +10% +1 point); bf16 RDDBNet "
              f"output max |diff| {dtrunk:.3e}; bf16 launches {counts} (want rdb5_bf16 9 and "
              f"tail_x4 1 + 1 a strip) {'PASS' if ok else 'FAIL'}")
        check(ok, f"the cascade in {n} strips")

    mesh = parallel.make_mesh((1,), ("space",))
    try:
        check(mesh.backend == "nccl", f"the mesh: {mesh}")
        got = {}
        for mode, p in preds.items():
            sharded = SpatialShardedPredictor(copy.deepcopy(p.sr_model),
                                              copy.deepcopy(p.c_model), 4, bf16=mode == "bf16",
                                              mesh=mesh, device=dev)
            reset_launches()
            got[mode] = sharded.predict(x).astype(int)
            torch.cuda.synchronize()
            del sharded
        counts = kernel_launches()
        add(counts)
        diff32 = int(np.abs(got["fp32"] - wants["fp32"]).max())
        dmax, dmean, quiet = within_noise(got["bf16"])
        ok = diff32 <= 1 and quiet and counts["rdb5_bf16"] == 9 and counts["tail_x4"] == 2
        print(f"[axes] SpatialShardedPredictor on an NCCL space mesh of 1: fp32 max |diff| "
              f"{diff32} LSB (bound 1), bit-equal {bool((got['fp32'] == wants['fp32']).all())}; "
              f"bf16 max |diff| {int(np.abs(got['bf16'] - want).max())} LSB, bit-equal "
              f"{bool((got['bf16'] == want).all())}, vs the fp32 cascade max {dmax} / mean "
              f"{dmean:.4f} (the bf16 predictor's own bound); bf16 launches {counts} "
              f"{'PASS' if ok else 'FAIL'}")
        check(ok, "the world-1 sharded predictor")

        rng = np.random.default_rng(61)
        shape = (2, AXES_GRAD_HW, AXES_GRAD_HW, 3)
        src, tar = (torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
                    for _ in range(2))
        rows = []
        with config.precision("fp32"), deterministic_cudnn():
            tr = slice_trainer(dev)
            real_a, real_b, _ = tr._u8_inputs(src, tar)
            plain, _, _ = tr.grads(tr.init(62), real_a, real_b)
            for axes, make in ((("space",), parallel.make_cas_2d_step),
                               (("data", "space"), parallel.make_cas_2d_step),
                               (("model",), parallel.make_cas_tp_step),
                               (("data", "model"), parallel.make_cas_tp_step)):
                m = parallel.make_mesh((1,) * len(axes), axes)
                g = make(tr, m).grads(tr.init(62), real_a, real_b)
                worst = max((rel_l2(g[r][k], plain[r][k]), f"{r}.{k}")
                            for r in plain for k in plain[r])
                rows.append((axes, worst))
        for axes, (err, at) in rows:
            print(f"[axes] fp32 gradients (TF32 off, batch 2 of {AXES_GRAD_HW}^2, the training "
                  f"slice) on a world-1 {' x '.join(axes)} mesh against the plain step's: max "
                  f"per-tensor rel-L2 {err:.2e} at {at} (bound 1e-5) "
                  f"{'PASS' if err <= 1e-5 else 'FAIL'}")
        check(all(err <= 1e-5 for _, (err, _) in rows), "a world-1 step's gradients")

        m2 = parallel.make_mesh((1, 1), ("data", "space"))
        tr = slice_trainer(dev, act_dtype=torch.bfloat16, fused_input=True)
        reset_launches()
        state, met = parallel.make_cas_2d_steps_u8(tr, m2)(tr.init(63), src[None], tar[None],
                                                          TRAIN_LR)
        torch.cuda.synchronize()
        counts = kernel_launches()
        add(counts)
        finite = all(bool(torch.isfinite(v).all()) for v in met.values())
        print(f"[axes] bf16 fused-input (data, space) uint8 step on a world-1 mesh: metrics "
              f"finite {finite}; launches {counts} {'PASS' if finite else 'FAIL'}")
        check(finite and counts["gray_degrade"] == 1, "the world-1 (data, space) uint8 step")
    finally:
        parallel.destroy_mesh()

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[axes] {cards} card: the cascade pipeline (2 ranks), the trunk pipeline "
              f"(nb=3, 3 ranks), the sharded predictor at 2 and 4 ranks and steps_check "
              f"--axes were not run; they run where the host has 2 or more cards")
    else:
        rows = axes_check.cards(cards)
        check(all(b is None or v <= b for _, v, b in rows), "a reading on the cards")
        ranks = cards - cards % 2
        check(steps_check.cli(["--ranks", str(ranks), "--axes"]) == 0,
              f"steps_check --axes on {ranks} cards")
    print(f"[axes] phase took {time.perf_counter() - t_phase:.1f} s")
    return totals


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

    builds = [(k, ()) for k in KERNELS] + list(YARDSTICKS)
    with ThreadPoolExecutor(len(builds)) as pool:
        built = list(pool.map(lambda b: build.build(*b), builds))
    for path, seconds, log in built:
        print(f"[build] {path.name}: nvcc {seconds:.1f} s")
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "wgmma", "C75")):
                print(f"[build]   {line.strip()}")

    where = f"{card} ({smi})"
    tail = phase_kernels(dev, where)
    gray = phase_gray_degrade(dev, where)
    ssim = phase_ssim(dev, where)
    rdb5_bf16, rdb5_int8 = phase_rdb5(dev, where)
    gn = phase_group_norm(dev, where)
    sr, c = cascade(torch.Generator().manual_seed(1))
    x_small, fp32_small = phase_fp32(dev, sr, c)
    tail["launches"], gn["launches"] = phase_serve(dev, where, sr, c, x_small, fp32_small)
    rdb5_bf16["launches"] = phase_trunk(dev, where, sr, c)
    rdb5_int8["launches"] = phase_int8(dev, where, sr, c)
    phase_train_fp32(dev)
    gray["launches"] = phase_train(dev, where)
    ssim["launches"] = phase_eval(dev, where)
    probes = phase_probes(dev, where)
    lab = phase_lab(dev, where, sr, c, x_small)
    tail["launches_lab"], ssim["launches_lab"] = lab["tail_x4"], lab["ssim"]
    del sr, c
    ssim["launches_gan"] = phase_gan(dev, where)
    mt = phase_multitask(dev, where)
    zoo, zoo_eval = phase_zoo(dev, where)
    extras = phase_serve_extras(dev, where)
    extras.update(phase_distill(dev, where))
    extras["data_axis"] = phase_data_axis(dev, where)
    extras["axes"] = phase_axes(dev, where)
    for entry, key in ((tail, "tail_x4"), (gray, "gray_degrade"), (ssim, "ssim"),
                       (rdb5_bf16, "rdb5_bf16"), (rdb5_int8, "rdb5_int8"),
                       *((p, "probes") for p in probes)):
        entry.update(launches_multitask=mt[key], launches_zoo=zoo[key],
                     launches_zoo_eval=zoo_eval[key],
                     **{f"launches_{path}": n[key] for path, n in extras.items()})

    gn["launches_tiled"] = extras["tiled"]["group_norm"]
    print(json.dumps({"kernels": [tail, gray, ssim, rdb5_bf16, rdb5_int8, *probes, gn]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
