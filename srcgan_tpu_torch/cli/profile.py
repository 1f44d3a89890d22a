"""Profiling driver: per-step timing of the cascade train step, with an
optional ``torch.profiler`` trace, as ``srcgan_tpu.cli.profile``.

  python -m srcgan_tpu_torch.cli.profile --SRModel RDDBNet --up 2 --steps 20 \\
      [--trace-dir runs/trace] [--bf16 | --bf16-acts] [--cost-analysis]

Times ``CasTrainer.train_step`` with the warm-up steps left out; every timed
step ends in a read of its loss, which waits for the device.  With
--trace-dir the timed steps are traced (``utils.logging.profile_trace``, for
TensorBoard).  --cost-analysis counts the step's FLOPs
(``torch.utils.flop_counter``) and prints the least time the card could
take for them: the larger of the FLOPs at the card's peak for the step's
type and the bytes the step must move (the two input batches once; every
parameter and its two Adam moments read and written once) at its memory
rate, and on the card the share of the measured step that bound is.  Runs
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json

# The card's published peaks (H100 SXM, dense) that a bound is taken against.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}


def build_parser():
    p = argparse.ArgumentParser(description="train-step profiler")
    p.add_argument("--SRModel", type=str, default="RDDBNet")
    p.add_argument("--CModel", type=str, default="ResDeconv")
    p.add_argument("--up", type=int, default=2)
    p.add_argument("--const", action="store_true")
    p.add_argument("--lab", action="store_true")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--bf16", action="store_true",
                   help="TF32 convolutions and matmuls on fp32 tensors (default: "
                        "fp32 with TF32 off)")
    p.add_argument("--bf16-acts", action="store_true",
                   help="profile the mixed-precision step (bf16 activations, fp32 "
                        "masters: train_cas --bf16-acts)")
    p.add_argument("--trace-dir", type=str, default=None)
    p.add_argument("--cost-analysis", action="store_true",
                   help="count the step's FLOPs and print its least time at the "
                        "card's peaks (and, on the card, the achieved share)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import contextlib

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.train.cas import CasTrainer
    from srcgan_tpu_torch.utils.logging import StepTimer, profile_trace

    device = config.resolve_device(args.device)
    mode = "bf16" if args.bf16_acts else "tf32" if args.bf16 else "fp32"
    trainer = CasTrainer(sr_model=args.SRModel, c_model=args.CModel, up=args.up,
                         const=args.const, lab=args.lab,
                         act_dtype=torch.bfloat16 if args.bf16_acts else None, device=device)
    state = trainer.init(0)
    rng = np.random.default_rng(0)
    tar = torch.from_numpy(rng.uniform(
        0, 1, (args.batch_size, args.size, args.size, 3)).astype(np.float32)).to(device)
    src = (tar * torch.tensor([0.2125, 0.7154, 0.0721], device=device)).sum(-1, keepdim=True)

    with config.precision(mode):
        state, m = trainer.train_step(state, src, tar, 1e-4)     # cuDNN chooses here
        float(m["loss_SR"])
        cost = None
        if args.cost_analysis:
            counter = FlopCounterMode(display=False)
            with counter:
                state, m = trainer.train_step(state, src, tar, 1e-4)
                float(m["loss_SR"])
            n_param = sum(p.numel() for ts in state for p in ts.model.parameters())
            nbytes = (src.numel() + tar.numel()) * 4 + 6 * 4 * n_param
            flops = counter.get_total_flops()
            t_ops = flops / PEAK_FLOPS[mode]
            t_bytes = nbytes / HBM_BYTES_PER_S
            cost = {"flops": flops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "peaks": f"H100 SXM: {PEAK_FLOPS[mode] / 1e12:g} TFLOP/s {mode}, "
                             f"{HBM_BYTES_PER_S / 1e12:g} TB/s"}

        timer = StepTimer(warmup=args.warmup)
        trace = profile_trace(args.trace_dir) if args.trace_dir else contextlib.nullcontext()
        with trace:
            for _ in range(args.steps):
                with timer:
                    state, m = trainer.train_step(state, src, tar, 1e-4)
                    float(m["loss_SR"])      # waits for the step
    if args.trace_dir:
        print(f"trace written to {args.trace_dir}")

    summary = timer.summary()
    summary.update({
        "samples_per_s": round(args.batch_size / summary["p50_s"], 2),
        "config": f"{args.SRModel}+{args.CModel} x{args.up} bs={args.batch_size} "
                  f"{args.size}^2 {'bf16acts' if args.bf16_acts else mode}",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    })
    if cost is not None:
        summary["cost_analysis"] = cost
        if device.type == "cuda":
            summary["achieved_tflops"] = round(cost["flops"] / summary["p50_s"] / 1e12, 3)
            summary["fraction_of_bound"] = round(cost["bound_ms"] / 1e3 / summary["p50_s"], 4)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
