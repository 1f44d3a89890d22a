"""Cascaded SR -> colorization training tool, as ``srcgan_tpu.cli.train_cas``.

  python -m srcgan_tpu_torch.cli.train_cas --SRModel RDDBNet --CModel ResDeconv --up 2
  python -m srcgan_tpu_torch.cli.train_cas --const      # constant-resolution pipeline

Every flag of the JAX package's tool keeps its name.  Checkpoints keep the
name-encoded convention, as .npz parameter trees that either package loads,
plus the full train state for ``--resume``.  Runs on the card unless
``--device cpu`` is given.  Flags whose machinery is still to be ported
(the mesh family, orbax, the perceptual and distillation losses, LAB) exit
at once with the ROADMAP item that brings them.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

METRIC_KEYS = ("loss_SR", "loss_C", "psnr_SR", "psnr_C")


def build_parser():
    p = argparse.ArgumentParser(description="cascaded SR->colorization training")
    p.add_argument("--SRModel", type=str, default="ESPCN")
    p.add_argument("--CModel", type=str, default="ResDeconv")
    p.add_argument("--up", type=int, default=2)
    p.add_argument("--const", action="store_true",
                   help="constant-resolution pipeline (down, then up, degrade)")
    p.add_argument("--lab", action="store_true",
                   help="LAB colour space: not ported yet (ROADMAP A9); exits")
    p.add_argument("--root", type=str, default="Sat2Aerx1")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-policy", type=str, default="cosine")
    p.add_argument("--num-epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--save-every", type=int, default=25)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--checkpoints", type=str, default="./checkpoints")
    p.add_argument("--mesh-size", type=int, default=0,
                   help="devices on the data axis: not ported yet (ROADMAP A14); "
                        "a value above 1 exits")
    p.add_argument("--space-size", type=int, default=0,
                   help="extra mesh axis over image height: not ported yet "
                        "(ROADMAP A14); a value above 1 exits")
    p.add_argument("--fsdp", action="store_true",
                   help="sharded parameters and moments: not ported yet "
                        "(ROADMAP A14); exits")
    p.add_argument("--zero-opt", action="store_true",
                   help="sharded optimizer state: not ported yet (ROADMAP A14); "
                        "exits")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run-dir", type=str, default="runs/latest",
                   help="per-run log dir: loss history (losses.jsonl) + "
                        "live image windows (one PNG per window name)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize network activations "
                        "(torch.utils.checkpoint) for large tiles / deep models")
    p.add_argument("--augment", action="store_true",
                   help="random per-sample D4 rotation/flip applied to both "
                        "images of each training pair (deterministic per "
                        "--seed/epoch)")
    p.add_argument("--workers", type=int, default=2,
                   help="host decode threads; 0 = in-line decode")
    p.add_argument("--cache", action="store_true",
                   help="decode PNGs once into a raw uint8 cache; later "
                        "epochs memmap it")
    p.add_argument("--bf16", action="store_true",
                   help="reduced-precision tensor-core feed with fp32 tensors: "
                        "on the card that is TF32 for convolutions and matmuls "
                        "(without this flag the step runs in fp32 with TF32 off)")
    p.add_argument("--bf16-acts", action="store_true",
                   help="run the networks in bf16: activations and the "
                        "parameters' working copies (fp32 master parameters + "
                        "fp32 Adam)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="maintain an exponential moving average of the "
                        "weights (e.g. 0.999) and save it under "
                        "<checkpoints>/ema/ with the standard names")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="split each batch into K microbatches and accumulate "
                        "gradients (peak activation memory of batch/K; same "
                        "update as the full batch)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run K optimization steps per trainer call: K uint8 "
                        "batches are stacked into one host-to-device block and "
                        "the host reads the metrics once per K steps")
    p.add_argument("--resume", action="store_true",
                   help="resume from <checkpoints>/casstate_latest.npz "
                        "(full state: params + Adam moments + epoch)")
    p.add_argument("--orbax-dir", type=str, default=None,
                   help="orbax full-state checkpoints: not ported yet "
                        "(ROADMAP A14); exits")
    p.add_argument("--keep-last", type=int, default=0,
                   help="retain only the newest K checkpoint epochs "
                        "(0 = keep all)")
    p.add_argument("--keep-best", type=int, default=0,
                   help="additionally retain the K best epochs by "
                        "training-validation PSNR")
    p.add_argument("--early-stop-patience", type=int, default=0,
                   help="stop when epoch-mean validation PSNR hasn't improved "
                        "for K epochs (0 = off)")
    p.add_argument("--early-stop-delta", type=float, default=0.0,
                   help="minimum PSNR improvement (dB) to reset patience")
    p.add_argument("--perceptual", type=str, default=None,
                   help="VGG16 perceptual term: not ported yet (ROADMAP A13); exits")
    p.add_argument("--perceptual-weight", type=float, default=1.0)
    p.add_argument("--distill-netGA", type=str, default=None,
                   help="teacher SR checkpoint: distillation is not ported yet "
                        "(ROADMAP A13); exits")
    p.add_argument("--distill-netGB", type=str, default=None,
                   help="teacher colorizer checkpoint (pairs with --distill-netGA)")
    p.add_argument("--distill-alpha", type=float, default=0.5)
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    from srcgan_tpu_torch.utils.live import add_live_flag
    add_live_flag(p)
    return p


def _refuse_unported(args) -> None:
    """Exit, before any work, on a flag whose machinery is still to be ported."""
    mesh = [flag for flag, on in (("--mesh-size", args.mesh_size > 1),
                                  ("--space-size", args.space_size > 1),
                                  ("--fsdp", args.fsdp), ("--zero-opt", args.zero_opt),
                                  ("--orbax-dir", args.orbax_dir)) if on]
    if mesh:
        sys.exit(f"{', '.join(mesh)}: the parallel stack and orbax are still to be "
                 "ported (ROADMAP A14)")
    extra = [flag for flag, on in (("--perceptual", args.perceptual),
                                   ("--distill-netGA", args.distill_netGA),
                                   ("--distill-netGB", args.distill_netGB)) if on]
    if extra:
        sys.exit(f"{', '.join(extra)}: the perceptual and distillation losses are "
                 "still to be ported (ROADMAP A13)")
    if args.lab:
        sys.exit("--lab needs the LAB colour ops (ROADMAP A9)")


def _stacked_blocks(it, k):
    """Group up to ``k`` consecutive same-shape (src, tar) uint8 batches from
    a ``data.batches`` iterator and stack them with a leading steps axis:
    the input blocks of ``CasTrainer.train_steps_u8``.  A ragged epoch tail
    (or a batch-size change) flushes early, producing a shorter block."""
    buf = []

    def flush():
        return (np.stack([s for s, _ in buf]), np.stack([t for _, t in buf]))

    for src, tar, _ in it:
        if buf and src.shape != buf[-1][0].shape:
            yield flush()
            buf = []
        buf.append((src, tar))
        if len(buf) == k:
            yield flush()
            buf = []
    if buf:
        yield flush()


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    # Preemption safety: register the SIGTERM flag handler FIRST, so a signal
    # during setup is not fatal.  The loop checks the flag after every trainer
    # call, saves the FULL train state and returns, so --resume redoes the
    # interrupted epoch.  The finally restores the previous handler on EVERY
    # exit path (the non-finite-loss error too), so a later caller in the same
    # process does not inherit a handler that swallows SIGTERM.
    import signal

    preempted = {"flag": False}
    prev_handler = signal.signal(signal.SIGTERM,
                                 lambda s_, f_: preempted.update(flag=True))
    from srcgan_tpu_torch.utils import live as live_mod
    live = live_mod.maybe_start(args, run_dir=args.run_dir)
    try:
        return _run(args, preempted)
    finally:
        if live is not None:
            live.stop()
        signal.signal(signal.SIGTERM, prev_handler)


def _run(args, preempted):
    import torch

    from srcgan_tpu_torch import config, data, interop
    from srcgan_tpu_torch.data import preprocess
    from srcgan_tpu_torch.train.cas import CasTrainer
    from srcgan_tpu_torch.train.retention import CheckpointManager, EarlyStopper
    from srcgan_tpu_torch.train.state import (checkpoint_name, load_train_state,
                                              save_params, save_train_state)
    from srcgan_tpu_torch.utils import Logger

    device = config.resolve_device(args.device)
    mode = "bf16" if args.bf16_acts else "tf32" if args.bf16 else "fp32"
    ver = "G2RGB"
    trainer = CasTrainer(
        sr_model=args.SRModel, c_model=args.CModel, up=args.up, lr=args.lr,
        const=args.const, lr_policy=args.lr_policy, num_epochs=args.num_epochs,
        remat=args.remat, act_dtype=torch.bfloat16 if args.bf16_acts else None,
        device=device)
    state = trainer.init(args.seed)
    start_epoch = 1
    state_path = os.path.join(args.checkpoints, "casstate_latest.npz")

    if args.resume and os.path.exists(state_path):
        state, extra = load_train_state(state_path, state)
        start_epoch = int(extra.get("epoch", 0)) + 1
        print(f"resumed from {state_path} at epoch {start_epoch}")

    ema = None
    if args.ema_decay > 0:
        if args.grad_accum > 1:
            raise SystemExit("--ema-decay currently composes with the plain "
                             "single-device step only")
        ema = trainer.ema_init(state)      # after the restore: from its weights
    if args.steps_per_dispatch > 1 and (args.grad_accum > 1 or ema is not None):
        raise SystemExit("--steps-per-dispatch composes with the plain "
                         "single-device step (not --grad-accum/--ema-decay)")

    def _save_full_state(extra):
        save_train_state(state_path, state, extra=extra)

    if args.data_dir:
        trainset = data.FileListDataset(args.root, "train", ver, args.data_dir)
    else:
        trainset, _, _ = data.load_dataset(args.root, ver)
    if args.cache:
        trainset = data.CachedDataset(trainset)
    print(f"Starting Training Loop... ({len(trainset)} samples, ver={ver}, "
          f"const={args.const}, up={args.up}, device={device})")
    logger = Logger(len(trainset), args.num_epochs, image_dir=args.run_dir)

    manager = CheckpointManager(args.checkpoints, keep_last=args.keep_last,
                                keep_best=args.keep_best, mode="max")
    stopper = EarlyStopper(args.early_stop_patience, args.early_stop_delta,
                           mode="max")

    def _preempt_save(epoch):
        _save_full_state({"epoch": epoch - 1})  # redo this epoch
        print(f"\nSIGTERM: train state saved to {state_path} "
              f"(resume with --resume); exiting")

    def _save_epoch_checkpoints(epoch, mean_psnr):
        os.makedirs(args.checkpoints, exist_ok=True)
        netGA = os.path.join(args.checkpoints, checkpoint_name(
            args.SRModel, "A2C", args.up, epoch))
        netGB = os.path.join(args.checkpoints, checkpoint_name(
            args.CModel, "C2B", args.up, epoch))
        save_params(netGA, interop.jax_tree_from_module(state.sr.model)[0])
        save_params(netGB, interop.jax_tree_from_module(state.c.model)[0])
        if ema is not None:
            ema_dir = os.path.join(args.checkpoints, "ema")
            os.makedirs(ema_dir, exist_ok=True)
            save_params(os.path.join(ema_dir, os.path.basename(netGA)),
                        interop.jax_tree_from_module(state.sr.model, ema["sr"])[0])
            save_params(os.path.join(ema_dir, os.path.basename(netGB)),
                        interop.jax_tree_from_module(state.c.model, ema["c"])[0])
        _save_full_state({"epoch": epoch, "val_psnr": mean_psnr})
        removed = manager.register(epoch, [netGA, netGB], metric=mean_psnr)
        print(f"\nsaved {netGA} {netGB} (+ resume state; "
              f"val PSNR {mean_psnr:.2f} dB)"
              + (f"; retention removed {len(removed)} files" if removed
                 else ""))

    def _finish_epoch(epoch, epoch_psnr) -> bool:
        """Early-stop bookkeeping and the epoch's checkpoints; True to stop."""
        mean_psnr = float(np.mean(epoch_psnr)) if epoch_psnr else float("nan")
        stop = stopper.update(mean_psnr)
        if epoch % args.save_every == 0 or stop:
            _save_epoch_checkpoints(epoch, mean_psnr)
        if stop:
            print(f"early stop at epoch {epoch}: validation PSNR stalled for "
                  f"{args.early_stop_patience} epochs (best "
                  f"{stopper.best:.2f} dB, best epoch {manager.best_epoch()})")
        return stop

    window = {k: [] for k in METRIC_KEYS}

    def _record(epoch, it, values, src_u8, tar_u8, epoch_psnr):
        """One step's metrics (floats, in METRIC_KEYS order): the non-finite
        stop, the logging window and, every --log-every steps, a log line with
        the image set of this step's batch."""
        nonlocal window
        row = dict(zip(METRIC_KEYS, values))
        if not np.isfinite(row["loss_SR"] + row["loss_C"]):
            # failure detection: stop instead of training on garbage; with
            # --resume the run restarts from the last full-state checkpoint
            raise RuntimeError(
                f"non-finite loss at epoch {epoch} it {it}; restart with "
                f"--resume to restore from {state_path}")
        for k in window:
            window[k].append(row[k])
        epoch_psnr.append(row["psnr_C"])
        if it % args.log_every == 0:
            realA, realB = preprocess.convert_pair(src_u8, tar_u8, ver)
            logger.log(nepoch=epoch, niter=it,
                       losses={k: float(np.mean(v)) for k, v in window.items()},
                       images=trainer.snapshot(state, realA, realB), ver=ver)
            window = {k: [] for k in window}

    with config.precision(mode):
        for epoch in range(start_epoch, args.num_epochs + 1):
            epoch_psnr = []
            lr = trainer.lr_at_epoch(epoch)
            raw_iter = data.batches(trainset, args.batch_size, shuffle=True,
                                    seed=args.seed, epoch=epoch,
                                    workers=args.workers, augment=args.augment)
            if args.steps_per_dispatch > 1:
                # K steps per trainer call on a stacked uint8 block: one
                # host-to-device copy and one read of the metrics per K steps
                it = 0
                for src_blk, tar_blk in preprocess.device_put_iter(
                        _stacked_blocks(raw_iter, args.steps_per_dispatch), device):
                    state, mrows = trainer.train_steps_u8(state, src_blk, tar_blk, lr)
                    if preempted["flag"]:
                        _preempt_save(epoch)
                        return state
                    rows = torch.stack([mrows[k] for k in METRIC_KEYS], dim=1).tolist()
                    for j, values in enumerate(rows):
                        it += 1
                        _record(epoch, it, values, src_blk[j], tar_blk[j], epoch_psnr)
                if _finish_epoch(epoch, epoch_psnr):
                    break
                continue
            batch_iter = preprocess.device_put_iter(
                ((src, tar) for src, tar, _ in raw_iter), device)
            for it, (src_u8, tar_u8) in enumerate(batch_iter, start=1):
                if args.grad_accum > 1:
                    realA, realB = preprocess.convert_pair(src_u8, tar_u8, ver)
                    state, metrics = trainer.train_step_accum(
                        state, realA, realB, lr, args.grad_accum)
                elif ema is not None:
                    realA, realB = preprocess.convert_pair(src_u8, tar_u8, ver)
                    state, ema, metrics = trainer.train_step_ema(
                        state, ema, realA, realB, lr, args.ema_decay)
                else:
                    # uint8-input step: the preprocessing runs in the step
                    state, metrics = trainer.train_step_u8(state, src_u8, tar_u8, lr)
                if preempted["flag"]:
                    _preempt_save(epoch)
                    return state
                values = torch.stack([metrics[k] for k in METRIC_KEYS]).tolist()
                _record(epoch, it, values, src_u8, tar_u8, epoch_psnr)
            if _finish_epoch(epoch, epoch_psnr):
                break
    return state


if __name__ == "__main__":
    main()
