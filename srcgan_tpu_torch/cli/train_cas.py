"""Cascaded SR -> colorization training tool, as ``srcgan_tpu.cli.train_cas``.

  python -m srcgan_tpu_torch.cli.train_cas --SRModel RDDBNet --CModel ResDeconv --up 2
  python -m srcgan_tpu_torch.cli.train_cas --const      # constant-resolution pipeline
  python -m srcgan_tpu_torch.cli.train_cas --lab        # LAB colour space (also with --const)

  python -m srcgan_tpu_torch.cli.train_cas --mesh-size 2 [--zero-opt | --fsdp]
  python -m srcgan_tpu_torch.cli.train_cas --mesh-size 2 --space-size 2
  python -m srcgan_tpu_torch.cli.train_cas --distill-netGA T_A2C.npz --distill-netGB T_C2B.npz

Every flag of the JAX package's tool keeps its name.  Checkpoints keep the
name-encoded convention, as .npz parameter trees that either package loads,
plus the full train state for ``--resume`` (``casstate_latest.npz``, or
step directories under ``--orbax-dir``).  Runs on the card unless
``--device cpu`` is given.

``--mesh-size N`` trains data-parallel over N ranks of one process group
(``parallel.mesh``): without ``WORLD_SIZE`` in the environment the tool
spawns its N workers itself, one card each (NCCL), or all on the CPU with
``--device cpu`` (gloo); under ``torchrun --nproc-per-node N`` it is one of
them.  Every rank reads the same shuffled batches and trains on its shard;
rank 0 prints, logs and writes the files.  ``--space-size S`` with
``--mesh-size D`` trains on a (data, space) mesh of D x S ranks
(``parallel.make_cas_2d_steps_u8``): each rank takes its data shard's row
strip of every batch.  As in the JAX tool, ``--space-size`` without
``--mesh-size`` trains on one device, and it refuses ``--zero-opt``,
``--fsdp``, ``--steps-per-dispatch``, ``--grad-accum`` and ``--ema-decay``;
here it also refuses ``--const``, ``--perceptual``, ``--remat`` and
distillation, which the strip step does not take.
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
                   help="LAB colour space: L to the SR net, ab from the colorizer; "
                        "checkpoints are named <Model>@G2LAB_...")
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
                   help="ranks on the data axis (0 = one process): the batch is "
                        "split over N processes, one card each (or the CPU with "
                        "--device cpu), gradients averaged by all-reduce")
    p.add_argument("--space-size", type=int, default=0,
                   help="with --mesh-size: a second mesh axis over image height, "
                        "D x S ranks, each a row strip of its data shard")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP over the --mesh-size data mesh: parameters AND Adam "
                        "moments stored as per-rank rows (3 x n/N values a rank at "
                        "rest), gathered for each step")
    p.add_argument("--zero-opt", action="store_true",
                   help="with --mesh-size: ZeRO-1, Adam's moments and update on "
                        "1/N-th of the parameters per rank (gradients "
                        "reduce-scattered, parameters all-gathered; the math of "
                        "plain data parallelism)")
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
                   help="full-state checkpoints as step directories "
                        "(torch.distributed.checkpoint: each rank writes what it "
                        "holds, a ZeRO-1 / FSDP state restores sharded; --keep-last "
                        "applies) instead of the npz file; the name-encoded weight "
                        ".npz files are still written")
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
                   help="VGG16 weights (.npz from convert_vgg, or a torchvision "
                        ".pth) adding the VGG16 perceptual term to both stage "
                        "losses; 'random' = untrained VGG (testing only)")
    p.add_argument("--perceptual-weight", type=float, default=1.0)
    p.add_argument("--distill-netGA", type=str, default=None,
                   help="teacher SR checkpoint (.npz/.pth): train this run's "
                        "--SRModel/--CModel as a student on "
                        "alpha*L1(gt) + (1-alpha)*L1(teacher) per stage")
    p.add_argument("--distill-netGB", type=str, default=None,
                   help="teacher colorizer checkpoint (pairs with --distill-netGA)")
    p.add_argument("--distill-alpha", type=float, default=0.5,
                   help="weight on the ground-truth term (1 = pure supervision, "
                        "0 = pure teacher mimicry)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    from srcgan_tpu_torch.utils.live import add_live_flag
    add_live_flag(p)
    return p


def _check_flags(args) -> None:
    """Exit, before any work, on a flag still to be ported or a composition
    the tool does not have (the JAX tool's exits, with its messages)."""
    two_d = args.mesh_size > 1 and args.space_size > 1
    if two_d and (args.const or args.perceptual or args.remat or args.distill_netGA):
        sys.exit("--space-size takes the plain L1 cascade: not --const, --perceptual, "
                 "--remat or distillation")
    if bool(args.distill_netGA) != bool(args.distill_netGB):
        sys.exit("--distill-netGA and --distill-netGB must be given together "
                 "(a teacher cascade)")
    if args.zero_opt or args.fsdp:
        if args.zero_opt and args.fsdp:
            sys.exit("--zero-opt and --fsdp are mutually exclusive (FSDP subsumes "
                     "the moment sharding)")
        which = "--fsdp" if args.fsdp else "--zero-opt"
        if args.mesh_size <= 1 or args.space_size > 1:
            sys.exit(f"{which} requires a 1-D --mesh-size data mesh (no --space-size)")
        if args.ema_decay > 0 or args.grad_accum > 1:
            sys.exit(f"{which} composes with the plain DP loop (not "
                     "--ema-decay/--grad-accum)")
    if args.mesh_size > 1:
        if args.batch_size % args.mesh_size:
            sys.exit("--mesh-size requires --batch-size divisible by it")
        if args.grad_accum > 1:
            sys.exit("--grad-accum composes with the single-device step only; under "
                     "a mesh add data-parallel shards instead")
    if args.ema_decay > 0 and (args.mesh_size > 1 or args.grad_accum > 1):
        sys.exit("--ema-decay currently composes with the plain single-device step only")
    if args.steps_per_dispatch > 1 and (args.grad_accum > 1 or args.ema_decay > 0 or two_d):
        sys.exit("--steps-per-dispatch composes with the plain single-device step or a "
                 "1-D --mesh-size data mesh (not --space-size/--grad-accum/--ema-decay)")


def load_perceptual(spec, device=None):
    """--perceptual value -> VGG16 parameters (or None): a weights file, or
    ``random`` for untrained ones drawn from seed 0."""
    if not spec:
        return None
    import torch

    from srcgan_tpu_torch import losses_vgg
    if spec == "random":
        return losses_vgg.init_vgg_params(torch.Generator().manual_seed(0), device=device)
    return losses_vgg.load_vgg_params(spec, device=device)


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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _check_flags(args)
    from srcgan_tpu_torch.parallel import mesh as mesh_lib
    if mesh_lib.spawned_by_tool(args.mesh_size):
        return mesh_lib.launch("srcgan_tpu_torch.cli.train_cas:main", argv,
                               args.mesh_size * max(args.space_size, 1), args.device)

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
    live = (live_mod.maybe_start(args, run_dir=args.run_dir)
            if int(os.environ.get("RANK", 0)) == 0 else None)
    try:
        return _run(args, preempted)
    finally:
        if live is not None:
            live.stop()
        signal.signal(signal.SIGTERM, prev_handler)


def _run(args, preempted):
    import torch

    from srcgan_tpu_torch import config, data, interop, parallel
    from srcgan_tpu_torch.data import preprocess
    from srcgan_tpu_torch.train.cas import CasTrainer
    from srcgan_tpu_torch.train.retention import CheckpointManager, EarlyStopper
    from srcgan_tpu_torch.train.state import (checkpoint_name, load_train_state,
                                              save_params, save_train_state)
    from srcgan_tpu_torch.utils import Logger

    mesh = None
    if args.mesh_size > 1 and args.space_size > 1:
        mesh = parallel.make_mesh((args.mesh_size, args.space_size), ("data", "space"),
                                  device=args.device)
    elif args.mesh_size > 1:
        mesh = parallel.make_mesh((args.mesh_size,), ("data",), device=args.device)
    device = mesh.device if mesh is not None else config.resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    mode = "bf16" if args.bf16_acts else "tf32" if args.bf16 else "fp32"
    ver = "G2LAB" if args.lab else "G2RGB"
    cas_kwargs = dict(
        sr_model=args.SRModel, c_model=args.CModel, up=args.up, lr=args.lr,
        const=args.const, lab=args.lab, lr_policy=args.lr_policy, num_epochs=args.num_epochs,
        remat=args.remat, perceptual_params=load_perceptual(args.perceptual),
        perceptual_weight=args.perceptual_weight,
        act_dtype=torch.bfloat16 if args.bf16_acts else None, device=device)
    if args.distill_netGA:
        from srcgan_tpu_torch.train.distill import DistillTrainer
        trainer = DistillTrainer.from_checkpoints(args.distill_netGA, args.distill_netGB,
                                                  alpha=args.distill_alpha, **cas_kwargs)
        if main_rank:
            print(f"distilling from {os.path.basename(args.distill_netGA)} + "
                  f"{os.path.basename(args.distill_netGB)} (alpha={args.distill_alpha})")
    else:
        trainer = CasTrainer(**cas_kwargs)
    state = trainer.init(args.seed)
    start_epoch = 1
    state_path = os.path.join(args.checkpoints, "casstate_latest.npz")

    # the npz full state is the plain layout in every mode: a sharded state is
    # restored into a plain template, then cut into this rank's rows
    if args.resume and not args.orbax_dir and os.path.exists(state_path):
        state, extra = load_train_state(state_path, state)
        start_epoch = int(extra.get("epoch", 0)) + 1
        if main_rank:
            print(f"resumed from {state_path} at epoch {start_epoch}")
    if args.fsdp:
        state = parallel.fsdp_put(state, mesh)
    elif args.zero_opt:
        state = parallel.zero1_put(state, mesh)
    elif mesh is not None:
        state = parallel.put_replicated(state, mesh)

    steps_u8 = trainer.train_steps_u8
    if args.fsdp:
        steps_u8 = parallel.make_cas_fsdp_steps_u8(trainer, mesh)
    elif args.zero_opt:
        steps_u8 = parallel.make_cas_zero1_steps_u8(trainer, mesh)
    elif mesh is not None and "space" in mesh.shape:
        steps_u8 = parallel.make_cas_2d_steps_u8(trainer, mesh)
    elif mesh is not None:
        steps_u8 = parallel.make_cas_dp_steps_u8(trainer, mesh)

    # the step directories: restored after the layout is set, into it
    ock = None
    if args.orbax_dir:
        from srcgan_tpu_torch.train.orbax_io import OrbaxCheckpointer
        ock = OrbaxCheckpointer(args.orbax_dir, max_to_keep=args.keep_last or None)
        if args.resume and ock.latest_step() is not None:
            state, extra = ock.restore(state)
            start_epoch = int(extra.get("epoch", 0)) + 1
            if main_rank:
                print(f"resumed from {args.orbax_dir} at epoch {start_epoch}")

    ema = None
    if args.ema_decay > 0:
        ema = trainer.ema_init(state)      # after the restore: from its weights

    def _save_full_state(extra):
        """The full state through the configured backend: a step directory
        (a monotonic counter; the epoch lives in ``extra``) or the npz file,
        which rank 0 writes from the gathered plain layout."""
        if ock is not None:
            ock.save((ock.latest_step() or 0) + 1, state, extra)
            return
        plain = (parallel.plain_state(state, lambda: trainer.init(args.seed))
                 if args.zero_opt or args.fsdp else state)
        if main_rank:
            save_train_state(state_path, plain, extra=extra)

    if args.data_dir:
        trainset = data.FileListDataset(args.root, "train", ver, args.data_dir)
    else:
        trainset, _, _ = data.load_dataset(args.root, ver)
    if args.cache:
        trainset = data.CachedDataset(trainset)
    if main_rank:
        print(f"Starting Training Loop... ({len(trainset)} samples, ver={ver}, "
              f"const={args.const}, up={args.up}, device={device}"
              + (f", {mesh.size} ranks" if mesh is not None else "") + ")")
    logger = Logger(len(trainset), args.num_epochs, image_dir=args.run_dir) if main_rank else None

    manager = CheckpointManager(args.checkpoints, keep_last=args.keep_last,
                                keep_best=args.keep_best, mode="max")
    stopper = EarlyStopper(args.early_stop_patience, args.early_stop_delta,
                           mode="max")

    def _preempted() -> bool:
        return mesh.any(preempted["flag"]) if mesh is not None else preempted["flag"]

    def _preempt_save(epoch):
        _save_full_state({"epoch": epoch - 1})  # redo this epoch
        if main_rank:
            print(f"\nSIGTERM: train state saved to {args.orbax_dir or state_path} "
                  f"(resume with --resume); exiting")

    def _save_epoch_checkpoints(epoch, mean_psnr):
        lab_ver = "G2LAB" if args.lab else None
        netGA = os.path.join(args.checkpoints, checkpoint_name(
            args.SRModel, "A2C", args.up, epoch, ver=lab_ver))
        netGB = os.path.join(args.checkpoints, checkpoint_name(
            args.CModel, "C2B", args.up, epoch, ver=lab_ver))
        with parallel.gathered(state):
            if main_rank:
                os.makedirs(args.checkpoints, exist_ok=True)
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
        if not main_rank:
            return
        removed = manager.register(epoch, [netGA, netGB], metric=mean_psnr)
        print(f"\nsaved {netGA} {netGB} (+ resume state; "
              f"val PSNR {mean_psnr:.2f} dB)"
              + (f"; retention removed {len(removed)} files" if removed
                 else ""))

    def _finish_epoch(epoch, epoch_psnr) -> bool:
        """Early-stop bookkeeping and the epoch's checkpoints; True to stop.
        The metrics are the ranks' means, so every rank decides alike."""
        mean_psnr = float(np.mean(epoch_psnr)) if epoch_psnr else float("nan")
        stop = stopper.update(mean_psnr)
        if epoch % args.save_every == 0 or stop:
            _save_epoch_checkpoints(epoch, mean_psnr)
        if stop and main_rank:
            print(f"early stop at epoch {epoch}: validation PSNR stalled for "
                  f"{args.early_stop_patience} epochs (best "
                  f"{stopper.best:.2f} dB, best epoch {manager.best_epoch()})")
        return stop

    window = {k: [] for k in METRIC_KEYS}

    def _record(epoch, it, values, src_u8, tar_u8, epoch_psnr):
        """One step's metrics (floats, in METRIC_KEYS order): the non-finite
        stop, the logging window and, every --log-every steps, a log line with
        the image set of this step's batch (this rank's shard)."""
        nonlocal window
        row = dict(zip(METRIC_KEYS, values))
        if not np.isfinite(row["loss_SR"] + row["loss_C"]):
            # failure detection: stop instead of training on garbage; with
            # --resume the run restarts from the last full-state checkpoint
            raise RuntimeError(
                f"non-finite loss at epoch {epoch} it {it}; restart with "
                f"--resume to restore from {args.orbax_dir or state_path}")
        for k in window:
            window[k].append(row[k])
        epoch_psnr.append(row["psnr_C"])
        if it % args.log_every == 0:
            realA, realB = preprocess.convert_pair(src_u8, tar_u8, ver)
            with parallel.gathered(state):
                if main_rank:
                    logger.log(nepoch=epoch, niter=it,
                               losses={k: float(np.mean(v)) for k, v in window.items()},
                               images=trainer.snapshot(state, realA, realB), ver=ver)
            window = {k: [] for k in window}

    def _shards(blocks, batch_dim):
        """Each host batch (or block of steps), cut to this rank's shard."""
        for src, tar in blocks:
            if mesh is not None:
                src, tar = (parallel.shard_of(a, mesh, batch_dim) for a in (src, tar))
            yield src, tar

    with config.precision(mode):
        for epoch in range(start_epoch, args.num_epochs + 1):
            epoch_psnr = []
            lr = trainer.lr_at_epoch(epoch)
            raw_iter = data.batches(trainset, args.batch_size, shuffle=True,
                                    seed=args.seed, epoch=epoch,
                                    workers=args.workers, augment=args.augment,
                                    drop_last=mesh is not None)
            if args.steps_per_dispatch > 1:
                # K steps per trainer call on a stacked uint8 block: one
                # host-to-device copy and one read of the metrics per K steps
                it = 0
                for src_blk, tar_blk in preprocess.device_put_iter(
                        _shards(_stacked_blocks(raw_iter, args.steps_per_dispatch), 1),
                        device):
                    state, mrows = steps_u8(state, src_blk, tar_blk, lr)
                    if _preempted():
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
                _shards(((src, tar) for src, tar, _ in raw_iter), 0), device)
            for it, (src_u8, tar_u8) in enumerate(batch_iter, start=1):
                if args.grad_accum > 1:
                    realA, realB = preprocess.convert_pair(src_u8, tar_u8, ver)
                    state, metrics = trainer.train_step_accum(
                        state, realA, realB, lr, args.grad_accum)
                elif ema is not None:
                    realA, realB = preprocess.convert_pair(src_u8, tar_u8, ver)
                    state, ema, metrics = trainer.train_step_ema(
                        state, ema, realA, realB, lr, args.ema_decay)
                elif mesh is not None:
                    # one step of the mesh's K-step form: the u8 input path
                    # (fused_input included) on this rank's shard
                    state, metrics = steps_u8(state, src_u8[None], tar_u8[None], lr)
                    metrics = {k: v[0] for k, v in metrics.items()}
                else:
                    # uint8-input step: the preprocessing runs in the step
                    state, metrics = trainer.train_step_u8(state, src_u8, tar_u8, lr)
                if _preempted():
                    _preempt_save(epoch)
                    return state
                values = torch.stack([metrics[k] for k in METRIC_KEYS]).tolist()
                _record(epoch, it, values, src_u8, tar_u8, epoch_psnr)
            if _finish_epoch(epoch, epoch_psnr):
                break
    return state


if __name__ == "__main__":
    main()
