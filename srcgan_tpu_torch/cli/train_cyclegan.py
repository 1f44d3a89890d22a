"""CycleGAN SR training tool, as ``srcgan_tpu.cli.train_cyclegan``.

  python -m srcgan_tpu_torch.cli.train_cyclegan --net 1 --mode x2

net='1' (the reference default): an RGB <-> RGB cycle whose realA is the
nearest 1/scale downsample of the target; net='SRdens' the SRDenseNet pair;
any other value the gray <-> RGB RDDB pair.  Every flag of the JAX
package's tool keeps its name.  Checkpoints are
``netG_A2B_SRtask_<mode>_<epoch%04d>.npz`` and ``netG_B2A_...`` in the JAX
package's ``save_params`` layout (either package loads them), plus the full
train state ``cyclestate_latest.npz`` for ``--resume``.  Runs on the card
unless ``--device cpu`` is given; fp32 steps run with TF32 off.

``--mesh-size N`` trains data-parallel over N ranks (``parallel.mesh``: the
tool spawns them, one card each, or all on the CPU with --device cpu; or
one of torchrun's): each rank its shard of the batch, the discriminators'
BatchNorm on the global batch, the host pools drawing on the gathered
fakes; ``--zero-opt`` shards both networks' Adam state (pool size 0).
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description="CycleGAN SR training")
    p.add_argument("--net", type=str, default="1")
    p.add_argument("--mode", type=str, default="x2", choices=["x2", "x4"])
    p.add_argument("--root", type=str, default=None,
                   help="dataset root (default Sat2Aer<mode>)")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num-epochs", type=int, default=25)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--pool-size", type=int, default=4)
    p.add_argument("--save-every", type=int, default=5)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--checkpoints", type=str, default="./checkpoints")
    p.add_argument("--bf16-acts", action="store_true",
                   help="bf16 activations with fp32 master params")
    p.add_argument("--no-remat", action="store_true",
                   help="disable per-pass rematerialization (faster iterations; "
                        "the six-pass backward must fit device memory)")
    p.add_argument("--pack-passes", action="store_true",
                   help="batch same-net independent generator passes into one "
                        "forward (6 passes -> 3; exact math)")
    p.add_argument("--eval-after-save", action="store_true",
                   help="run the eval tool (test_cyclegan) on each saved "
                        "checkpoint pair, in-process")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="maintain an exponential moving average of the generator "
                        "weights (e.g. 0.999) and save it under <checkpoints>/ema/")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run-dir", type=str, default="runs/latest",
                   help="per-run log dir: loss history (losses.jsonl) + live "
                        "image windows (one PNG per window name)")
    p.add_argument("--augment", action="store_true",
                   help="random per-sample D4 rotation/flip applied to both "
                        "images of each training pair (deterministic per "
                        "--seed/epoch)")
    p.add_argument("--perceptual", type=str, default=None,
                   help="VGG16 weights (.npz from convert_vgg, or a torchvision "
                        ".pth) adding a perceptual term on the cycle "
                        "reconstructions; 'random' = untrained VGG (testing only)")
    p.add_argument("--perceptual-weight", type=float, default=1.0)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run K G+D iterations per trainer call on a stacked "
                        "uint8 block (requires --pool-size 0 or --device-pool); "
                        "the host reads the losses once per K iterations")
    p.add_argument("--zero-opt", action="store_true",
                   help="with --mesh-size: ZeRO-1, the G and D Adam moments sharded "
                        "over the ranks (requires --pool-size 0: the fused G+D "
                        "iteration)")
    p.add_argument("--resume", action="store_true",
                   help="resume from <checkpoints>/cyclestate_latest.npz (full "
                        "G+D state: params, BatchNorm statistics, Adam moments, "
                        "epoch; the host ImagePool restarts empty)")
    p.add_argument("--device-pool", action="store_true",
                   help="keep the ImagePool on the device: G update, both pool "
                        "queries and the D update with no fake-image round trip "
                        "to the host (same sampling distribution, a torch "
                        "generator's stream); needs --pool-size > 0")
    p.add_argument("--mesh-size", type=int, default=0,
                   help="data-parallel ranks (one card each, or the CPU with "
                        "--device cpu): batch split, gradients averaged, BatchNorm "
                        "on the global batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    from srcgan_tpu_torch.utils.live import add_live_flag
    add_live_flag(p)
    return p


def _check_flags(args) -> None:
    """Exit, before any work, on a flag still to be ported or a composition
    the trainer does not have."""
    if args.zero_opt:
        if args.mesh_size <= 1:
            sys.exit("--zero-opt requires --mesh-size > 1")
        if (args.pool_size != 0 or args.device_pool or args.ema_decay > 0
                or args.steps_per_dispatch > 1):
            sys.exit("--zero-opt requires --pool-size 0 (the fused G+D program) and "
                     "composes without --ema-decay/--device-pool/--steps-per-dispatch")
    if args.mesh_size > 1:
        if args.ema_decay > 0:
            sys.exit("--ema-decay composes with the single-device step only")
        if args.batch_size % args.mesh_size:
            sys.exit("--mesh-size needs --batch-size divisible by the mesh")
    if args.steps_per_dispatch > 1:
        if args.ema_decay > 0:
            sys.exit("--steps-per-dispatch composes without --ema-decay")
        if args.pool_size != 0 and not args.device_pool:
            sys.exit("--steps-per-dispatch requires --pool-size 0 (the pass-through "
                     "pool makes the K-step call exact) or --device-pool")
    if args.device_pool and (args.pool_size <= 0 or args.mesh_size > 1):
        sys.exit("--device-pool needs --pool-size > 0 and a single device "
                 "(--ema-decay and --steps-per-dispatch compose)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _check_flags(args)
    from srcgan_tpu_torch.parallel import mesh as mesh_lib
    if mesh_lib.spawned_by_tool(args.mesh_size):
        return mesh_lib.launch("srcgan_tpu_torch.cli.train_cyclegan:main", argv,
                               args.mesh_size, args.device)

    # Preemption safety, as in train_cas: the flag handler is registered
    # first, the loop checks it after every trainer call and persists the
    # full state; the finally restores the previous handler on every exit.
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


def _loss_row(get) -> dict:
    """The logged loss sums of one iteration; ``get(key)`` reads a scalar."""
    return {"loss_G": get("loss_G"),
            "loss_G_identity": get("loss_iden_A") + get("loss_iden_B"),
            "loss_G_GAN": get("loss_G_A") + get("loss_G_B"),
            "loss_G_cycle": get("loss_cycle_A") + get("loss_cycle_B"),
            "loss_D": get("loss_D_A") + get("loss_D_B")}


def _run(args, preempted):
    import math

    import torch

    from srcgan_tpu_torch import config, data, interop, parallel
    from srcgan_tpu_torch.cli.train_cas import _stacked_blocks, load_perceptual
    from srcgan_tpu_torch.data import preprocess
    from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer
    from srcgan_tpu_torch.train.state import load_train_state, save_params, save_train_state
    from srcgan_tpu_torch.utils import Logger

    mesh = (parallel.make_mesh((args.mesh_size,), ("data",), device=args.device)
            if args.mesh_size > 1 else None)
    device = mesh.device if mesh is not None else config.resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    root = args.root or f"Sat2Aer{args.mode}"
    trainer = CycleGANTrainer(net=args.net, mode=args.mode, lr=args.lr,
                              pool_size=args.pool_size, num_epochs=args.num_epochs,
                              act_dtype=torch.bfloat16 if args.bf16_acts else None,
                              remat=not args.no_remat, pack_passes=args.pack_passes,
                              perceptual_params=load_perceptual(args.perceptual),
                              perceptual_weight=args.perceptual_weight, device=device)
    state = trainer.init(args.seed)
    start_epoch = 1
    state_path = os.path.join(args.checkpoints, "cyclestate_latest.npz")
    if args.resume and os.path.exists(state_path):
        state, extra = load_train_state(state_path, state)
        start_epoch = int(extra.get("epoch", 0)) + 1
        if main_rank:
            print(f"resumed from {state_path} at epoch {start_epoch}")
    # after the restore, so a resumed run's EMA starts from the restored weights
    ema = trainer.ema_init(state) if args.ema_decay > 0 else None
    iteration = zero_step = None
    if args.zero_opt:
        state = parallel.zero1_gd_put(state, mesh)
        zero_step = parallel.make_gd_zero1_step(trainer, mesh)
    elif mesh is not None:
        state = parallel.put_replicated(state, mesh)
        iteration = parallel.make_gan_dp_iteration(trainer, mesh)

    def _save_full_state(extra):
        """The npz full state, by rank 0 (a ZeRO state gathered first)."""
        plain = (parallel.plain_state(state, lambda: trainer.init(args.seed))
                 if args.zero_opt else state)
        if main_rank:
            save_train_state(state_path, plain, extra=extra)

    def _preempt_save(epoch):
        _save_full_state({"epoch": epoch - 1})  # redo this epoch
        if main_rank:
            print(f"\nSIGTERM: train state saved to {state_path} "
                  f"(resume with --resume); exiting")

    def _save_epoch(epoch):
        paths = {role: os.path.join(args.checkpoints,
                                    f"netG_{tag}_SRtask_{args.mode}_{epoch:04d}.npz")
                 for role, tag in (("G_A", "A2B"), ("G_B", "B2A"))}
        _save_full_state({"epoch": epoch})
        if not main_rank:
            return
        os.makedirs(args.checkpoints, exist_ok=True)
        for role, path in paths.items():
            save_params(path, interop.jax_tree_from_module(state.g.model[role])[0])
        if ema is not None:
            ema_dir = os.path.join(args.checkpoints, "ema")
            os.makedirs(ema_dir, exist_ok=True)
            ema_tree = interop.jax_tree_from_module(state.g.model, ema)[0]
            for role, path in paths.items():
                save_params(os.path.join(ema_dir, os.path.basename(path)), ema_tree[role])
        print(f"\nsaved {paths['G_A']} {paths['G_B']} (+ resume state)")
        if args.eval_after_save:
            from srcgan_tpu_torch.cli import test_cyclegan
            ev = ["--netGA", paths["G_A"], "--netGB", paths["G_B"], "--net", args.net,
                  "--device", str(device)]
            if args.root:
                ev += ["--root", args.root]
            if args.data_dir:
                ev += ["--data-dir", args.data_dir]
            test_cyclegan.main(ev)

    def _check_finite(value, epoch, it):
        if not math.isfinite(value):
            raise RuntimeError(f"non-finite generator loss at epoch {epoch} it {it}; "
                               f"restart with --resume to restore from {state_path}")

    def _preempted() -> bool:
        return mesh.any(preempted["flag"]) if mesh is not None else preempted["flag"]

    def _iterate(state, real_a, real_b, g_lr, d_lr):
        """One iteration through the host pools, on one device or the mesh."""
        if zero_step is not None:
            return zero_step(state, real_a, real_b, g_lr, d_lr)
        if iteration is not None:
            return iteration(state, real_a, real_b, g_lr, d_lr)
        return trainer.optimize_parameters(state, real_a, real_b, g_lr, d_lr)

    def _shards(blocks, batch_dim):
        for src, tar in blocks:
            if mesh is not None:
                src, tar = (parallel.shard_of(a, mesh, batch_dim) for a in (src, tar))
            yield src, tar

    trainset = data.FileListDataset(root, "train", "G2RGB", args.data_dir)
    if main_rank:
        print(f"Starting Training Loop... ({len(trainset)} samples, net={args.net}, "
              f"device={device}" + (f", {mesh.size} ranks" if mesh is not None else "") + ")")
    logger = Logger(len(trainset), args.num_epochs, image_dir=args.run_dir) if main_rank else None
    pools = None            # the device pools, sized from the first batch

    with config.precision("bf16" if args.bf16_acts else "fp32"):
        for epoch in range(start_epoch, args.num_epochs + 1):
            g_lr, d_lr = trainer.lr_at_epoch(epoch)
            raw_iter = data.batches(trainset, args.batch_size, shuffle=True, seed=args.seed,
                                    epoch=epoch, augment=args.augment,
                                    drop_last=mesh is not None)
            if args.steps_per_dispatch > 1:
                # K iterations per trainer call on a stacked uint8 block: the
                # losses come back per step, the images from the block's last
                it = -1
                for src_blk, tar_blk in preprocess.device_put_iter(
                        _shards(_stacked_blocks(raw_iter, args.steps_per_dispatch), 1),
                        device):
                    if args.device_pool:
                        if pools is None:
                            pools = trainer.device_pool_init(
                                state, *trainer.inputs_u8(src_blk[0], tar_blk[0]),
                                seed=args.seed)
                        state, pools, imgs, rows = trainer.gd_steps_pooled_u8(
                            state, pools, src_blk, tar_blk, g_lr, d_lr)
                    elif mesh is not None:
                        # the K iterations of the block, each on the mesh
                        per_step = []
                        for s_, t_ in zip(src_blk, tar_blk):
                            state, aux = _iterate(state, *trainer.inputs_u8(s_, t_), g_lr,
                                                  d_lr)
                            per_step.append(aux)
                        imgs = {k: aux[k] for k in trainer._IMAGE_KEYS}
                        rows = {k: torch.stack([a[k] for a in per_step])
                                for k, v in aux.items() if v.dim() == 0}
                    else:
                        state, imgs, rows = trainer.gd_steps_u8(state, src_blk, tar_blk,
                                                                g_lr, d_lr)
                    if _preempted():
                        _preempt_save(epoch)
                        return state
                    rows = {k: v.tolist() for k, v in rows.items()}
                    for j in range(len(rows["loss_G"])):
                        it += 1
                        _check_finite(rows["loss_G"][j], epoch, it)
                        if it % args.log_every == 0 and main_rank:
                            logger.log(nepoch=epoch, niter=it,
                                       losses=_loss_row(lambda k: rows[k][j]), images=imgs)
            else:
                batch_iter = preprocess.device_put_iter(
                    _shards(((src, tar) for src, tar, _ in raw_iter), 0), device)
                for it, (src_u8, tar_u8) in enumerate(batch_iter):
                    real_a, real_b = trainer.inputs_u8(src_u8, tar_u8)
                    if args.device_pool:
                        if pools is None:
                            pools = trainer.device_pool_init(state, real_a, real_b,
                                                             seed=args.seed)
                        if ema is not None:
                            state, pools, ema, aux = trainer.gd_step_pooled_ema(
                                state, pools, ema, real_a, real_b, g_lr, d_lr,
                                args.ema_decay)
                        else:
                            state, pools, aux = trainer.gd_step_pooled(
                                state, pools, real_a, real_b, g_lr, d_lr)
                    elif ema is not None:
                        state, ema, aux = trainer.optimize_parameters(
                            state, real_a, real_b, g_lr, d_lr, ema=ema,
                            ema_decay=args.ema_decay)
                    else:
                        state, aux = _iterate(state, real_a, real_b, g_lr, d_lr)
                    if _preempted():
                        _preempt_save(epoch)
                        return state
                    _check_finite(float(aux["loss_G"]), epoch, it)
                    if it % args.log_every == 0 and main_rank:
                        logger.log(nepoch=epoch, niter=it,
                                   losses=_loss_row(lambda k: float(aux[k])),
                                   images={k: aux[k] for k in trainer._IMAGE_KEYS})
            if epoch % args.save_every == 0:
                _save_epoch(epoch)
    return state


if __name__ == "__main__":
    main()
