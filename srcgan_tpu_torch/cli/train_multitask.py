"""Multi-task CycleGAN training tool, as ``srcgan_tpu.cli.train_multitask``.

  python -m srcgan_tpu_torch.cli.train_multitask --mode x2

G_C (gray SR) in front of a pix2pix colorization cycle (``--netG``,
``--norm``, ``--ngf``) on a Sat2Aer<mode> set.  Every flag of the JAX
package's tool keeps its name.  Checkpoints are
``netG_{G_A,G_B,G_C}_MTtask_<mode>_<epoch%04d>.npz`` in the JAX package's
``save_params`` layout (either package loads them).  Runs on the card
unless ``--device cpu`` is given; fp32 steps run with TF32 off.
``--mesh-size N`` trains data-parallel over N ranks, as in
``train_cyclegan``: BatchNorm on the global batch, the host pools drawing
on the gathered fakes.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description="multi-task CycleGAN training")
    p.add_argument("--mode", type=str, default="x2", choices=["x2", "x4"])
    p.add_argument("--root", type=str, default=None,
                   help="dataset root (default Sat2Aer<mode>)")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--num-epochs", type=int, default=25)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--netG", type=str, default="resnet_9blocks")
    p.add_argument("--norm", type=str, default="instance")
    p.add_argument("--device-pool", action="store_true",
                   help="keep the ImagePools on the device: the three-generator G "
                        "update, both 50%% replace queries and the D update with no "
                        "fake-image round trip to the host (same sampling "
                        "distribution, a torch generator's stream)")
    p.add_argument("--pack-passes", action="store_true",
                   help="batch G_A's two independent inputs into one forward (exact "
                        "for instance-norm nets; off for --norm batch)")
    p.add_argument("--bf16-acts", action="store_true",
                   help="bf16 generator activations with fp32 master params")
    p.add_argument("--mesh-size", type=int, default=0,
                   help="data-parallel ranks (one card each, or the CPU with "
                        "--device cpu): batch split, gradients averaged")
    p.add_argument("--save-every", type=int, default=5)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--checkpoints", type=str, default="./checkpoints")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run-dir", type=str, default="runs/latest",
                   help="per-run log dir: loss history (losses.jsonl) + live "
                        "image windows (one PNG per window name)")
    p.add_argument("--augment", action="store_true",
                   help="random per-sample D4 rotation/flip applied to both "
                        "images of each training pair (deterministic per "
                        "--seed/epoch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    from srcgan_tpu_torch.utils.live import add_live_flag
    add_live_flag(p)
    return p


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.mesh_size > 1:
        if args.device_pool:
            sys.exit("--device-pool composes with the single-device iteration only")
        if args.batch_size % args.mesh_size:
            sys.exit("--mesh-size needs --batch-size divisible by the mesh")
    from srcgan_tpu_torch.parallel import mesh as mesh_lib
    if mesh_lib.spawned_by_tool(args.mesh_size):
        return mesh_lib.launch("srcgan_tpu_torch.cli.train_multitask:main", argv,
                               args.mesh_size, args.device)
    from srcgan_tpu_torch.utils import live as live_mod
    live = (live_mod.maybe_start(args, run_dir=args.run_dir)
            if int(os.environ.get("RANK", 0)) == 0 else None)
    try:
        return _run(args)
    finally:
        if live is not None:
            live.stop()


def _run(args):
    import torch

    from srcgan_tpu_torch import config, data, interop, parallel
    from srcgan_tpu_torch.data import preprocess
    from srcgan_tpu_torch.train.multitask import MultiTaskTrainer
    from srcgan_tpu_torch.train.state import save_params
    from srcgan_tpu_torch.utils import Logger

    mesh = (parallel.make_mesh((args.mesh_size,), ("data",), device=args.device)
            if args.mesh_size > 1 else None)
    device = mesh.device if mesh is not None else config.resolve_device(args.device)
    main_rank = mesh is None or mesh.is_main
    root = args.root or f"Sat2Aer{args.mode}"
    trainer = MultiTaskTrainer(mode=args.mode, lr=args.lr, ngf=args.ngf, netG=args.netG,
                               norm=args.norm, num_epochs=args.num_epochs,
                               act_dtype=torch.bfloat16 if args.bf16_acts else None,
                               pack_passes=args.pack_passes, device=device)
    state = trainer.init(args.seed)
    iteration = None
    if mesh is not None:
        state = parallel.put_replicated(state, mesh)
        iteration = parallel.make_gan_dp_iteration(trainer, mesh)
    trainset = data.FileListDataset(root, "train", "G2RGB", args.data_dir)
    if main_rank:
        print(f"Starting Training Loop... ({len(trainset)} samples, multi-task, "
              f"device={device}" + (f", {mesh.size} ranks" if mesh is not None else "") + ")")
    logger = Logger(len(trainset), args.num_epochs, image_dir=args.run_dir) if main_rank else None
    pools = None            # the device pools, sized from the first batch

    with config.precision("bf16" if args.bf16_acts else "fp32"):
        for epoch in range(1, args.num_epochs + 1):
            g_lr, d_lr = trainer.lr_at_epoch(epoch)
            raw_iter = data.batches(trainset, args.batch_size, shuffle=True, seed=args.seed,
                                    epoch=epoch, augment=args.augment,
                                    drop_last=mesh is not None)
            batch_iter = preprocess.device_put_iter(
                ((src, tar) if mesh is None else
                 (parallel.shard_of(src, mesh), parallel.shard_of(tar, mesh))
                 for src, tar, _ in raw_iter), device)
            for it, (src_u8, tar_u8) in enumerate(batch_iter):
                real_a, real_b = preprocess.convert_pair(src_u8, tar_u8, "G2RGB")
                if args.device_pool:
                    if pools is None:
                        pools = trainer.device_pool_init(state, real_a, real_b, seed=args.seed)
                    state, pools, aux = trainer.gd_step_pooled(state, pools, real_a, real_b,
                                                               g_lr, d_lr)
                elif iteration is not None:
                    state, aux = iteration(state, real_a, real_b, g_lr, d_lr)
                else:
                    state, aux = trainer.optimize_parameters(state, real_a, real_b,
                                                             g_lr=g_lr, d_lr=d_lr)
                if it % args.log_every == 0 and main_rank:
                    logger.log(nepoch=epoch, niter=it,
                               losses={k: float(aux[k]) for k in
                                       ("loss_G", "loss_G_C", "loss_D_A", "loss_D_B")},
                               images={k: aux[k] for k in trainer._IMAGE_KEYS})
            if epoch % args.save_every == 0 and main_rank:
                os.makedirs(args.checkpoints, exist_ok=True)
                for name in ("G_A", "G_B", "G_C"):
                    path = os.path.join(args.checkpoints,
                                        f"netG_{name}_MTtask_{args.mode}_{epoch:04d}.npz")
                    save_params(path, interop.jax_tree_from_module(state.g.model[name])[0])
                print(f"\nsaved multi-task generators at epoch {epoch}")
    return state


if __name__ == "__main__":
    main()
