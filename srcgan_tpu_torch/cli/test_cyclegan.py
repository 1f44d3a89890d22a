"""CycleGAN evaluation tool, as ``srcgan_tpu.cli.test_cyclegan``.

  python -m srcgan_tpu_torch.cli.test_cyclegan \\
      --netGA checkpoints/netG_A2B_SRtask_x2_0025.npz \\
      --netGB checkpoints/netG_B2A_SRtask_x2_0025.npz

Loads the generator pair (.npz as either package saves it, or a reference
.pth), picks Sat2Aerx2 or Sat2Aerx4 by the mode in the netGA file name, and
for every test pair writes fake_B and fake_A PNGs.  With net='1' realA is
synthesised from the target at the generator's scale (nearest).  fake_B is
scored against realB with the cascade's per-sample evaluators [MSE, PSNR,
AE, SSIM] (SSIM through the ``ssim`` kernel on the card, one launch per
image) and the means are appended to result/Performs.csv.  fp32 with TF32
off; runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="CycleGAN eval")
    p.add_argument("--netGA", type=str, required=True)
    p.add_argument("--netGB", type=str, required=True)
    p.add_argument("--net", type=str, default="1")
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--result-dir", type=str, default="./result")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from srcgan_tpu_torch import config, data
    from srcgan_tpu_torch.cli.test_cas import append_performs, format_row
    from srcgan_tpu_torch.interop import load_params_any
    from srcgan_tpu_torch.metrics import per_sample_evaluators
    from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc
    from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer
    from srcgan_tpu_torch.utils import vis

    device = config.resolve_device(args.device)
    base = os.path.basename(args.netGA)
    mode = "x4" if "x4" in base else "x2"
    root = args.root or f"Sat2Aer{mode}"
    trainer = CycleGANTrainer(net=args.net, mode=mode, device=device)
    gens = trainer.make_generators()
    load_params_any(gens["G_A"], args.netGA)
    load_params_any(gens["G_B"], args.netGB)
    gens.eval().requires_grad_(False)

    testset = data.FileListDataset(root, "test", "G2RGB", args.data_dir)
    tag = base.rsplit(".", 1)[0]
    dir_b = os.path.join(args.result_dir, "cyc_fakeB_" + tag)
    dir_a = os.path.join(args.result_dir, "cyc_fakeA_" + tag)
    os.makedirs(dir_b, exist_ok=True)
    os.makedirs(dir_a, exist_ok=True)

    def run(net, x):
        return to_nhwc(net(to_nchw(x)))

    def to_u8(t):
        """The first image of a float NHWC batch as uint8 on the host:
        clipped, times 255, truncated (one channel as HW)."""
        a = (t[0].clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        return a[..., 0] if a.shape[-1] == 1 else a

    ps_evals = per_sample_evaluators()
    performs = [[] for _ in ps_evals]
    t_start = time.perf_counter()
    with torch.no_grad(), config.precision("fp32"):
        for idx in range(len(testset)):
            src_u8, tar_u8 = (torch.from_numpy(np.array(a[None])).to(device)
                              for a in testset.raw(idx))
            real_a, real_b = trainer.inputs_u8(src_u8, tar_u8)
            fake_b, fake_a = run(gens["G_A"], real_a), run(gens["G_B"], real_b)
            acc = ""
            if fake_b.shape == real_b.shape:
                vals = torch.stack([fn(fake_b, real_b)[0] for _, fn in ps_evals]).tolist()
                for i, (ev_name, _) in enumerate(ps_evals):
                    performs[i].append(vals[i])
                    acc += " {}:{:0.2f};".format(ev_name, vals[i])
            name = testset.datalist[idx]
            vis.save_png(os.path.join(dir_b, name), to_u8(fake_b))
            vis.save_png(os.path.join(dir_a, name), to_u8(fake_a))
            sys.stdout.write("\rGenerated %s (%04d / %04d) >> %s" %
                             (name, idx, len(testset), acc))
    seconds = time.perf_counter() - t_start
    sys.stdout.write("\n")

    # no row where fake_B and realB differ in shape (a pairing whose SR
    # output has no same-size target): PNGs only, as the reference
    if not performs[0]:
        print("fake_B/realB shapes differ: no metric rows (PNGs only)")
        return None
    row = {"time": time.strftime("%h_%d"), "checkpoint": tag}
    row.update({name: sum(p) / len(p) for (name, _), p in zip(ps_evals, performs)})
    append_performs(os.path.join(args.result_dir, "Performs.csv"), row)
    print(format_row(row))
    return {**row, "images": len(performs[0]), "eval_seconds": seconds,
            "device": str(device)}


if __name__ == "__main__":
    main()
