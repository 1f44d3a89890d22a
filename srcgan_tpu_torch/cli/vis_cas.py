"""Qualitative panel visualization tool, as ``srcgan_tpu.cli.vis_cas``.

  python -m srcgan_tpu_torch.cli.vis_cas --netGA ... --netGB ... --threshold 22.5

Side-by-side framed panels [input | SR | colorized | target], saved only when
the sample's colorization PSNR exceeds --threshold (22.5 dB is the
protocol's bar for a "good" sample).  Runs on the card unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description="qualitative panels")
    p.add_argument("--netGA", type=str, required=True)
    p.add_argument("--netGB", type=str, required=True)
    p.add_argument("--threshold", type=float, default=22.5)
    p.add_argument("--const", action="store_true")
    p.add_argument("--root", type=str, default="Sat2Aerx1")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--result-dir", type=str, default="./result")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from srcgan_tpu_torch import config, data, metrics
    from srcgan_tpu_torch.cli.test_cas import load_cascade, make_cascade
    from srcgan_tpu_torch.data import preprocess
    from srcgan_tpu_torch.utils import vis

    device = config.resolve_device(args.device)
    info_a, sr_net, c_net = load_cascade(args.netGA, args.netGB, device, torch.float32)
    sf = info_a["up"]
    cascade = make_cascade(sr_net, c_net, sf, args.const, "fp32")
    degrade = (preprocess.degrade_const_nearest if args.const
               else preprocess.degrade_nearest)

    testset = data.FileListDataset(args.root, "test", info_a["ver"], args.data_dir)
    out_dir = os.path.join(
        args.result_dir,
        "vis_" + "_".join([info_a["model"], f"x{sf}", f"{info_a['epoch']:04d}"]))
    os.makedirs(out_dir, exist_ok=True)

    psnr = metrics.PSNR()
    n_saved = 0
    for idx in range(len(testset)):
        src_u8, tar_u8 = testset.raw(idx)
        real_a, real_b = preprocess.convert_pair(
            torch.tensor(src_u8[None], device=device),
            torch.tensor(tar_u8[None], device=device), info_a["ver"])
        _, _, fake_bc, pred = cascade(real_a, real_b)
        if float(psnr(pred, real_b)) > args.threshold:
            real_ba = degrade(preprocess.luma(real_b), sf)
            panel = vis.patch2vis(
                vis.tensor2img(real_ba, "RGB"),
                vis.tensor2img(fake_bc, "RGB"),
                vis.tensor2img(pred, "RGB"),
                vis.tensor2img(real_b, "RGB"),
            )
            vis.save_png(os.path.join(out_dir, testset.datalist[idx]), panel)
            n_saved += 1
        sys.stdout.write("\r%04d / %04d (saved %d)" %
                         (idx, len(testset), n_saved))
    sys.stdout.write("\n")
    return n_saved


if __name__ == "__main__":
    main()
