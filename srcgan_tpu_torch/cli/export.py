"""Export a trained cascade as a self-contained ``torch.export`` artifact, as
``srcgan_tpu.cli.export``.

  python -m srcgan_tpu_torch.cli.export \\
      --netGA checkpoints/RDDBNet_A2C_x4_0050.npz \\
      --netGB checkpoints/ResDeconv_C2B_x4_0050.npz \\
      --size 128x128 --out cascade_x4.pt2 [--batch 8] [--bf16] \\
      [--platforms cuda,cpu]

The artifact holds the weights and the whole uint8 -> uint8 program
(``srcgan_tpu_torch.deploy.export_cascade``); ``deploy.load_exported``, or
``torch.export.load`` alone, runs it without this package's model code or
the checkpoints.  The default exports a symbolic batch dimension (one
artifact, every batch size).  Traces on the card unless ``--device cpu``
is given.
"""
from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(description="torch.export cascade export")
    p.add_argument("--netGA", type=str, required=True)
    p.add_argument("--netGB", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--size", type=str, default="128x128",
                   help="input HxW the artifact is traced for")
    p.add_argument("--channels", type=int, default=1, choices=(1, 3),
                   help="input channels (3 = RGB, luma taken on the device)")
    p.add_argument("--batch", type=int, default=0,
                   help="concrete batch size; 0 = symbolic (any batch)")
    p.add_argument("--bf16", action="store_true",
                   help="bake bf16 weights and compute into the artifact")
    p.add_argument("--platforms", type=str, default="cuda,cpu",
                   help="comma-separated device types the artifact may load on "
                        "(cuda, cpu)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to trace: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    platforms = tuple(p.strip().lower() for p in args.platforms.split(",") if p.strip())
    if "tpu" in platforms:
        sys.exit("--platforms tpu: a torch.export artifact runs under PyTorch on "
                 "cuda or cpu; there is no TPU target in this package")
    from srcgan_tpu_torch.deploy import PLATFORMS, export_cascade
    from srcgan_tpu_torch.serving import CascadePredictor

    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        sys.exit(f"--platforms {args.platforms}: one or more of {', '.join(PLATFORMS)}")
    pred = CascadePredictor.from_checkpoints(args.netGA, args.netGB, bf16=args.bf16,
                                             device=args.device)
    h, w = (int(v) for v in args.size.lower().split("x"))
    blob = export_cascade(pred, h=h, w=w, c=args.channels, batch=args.batch or None,
                          platforms=platforms)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out}: {len(blob) / 1e6:.2f} MB, input "
          f"({args.batch or 'b'}, {h}, {w}, {args.channels}) uint8, "
          f"platforms {','.join(platforms)}")


if __name__ == "__main__":
    main()
