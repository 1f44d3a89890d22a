"""Blend generator checkpoints in weight space, as ``srcgan_tpu.cli.blend``.

Two modes (``srcgan_tpu_torch.weightspace``):

  ESRGAN network interpolation (Wang et al. 2018 §3.4): blend a PSNR-trained
  and a GAN-trained generator without retraining::

    python -m srcgan_tpu_torch.cli.blend --alpha 0.8 \\
        checkpoints/RDDBNet_A2C_x4_0050.npz gan/RDDBNet_A2C_x4_0025.npz \\
        --out interp/RDDBNet_A2C_x4_0050.npz

  Checkpoint averaging (SWA over the last K epoch saves)::

    python -m srcgan_tpu_torch.cli.blend checkpoints/RDDBNet_A2C_x4_00{30,40,50}.npz \\
        --out swa/RDDBNet_A2C_x4_0050.npz

Inputs may be .npz saves of either package or reference .pth state_dicts
(the architecture is rebuilt from the name-encoded config, so keep the
reference file-name convention on --out too: the eval and serve drivers
parse it).  The output is a parameters-only .npz that ``cli.test_cas``,
``cli.serve`` and ``cli.export`` of either package load.  The float64 sums
run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(description="weight-space checkpoint blending")
    p.add_argument("inputs", nargs="+",
                   help="2+ checkpoints of the SAME architecture (.npz or reference .pth)")
    p.add_argument("--out", required=True,
                   help="output .npz path (keep the <Model>_<role>_x<up>_<epoch>.npz "
                        "convention so the eval drivers can parse it)")
    p.add_argument("--alpha", type=float, default=None,
                   help="ESRGAN network interpolation: exactly 2 inputs, "
                        "out = (1-alpha)*first + alpha*second")
    p.add_argument("--weights", type=float, nargs="+", default=None,
                   help="per-input averaging weights (default: uniform SWA mean; "
                        "normalized to sum to 1)")
    p.add_argument("--force", action="store_true", help="overwrite an existing --out")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to sum: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.alpha is not None and args.weights is not None:
        sys.exit("--alpha and --weights are mutually exclusive")
    if args.alpha is not None and len(args.inputs) != 2:
        sys.exit(f"--alpha interpolates exactly 2 checkpoints (got {len(args.inputs)})")
    if len(args.inputs) < 2:
        sys.exit("need at least 2 input checkpoints to blend")
    if os.path.exists(args.out) and not args.force:
        sys.exit(f"{args.out} already exists; pass --force to overwrite")

    from srcgan_tpu_torch import config, interop, weightspace
    from srcgan_tpu_torch.train.state import save_params

    device = config.resolve_device(args.device)
    model, info0 = weightspace.load_checkpoint_model(args.inputs[0])
    arch0 = {k: info0[k] for k in ("model", "ver", "role", "up")}
    dicts = [{k: p.detach() for k, p in model.named_parameters()}]
    for path in args.inputs[1:]:
        params, info = weightspace.load_checkpoint_params(path)
        arch = {k: info[k] for k in arch0}
        if arch != arch0:
            sys.exit(f"{path} is a {arch} checkpoint; expected {arch0} "
                     "(all blend inputs must share the architecture)")
        dicts.append(params)
    dicts[0] = {k: t.to(device) for k, t in dicts[0].items()}

    if args.alpha is not None:
        out = weightspace.interpolate_params(dicts[0], dicts[1], args.alpha)
        how = f"alpha={args.alpha} interpolation"
    else:
        if args.weights is not None and len(args.weights) != len(dicts):
            sys.exit(f"{len(args.weights)} weights for {len(dicts)} inputs")
        out = weightspace.blend_params(dicts, args.weights)
        how = f"weights={args.weights}" if args.weights else "uniform mean"
    save_params(args.out, interop.jax_tree_from_module(model, out)[0])
    print(f"{args.out}: {arch0['model']} {arch0['role']} x{arch0['up']} "
          f"<- {how} of {len(dicts)} checkpoint(s)")


if __name__ == "__main__":
    main()
