"""Convert a torchvision VGG16/VGG19 checkpoint (.pth) to the .npz that
``srcgan_tpu_torch.losses_vgg.load_vgg_params`` (and the JAX package's) reads.

No weights are downloaded here: fetch ``vgg16-397923af.pth`` /
``vgg19-dcbb9e9d.pth`` on a connected machine, copy the file over, then

    python -m srcgan_tpu_torch.cli.convert_vgg vgg16-397923af.pth vgg16.npz
    python -m srcgan_tpu_torch.cli.train_cas --perceptual vgg16.npz ...

Only the ``features.*`` conv weights and biases are kept (the perceptual
losses never use the classifier), in OIHW; every conv's shape is checked
against the torchvision layout, so a mismatched architecture fails loudly.
"""
from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="torchvision VGG .pth -> .npz")
    p.add_argument("src", help="torchvision VGG state_dict (.pth)")
    p.add_argument("dst", help="output .npz path")
    p.add_argument("--arch", default="vgg16", choices=["vgg16", "vgg19"])
    return p


def convert(src: str, dst: str, arch: str = "vgg16") -> int:
    """Write the .npz; returns the number of arrays written."""
    import torch

    from srcgan_tpu_torch.losses_vgg import VGG16_CFG, VGG19_CFG, _features_plan

    cfg = VGG16_CFG if arch == "vgg16" else VGG19_CFG
    sd = torch.load(src, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out, cin = {}, 3
    for idx, kind, cout in _features_plan(cfg):
        if kind != "conv":
            continue
        w = sd[f"features.{idx}.weight"].detach().numpy()
        b = sd[f"features.{idx}.bias"].detach().numpy()
        if w.shape != (cout, cin, 3, 3):
            raise ValueError(
                f"features.{idx}.weight has shape {w.shape}, expected "
                f"{(cout, cin, 3, 3)}: wrong --arch?")
        out[f"features.{idx}.weight"] = w
        out[f"features.{idx}.bias"] = b
        cin = cout
    np.savez(dst, **out)
    return len(out)


def main(argv=None):
    args = build_parser().parse_args(argv)
    n = convert(args.src, args.dst, args.arch)
    print(f"wrote {args.dst}: {n} arrays ({args.arch} features)")


if __name__ == "__main__":
    main()
