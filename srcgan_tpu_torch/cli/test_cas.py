"""Cascaded pipeline evaluation tool, as ``srcgan_tpu.cli.test_cas``.

  python -m srcgan_tpu_torch.cli.test_cas \\
      --netGA checkpoints/RDDBNet_A2C_x2_0050.npz \\
      --netGB checkpoints/ResDeconv_C2B_x2_0050.npz

The protocol:
  - model class, scale and colour space (``@G2LAB``) are parsed from the
    checkpoint file names;
  - the degradation replay uses nearest resampling (training uses bilinear);
  - the evaluators [MSE, PSNR, AE, SSIM] are averaged over the test split:
    batches are scored per sample, which reproduces the one-sample-at-a-time
    means exactly;
  - per-sample PNGs go to result/{A,B}_<model>_x<up>_<epoch>/ under the
    datalist's names, and the means are appended to result/Performs.csv;
  - on @G2LAB checkpoints the SR net predicts L and the colorizer ab: the
    metrics compare L (+) ab with the normalized-LAB target, and the PNGs are
    L (+) ab converted to RGB;
  - with --self-ensemble both domains' (SR, colorized) pairs are the x8
    dihedral self-ensemble (``ops.ensemble``): every D4 copy of a batch in one
    forward, inverted and averaged;
  - with --mesh-size N each batch (rounded up to a multiple of N and padded
    with copies of its last row) is split over N ranks (``parallel.mesh``:
    the tool spawns them, one card each, or all on the CPU with --device
    cpu); rank 0 gathers the outputs and metrics and writes the same PNGs
    and Performs.csv row as one process.

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import math
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description="cascaded pipeline evaluation")
    p.add_argument("--netGA", type=str, required=True)
    p.add_argument("--netGB", type=str, required=True)
    p.add_argument("--const", action="store_true",
                   help="constant-resolution eval (nearest down, then up)")
    p.add_argument("--root", type=str, default="Sat2Aerx1")
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--result-dir", type=str, default="./result")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--mesh-size", type=int, default=None,
                   help="data-parallel eval over N ranks (one card each, or the "
                        "CPU with --device cpu); the batch size is raised to a "
                        "multiple of N")
    p.add_argument("--self-ensemble", action="store_true",
                   help="geometric self-ensemble (x8 dihedral TTA, the 'EDSR+' "
                        "protocol): run every D4 transform of each input as one "
                        "batched forward, invert and average the outputs, at ~8x "
                        "the inference FLOPs")
    p.add_argument("--precision", type=str, default="highest",
                   choices=["highest", "high", "default", "int8"],
                   help="highest = fp32 with TF32 off (metric-grade); high = the "
                        "same fp32 mode (the card has no 3-pass bf16 mode to map "
                        "it to); default = bf16 networks; int8 = post-training "
                        "quantized convs (srcgan_tpu_torch.quant; fp32 between them, "
                        "calibrated on the first eval batches)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to run: the card by default (an error without "
                        "one); 'cpu' to run on the CPU")
    return p


def load_cascade(netGA: str, netGB: str, device, dtype):
    """(info of netGA, SR net, colorizer) from name-encoded checkpoints, in
    eval mode on ``device`` at ``dtype``.  A G2LAB colorizer has two output
    channels (ab)."""
    import torch

    from srcgan_tpu_torch import models
    from srcgan_tpu_torch.interop import load_params_any
    from srcgan_tpu_torch.train.state import parse_checkpoint_name

    info_a = parse_checkpoint_name(netGA)
    info_b = parse_checkpoint_name(netGB)
    lab = info_a["ver"] == "G2LAB"
    nets = []
    for net, path in ((models.create(info_a["model"], 1, 1, info_a["up"]), netGA),
                      (models.create(info_b["model"], 1, 2 if lab else 3), netGB)):
        load_params_any(net, path)
        net.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        nets.append(net.eval().requires_grad_(False))
    return info_a, nets[0], nets[1]


def make_cascade(sr_net, c_net, up: int, const: bool, mode: str, lab: bool = False,
                 self_ensemble: bool = False):
    """cascade(realA, realB) -> (fake_AC, fake_AB, fake_BC, fake_BB), fp32
    NHWC: the degradation replay and the cascade on both domains, under
    ``torch.no_grad()`` in ``config.precision(mode)``.  With ``lab`` realB is
    normalized LAB and its L channel is the SR target; with
    ``self_ensemble`` each domain's pair is the dihedral self-ensemble."""
    import torch

    from srcgan_tpu_torch import config
    from srcgan_tpu_torch.data import preprocess
    from srcgan_tpu_torch.ops import ensemble
    from srcgan_tpu_torch.ops.conv import to_nchw, to_nhwc

    dtype = config.DTYPES[mode]

    def run_casc(x):
        c = sr_net(to_nchw(x).to(dtype))
        b = c_net(c)
        return to_nhwc(c).float(), to_nhwc(b).float()

    def both(x):
        return ensemble.self_ensemble_apply(run_casc, x) if self_ensemble else run_casc(x)

    def cascade(real_a, real_b):
        with torch.no_grad(), config.precision(mode):
            real_bc = real_b[..., :1] if lab else preprocess.luma(real_b)
            if const:
                real_ba = preprocess.degrade_const_nearest(real_bc, up)
                real_aa = real_a
            else:
                real_ba = preprocess.degrade_nearest(real_bc, up)
                real_aa = preprocess.degrade_nearest(real_a, up)
            fake_ac, fake_ab = both(real_aa)
            fake_bc, fake_bb = both(real_ba)
            return fake_ac, fake_ab, fake_bc, fake_bb

    return cascade


def _csv_cell(v) -> str:
    """One cell as pandas' to_csv(float_format='%.3f') writes it."""
    if isinstance(v, float):
        return "" if math.isnan(v) else "%.3f" % v
    return str(v)


def append_performs(log_path: str, row: dict) -> None:
    """Append ``row`` to Performs.csv in the layout pandas gives it: the header
    time,checkpoint,MSE,PSNR,AE,SSIM on a new file, floats as %.3f, each new
    row under the rows the file already has."""
    is_new = not os.path.exists(log_path)
    with open(log_path, "a", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        if is_new:
            writer.writerow(list(row))
        writer.writerow([_csv_cell(v) for v in row.values()])


def _table_cell(v) -> str:
    if isinstance(v, float):
        text = ("%.6f" % v).rstrip("0")
        return text + "0" if text.endswith(".") else text
    return str(v)


def format_row(row: dict) -> str:
    """The row as a two-line table, every column right-justified: what
    ``DataFrame.tail(1).to_string(index=False)`` prints for it."""
    cells = {k: _table_cell(v) for k, v in row.items()}
    widths = {k: max(len(k), len(c)) for k, c in cells.items()}
    return ("\n".join(" ".join(t.rjust(widths[k]) for k, t in line.items())
                      for line in ({k: k for k in cells}, cells)))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    from srcgan_tpu_torch.parallel import mesh as mesh_lib
    if mesh_lib.spawned_by_tool(args.mesh_size or 0):
        return mesh_lib.launch("srcgan_tpu_torch.cli.test_cas:main", argv, args.mesh_size,
                               args.device)

    import torch

    from srcgan_tpu_torch import config, data
    from srcgan_tpu_torch.data import preprocess
    from srcgan_tpu_torch.metrics import per_sample_evaluators
    from srcgan_tpu_torch.ops import color
    from srcgan_tpu_torch.utils import vis

    mesh = None
    if args.mesh_size:
        mesh = mesh_lib.make_mesh((args.mesh_size,), ("data",), device=args.device)
        if args.batch_size % args.mesh_size:
            eff = -(-args.batch_size // args.mesh_size) * args.mesh_size
            if mesh.is_main:
                print(f"--mesh-size {args.mesh_size}: raising --batch-size "
                      f"{args.batch_size} -> {eff} (a mesh multiple; per-sample "
                      "metrics make this protocol-neutral, and without it every "
                      "batch would be mostly discarded pad rows)")
            args.batch_size = eff
    main_rank = mesh is None or mesh.is_main
    device = mesh.device if mesh is not None else config.resolve_device(args.device)
    mode = "bf16" if args.precision == "default" else "fp32"
    info_a, sr_net, c_net = load_cascade(args.netGA, args.netGB, device, config.DTYPES[mode])
    sf, lab = info_a["up"], info_a["ver"] == "G2LAB"
    cascade = make_cascade(sr_net, c_net, sf, args.const, mode, lab, args.self_ensemble)

    testset = data.FileListDataset(args.root, "test", info_a["ver"], args.data_dir)

    tag = "_".join([info_a["model"], f"x{sf}", f"{info_a['epoch']:04d}"])
    save_dir_a = os.path.join(args.result_dir, "A_" + tag)
    save_dir_b = os.path.join(args.result_dir, "B_" + tag)
    if main_rank:
        os.makedirs(save_dir_a, exist_ok=True)
        os.makedirs(save_dir_b, exist_ok=True)

    def gather(t):
        """The global batch of a per-rank tensor (every rank's rows in order)."""
        return t if mesh is None else mesh_lib.all_gather_batch(t, mesh)

    def to_u8(t):
        """float NHWC batch -> uint8 on the host: clip, times 255, truncate
        (the global batch under a mesh)."""
        return gather((t.clamp(0.0, 1.0) * 255.0).to(torch.uint8)).cpu().numpy()

    run_ctx = contextlib.nullcontext
    if args.precision == "int8":
        from srcgan_tpu_torch import quant

        # calibrate on the first two eval batches through the both-domain cascade
        cal = []
        for src_u8, tar_u8, _ in data.batches(testset, args.batch_size):
            cal.append((torch.from_numpy(src_u8).to(device), torch.from_numpy(tar_u8).to(device)))
            if len(cal) >= 2:
                break
        scales = quant.calibrate_fn(
            lambda pair: cascade(*preprocess.convert_pair(*pair, info_a["ver"])), cal)
        print(f"int8: calibrated {len(scales)} conv callsites")
        prepared = {}
        run_ctx = lambda: quant.quant_mode("int8", scales, prepared)  # noqa: E731

    ps_evals = per_sample_evaluators()
    performs = [[] for _ in ps_evals]
    done = n_batches = 0
    encode_seconds = 0.0
    t_start = time.perf_counter()

    def host_batches():
        """The host batches (this rank's shard of each, padded, under a mesh);
        the indices stay on the host (a list passes the staging as it is)."""
        for src, tar, idxs in data.batches(testset, args.batch_size):
            if mesh is not None:
                # pad rows only feed the ranks' programs; the loop below walks
                # idxs, so they never reach Performs.csv or disk
                src, tar = (mesh_lib.shard_of(mesh_lib.pad_batch_to(a, mesh.size)[0], mesh)
                            for a in (src, tar))
            yield src, tar, idxs.tolist()

    for src_u8, tar_u8, idxs in preprocess.device_put_iter(host_batches(), device):
        real_a, real_b = preprocess.convert_pair(src_u8, tar_u8, info_a["ver"])
        with run_ctx():
            fake_ac, fake_ab, fake_bc, fake_bb = cascade(real_a, real_b)
        pred = torch.cat([fake_bc, fake_bb], dim=-1) if lab else fake_bb
        # one copy to the host for the four metrics of the batch
        per_sample = gather(torch.stack([fn(pred, real_b) for _, fn in ps_evals], 1)
                            ).T.cpu().numpy()
        if lab:
            imgs_a = to_u8(color.lab_norm_to_rgb(torch.cat([fake_ac, fake_ab], dim=-1)))
            imgs_b = to_u8(color.lab_norm_to_rgb(pred))
        else:
            imgs_a, imgs_b = to_u8(fake_ab), to_u8(fake_bb)
        n_batches += 1
        if not main_rank:
            continue
        names = []
        for j, idx in enumerate(idxs):
            acc = ""
            for i, (ev_name, _) in enumerate(ps_evals):
                val = float(per_sample[i][j])
                acc += " {}:{:0.2f};".format(ev_name, val)
                performs[i].append(val)
            names.append(testset.datalist[idx])
            done += 1
            sys.stdout.write("\rGenerated %s (%04d / %04d) >> %s" %
                             (names[-1], done - 1, len(testset), acc))
        t_enc = time.perf_counter()
        vis.save_png_batch([os.path.join(save_dir_a, n) for n in names], imgs_a[:len(names)])
        vis.save_png_batch([os.path.join(save_dir_b, n) for n in names], imgs_b[:len(names)])
        encode_seconds += time.perf_counter() - t_enc
    seconds = time.perf_counter() - t_start
    if not main_rank:
        return None
    sys.stdout.write("\n")

    row = {"time": time.strftime("%h_%d"),
           "checkpoint": os.path.basename(args.netGA).rsplit(".", 1)[0]}
    row.update({name: sum(p) / len(p) for (name, _), p in zip(ps_evals, performs)})
    append_performs(os.path.join(args.result_dir, "Performs.csv"), row)
    print(format_row(row))
    return {**row, "images": done, "batches": n_batches, "eval_seconds": seconds,
            "encode_seconds": encode_seconds, "device": str(device)}


if __name__ == "__main__":
    main()
