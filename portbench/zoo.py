"""The cascade with an SR net of the port's zoo in RDDBNet's place: RCAN, as
the configuration's ``sr_model`` names it, then the ResDeconv colorizer.

For such a configuration this module gives the stream driver what
``portbench.cascade`` and ``portbench.flops`` give it for RDDBNet (weights
from the seed, the program's predictor, the spans of a traced run, the
reference's answers, the count of the work);
``drivers/zoo_stream.py`` runs ``drivers/stream.py`` with this module in
the place of both.  A traced run's spans are ``portbench.cascade``'s and,
on RCAN, ``ca`` on each channel attention and ``rcab_conv`` on each RCAB's
two 3x3 convs.

The weights are drawn as ``portbench.cascade`` draws them (kaiming normal
over fan_out, uniform biases), then scaled as the configuration states, so
that random weights behave as a trained net's do: ``rcab_scale`` on each
RCAB's second conv and ``group_scale`` on each group's last conv keep the
trunk's spread near the head's through 200 residual blocks,
``ca_up_scale`` on each channel attention's up conv spreads its gates,
``sr_out_scale`` on the last conv puts the SR output in the gray range and
``pred_scale`` on the colorizer's last conv keeps its output off the clip.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import cascade as _cs
from portbench import faults, variants
from portbench.cascade import compare, device_sync, free, memory_peak  # noqa: F401 (the driver's)
from portbench.flops import conv, resdeconv
from portbench.reference import cascade as ref
from portbench.reference import rcan as rcan_ref

BUILT = {"sr_model.name": "RCAN", "c_model.name": "ResDeconv", "c_model.norm": "GN"}


# -- weights -------------------------------------------------------------------------

def scale_weights(p_sr: dict, p_c: dict, config: dict) -> None:
    """The configuration's scales, in place (see the module docstring)."""
    s = config["sr_model"]
    blocks = s["n_resblocks"]
    for g in range(s["n_resgroups"]):
        for b in range(blocks):
            p_sr[f"{rcan_ref.rcab(g, b)}.2.weight"].mul_(config.get("rcab_scale", 1.0))
            p_sr[f"{rcan_ref.rcab(g, b)}.3.conv_du.2.weight"].mul_(config.get("ca_up_scale", 1.0))
        p_sr[f"body.{g}.body.{blocks}.weight"].mul_(config.get("group_scale", 1.0))
    p_sr["tail.1.weight"].mul_(config.get("sr_out_scale", 1.0))
    p_c["pred.weight"].mul_(config.get("pred_scale", 1.0))


def make_weights(cell) -> tuple:
    """(SR net, colorizer) parameter dicts, float32 on the cell's device,
    from the seed, scaled; the SR net's dict holds its mean shifts."""
    _cs.expect(cell.config, BUILT)
    sr_cfg, c_cfg = cell.config["sr_model"], cell.config["c_model"]
    gen = cell.generator("weights")
    p_sr = _cs._draw(rcan_ref.specs(sr_cfg), gen, cell.device)
    p_sr.update(rcan_ref.constants(sr_cfg, cell.device))
    p_c = _cs._draw(ref.resdeconv_specs(c_cfg), gen, cell.device)
    scale_weights(p_sr, p_c, cell.config)
    return p_sr, p_c


# -- the program -----------------------------------------------------------------------

def program_models(cell, p_sr: dict, p_c: dict) -> tuple:
    """The program's RCAN (its cascade form) and ResDeconv holding the
    benchmark's weights."""
    from srcgan_tpu_torch import models

    s, c = cell.config["sr_model"], cell.config["c_model"]
    sr = models.create(s["name"], s["in_ch"], s["ou_ch"], s["up"],
                       n_resgroups=s["n_resgroups"], n_resblocks=s["n_resblocks"],
                       n_feats=s["n_feats"], reduction=s["reduction"])
    col = models.ResDeconv(c["src_ch"], c["tar_ch"], BN=c["norm"])
    _cs.check_groups(col, c["groups"])
    for net, p in ((sr, p_sr), (col, p_c)):
        net.to(cell.device)
        net.load_state_dict(p, strict=True)
    return sr, col


def predictor(cell, p_sr: dict, p_c: dict, cls=None, calibration=(), **kw):
    """The program's predictor of the configuration's precision, with the
    cell's variant.  The control serves the reference in fp8 in the
    program's place, on the timed path."""
    from srcgan_tpu_torch.serving import CascadePredictor

    cls = cls or CascadePredictor
    sr, col = program_models(cell, p_sr, p_c)
    pred = cls(sr, col, cell.config["sr_model"]["up"],
               bf16=cell.config["precision"] == "bf16", device=cell.device, **kw)
    if cell.variant == "control":
        pred._run = lambda gray_u8: rcan_ref.serve_u8(p_sr, p_c, cell.config, gray_u8, ref.FP8)
    variants.serving(cell, pred)
    faults.serving(cell, pred)
    return pred


def hook_spans(spans, pred) -> None:
    """``portbench.cascade``'s spans (the SR net, the colorizer, its
    GroupNorms), ``ca`` on each channel attention and ``rcab_conv`` on each
    of an RCAB's two 3x3 convs (a conv's call: cuDNN's kernel and the bias
    added after it)."""
    _cs.hook_spans(spans, pred)
    for m in pred.sr_model.modules():
        kind = type(m).__name__
        if kind == "CALayer":
            spans.on(m, "ca")
        elif kind == "RCAB":
            for conv in (m.body[0], m.body[2]):
                spans.on(conv, "rcab_conv")


def reference_u8(cell, p_sr: dict, p_c: dict, inputs: list, block: int = 8) -> list:
    """The float32 reference's uint8 answers for a list of (n, h, w, 1)
    uint8 arrays, ``block`` rows at a time."""
    outs = []
    with ref.exact_fp32():
        for x in inputs:
            parts = [rcan_ref.serve_u8(p_sr, p_c, cell.config,
                                       torch.from_numpy(np.ascontiguousarray(x[i:i + block]))
                                       .to(cell.device)).cpu().numpy()
                     for i in range(0, len(x), block)]
            outs.append(np.concatenate(parts))
    return outs


# -- the count of the work (the reference's layers, as ``portbench.flops``) -----------

def rcab_conv_per_pixel(nf: int = 64) -> int:
    """One of an RCAB's two 3x3 convs, nf -> nf."""
    return conv(nf, nf, 3, 1)


def rcab_conv_bytes(pixels: int, nf: int = 64, itemsize: int = 2) -> int:
    """One RCAB 3x3 conv's input read once, output written once, weights and
    bias once."""
    return 2 * pixels * nf * itemsize + (9 * nf * nf + nf) * itemsize


def rcan_per_pixel(sr: dict) -> int:
    """RCAN's convolutions per input pixel: the head, two a block and one a
    group in the trunk, the body conv, the upsampler's conv to 4 n_feats at
    each factor of 2, the last conv at the output scale."""
    nf, up = sr["n_feats"], sr["up"]
    trunk = sr["n_resgroups"] * (2 * sr["n_resblocks"] + 1) + 1
    total = conv(sr["in_ch"], nf, 3, 1) + trunk * rcab_conv_per_pixel(nf)
    scale = 1
    while scale < up:
        total += conv(nf, 4 * nf, 3, scale * scale)
        scale *= 2
    return total + conv(nf, sr["ou_ch"], 3, up * up)


def rcan_attention_per_image(sr: dict) -> int:
    """The channel attentions' 1x1 convs, on one pixel an image each."""
    nf, red = sr["n_feats"], sr["reduction"]
    return sr["n_resgroups"] * sr["n_resblocks"] * 2 * conv(nf, nf // red, 1, 1)


def cascade_forward(n: int, h: int, w: int, sr: dict, c: dict) -> int:
    """RCAN on n gray h x w inputs, then the colorizer on its output."""
    up = sr["up"]
    return (n * h * w * rcan_per_pixel(sr) + n * rcan_attention_per_image(sr)
            + n * resdeconv(h * up, w * up, c["tar_ch"]))
