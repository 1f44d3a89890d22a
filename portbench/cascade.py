"""What the cascade's drivers share: weights from the seed, the program's
predictor built on them, the spans of a traced run, and the comparison of
served answers with the reference."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import variants
from portbench.reference import cascade as ref


def _draw(specs: list, gen: torch.Generator, device) -> dict:
    """Every parameter of ``specs`` from two draws on the device: kaiming
    normal weights, uniform biases, GroupNorm's ones and zeros."""
    sizes = {d: sum(math.prod(s) for _, s, dd, _ in specs if dd == d) for d in ("normal", "uniform")}
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device)
    out, at = {}, {"normal": 0, "uniform": 0}
    for name, shape, draw, fan in specs:
        n = math.prod(shape)
        if draw == "normal":
            out[name] = normal[at[draw]:at[draw] + n].view(shape) * math.sqrt(2.0 / fan)
        elif draw == "uniform":
            out[name] = (uniform[at[draw]:at[draw] + n].view(shape) * 2 - 1) / math.sqrt(fan)
        else:
            out[name] = (torch.ones if draw == "ones" else torch.zeros)(shape, device=device)
        at[draw] = at.get(draw, 0) + n
    return out


# what the drivers and the reference build: a configuration that names
# anything else is refused, not run as these
BUILT = {"sr_model.name": "RDDBNet", "c_model.name": "ResDeconv", "c_model.norm": "GN"}


def expect(config: dict, values: dict) -> None:
    """Refuse a configuration whose ``group.key`` differs from ``values``."""
    for path, want in values.items():
        group, key = path.split(".")
        got = config.get(group, {}).get(key)
        if got != want:
            raise ValueError(f"configuration {config.get('name')!r} has {path} = {got!r}; "
                             f"the benchmark builds only {want!r}")


def check_groups(net, groups: int) -> None:
    """Refuse a program module whose GroupNorms differ from the configuration's."""
    found = {m.num_groups for m in net.modules() if isinstance(m, torch.nn.GroupNorm)}
    if found != {groups}:
        raise ValueError(f"the program's colorizer has GroupNorm groups {sorted(found)}; "
                         f"the configuration states {groups}")


def make_weights(cell) -> tuple:
    """(SR net, colorizer) parameter dicts, float32 on the cell's device, from
    the seed; the SR net's and the colorizer's last convs scaled by the
    configuration's ``sr_out_scale`` and ``pred_scale``."""
    expect(cell.config, BUILT)
    sr_cfg, c_cfg = cell.config["sr_model"], cell.config["c_model"]
    gen = cell.generator("weights")
    p_sr = _draw(ref.rddbnet_specs(sr_cfg), gen, cell.device)
    p_c = _draw(ref.resdeconv_specs(c_cfg), gen, cell.device)
    p_sr["conv_last.weight"].mul_(cell.config.get("sr_out_scale", 1.0))
    p_c["pred.weight"].mul_(cell.config.get("pred_scale", 1.0))
    return p_sr, p_c


def program_models(cell, p_sr: dict, p_c: dict) -> tuple:
    """The program's RDDBNet and ResDeconv holding the benchmark's weights."""
    from srcgan_tpu_torch import models

    s, c = cell.config["sr_model"], cell.config["c_model"]
    sr = models.RDDBNet(s["in_ch"], s["ou_ch"], s["up"], nf=s["nf"], nb=s["nb"], gc=s["gc"])
    col = models.ResDeconv(c["src_ch"], c["tar_ch"], BN=c["norm"])
    check_groups(col, c["groups"])
    for net, p in ((sr, p_sr), (col, p_c)):
        net.to(cell.device)
        net.load_state_dict(p, strict=True)
    return sr, col


def predictor(cell, p_sr: dict, p_c: dict, cls=None, calibration=(), **kw):
    """The program's predictor of the configuration's precision (the control:
    its int8 path, calibrated on ``calibration``), with the cell's variant."""
    from srcgan_tpu_torch.serving import CascadePredictor

    cls = cls or CascadePredictor
    sr, col = program_models(cell, p_sr, p_c)
    int8 = cell.variant == "control"
    pred = cls(sr, col, cell.config["sr_model"]["up"], bf16=cell.config["precision"] == "bf16",
               int8=int8, device=cell.device, **kw)
    if int8:
        pred.calibrate(list(calibration))
    variants.serving(cell, pred)
    return pred


def hook_spans(spans, pred) -> None:
    """The spans the serving readers take: the colorizer, its GroupNorms, the
    SR net and each of its RDB5 blocks."""
    spans.on(pred.c_model, "colorizer")
    spans.on(pred.sr_model, "sr_net")
    for name, m in pred.c_model.named_modules():
        if isinstance(m, torch.nn.GroupNorm):
            spans.on(m, "group_norm")
    for name, m in pred.sr_model.named_modules():
        if type(m).__name__ == "ResidualDenseBlock5":
            spans.on(m, "rdb5")


def reference_u8(cell, p_sr: dict, p_c: dict, inputs: list, block: int = 8) -> list:
    """The float32 reference's uint8 answers for a list of (n, h, w, 1) uint8
    arrays, ``block`` rows at a time."""
    outs = []
    with ref.exact_fp32():
        for x in inputs:
            parts = [ref.serve_u8(p_sr, p_c, cell.config,
                                  torch.from_numpy(np.ascontiguousarray(x[i:i + block]))
                                  .to(cell.device)).cpu().numpy()
                     for i in range(0, len(x), block)]
            outs.append(np.concatenate(parts))
    return outs


# an output value further than this from the reference's is off
OFF_LSB = 8


def compare(answers: list) -> tuple:
    """Numbers of a list of (program, reference) uint8 answers: the worst
    answer's share of values more than ``OFF_LSB`` from the reference; and
    notes (the worst answer's mean |difference|, the overall mean, the
    largest difference, the shares over 2, 4 and 8 LSB of all values)."""
    worst, worst_mean, total, count, big = 0.0, 0.0, 0.0, 0, 0
    over = {k: 0 for k in (2, 4, 8)}
    for got, want in answers:
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        worst = max(worst, float((d > OFF_LSB).mean()))
        worst_mean = max(worst_mean, float(d.mean()))
        total += float(d.sum())
        count += d.size
        big = max(big, int(d.max()))
        for k in over:
            over[k] += int((d > k).sum())
    numbers = {"worst_answer_share_off": worst if answers else None}
    notes = {"answers compared": len(answers), "worst answer mean_lsb": worst_mean,
             "mean_lsb": total / max(count, 1), "max_lsb": big,
             **{f"share_over_{k}_lsb": v / max(count, 1) for k, v in over.items()}}
    return numbers, notes


def device_sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
