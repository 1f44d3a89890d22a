"""The cascade's training step, ``CasTrainer.train_step_u8``, one call a step
in a Python loop, over uint8 RGB targets.

Traffic keys: ``batch`` and ``side`` (the targets), ``pool``
(distinct batches made from the seed, replayed in turn), ``checked``
(the first steps, run in set-up through the window's own call and feed,
that the reference follows), ``warmup`` (further steps before the window),
``trace_s`` (the profiled slice, the window's last seconds).

Every row of a batch differs: row r of a batch is noise of amplitude
growing with r about a mid-gray drawn per row, so that a step that loses
part of its batch shows in its loss.  The window ends in a synchronise;
``train_samples_s`` is the samples of every step in it over its length.

What is compared with the plain float32 reference, which trains copies of
the same weights on the same batches: the first step's inputs of the two
nets, the gray and its bilinear downsample that ``gray_degrade`` makes
(``degrade_max_gap``, the largest difference of a value, in [0, 1]; a row
missing counts as 1); every leaf's gradient of the first step, as Adam
holds it after that step (``sr_grad_median_gap`` and
``colorizer_grad_median_gap``, each net's median leaf's gap); every
leaf's change over the checked steps (``change_gap``, the worst leaf's, of
both nets).  A leaf's gap is the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf.  Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of the gradients and the change (a bias
ahead of a GroupNorm: Adam moves it by round-off alone).  Printed beside
them and not judged: each step's losses and the worst leaf's gradient.  In
bf16 these swing from seed to seed (Adam's first updates are about lr times
the sign of each gradient element, so rounding that flips a small
element's sign moves the later losses; the first colorizer conv's gradient
is a sum that cancels), and the first step's loss is as near the reference
in the fp8 control as in sound runs.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench import cascade as cs
from portbench import flops, harness, tracing, variants
from portbench.reference import cascade as ref
from portbench.reference import train as ref_train

BETA1 = 0.9      # Adam's first moment after one step is (1 - beta1) * gradient
MEDIAN_GAP = {"sr": "sr_grad_median_gap", "c": "colorizer_grad_median_gap"}


def batches(cell) -> torch.Tensor:
    """(pool, batch, side, side, 3) uint8 targets from the seed."""
    t = cell.traffic
    gen = cell.generator("inputs")
    shape = (t["pool"], t["batch"], t["side"], t["side"], 3)
    noise = torch.rand(shape, generator=gen, device=cell.device) * 2 - 1
    mid = 64 + 128 * torch.rand((t["pool"], t["batch"], 1, 1, 1), generator=gen,
                                device=cell.device)
    amp = torch.linspace(8, 120, t["batch"], device=cell.device).view(1, -1, 1, 1, 1)
    return (mid + amp * noise).round().clamp(0, 255).to(torch.uint8)


def leaf_gaps(got: dict, want: dict, keep) -> dict:
    """Each kept leaf's gap between norms, over max(its reference norm, the
    median leaf's)."""
    norms = {k: float(want[k].norm()) for k in keep}
    floor = statistics.median(norms.values())
    return {k: abs(float(got[k].norm()) - norms[k]) / max(norms[k], floor) for k in keep}


def input_gap(got, want) -> float:
    """The largest difference of a value between two (N, 1, h, w) inputs; 1,
    the whole range, where rows are missing."""
    if got.numel() != want.numel():
        return 1.0
    return float((got.reshape(want.shape).float() - want).abs().max())


def capture_inputs(nets: dict) -> tuple:
    """({role: the first input each net is called with}, hook handles)."""
    seen, handles = {}, []
    for role, net in nets.items():
        def pre(_mod, args, role=role):
            seen.setdefault(role, args[0].detach().float().clone())
        handles.append(net.register_forward_pre_hook(pre))
    return seen, handles


def run(cell) -> harness.Outcome:
    from srcgan_tpu_torch.train.cas import CasTrainer

    t, dev = cell.traffic, cell.device
    sr_cfg, c_cfg = cell.config["sr_model"], cell.config["c_model"]
    tr = cell.config["train"]
    cs.expect(cell.config, {"train.trainer": "CasTrainer", "train.optimizer": "adam"})
    p_sr, p_c = cs.make_weights(cell)
    data = batches(cell)
    checked = [data[i % t["pool"]] for i in range(t["checked"])]
    prog = {}
    counters, setup_s, peak, trace, metrics = {}, None, 0, None, {}
    enq = []
    if cell.variant == "control":
        # the reference in a precision below the configuration's, in the program's place
        with ref.exact_fp32():
            losses, first, after, seen = ref_train.run(p_sr, p_c, cell.config, checked,
                                                       tr["lr"], ref.QUANTIZERS["fp8"])
        prog = {"losses": losses, "first": first, "after": after, "seen": seen}
        steps, window = 0, 0.0
    else:
        trainer = CasTrainer(sr_model=sr_cfg["name"], c_model=c_cfg["name"], up=sr_cfg["up"],
                             lr=tr["lr"], act_dtype=getattr(torch, tr["act_dtype"]),
                             fused_input=tr["fused_input"], device=dev)
        state = trainer.init(0)
        state.sr.model.load_state_dict(p_sr, strict=True)
        state.c.model.load_state_dict(p_c, strict=True)
        cs.check_groups(state.c.model, c_cfg["groups"])
        variants.training(cell, trainer)
        seen, hooks = capture_inputs({"sr": state.sr.model, "c": state.c.model})
        losses = []
        for i, x in enumerate(checked):
            state, met = trainer.train_step_u8(state, x, x, tr["lr"])
            losses.append((met["loss_SR"], met["loss_C"]))
            if i == 0:
                for h in hooks:
                    h.remove()
                first = {role: {k: ts.opt.state[p]["exp_avg"] / (1 - BETA1)
                                if p in ts.opt.state else torch.zeros_like(p)
                                for k, p in ts.model.named_parameters()}
                         for role, ts in (("sr", state.sr), ("c", state.c))}
        after = {role: {k: p.detach().clone() for k, p in ts.model.named_parameters()}
                 for role, ts in (("sr", state.sr), ("c", state.c))}
        prog = {"losses": [(float(a), float(b)) for a, b in losses], "first": first,
                "after": after, "seen": seen}
        k = t["checked"]
        for _ in range(t["warmup"]):
            state, _ = trainer.train_step_u8(state, data[k % t["pool"]], data[k % t["pool"]],
                                             tr["lr"])
            k += 1
        cs.device_sync(dev)

        tracer = tracing.Tracer(cell.trace, t["trace_s"])
        gc.collect()
        setup_s = harness.process_seconds()
        t0 = time.perf_counter()
        end = t0 + cell.seconds
        tracer.open(end)
        steps = 0
        while (now := time.perf_counter()) < end:
            tracer.tick(now, (steps, sum(enq)))
            x = data[k % t["pool"]]
            state, _ = trainer.train_step_u8(state, x, x, tr["lr"])
            enq.append(time.perf_counter() - now)
            k += 1
            steps += 1
        cs.device_sync(dev)
        window = time.perf_counter() - t0
        tracer.stop()
        trace = tracer.finish()
        peak = cs.memory_peak(dev)
        metrics = {"train_samples_s": steps * t["batch"] / window, "setup_s": setup_s}
        counted_s, (counted, enqueue_s) = tracer.untraced_part(t0, t0 + window,
                                                              (steps, sum(enq)))
        counters = {"window_s": counted_s, "steps": counted, "enqueue_s": enqueue_s,
                    "model_flop": counted * flops.train_step(t["batch"], t["side"], sr_cfg,
                                                            cell.config["c_model"]),
                    "dtype": cell.config["precision"]}
        del trainer, state, met
    cs.free(dev)

    with ref.exact_fp32():
        want_losses, want_first, want_after, want_seen = ref_train.run(
            p_sr, p_c, cell.config, checked, tr["lr"])
    numbers, notes = {}, {}
    gaps = {role: input_gap(prog["seen"][role], want_seen[role]) for role in ("sr", "c")}
    notes["input gap"] = gaps
    numbers["degrade_max_gap"] = max(gaps.values())
    step_gaps = [max(abs(g - w) / w for g, w in zip(gs, ws))
                 for gs, ws in zip(prog["losses"], want_losses)]
    notes["loss gap by step"] = step_gaps
    worst_grad, change = 0.0, 0.0
    for role, p0 in (("sr", p_sr), ("c", p_c)):
        g_norms = {k: float(v.norm()) for k, v in want_first[role].items()}
        floor = 1e-3 * statistics.median(g_norms.values())
        keep = [k for k, v in g_norms.items() if v >= floor]
        notes[f"{role} leaves left out"] = sorted(set(g_norms) - set(keep))
        g = leaf_gaps(prog["first"][role], want_first[role], keep)
        moved = {k: prog["after"][role][k].float() - p0[k] for k in keep}
        moved_ref = {k: want_after[role][k] - p0[k] for k in keep}
        c = leaf_gaps(moved, moved_ref, keep)
        g_worst, c_worst = max(g, key=g.get), max(c, key=c.get)
        notes[f"{role} grad gap"] = (f"median {statistics.median(g.values()):.6f}, worst "
                                     f"{g_worst} {g[g_worst]:.6f}")
        notes[f"{role} worst change"] = f"{c_worst} {c[c_worst]:.6f}"
        numbers[MEDIAN_GAP[role]] = statistics.median(g.values())
        worst_grad = max(worst_grad, g[g_worst])
        change = max(change, c[c_worst])
    numbers["change_gap"] = change
    notes["worst leaf grad gap"] = worst_grad
    notes["losses"] = f"program {prog['losses']}, reference {want_losses}"
    if enq:
        notes["window"] = (f"{steps} steps in {window:.4f} s; host enqueue per step "
                           f"median {statistics.median(enq) * 1e3:.3f} ms")
    return harness.Outcome(metrics=metrics, attempted=steps, failed=0, numbers=numbers,
                           memory_peak_bytes=peak, counters=counters, trace=trace, notes=notes)
