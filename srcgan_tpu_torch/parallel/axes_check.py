"""The space, model and pipe axes on 2 or 4 ranks, once, on stated problems:
the runs that tests/test_torch_space.py (2 ranks) and
tests/test_torch_tp_pipe.py (4 ranks) hold against the JAX package.

    python -m srcgan_tpu_torch.parallel.axes_check --ranks 2 --device cpu
    python -m srcgan_tpu_torch.parallel.axes_check --cards 4      # the readings on N cards

Every model is built from a fixed seed (``build``) and every input from
numpy seed 0 (``make_problem``), so a test process rebuilds the same weights
and carries them to JAX through ``interop``.  Each rank runs every check of
its world and rank 0 returns one dict of numpy arrays:

- 2 ranks, a ``space`` mesh: ``make_spatial_infer`` of ESPCN x2 at
  (1,64,16,1) and RDDBNet(1,1,4,nf=16,nb=1) at (1,32,8,1); the
  space-sharded predictors of ESPCN x2 + ResDeconv (the batch at (1,64,16,1)
  before and after a reload of another checkpoint pair, self-ensembled, and
  the JAX package's three odd scenes through tiles of 32, overlap 8);
  and, against this rank's own unsharded computation in float64, the
  group and batch norms over strips of 48 / 16 rows and 64 / 0 rows, the
  ResDeconv's forward and backward on ragged strips, the halo units (a
  5-conv chain on a 5-row halo, the x4 tail's plain form on its
  8-row-multiple extension) and x2 bilinear and nearest upsampling.
- 4 ranks: the (data, space) and (data, model) steps of ESPCN + ResDeconv
  x2 at 32^2, batch 4 (fp32 metrics and full parameters after one step; the
  float64 gradients at the initial state), ``make_tp_infer`` of
  RDDBNet(1,1,4,nf=16,nb=1) at (1,16,16,1), the cascade pipeline (T=3,
  m=2, 8^2) and its refusal of a pipe axis of 4, and the trunk pipeline of
  RDDBNet(1,1,2,nf=16,nb=2) on a (pipe, data) mesh: inference, the float64
  ring gradients, PP x DP's, and three Adam steps.

``--cards N`` (``cards``) takes the readings on N cards, one a rank, of the
main serving cascade at full width (RDDBNet x4 nf=64 nb=3 + ResDeconv GN,
seed 1, the colorizer's last conv scaled by 0.03 as chip_smoke.py does):
the space-sharded predictor at 2, 3 and 4 ranks on one (1,2048,512,1)
gray input against one card's ``CascadePredictor``: in fp32 within 1 LSB,
in bf16 within the bf16 cascade's own rounding noise against fp32 (its mean
|diff| + 10%, its share of values beyond 1 LSB + 10% + 1 point: a sum in
another order moves a bf16 value across a rounding boundary, and the
colorizer carries it on), with ms a call (median of 3 after a warm-up) and
every rank's peak memory;
the cascade pipeline on 2 ranks and the trunk pipeline (nb=3) on 3 ranks
against the unsharded forward of 4 microbatches of (2,1,128,128): fp32
within atol 2e-5, rtol 1e-4, bf16 as uint8 within 1 LSB.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from srcgan_tpu_torch import config, models, parallel
from srcgan_tpu_torch.ops import norm
from srcgan_tpu_torch.parallel import spatial
from srcgan_tpu_torch.serving import SpatialShardedPredictor, SpatialShardedTiledPredictor
from srcgan_tpu_torch.train.cas import CasTrainer

SEEDS = {"espcn": 10, "rddb": 11, "cas_sr": 12, "cas_c": 13, "trunk": 14, "cas": 15}
SCENES = ((23, 40), (7, 33), (37, 31))
CAS_LR = 1e-4


def build(name: str, device="cpu") -> torch.nn.Module:
    """The check's model ``name``, from its seed."""
    g = torch.Generator().manual_seed(SEEDS[name])
    make = {"espcn": lambda: models.ESPCN(1, 3, 2, device=device, generator=g),
            "rddb": lambda: models.RDDBNet(1, 1, 4, nf=16, nb=1, device=device, generator=g),
            "cas_sr": lambda: models.ESPCN(1, 1, 2, device=device, generator=g),
            "cas_c": lambda: models.ResDeconv(1, 3, device=device, generator=g),
            "trunk": lambda: models.RDDBNet(1, 1, 2, nf=16, nb=2, device=device, generator=g)}
    return make[name]().eval()


def _pair_paths(directory: str):
    from srcgan_tpu_torch.train.state import checkpoint_name

    return tuple(os.path.join(directory, checkpoint_name(name, role, 2, 1))
                 for name, role in (("ESPCN", "A2C"), ("ResDeconv", "C2B")))


def _save_pair(directory: str, seed: int) -> None:
    """An ESPCN x2 + ResDeconv checkpoint pair drawn from ``seed``."""
    from srcgan_tpu_torch.interop import jax_tree_from_module
    from srcgan_tpu_torch.train.state import save_params

    g = torch.Generator().manual_seed(seed)
    nets = (models.ESPCN(1, 1, 2, device="cpu", generator=g),
            models.ResDeconv(1, 3, device="cpu", generator=g))
    for path, net in zip(_pair_paths(directory), nets):
        save_params(path, jax_tree_from_module(net)[0])


def reloaded_pair(device="cpu"):
    """The ESPCN x2 + ResDeconv pair that the 2-rank run reloads."""
    with tempfile.TemporaryDirectory() as d:
        _save_pair(d, SEEDS["cas"])
        from srcgan_tpu_torch.interop import load_params_any

        return tuple(load_params_any(m, path) for m, path in zip(
            (models.ESPCN(1, 1, 2, device=device), models.ResDeconv(1, 3, device=device)),
            _pair_paths(d)))


def cas_trainer(device) -> CasTrainer:
    return CasTrainer("ESPCN", "ResDeconv", up=2, lr=CAS_LR, device=device)


def make_problem() -> dict:
    """The inputs (NHWC, numpy) of every check."""
    rng = np.random.default_rng(0)
    tar = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    return dict(
        sp_espcn=rng.uniform(0, 1, (1, 64, 16, 1)).astype(np.float32),
        sp_rddb=rng.uniform(0, 1, (1, 32, 8, 1)).astype(np.float32),
        pred_u8=rng.integers(0, 256, (1, 64, 16, 1), dtype=np.uint8),
        norm_x=rng.normal(size=(2, 64, 16, 64)),
        realB=tar, realA=(tar @ np.array([0.2125, 0.7154, 0.0721], np.float32))[..., None],
        tp_x=rng.uniform(0, 1, (1, 16, 16, 1)).astype(np.float32),
        pipe_x=rng.uniform(0, 1, (3, 2, 8, 8, 1)).astype(np.float32),
        trunk_x=rng.uniform(0, 1, (4, 2, 8, 8, 1)).astype(np.float32),
        trunk_y=rng.uniform(0, 1, (4, 2, 16, 16, 1)).astype(np.float32),
        **{f"scene_{h}x{w}": np.random.default_rng(5).integers(0, 256, (h, w), dtype=np.uint8)
           for h, w in SCENES})


def scene_key(shape) -> str:
    return f"scene_{shape[0]}x{shape[1]}"


def nchw(a, device, dtype=None):
    t = torch.as_tensor(np.asarray(a)).to(device)
    t = t.permute(*range(t.dim() - 3), -1, -3, -2)
    return t.to(dtype or t.dtype).contiguous(memory_format=torch.channels_last) \
        if t.dim() == 4 else t.to(dtype or t.dtype)


def nhwc(t) -> np.ndarray:
    return t.detach().permute(*range(t.dim() - 3), -2, -1, -3).cpu().numpy()


# -- 2 ranks: the space axis ------------------------------------------------------

def _space(p: dict, mesh, out: dict) -> None:
    dev, main = mesh.device, mesh.is_main
    for name, key in (("espcn", "sp_espcn"), ("rddb", "sp_rddb")):
        y = parallel.make_spatial_infer(build(name, dev), mesh)(nchw(p[key], dev))
        y = spatial.gather_strips(y, mesh)
        if main:
            out[f"sp/{name}"] = nhwc(y)

    sr, c = build("cas_sr", dev), build("cas_c", dev)
    pred = SpatialShardedPredictor(sr, c, 2, mesh=mesh, device=dev)
    tiled = SpatialShardedTiledPredictor(sr, c, 2, mesh=mesh, device=dev, tile=32, overlap=8,
                                         max_batch=2)
    ens = SpatialShardedPredictor(build("cas_sr", dev), build("cas_c", dev), 2, mesh=mesh,
                                  device=dev, self_ensemble=True)
    ck = [None]
    if main:
        ck = [tempfile.mkdtemp(prefix="srcgan_axes_ck_")]
        _save_pair(ck[0], SEEDS["cas"])
    dist.broadcast_object_list(ck, 0, group=mesh.group("space"))
    if main:
        out["pred/u8"] = pred.predict(p["pred_u8"])
        pred.reload_checkpoints(*_pair_paths(ck[0]))()
        out["pred/reloaded"] = pred.predict(p["pred_u8"])
        pred.stop()
        for shape in SCENES:
            out[f"tiled/{scene_key(shape)}"] = tiled.predict_scene(p[scene_key(shape)])
            out[f"tiled/plan/{scene_key(shape)}"] = np.array(tiled.plan(shape[0]).heights)
        tiled.stop()
        out["pred/ensemble"] = ens.predict(p["pred_u8"])
        ens.stop()
    else:
        pred.follow()
        tiled.follow()
        ens.follow()
    dist.barrier(group=mesh.group("space"))
    if main:
        shutil.rmtree(ck[0], ignore_errors=True)

    # float64, against this rank's own unsharded computation
    x = nchw(p["norm_x"], dev, torch.float64)
    gn = norm.GroupNorm(32, 64).double()
    bn = norm.BatchNorm2d(64).double().train()
    torch.nn.init.normal_(gn.weight, generator=torch.Generator().manual_seed(1))
    for heights in ((48, 16), (64, 0)):
        plan = spatial.StripPlan(heights)
        for tag, layer in (("gn", gn), ("bn", bn)):
            xs = plan.cut(x, mesh.coord("space"), dim=2).detach().requires_grad_(True)
            with spatial.space_scope(mesh, plan):
                y = layer(xs)
            gx, gw = torch.autograd.grad((y * y).sum(), [xs, layer.weight])
            y, gx = spatial.gather_strips(y, mesh), spatial.gather_strips(gx, mesh)
            dist.all_reduce(gw, group=mesh.group("space"))
            if main:
                xr = x.detach().clone().requires_grad_(True)
                yr = layer(xr)
                gxr, gwr = torch.autograd.grad((yr * yr).sum(), [xr, layer.weight])
                out[f"norm/{tag}/{heights[0]}_{heights[1]}"] = np.array([
                    float((y - yr).abs().max()), float((gx - gxr).abs().max()),
                    float((gw - gwr).abs().max())])

    res = build("cas_c", dev).double().train()
    xr = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 1, 46, 32))).to(dev)
    plan = spatial.plan_strips(46, mesh.size("space"), *spatial.geometry(res))
    xs = plan.cut(xr, mesh.coord("space"), dim=2).requires_grad_(True)
    with spatial.space_scope(mesh, plan):
        y = res(xs)
    gs = torch.autograd.grad((y * y).sum(), [xs] + list(res.parameters()))
    y, gx = spatial.gather_strips(y, mesh), spatial.gather_strips(gs[0], mesh)
    gp = torch.cat([g.reshape(-1) for g in gs[1:]])
    dist.all_reduce(gp, group=mesh.group("space"))
    if main:
        xf = xr.clone().requires_grad_(True)
        yf = res(xf)
        gf = torch.autograd.grad((yf * yf).sum(), [xf] + list(res.parameters()))
        gpf = torch.cat([g.reshape(-1) for g in gf[1:]])
        out["ragged/resdeconv"] = np.array([
            float((y - yf).abs().max() / yf.abs().max()),
            float((gx - gf[0]).abs().max() / gf[0].abs().max()),
            float((gp - gpf).norm() / gpf.norm()), y.shape[2], yf.shape[2]])

    out.update(_units(mesh, dev))


def _units(mesh, dev) -> dict:
    """The halo units of the fused paths, their plain forms on float64."""
    import torch.nn.functional as F

    from srcgan_tpu_torch.ops import fused
    from srcgan_tpu_torch.ops.conv import to_nhwc

    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(8, 8, 3, 3, generator=g, dtype=torch.float64).to(dev) * 0.2
          for _ in range(5)]

    def chain(v):
        for w in ws:
            v = F.conv2d(v, w, None, 1, 1)
        return v

    m = models.RDDBNet(1, 1, 4, nf=8, nb=1, device=dev, generator=g).double()
    dws = [d.weight.permute(2, 3, 0, 1) for d in list(m.upscale_layers)[::2]]
    lw = m.conv_last.weight.permute(2, 3, 1, 0)

    def tail(t):
        return fused.phasefold_deconv_tail(t, dws, lw, None)

    x = torch.randn(2, 8, 44, 8, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64).to(dev)
    plan = spatial.plan_strips(44, mesh.size("space"), 1, 8)
    xs = plan.cut(x, mesh.coord("space"), dim=2)
    def ups(v):
        return [F.interpolate(v, scale_factor=2, mode=m) for m in ("bilinear", "nearest")]

    with torch.no_grad(), spatial.space_scope(mesh, plan) as sc:
        y = sc.halo_unit(xs, 5, 5, chain, symmetric=True)
        z = sc.halo_unit(to_nhwc(xs).contiguous(), *sc.tail_rows(xs.shape[2]), tail,
                         out_scale=4, nhwc=True)
        u = ups(xs)
    y, z = spatial.gather_strips(y, mesh), spatial.gather_strips(z, mesh, dim=1)
    u = [spatial.gather_strips(v, mesh) for v in u]
    if not mesh.is_main:
        return {}
    with torch.no_grad():
        return {"units": np.array([float((y - chain(x)).abs().max()),
                                   float((z - tail(to_nhwc(x).contiguous())).abs().max())]
                                  + [float((a - b).abs().max()) for a, b in zip(u, ups(x))])}


# -- 4 ranks: the 2-D steps, tensor and pipeline parallelism ---------------------

def _full_params(model, mesh=None, axis="model") -> dict:
    """Every parameter whole (a tensor-parallel slice gathered over ``axis``)."""
    out = {}
    split = parallel.tp_param_shardings(model, mesh, axis) if mesh is not None else {}
    for name, p in model.named_parameters():
        t = p.detach()
        if split.get(name) is not None and getattr(_owner(model, name), "_tp_split", False):
            parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
            dist.all_gather(parts, t.contiguous(), group=mesh.group(axis))
            t = torch.cat(parts, split[name])
        out[name] = t.cpu().numpy()
    return out


def _owner(model, name):
    return model.get_submodule(name.rpartition(".")[0])


def _step_run(tag, make_step, p, mesh, out, shard_axis=None):
    dev = mesh.device
    tr = cas_trainer(dev)
    realA, realB = parallel.put_batch((p["realA"], p["realB"]), mesh)
    state = parallel.put_replicated(tr.init(SEEDS["cas"]), mesh)
    step = make_step(tr, mesh)
    state, m = step(state, realA, realB, CAS_LR)
    for role, ts in zip(("sr", "c"), state):
        full = _full_params(ts.model, mesh if shard_axis else None)
        held = sum(t.numel() for t in ts.model.parameters())
        if mesh.is_main:
            out.update({f"{tag}/{role}/{k}": v for k, v in full.items()})
            out[f"{tag}/held/{role}"] = np.array([held, sum(v.size for v in full.values())])
    if mesh.is_main:
        out.update({f"{tag}/metric/{k}": v.detach().cpu().numpy() for k, v in m.items()})
    state = tr.init(SEEDS["cas"])
    for ts in state:
        ts.model.double()
    g = make_step(tr, mesh).grads(state, torch.as_tensor(realA).double(),
                                  torch.as_tensor(realB).double())
    for role, ts in zip(("sr", "c"), state):
        split = (parallel.tp_param_shardings(ts.model, mesh, shard_axis)
                 if shard_axis else {})
        for k, v in g[role].items():
            if split.get(k) is not None:
                parts = [torch.empty_like(v) for _ in range(mesh.size(shard_axis))]
                dist.all_gather(parts, v.contiguous(), group=mesh.group(shard_axis))
                v = torch.cat(parts, split[k])
            if mesh.is_main:
                out[f"{tag}/g64/{role}/{k}"] = v.cpu().numpy()


def _axes(p: dict, out: dict, device) -> None:
    m2d = parallel.make_mesh((2, 2), ("data", "space"), device=device)
    dev, main = m2d.device, m2d.is_main
    _step_run("2d", parallel.make_cas_2d_step, p, m2d, out)
    mtp = parallel.make_mesh((2, 2), ("data", "model"), device=dev)
    _step_run("tp", parallel.make_cas_tp_step, p, mtp, out, shard_axis="model")
    y = parallel.make_tp_infer(build("rddb", dev), mtp)(nchw(p["tp_x"], dev))
    if main:
        out["tp/infer"] = nhwc(y)

    mpp = parallel.make_mesh((2, 2), ("pipe", "data"), device=dev)
    sr, c = build("cas_sr", dev), build("cas_c", dev)
    y = parallel.make_cascade_pipeline_infer(sr, c, mpp)(nchw(p["pipe_x"], dev))
    try:
        parallel.make_cascade_pipeline_infer(sr, c, parallel.make_mesh((4,), ("pipe",),
                                                                       device=dev))
        refused = ""
    except ValueError as e:
        refused = str(e)
    if main:
        out["pipe/cascade"] = nhwc(y)
        out["pipe/refused"] = np.array(refused)

    trunk = build("trunk", dev)
    y = parallel.make_rddb_trunk_pipeline_infer(trunk, mpp)(
        parallel.place_trunk_pipeline_params(trunk, mpp), nchw(p["trunk_x"], dev))
    if main:
        out["trunk/infer"] = nhwc(y)
    xq = nchw(p["trunk_x"], dev, torch.float64)
    yq = nchw(p["trunk_y"], dev, torch.float64)
    for tag, data_axis in (("trunk", None), ("trunk_dp", "data")):
        model = build("trunk", dev).double()
        init_opt, step, grads = parallel.make_trunk_pipeline_train(model, mpp, data_axis=data_axis)
        pair = parallel.place_trunk_pipeline_params(model, mpp)
        loss, g_ht, g_st = grads(pair, xq, yq)
        for k, v in g_st.items():                 # stage s's RRDB -> trunk.RRDB_trunk.s
            parts = [torch.empty_like(v) for _ in range(2)]
            dist.all_gather(parts, v.contiguous(), group=mpp.group("pipe"))
            if main:
                for s, part in enumerate(parts):
                    out[f"{tag}/g/RRDB_trunk.{s}.{k}"] = part.cpu().numpy()
        if main:
            out[f"{tag}/loss"] = loss.cpu().numpy()
            out.update({f"{tag}/g/{k}": v.cpu().numpy() for k, v in g_ht.items()})
        if data_axis is None:
            opt = init_opt(pair)
            losses = [float(step(pair, opt, xq, yq, 1e-3)[2]) for _ in range(3)]
            if main:
                out["trunk/adam_losses"] = np.array(losses)


# -- the readings on cards -----------------------------------------------------

CARD_SCENE = (1, 2048, 512, 1)
CARD_QUEUE = (4, 2, 1, 128, 128)


def serving_cascade(device):
    """The main serving cascade at full width, from seed 1."""
    g = torch.Generator().manual_seed(1)
    sr = models.RDDBNet(1, 1, 4, device=device, generator=g)
    c = models.ResDeconv(1, 3, device=device, generator=g)
    with torch.no_grad():
        c.pred.weight.mul_(0.03)
    return sr.eval(), c.eval()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _ms(fn, dev, reps: int = 3) -> float:
    import time

    fn()
    ts = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def _peak_reset(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)      # the context first: a fresh process has none
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> float:
    return float(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0.0


def _u8(y: torch.Tensor) -> np.ndarray:
    return torch.round(y.float().clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()


def _collective_share(fn) -> tuple:
    """(device ms of NCCL kernels, device ms of all kernels) over one call of
    ``fn`` on this rank (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    nccl = sum(e.self_device_time_total for e in events if "nccl" in e.key.lower()) / 1e3
    return nccl, total


def card_worker(argv) -> None:
    """One rank of ``cards``: the sharded predictor in fp32 and bf16, and on
    2 or 3 ranks the pipelines; rank 0 writes what it read."""
    tmp, device, scene, queue = argv
    world = int(os.environ["WORLD_SIZE"])
    mesh = parallel.make_mesh((world,), ("space",), device=device)
    dev = mesh.device
    out = {}
    x = np.random.default_rng(7).integers(0, 256, scene, dtype=np.uint8)
    for mode in ("fp32", "bf16"):
        _peak_reset(dev)
        pred = SpatialShardedPredictor(*serving_cascade(dev), 4, bf16=mode == "bf16",
                                       mesh=mesh, device=dev)
        if mesh.is_main:
            out[f"pred_{mode}"] = pred.predict(x)
            out[f"ms_{mode}"] = np.array(_ms(lambda: pred.predict(x), dev))
            if dev.type == "cuda":
                out[f"nccl_{mode}"] = np.array(_collective_share(lambda: pred.predict(x)))
            pred.stop()
        else:
            pred.follow()
        peak = torch.tensor([_peak(dev)], device=dev)
        peaks = [torch.zeros_like(peak) for _ in range(world)]
        dist.all_gather(peaks, peak)
        out[f"peak_{mode}"] = torch.cat(peaks).cpu().numpy()
        del pred
    if world in (2, 3):
        q = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, queue)
                             .astype(np.float32)).to(dev)
        pipe = parallel.make_mesh((world,), ("pipe",), device=dev)
        for mode in ("fp32", "bf16"):
            dt = torch.bfloat16 if mode == "bf16" else torch.float32
            sr, c = serving_cascade(dev)
            sr, c = sr.to(dt), c.to(dt)
            with config.precision(mode), torch.no_grad():
                if world == 2:
                    got = parallel.make_cascade_pipeline_infer(sr, c, pipe)(q.to(dt))
                    want = torch.stack([c(sr(v.to(dt))) for v in q]) if mesh.is_main else None
                else:
                    sr3 = models.RDDBNet(1, 1, 4, nb=3, device=dev,
                                         generator=torch.Generator().manual_seed(2)).eval().to(dt)
                    got = parallel.make_rddb_trunk_pipeline_infer(sr3, pipe)(
                        parallel.place_trunk_pipeline_params(sr3, pipe), q.to(dt))
                    want = torch.stack([sr3(v.to(dt)) for v in q]) if mesh.is_main else None
            if mesh.is_main:
                out[f"pipe_{mode}"] = got.float().cpu().numpy()
                out[f"pipe_{mode}_ref"] = want.float().cpu().numpy()
    if mesh.is_main:
        np.savez(os.path.join(tmp, f"world{world}.npz"), **out)


def cards(n: int, device: str = "cuda") -> list:
    """The readings on ``n`` cards (see the module docstring): [(what, value,
    bound or None)], printed as they come.  ``device="cpu"`` rehearses the
    runs on gloo ranks (its times and memory are not the card's)."""
    from srcgan_tpu_torch.serving import CascadePredictor

    rows = []

    def row(what, value, bound=None):
        rows.append((what, value, bound))
        verdict = "" if bound is None else (" PASS" if value <= bound else " FAIL")
        print(f"[axes-cards] {what}: {value:.6g}" + ("" if bound is None else
                                                      f" (bound {bound:g})") + verdict,
              flush=True)

    dev = torch.device("cuda:0" if device == "cuda" else device)
    x = np.random.default_rng(7).integers(0, 256, CARD_SCENE, dtype=np.uint8)
    ref = {}
    for mode in ("fp32", "bf16"):
        _peak_reset(dev)
        one = CascadePredictor(*serving_cascade(dev), 4, bf16=mode == "bf16", device=dev)
        ref[mode] = one.predict(x).astype(int)
        row(f"1 card: CascadePredictor {mode} {CARD_SCENE} ms", _ms(lambda: one.predict(x), dev))
        row(f"1 card: {mode} peak memory GiB", _peak(dev) / 2 ** 30)
        del one
    noise = np.abs(ref["bf16"] - ref["fp32"])
    row("1 card: the bf16 cascade's own noise against fp32, mean |diff| LSB", noise.mean())
    row("1 card: ... its share of values beyond 1 LSB", (noise > 1).mean())
    tmp = tempfile.mkdtemp(prefix="srcgan_axes_cards_")
    try:
        for world in sorted({w for w in (2, 3, 4) if w <= n}):
            parallel.launch("srcgan_tpu_torch.parallel.axes_check:card_worker",
                            [tmp, device, CARD_SCENE, CARD_QUEUE], world, device=device)
            with np.load(os.path.join(tmp, f"world{world}.npz")) as z:
                got = {k: z[k] for k in z.files}
            row(f"{world} cards: SpatialShardedPredictor fp32 vs 1 card, max |diff| LSB",
                float(np.abs(got["pred_fp32"].astype(int) - ref["fp32"]).max()), 1)
            d = np.abs(got["pred_bf16"].astype(int) - ref["fp32"])
            row(f"{world} cards: SpatialShardedPredictor bf16 vs the fp32 card, mean |diff| LSB",
                d.mean(), 1.1 * noise.mean())
            row(f"{world} cards: ... its share of values beyond 1 LSB", (d > 1).mean(),
                1.1 * (noise > 1).mean() + 0.01)
            row(f"{world} cards: ... bf16 vs the bf16 card, max |diff| LSB",
                float(np.abs(got["pred_bf16"].astype(int) - ref["bf16"]).max()))
            for mode in ("fp32", "bf16"):
                row(f"{world} cards: SpatialShardedPredictor {mode} ms", float(got[f"ms_{mode}"]))
                if f"nccl_{mode}" in got:
                    nccl, total = got[f"nccl_{mode}"]
                    row(f"{world} cards: {mode} rank 0 device ms in NCCL kernels / in all "
                        f"kernels, one call (profiler): {nccl:.3f} /", total)
                for r, peak in enumerate(got[f"peak_{mode}"]):
                    row(f"{world} cards: {mode} rank {r} peak memory GiB", float(peak) / 2 ** 30)
            name = {2: "cascade pipeline", 3: "trunk pipeline (nb=3)"}.get(world)
            if name:
                a, b = got["pipe_fp32"], got["pipe_fp32_ref"]
                row(f"{world} cards: {name} fp32 vs unsharded, max |diff| - 1e-4 |ref|",
                    float(np.max(np.abs(a - b) - 1e-4 * np.abs(b))), 2e-5)
                row(f"{world} cards: {name} bf16 vs unsharded, max |diff| uint8",
                    float(np.abs(_u8(torch.from_numpy(got["pipe_bf16"])).astype(int)
                                 - _u8(torch.from_numpy(got["pipe_bf16_ref"])).astype(int))
                          .max()), 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def run_ranks(problem: dict, ranks: int, device: str = "cuda") -> dict:
    """``main`` on ``ranks`` ranks (``parallel.launch``); rank 0's results."""
    tmp = tempfile.mkdtemp(prefix="srcgan_axes_check_")
    try:
        np.savez(os.path.join(tmp, "problem.npz"), **problem)
        parallel.launch("srcgan_tpu_torch.parallel.axes_check:main",
                        [os.path.join(tmp, "problem.npz"), os.path.join(tmp, "results.npz"),
                         device], ranks, device=device)
        with np.load(os.path.join(tmp, "results.npz")) as raw:
            return {k: raw[k] for k in raw.files}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv) -> None:
    problem, results, device = argv
    with np.load(problem) as raw:
        p = {k: raw[k] for k in raw.files}
    world = int(os.environ.get("WORLD_SIZE", 1))
    out: dict = {}
    with config.precision("fp32"):
        if world == 2:
            _space(p, parallel.make_mesh((2,), ("space",), device=device), out)
        elif world == 4:
            _axes(p, out, device)
        else:
            raise SystemExit(f"axes_check runs on 2 or 4 ranks, not {world}")
    if int(os.environ.get("RANK", 0)) == 0:
        np.savez(results, **out)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the space, model and pipe axes on N ranks")
    ap.add_argument("--ranks", type=int, default=2, choices=(2, 4))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cards", type=int, default=0,
                    help="take the readings on this many cards instead")
    args = ap.parse_args(argv)
    if args.cards:
        rows = cards(args.cards)
        return 0 if all(b is None or v <= b for _, v, b in rows) else 1
    got = run_ranks(make_problem(), args.ranks, args.device)
    for k in sorted(got):
        if got[k].size <= 8:
            print(f"[axes_check] {args.ranks} ranks ({args.device}) {k}: {got[k].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(cli())
