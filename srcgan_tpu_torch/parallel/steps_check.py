"""Every step of the data axis, once, on a stated problem, on N ranks; and
the same steps in one process on the whole batch, to hold them together.

    python -m srcgan_tpu_torch.parallel.steps_check --ranks 4             # N cards, NCCL
    python -m srcgan_tpu_torch.parallel.steps_check --ranks 2 --device cpu    # gloo

The problem (``make_problem``): the seeds, the learning rates, the global
batches (``realA``/``realB`` float for the cascade, ``src_k``/``tar_k``
uint8 (K, N, H, W, 3) blocks, ``ganA``/``ganB`` float for the CycleGAN,
N = 2 a rank) and the pool size.  Each rank (``main``, through
``parallel.launch``) builds the same fresh states from the seeds (a
CasTrainer of ESPCN + SRCNN, a CycleGANTrainer of the SRDenseNet pair,
remat off), takes its shard of every batch and runs, in fp32 with TF32
off: the cascade's DP step, its DP uint8 steps (K of them), its ZeRO-1 and
FSDP steps; one CycleGAN iteration through ``make_gan_dp_iteration``
(BatchNorm on the global batch, the host pools on the gathered fakes); one
``make_gd_zero1_step``; and a ``train.orbax_io`` round trip of the ZeRO-1
and FSDP states with ``max_to_keep=2``.  Rank 0 writes each run's full
parameters after the step (``<run>/<net>/<name>``), its metrics
(``<run>/metric/<key>``), the D BatchNorm statistics, the pooled and
gathered fakes, and the round trip's checks.  ``one_process`` computes
what they must equal on the whole batch (the plain steps, the GAN's
``optimize_parameters`` and ``gd_step``), and ``compare`` holds the two:
the losses within rtol 1e-5 (the GAN's 1e-4), each tensor's update within
rel-L2 5e-2 (Adam's first update amplifies a near-zero gradient's
reduction-order noise to +-lr), each D BatchNorm statistic within rel-L2
1e-5.  ``compare_grads`` adds the gradients that decide whether an update's
disagreement is that amplification or a wrong gradient: the cascade DP
step's averaged gradients, per tensor, within rel-L2 1e-4 of one process's.
The tests hold the ranks' results against the JAX package's 2-device mesh
too (tests/test_torch_parallel.py).

``--axes`` (an even number of ranks) adds the other axes on the same
cascade problem and ``compare_axes`` their rows: the (data, space) step on
N/2 x 2 ranks and the (data, model) step on N/2 x 2 (losses rtol 1e-5,
updates rel-L2 5e-2, gradients 1e-4 against one process), and the trunk
pipeline of an RDDBNet(1,1,2,nf=16,nb=2) on a (pipe 2, data N/2) mesh (its
loss rtol 1e-5 and gradients 1e-4 against the unsharded model's).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from srcgan_tpu_torch import config, parallel
from srcgan_tpu_torch.parallel.dp import average_
from srcgan_tpu_torch.train.cas import CasTrainer
from srcgan_tpu_torch.train.cyclegan import CycleGANTrainer
from srcgan_tpu_torch.train.orbax_io import OrbaxCheckpointer

LR, G_LR, D_LR, POOL = 1e-3, 1e-3, 1e-3, 2
CAS_SEED, GAN_SEED = 3, 4
HW, K, GAN_HW, PER_RANK = 16, 2, 32, 2
RUNS = ("dp", "dp_u8", "zero1", "fsdp", "gan_dp", "gan_zero1")
AXES_RUNS = ("2d", "tp")
TRUNK_SEED, TRUNK_T = 6, 2


def cas_trainer(lr: float, device) -> CasTrainer:
    return CasTrainer("ESPCN", "SRCNN", up=2, lr=lr, device=device)


def gan_trainer(pool_size: int, device) -> CycleGANTrainer:
    return CycleGANTrainer(net="SRdens", mode="x2", pool_size=pool_size, remat=False,
                           device=device)


def _params(state, prefix: str, out: dict) -> None:
    full = parallel.fsdp_full_params(state)
    for role, named in full.items():
        for name, p in named.items():
            out[f"{prefix}/{role}/{name}"] = p.detach().cpu().numpy()


def _metrics(metrics: dict, prefix: str, out: dict) -> None:
    for k, v in metrics.items():
        if v.dim() <= 1:
            out[f"{prefix}/metric/{k}"] = v.detach().cpu().numpy()


def make_problem(ranks: int) -> dict:
    """The stated problem for ``ranks`` ranks, from numpy seed 0."""
    n = PER_RANK * ranks
    rng = np.random.default_rng(0)
    tar = rng.uniform(0, 1, (n, HW, HW, 3)).astype(np.float32)
    gan_b = rng.uniform(0, 1, (n, GAN_HW, GAN_HW, 3)).astype(np.float32)
    return dict(
        lr=LR, g_lr=G_LR, d_lr=D_LR, pool_size=POOL, cas_seed=CAS_SEED, gan_seed=GAN_SEED,
        realA=np.zeros((n, HW, HW, 1), np.float32), realB=tar,
        src_k=rng.integers(0, 256, (K, n, HW, HW, 3), dtype=np.uint8),
        tar_k=rng.integers(0, 256, (K, n, HW, HW, 3), dtype=np.uint8),
        ganA=rng.uniform(0, 1, (n, GAN_HW // 2, GAN_HW // 2, 1)).astype(np.float32),
        ganB=gan_b,
        trunk_x=rng.uniform(0, 1, (TRUNK_T, n, 1, 8, 8)).astype(np.float32),
        trunk_y=rng.uniform(0, 1, (TRUNK_T, n, 1, 16, 16)).astype(np.float32))


def trunk_model(device):
    from srcgan_tpu_torch import models

    return models.RDDBNet(1, 1, 2, nf=16, nb=2, device=device,
                          generator=torch.Generator().manual_seed(TRUNK_SEED)).train()


def _grads(grads: dict, prefix: str, out: dict) -> None:
    for role, named in grads.items():
        for name, g in named.items():
            out[f"{prefix}/grad/{role}/{name}"] = g.detach().cpu().numpy()


def run_ranks(problem: dict, ranks: int, device: str = "cuda", axes: bool = False) -> dict:
    """``main`` on ``ranks`` ranks (``parallel.launch``); rank 0's results."""
    tmp = tempfile.mkdtemp(prefix="srcgan_steps_check_")
    try:
        np.savez(os.path.join(tmp, "problem.npz"), **problem)
        parallel.launch("srcgan_tpu_torch.parallel.steps_check:main",
                        [os.path.join(tmp, "problem.npz"), os.path.join(tmp, "results.npz"),
                         device] + (["axes"] if axes else []), ranks, device=device)
        with np.load(os.path.join(tmp, "results.npz")) as raw:
            return {k: raw[k] for k in raw.files}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def one_process(problem: dict, device: str = "cuda") -> dict:
    """The plain steps on the whole batch in this process, keyed as the ranks'
    results: the cascade's train_step (the reference of dp, zero1 and fsdp)
    and train_steps_u8, the CycleGAN's optimize_parameters through its pool
    and its gd_step (pool size 0), in fp32 with TF32 off."""
    p = {k: torch.as_tensor(v) for k, v in problem.items()}
    out: dict = {}
    with config.precision("fp32"):
        tr = cas_trainer(LR, device)
        g, _, _ = tr.grads(tr.init(CAS_SEED), tr._tensor(p["realA"]), tr._tensor(p["realB"]))
        for run in ("dp",) + AXES_RUNS:
            _grads(g, run, out)
        state, m = tr.train_step(tr.init(CAS_SEED), p["realA"], p["realB"], LR)
        for run in ("dp", "zero1", "fsdp") + AXES_RUNS:
            _params(state, run, out)
            _metrics(m, run, out)
        model = trunk_model(device)
        xq, yq = (p[k].to(device) for k in ("trunk_x", "trunk_y"))
        loss = (model(xq.flatten(0, 1)) - yq.flatten(0, 1)).abs().mean()
        names, params = zip(*model.named_parameters())
        out["pipe/loss"] = loss.detach().cpu().numpy()
        for name, gt in zip(names, torch.autograd.grad(loss, params)):
            out[f"pipe/grad/net/{name}"] = gt.cpu().numpy()
        state, m = tr.train_steps_u8(tr.init(CAS_SEED), p["src_k"], p["tar_k"], LR)
        _params(state, "dp_u8", out)
        _metrics(m, "dp_u8", out)
        for run, pool in (("gan_dp", POOL), ("gan_zero1", 0)):
            gtr = gan_trainer(pool, device)
            gstate = gtr.init(GAN_SEED)
            step = gtr.optimize_parameters if pool else gtr.gd_step
            gstate, aux = step(gstate, p["ganA"], p["ganB"], G_LR, D_LR)
            _params(gstate, run, out)
            _metrics(aux, run, out)
            for name, b in gstate.d.model.named_buffers():
                out[f"{run}/d_state/{name}"] = b.cpu().numpy()
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def compare_grads(ranks: dict, ref: dict, runs=("dp",), bound: float = 1e-4) -> list:
    """[(what, error, bound)]: per run, the largest per-tensor rel-L2 of the
    ranks' gradients against one process's."""
    rows = []
    for run in runs:
        keys = [k for k in ref if k.startswith(f"{run}/grad/")]
        if not keys or any(k not in ranks for k in keys):
            rows.append((f"{run} gradients (missing)", float("inf"), bound))
            continue
        rows.append((f"{run} gradients", max(_rel(ranks[k], ref[k]) for k in keys), bound))
    return rows


def compare_axes(ranks: dict, ref: dict) -> list:
    """The rows of ``--axes``: losses, updates and gradients of the (data,
    space) and (data, model) steps, the trunk pipeline's loss and gradients."""
    rows = []
    for run in AXES_RUNS:
        err = max(float(np.abs(ranks[f"{run}/metric/{k}"] - ref[f"{run}/metric/{k}"])
                        / np.abs(ref[f"{run}/metric/{k}"])) for k in ("loss_SR", "loss_C"))
        rows.append((f"{run} losses", err, 1e-5))
        start = _before(run)
        rows.append((f"{run} updates", max(_rel(ranks[k] - p0, ref[k] - p0)
                                           for k, p0 in start.items()), 5e-2))
    rows += compare_grads(ranks, ref, AXES_RUNS + ("pipe",))
    rows.append(("pipe loss", float(abs(ranks["pipe/loss"] - ref["pipe/loss"])
                                    / abs(ref["pipe/loss"])), 1e-5))
    return rows


def _before(run: str) -> dict:
    """The fresh parameters a run starts from, by its result keys."""
    out: dict = {}
    state = (gan_trainer(0, "cpu").init(GAN_SEED) if run.startswith("gan")
             else cas_trainer(LR, "cpu").init(CAS_SEED))
    _params(state, run, out)
    return out


def compare(ranks: dict, ref: dict) -> list:
    """[(what, error, bound)] of the ranks' results against one process's:
    the losses (rtol), the largest per-tensor update rel-L2, the largest D
    BatchNorm statistic's rel-L2."""
    rows = []
    for run in RUNS:
        loss_keys = (("loss_G", "loss_D_A", "loss_D_B") if run.startswith("gan")
                     else ("loss_SR", "loss_C"))
        rtol = 1e-4 if run.startswith("gan") else 1e-5
        err = max(float(np.max(np.abs(ranks[f"{run}/metric/{k}"] - ref[f"{run}/metric/{k}"])
                               / np.abs(ref[f"{run}/metric/{k}"]))) for k in loss_keys)
        rows.append((f"{run} losses", err, rtol))
        start = _before(run)
        worst = 0.0
        for key, p0 in start.items():
            want = ref[key] - p0
            worst = max(worst, float(np.linalg.norm(ranks[key] - p0 - want)
                                     / (np.linalg.norm(want) + 1e-30)))
        rows.append((f"{run} updates", worst, 5e-2))
        stats = [k for k in ref if k.startswith(f"{run}/d_state/")
                 and not k.endswith("num_batches_tracked")]
        if stats:
            rows.append((f"{run} BatchNorm statistics", max(
                float(np.linalg.norm(ranks[k] - ref[k]) / np.linalg.norm(ref[k]))
                for k in stats), 1e-5))
    return rows


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the data axis on N ranks against one process")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--axes", action="store_true",
                    help="also the (data, space), (data, model) and pipeline runs")
    args = ap.parse_args(argv)
    problem = make_problem(args.ranks)
    got = run_ranks(problem, args.ranks, args.device, args.axes)
    ref = one_process(problem, args.device)
    rows = compare(got, ref) + compare_grads(got, ref)
    if args.axes:
        rows += compare_axes(got, ref)
    rows.append(("step directories: keep-last and bit-equal round trips",
                 0.0 if (got["orbax/steps"].tolist() == [2, 3] and got["orbax/zero1_equal"].all()
                         and got["orbax/fsdp_equal"].all()) else 1.0, 0.0))
    ok = True
    for what, err, bound in rows:
        ok &= err <= bound
        print(f"[steps_check] {args.ranks} ranks ({args.device}) against one process: {what} "
              f"{err:.3e} (bound {bound:g}) {'PASS' if err <= bound else 'FAIL'}")
    return 0 if ok else 1


def main(argv) -> None:
    problem, results, device = argv[:3]
    with np.load(problem) as raw:
        p = {k: raw[k] for k in raw.files}
    mesh = parallel.make_mesh(device=device)
    with config.precision("fp32"):
        out = _run(p, mesh)
        if argv[3:] == ["axes"]:
            out.update(_run_axes(p, mesh))
    if mesh.is_main:
        np.savez(results, **out)


def _run_axes(p: dict, world) -> dict:
    """The (data, space), (data, model) and trunk pipeline runs."""
    n = world.size
    if n % 2:
        raise SystemExit("--axes needs an even number of ranks")
    dev, out = world.device, {}
    lr, seed = float(p["lr"]), int(p["cas_seed"])
    tr = cas_trainer(lr, dev)
    for run, axes, make in (("2d", ("data", "space"), parallel.make_cas_2d_step),
                            ("tp", ("data", "model"), parallel.make_cas_tp_step)):
        mesh = parallel.make_mesh((n // 2, 2), axes, device=dev)
        realA, realB = parallel.put_batch((p["realA"], p["realB"]), mesh)
        step = make(tr, mesh)
        state = parallel.put_replicated(tr.init(seed), mesh)
        g = step.grads(state, realA, realB)
        state = parallel.put_replicated(tr.init(seed), mesh)
        state, m = step(state, realA, realB, lr)
        if run == "tp":      # the slices, whole again
            from srcgan_tpu_torch.parallel import tp as tp_lib

            g = {role: _whole(g[role], tp_lib.tp_param_shardings(ts.model, mesh), mesh)
                 for role, ts in zip(("sr", "c"), state)}
            full = {role: _whole(dict(ts.model.named_parameters()),
                                 tp_lib.tp_param_shardings(ts.model, mesh), mesh)
                    for role, ts in zip(("sr", "c"), state)}
            for role, named in full.items():
                for name, t in named.items():
                    out[f"tp/{role}/{name}"] = t.detach().cpu().numpy()
        else:
            _params(state, run, out)
        _grads(g, run, out)
        _metrics(m, run, out)

    mesh = parallel.make_mesh((2, n // 2), ("pipe", "data"), device=dev)
    model = trunk_model(dev)
    _, _, grads = parallel.make_trunk_pipeline_train(model, mesh, data_axis="data")
    pair = parallel.place_trunk_pipeline_params(model, mesh)
    xq, yq = (torch.as_tensor(p[k]).to(dev) for k in ("trunk_x", "trunk_y"))
    loss, g_ht, g_st = grads(pair, xq, yq)
    out["pipe/loss"] = loss.detach().cpu().numpy()
    for name, g in g_ht.items():
        out[f"pipe/grad/net/{name}"] = g.cpu().numpy()
    for name, g in g_st.items():
        parts = [torch.empty_like(g) for _ in range(2)]
        torch.distributed.all_gather(parts, g.contiguous(), group=mesh.group("pipe"))
        for s, part in enumerate(parts):
            out[f"pipe/grad/net/RRDB_trunk.{s}.{name}"] = part.cpu().numpy()
    return out


def _whole(named: dict, dims: dict, mesh) -> dict:
    """Tensor-parallel slices gathered whole over ``model``, by name."""
    out = {}
    for name, t in named.items():
        t = t.detach()
        if dims.get(name) is not None:
            parts = [torch.empty_like(t) for _ in range(mesh.size("model"))]
            torch.distributed.all_gather(parts, t.contiguous(), group=mesh.group("model"))
            t = torch.cat(parts, dims[name])
        out[name] = t
    return out


def _run(p: dict, mesh) -> dict:
    dev = mesh.device
    out: dict = {}
    lr = float(p["lr"])
    tr = cas_trainer(lr, dev)
    seed = int(p["cas_seed"])
    realA, realB = parallel.put_batch((p["realA"], p["realB"]), mesh)

    g, _, _ = tr.grads(tr.init(seed), realA, realB)
    average_([t for named in g.values() for t in named.values()], mesh.group("data"))
    _grads(g, "dp", out)
    state = parallel.put_replicated(tr.init(seed), mesh)
    state, m = parallel.make_cas_dp_step(tr, mesh)(state, realA, realB, lr)
    _params(state, "dp", out)
    _metrics(m, "dp", out)

    src_k, tar_k = parallel.put_batch((p["src_k"], p["tar_k"]), mesh, batch_dim=1)
    state = parallel.put_replicated(tr.init(seed), mesh)
    state, m = parallel.make_cas_dp_steps_u8(tr, mesh)(state, src_k, tar_k, lr)
    _params(state, "dp_u8", out)
    _metrics(m, "dp_u8", out)

    zstate = parallel.zero1_init(tr, seed, mesh)
    zstate, m = parallel.make_cas_zero1_step(tr, mesh)(zstate, realA, realB, lr)
    _params(zstate, "zero1", out)
    _metrics(m, "zero1", out)
    out["zero1/rows"] = np.array([zstate.sr.opt.rows.numel()])
    out["zero1/opt_bytes"] = np.array([parallel.zero1_opt_bytes_per_device(
        tr.init(seed).sr.model, mesh)])

    fstate, _ = parallel.fsdp_init(tr, seed, mesh)
    fstate, m = parallel.make_cas_fsdp_step(tr, mesh)(fstate, realA, realB, lr)
    _params(fstate, "fsdp", out)
    _metrics(m, "fsdp", out)
    out["fsdp/held"] = np.array([sum(t.numel() for t in fstate.sr.model.parameters())])

    # the step directories: a sharded state saved three times, two kept,
    # restored into fresh states of the same layouts
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ck") if mesh.is_main else None
        roots = [root]
        torch.distributed.broadcast_object_list(roots, 0)
        ck = OrbaxCheckpointer(os.path.join(roots[0], "zero1"), max_to_keep=2)
        for step in (1, 2, 3):
            ck.save(step, zstate, {"epoch": step})
        out["orbax/steps"] = np.array(ck.all_steps())
        like, extra = ck.restore(parallel.zero1_init(tr, seed + 1, mesh))
        same = [torch.equal(a.opt.rows, b.opt.rows)
                and all(torch.equal(x, y) for x, y in zip(a.opt.moments()[:2],
                                                           b.opt.moments()[:2]))
                and a.opt.moments()[2] == b.opt.moments()[2] and a.step == b.step
                for a, b in zip(zstate, like)]
        out["orbax/zero1_equal"] = np.array([all(same), extra["epoch"] == 3])
        fck = OrbaxCheckpointer(os.path.join(roots[0], "fsdp"))
        fck.save(1, fstate, {})
        like, _ = fck.restore(parallel.fsdp_init(tr, seed + 1, mesh)[0])
        a, b = parallel.fsdp_full_params(fstate), parallel.fsdp_full_params(like)
        out["orbax/fsdp_equal"] = np.array([all(torch.equal(a[r][n], b[r][n])
                                                for r in a for n in a[r])])

    gseed, g_lr, d_lr = int(p["gan_seed"]), float(p["g_lr"]), float(p["d_lr"])
    ganA, ganB = parallel.put_batch((p["ganA"], p["ganB"]), mesh)
    gtr = gan_trainer(int(p["pool_size"]), dev)
    gstate = parallel.put_replicated(gtr.init(gseed), mesh)
    iteration = parallel.make_gan_dp_iteration(gtr, mesh)
    pools = []
    query = gtr.fake_A_pool.query

    def record(images):
        pooled = query(images)
        pools.append((images.detach().cpu().numpy(), pooled.detach().cpu().numpy()))
        return pooled

    gtr.fake_A_pool.query = record
    gstate, aux = iteration(gstate, ganA, ganB, g_lr, d_lr)
    gtr.fake_A_pool.query = query
    _params(gstate, "gan_dp", out)
    _metrics(aux, "gan_dp", out)
    out["gan_dp/fake_A_global"], out["gan_dp/fake_A_pooled"] = pools[0]
    for name, b in gstate.d.model.named_buffers():
        out[f"gan_dp/d_state/{name}"] = b.cpu().numpy()

    ztr = gan_trainer(0, dev)
    zg = parallel.zero1_gd_from_state(ztr.init(gseed), mesh)
    zg, aux = parallel.make_gd_zero1_step(ztr, mesh)(zg, ganA, ganB, g_lr, d_lr)
    _params(zg, "gan_zero1", out)
    _metrics(aux, "gan_zero1", out)
    for name, b in zg.d.model.named_buffers():
        out[f"gan_zero1/d_state/{name}"] = b.cpu().numpy()
    return out


if __name__ == "__main__":
    sys.exit(cli())
