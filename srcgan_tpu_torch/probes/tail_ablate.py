"""The x4 tail's main kernel against its first design, timed on the card.

    python -m srcgan_tpu_torch.probes tail [--rounds 4]

``csrc/tail_x4.cu`` (the design that ships: wgmma with t1 and z2 chained in
registers, weights by bulk copies, a persistent grid) and
``csrc/tail_x4_wmma.cu`` (the first design: wmma 16x16x16, every
intermediate through shared memory, weights copied by all threads between
block barriers) compute the same zall.  This builds both (one nvcc each,
started together), first runs the chain check (GEMM 1 and the first chunk of
GEMM 2 alone, the claim that a wgmma accumulator is the next product's A
fragment), holds both main kernels against the plain ``zall_reference`` at
(8,128,128,64), ou = 1 and 3 (max|diff| <= 0.02 * max(max|ref|, 1)), and
then times them at ou = 1: a CUDA graph of four launches replayed between
events, the two in turns (forwards, backwards, ...), and each kernel's
device time from the profiler.  The first design is launched only from
here; no launch of either is counted.  There is no CPU mode.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
from concurrent.futures import ThreadPoolExecutor

import torch

from srcgan_tpu_torch import config
from srcgan_tpu_torch.probes import common

SHAPE = (8, 128, 128, 64)
FIRST = "tail_x4_wmma"          # csrc/tail_x4_wmma.cu


def flop(m: int, nf: int, ou: int) -> int:
    """Operations of the three GEMMs over the four phase blocks."""
    return 4 * 2 * (nf * nf + nf * 4 * nf + 4 * nf * 144 * ou) * m


@functools.lru_cache(maxsize=1)
def _first() -> ctypes.CDLL:
    from srcgan_tpu_torch.ops.kernels import build

    lib = build.load(FIRST)
    lib.tail_x4_wmma_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.tail_x4_wmma_launch.restype = ctypes.c_int
    lib.tail_x4_wmma_error_string.argtypes = [ctypes.c_int]
    lib.tail_x4_wmma_error_string.restype = ctypes.c_char_p
    return lib


def first_design(t0m: torch.Tensor, tw, alpha: float = 0.2) -> torch.Tensor:
    """zall through the first design: the plain (4,nf,nf), (nf,4nf),
    (4,4nf,c9) operands of ``TailWeights``, no launch counted."""
    lib = _first()
    m, nf = t0m.shape
    c9 = tw.wall.shape[2]
    zall = torch.empty((m, c9), dtype=torch.bfloat16, device=t0m.device)
    stream = torch.cuda.current_stream(t0m.device).cuda_stream
    with torch.cuda.device(t0m.device):
        err = lib.tail_x4_wmma_launch(t0m.data_ptr(), tw.w1s.data_ptr(), tw.w2m.data_ptr(),
                                      tw.wall.data_ptr(), zall.data_ptr(), m, nf, c9, alpha, stream)
    if err:
        raise RuntimeError(f"{FIRST} launch failed: {lib.tail_x4_wmma_error_string(err).decode()}")
    return zall


def chain(t0m: torch.Tensor, tw, alpha: float = 0.2) -> torch.Tensor:
    """The chain check of csrc/tail_x4.cu on the card: t0's first 64 rows ->
    (64, 64) fp32 sums of t1 @ W2m[:, :64], t1 = bf16(lrelu(t0 @ W1[0])), with
    t1 handed from GEMM 1's accumulator to GEMM 2 as registers."""
    from srcgan_tpu_torch.ops.kernels import tail_kernel

    lib = tail_kernel._library()
    tail_kernel._check_operands(t0m.device, t0=t0m, packed=tw.packed)
    out = torch.empty((64, 64), dtype=torch.float32, device=t0m.device)
    stream = torch.cuda.current_stream(t0m.device).cuda_stream
    with torch.cuda.device(t0m.device):
        err = lib.tail_x4_chain_launch(t0m.data_ptr(), tw.packed.data_ptr(), out.data_ptr(),
                                       t0m.shape[0], t0m.shape[1], alpha, stream)
    tail_kernel._raise_if(lib, err, "chain check")
    return out


def chain_reference(t0m: torch.Tensor, tw, alpha: float = 0.2) -> torch.Tensor:
    """The plain version of ``chain``."""
    t1 = torch.nn.functional.leaky_relu(t0m[:64].float() @ tw.w1s[0].float(), alpha)
    return t1.to(torch.bfloat16).float() @ tw.w2m[:, :64].float()


def inputs(gen, ou: int, dev, shape=SHAPE):
    """Trunk rows and prepared weights, kaiming-scaled as chip_smoke.py draws them."""
    from srcgan_tpu_torch.ops.kernels import tail_kernel

    n, h, w, nf = shape
    t0 = torch.randn(n * h * w, nf, generator=gen).to(dev, torch.bfloat16)
    d1, d2 = (torch.randn(nf, nf, 2, 2, generator=gen) * (2 / (4 * nf)) ** 0.5 for _ in range(2))
    lw = torch.randn(ou, nf, 3, 3, generator=gen) * (2 / (9 * ou)) ** 0.5
    return t0, tail_kernel.prepare(d1.to(dev), d2.to(dev), lw.to(dev))


def within(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got.float() - ref.float()).abs().max().item()
    bound = 0.02 * max(ref.float().abs().max().item(), 1.0)
    return err, bound


def main(argv=None) -> list:
    from srcgan_tpu_torch.ops.kernels import build, tail_kernel

    p = argparse.ArgumentParser(prog="python -m srcgan_tpu_torch.probes tail",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="the card to run on (an error without one; there is no CPU mode)")
    p.add_argument("--rounds", type=int, default=4, help="timing rounds, in turns (default 4)")
    args = p.parse_args(argv)
    dev = config.resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("the tail ablation times CUDA kernels built for sm_90a on an NVIDIA "
                           "card (an H100); it has no CPU mode")
    print(f"# tail_x4 main kernel at {SHAPE}, against its first design, on {common.card_line(dev)}")
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(build.build, ("tail_x4", FIRST)))
    for path, seconds, _ in built:
        print(f"# built {path.name} in {seconds:.1f} s")

    gen = torch.Generator().manual_seed(21)
    rows = []
    for nf in (16, 64):
        t0m, tw = inputs(gen, 1, dev, (1, 8, 8, nf))
        got, ref = chain(t0m, tw), chain_reference(t0m, tw)
        torch.cuda.synchronize()
        rel = ((got - ref).norm() / ref.norm()).item()
        print(f"# chain check nf={nf}: rel-L2 vs plain {rel:.3g} (bound 1e-3)")
        if not rel <= 1e-3:
            raise RuntimeError(f"the tail's accumulator -> A chaining is wrong at nf={nf}")
    count = tail_kernel.launches
    kernels = {"ships": lambda t, w: tail_kernel._zall_kernel(t, w, 0.2),
               "first design": first_design}
    for ou in (1, 3):
        t0m, tw = inputs(gen, ou, dev)
        ref = tail_kernel.zall_reference(t0m, tw)
        for label, fn in kernels.items():
            err, bound = within(fn(t0m, tw), ref)
            print(f"# {label} ou={ou}: max|zall - plain| {err:.4g} (bound {bound:.4g})")
            if not err <= bound:
                raise RuntimeError(f"tail_x4 ({label}) disagrees with its plain version at ou={ou}")
        if ou == 1:
            timed = (t0m, tw)
    tail_kernel.launches = count                  # the checks above are not the main path's

    t0m, tw = timed
    ops = flop(t0m.shape[0], t0m.shape[1], 1)
    times = {label: [] for label in kernels}
    order = list(kernels)
    for _ in range(args.rounds):
        for label in order:
            times[label].append(common.graph_ms([lambda f=kernels[label]: f(t0m, tw)] * 4))
        order.reverse()
    tail_kernel.launches = count
    on_device = {"ships": common.device_us(lambda: kernels["ships"](t0m, tw), "tail_x4_kernel"),
                 "first design": common.device_us(lambda: first_design(t0m, tw), "tail_x4_kernel")}
    tail_kernel.launches = count
    print(f"{'design':<14} {'median ms':>10} {'min':>8} {'max':>8} {'TFLOP/s':>8} {'device us':>10}")
    for label, ts in times.items():
        med = statistics.median(ts)
        dus = on_device[label]
        print(f"{label:<14} {med:>10.4f} {min(ts):>8.4f} {max(ts):>8.4f} {common.rate(ops, med):>8.1f} "
              f"{'not measured' if dus is None else f'{dus:.1f}':>10}")
        rows.append({"design": label, "ms": med, "min_ms": min(ts), "max_ms": max(ts),
                     "rounds": ts, "device_us": dus})
    return rows


if __name__ == "__main__":
    main()
