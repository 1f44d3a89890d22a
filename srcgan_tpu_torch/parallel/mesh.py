"""The data axis: a process group of N ranks, one device each, and the
helpers that place a batch and a state on it (``srcgan_tpu.parallel.mesh``).

The JAX package builds a ``Mesh`` of devices and lets GSPMD place arrays by
their sharding annotations.  PyTorch has no partitioner, so here a mesh is
a ``torch.distributed`` process group of N processes, each holding one
device: NCCL on ``cuda:<local rank>`` on cards, gloo only where the caller
asks for the CPU (a card never falls back to gloo).  ``put_batch`` takes
this rank's shard of a batch, ``put_replicated`` broadcasts rank 0's state,
and the steps of ``parallel.dp`` / ``zero`` / ``fsdp`` run the collectives
that XLA inserts in the JAX package.  Only the 1-D ``data`` axis exists;
the ``space`` axis comes with the rest of ROADMAP A14.

Launch.  ``make_mesh((N,))`` joins the group its process belongs to:

- in a worker of ``launch`` (the command-line tools' ``--mesh-size N``
  without ``WORLD_SIZE`` in the environment spawns N local workers with
  ``torch.multiprocessing``), through a ``FileStore`` in a fresh temporary
  directory;
- under ``torchrun``, whose ``WORLD_SIZE`` must equal N, through its
  environment;
- with N == 1 and neither, a group of one over its own ``FileStore``.

No fixed ``MASTER_PORT`` is used, so any number of groups run side by side.
``launch``'s workers import only this package: their entry point is
``_worker`` here, which imports the target by name.
"""
from __future__ import annotations

import importlib
import os
import pickle
import shutil
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from srcgan_tpu_torch import config

# launch's environment for its workers: the FileStore's path
STORE_ENV = "SRCGAN_TORCH_STORE"
# the temporary directory of a group of one that make_mesh started
_OWN_STORE: Optional[str] = None


class Mesh:
    """A 1-D ``data`` mesh over the default process group: this process's
    rank among ``size``, and its device."""

    def __init__(self, size: int, rank: int, device: torch.device, backend: str):
        self.size, self.rank, self.device, self.backend = size, rank, device, backend
        self.shape = {"data": size}

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that writes files and prints."""
        return self.rank == 0

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a scalar MAX)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def __repr__(self):
        return (f"Mesh(data={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data",), device=None) -> Mesh:
    """Join (or start) the process group of a 1-D ``data`` mesh of
    ``shape[0]`` ranks (default: ``WORLD_SIZE``, else 1) on ``device`` (the
    card by default; ``"cpu"`` for gloo)."""
    if tuple(axis_names) != ("data",) or (shape is not None and len(shape) != 1):
        raise NotImplementedError(
            f"mesh {tuple(shape or ())} over {tuple(axis_names)}: only the 1-D 'data' axis "
            "is ported; the space axis comes with the rest of ROADMAP A14")
    env_world = os.environ.get("WORLD_SIZE")
    n = int(shape[0]) if shape is not None else int(env_world or 1)
    device = config.resolve_device(device)
    rank = int(os.environ.get("RANK", 0))
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise SystemExit(f"rank {rank} needs card {local}; this host has "
                             f"{torch.cuda.device_count()}")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise SystemExit(f"--mesh-size {n} but this process group has "
                             f"{dist.get_world_size()} ranks")
        return Mesh(n, dist.get_rank(), device, backend)
    if env_world is not None and int(env_world) != n:
        raise SystemExit(f"--mesh-size {n} must equal WORLD_SIZE ({env_world}) under torchrun")
    kw = {"device_id": device} if backend == "nccl" else {}
    if os.environ.get(STORE_ENV):
        store = dist.FileStore(os.environ[STORE_ENV], n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n, **kw)
    elif env_world is not None:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=n, **kw)
    elif n == 1:
        global _OWN_STORE
        _OWN_STORE = tempfile.mkdtemp(prefix="srcgan_mesh_")
        store = dist.FileStore(os.path.join(_OWN_STORE, "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1, **kw)
    else:
        raise ValueError(f"a mesh of {n} ranks needs {n} processes: run them with "
                         "parallel.launch (the tools' --mesh-size) or torchrun")
    return Mesh(n, rank, device, backend)


def destroy_mesh() -> None:
    """Leave the process group (every rank calls it)."""
    global _OWN_STORE
    if dist.is_initialized():
        dist.destroy_process_group()
    if _OWN_STORE is not None:
        shutil.rmtree(_OWN_STORE, ignore_errors=True)
        _OWN_STORE = None


def pad_batch_to(batch: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading dim up to a multiple by repeating the last row;
    returns (padded, number of real rows)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), n


def shard_of(a, mesh: Mesh, batch_dim: int = 0):
    """This rank's shard of an array (numpy or tensor) along ``batch_dim``, a
    view; the dim must divide by the mesh size."""
    n = a.shape[batch_dim]
    if n % mesh.size:
        raise ValueError(f"batch dim {n} does not divide over {mesh.size} ranks")
    m = n // mesh.size
    index = [slice(None)] * a.ndim
    index[batch_dim] = slice(mesh.rank * m, (mesh.rank + 1) * m)
    return a[tuple(index)]


def put_batch(tree, mesh: Mesh, batch_dim: int = 0):
    """This rank's shard (``shard_of``) of every array leaf of ``tree``, on
    the mesh's device: ``batch_dim`` 1 for a (K, N, ...) block of steps."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(put_batch(t, mesh, batch_dim) for t in tree)
    if isinstance(tree, dict):
        return {k: put_batch(v, mesh, batch_dim) for k, v in tree.items()}
    return torch.as_tensor(shard_of(tree, mesh, batch_dim)).contiguous().to(mesh.device)


@torch.no_grad()
def _broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Broadcast rank 0's ``t`` into ``t`` in place (through the mesh's
    device where ``t`` lies elsewhere: Adam's step counts are host tensors)."""
    if t.device == mesh.device:
        dist.broadcast(t, 0)
    else:
        tmp = t.to(mesh.device)
        dist.broadcast(tmp, 0)
        t.copy_(tmp)
    return t


def put_replicated(tree, mesh: Mesh):
    """Rank 0's values of a state on every rank, in place: tensors, modules
    (parameters and buffers), optimizers (their state tensors), TrainStates
    and tuples / dicts of them; other leaves pass through.  Returns ``tree``."""
    if isinstance(tree, torch.Tensor):
        return _broadcast_(tree, mesh)
    if isinstance(tree, nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            _broadcast_(t.data, mesh)
        return tree
    if isinstance(tree, torch.optim.Optimizer):
        for st in tree.state.values():
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    _broadcast_(v, mesh)
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            put_replicated(v, mesh)
        return tree
    if isinstance(tree, (tuple, list)):
        for v in tree:
            put_replicated(v, mesh)
        return tree
    return tree


def all_gather_batch(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal-shaped shard of a batch, concatenated in rank order
    along dim 0 (the global batch), on every rank."""
    t = t.contiguous()
    out = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, t)
    return out


# -- launching N local workers ----------------------------------------------

def _worker(rank: int, target: str, argv, world: int, tmp: str, threads: int,
            device: str) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      **{STORE_ENV: os.path.join(tmp, "store")})
    if device == "cpu":
        torch.set_num_threads(max(1, threads // world))
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        out = fn(argv)
    except SystemExit as e:
        if e.code not in (None, 0):
            with open(os.path.join(tmp, f"exit.{rank}"), "w") as f:
                f.write(str(e.code))
        raise
    finally:
        destroy_mesh()
    if rank == 0:
        try:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
        except (pickle.PicklingError, TypeError, AttributeError):
            pass


def launch(target: str, argv, world: int, device: str = "cuda"):
    """Run ``target`` ("module:function", called with ``argv``) in ``world``
    local processes of one mesh, rank i on card i (or all on the CPU with
    ``device="cpu"``), and return rank 0's result where it pickles (else
    None).  A worker's exit message or error is raised here."""
    if torch.device(device).type == "cuda":
        config.resolve_device(device)
        have = torch.cuda.device_count()
        if world > have:
            raise SystemExit(f"--mesh-size {world} exceeds the {have} visible cards")
    tmp = tempfile.mkdtemp(prefix="srcgan_mesh_")
    try:
        try:
            torch.multiprocessing.spawn(
                _worker, args=(target, list(argv), world, tmp, torch.get_num_threads(),
                               torch.device(device).type), nprocs=world, join=True)
        except torch.multiprocessing.ProcessExitedException as e:
            exits = sorted(f for f in os.listdir(tmp) if f.startswith("exit."))
            if exits:
                with open(os.path.join(tmp, exits[0])) as f:
                    raise SystemExit(f.read()) from e
            raise
        result = os.path.join(tmp, "result.pkl")
        if os.path.exists(result):
            with open(result, "rb") as f:
                return pickle.load(f)
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def spawned_by_tool(mesh_size: int) -> bool:
    """True where a tool given ``--mesh-size`` must start its own workers:
    a size above 1 and no ``WORLD_SIZE`` in the environment (the workers,
    and torchrun's, have one)."""
    return mesh_size > 1 and "WORLD_SIZE" not in os.environ
