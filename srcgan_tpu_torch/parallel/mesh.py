"""The mesh: a process group of N ranks, one device each, cut into axes, and
the helpers that place a batch and a state on it (``srcgan_tpu.parallel.mesh``).

The JAX package builds a ``Mesh`` of devices and lets GSPMD place arrays by
their sharding annotations.  PyTorch has no partitioner, so here a mesh is
a ``torch.distributed`` process group of N processes, each holding one
device: NCCL on ``cuda:<local rank>`` on cards, gloo only where the caller
asks for the CPU (a card never falls back to gloo).  ``make_mesh(shape,
axis_names)`` lays the ranks out row-major over ``shape``, as JAX reshapes
its device list, with 1 or 2 of the axes ``data``, ``space``, ``model`` and
``pipe``; each line of each axis is a process group of its own
(``Mesh.group``), so a data reduction never mixes in the other axes.
``put_batch`` takes this rank's data shard of a batch, ``put_replicated``
broadcasts rank 0's state, and the steps of ``parallel.dp`` / ``zero`` /
``fsdp`` / ``tp`` / ``pipeline`` and ``parallel.spatial``'s halo exchange run
the collectives that XLA inserts in the JAX package.

Launch.  ``make_mesh(shape)`` joins the group its process belongs to:

- in a worker of ``launch`` (the command-line tools' ``--mesh-size N``
  without ``WORLD_SIZE`` in the environment spawns N local workers with
  ``torch.multiprocessing``), through a ``FileStore`` in a fresh temporary
  directory;
- under ``torchrun``, whose ``WORLD_SIZE`` must equal the mesh's size,
  through its environment;
- with a mesh of one rank and neither, a group of one over its own ``FileStore``.

No fixed ``MASTER_PORT`` is used, so any number of groups run side by side.
Every collective waits at most ``TIMEOUT_S`` seconds, so a rank whose peers
are gone raises instead of hanging.
``launch``'s workers import only this package: their entry point is
``_worker`` here, which imports the target by name.
"""
from __future__ import annotations

import importlib
import os
import pickle
import shutil
import tempfile
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from srcgan_tpu_torch import config

# launch's environment for its workers: the FileStore's path
STORE_ENV = "SRCGAN_TORCH_STORE"
AXES = ("data", "space", "model", "pipe")
# how long a collective waits for its peers before it raises
TIMEOUT_S = 600.0
# the temporary directory of a group of one that make_mesh started
_OWN_STORE: Optional[str] = None


class _Size(int):
    """The mesh's number of ranks, an int; called with an axis name, that
    axis's size (1 for an axis the mesh does not have)."""

    def __new__(cls, n: int, shape: dict):
        self = super().__new__(cls, n)
        self._shape = shape
        return self

    def __call__(self, axis: str) -> int:
        return self._shape.get(axis, 1)


class Mesh:
    """A mesh over the default process group: this process's global
    ``rank`` among ``size`` ranks, its device, and the axes in ``shape``
    (axis -> size, in order).  ``coord(axis)`` is this rank's position on an
    axis, ``group(axis)`` the process group of its line along it (the
    default group where the axis spans every rank), ``size(axis)`` its
    size.  On a 1-D ``data`` mesh ``size`` and ``rank`` are the data axis's."""

    def __init__(self, shape: dict, rank: int, device: torch.device, backend: str):
        self.shape = dict(shape)
        self.size = _Size(int(np.prod(list(self.shape.values()))), self.shape)
        self.rank, self.device, self.backend = rank, device, backend
        self._coords = dict(zip(self.shape, np.unravel_index(rank, tuple(self.shape.values()))))
        self._groups = {}
        grid = np.arange(int(self.size)).reshape(tuple(self.shape.values()))
        for i, axis in enumerate(self.shape):
            if self.shape[axis] == self.size:
                self._groups[axis] = dist.group.WORLD
                continue
            # every line of the axis, in the same order on every rank
            lines = np.moveaxis(grid, i, -1).reshape(-1, self.shape[axis])
            for line in lines:
                g = dist.new_group([int(r) for r in line], timeout=timedelta(seconds=TIMEOUT_S))
                if rank in line:
                    self._groups[axis] = g

    def coord(self, axis: str) -> int:
        return int(self._coords.get(axis, 0))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if axis not in self.shape:
            raise KeyError(f"this mesh has no {axis!r} axis: {tuple(self.shape)}")
        return self._groups[axis]

    def peer(self, axis: str, coord: int) -> int:
        """The global rank at ``coord`` on ``axis``, the other coordinates this rank's."""
        at = dict(self._coords, **{axis: coord})
        return int(np.ravel_multi_index(tuple(at[a] for a in self.shape),
                                        tuple(self.shape.values())))

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
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}, rank={self.rank}, device={self.device}, backend={self.backend})"


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data",), device=None) -> Mesh:
    """Join (or start) the process group of a mesh of ``shape`` (default:
    ``WORLD_SIZE`` ranks, else 1) over ``axis_names`` on ``device`` (the
    card by default; ``"cpu"`` for gloo).  Called again in a process whose
    group is up, it lays a new mesh over the same ranks."""
    axis_names = tuple(axis_names)
    env_world = os.environ.get("WORLD_SIZE")
    shape = tuple(int(v) for v in shape) if shape is not None else (int(env_world or 1),)
    if (len(shape) != len(axis_names) or not 1 <= len(shape) <= 2
            or len(set(axis_names)) != len(axis_names)
            or any(a not in AXES for a in axis_names)):
        raise ValueError(f"mesh {shape} over {axis_names}: 1 or 2 distinct axes of {AXES}")
    n = int(np.prod(shape))
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
    dims = dict(zip(axis_names, shape))
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise SystemExit(f"a mesh of {n} ranks {dims} but this process group has "
                             f"{dist.get_world_size()}")
        return Mesh(dims, dist.get_rank(), device, backend)
    if env_world is not None and int(env_world) != n:
        raise SystemExit(f"a mesh of {n} ranks {dims} must equal WORLD_SIZE ({env_world}) "
                         "under torchrun")
    kw = {"device_id": device} if backend == "nccl" else {}
    kw["timeout"] = timedelta(seconds=TIMEOUT_S)
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
    return Mesh(dims, rank, device, backend)


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
    """This rank's shard of an array (numpy or tensor) along ``batch_dim``
    over the mesh's ``data`` axis (the whole array where it has none), a
    view; the dim must divide by the axis size."""
    n, d = a.shape[batch_dim], mesh.size("data")
    if n % d:
        raise ValueError(f"batch dim {n} does not divide over {d} ranks")
    m = n // d
    index = [slice(None)] * a.ndim
    index[batch_dim] = slice(mesh.coord("data") * m, (mesh.coord("data") + 1) * m)
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
    """Every data rank's equal-shaped shard of a batch, concatenated in rank
    order along dim 0 (the global batch), on every rank."""
    t = t.contiguous()
    out = torch.empty((mesh.size("data") * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, t, group=mesh.group("data"))
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
        try:     # a state that holds process groups does not pickle
            blob = pickle.dumps(out)
        except (pickle.PicklingError, TypeError, AttributeError):
            return
        with open(os.path.join(tmp, "result.pkl"), "wb") as f:
            f.write(blob)


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


def _follower(i: int, *args) -> None:
    _worker(i + 1, *args)


class Followers:
    """Ranks 1..N-1 of a mesh whose rank 0 is this process (``lead``)."""

    def __init__(self, context, tmp: str):
        self.context, self.tmp = context, tmp

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.context.processes)

    def kill(self) -> None:
        """End the followers where rank 0 failed, and leave the mesh."""
        for p in self.context.processes:
            p.terminate()
        destroy_mesh()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def join(self, timeout: float = 60.0) -> None:
        """Leave the mesh and wait for the followers to exit (they must have
        been told to); a follower's error is raised here.  Rank 0 leaves
        first, once its device is done: NCCL's teardown waits for every rank
        of a communicator, so a follower leaving the mesh as it exits would
        wait for rank 0 while rank 0 waited for it to exit."""
        try:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            destroy_mesh()
            for p in self.context.processes:
                p.join(timeout)
                if p.is_alive():
                    p.terminate()
                    raise RuntimeError(f"a follower did not stop within {timeout}s")
            self.context.join(0)
        finally:
            destroy_mesh()
            shutil.rmtree(self.tmp, ignore_errors=True)


def lead(target: str, argv, world: int, axis_names=("space",), device: str = "cuda"):
    """Start ranks 1..world-1 of a 1-D mesh as local processes running
    ``target`` (as ``launch``'s workers do) and join it as rank 0 in this
    process.  Returns (mesh, Followers)."""
    if torch.device(device).type == "cuda":
        config.resolve_device(device)
        if world > torch.cuda.device_count():
            raise SystemExit(f"--mesh-size {world} exceeds the {torch.cuda.device_count()} "
                             "visible cards")
    tmp = tempfile.mkdtemp(prefix="srcgan_mesh_")
    context = torch.multiprocessing.start_processes(
        _follower, args=(target, list(argv), world, tmp, torch.get_num_threads(),
                         torch.device(device).type), nprocs=world - 1, join=False,
        start_method="spawn")
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": str(world),
           STORE_ENV: os.path.join(tmp, "store")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        mesh = make_mesh((world,), axis_names, device=device)
    except BaseException:
        for p in context.processes:
            p.terminate()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return mesh, Followers(context, tmp)


def spawned_by_tool(mesh_size: int) -> bool:
    """True where a tool given ``--mesh-size`` must start its own workers:
    a size above 1 and no ``WORLD_SIZE`` in the environment (the workers,
    and torchrun's, have one)."""
    return mesh_size > 1 and "WORLD_SIZE" not in os.environ
