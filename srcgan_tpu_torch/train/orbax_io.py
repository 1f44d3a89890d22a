"""Step-indexed full-state checkpoints written with
``torch.distributed.checkpoint`` (``srcgan_tpu.train.orbax_io``).

The JAX package writes these with orbax; the names (``OrbaxCheckpointer``,
``save_train_state_orbax``, ``load_train_state_orbax``) and the tools'
``--orbax-dir`` flag stay, so command lines carry over.  The files are the
port's own: orbax's are not read.

- One directory a step, ``<dir>/<step>/``: the state's tensors through
  ``torch.distributed.checkpoint`` (each rank writes what it holds: the
  replicated tensors once, the rows of a ZeRO-1 or FSDP state per rank,
  under keys of their rank) and ``extra.json``.  A save goes to
  ``<step>.partial`` and is renamed when every rank is done, so a reader
  never sees a partial step; ``max_to_keep`` drops the oldest steps.
- ``restore(like)`` loads into ``like``'s layout in place: a plain state,
  or a ZeRO-1 / FSDP state made on a mesh of the same size.
- Saves are synchronous: a save is on disk when ``save`` returns.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from srcgan_tpu_torch.train.state import TrainState


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def _sharded(ts: TrainState) -> bool:
    from srcgan_tpu_torch.parallel.zero import ShardedAdam

    return isinstance(ts.opt, ShardedAdam)


def _state_tensors(state) -> Dict[str, torch.Tensor]:
    """Every tensor of a trainer state by a checkpoint key: each network's
    state_dict (without an FSDP state's freed parameters), its optimizer's
    moments and count, its lr and step.  The rows of a sharded optimizer
    are keyed by the rank that holds them."""
    out: Dict[str, torch.Tensor] = {}
    for role, ts in state._asdict().items():
        sharded = _sharded(ts)
        skip = set(ts.opt.names) if sharded and ts.opt.fsdp else set()
        for k, v in ts.model.state_dict().items():
            if k not in skip:
                out[f"{role}/model/{k}"] = v
        if sharded:
            mu, nu, count = ts.opt.moments()
            r = _rank()
            out[f"{role}/rows/{r}"] = ts.opt.rows.detach()
            out[f"{role}/mu/{r}"], out[f"{role}/nu/{r}"] = mu, nu
        else:
            first = next(iter(ts.model.parameters()))
            count = int(ts.opt.state.get(first, {}).get("step", 0))
            for name, p in ts.model.named_parameters():
                st = ts.opt.state.get(p, {})
                out[f"{role}/mu/{name}"] = st.get("exp_avg", torch.zeros_like(p))
                out[f"{role}/nu/{name}"] = st.get("exp_avg_sq", torch.zeros_like(p))
        out[f"{role}/count"] = torch.tensor(count, dtype=torch.int64)
        out[f"{role}/step"] = torch.tensor(int(ts.step), dtype=torch.int64)
        out[f"{role}/lr"] = torch.tensor(float(ts.opt.param_groups[0]["lr"]),
                                         dtype=torch.float64)
    return out


@torch.no_grad()
def _load_into(state, tensors: Dict[str, torch.Tensor]):
    """Copy restored tensors (``_state_tensors``' keys) into ``state`` in place;
    returns the state with the restored steps."""
    out = {}
    for role, ts in state._asdict().items():
        sharded = _sharded(ts)
        skip = set(ts.opt.names) if sharded and ts.opt.fsdp else set()
        for k, v in ts.model.state_dict().items():
            if k not in skip:
                v.copy_(tensors[f"{role}/model/{k}"])
        count = int(tensors[f"{role}/count"])
        if sharded:
            r = _rank()
            ts.opt.rows.copy_(tensors[f"{role}/rows/{r}"])
            ts.opt.set_moments(tensors[f"{role}/mu/{r}"], tensors[f"{role}/nu/{r}"], count)
        else:
            ts.opt.state.clear()
            for name, p in ts.model.named_parameters():
                if count:
                    ts.opt.state[p] = {
                        "step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": tensors[f"{role}/mu/{name}"].clone(),
                        "exp_avg_sq": tensors[f"{role}/nu/{name}"].clone()}
        for group in ts.opt.param_groups:
            group["lr"] = float(tensors[f"{role}/lr"])
        out[role] = ts._replace(step=int(tensors[f"{role}/step"]))
    return type(state)(**out)


class OrbaxCheckpointer:
    """Step-indexed train-state checkpoints under one directory.

    >>> ck = OrbaxCheckpointer("ckpt", max_to_keep=3)
    >>> ck.save(epoch, state, {"epoch": epoch})
    >>> state, extra = ck.restore(like=trainer.init(0))   # latest

    Every rank of a mesh calls every method (they are collectives)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if _rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
        _barrier()

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None) -> None:
        import torch.distributed.checkpoint as dcp

        final = os.path.join(self.directory, str(int(step)))
        part = final + ".partial"
        if _rank() == 0:
            shutil.rmtree(part, ignore_errors=True)
        _barrier()
        dcp.save(_state_tensors(state), checkpoint_id=part)
        _barrier()
        if _rank() == 0:
            with open(os.path.join(part, "extra.json"), "w") as f:
                json.dump(dict(extra or {}), f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(part, final)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        _barrier()

    def restore(self, like: Any, step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
        """Restore ``step`` (default: the latest) into ``like`` in place (a
        state of the layout the checkpoint was saved from, on a mesh of the
        same size); returns (state, extra)."""
        import torch.distributed.checkpoint as dcp

        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = os.path.join(self.directory, str(int(step)))
        tensors = {k: v.clone() for k, v in _state_tensors(like).items()}
        dcp.load(tensors, checkpoint_id=path)
        with open(os.path.join(path, "extra.json")) as f:
            extra = json.load(f)
        return _load_into(like, tensors), extra


def save_train_state_orbax(directory: str, step: int, state: Any,
                           extra: Optional[Dict[str, Any]] = None,
                           max_to_keep: Optional[int] = None) -> None:
    """One save, done when it returns."""
    OrbaxCheckpointer(directory, max_to_keep=max_to_keep).save(step, state, extra)


def load_train_state_orbax(directory: str, like: Any, step: Optional[int] = None
                           ) -> Tuple[Any, Dict[str, Any]]:
    """One restore (the latest step by default)."""
    return OrbaxCheckpointer(directory).restore(like, step)
