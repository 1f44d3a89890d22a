"""Train state and checkpoint files (``srcgan_tpu.train.state``).

The JAX package saves a parameter tree as ``.npz`` with '/'-joined path keys
(``save_params``) under the reference's config-in-filename convention
``<Model>[@G2LAB]_<A2C|C2B>_x<up>_<epoch%04d>.<ext>``.  The port reads and
writes that layout (``srcgan_tpu_torch.interop`` converts between the tree
and a module), so either package loads the other's weights.

``save_train_state`` / ``load_train_state`` keep the port trainer's whole
state for resuming: per network its parameters, BatchNorm running
statistics, Adam moments and count, learning rate and step, all in the JAX
tree layout, plus ``__extra__/`` scalars.  Every write is atomic (a
temporary file in the same directory, then ``os.replace``), so a reader or
a crash never sees a partial file.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class TrainState(NamedTuple):
    """One network's training state.  ``model`` holds the fp32 master
    parameters and, as buffers, the model state (BatchNorm running
    statistics); ``opt`` its optimizer; ``step`` the updates applied.  The
    trainer updates ``model`` and ``opt`` in place."""
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    step: int


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is not None:
        a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else tree
        out[prefix.rstrip("/")] = np.asarray(a)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _savez_atomic(path: str, flat: Dict[str, np.ndarray]) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_params(path: str, params) -> None:
    """Save a parameter tree (nested dicts of numpy arrays or tensors, e.g.
    ``interop.jax_tree_from_module(model)[0]``) as the JAX package's .npz."""
    _savez_atomic(path, _flatten(params))


def load_params(path: str) -> Dict[str, Any]:
    """Load a ``save_params`` .npz into nested dicts of numpy arrays, in the
    file's key order.  (The JAX package checks the tree against a template
    here; the port checks the resulting state_dict with strict=True.)"""
    with np.load(path) as raw:
        return _unflatten({key: raw[key] for key in raw.files})


_NAME_RE = re.compile(
    r"^(?P<model>[A-Za-z0-9]+)(?:@(?P<ver>G2LAB))?_(?P<role>A2C|C2B)"
    r"_x(?P<up>\d+)_(?P<epoch>\d{4})$")


def checkpoint_name(model: str, role: str, up: int, epoch: int,
                    ver: Optional[str] = None, ext: str = "npz") -> str:
    """'<Model>[@G2LAB]_<role>_x<up>_<epoch%04d>.<ext>'."""
    tag = f"{model}@{ver}" if ver == "G2LAB" else model
    return f"{tag}_{role}_x{up}_{epoch:04d}.{ext}"


def parse_checkpoint_name(path: str) -> Dict[str, Any]:
    """Inverse of checkpoint_name: {model, ver, role, up, epoch}."""
    base = os.path.basename(path)
    stem = base.rsplit(".", 1)[0]
    m = _NAME_RE.match(stem)
    if not m:
        raise ValueError(f"unrecognized checkpoint name: {base}")
    d = m.groupdict()
    return {"model": d["model"], "ver": d["ver"] or "G2RGB",
            "role": d["role"], "up": int(d["up"]), "epoch": int(d["epoch"])}


def _adam_moments(ts: TrainState, key: str) -> Dict[str, torch.Tensor]:
    """One Adam moment of every parameter, by parameter name (zeros before
    the first update)."""
    out = {}
    for name, p in ts.model.named_parameters():
        st = ts.opt.state.get(p, {})
        out[name] = st[key] if key in st else torch.zeros_like(p)
    return out


def save_train_state(path: str, state, extra: Optional[Dict[str, Any]] = None) -> None:
    """Save a trainer state (a NamedTuple of ``TrainState``s, e.g. CasState)
    for resuming.  ``extra`` holds scalar metadata, e.g. {'epoch': 7}."""
    from srcgan_tpu_torch import interop

    flat: Dict[str, np.ndarray] = {}
    for role, ts in state._asdict().items():
        params, model_state = interop.jax_tree_from_module(ts.model)
        first = next(iter(ts.model.parameters()))
        count = ts.opt.state.get(first, {}).get("step", 0)
        tree = {
            "params": params, "model_state": model_state, "step": np.int64(ts.step),
            "opt": {"mu": interop.jax_tree_from_module(ts.model, _adam_moments(ts, "exp_avg"))[0],
                    "nu": interop.jax_tree_from_module(ts.model, _adam_moments(ts, "exp_avg_sq"))[0],
                    "count": np.int64(int(count)),
                    "lr": np.float64(ts.opt.param_groups[0]["lr"])},
        }
        flat.update(_flatten(tree, f"{role}/"))
    for k, v in (extra or {}).items():
        flat[f"__extra__/{k}"] = np.asarray(v)
    _savez_atomic(path, flat)


@torch.no_grad()
def load_train_state(path: str, like) -> Tuple[Any, Dict[str, Any]]:
    """Restore a ``save_train_state`` file into ``like`` (e.g. a fresh
    ``trainer.init(seed)``): parameters, buffers and optimizer state are
    copied into its modules and optimizers in place.  Returns (state with
    the saved steps, extra)."""
    from srcgan_tpu_torch import interop

    with np.load(path) as raw:
        flat = {k: raw[k] for k in raw.files}
    extra = {k.split("/", 1)[1]: flat.pop(k).item()
             for k in list(flat) if k.startswith("__extra__/")}
    tree = _unflatten(flat)
    restored = {}
    for role, ts in like._asdict().items():
        t = tree[role]
        sd = interop.state_dict_from_jax(ts.model, t["params"], t.get("model_state"))
        ts.model.load_state_dict(sd, strict=False)
        missing = set(ts.model.state_dict()) - set(sd)
        if any(not k.endswith("num_batches_tracked") for k in missing):
            raise ValueError(f"{role}: checkpoint lacks {sorted(missing)[:5]}")
        mu = interop.state_dict_from_jax(ts.model, t["opt"]["mu"])
        nu = interop.state_dict_from_jax(ts.model, t["opt"]["nu"])
        count = int(t["opt"]["count"])
        ts.opt.state.clear()
        for name, p in ts.model.named_parameters():
            if count:
                ts.opt.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": torch.empty_like(p).copy_(mu[name]),
                    "exp_avg_sq": torch.empty_like(p).copy_(nu[name])}
        for group in ts.opt.param_groups:
            group["lr"] = float(t["opt"]["lr"])
        restored[role] = ts._replace(step=int(t["step"]))
    return type(like)(**restored), extra
