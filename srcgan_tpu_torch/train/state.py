"""Checkpoint files of the JAX package, read with numpy (``srcgan_tpu.train.state``).

The JAX package saves a parameter tree as ``.npz`` with '/'-joined path keys
(``save_params``) under the reference's config-in-filename convention
``<Model>[@G2LAB]_<A2C|C2B>_x<up>_<epoch%04d>.<ext>``.  The port reads those
files; ``srcgan_tpu_torch.interop`` turns the tree into a state_dict.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np


def load_params(path: str) -> Dict[str, Any]:
    """Load a ``save_params`` .npz into nested dicts of numpy arrays, in the
    file's key order.  (The JAX package checks the tree against a template
    here; the port checks the resulting state_dict with strict=True.)"""
    tree: Dict[str, Any] = {}
    with np.load(path) as raw:
        for key in raw.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = raw[key]
    return tree


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
