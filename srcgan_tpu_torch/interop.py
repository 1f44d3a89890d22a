"""Weights into the port: JAX parameter trees and reference .pth state_dicts.

The port's modules carry the reference torch names, which are the names
``srcgan_tpu.interop.export_torch_state_dict`` emits, so a state_dict from
either source loads with ``strict=True``.  ``state_dict_from_jax`` is that
export done with numpy alone (no jax): path components are renamed by the
same map, convs go HWIO -> OIHW, transposed convs (kh,kw,in,out) ->
(in,out,kh,kw), and norm ``scale`` becomes ``weight``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from srcgan_tpu_torch.train.state import load_params

# JAX parameter-tree path components -> reference torch module names, where
# they differ (srcgan_tpu/interop.py _TORCH_NAME_MAP).
_TORCH_NAME_MAP = {
    "trunk": "RRDB_trunk",          # RDDBNet
    "upscale": "upscale_layers",    # RDDBNet
    "encoder": "RRDB_encoder",      # SRDN
    "decoder": "RRDB_decoder",      # SRDN
    "down_conv": "downsample.0",    # ResDeconv BasicBlock
    "down_bn": "downsample.1",
    "w": "weight",
    "b": "bias",
    "scale": "weight",              # norm affine
}
# BatchNorm running statistics, kept in the JAX model state.
_STATE_NAME_MAP = {"mean": "running_mean", "var": "running_var"}


def _torch_name(path, names) -> str:
    return ".".join(names.get(part, part) for part in path)


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def state_dict_from_jax(model: nn.Module, params, state=None) -> Dict[str, torch.Tensor]:
    """The port state_dict of a JAX parameter tree (nested dicts of arrays)
    and, for BatchNorm models, of its model state."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _walk(params):
        name = _torch_name(path, _TORCH_NAME_MAP)
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        a = np.asarray(v)
        if name.endswith(".weight") and isinstance(owner, nn.ConvTranspose2d):
            a = a.transpose(2, 3, 0, 1)
        elif name.endswith(".weight") and isinstance(owner, nn.Conv2d):
            a = a.transpose(3, 2, 0, 1)
        out[name] = torch.tensor(np.ascontiguousarray(a))
    for path, v in _walk(state or {}):
        name = _torch_name(path, {**_TORCH_NAME_MAP, **_STATE_NAME_MAP})
        out[name] = torch.tensor(np.ascontiguousarray(v))
    # the model's registration order (JAX tree utilities sort the keys)
    order = [k for k in model.state_dict() if k in out]
    return {k: out[k] for k in order + [k for k in out if k not in order]}


def load_params_any(model: nn.Module, path: str) -> nn.Module:
    """Load an .npz written by the JAX package's ``save_params`` or a reference
    .pth state_dict into ``model`` (strict=True) and return the model."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        sd = state_dict_from_jax(model, load_params(path))
    model.load_state_dict(sd, strict=True)
    return model
