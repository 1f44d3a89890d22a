"""Weights across: JAX parameter trees and reference .pth state_dicts, both ways.

The port's modules carry the reference torch names, which are the names
``srcgan_tpu.interop.export_torch_state_dict`` emits, so a state_dict from
either source loads with ``strict=True``.  ``state_dict_from_jax`` is that
export done with numpy alone (no jax): path components are renamed by the
same map, convs go HWIO -> OIHW, transposed convs (kh,kw,in,out) ->
(in,out,kh,kw), and norm ``scale`` becomes ``weight``.  A module whose
JAX tree starts below it names that attribute ``jax_root`` (the PatchGAN's
``model``: reference name ``model.3.weight``, JAX path ``3/scale``; the
roots nest, as in a U-Net's ``model.model.1.model...``); one
whose attribute keeps its name in the JAX tree where the map would rename
it says so in ``jax_names`` (EDSR's ``upscale_layers``); one whose tensors
are constants no JAX tree holds sets ``jax_constant`` (the zoo's
``MeanShift``).  ``jax_tree_from_module``
is its inverse: a port module (or any state_dict-shaped dict of its tensors,
such as Adam's moments) -> the JAX parameter tree and model state, as numpy,
which the JAX package's ``load_params`` reads.  ``quant_scales_from_jax``
carries an int8 calibration table across, ``vgg_params_from_jax`` a set
of VGG weights (``losses_vgg``).  The ``jax_constant`` tensors
are in no JAX tree: ``state_dict_from_jax`` takes them from the module,
``jax_tree_from_module`` leaves them out; ``nn.PReLU``'s ``weight`` is the
JAX ``alpha``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
    "alpha": "weight",              # PReLU slope
}
# BatchNorm running statistics, kept in the JAX model state.
_STATE_NAME_MAP = {"mean": "running_mean", "var": "running_var"}
# The inverse maps (module-name components; the leaf names depend on the owner).
_JAX_NAME_MAP = {"RRDB_trunk": "trunk", "upscale_layers": "upscale",
                 "RRDB_encoder": "encoder", "RRDB_decoder": "decoder"}
_JAX_STATE_NAME_MAP = {v: k for k, v in _STATE_NAME_MAP.items()}


def _torch_name(model: nn.Module, path, names) -> str:
    """The port name of a JAX tree path: components renamed by ``names``,
    and the ``jax_root`` of a module on the way (the attribute its JAX tree
    starts at, e.g. the PatchGAN's ``model``) put back in."""
    out, mod = [], model
    for part in path[:-1]:
        root = getattr(mod, "jax_root", None)
        while root:
            out.append(root)
            mod = getattr(mod, root)
            root = getattr(mod, "jax_root", None)
        out.append(names.get(part, part))
        mod = mod.get_submodule(out[-1])
    return ".".join(out + [names.get(path[-1], path[-1])])


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
        name = _torch_name(model, path, _TORCH_NAME_MAP)
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        a = np.asarray(v)
        if name.endswith(".weight") and isinstance(owner, nn.ConvTranspose2d):
            a = a.transpose(2, 3, 0, 1)
        elif name.endswith(".weight") and isinstance(owner, nn.Conv2d):
            a = a.transpose(3, 2, 0, 1)
        out[name] = torch.tensor(np.ascontiguousarray(a))
    for path, v in _walk(state or {}):
        name = _torch_name(model, path, {**_TORCH_NAME_MAP, **_STATE_NAME_MAP})
        out[name] = torch.tensor(np.ascontiguousarray(v))
    for name, t in model.state_dict().items():       # constants no JAX tree holds
        if _is_constant(model, name):
            out[name] = t.detach().cpu().clone()
    # the model's registration order (JAX tree utilities sort the keys)
    order = [k for k in model.state_dict() if k in out]
    return {k: out[k] for k in order + [k for k in out if k not in order]}


def _is_constant(model: nn.Module, name: str) -> bool:
    return getattr(model.get_submodule(name.rpartition(".")[0]), "jax_constant", False)


def quant_scales_from_jax(scales) -> Dict[int, np.ndarray]:
    """The port's int8 calibration table (``quant.quant_mode``'s ``scales``)
    from one recorded by the JAX package's ``quant.calibrate_fn``: callsite
    index -> per-input-channel absmax, float32 numpy, copied.  The two
    packages count callsites alike, and a per-channel vector means the same
    in NHWC and NCHW, so the table carries over key for key."""
    return {int(i): np.array(v, dtype=np.float32) for i, v in scales.items()}


def load_params_any(model: nn.Module, path: str) -> nn.Module:
    """Load an .npz written by the JAX package's ``save_params`` or a reference
    .pth state_dict into ``model`` (strict=True) and return the model."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        sd = state_dict_from_jax(model, load_params(path))
    model.load_state_dict(sd, strict=True)
    return model


def _jax_path(model: nn.Module, name: str) -> Tuple[Tuple[str, ...], bool]:
    """(JAX tree path, is model state) of the port tensor ``name``."""
    *mods, leaf = name.split(".")
    owner = model.get_submodule(".".join(mods))
    path = []
    i = 0
    mod = model
    while i < len(mods):
        part = mods[i]
        if getattr(mod, "jax_root", None) == part:     # not in the JAX tree
            mod = getattr(mod, part)
            i += 1
            continue
        names = {**_JAX_NAME_MAP, **getattr(mod, "jax_names", {})}
        mod = getattr(mod, part)
        if part == "downsample" and i + 1 < len(mods):
            path.append({"0": "down_conv", "1": "down_bn"}[mods[i + 1]])
            mod = getattr(mod, mods[i + 1])
            i += 2
            continue
        path.append(names.get(part, part))
        i += 1
    if leaf in _JAX_STATE_NAME_MAP:
        return tuple(path) + (_JAX_STATE_NAME_MAP[leaf],), True
    if isinstance(owner, (nn.Conv2d, nn.ConvTranspose2d)):
        return tuple(path) + ({"weight": "w", "bias": "b"}[leaf],), False
    if isinstance(owner, nn.PReLU):
        return tuple(path) + ("alpha",), False
    return tuple(path) + ({"weight": "scale", "bias": "bias"}[leaf],), False


def jax_tree_from_module(model: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None):
    """(params, model state) in the JAX package's tree layout, as nested dicts
    of float32 numpy arrays: the inverse of ``state_dict_from_jax``.

    ``tensors`` defaults to the module's own state_dict; any dict with the
    same names and parameter shapes (an optimizer's moments, gradients)
    converts the same way.  The arrays are copies.  ``num_batches_tracked``
    and the ``jax_constant`` tensors have no JAX counterpart."""
    sd = model.state_dict() if tensors is None else tensors
    params: Dict = {}
    state: Dict = {}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked") or _is_constant(model, name):
            continue
        path, is_state = _jax_path(model, name)
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        a = t.detach().float().cpu().numpy().copy()     # never a view of the module
        if name.endswith(".weight") and isinstance(owner, nn.ConvTranspose2d):
            a = a.transpose(2, 3, 0, 1)
        elif name.endswith(".weight") and isinstance(owner, nn.Conv2d):
            a = a.transpose(2, 3, 1, 0)
        node = state if is_state else params
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return params, state


def vgg_params_from_jax(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's VGG parameters (``losses_vgg``: OIHW weights) from the JAX
    package's ``{idx: {"w": HWIO, "b"}}`` tree of arrays, copied to float32."""
    return {str(idx): {"w": torch.from_numpy(np.array(p["w"], np.float32).transpose(3, 2, 0, 1)
                                             .copy()),
                       "b": torch.from_numpy(np.array(p["b"], np.float32))}
            for idx, p in params.items()}
