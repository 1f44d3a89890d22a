"""Model registry of the port: the models of the x4 serving cascade.

``create(name, ...)`` builds a model by name, as ``srcgan_tpu.models.create``
does; the rest of the JAX zoo is still to be ported (ROADMAP A3, A11).
"""
from __future__ import annotations

from typing import Dict

from srcgan_tpu_torch.models.rddb import RDDBNet
from srcgan_tpu_torch.models.resdeconv import ResDeconv

REGISTRY: Dict[str, type] = {
    "RDDBNet": RDDBNet,
    "ResDeconv": ResDeconv,
}


def create(name: str, *args, **kwargs):
    """Build a registered model: create("RDDBNet", 1, 1, 4, device="cuda")."""
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(REGISTRY)}") from None
    return cls(*args, **kwargs)


__all__ = ["REGISTRY", "RDDBNet", "ResDeconv", "create"]
