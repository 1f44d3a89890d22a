"""Model registry of the port: the cascade's SR generators and colorizers,
the six names the reference exports, and the adversarial trainer's nets.

``create(name, ...)`` builds a model by name, as ``srcgan_tpu.models.create``
does, with the same positional arguments; the pix2pix generators (the
multi-task half of ROADMAP A10) and the EDSR-derived zoo (A11) are still to
be ported.
"""
from __future__ import annotations

from typing import Dict

from srcgan_tpu_torch.models.discriminator import NLayerDiscriminator
from srcgan_tpu_torch.models.edsr import EDSR
from srcgan_tpu_torch.models.espcn import ESPCN, SRCNN
from srcgan_tpu_torch.models.legacy import (Decoder, Encoder, RDDBNetA, RDDBNetB,
                                            RDDBNetD, SRDenseNetA, SRDenseNetB)
from srcgan_tpu_torch.models.rddb import RDDBNet
from srcgan_tpu_torch.models.resdeconv import ResDeconv
from srcgan_tpu_torch.models.srdn import SRDN

# The reference package's public export list.
EXPORTED = ("ESPCN", "SRCNN", "EDSR", "RDDBNet", "SRDN", "ResDeconv")

REGISTRY: Dict[str, type] = {
    "ESPCN": ESPCN,
    "SRCNN": SRCNN,
    "EDSR": EDSR,
    "RDDBNet": RDDBNet,
    "SRDN": SRDN,
    "ResDeconv": ResDeconv,
    "NLayerDiscriminator": NLayerDiscriminator,
    "RDDBNetA": RDDBNetA,
    "RDDBNetB": RDDBNetB,
    "RDDBNetD": RDDBNetD,
    "Decoder": Decoder,
    "Encoder": Encoder,
    "SRDenseNetA": SRDenseNetA,
    "SRDenseNetB": SRDenseNetB,
}


def create(name: str, *args, **kwargs):
    """Build a registered model: create("RDDBNet", 1, 1, 4, device="cuda")."""
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(REGISTRY)}") from None
    return cls(*args, **kwargs)


__all__ = list(REGISTRY) + ["EXPORTED", "REGISTRY", "create"]
