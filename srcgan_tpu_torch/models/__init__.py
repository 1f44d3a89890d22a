"""Model registry of the port, the JAX package's 22 names: the cascade's SR
generators and colorizers (the six names the reference exports), the
CycleGAN-era nets and the PatchGAN, the EDSR-derived zoo and the pix2pix
generators.

``create(name, ...)`` builds a model by name, as ``srcgan_tpu.models.create``
does, with the same positional arguments; ``register(name, cls)`` adds one.
"""
from __future__ import annotations

from typing import Dict

from srcgan_tpu_torch.models.discriminator import NLayerDiscriminator
from srcgan_tpu_torch.models.edsr import EDSR
from srcgan_tpu_torch.models.edsr_zoo import (DDBPN, MDSR, RCAN, RDN, VDSR, EDSRWeb,
                                              args_namespace)
from srcgan_tpu_torch.models.espcn import ESPCN, SRCNN
from srcgan_tpu_torch.models.legacy import (Decoder, Encoder, RDDBNetA, RDDBNetB,
                                            RDDBNetD, SRDenseNetA, SRDenseNetB)
from srcgan_tpu_torch.models.pix2pix import ResnetGenerator, UnetGenerator, define_G
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
    "EDSRWeb": EDSRWeb,
    "VDSR": VDSR,
    "MDSR": MDSR,
    "RDN": RDN,
    "RCAN": RCAN,
    "DDBPN": DDBPN,
    "ResnetGenerator": ResnetGenerator,
    "UnetGenerator": UnetGenerator,
}


def register(name: str, cls: type) -> None:
    """Add (or replace) a model under ``name``."""
    REGISTRY[name] = cls


def create(name: str, *args, **kwargs):
    """Build a registered model: create("RDDBNet", 1, 1, 4, device="cuda")."""
    try:
        cls = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; known: {sorted(REGISTRY)}") from None
    return cls(*args, **kwargs)


__all__ = list(REGISTRY) + ["EXPORTED", "REGISTRY", "args_namespace", "create",
                            "define_G", "register"]
