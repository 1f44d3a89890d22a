"""Data layer of the port: on-device preprocessing (``data.preprocess``).

The file-list datasets (``srcgan_tpu.data.dataset``, ``native``) are still to
be ported (ROADMAP A9); this package imports nothing that needs jax.
"""
from srcgan_tpu_torch.data import preprocess

__all__ = ["preprocess"]
