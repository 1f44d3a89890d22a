"""Data layer of the port: host-side file-list datasets and batching
(``data.dataset``, ``data.native``) and on-device preprocessing
(``data.preprocess``).  Nothing here needs jax.
"""
from srcgan_tpu_torch.data import preprocess
from srcgan_tpu_torch.data.dataset import (
    G2LAB,
    G2RGB,
    CachedDataset,
    FileListDataset,
    batches,
    dihedral,
    load_dataset,
    make_synthetic_dataset,
    normalize,
)

__all__ = ["preprocess", "FileListDataset", "G2RGB", "G2LAB", "load_dataset", "batches",
           "dihedral", "make_synthetic_dataset", "CachedDataset", "normalize"]
