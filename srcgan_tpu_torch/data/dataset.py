"""File-list datasets (G2RGB, G2LAB) with on-device preprocessing, as in
``srcgan_tpu.data.dataset``.

Layout: ``<data_dir>/<root>/{src,tar}/`` plus ``{train,val,test}.txt`` file
lists.  The work is split between host and device:

  host   : file list, PNG decode (the native libpng decoder, or PIL), uint8
           HWC arrays, batching, shuffling, D4 augmentation: no float math;
  device : everything numeric (/255, luma, RGB->LAB, degradation) in
           ``srcgan_tpu_torch.data.preprocess``, so the host-to-device copy
           is uint8, a quarter of the fp32 bytes.

Pure numpy: for the same arguments ``batches`` yields the same bytes as the
JAX package's (the random draws are made in the same order).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

DATASET_DIR = os.environ.get(
    "SRCGAN_DATA_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "dataset"))


def normalize(arr: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0,1]."""
    mx, mi = np.max(arr), np.min(arr)
    return (arr - mi) / (mx - mi)


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


class FileListDataset:
    """Host-side dataset: yields uint8 RGB (src, tar) pairs by index.

    ver selects the on-device target conversion: 'G2RGB' (src->gray, tar->RGB)
    or 'G2LAB' (src->gray, tar->normalized LAB).
    """

    def __init__(self, root: str, split: str = "all", ver: str = "G2RGB",
                 data_dir: Optional[str] = None):
        self.root, self.split, self.ver = root, split, ver
        self.data_dir = data_dir or DATASET_DIR
        base = os.path.join(self.data_dir, root)
        with open(os.path.join(base, f"{split}.txt")) as f:
            self.datalist: List[str] = [ln.strip() for ln in f if ln.strip()]
        self.srcpath = os.path.join(base, "src", "%s")
        self.tarpath = os.path.join(base, "tar", "%s")
        self.src_ch, self.tar_ch = 1, 3

    def __len__(self):
        return len(self.datalist)

    def raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 HWC RGB pair (host)."""
        name = self.datalist[idx]
        return _read_png(self.srcpath % name), _read_png(self.tarpath % name)

    def raw_batch(self, idxs) -> Tuple[np.ndarray, np.ndarray]:
        """(src, tar) uint8 batches.  Uses the native C++/libpng threaded
        decoder (data/native.py) when available and the dataset's images are
        uniformly sized; decodes per item with PIL otherwise."""
        from srcgan_tpu_torch.data import native

        if native.available():
            if not hasattr(self, "_shapes"):
                n0 = self.datalist[0]
                self._shapes = (native.probe(self.srcpath % n0),
                                native.probe(self.tarpath % n0))
            sshape, tshape = self._shapes
            if sshape and tshape:
                try:
                    names = [self.datalist[int(i)] for i in idxs]
                    src = native.decode_batch(
                        [self.srcpath % n for n in names], *sshape)
                    tar = native.decode_batch(
                        [self.tarpath % n for n in names], *tshape)
                    return src, tar
                except RuntimeError:
                    pass  # mixed sizes / corrupt file: PIL path below
        srcs, tars = zip(*(self.raw(int(i)) for i in idxs))
        return np.stack(srcs), np.stack(tars)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """One converted sample: float32 HWC arrays (src luma, tar RGB or
        normalized LAB).

        The training path takes ``batches()`` and converts on the device;
        this per-sample form converts on the host.
        """
        import torch

        from srcgan_tpu_torch.data import preprocess

        src_u8, tar_u8 = self.raw(idx)
        src, tar = preprocess.convert_pair(
            torch.tensor(src_u8[None]), torch.tensor(tar_u8[None]), self.ver)
        return {"src": src[0].numpy(), "tar": tar[0].numpy(), "idx": idx}

    def show(self, idx: int, example_dir: Optional[str] = None) -> str:
        """Write a side-by-side src | tar preview PNG and return its path."""
        from srcgan_tpu_torch.utils.vis import save_png, whitespace

        sample = self.__getitem__(idx)
        src = sample["src"]
        tar = sample["tar"]
        src_img = whitespace((np.repeat(src, 3, axis=-1) * 255).astype(np.uint8))
        if self.ver == "G2LAB":
            import torch

            from srcgan_tpu_torch.ops import color
            tar = color.lab_norm_to_rgb(torch.from_numpy(tar)).numpy()
        tar_img = whitespace((tar * 255).astype(np.uint8))
        vis = np.concatenate([src_img, tar_img], axis=1)
        out_dir = example_dir or os.path.join(
            os.path.dirname(self.data_dir), "example", self.root + self.ver)
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"{self.split}-{idx}.png")
        save_png(out, vis)
        return out


class G2RGB(FileListDataset):
    def __init__(self, root, split="all", **kw):
        super().__init__(root, split, ver="G2RGB", **kw)


class G2LAB(FileListDataset):
    def __init__(self, root, split="all", **kw):
        super().__init__(root, split, ver="G2LAB", **kw)


_VERSIONS = {"G2RGB": G2RGB, "G2LAB": G2LAB}


def load_dataset(root: str, ver: str = "G2RGB", mode: str = "training"):
    """(trainset, valset, testset) of the default data directory."""
    cls = _VERSIONS[ver]
    return (cls(root, "train"), cls(root, "val"), cls(root, "test"))


# ---------------------------------------------------------------------------
# Batch iteration (host side)
# ---------------------------------------------------------------------------

def dihedral(img: np.ndarray, op: int) -> np.ndarray:
    """Apply D4 symmetry ``op`` (0..7) to an HWC array.

    0..3 = rot90 CCW by k=op; 4/5 = horizontal/vertical flip; 6 = transpose;
    7 = anti-transpose.  Ops 0, 2, 4, 5 preserve (H, W); the others swap the
    spatial dims (only legal for square images inside a stacked batch).
    """
    if op == 0:
        return img
    if op < 4:
        return np.rot90(img, k=op, axes=(0, 1))
    if op == 4:
        return img[:, ::-1]
    if op == 5:
        return img[::-1]
    if op == 6:
        return np.swapaxes(img, 0, 1)
    return np.swapaxes(img, 0, 1)[::-1, ::-1]


# D4 ops that keep (H, W) — the legal set for non-square imagery
_SHAPE_PRESERVING_OPS = np.array([0, 2, 4, 5])


def batches(dataset, batch_size: int, *, shuffle: bool = False,
            seed: int = 0, drop_last: bool = False, epoch: int = 0,
            host_id: int = 0, num_hosts: int = 1, workers: int = 0,
            prefetch: int = 2, augment: bool = False,
            ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (src_u8, tar_u8, idx) uint8 batches.  Deterministic per (seed,
    epoch).  For multi-host DP, each host passes its (host_id, num_hosts) and
    gets a disjoint strided shard of the (identically shuffled) order.

    workers>0 decodes batches in a thread pool, ``workers + prefetch`` batches
    ahead, yielding strictly in order, so a cold first epoch's PNG decode
    overlaps the device step instead of starving it (PIL decode releases the
    GIL).  Batch contents are identical to workers=0.

    augment=True applies a per-sample random D4 symmetry (rotation/flip/
    transpose) to BOTH images of the pair, the standard SR augmentation.  The
    same op on src and tar keeps the pair pixel-aligned (D4 commutes with the
    uniform down/up-sampling between the domains).  Ops are drawn per
    (seed, epoch, ORIGINAL dataset index), so the augmented stream is
    deterministic and identical across worker counts and multi-host shards;
    non-square imagery restricts to the four shape-preserving ops so batches
    still stack.  Host-side on uint8 by design: a flip costs a memcpy of a
    batch a quarter the size of its fp32 form.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    if num_hosts > 1:
        order = order[host_id::num_hosts]
    n = len(order)
    stop = n - (n % batch_size) if drop_last else n
    starts = list(range(0, stop, batch_size))

    aug_ops = None
    if augment and len(dataset) > 0:
        # keyed by original index: shard/worker/batch-boundary independent
        aug_ops = np.random.default_rng(
            np.random.SeedSequence([seed, epoch, 0xD4])
        ).integers(0, 8, size=len(dataset))
        s0, t0 = dataset.raw(0)
        if s0.shape[0] != s0.shape[1] or t0.shape[0] != t0.shape[1]:
            aug_ops = _SHAPE_PRESERVING_OPS[aug_ops % 4]

    def load(start):
        idxs = order[start:start + batch_size]
        if hasattr(dataset, "raw_batch"):
            src, tar = dataset.raw_batch(idxs)
        else:
            srcs, tars = zip(*(dataset.raw(int(i)) for i in idxs))
            src, tar = np.stack(srcs), np.stack(tars)
        if aug_ops is not None:
            ops_b = aug_ops[np.asarray(idxs)]
            src = np.ascontiguousarray(
                np.stack([dihedral(a, int(o)) for a, o in zip(src, ops_b)]))
            tar = np.ascontiguousarray(
                np.stack([dihedral(a, int(o)) for a, o in zip(tar, ops_b)]))
        return src, tar, idxs

    if workers <= 0:
        for s in starts:
            yield load(s)
        return

    import itertools
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = deque()
        it = iter(starts)
        for s in itertools.islice(it, workers + prefetch):
            pending.append(ex.submit(load, s))
        while pending:
            out = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(ex.submit(load, nxt))
            yield out


# ---------------------------------------------------------------------------
# Synthetic data (tests, smoke runs: no Sat2Aer imagery is in the repository)
# ---------------------------------------------------------------------------

def make_synthetic_dataset(path: str, n_train: int = 8, n_val: int = 2,
                           n_test: int = 2, size: int = 64, seed: int = 0,
                           scale: int = 1, colorizable: bool = False) -> str:
    """Create an on-disk Sat2Aer-layout dataset with procedural imagery.

    tar: smooth random RGB fields (sum of low-frequency cosines + noise);
    src: grayscale rendering of tar, optionally downscaled by ``scale`` —
    mirroring the Sat2Aerx1/x2/x4 variants.  Returns the dataset root name.

    ``colorizable=True`` draws each channel from a SHARED smooth field
    through a dataset-wide random tone curve (plus a small independent
    chroma field), so luma nearly determines color — the regime real
    aerial RGB lives in, and the one where the cascade protocol (gray -> SR
    -> colorize, scored as colorization PSNR) is actually attainable.  The default (independent
    per-channel phases) keeps color nearly ill-posed from luma, which
    caps cascade PSNR regardless of model quality.
    """
    rng = np.random.default_rng(seed)
    root = os.path.basename(path)
    os.makedirs(os.path.join(path, "src"), exist_ok=True)
    os.makedirs(os.path.join(path, "tar"), exist_ok=True)
    names = {"train": [], "val": [], "test": []}
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    total = {"train": n_train, "val": n_val, "test": n_test}
    # dataset-wide tone curve for the colorizable variant: per-channel
    # gamma + affine of the shared field (monotone, so luma -> RGB is
    # invertible and learnable by the colorizer).  Drawn ONLY for that
    # variant: the default variant's RNG stream (and with it every seeded
    # dataset of the JAX package) must stay byte-identical.
    if colorizable:
        tone_gamma = rng.uniform(0.6, 1.6, 3)
        tone_lo = rng.uniform(0.0, 0.25, 3)
        tone_hi = rng.uniform(0.75, 1.0, 3)
    for split, count in total.items():
        for i in range(count):
            if colorizable:
                g = np.zeros((size, size), np.float32)
                chroma = np.zeros((size, size), np.float32)
                for _ in range(4):
                    # gentler spectrum than the default variant: SR at x2
                    # must actually recover these frequencies for the
                    # cascade PSNR to reflect colorization quality
                    fx, fy = rng.uniform(0.5, 2.5, 2)
                    g += np.cos(2 * np.pi * (fx * rng.uniform(0.8, 1.2) * xx
                                             + fy * yy) + rng.uniform(0, 6.28))
                    cfx, cfy = rng.uniform(0.5, 1.5, 2)
                    chroma += np.cos(2 * np.pi * (cfx * xx + cfy * yy)
                                     + rng.uniform(0, 6.28))
                g = (g - g.min()) / (np.ptp(g) + 1e-9)
                chroma = (chroma - chroma.min()) / (np.ptp(chroma) + 1e-9)
                img = np.stack(
                    [tone_lo[c] + (tone_hi[c] - tone_lo[c])
                     * g ** tone_gamma[c] for c in range(3)], -1)
                # small independent chroma so color isn't a pure function
                # of luma (keeps the task non-trivial)
                img[..., 0] += 0.06 * (chroma - 0.5)
                img[..., 2] -= 0.06 * (chroma - 0.5)
                img = np.clip(img, 0, 1)
            else:
                img = np.zeros((size, size, 3), np.float32)
                for _ in range(4):
                    fx, fy = rng.uniform(0.5, 4, 2)
                    ph = rng.uniform(0, 6.28, 3)
                    for c in range(3):
                        img[..., c] += np.cos(
                            2 * np.pi * (fx * xx + fy * yy) + ph[c])
                img = (img - img.min()) / (np.ptp(img) + 1e-9)
            img = (img * 255).astype(np.uint8)
            gray = (img.astype(np.float32) @ np.array([0.2125, 0.7154, 0.0721]))
            src = np.repeat(gray[..., None], 3, -1).astype(np.uint8)
            if scale > 1:
                src = np.asarray(Image.fromarray(src).resize(
                    (size // scale, size // scale), Image.BILINEAR))
            name = f"{split}-{i}.png"
            Image.fromarray(img).save(os.path.join(path, "tar", name))
            Image.fromarray(src).save(os.path.join(path, "src", name))
            names[split].append(name)
    for split, lst in names.items():
        with open(os.path.join(path, f"{split}.txt"), "w") as f:
            f.write("\n".join(lst) + "\n")
    return root


# ---------------------------------------------------------------------------
# Raw decode cache: PNG decode is host work in front of every train step.  The
# first pass decodes and writes a uint8 .npy per split; later passes memmap
# it (no decode, no copy until batching).
# ---------------------------------------------------------------------------

class CachedDataset:
    """Wraps a FileListDataset with an on-disk uint8 raw cache."""

    def __init__(self, dataset: FileListDataset, cache_dir: Optional[str] = None):
        self.dataset = dataset
        self.ver = dataset.ver
        self.datalist = dataset.datalist
        base = cache_dir or os.path.join(dataset.data_dir, dataset.root, ".cache")
        os.makedirs(base, exist_ok=True)
        self._src = self._build(os.path.join(base, f"{dataset.split}_src.npy"),
                                which=0)
        self._tar = self._build(os.path.join(base, f"{dataset.split}_tar.npy"),
                                which=1)

    def _build(self, path: str, which: int) -> np.ndarray:
        n = len(self.dataset)
        if not os.path.exists(path):
            first = self.dataset.raw(0)[which]
            arr = np.lib.format.open_memmap(
                path, mode="w+", dtype=np.uint8, shape=(n, *first.shape))
            arr[0] = first
            for i in range(1, n):
                arr[i] = self.dataset.raw(i)[which]
            arr.flush()
        return np.load(path, mmap_mode="r")

    def __len__(self):
        return len(self.dataset)

    def raw(self, idx: int):
        return self._src[idx], self._tar[idx]

    def raw_batch(self, idxs):
        return self._src[np.asarray(idxs)], self._tar[np.asarray(idxs)]


if __name__ == "__main__":
    # Preview main: renders side-by-side src|tar example PNGs of every split
    # and prints the tensor shapes.
    import argparse

    parser = argparse.ArgumentParser(description="dataset preview")
    parser.add_argument("-idx", type=int, default=0)
    parser.add_argument("-root", type=str, default="Sat2Aerx1")
    parser.add_argument("--data-dir", type=str, default=None)
    args = parser.parse_args()
    for split in ("train", "val", "test"):
        ds = G2RGB(args.root, split, data_dir=args.data_dir)
        sample = ds[args.idx]
        ds.show(args.idx)
        print(f"Tensor size of {args.root}/G2RGB/{split}")
        print("\tsrc:", sample["src"].shape, "tar:", sample["tar"].shape)
