"""Image IO and visualization helpers, as in ``srcgan_tpu.utils.vis`` (numpy on the host)."""
from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """float32 numpy array of a tensor (any device) or an array."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def save_png(path: str, arr: np.ndarray) -> None:
    """uint8 HWC (or HW) array -> PNG (native libpng encoder when built,
    PIL otherwise)."""
    from srcgan_tpu_torch.data import native

    if arr.dtype == np.uint8 and (arr.ndim == 2 or arr.shape[-1] in (1, 3)):
        try:
            native.encode(path, arr)
            return
        except RuntimeError:
            pass
    from PIL import Image

    Image.fromarray(arr).save(path)


def save_png_batch(paths, imgs) -> None:
    """Write a list/stack of same-shaped uint8 HWC images to one PNG each.
    Uses the C++ thread fan-out encoder (data/_native/loader.cc) where it is
    built (zlib compression is the host side of a batched eval pass), and PIL
    one image at a time otherwise."""
    from srcgan_tpu_torch.data import native

    arr = np.asarray(imgs)
    if arr.ndim == 3:
        arr = arr[..., None]
    # Same gate as save_png: the native encoder hands the raw buffer to
    # libpng as unsigned char*, so a non-uint8 / odd-channel array would
    # silently write corrupt PNGs instead of erroring.
    if arr.dtype == np.uint8 and arr.shape[-1] in (1, 3):
        try:
            native.encode_batch(list(paths), arr)
            return
        except RuntimeError:
            pass
    for p, img in zip(paths, imgs):
        save_png(p, np.asarray(img))


def whitespace(img: np.ndarray, width: int = 5) -> np.ndarray:
    """5-px white border around an HWC uint8 image."""
    h, w, c = img.shape
    out = np.full((h + 2 * width, w + 2 * width, c), 255, np.uint8)
    out[width:h + width, width:w + width] = img
    return out


def add_barrier(img: np.ndarray, width: int = 2, color: int = 0) -> np.ndarray:
    """Black/white framing of a panel patch."""
    h, w, c = img.shape
    out = np.full((h + 2 * width, w + 2 * width, c), color, np.uint8)
    out[width:h + width, width:w + width] = img
    return out


def tensor2img(x, mode: str = "RGB", dsize=(256, 256)) -> np.ndarray:
    """First sample of an NHWC float batch (numpy or tensor) -> uint8 HWC RGB
    at dsize.  mode "LAB": a normalized-LAB tensor is de-normalized and
    converted to RGB; a 2-channel ab map is read as (a, b, b), as the JAX
    package's clamped channel index reads it."""
    from PIL import Image

    a = _host(x[0])
    if mode == "LAB":
        import torch

        from srcgan_tpu_torch.ops import color
        if a.shape[-1] == 2:
            a = np.concatenate([a, a[..., 1:]], axis=-1)
        a = color.lab_norm_to_rgb(torch.from_numpy(np.ascontiguousarray(a))).numpy()
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    img = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    if img.shape[:2] != dsize:
        img = np.asarray(Image.fromarray(img).resize(dsize[::-1], Image.BILINEAR))
    return img


def patch2vis(*imgs: np.ndarray) -> np.ndarray:
    """Horizontal concat of framed patches."""
    return np.concatenate([add_barrier(im) for im in imgs], axis=1)


def tensor2image_u8(x) -> np.ndarray:
    """First sample of a float NHWC batch -> uint8 HWC (HW for one channel):
    times 255, truncated."""
    a = _host(x[0]) * 255.0
    a = a.astype(np.uint8)
    if a.shape[-1] == 1:
        a = a[..., 0]
    return a
