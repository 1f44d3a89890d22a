"""ctypes bindings for the native (C++/libpng) batch PNG decoder and encoder.

Builds ``_native/loader.cc`` with g++ on first use into the package's ignored
``_build/`` directory (the one place everything built at run time lives),
under a name that carries the source's digest, and loads it via ctypes.
Optional: where g++ or libpng's header is missing, ``available()`` is false
and the callers take the PIL path.  ``SRCGAN_NO_NATIVE=1`` turns it off.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "_native", "loader.cc")
_lib = None
_tried = False


def _cache_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "_build")


def _build() -> Optional[str]:
    try:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    out = os.path.join(_cache_dir(), f"_loader_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_cache_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", _SRC, "-lpng", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("SRCGAN_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.srcgan_png_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.srcgan_png_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.srcgan_png_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.srcgan_png_encode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def codec() -> str:
    """Which PNG codec the package uses in this process."""
    return "libpng (native, C++ threads)" if available() else "PIL"


def probe(path: str) -> Optional[Tuple[int, int]]:
    """(h, w) of a PNG, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.srcgan_png_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    return h.value, w.value


def decode_batch(paths: Sequence[str], h: int, w: int,
                 threads: int = 4) -> np.ndarray:
    """Decode PNGs (all h x w) to one (n, h, w, 3) uint8 array, in C++
    threads.  Raises on any failure (the caller then decodes with PIL)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.srcgan_png_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.c_void_p), h, w, threads)
    if rc:
        raise RuntimeError(f"native decode failed for {paths[rc - 1]!r}")
    return out


def encode(path: str, img: np.ndarray) -> None:
    """uint8 (h, w, 3|1) or (h, w) -> PNG via libpng.  Raises on failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native encoder unavailable")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    img = np.ascontiguousarray(img)
    rc = lib.srcgan_png_encode(path.encode(),
                               img.ctypes.data_as(ctypes.c_void_p), h, w, ch)
    if rc:
        raise RuntimeError(f"native encode failed for {path!r} ({rc})")


def encode_batch(paths: Sequence[str], imgs: np.ndarray,
                 threads: int = 4) -> None:
    """Write imgs (n, h, w, 3|1) uint8 to one PNG each, in C++ threads
    (zlib compression is the host side of a batched eval).  Raises on any
    failure (the caller then encodes with PIL)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native encoder unavailable")
    n, h, w, ch = imgs.shape
    assert n == len(paths), (n, len(paths))
    imgs = np.ascontiguousarray(imgs)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.srcgan_png_encode_batch(
        arr, imgs.ctypes.data_as(ctypes.c_void_p), n, h, w, ch, threads)
    if rc:
        raise RuntimeError(f"native encode failed for {paths[rc - 1]!r}")
