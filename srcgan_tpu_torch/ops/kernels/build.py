"""Build the package's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``srcgan_tpu_torch/_build/lib<name>-<digest>.so`` (the digest covers
the source, the flags and the ``-D`` defines of a variant, so an edited source
rebuilds and every variant has its own library).  The build is atomic
(temporary file + rename), so concurrent processes can race on it safely.
Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# sm_90a, not sm_90: the "a" target is the one that also admits wgmma/setmaxnreg.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def build(name: str, defines: tuple = ()) -> tuple:
    """Compile csrc/<name>.cu unless its library exists.  ``defines`` are
    compile-time switches of the source ("RDB5_WGMMA=0", ...), none for the
    design that ships.  Returns (path, seconds spent compiling, compiler log);
    seconds is 0.0 and the log the one kept from the earlier build when the
    library was already there."""
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, seconds, log


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (of its variant ``defines``),
    built at first use."""
    with _lock:
        lib = _libs.get((name, defines))
        if lib is None:
            path, _, _ = build(name, defines)
            lib = _libs[(name, defines)] = ctypes.CDLL(str(path))
        return lib
