"""Training logger and step timing, as in ``srcgan_tpu.utils.logging``.

The Logger prints loss / ETA lines and writes the live image windows as PNG
files under a run directory: one file per window name, overwritten at each
log call, plus the loss history as ``losses.jsonl`` (``utils.live`` serves
both).
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from srcgan_tpu_torch.utils import vis


class Logger:
    def __init__(self, n_iters: int, n_epochs: int,
                 image_dir: Optional[str] = "runs/latest"):
        self.n_iters = n_iters
        self.n_epochs = n_epochs
        self.init_time = time.time()
        self.image_dir = image_dir
        if image_dir:
            # run dirs (e.g. runs/latest) are reused across runs: start this
            # run's loss history AND window set fresh, or the live dashboard
            # presents the previous run's PNGs as current
            try:
                for f in os.listdir(image_dir):
                    if f.endswith((".png", ".jsonl")):
                        os.remove(os.path.join(image_dir, f))
            except OSError:
                pass

    def log(self, nepoch: int, niter: int, losses: Optional[Dict] = None,
            images: Optional[Dict] = None, ver: str = "G2RGB") -> None:
        period = time.time() - self.init_time
        sys.stdout.write("\n Epoch %02d [%04d/%04d] >> " %
                         (nepoch, niter, self.n_iters))
        for k, v in (losses or {}).items():
            sys.stdout.write("%s: %.3f | " % (k, float(v)))
        iters_done = self.n_iters * (nepoch - 1) + niter
        iters_left = self.n_iters * self.n_epochs - iters_done
        eta = iters_left / max(iters_done, 1) * period
        sys.stdout.write("ETA: %s" % (datetime.timedelta(seconds=int(eta))))
        sys.stdout.flush()

        if losses and self.image_dir:
            # history consumed by utils.live.LiveView (and greppable per run)
            os.makedirs(self.image_dir, exist_ok=True)
            row = {"epoch": nepoch, "iter": niter, "t": round(period, 2),
                   "losses": {k: float(v) for k, v in losses.items()}}
            with open(os.path.join(self.image_dir, "losses.jsonl"), "a") as f:
                f.write(json.dumps(row) + "\n")

        if images and self.image_dir:
            os.makedirs(self.image_dir, exist_ok=True)
            for k, v in images.items():
                mode = "RGB"
                if k in ("fake_AB", "real_B", "fake_BB") and ver == "G2LAB":
                    mode = "LAB"            # raises until the LAB ops are ported
                img = vis.tensor2img(v, mode)
                # atomic overwrite: LiveView may be serving this window
                # concurrently, and a reader racing a plain in-place write
                # would get a truncated PNG.  The hidden dot-name keeps the
                # temp out of the dashboard's window list (and the .png
                # suffix keeps PIL's format inference working).
                final = os.path.join(self.image_dir, f"{k}.png")
                tmp = os.path.join(self.image_dir, f".{k}.png")
                vis.save_png(tmp, img)
                os.replace(tmp, final)


class StepTimer:
    """Wall-clock per-step timing with warmup exclusion.  The timed block must
    end in a wait for the device (``torch.cuda.synchronize()``), or it times
    the enqueue; ``profile_trace`` gives the device's side."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times = []
        self._t0 = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.array(self.times)
        return {"mean_s": float(arr.mean()), "p50_s": float(np.median(arr)),
                "min_s": float(arr.min()), "steps": len(arr)}


def profile_trace(log_dir: str):
    """Context manager: a torch.profiler trace (host and, on a card, device
    activities) written for TensorBoard under ``log_dir``."""
    import torch
    from torch import profiler

    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    return profiler.profile(activities=activities,
                            on_trace_ready=profiler.tensorboard_trace_handler(log_dir))
