"""Checkpoint retention (GC / best-k) and metric-gated early stopping, as in
``srcgan_tpu.train.retention`` (pure Python; the same ledger file, so a run
can move between the packages).

  CheckpointManager — tracks checkpoint groups (one epoch = N files) with a
      JSON ledger persisted next to the checkpoints (survives resume), and
      garbage-collects after every save so only the union of the newest
      ``keep_last`` and the metric-best ``keep_best`` groups remain.
      keep_last=0 / keep_best=0 disables that bound (reference behavior).

  EarlyStopper — stop when the gating metric hasn't improved by at least
      ``min_delta`` for ``patience`` consecutive evaluations.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


class CheckpointManager:
    """Retention manager for epoch-grouped checkpoint files."""

    LEDGER = "retention.json"

    def __init__(self, directory: str, keep_last: int = 0, keep_best: int = 0,
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.dir = directory
        self.keep_last, self.keep_best = keep_last, keep_best
        self.mode = mode
        self._groups: Dict[str, dict] = {}
        self._ledger_path = os.path.join(directory, self.LEDGER)
        if os.path.exists(self._ledger_path):
            with open(self._ledger_path) as f:
                self._groups = json.load(f)

    # -- api ------------------------------------------------------------------

    def register(self, epoch: int, files: List[str],
                 metric: Optional[float] = None) -> List[str]:
        """Record one saved checkpoint group and garbage-collect.

        Returns the list of file paths deleted by retention."""
        self._groups[str(epoch)] = {
            "files": [os.path.basename(f) for f in files],
            "metric": None if metric is None else float(metric),
        }
        removed = self._gc()
        self._persist()
        return removed

    def best_epoch(self) -> Optional[int]:
        scored = [(g["metric"], int(e)) for e, g in self._groups.items()
                  if g["metric"] is not None]
        if not scored:
            return None
        return (max if self.mode == "max" else min)(scored)[1]

    # -- internals --------------------------------------------------------------

    def _keep_set(self) -> set:
        epochs = sorted(int(e) for e in self._groups)
        keep = set(epochs)  # default: keep everything
        if self.keep_last > 0 or self.keep_best > 0:
            keep = set(epochs[-self.keep_last:] if self.keep_last > 0 else [])
            if self.keep_best > 0:
                scored = sorted(
                    ((g["metric"], int(e)) for e, g in self._groups.items()
                     if g["metric"] is not None),
                    reverse=self.mode == "max")
                keep.update(e for _, e in scored[:self.keep_best])
        return keep

    def _gc(self) -> List[str]:
        keep = self._keep_set()
        removed = []
        for e in [e for e in self._groups if int(e) not in keep]:
            for fname in self._groups[e]["files"]:
                path = os.path.join(self.dir, fname)
                if os.path.exists(path):
                    os.remove(path)
                    removed.append(path)
            del self._groups[e]
        return removed

    def _persist(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        with open(self._ledger_path, "w") as f:
            json.dump(self._groups, f, indent=1, sort_keys=True)


class EarlyStopper:
    """Stop when the metric hasn't improved by min_delta for `patience`
    consecutive updates.  patience=0 disables."""

    def __init__(self, patience: int = 0, min_delta: float = 0.0,
                 mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.patience, self.min_delta, self.mode = patience, min_delta, mode
        self.best: Optional[float] = None
        self.stale = 0

    def update(self, value: float) -> bool:
        """Record one evaluation; returns True when training should stop."""
        if self.patience <= 0:
            return False
        improved = (self.best is None
                    or (value > self.best + self.min_delta
                        if self.mode == "max"
                        else value < self.best - self.min_delta))
        if improved:
            self.best = value
            self.stale = 0
        else:
            self.stale += 1
        return self.stale >= self.patience
