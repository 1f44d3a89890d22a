"""Deployment artifacts: the whole uint8 -> uint8 cascade as one
``torch.export`` program, as ``srcgan_tpu.deploy`` does with StableHLO.

``export_cascade`` traces a ``CascadePredictor``'s forward (the input
scaling, luma of an RGB input, both networks, the colour conversion and the
output quantization) with its weights in the program, and serialises it
with ``torch.export.save``.  Any PyTorch of a compatible version runs the
artifact without this package, its model code or the checkpoints:

  pred = CascadePredictor.from_checkpoints(ga, gb, bf16=True)
  blob = export_cascade(pred, h=128, w=128)          # symbolic batch dim
  open("cascade.pt2", "wb").write(blob)
  ...
  run = load_exported(open("cascade.pt2", "rb").read())
  sr_rgb_u8 = run(gray_u8)                            # any batch size

Notes:
  - the batch dimension is symbolic by default (``batch=None``): one
    artifact serves every batch size.  H and W stay concrete, as the
    bucket-padded serving shapes are.
  - the program is traced with this package's kernels scoped off
    (``rddb.no_tail_kernel`` and ``rdb5_schedule("naive")``): a call into a
    library of this package would tie the artifact to it; the tail runs
    phase-folded and the dense blocks as convolutions.
  - ``platforms`` lists the device types the artifact may be loaded on
    ("cuda", "cpu"); ``load_exported`` moves the program there.  The
    numerics mode travels with it: an fp32 artifact runs with TF32 off.
"""
from __future__ import annotations

import io
import warnings

import numpy as np
import torch

from srcgan_tpu_torch import config

PLATFORMS = ("cuda", "cpu")


class _Program(torch.nn.Module):
    """The predictor's forward as a module that holds its two networks, so
    that their weights are the exported program's parameters."""

    def __init__(self, pred):
        super().__init__()
        self.sr_model, self.c_model = pred.sr_model, pred.c_model
        self._pred = pred

    def forward(self, gray_u8):
        return self._pred._run(gray_u8)


def export_cascade(pred, h: int, w: int, c: int = 1, batch: int | None = None,
                   platforms=PLATFORMS) -> bytes:
    """Serialise ``pred``'s uint8 -> uint8 program; returns the artifact.

    pred: a CascadePredictor (its weights go into the artifact; traced on
        its device).
    h, w, c: the input resolution and channels (1 gray or 3 RGB, luma taken).
    batch: a concrete batch size, or None for a symbolic batch dimension.
    platforms: the device types a loader may run it on.
    """
    from srcgan_tpu_torch.models.blocks import rdb5_schedule
    from srcgan_tpu_torch.models.rddb import no_tail_kernel

    if pred.int8:
        # int8 runs through quant.quant_mode's scoped dispatch, which the
        # trace would not see: the artifact would hold the float program
        raise NotImplementedError("export_cascade does not support int8 predictors; "
                                  "export the bf16 or fp32 predictor instead")
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms {unknown or platforms}: an artifact runs on "
                         f"{' / '.join(PLATFORMS)} under PyTorch")
    # an example batch of 2: a size-1 dimension would be specialised
    example = torch.zeros((2 if batch is None else batch, h, w, c), dtype=torch.uint8,
                          device=pred.device)
    dynamic = ({0: torch.export.Dim("batch", min=1)},) if batch is None else None
    with no_tail_kernel(), rdb5_schedule("naive"):
        program = torch.export.export(_Program(pred), (example,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # channels_last weights are not "complete" in torch.export's sense;
        # each is written whole, with its strides, and loads back as it was
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, buf, extra_files={
            "platforms": ",".join(platforms), "precision": "bf16" if pred.bf16 else "fp32"})
    return buf.getvalue()


def load_exported(blob: bytes, device=None):
    """Deserialise an ``export_cascade`` artifact into a callable on
    ``device`` (default: the card; raises without one unless the caller
    passes ``device="cpu"``).

    Returns ``run(gray_u8) -> uint8 SR RGB`` (numpy in, numpy out), with the
    loaded program as ``run.exported``."""
    from torch.export.passes import move_to_device_pass

    device = config.resolve_device(device)
    extra = {"platforms": "", "precision": ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    platforms = extra["platforms"].split(",")
    if device.type not in platforms:
        raise ValueError(f"the artifact was made for {platforms}, not {device.type}")
    program = move_to_device_pass(program, device)
    module = program.module()

    def run(gray_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(gray_u8)).to(device)
        with torch.no_grad(), config.precision(extra["precision"]):
            return module(x).cpu().numpy()

    run.exported = program
    return run
