"""Runs other than the program's own, for ``control.py`` and the tests: the
control (a precision below the configuration's) and planted faults.  The
benchmark's command always runs the variant "program", which changes
nothing.

Faults, each breaking the timed path underneath the driver:

- ``answer_altered``: the first row of every batch the predictor hands back
  is inverted where it reaches the host;
- ``state_unchanged``: the trainer's update leaves the state as it was;
- ``half_batch``: the trainer's step sees the first half of its batch, and
  its means are taken over that half.
"""
from __future__ import annotations

FAULTS = ("answer_altered", "state_unchanged", "half_batch")


def serving(cell, pred) -> None:
    if cell.variant != "answer_altered":
        return
    collect = pred._collect

    def altered(host, done):
        out = collect(host, done).copy()
        out[0] = 255 - out[0]
        return out

    pred._collect = altered


def training(cell, trainer) -> None:
    if cell.variant == "state_unchanged":
        trainer.apply_grads = lambda state, grads, model_states, lr: state
    elif cell.variant == "half_batch":
        inputs = trainer._u8_inputs

        def half(src_u8, tar_u8):
            n = tar_u8.shape[0] // 2
            return inputs(src_u8[:n], tar_u8[:n])

        trainer._u8_inputs = half
