"""Faults of the RCAN stream cell and of the space driver
(``drivers/space.py``), beside ``variants.FAULTS``, each breaking the timed
path underneath the driver:

- ``ca_skipped``: every channel attention of the SR net gates by a constant
  0.5 in place of its sigmoid of the image's channel means;
- ``halo_short``: each strip takes one halo row too few: the outermost row
  of every halo a strip receives is zeros.

    python3 portbench/faults.py --workload rcan_x4_stream_b32 --variant ca_skipped \\
        --seconds 3 --seeds 11 12 13

runs ``control.py`` with these faults among its variants.
"""
from __future__ import annotations

import sys
import types
from pathlib import Path

FAULTS = ("ca_skipped", "halo_short")


def _half_gate(self, x):
    return x * 0.5


def serving(cell, pred) -> None:
    """The SR net's channel attentions under ``ca_skipped``."""
    if cell.variant != "ca_skipped":
        return
    for m in pred.sr_model.modules():
        if type(m).__name__ == "CALayer":
            m.forward = types.MethodType(_half_gate, m)


def strips(variant: str) -> None:
    """``parallel.spatial``'s exchange under ``halo_short`` (every rank of a
    space-sharded cell calls it before serving)."""
    if variant != "halo_short":
        return
    from srcgan_tpu_torch.parallel import spatial

    exchange = spatial.SpaceScope.exchange

    def short(self, x, top, bottom, give_up=None, give_down=None):
        y = exchange(self, x, top, bottom, give_up, give_down)
        got_top = top if self.prev is not None else 0
        got_bottom = bottom if self.next is not None else 0
        if y is x or not (got_top or got_bottom):
            return y
        y = y.clone()
        if got_top:
            y[:, :, 0] = 0
        if got_bottom:
            y[:, :, -1] = 0
        return y

    spatial.SpaceScope.exchange = short


def main(argv=None) -> int:
    from portbench import control, variants

    variants.FAULTS = variants.FAULTS + FAULTS
    return control.main(argv)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())
