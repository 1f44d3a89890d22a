"""The tile plan and the stitching of a tiled scene, a frozen copy of the
arithmetic of ``TiledPredictor`` (written out here, not imported): windows
of ``tile`` laid every ``tile - 2 * overlap`` pixels, edge windows flush
with the border, and each output tile's core kept."""
from __future__ import annotations

import numpy as np


def axis_windows(n: int, tile: int, overlap: int) -> list:
    """[(window start, core offset in the window, core start, core length)]
    covering [0, n)."""
    core = tile - 2 * overlap
    plan = []
    for i in range(-(-n // core)):
        c0, c1 = i * core, min((i + 1) * core, n)
        w = min(max(c0 - overlap, 0), n - tile)
        plan.append((w, c0 - w, c0, c1 - c0))
    return plan


def plan(h: int, w: int, tile: int, overlap: int) -> list:
    """The windows of an h x w scene, row-major: [(row entry, column entry)]."""
    return [(r, c) for r in axis_windows(h, tile, overlap) for c in axis_windows(w, tile, overlap)]


def crops(scene: np.ndarray, windows: list, tile: int) -> np.ndarray:
    """(len(windows), tile, tile, C) input windows of an (H, W, C) scene."""
    return np.stack([scene[r[0]:r[0] + tile, c[0]:c[0] + tile] for r, c in windows])


def cores(windows: list, scale: int) -> list:
    """[(output row slice, output column slice, tile row slice, tile column
    slice)] of each window's core, at the output scale."""
    out = []
    for (_, ky, cy, ly), (_, kx, cx, lx) in windows:
        out.append((slice(cy * scale, (cy + ly) * scale), slice(cx * scale, (cx + lx) * scale),
                    slice(ky * scale, (ky + ly) * scale), slice(kx * scale, (kx + lx) * scale)))
    return out


def stitch(out_tiles: np.ndarray, windows: list, h: int, w: int, scale: int) -> np.ndarray:
    """The (h*scale, w*scale, C) canvas of the output tiles' cores."""
    canvas = np.empty((h * scale, w * scale, out_tiles.shape[-1]), dtype=out_tiles.dtype)
    for t, (ys, xs, ty, tx) in zip(out_tiles, cores(windows, scale)):
        canvas[ys, xs] = t[ty, tx]
    return canvas
