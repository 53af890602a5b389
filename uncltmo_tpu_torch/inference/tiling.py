"""Tile-grid planning and overlap blend weights for big-image inference.

The reference processes large images with a Python double loop of 256x256
patches, 64-px overlap, and a *sequential* linear cross-fade into an
accumulator (`utils/model_save_util.py:409-486`).  Because that process is
linear in the per-tile network outputs, it is equivalent to a fixed
partition-of-unity: output = sum_t w_t * net(tile_t) with per-tile weight
masks w_t that sum to 1 everywhere.  We recover the *exact* reference
weights by symbolically simulating its 1-D update rules once per axis
length on the host (cheap, cached), then run the tiles as batched forwards
and blend them with these weights on the device.  numpy only (a copy of the
JAX package's planner, so the port needs nothing of that package).

Axis semantics reproduced (for L > tile):
  * regular tile origins (tile - overlap) * i while (tile*(i+1) -
    overlap*i) < L, then one final tile anchored at L - tile;
  * cross-fade ramps divide by (overlap - 1) — the reference's
    "off-by-one" denominator (`model_save_util.py:434`) — so adjacent
    weights still sum exactly to 1;
  * the final tile blends over last_range = prev_end - (L - tile) pixels.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np


class AxisPlan(NamedTuple):
    origins: np.ndarray   # (n_tiles,) int32 tile start offsets
    weights: np.ndarray   # (n_tiles, tile) float32, partition of unity


@functools.lru_cache(maxsize=None)
def axis_plan(length: int, tile: int = 256, overlap: int = 64) -> AxisPlan:
    if length < tile:
        raise ValueError(f"axis length {length} < tile {tile}; pad first")
    if length == tile:
        return AxisPlan(np.zeros((1,), np.int32),
                        np.ones((1, tile), np.float32))

    # regular tiles from the reference while-loop
    origins: List[int] = []
    h_index = 1
    while tile * h_index - overlap * (h_index - 1) < length:
        origins.append((tile - overlap) * (h_index - 1))
        h_index += 1
    n = len(origins)
    prev_end = origins[-1] + tile
    origins.append(length - tile)

    # symbolic simulation of the sequential cross-fade: coef[t, g] is the
    # final weight of tile t at global position g
    coef = np.zeros((n + 1, length), np.float64)
    coef[0, 0:tile] = 1.0
    for i in range(1, n):
        s = origins[i]
        j = np.arange(overlap, dtype=np.float64)
        coef[:, s:s + overlap] *= (overlap - 1 - j) / (overlap - 1)
        coef[i, s:s + overlap] += j / (overlap - 1)
        coef[:, s + overlap:s + tile] = 0.0
        coef[i, s + overlap:s + tile] = 1.0
    # final tile anchored at length - tile
    s = origins[-1]
    last_range = prev_end - s
    if last_range >= 2:
        j = np.arange(last_range, dtype=np.float64)
        coef[:, s:s + last_range] *= (last_range - 1 - j) / (last_range - 1)
        coef[n, s:s + last_range] += j / (last_range - 1)
    # beyond prev_end the final tile simply overwrites
    coef[:, prev_end:] = 0.0
    coef[n, prev_end:] = 1.0

    weights = np.zeros((n + 1, tile), np.float32)
    for t, o in enumerate(origins):
        weights[t] = coef[t, o:o + tile]
    return AxisPlan(np.asarray(origins, np.int32), weights)
