"""Sparse-flow rasterisation of drag tracks (host-side numpy).

Counterpart of mofa_tpu/ops/rasterize.py::rasterize_trajectories, copied:
the reference's `get_sparseflow_and_mask_forward`. Each track paints a
single pixel at its integer start with the integer displacement end -
start, per frame; overlapping tracks SUM (both the flow and the mask).
"""

from __future__ import annotations

import numpy as np


def rasterize_trajectories(tracks: np.ndarray, n_steps: int, H: int, W: int,
                           is_backward_flow: bool = False):
    """tracks: [K, n_steps+1, 2] interpolated (x, y) points.

    Returns (sparse_flow [n_steps, H, W, 2], mask [n_steps, H, W]).
    """
    tracks = np.asarray(tracks, dtype=np.float64)
    K = tracks.shape[0]
    s_flow = np.zeros((n_steps, H, W, 2), dtype=np.float64)
    mask = np.zeros((n_steps, H, W), dtype=np.float64)
    sign = -1.0 if is_backward_flow else 1.0
    for k in range(K):
        start = tracks[k, 0]
        col, row = int(start[0]), int(start[1])
        for i in range(n_steps):
            end = tracks[k, 1 + i]
            flow = np.int64(end - start) * sign
            s_flow[i, row, col] += flow
            mask[i, row, col] += 1
    return s_flow, mask
