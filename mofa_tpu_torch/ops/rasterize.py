"""Sparse-flow rasterisation of drag tracks and landmarks (host-side numpy).

Counterpart of mofa_tpu/ops/rasterize.py, copied:

- `rasterize_trajectories`: the reference's
  `get_sparseflow_and_mask_forward`. Each track paints a single pixel at
  its integer start with the integer displacement end - start, per frame;
  overlapping tracks SUM (both the flow and the mask).
- `landmarks_to_sparse_flow`: the Hybrid app's `get_sparse_flow`. Each
  landmark's displacement from frame 0 is scattered at its frame-0 pixel;
  where two landmarks share a pixel the later one wins (numpy fancy-index
  assignment; a torch `index_put_` leaves duplicates unordered on CUDA, so
  this stays on the host).
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


def landmarks_to_sparse_flow(landmarks: np.ndarray, h: int, w: int):
    """landmarks: [b, t, K, 2] (x, y) pixel coords.

    Returns (sparse_flow [b, t-1, 2, h, w], mask [b, t-1, 2, h, w]) with
    channel order (dx, dy); displacement of landmark k from frame 0 scattered
    at its frame-0 position (row = y clipped to h - 1, col = x clipped to w - 1).
    """
    lm = np.asarray(landmarks, dtype=np.float32)
    b, t, K, _ = lm.shape
    flow = lm[:, 1:] - lm[:, 0:1]                       # [b, t-1, K, 2] (dx, dy)
    anchors = np.broadcast_to(lm[:, 0:1], (b, t - 1, K, 2))
    rows = np.clip(anchors[..., 1].astype(np.int64), 0, h - 1)
    cols = np.clip(anchors[..., 0].astype(np.int64), 0, w - 1)

    sparse = np.zeros((b, t - 1, h, w, 2), dtype=np.float32)
    mask = np.zeros((b, t - 1, h, w), dtype=np.float32)
    bi = np.arange(b)[:, None, None]
    ti = np.arange(t - 1)[None, :, None]
    sparse[bi, ti, rows, cols] = flow                   # assignment (last wins)
    mask[bi, ti, rows, cols] = 1.0
    sparse = np.moveaxis(sparse, -1, 2)                 # [b, t-1, 2, h, w]
    mask = np.repeat(mask[:, :, None], 2, axis=2)
    return sparse, mask
