"""Sparse hints sampled from dense flow: stage 2's and CMP training's input.

Counterpart of mofa_tpu/train/flow_sampler.py (the reference's
Training/train_utils/sample_flow_utils.py:10-224), kept as this package's
own host numpy + scipy copy: it runs per clip on the host, and the JAX
module cannot be imported without JAX. Strategies:

- grid:      stride = sqrt(1/bg_ratio) mesh, centred;
- watershed: Sobel edge magnitude -> binarised at 0.1 of its max ->
             euclidean distance transform -> square-footprint NMS (ks) ->
             border removed -> randomised neighbour elimination within
             (ks-1)/2;
- uniform / gradnms / single / full / specified: the reference's other
  strategies.

The `RandomState` calls come in the JAX module's order, so one seed gives
both packages the same points. Returns (sparse [h, w, 2], mask [h, w, 2])
as the reference does.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage, signal

_SOBEL = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)


def sobel_edge(data: np.ndarray) -> np.ndarray:
    """[h, w, c] -> summed per-channel Sobel gradient magnitude."""
    total = None
    for c in range(data.shape[2]):
        gx = signal.convolve2d(data[:, :, c], _SOBEL, boundary="symm", mode="same")
        gy = signal.convolve2d(data[:, :, c], _SOBEL.T, boundary="symm", mode="same")
        mag = np.sqrt(gx * gx + gy * gy)
        total = mag if total is None else total + mag
    return total


def square_nms(score: np.ndarray, ks: int) -> np.ndarray:
    """Zero out everything below the ks x ks local max."""
    if ks % 2 != 1:
        raise ValueError(f"the NMS footprint must be odd, got {ks}")
    local_max = ndimage.maximum_filter(score, footprint=np.ones((ks, ks)))
    out = score.copy()
    out[score < local_max] = 0.0
    return out


def eliminate_neighbors(rows: np.ndarray, cols: np.ndarray, d: float,
                        rng: np.random.RandomState):
    """Randomly drop one of each point pair closer than d in both axes
    (sequential pairwise pass, matching the reference's semantics)."""
    keep = np.ones(len(rows), np.bool_)
    dr = np.abs(rows[:, None] - rows[None, :])
    dc = np.abs(cols[:, None] - cols[None, :])
    close_i, close_j = np.where((dr < d) & (dc < d))
    for i, j in zip(close_i, close_j):
        if keep[i] and keep[j] and i != j:
            if rng.rand() > 0.5:
                keep[i] = False
            else:
                keep[j] = False
    return rows[keep], cols[keep]


def _grid_points(h, w, bg_ratio):
    stride = int(np.sqrt(1.0 / bg_ratio))
    start_h = int((h - h // stride * stride) / 2)
    start_w = int((w - w // stride * stride) / 2)
    mesh_h, mesh_w = np.meshgrid(np.arange(start_h, h, stride),
                                 np.arange(start_w, w, stride))
    return mesh_h.ravel(), mesh_w.ravel()


def _watershed_points(flow, ds, nms_ks, rng):
    edge = sobel_edge(flow[::ds, ::ds, :])
    edge = edge / max(edge.max(), 0.01)
    binary = (edge > 0.1).astype(np.float32)
    dist = ndimage.distance_transform_edt(1.0 - binary)
    peaks = square_nms(dist, nms_ks)
    peaks[0, :] = peaks[-1, :] = 0
    peaks[:, 0] = peaks[:, -1] = 0
    rows, cols = np.where(peaks > 0)
    rows, cols = eliminate_neighbors(rows, cols, (nms_ks - 1) / 2, rng)
    return rows * ds, cols * ds


def _gradnms_points(flow, ds, nms_ks):
    w_ds = flow.shape[1] // ds
    ks = w_ds // 20
    edge = sobel_edge(flow[::ds, ::ds, :])
    box = np.ones((ks, ks), np.float32) / (ks * ks)
    sub = np.ones((ks // 2, ks // 2), np.float32) / ((ks // 2) ** 2)
    score = signal.convolve2d(edge, box, boundary="symm", mode="same")
    subscore = signal.convolve2d(edge, sub, boundary="symm", mode="same")
    score = score / score.max() - subscore / subscore.max()
    peaks = square_nms(score, nms_ks)
    rows, cols = np.where(peaks > 0.1)
    return rows * ds, cols * ds


def flow_sampler(flow: np.ndarray, strategy=("grid",), bg_ratio=1.0 / 6400,
                 nms_ks: int = 15, max_num_guide: int = -1,
                 guidepoint=None, rng: np.random.RandomState | None = None):
    """flow [h, w, 2] -> (sparse [h, w, 2], mask [h, w, 2] int64)."""
    if rng is None:
        rng = np.random.RandomState()
    h, w = flow.shape[:2]
    ds = max(1, max(h, w) // 400)

    if "full" in strategy:
        return flow.copy(), np.ones(flow.shape, np.int64)

    rows, cols = [], []
    if "grid" in strategy:
        r, c = _grid_points(h, w, bg_ratio)
        rows.append(r), cols.append(c)
    if "uniform" in strategy:
        n = int(bg_ratio * h * w)
        rows.append(rng.randint(0, h, n)), cols.append(rng.randint(0, w, n))
    if "gradnms" in strategy:
        r, c = _gradnms_points(flow, ds, nms_ks)
        rows.append(r), cols.append(c)
    if "watershed" in strategy:
        r, c = _watershed_points(flow, ds, nms_ks, rng)
        rows.append(r), cols.append(c)
    if "single" in strategy:
        r, c = np.where((flow[:, :, 0] != 0) | (flow[:, :, 1] != 0))
        i = rng.randint(len(r))
        rows.append(r[i:i + 1]), cols.append(c[i:i + 1])
    if "specified" in strategy:
        if guidepoint is None:
            raise ValueError("the 'specified' strategy needs guidepoint")
        rows.append(guidepoint[:, 1]), cols.append(guidepoint[:, 0])

    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    if max_num_guide != -1 and len(rows) > max_num_guide:
        sel = rng.permutation(len(rows))[:max_num_guide]
        rows, cols = rows[sel], cols[sel]

    sparse = np.zeros_like(flow)
    mask = np.zeros(flow.shape, np.int64)
    sparse[rows, cols] = flow[rows, cols]
    mask[rows, cols] = 1
    return sparse, mask


def clip_sample_mask(flows: np.ndarray, rng=None) -> np.ndarray:
    """get_cmpsample_mask (Training/train_stage2.py:110-121), channel-last:
    flows [b, t, h, w, 2] -> mask [b, t, h, w, 2] sampled from each clip's
    LAST frame flow with (grid, watershed), broadcast over t."""
    b, t = flows.shape[:2]
    masks = []
    for i in range(b):
        _, m = flow_sampler(flows[i, -1], ("grid", "watershed"), rng=rng)
        masks.append(m)
    mask = np.stack(masks).astype(flows.dtype)       # [b, h, w, 2]
    return np.repeat(mask[:, None], t, axis=1)
