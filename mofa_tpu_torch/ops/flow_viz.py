"""Middlebury optical-flow visualisation (flow -> RGB) and .flo files, numpy.

Counterpart of mofa_tpu/ops/flow_viz.py, copied (the reference's
utils/flow_viz.py `flow_to_image`): the Baker et al. colour wheel,
normalised by the largest radius; `read_flo` / `write_flo` are the
Middlebury .flo format (cmp/utils/flowlib.py).
"""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_COLORWHEEL = _make_colorwheel()


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray, convert_to_bgr=False) -> np.ndarray:
    flow_image = np.zeros((u.shape[0], u.shape[1], 3), np.uint8)
    ncols = _COLORWHEEL.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    for i in range(3):
        tmp = _COLORWHEEL[:, i]
        col0 = tmp[k0] / 255.0
        col1 = tmp[k1] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        ch = 2 - i if convert_to_bgr else i
        flow_image[:, :, ch] = np.floor(255 * col)
    return flow_image


def flow_to_image(flow_uv: np.ndarray, clip_flow=None, convert_to_bgr=False) -> np.ndarray:
    """flow_uv: [H, W, 2] -> uint8 RGB [H, W, 3]."""
    if flow_uv.ndim != 3 or flow_uv.shape[2] != 2:
        raise ValueError(f"flow_to_image takes [H, W, 2], got {flow_uv.shape}")
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[:, :, 0], flow_uv[:, :, 1]
    rad_max = np.max(np.sqrt(u**2 + v**2))
    eps = 1e-5
    u = u / (rad_max + eps)
    v = v / (rad_max + eps)
    return flow_uv_to_colors(u, v, convert_to_bgr)


# ----------------------------------------------------------- .flo file I/O

_FLO_MAGIC = 202021.25


def read_flo(path: str):
    """Middlebury .flo reader (cmp/utils/flowlib.py read_flow)."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if abs(magic - _FLO_MAGIC) >= 1e-3:
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(flow, path: str):
    """Middlebury .flo writer (cmp/utils/flowlib.py write_flow)."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(_FLO_MAGIC).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.tobytes())
