"""Trajectory-workload preprocessing: image sizing, brush split, drag -> flow.

Counterpart of mofa_tpu/preprocess/traj.py (the reference's Traj gradio
app, run_gradio.py):

- `preprocess_image`: shortest side -> target, centre-crop to multiples of
  64 (Pillow's bilinear resize, reproduced without PIL by
  `preprocess/image.py`);
- `divide_points_afterinterpolate`: split interpolated tracks by the motion
  brush (mask indexed [row][col] = [y][x]);
- `prepare_trajectory_flow`: PCHIP-resample the tracks to the video's
  length and rasterise sparse flow on the CMP canvas (384^2);
- `DragFlowEngine`: CMP completion on the canvas, nearest resize with
  per-axis scaling to the video's size, and the in/out-brush merge.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from mofa_tpu_torch.models.cmp.model import CMP, cmp_preprocess
from mofa_tpu_torch.ops.flow import merge_flows, rescale_flow
from mofa_tpu_torch.ops.rasterize import rasterize_trajectories
from mofa_tpu_torch.ops.trajectory import interpolate_trajectory
from mofa_tpu_torch.preprocess.image import BILINEAR, pil_resize, read_image


def preprocess_image(image, target_size: int = 512):
    """Image path or uint8 array ([H, W, 3] RGB, [H, W, 4] RGBA or [H, W]
    grey) -> (np.float32 [H, W, 3] in [0, 1], (H, W)).

    Shortest side resized to target_size (Pillow's bilinear, bit for bit),
    then centre-cropped so both sides are multiples of 64: the pixels of
    the PIL pipeline of mofa_tpu's preprocess_image. Alpha is dropped
    before the resize (that pipeline resized RGBA premultiplied, so a
    translucent image's pixels may differ; opaque ones do not)."""
    if isinstance(image, (str, os.PathLike)):
        image = read_image(os.fspath(image))
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    image = image[..., :3]
    raw_h, raw_w = image.shape[:2]
    ratio = target_size / min(raw_w, raw_h)
    new_w, new_h = round(raw_w * ratio), round(raw_h * ratio)
    image = pil_resize(image, (new_w, new_h), BILINEAR)
    crop_w, crop_h = new_w - new_w % 64, new_h - new_h % 64
    left = round((new_w - crop_w) / 2.0)
    top = round((new_h - crop_h) / 2.0)
    image = image[top:top + crop_h, left:left + crop_w]
    return image.astype(np.float32) / 255.0, (crop_h, crop_w)


def divide_points_afterinterpolate(points: np.ndarray,
                                   motion_brush_mask: np.ndarray):
    """points [K, N, 2] (x, y); mask [H, W] with 255 inside the brush.
    Returns (in_tracks, out_tracks)."""
    in_m, out_m = [], []
    for k in range(points.shape[0]):
        x, y = int(points[k, 0, 1]), int(points[k, 0, 0])
        (in_m if motion_brush_mask[x][y] == 255 else out_m).append(points[k])
    return np.array(in_m), np.array(out_m)


def prepare_trajectory_flow(tracks: Sequence[Sequence[tuple]],
                            model_length: int, height: int, width: int,
                            raster_size: int = 384):
    """User click tracks -> (sparse_flow [T-1, r, r, 2], mask [T-1, r, r]),
    r = raster_size; tracks are PCHIP-resampled to model_length and scaled
    from (height, width) to the r x r CMP canvas."""
    resized = []
    for tr in tracks:
        if len(tr) < 2:
            continue
        pts = np.asarray(interpolate_trajectory(tr, model_length), np.float64)
        pts[:, 0] *= raster_size / width
        pts[:, 1] *= raster_size / height
        resized.append(pts)
    t = model_length - 1
    if not resized:
        return (np.zeros((t, raster_size, raster_size, 2), np.float32),
                np.zeros((t, raster_size, raster_size), np.float32))
    s_flow, mask = rasterize_trajectories(np.stack(resized), t, raster_size,
                                          raster_size)
    return s_flow.astype(np.float32), mask.astype(np.float32)


class DragFlowEngine:
    """CMP sparse-to-dense completion, then resize and scale to the video."""

    def __init__(self, cmp: CMP):
        self.cmp = cmp.eval()

    @torch.no_grad()
    def get_cmp_flow(self, frames01: torch.Tensor, sparse_flow: torch.Tensor,
                     mask: torch.Tensor,
                     brush_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """frames01 [b, t, r, r, 3] in (0, 1); sparse_flow, mask
        [b, t, r, r, 2] -> dense flow [b, t, r, r, 2] (brush_mask [r, r]
        multiplies it). The CMP runs in its parameters' dtype."""
        p = next(self.cmp.parameters())
        b, t = frames01.shape[:2]
        flat = lambda x: x.reshape((b * t,) + tuple(x.shape[2:])).to(p.device, p.dtype)
        flow = self.cmp(cmp_preprocess(flat(frames01)), flat(sparse_flow), flat(mask))
        if brush_mask is not None:
            flow = flow * brush_mask.to(flow)[None, :, :, None]
        return flow.reshape((b, t) + tuple(flow.shape[1:]))

    def get_flow(self, first_frame01: torch.Tensor, sparse_flow: torch.Tensor,
                 mask: torch.Tensor, height: int, width: int,
                 brush_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """first_frame01 [b, r, r, 3]; sparse / mask [b, t, r, r, 2] ->
        the adapter's flow [b, t, height, width, 2]."""
        t = sparse_flow.shape[1]
        frames = first_frame01[:, None].expand(-1, t, -1, -1, -1)
        flow = self.get_cmp_flow(frames, sparse_flow, mask, brush_mask)
        return rescale_flow(flow, height, width)

    def get_drag_flow_with_brush(self, first_frame01, s_flow_in, mask_in,
                                 s_flow_out, mask_out, brush_mask,
                                 height: int, width: int) -> torch.Tensor:
        """In-brush and out-brush flows completed separately, then merged by
        nonzero-ness."""
        f_in = self.get_flow(first_frame01, s_flow_in, mask_in, height, width,
                             brush_mask=brush_mask)
        f_out = self.get_flow(first_frame01, s_flow_out, mask_out, height, width,
                              brush_mask=1.0 - brush_mask)
        return merge_flows(f_in, f_out)
