"""Landmark-workload preprocessing: the landmark raster and landmark -> flow.

Counterpart of mofa_tpu/preprocess/landmark.py (the reference's Hybrid
gradio app, run_gradio_audio_driven.py):

- `PARTS` / `draw_landmarks`: the 15-part connectivity of the 68 points
  and its colours, drawn as 2-pixel cv2 polylines (cv2 imported when
  used); `draw_landmark_sequence` draws at 320^2 and resizes bilinearly;
- `prepare_landmark_flow`: landmark sequence -> sparse flow and mask at
  the video's size and on the 384^2 CMP canvas (sample_inputs_face);
- `LandmarkFlowEngine.get_cmp_flow_landmarks`: CMP completion of every
  frame in one batched forward (the reference loops over the frames),
  then the flow rescaled to the video's size; `flow_from_landmarks`, the
  whole chain from a landmark track (the hybrid and keypoint apps').
"""

from __future__ import annotations

import numpy as np
import torch

from mofa_tpu_torch.ops.flow import rescale_flow
from mofa_tpu_torch.ops.rasterize import landmarks_to_sparse_flow
from mofa_tpu_torch.ops.resize import resize_nhwc
from mofa_tpu_torch.preprocess.traj import DragFlowEngine

CANVAS = 384               # the CMP canvas

PARTS = [
    ("FACE", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17], (10, 200, 10)),
    ("LEFT_EYE", [43, 44, 45, 46, 47, 48, 43], (180, 200, 10)),
    ("LEFT_EYEBROW", [23, 24, 25, 26, 27], (180, 220, 10)),
    ("RIGHT_EYE", [37, 38, 39, 40, 41, 42, 37], (10, 200, 180)),
    ("RIGHT_EYEBROW", [18, 19, 20, 21, 22], (10, 220, 180)),
    ("NOSE_UP", [28, 29, 30, 31], (10, 200, 250)),
    ("NOSE_DOWN", [32, 33, 34, 35, 36], (250, 200, 10)),
    ("LIPS_OUTER_BOTTOM_LEFT", [55, 56, 57, 58], (10, 180, 20)),
    ("LIPS_OUTER_BOTTOM_RIGHT", [49, 60, 59, 58], (20, 10, 180)),
    ("LIPS_INNER_BOTTOM_LEFT", [65, 66, 67], (100, 100, 30)),
    ("LIPS_INNER_BOTTOM_RIGHT", [61, 68, 67], (100, 150, 50)),
    ("LIPS_OUTER_TOP_LEFT", [52, 53, 54, 55], (20, 80, 100)),
    ("LIPS_OUTER_TOP_RIGHT", [52, 51, 50, 49], (80, 100, 20)),
    ("LIPS_INNER_TOP_LEFT", [63, 64, 65], (120, 100, 200)),
    ("LIPS_INNER_TOP_RIGHT", [63, 62, 61], (150, 120, 100)),
]


def draw_landmarks(keypoints: np.ndarray, h: int, w: int) -> np.ndarray:
    """68 (x, y) points -> [h, w, 3] float raster (0-255 colour values),
    2-pixel cv2 lines along each facial part."""
    import cv2
    image = np.zeros((h, w, 3))
    for _name, indices, color in PARTS:
        pts = keypoints[np.asarray(indices) - 1]
        for i in range(len(indices) - 1):
            x1, y1 = pts[i]
            x2, y2 = pts[i + 1]
            cv2.line(image, (int(x1), int(y1)), (int(x2), int(y2)), color,
                     thickness=2)
    return image


def draw_landmark_sequence(landmarks: np.ndarray, h: int, w: int,
                           raster: int = 320) -> np.ndarray:
    """[T, 68, 2] -> [T, h, w, 3] in [0, 1]: drawn at raster^2, then
    bilinearly resized to (h, w)."""
    import cv2
    t = landmarks.shape[0]
    out = np.zeros((t, h, w, 3), np.float32)
    for i in range(t):
        pts = landmarks[i].astype(np.float64).copy()
        pts[:, 0] *= raster / w
        pts[:, 1] *= raster / h
        img = draw_landmarks(pts, raster, raster)
        out[i] = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR) / 255.0
    return out


def prepare_landmark_flow(landmarks: np.ndarray, h: int, w: int) -> dict:
    """landmarks [b, t, 68, 2] (x, y) at the video's size (h, w) -> channel-
    last arrays: sparse_flow and mask [b, t-1, h, w, 2], their copies on the
    CMP canvas, sparse_flow_384 and mask_384 [b, t-1, 384, 384, 2], and the
    landmarks scaled to it, landmarks_384 [b, t, 68, 2]."""
    def to_last(x):  # [b, t-1, 2, h, w] -> [b, t-1, h, w, 2]
        return np.moveaxis(x, 2, -1)

    sparse, mask = landmarks_to_sparse_flow(landmarks, h, w)
    out = {"sparse_flow": to_last(sparse), "mask": to_last(mask)}
    if (h, w) != (CANVAS, CANVAS):
        lm384 = landmarks.astype(np.float64).copy()
        lm384[..., 0] *= CANVAS / w
        lm384[..., 1] *= CANVAS / h
        s384, m384 = landmarks_to_sparse_flow(lm384, CANVAS, CANVAS)
        out["landmarks_384"] = lm384
        out["sparse_flow_384"] = to_last(s384)
        out["mask_384"] = to_last(m384)
    else:
        out["landmarks_384"] = landmarks
        out["sparse_flow_384"] = out["sparse_flow"]
        out["mask_384"] = out["mask"]
    return out


class LandmarkFlowEngine(DragFlowEngine):
    """CMP completion of landmark-driven sparse flow, batched over frames."""

    @torch.no_grad()
    def get_cmp_flow_landmarks(self, frames01_384: torch.Tensor,
                               sparse_384: torch.Tensor, mask_384: torch.Tensor,
                               height: int, width: int) -> torch.Tensor:
        """frames01_384 [b, t, 384, 384, 3]; sparse / mask [b, t, 384, 384, 2]
        -> dense flow [b, t, height, width, 2]."""
        flow = self.get_cmp_flow(frames01_384, sparse_384, mask_384)
        return rescale_flow(flow, height, width)

    def flow_from_landmarks(self, image01: torch.Tensor, landmarks: np.ndarray):
        """image01 [1, H, W, 3] on the CMP's device; landmarks [T, 68, 2]
        (x, y) pixels -> (the adapter's flow [1, T-1, H, W, 2], the landmark
        frames [T, H, W, 3] in [0, 1] as numpy): the landmark scatter on the
        384^2 canvas completed over the T-1 frames in one batch, and the
        raster."""
        dev = image01.device
        h, w = image01.shape[1:3]
        t = landmarks.shape[0]
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        flow_in = prepare_landmark_flow(landmarks[None], h, w)
        frames = resize_nhwc(image01, (CANVAS, CANVAS))[:, None].expand(-1, t - 1, -1, -1, -1)
        flow = self.get_cmp_flow_landmarks(frames, to_dev(flow_in["sparse_flow_384"]),
                                           to_dev(flow_in["mask_384"]), h, w)
        return flow, draw_landmark_sequence(landmarks, h, w)
