"""The driving-video 3DMM fit: a raw video -> the per-frame [T, 70] track.

Counterpart of mofa_tpu/preprocess/video_fit.py (the reference's
sadtalker_video2pose preprocessing):

- `read_video_frames`: cv2 decode, RGB (extract_kp_videos_safe.py:96-108);
- `detect_video_boxes`: BlazeFace (models/mp_face.py) per frame, the box
  padded for the FAN crop; a frame without a detection reuses the last box
  (the first such frame the whole image), as the reference reuses the last
  keypoints (extract_kp_videos_safe.py:52-55);
- `video_keypoints`: every crop through the AWing FAN in one batch
  (models/face_alignment.py), 98 -> 68 points, shifted back;
- `smooth_3dmm_params`: the per-column 'same' moving average
  (preprocess_fromvideo.py:23-37);
- `fit_video_coeffs`: each frame aligned on the host (`align_img`), the
  T 224^2 crops through ReconNet in one batch -> exp(64) + angle(3) +
  trans(3), the pose smoothed;
- `fit_driving_video`: the chain, frames resized to pic_size squares by
  Pillow's BILINEAR as the reference's 'resize' mode does, reproduced
  without PIL (`preprocess/image.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mofa_tpu_torch.models.audio.face3d_fit import ReconNet, align_img
from mofa_tpu_torch.models.face_alignment import (FAN, get_landmarks_batch,
                                                  landmark_98_to_68)
from mofa_tpu_torch.models.mp_face import detect_face
from mofa_tpu_torch.preprocess.image import BILINEAR, pil_resize


def read_video_frames(path: str, max_frames: Optional[int] = None, stride: int = 1):
    """A video file -> ([T, H, W, 3] uint8 RGB, fps)."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    frames = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            frames.append(frame[..., ::-1].copy())   # BGR -> RGB
        i += 1
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames), float(fps)


def detect_video_boxes(frames: np.ndarray, detector, pad: float = 0.15) -> np.ndarray:
    """Per-frame BlazeFace box in pixels [T, 4] (x1, y1, x2, y2), padded by
    `pad` x the box size for the FAN crop."""
    t, h, w = frames.shape[:3]
    boxes = np.zeros((t, 4), np.float32)
    last = np.array([0, 0, w, h], np.float32)
    for i in range(t):
        det = detect_face(detector, frames[i].astype(np.float32) / 255.0)
        if det is not None:
            b = det[0] * np.array([w, h, w, h], np.float32)
            dx, dy = (b[2] - b[0]) * pad, (b[3] - b[1]) * pad
            last = np.array([max(b[0] - dx, 0), max(b[1] - dy, 0),
                             min(b[2] + dx, w), min(b[3] + dy, h)], np.float32)
        boxes[i] = last
    return boxes


def video_keypoints(frames: np.ndarray, boxes: np.ndarray, fan: FAN) -> np.ndarray:
    """[T, H, W, 3] + boxes -> [T, 68, 2] keypoints (y down, frame pixels):
    each crop, the FAN over all of them in one batch, 98 -> 68, shifted
    back (extract_kp_videos_safe.py:64-77)."""
    crops = []
    for f, b in zip(frames, boxes.astype(np.int32)):
        x1, y1, x2, y2 = b
        crops.append(f[y1:max(y2, y1 + 2), x1:max(x2, x1 + 2)])
    lm98 = get_landmarks_batch(fan, crops)
    kp = np.stack([landmark_98_to_68(lm) for lm in lm98])
    kp[:, :, 0] += boxes[:, None, 0]
    kp[:, :, 1] += boxes[:, None, 1]
    return kp.astype(np.float32)


def smooth_3dmm_params(params: np.ndarray, window_size: int = 3):
    """preprocess_fromvideo.py:23-37: each column's 'same' moving average."""
    out = np.zeros_like(params)
    window = np.ones(int(window_size)) / float(window_size)
    for i in range(params.shape[1]):
        out[:, i] = np.convolve(params[:, i], window, "same")
    return out


@torch.no_grad()
def fit_video_coeffs(frames: np.ndarray, kp68: np.ndarray, recon: ReconNet,
                     lm3d_std: np.ndarray, smooth_pose: bool = True):
    """T frames (uint8 [T, H, W, 3]) + keypoints (y down) -> (coeff_3dmm
    [T, 70], full_3dmm of the first frame [1, 257], its trans_params [8]).
    The reference fits frame by frame (preprocess_fromvideo.py:150-186);
    here the alignment stays on the host and ReconNet takes the T crops as
    one batch on its device."""
    ims, tps = [], []
    for img, lm in zip(frames, kp68):
        h = img.shape[0]
        lm_up = lm.astype(np.float32).copy()
        lm_up[:, -1] = h - 1 - lm_up[:, -1]        # y down -> y up
        tp, im224, _ = align_img(np.asarray(img), lm_up, lm3d_std)
        ims.append(im224.astype(np.float32) / 255.0)
        tps.append(np.array([float(np.asarray(x).reshape(-1)[0]) for x in tp], np.float32))
    dev = next(recon.parameters()).device
    batch = torch.from_numpy(np.ascontiguousarray(np.stack(ims).transpose(0, 3, 1, 2)))
    full = recon(batch.to(dev)).cpu().numpy()                 # [T, 257]
    coeff70 = np.concatenate([full[:, 80:144], full[:, 224:227], full[:, 254:257]], axis=1)
    if smooth_pose:
        coeff70[:, -6:] = smooth_3dmm_params(coeff70[:, -6:], window_size=3)
    return coeff70, full[:1], tps[0]


def fit_driving_video(video_path: str, detector, fan: FAN, recon: ReconNet,
                      lm3d_std: np.ndarray, pic_size: int = 256,
                      max_frames: Optional[int] = None,
                      smooth_pose: bool = True) -> Tuple[np.ndarray, float]:
    """A driving video -> (coeff_3dmm [T, 70], fps): the reference's
    automatic per-frame chain (inference.py:79-92 ->
    preprocess_fromvideo.generate with if_smooth=True)."""
    frames, fps = read_video_frames(video_path, max_frames=max_frames)
    frames = np.stack([pil_resize(f, (pic_size, pic_size), BILINEAR) for f in frames])
    boxes = detect_video_boxes(frames, detector)
    kp68 = video_keypoints(frames, boxes, fan)
    coeff70, _, _ = fit_video_coeffs(frames, kp68, recon, lm3d_std, smooth_pose=smooth_pose)
    return coeff70, fps
