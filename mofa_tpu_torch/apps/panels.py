"""Side-by-side diagnostic panel videos (numpy; cv2 imported when used).

Counterpart of mofa_tpu/apps/panels.py: the keypoint CLI's five-column
video [first frame | flow | landmark raster | output with landmark dots |
output] (MOFA-Video-Keypoint mofa_keypoint.py:369-408) and the hybrid
app's composite, which adds the drag-flow column
(run_gradio_audio_driven.py:485-533). Inputs are [0, 1] float RGB, except
landmarks (pixel coordinates).
"""

from __future__ import annotations

import numpy as np

from mofa_tpu_torch.ops.flow_viz import flow_to_image


def overlay_landmarks(frames01: np.ndarray, landmarks: np.ndarray) -> np.ndarray:
    """Red dots of radius 2 at each landmark. frames01 [T, H, W, 3] in
    [0, 1]; landmarks [T, K, 2] (x, y) pixels."""
    import cv2

    out = (np.asarray(frames01) * 255).clip(0, 255).astype(np.uint8).copy()
    t = min(out.shape[0], landmarks.shape[0])
    for k in range(t):
        for x, y in landmarks[k]:
            cv2.circle(out[k], (int(x), int(y)), 2, (255, 0, 0), -1)
    return out.astype(np.float32) / 255.0


def flow_video(flow: np.ndarray) -> np.ndarray:
    """[T-1, H, W, 2] -> [T, H, W, 3] in [0, 1]: Middlebury colours with a
    white frame first."""
    flow = np.asarray(flow, np.float32)
    vizs = [flow_to_image(f) for f in flow]
    vizs = [np.full_like(vizs[-1], 255)] + vizs
    return np.stack(vizs).astype(np.float32) / 255.0


def compose_panels(columns) -> np.ndarray:
    """Concatenate [T, H, W, 3] float columns along the width; a single
    image ([H, W, 3]) is repeated over time."""
    columns = [np.asarray(c, np.float32) for c in columns]
    t = max(c.shape[0] for c in columns if c.ndim == 4)
    cols = []
    for c in columns:
        if c.ndim == 3:
            c = np.repeat(c[None], t, axis=0)
        if c.shape[0] != t:
            raise ValueError(f"a column has {c.shape[0]} frames, the video {t}")
        cols.append(c)
    return np.concatenate(cols, axis=2)


def keypoint_panel(first_frame01, controlnet_flow, ldmk_imgs01, frames01,
                   landmarks) -> np.ndarray:
    """Columns: first frame, flow, landmark raster, output with landmark
    dots, output."""
    return compose_panels([
        first_frame01,
        flow_video(controlnet_flow),
        ldmk_imgs01,
        overlay_landmarks(frames01, landmarks),
        frames01,
    ])


def hybrid_panel(first_frame01, drag_flow, face_flow, ldmk_imgs01, frames01,
                 landmarks, hint01=None) -> np.ndarray:
    """Columns: first frame, [hint], drag flow, face flow, landmark raster,
    output with landmark dots, output."""
    cols = [first_frame01]
    if hint01 is not None:
        cols.append(hint01)
    cols += [
        flow_video(drag_flow),
        flow_video(face_flow),
        ldmk_imgs01,
        overlay_landmarks(frames01, landmarks),
        frames01,
    ]
    return compose_panels(cols)
