"""Post-processing of rendered face crops: the face enhancer and the paste-back.

Counterpart of mofa_tpu/preprocess/enhance.py (the reference's
sadtalker_audio2pose/src/utils/paste_pic.py and face_enhancer.py):

- `crop_box` / `paste_back_frames` (paste_pic.py:38-66): each generated
  crop frame resized (cv2) to the original crop box and Poisson-blended
  (`cv2.seamlessClone`, NORMAL_CLONE) into the full image at the box's
  centre. crop_info is CropAndExtract's 3-tuple ((r_w, r_h), (clx, cly,
  crx, cry), (lx, ly, rx, ry)).
- `enhance_frames` (face_enhancer.py:42-123), by method:
    "none"    the frames as they are (the reference's default);
    "gfpgan"  GFPGAN v1 clean (models/gfpgan.py) on the card, in the
              aligned-crop mode (`GFPGANer(has_aligned=True)`); `ckpt` is
              GFPGANv1.4.pth (with `tiny`, seeded random weights without one);
    "npz"     frames restored offline by any enhancer, {"frames": uint8
              [T, H, W, 3] RGB}, shape-checked.
"""

from __future__ import annotations

import numpy as np


def crop_box(crop_info, extended_crop: bool = False):
    """The original image's box (ox1, oy1, ox2, oy2) the paste targets
    (paste_pic.py:44-55)."""
    if len(crop_info) != 3:
        raise ValueError("crop_info must be ((rw,rh),(clx,cly,crx,cry),(lx,ly,rx,ry))")
    _, (clx, cly, crx, cry), (lx, ly, rx, ry) = crop_info
    lx, ly, rx, ry = int(lx), int(ly), int(rx), int(ry)
    if extended_crop:
        return int(clx), int(cly), int(crx), int(cry)
    return int(clx) + lx, int(cly) + ly, int(clx) + rx, int(cly) + ry


def paste_back_frames(crop_frames: np.ndarray, full_img: np.ndarray, crop_info,
                      extended_crop: bool = False) -> np.ndarray:
    """crop_frames [T, h, w, 3] uint8 RGB; full_img [H, W, 3] uint8 RGB ->
    [T, H, W, 3] uint8, each frame seamless-cloned into full_img."""
    import cv2

    ox1, oy1, ox2, oy2 = crop_box(crop_info, extended_crop)
    h, w = full_img.shape[:2]
    ox1, ox2 = np.clip([ox1, ox2], 0, w).tolist()
    oy1, oy2 = np.clip([oy1, oy2], 0, h).tolist()
    if ox2 <= ox1 or oy2 <= oy1:
        raise ValueError(f"empty paste box {(ox1, oy1, ox2, oy2)}")
    location = ((ox1 + ox2) // 2, (oy1 + oy2) // 2)
    out = []
    for frame in np.asarray(crop_frames, np.uint8):
        p = cv2.resize(frame, (ox2 - ox1, oy2 - oy1))
        mask = 255 * np.ones(p.shape, p.dtype)
        out.append(cv2.seamlessClone(p, full_img, mask, location, cv2.NORMAL_CLONE))
    return np.stack(out)


def enhance_frames(frames: np.ndarray, method: str = "none", npz_path: str | None = None,
                   ckpt: str | None = None, tiny: bool = False,
                   device="cuda") -> np.ndarray:
    """The face-enhancer stage: frames [T, H, W, 3] uint8 RGB -> the same
    shape and dtype (the reference resizes GFPGAN's upscale=2 output back,
    so the shape holds end to end)."""
    frames = np.asarray(frames)
    if method in ("none", None, ""):
        return frames
    if method == "gfpgan":
        from mofa_tpu_torch.models.gfpgan import enhance_aligned, load_gfpgan
        if not (ckpt or tiny):
            raise ValueError("method='gfpgan' needs ckpt=GFPGANv1.4.pth")
        model = load_gfpgan(ckpt, device, tiny=tiny)
        out = enhance_aligned(model, frames.astype(np.float32) / 255.0)
        return (out * 255.0 + 0.5).astype(np.uint8)
    if method == "npz":
        if not npz_path:
            raise ValueError("method='npz' needs npz_path ({'frames': uint8 [T,H,W,3]})")
        enhanced = np.asarray(np.load(npz_path)["frames"])
        if enhanced.shape[0] != frames.shape[0]:
            raise ValueError(f"enhanced npz has {enhanced.shape[0]} frames, "
                             f"expected {frames.shape[0]}")
        if enhanced.ndim != 4 or enhanced.shape[-1] != 3:
            raise ValueError(f"bad enhanced frames shape {enhanced.shape}")
        return enhanced.astype(np.uint8)
    raise ValueError(f"unknown enhancer '{method}'")
