"""Model loading for the apps: the CMP, the diffusion bundle, video files.

Counterpart of the parts of mofa_tpu/apps/loaders.py that the trajectory
app needs:

- `load_cmp`: the reference's `ckpt_iter_42000.pth.tar`, whose state dict
  carries this package's CMP names, loaded with `strict=True`; seeded
  random weights when no file is given;
- `load_bundle`: the SVD-XT bundle with seeded random weights (loading the
  diffusers safetensors tree into the port waits for those files);
- `write_video`: gif through PIL, mp4 through cv2, each imported when used.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
from mofa_tpu_torch.models.cmp.model import CMP, CMPConfig
from mofa_tpu_torch.models.svd_unet import SVDUNetConfig
from mofa_tpu_torch.models.vae import VAEConfig
from mofa_tpu_torch.pipelines.common import ModelBundle, init_random_

_WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin")


def init_random_cmp_(cmp: CMP, generator: torch.Generator) -> CMP:
    """Seeded random parameters (`init_random_`) and BatchNorm statistics
    (mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5)), so every BatchNorm does work."""
    init_random_(cmp, generator)
    with torch.no_grad():
        for m in cmp.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)
    return cmp


def cmp_state_dict(checkpoint: dict) -> dict:
    """The CMP weights of a reference checkpoint: the state dict under
    "state_dict" (or "model" / "module"), `module.` prefixes stripped,
    BatchNorm's `num_batches_tracked` counters dropped."""
    sd = checkpoint
    for key in ("state_dict", "model", "module"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
    return {re.sub(r"^(module\.)+", "", k): v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def load_cmp(ckpt_path: Optional[str] = None, device="cuda",
             dtype: torch.dtype = torch.float32, cfg: CMPConfig = CMPConfig(),
             seed: int = 0) -> CMP:
    """The CMP in eval mode on `device`, in `dtype`."""
    with torch.device(device):
        cmp = CMP(cfg)
    if ckpt_path and os.path.exists(ckpt_path):
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        cmp.load_state_dict(cmp_state_dict(ckpt), strict=True)
    else:
        if ckpt_path:
            print(f"[loaders] CMP: no checkpoint at {ckpt_path!r}; random init")
        init_random_cmp_(cmp, torch.Generator(device=device).manual_seed(seed))
    return cmp.to(dtype).eval().requires_grad_(False)


def _find_weights(subdir: Optional[str]) -> Optional[str]:
    for name in _WEIGHT_FILES if subdir else ():
        path = os.path.join(subdir, name)
        if os.path.exists(path):
            return path
    return None


def load_bundle(svd_dir: Optional[str] = None,
                controlnet_dir: Optional[str] = None, device="cuda",
                dtype: torch.dtype = torch.float32,
                unet_cfg: SVDUNetConfig = SVDUNetConfig(),
                vae_cfg: VAEConfig = VAEConfig(),
                clip_cfg: CLIPVisionConfig = CLIPVisionConfig(),
                seed: int = 0) -> ModelBundle:
    """The SVD UNet, MOFA adapter, VAE and CLIP vision encoder on `device`
    in `dtype`, with seeded random weights. A directory that holds weight
    files raises: loading them into the port is not written yet."""
    for desc, subdir in (("SVD UNet", svd_dir and os.path.join(svd_dir, "unet")),
                         ("VAE", svd_dir and os.path.join(svd_dir, "vae")),
                         ("CLIP vision",
                          svd_dir and os.path.join(svd_dir, "image_encoder")),
                         ("MOFA-Adapter", controlnet_dir)):
        found = _find_weights(subdir)
        if found:
            raise NotImplementedError(f"{desc}: loading {found} into the port is "
                                      "not written yet")
        print(f"[loaders] {desc}: no weights at {subdir!r}; random init")
    return ModelBundle.init_random(device, torch.Generator(device=device).manual_seed(seed),
                                   unet_cfg, vae_cfg, clip_cfg, dtype=dtype)


def write_video(frames01, path: str, fps: int = 7) -> None:
    """[T, H, W, 3] float in [0, 1] (numpy or tensor) -> mp4 (cv2) or gif (PIL)."""
    if torch.is_tensor(frames01):
        frames01 = frames01.detach().float().cpu().numpy()
    frames = (np.asarray(frames01) * 255).clip(0, 255).astype("uint8")
    if path.endswith(".gif"):
        from PIL import Image
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return
    import cv2
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
