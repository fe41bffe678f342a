"""Model loading for the apps: the CMP, the diffusion bundle, video files.

Counterpart of the parts of mofa_tpu/apps/loaders.py that the trajectory
app needs:

- `load_cmp`: the reference's `ckpt_iter_42000.pth.tar`, whose state dict
  carries this package's CMP names, loaded with `strict=True`; seeded
  random weights when no file is given;
- `load_bundle`: the SVD-XT bundle, each part from its reference-format
  weight file (diffusers / transformers `.safetensors` or `.bin`) with
  `strict=True`, or with seeded random weights where none is found;
- `write_video`: gif through PIL, mp4 through cv2, each imported when used,
  or the raw uint8 frames as .npy;
- `start_frame_parallel` / `share_bundle`: the apps' `--frame_parallel`
  (one process per device, under torchrun or alone; only the main rank
  prints, `core.mesh.is_main_rank`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from mofa_tpu_torch.core.mesh import is_main_rank
from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
from mofa_tpu_torch.models.cmp.model import CMP, CMPConfig
from mofa_tpu_torch.models.svd_unet import SVDUNetConfig
from mofa_tpu_torch.models.vae import VAEConfig
from mofa_tpu_torch.models.weights import (load_safetensors,
                                           load_torch_checkpoint,
                                           unwrap_state_dict)
from mofa_tpu_torch.parallel.activation import broadcast_module_
from mofa_tpu_torch.pipelines.common import ModelBundle, init_random_

_WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.bin")


def init_random_cmp_(cmp: CMP, generator: torch.Generator) -> CMP:
    """Seeded random parameters (`init_random_`) and BatchNorm statistics
    (mean ~ N(0, 0.1^2), var ~ U(0.5, 1.5)), so every BatchNorm (2-D or
    3-D) does work."""
    init_random_(cmp, generator)
    with torch.no_grad():
        for m in cmp.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)
    return cmp


def cmp_state_dict(checkpoint: dict) -> dict:
    """The CMP weights of a reference checkpoint: the state dict under
    "state_dict" (or "model" / "module"), `module.` prefixes stripped,
    BatchNorm's `num_batches_tracked` counters dropped."""
    return {k: v for k, v in unwrap_state_dict(checkpoint).items()
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
            _say(f"[loaders] CMP: no checkpoint at {ckpt_path!r}; random init")
        init_random_cmp_(cmp, torch.Generator(device=device).manual_seed(seed))
    return cmp.to(dtype).eval().requires_grad_(False)


def _find_weights(subdir: Optional[str]) -> Optional[str]:
    for name in _WEIGHT_FILES if subdir else ():
        path = os.path.join(subdir, name)
        if os.path.exists(path):
            return path
    return None


# Keys a reference file holds that no module of the port has, by part:
# transformers' CLIP vision files carry the `position_ids` buffer
# (0 .. npos-1; the port adds the position table without indexing it).
_EXTRA_KEYS = {"clip": ("vision_model.embeddings.position_ids",)}
# Keys dropped only where the target module lacks them: diffusers builds the
# temporal decoder's mid-block attention even at layers_per_block = 1, where
# its forward never runs it (mofa_tpu's convert_vae_state_dict drops it for
# its module, which omits it). The port's decoder keeps the module, so its
# keys load as they are.
_DEAD_PREFIXES = {"vae": ("decoder.mid_block.attentions.",)}


def part_state_dict(part: str, path: str, module: nn.Module) -> dict:
    """The state dict in weight file `path` for bundle part `part`, with
    the named reference keys that `module` has no place for removed."""
    sd = (load_safetensors(path) if path.endswith(".safetensors")
          else load_torch_checkpoint(path))
    for key in _EXTRA_KEYS.get(part, ()):
        sd.pop(key, None)
    own = module.state_dict().keys()
    for prefix in _DEAD_PREFIXES.get(part, ()):
        if not any(k.startswith(prefix) for k in own):
            sd = {k: v for k, v in sd.items() if not k.startswith(prefix)}
    return sd


def load_bundle(svd_dir: Optional[str] = None,
                controlnet_dir: Optional[str] = None, device="cuda",
                dtype: torch.dtype = torch.float32,
                unet_cfg: SVDUNetConfig = SVDUNetConfig(),
                vae_cfg: VAEConfig = VAEConfig(),
                clip_cfg: CLIPVisionConfig = CLIPVisionConfig(),
                seed: int = 0, controlnet2_dir: Optional[str] = None,
                ldmk: bool = False) -> ModelBundle:
    """The SVD UNet, VAE and CLIP vision encoder (from `svd_dir`'s unet/,
    vae/ and image_encoder/) and the MOFA adapter (`controlnet_dir`; a
    LdmkFlowControlNet when `ldmk`) on `device` in `dtype`, in eval mode.
    A second, trajectory adapter (`controlnet2`) exists whenever
    `controlnet2_dir` is not None ("" gives a random one).

    Each part with a weight file is built on the meta device and takes the
    file's tensors with `load_state_dict(strict=True, assign=True)`, is
    cast on the CPU and then moved, so the card holds one copy in `dtype`;
    a missing or unexpected key raises with its name. A part without one
    gets seeded random weights drawn on `device`."""
    dirs = {"unet": svd_dir and os.path.join(svd_dir, "unet"),
            "controlnet": controlnet_dir,
            "vae": svd_dir and os.path.join(svd_dir, "vae"),
            "clip": svd_dir and os.path.join(svd_dir, "image_encoder"),
            "controlnet2": controlnet2_dir}
    desc = {"unet": "SVD UNet", "vae": "VAE", "clip": "CLIP vision",
            "controlnet": "Ldmk MOFA-Adapter" if ldmk else "MOFA-Adapter",
            "controlnet2": "Drag MOFA-Adapter"}
    generator = torch.Generator(device=device).manual_seed(seed)
    parts = {}
    for name, build in ModelBundle.part_constructors(
            unet_cfg, vae_cfg, clip_cfg, ldmk, controlnet2_dir is not None).items():
        path = _find_weights(dirs[name])
        if path is None:
            _say(f"[loaders] {desc[name]}: no weights at {dirs[name]!r}; random init")
            with torch.device(device):
                m = init_random_(build(), generator)
        else:
            _say(f"[loaders] {desc[name]}: {path}")
            with torch.device("meta"):
                m = build()
            m.load_state_dict(part_state_dict(name, path, m), strict=True,
                              assign=True)
        parts[name] = m.to(dtype).to(device).eval().requires_grad_(False)
    return ModelBundle(**parts)


def write_video(frames01, path: str, fps: int = 7) -> None:
    """[T, H, W, 3] float in [0, 1] (numpy or tensor) -> mp4 (cv2), gif (PIL)
    or .npy (the uint8 frames as they are, without a codec)."""
    if torch.is_tensor(frames01):
        frames01 = frames01.detach().float().cpu().numpy()
    frames = (np.asarray(frames01) * 255).clip(0, 255).astype("uint8")
    if path.endswith(".npy"):
        np.save(path, frames)
        return
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


FRAME_PARALLEL_HELP = "shard the denoise over all devices' frames axis"


def start_frame_parallel(device):
    """`--frame_parallel`: join the process group (core.mesh.init_distributed:
    torchrun's ranks, or a world of one) and build the (1, 1, 1, world)
    mesh. Returns (this rank's device, the mesh)."""
    from mofa_tpu_torch.core.mesh import init_distributed, make_mesh
    device = init_distributed(device)
    return device, make_mesh(data=1, frames=dist.get_world_size())


def share_bundle(bundle: ModelBundle, mesh) -> ModelBundle:
    """Every rank takes the first rank's weights, byte for byte (with a
    mesh; without one the bundle is returned as it is)."""
    if mesh is not None:
        for module in bundle.modules().values():
            broadcast_module_(module)
    return bundle


def _say(msg: str) -> None:
    if is_main_rank():
        print(msg)
