"""Keypoint facial-animation CLI: a long video from a landmark track.

Counterpart of mofa_tpu/apps/keypoint_app.py (the reference
`inference_opendomain.py` + `mofa_keypoint.py`): image + landmarks.npy
([T, 68, 2], (x, y) pixels of the video's frame; `audio2ldmk_app` writes
one from audio) -> landmark raster and CMP completion of the landmark
scatter over the T-1 frames at 384^2 -> KeypointPipeline (sliding windows
of W frames, stride S, on the landmark adapter) -> mp4 / gif.

    python -m mofa_tpu_torch.apps.keypoint_app --image in.png --landmarks l.npy --bf16
    python -m mofa_tpu_torch.apps.keypoint_app --image in.png --landmarks l.npy \
        --device cpu --tiny --target_size 64 --num_frames 7 --window_size 4 \
        --stride 2 --num_inference_steps 1 --output out.gif

It runs on the CUDA device unless `--device cpu` is given, and raises when
there is none. `generate` is the generation itself (arrays in, frames out;
of the file libraries it needs only cv2, for the landmark raster); `_run`
adds the files around it.
"""

from __future__ import annotations

import argparse
import gc

import numpy as np
import torch

from mofa_tpu_torch.apps.instrument import (add_observability_args,
                                            maybe_trace, observe)
from mofa_tpu_torch.apps.loaders import load_bundle, load_cmp, write_video
from mofa_tpu_torch.apps.traj_app import resolve_device
from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG
from mofa_tpu_torch.models.cmp.model import TINY_CMP_CONFIG, CMPConfig
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.pipelines.keypoint import KeypointPipeline
from mofa_tpu_torch.preprocess.landmark import LandmarkFlowEngine
from mofa_tpu_torch.preprocess.traj import preprocess_image


def build_parser():
    p = argparse.ArgumentParser(description="MOFA keypoint facial animation (PyTorch)")
    p.add_argument("--image", required=True)
    p.add_argument("--landmarks", required=True, help="[T, 68, 2] .npy")
    p.add_argument("--output", default="output.mp4")
    p.add_argument("--panel_output", default=None,
                   help="also write the reference's 5-panel video (first frame | "
                        "flow | landmark raster | output + dots | output) here")
    p.add_argument("--svd_dir", default=None)
    p.add_argument("--controlnet_dir", default=None, help="landmark adapter")
    p.add_argument("--cmp_ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=125)
    p.add_argument("--window_size", type=int, default=25)
    p.add_argument("--stride", type=int, default=12)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--target_size", type=int, default=512)
    p.add_argument("--ctrl_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--decode_chunk_size", type=int, default=8)
    p.add_argument("--window_batch", type=int, default=1,
                   help="denoise this many sliding windows per denoiser call "
                        "(stacked on the batch axis; the same result)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="micro model configs, CMP included (smoke runs; no real weights)")
    return add_observability_args(p)


def generate(image01, landmarks, cmp_loader, bundle_loader, *, timer,
             window_size: int = 25, stride: int = 12, num_inference_steps: int = 25,
             ctrl_scale: float = 1.0, decode_chunk_size: int = 8, seed: int = 42,
             window_batch: int = 1, trace_dir=None, phase_times=None):
    """A landmark track -> video, on the device the CMP is loaded to.

    image01 [H, W, 3] in [0, 1] (H, W multiples of 64); landmarks
    [T, 68, 2] (x, y) pixels. cmp_loader() gives the CMP; it is freed before
    bundle_loader() gives the landmark-adapter ModelBundle. timer: a
    PhaseTimer (phases cmp_load, cmp_flow, bundle_load, denoise_decode);
    phase_times: passed to KeypointPipeline. The pipeline's random draws
    come from a generator seeded with `seed`. Returns (frames
    [T, H, W, 3] in [0, 1], flow [1, T-1, H, W, 2], landmark frames
    [T, H, W, 3] in [0, 1] as numpy)."""
    with timer.phase("cmp_load"):
        engine = LandmarkFlowEngine(cmp_loader())
    dev = next(engine.cmp.parameters()).device
    image = torch.as_tensor(image01, dtype=torch.float32, device=dev)[None]
    with timer.phase("cmp_flow"):
        flow, ldmk_imgs = engine.flow_from_landmarks(image, landmarks)
    # the CMP is done: free its device memory before the bundle loads
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with timer.phase("bundle_load"):
        bundle = bundle_loader()
    with timer.phase("denoise_decode"), maybe_trace(trace_dir):
        frames, _ = KeypointPipeline(bundle)(
            image, flow, torch.from_numpy(ldmk_imgs).to(dev)[None],
            window_size=window_size, stride=stride,
            num_inference_steps=num_inference_steps,
            controlnet_cond_scale=ctrl_scale, decode_chunk_size=decode_chunk_size,
            generator=torch.Generator(device=dev).manual_seed(seed),
            window_batch=window_batch, phase_times=phase_times)
    return frames[0], flow, ldmk_imgs


def run(args):
    dev = resolve_device(args.device)
    with observe(args, dev) as timer:
        _run(args, dev, timer)


def _run(args, dev, timer):
    from PIL import Image

    image, (h, w) = preprocess_image(Image.open(args.image), args.target_size)
    landmarks = np.load(args.landmarks)[: args.num_frames]
    cfg_kw, cmp_cfg = {}, CMPConfig()
    if args.tiny:
        cfg_kw = dict(unet_cfg=MICRO_UNET_CONFIG, vae_cfg=TINY_VAE_CONFIG,
                      clip_cfg=TINY_CLIP_CONFIG)
        cmp_cfg = TINY_CMP_CONFIG
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    frames, flow, ldmk_imgs = generate(
        image, landmarks, lambda: load_cmp(args.cmp_ckpt, dev, cfg=cmp_cfg),
        lambda: load_bundle(args.svd_dir, args.controlnet_dir, dev, dtype, **cfg_kw,
                            ldmk=True),
        timer=timer, window_size=args.window_size, stride=args.stride,
        num_inference_steps=args.num_inference_steps, ctrl_scale=args.ctrl_scale,
        decode_chunk_size=args.decode_chunk_size, seed=args.seed,
        window_batch=args.window_batch, trace_dir=args.trace_dir)
    frames = frames.float().cpu().numpy()
    with timer.phase("write"):
        write_video(frames, args.output, fps=args.fps)
    print(f"wrote {args.output} ({landmarks.shape[0]} frames @ {h}x{w})")
    if args.panel_output:
        from mofa_tpu_torch.apps.panels import keypoint_panel
        panel = keypoint_panel(image, flow[0].float().cpu().numpy(), ldmk_imgs,
                               frames, landmarks)
        write_video(panel, args.panel_output, fps=args.fps)
        print(f"wrote {args.panel_output}")


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
