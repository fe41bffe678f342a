"""Hybrid animation CLI (landmarks + drag tracks): the dual-adapter workload.

Counterpart of mofa_tpu/apps/hybrid_app.py (the reference Hybrid gradio
apps): image + landmarks.npy ([T, 68, 2], (x, y) pixels of the video's
frame) + optional trajectory JSON + optional face-mask PNG -> face flow
(CMP completion of the landmark scatter) and drag flow (CMP completion of
the tracks at the model's 25 frames, tiled to the landmarks' length) ->
HybridPipeline (the two adapters' residuals blended by the face mask) ->
mp4 / gif.

    python -m mofa_tpu_torch.apps.hybrid_app --image in.png --landmarks l.npy --bf16
    python -m mofa_tpu_torch.apps.hybrid_app --image in.png --landmarks l.npy \
        --device cpu --tiny --target_size 64 --num_inference_steps 1 --output out.gif

It runs on the CUDA device unless `--device cpu` is given, and raises when
there is none. `generate` is the generation itself (arrays in, frames out;
of the file libraries it needs only cv2, for the landmark raster); `_run`
adds the files around it.
"""

from __future__ import annotations

import argparse
import gc
import json

import numpy as np
import torch

from mofa_tpu_torch.apps.instrument import (add_observability_args,
                                            maybe_trace, observe)
from mofa_tpu_torch.apps.loaders import load_bundle, load_cmp, write_video
from mofa_tpu_torch.apps.traj_app import drag_flow, resolve_device
from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG
from mofa_tpu_torch.models.cmp.model import TINY_CMP_CONFIG, CMPConfig
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.pipelines.hybrid import HybridPipeline
from mofa_tpu_torch.preprocess.landmark import LandmarkFlowEngine
from mofa_tpu_torch.preprocess.traj import preprocess_image

MODEL_LENGTH = 25          # the drag adapter's frames: its flow is tiled to T-1


def build_parser():
    p = argparse.ArgumentParser(description="MOFA hybrid animation (PyTorch)")
    p.add_argument("--image", required=True)
    p.add_argument("--landmarks", required=True, help="[T, 68, 2] .npy")
    p.add_argument("--tracks", default=None, help="trajectory JSON (optional)")
    p.add_argument("--face_mask", default=None, help="{0, 255} PNG (optional)")
    p.add_argument("--output", default="output.mp4")
    p.add_argument("--panel_output", default=None,
                   help="also write the reference's composite (first frame | "
                        "drag flow | face flow | landmark raster | output + "
                        "dots | output) to this path")
    p.add_argument("--svd_dir", default=None)
    p.add_argument("--controlnet_dir", default=None, help="landmark adapter")
    p.add_argument("--controlnet2_dir", default=None, help="drag adapter")
    p.add_argument("--cmp_ckpt", default=None)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--target_size", type=int, default=512)
    p.add_argument("--ctrl_scale_ldmk", type=float, default=1.0)
    p.add_argument("--ctrl_scale_traj", type=float, default=0.6)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--decode_chunk_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="micro model configs, CMP included (smoke runs; no real weights)")
    return add_observability_args(p)


def generate(image01, landmarks, tracks, face_mask, cmp_loader, bundle_loader, *,
             timer, num_inference_steps: int = 25, ctrl_scale_ldmk: float = 1.0,
             ctrl_scale_traj: float = 0.6, decode_chunk_size: int = 8,
             seed: int = 42, trace_dir=None, phase_times=None):
    """Landmarks and drag tracks -> video, on the device the CMP is loaded to.

    image01 [H, W, 3] in [0, 1] (H, W multiples of 64); landmarks
    [T, 68, 2] (x, y) pixels; tracks: click points [[x, y], ...] per track,
    or None (no drag: zero flow); face_mask [H, W] in {0, 1}, or None (the
    face adapter everywhere). cmp_loader() gives the CMP; it is freed before
    bundle_loader() gives the dual-adapter ModelBundle. timer: a PhaseTimer
    (phases cmp_load, cmp_flow_landmarks, cmp_flow_tracks, bundle_load,
    denoise_decode); phase_times: passed to HybridPipeline. Returns (frames
    [T, H, W, 3] in [0, 1], face flow and drag flow [1, T-1, H, W, 2],
    landmark frames [T, H, W, 3] in [0, 1] as numpy)."""
    h, w = image01.shape[:2]
    t = landmarks.shape[0]
    with timer.phase("cmp_load"):
        engine = LandmarkFlowEngine(cmp_loader())
    dev = next(engine.cmp.parameters()).device
    image = torch.as_tensor(image01, dtype=torch.float32, device=dev)[None]
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    with timer.phase("cmp_flow_landmarks"):
        face_flow, ldmk_imgs = engine.flow_from_landmarks(image, landmarks)
    with timer.phase("cmp_flow_tracks"):
        if tracks:
            drag = drag_flow(engine, image, tracks, MODEL_LENGTH)
            reps = -(-(t - 1) // drag.shape[1])
            drag = drag.repeat(1, reps, 1, 1, 1)[:, : t - 1]
        else:
            drag = torch.zeros(1, t - 1, h, w, 2, device=dev)
    # the CMP is done: free its device memory before the bundle loads
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mask = (torch.ones(1, h, w, 1, device=dev) if face_mask is None
            else to_dev(np.asarray(face_mask, np.float32))[None, :, :, None])
    with timer.phase("bundle_load"):
        bundle = bundle_loader()
    with timer.phase("denoise_decode"), maybe_trace(trace_dir):
        frames, _ = HybridPipeline(bundle)(
            image, face_flow, drag, to_dev(ldmk_imgs)[None], mask,
            num_inference_steps=num_inference_steps,
            ctrl_scale_ldmk=ctrl_scale_ldmk, ctrl_scale_traj=ctrl_scale_traj,
            decode_chunk_size=decode_chunk_size,
            generator=torch.Generator(device=dev).manual_seed(seed),
            phase_times=phase_times)
    return frames[0], face_flow, drag, ldmk_imgs


def run(args):
    dev = resolve_device(args.device)
    with observe(args, dev) as timer:
        _run(args, dev, timer)


def _run(args, dev, timer):
    from PIL import Image

    image, (h, w) = preprocess_image(Image.open(args.image), args.target_size)
    landmarks = np.load(args.landmarks)
    tracks = None
    if args.tracks:
        with open(args.tracks) as f:
            tracks = json.load(f)["tracks"]
    face_mask = None
    if args.face_mask:
        m = np.asarray(Image.open(args.face_mask).convert("L").resize(
            (w, h), Image.NEAREST), np.float32)
        face_mask = (m > 127).astype(np.float32)
    cfg_kw, cmp_cfg = {}, CMPConfig()
    if args.tiny:
        cfg_kw = dict(unet_cfg=MICRO_UNET_CONFIG, vae_cfg=TINY_VAE_CONFIG,
                      clip_cfg=TINY_CLIP_CONFIG)
        cmp_cfg = TINY_CMP_CONFIG
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    frames, face_flow, drag, ldmk_imgs = generate(
        image, landmarks, tracks, face_mask,
        lambda: load_cmp(args.cmp_ckpt, dev, cfg=cmp_cfg),
        lambda: load_bundle(args.svd_dir, args.controlnet_dir, dev, dtype, **cfg_kw,
                            controlnet2_dir=args.controlnet2_dir or "", ldmk=True),
        timer=timer, num_inference_steps=args.num_inference_steps,
        ctrl_scale_ldmk=args.ctrl_scale_ldmk, ctrl_scale_traj=args.ctrl_scale_traj,
        decode_chunk_size=args.decode_chunk_size, seed=args.seed,
        trace_dir=args.trace_dir)
    frames = frames.float().cpu().numpy()
    with timer.phase("write"):
        write_video(frames, args.output, fps=args.fps)
    print(f"wrote {args.output} ({landmarks.shape[0]} frames @ {h}x{w})")
    if args.panel_output:
        from mofa_tpu_torch.apps.panels import hybrid_panel
        panel = hybrid_panel(image, drag[0].float().cpu().numpy(),
                             face_flow[0].float().cpu().numpy(), ldmk_imgs,
                             frames, landmarks)
        write_video(panel, args.panel_output, fps=args.fps)
        print(f"wrote {args.panel_output}")


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
