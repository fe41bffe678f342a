"""Trajectory animation CLI: the traj workload's entry point, on the card.

Counterpart of mofa_tpu/apps/traj_app.py (the reference Traj gradio app's
Drag.run): image + trajectory JSON -> PCHIP tracks -> sparse flow on the
384^2 canvas -> CMP completion -> flow at the video's size ->
TrajPipeline -> mp4 / gif.

    python -m mofa_tpu_torch.apps.traj_app --image in.png --tracks tracks.json --bf16
    python -m mofa_tpu_torch.apps.traj_app --image in.png --tracks tracks.json \
        --device cpu --tiny --output out.gif

Trajectory JSON:
  {"tracks": [[[x, y], [x, y], ...], ...],      # click points per track
   "motion_brush": optional path to a {0, 255} PNG mask}

It runs on the CUDA device unless `--device cpu` is given, and raises when
there is none. `--frame_parallel` shards the denoise over the frames of
every rank (one process per device): the same command runs alone (a world
of one) or under `torchrun --nproc_per_node N`; NCCL on the card, gloo
with `--device cpu`. Only rank 0 writes the video and prints. `generate` is the generation itself (arrays in, frames out;
it needs neither PIL nor cv2); `_run` adds the files around it, read
through cv2 (`preprocess/image.py`: Pillow's decoding and resizing
reproduced, so the CLI needs no PIL).
"""

from __future__ import annotations

import argparse
import gc
import json

import numpy as np
import torch

from mofa_tpu_torch.apps.instrument import (add_observability_args,
                                            maybe_trace, observe)
from mofa_tpu_torch.apps.loaders import (FRAME_PARALLEL_HELP, load_bundle,
                                         load_cmp, share_bundle,
                                         start_frame_parallel, write_video)
from mofa_tpu_torch.core.mesh import is_main_rank
from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG
from mofa_tpu_torch.models.cmp.model import TINY_CMP_CONFIG, CMPConfig
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.ops.resize import resize_nhwc
from mofa_tpu_torch.ops.trajectory import interpolate_trajectory
from mofa_tpu_torch.pipelines.traj import TrajPipeline
from mofa_tpu_torch.preprocess.image import nearest_index, read_image
from mofa_tpu_torch.preprocess.traj import (DragFlowEngine,
                                            divide_points_afterinterpolate,
                                            preprocess_image,
                                            prepare_trajectory_flow)

RASTER_SIZE = 384          # the CMP canvas


def build_parser():
    p = argparse.ArgumentParser(description="MOFA trajectory animation (PyTorch)")
    p.add_argument("--image", required=True)
    p.add_argument("--tracks", required=True, help="trajectory JSON path")
    p.add_argument("--output", default="output.mp4")
    p.add_argument("--svd_dir", default=None)
    p.add_argument("--controlnet_dir", default=None)
    p.add_argument("--cmp_ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=25)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--target_size", type=int, default=512)
    p.add_argument("--ctrl_scale", type=float, default=0.6)
    p.add_argument("--min_guidance", type=float, default=1.0)
    p.add_argument("--max_guidance", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fps", type=int, default=7)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--decode_chunk_size", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="micro model configs, CMP included (smoke runs; no real weights)")
    p.add_argument("--frame_parallel", action="store_true",
                   help=FRAME_PARALLEL_HELP)
    return add_observability_args(p)


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    return dev


def nearest_resize(mask: np.ndarray, size: int) -> np.ndarray:
    """[H, W] -> [size, size] with PIL's NEAREST rule (`nearest_index`)."""
    return mask[nearest_index(mask.shape[0], size)][:, nearest_index(mask.shape[1], size)]


def drag_flow(engine: DragFlowEngine, image01: torch.Tensor, tracks,
              num_frames: int, brush=None,
              raster_size: int = RASTER_SIZE) -> torch.Tensor:
    """image01 [1, H, W, 3] on the CMP's device; tracks: click points
    [[x, y], ...] per track, in image pixels; brush [H, W] with 255 inside,
    or None. Returns the adapter's flow [1, T-1, H, W, 2]."""
    dev = image01.device
    h, w = image01.shape[1:3]
    image_r = resize_nhwc(image01, (raster_size, raster_size))
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    sparse = lambda f: to_dev(f)[None]
    both_axes = lambda m: to_dev(np.repeat(m[..., None], 2, -1))[None]
    if brush is None:
        s_flow, mask = prepare_trajectory_flow(tracks, num_frames, h, w, raster_size)
        return engine.get_flow(image_r, sparse(s_flow), both_axes(mask), h, w)
    pts = np.stack([np.asarray(interpolate_trajectory(tr, num_frames))
                    for tr in tracks])
    inside, outside = divide_points_afterinterpolate(pts, brush)
    f_in, m_in = prepare_trajectory_flow([list(map(tuple, p)) for p in inside],
                                         num_frames, h, w, raster_size)
    f_out, m_out = prepare_trajectory_flow([list(map(tuple, p)) for p in outside],
                                           num_frames, h, w, raster_size)
    brush_r = nearest_resize(brush.astype(np.uint8), raster_size)
    return engine.get_drag_flow_with_brush(
        image_r, sparse(f_in), both_axes(m_in), sparse(f_out), both_axes(m_out),
        to_dev(brush_r.astype(np.float32) / 255.0), h, w)


def generate(image01, tracks, cmp_loader, bundle_loader, *, timer, brush=None,
             num_frames: int = 25, num_inference_steps: int = 25,
             min_guidance: float = 1.0, max_guidance: float = 3.0,
             ctrl_scale: float = 0.6, decode_chunk_size: int = 8, seed: int = 42,
             trace_dir=None, phase_times=None, mesh=None):
    """Drag tracks -> video, on the device the CMP is loaded to.

    image01 [H, W, 3] in [0, 1] (H, W multiples of 64); tracks and brush as
    in `drag_flow`. cmp_loader() gives the CMP; it is freed before
    bundle_loader() gives the ModelBundle. timer: a PhaseTimer (phases
    cmp_load, cmp_flow, bundle_load, denoise_decode); phase_times: passed to
    TrajPipeline. The pipeline's random draws come from a generator seeded
    with `seed`. mesh: frame-parallel inference over its ranks (the bundle
    takes rank 0's weights). Returns (frames [T, H, W, 3] in [0, 1], flow [1, T-1, H, W, 2]),
    on the device."""
    with timer.phase("cmp_load"):
        engine = DragFlowEngine(cmp_loader())
    dev = next(engine.cmp.parameters()).device
    image = torch.as_tensor(image01, dtype=torch.float32, device=dev)[None]
    with timer.phase("cmp_flow"):
        flow = drag_flow(engine, image, tracks, num_frames, brush)
    # the CMP is done: free its device memory before the bundle loads
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with timer.phase("bundle_load"):
        bundle = share_bundle(bundle_loader(), mesh)
    with timer.phase("denoise_decode"), maybe_trace(trace_dir):
        frames, _ = TrajPipeline(bundle, mesh=mesh)(
            image, flow, num_inference_steps=num_inference_steps,
            min_guidance_scale=min_guidance, max_guidance_scale=max_guidance,
            controlnet_cond_scale=ctrl_scale, decode_chunk_size=decode_chunk_size,
            generator=torch.Generator(device=dev).manual_seed(seed),
            phase_times=phase_times)
    return frames[0], flow


def run(args):
    dev, mesh = resolve_device(args.device), None
    if args.frame_parallel:
        dev, mesh = start_frame_parallel(dev)
    with observe(args, dev) as timer:
        _run(args, dev, timer, mesh)


def _run(args, dev, timer, mesh=None):
    image, (h, w) = preprocess_image(args.image, args.target_size)
    with open(args.tracks) as f:
        spec = json.load(f)
    brush = None
    if spec.get("motion_brush"):
        brush = read_image(spec["motion_brush"], "L").astype(np.float32)
    cfg_kw, cmp_cfg = {}, CMPConfig()
    if args.tiny:
        cfg_kw = dict(unet_cfg=MICRO_UNET_CONFIG, vae_cfg=TINY_VAE_CONFIG,
                      clip_cfg=TINY_CLIP_CONFIG)
        cmp_cfg = TINY_CMP_CONFIG
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    frames, _ = generate(
        image, spec["tracks"],
        lambda: load_cmp(args.cmp_ckpt, dev, cfg=cmp_cfg),
        lambda: load_bundle(args.svd_dir, args.controlnet_dir, dev, dtype, **cfg_kw),
        timer=timer, brush=brush, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        min_guidance=args.min_guidance, max_guidance=args.max_guidance,
        ctrl_scale=args.ctrl_scale, decode_chunk_size=args.decode_chunk_size,
        seed=args.seed, trace_dir=args.trace_dir, mesh=mesh)
    if not is_main_rank():
        return
    with timer.phase("write"):
        write_video(frames, args.output, fps=args.fps)
    print(f"wrote {args.output} ({args.num_frames} frames @ {h}x{w})")


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
