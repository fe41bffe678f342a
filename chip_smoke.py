"""Chip smoke test of the PyTorch/CUDA port (`mofa_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phase kernels  # build + kernel checks only
    python3 chip_smoke.py --phase profile  # torch.profiler table, 2 steps
    python3 chip_smoke.py --phase keypoint # build, the keypoint path's kernel
                                           # checks, video, the audio front,
                                           # the face stack and the face front
                                           # (5e, 5f, 5j, 5k)
    python3 chip_smoke.py --phase train    # build, the training path's kernel
                                           # backward checks, 5g, 5h, 5i
    python3 chip_smoke.py --phase ui       # build, the native library, PIRender,
                                           # FILM and the UI server (5l)
    python3 chip_smoke.py --phase mesh     # build, frame-parallel inference (5m)

Phases, each printed as it finishes:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of the CUDA kernels (one nvcc per source, all at once,
     sm_90a) from `mofa_tpu_torch/csrc`;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, bf16 and fp32 (the bf16-only fused convs also against the
     plain version in fp32 on the upcast inputs), against the bounds of
     TOL_FP32 / TOL_BF16, with the kernel's, the plain version's and one
     PyTorch call's times (CUDA events, median of 5) and, for the FFN,
     GroupNorm and fused-conv kernels, the stock chain the port's models
     run; flash also timed beside SDPA at each of the main path's sites
     (B*T = 50; no plain version: its logits would not fit); the fp32
     routes (split TF32) of flash and the FFN timed at the stage-1
     training shapes beside their plain versions, SDPA's fp32 forward and
     the stock fp32 chain, with their split-TF32 and CUDA-core bounds;
     short attention's fp32 route (split TF32 on mma.sync) timed at the
     training site in both layouts and at the classic inference site,
     beside its plain version and SDPA's fp32 forward;
     the FFN at both widths, and its bf16 route's three stages (LN pass, gate GEMM,
     out GEMM) each alone against its plain stage, timed beside one
     cuBLAS call of the same product, with the gate GEMM's "ilv" and
     "pipe" schedules checked and timed beside plain's; softsplat at the
     adapter's four warp sites from the feature map broadcast over 24
     flows (every mode, the raw sums and normaliser plane), with the
     whole 'avg' call timed against the wrapper path before the
     redesign; each fused conv's two stages (activation pass, wgmma GEMM
     over 9 or 3 taps) each alone, timed beside one cuDNN conv of the
     same product; then planted faults, which the fp32 and bf16 bounds
     must reject;
     3b. the FFN variants (tools/bench_ffn.py's A/B): plain, ilv, pipe,
     tanh, geglu_ffn and the stock chain at the main path's three FF
     shapes, their agreement with "plain" and one pass's launch counts;
     3c. the training path's four kernels and classic short attention
     under autograd (kernel forward, the stock backward of kernels/*.py)
     at the stage-1 shapes, fp32 and bf16: every gradient against plain
     autograd through the plain version (TOL_BWD), each backward timed
     beside SDPA's where it computes the same function, and a planted
     fault a kernel (a key chunk dropped, the last frame unread, the last
     key's gradient dropped, no d gamma, d_flow's sign flipped) that must
     miss; then each other entry point the JAX package differentiates
     (geglu_ffn, the ilv / pipe / tanh FFNs, the channel sums, the fused
     GroupNorm, both fused convs) at one shape, its gradients against
     plain autograd and a planted fault of its own;
  4. the composition check: the full trajectory pipeline at full SVD-XT
     widths but a small video, in both temporal layouts (spatial-major
     and classic, `MOFA_TMAJOR=0`), once through the kernels and once
     inside `plain_reference()`, in fp32 (PSNR >= 45 dB) and in bf16 (PSNR
     bars beside PSNR_BF16_DB); the classic and spatial-major bf16 videos
     against each other;
  5. the main path: the traj app's generation (`traj_app.generate`) from
     a seeded image and seeded drag tracks: PCHIP, sparse flow at 384^2,
     CMP (full size, seeded random weights, fp32), the flow rescaled to
     576x1024, then `TrajPipeline` at 25 frames, bf16, batched CFG,
     random seeded weights, timing every phase and counting each
     kernel's launches (each must be its expected count, the flow finite
     and not all zero, every frame finite); 5b. the classic-layout path,
     the same video at 5 steps with `MOFA_TMAJOR=0` (short_attention
     launched, tmajor never); 5c. the app's motion-brush path at 256x384;
     5d. the hybrid path: the hybrid app's generation
     (`hybrid_app.generate`) from a seeded 68-point landmark sequence,
     seeded drag tracks and an elliptical face mask, at MAIN's size and
     steps, with the landmark and trajectory adapters written to files
     first (.safetensors and .bin) and loaded by `load_bundle` (each tensor
     held bit-equal), both flows and the frames checked and the launches
     held to the sites of two adapter trunks a step; 5e. the keypoint
     path: the keypoint app's generation (`keypoint_app.generate`) from a
     seeded 68-point track of 125 frames at 512^2: the CMP over its 124
     frames, then `KeypointPipeline` in 10 sliding windows of 25 frames
     at stride 12, 10 steps (KEYPOINT), bf16, the launches held to the sites of 10
     windows a step (`expected_launches` by image size, views and window
     batch); then the same inputs at 2 steps with window_batch 1, 2, 2
     and 1 from one set of latents, each run's launches held, 2 against 1
     to WINDOW_BATCH_RMS and a planted fault outside it; the four path
     kernels are also held to
     their plain versions at this path's shapes in phase 3
     (`keypoint_kernel_checks`); 5f. the audio front: the AniPortrait
     engine of `audio2ldmk_app` at full widths (wav2vec2-base, Audio2Mesh,
     Audio2Pose) from a seeded 6-second wav and a seeded face to a
     [151, 68, 2] landmark track, finite, no custom kernel launched;
     5j. the face stack (fp32, full widths, seeded weights written to
     files under the reference names and read back strict, bit-equal):
     `face_fit_app.main` (the 4-module FAN and the ResNet-50) on a
     seeded 256^2 PNG; `audio2ldmk_app.main --engine sadtalker` on a 6 s
     wav with a synthetic BFM of the front model's size (BFM_VERTICES,
     BFM_FACES) -> [151, 68, 2], twice; --face3dvis on a 1 s wav (25
     frames rendered), one frame held against the CPU (masks, colours:
     FACE's bounds); the video engine on a 150-frame track;
     `opendomain_app.main --engine sadtalker` at 512^2, bf16, one window
     of 25 frames, 3 steps, its launches held to the keypoint sites; the
     face stack itself no custom kernel; then `traj_app.main`,
     `hybrid_app.main` (a face-mask PNG) and `keypoint_app.main` through
     their files (cv2 in, mp4 out: no PIL), each mp4 counted;
     5k. the face front and facerender (fp32, full widths, FRONT): a
     synthetic face_landmarker .task (tests/torch_ref/tflite_writer.py:
     BlazeFace, the landmarker, the blendshapes at the published shapes,
     planted head biases), the facerender checkpoint (spectral-norm
     triplets folded) and GFPGANv1.4.pth written under the reference
     names and read back strict, bit-equal; each compiled graph's
     outputs held to the CPU's (FRONT's bound, cuDNN TF32 allowed);
     `face_fit_app.main --task`, `audio2ldmk_app.main --task` and
     `--engine video --driving_video` (a seeded 2 s mp4), then
     `facerender_app.main` at 256^2 on 50 frames of 5j's coefficient
     track with `--enhancer gfpgan` and `--paste_back`; each stage timed,
     one rendered frame held to the CPU, the peak memory; no face found
     fails the phase;
     5l. the native host library (`mofa_tpu_torch/native.py`, built with
     g++ here; a failed build fails the run), its four entry points held
     bit-equal to their numpy versions at the main path's sizes and timed
     beside them; PIRender at PIRenderConfig() (fp32, seeded weights
     written as the reference's checkpoint and read back strict), 50
     frames of 27-frame semantics windows on a 256^2 source, a frame held
     to the CPU (UI's tol); FILM at FilmConfig() (fp32), `interpolate_frames`
     over 4 frames of 512^2 with inter_frames 1 and 3, a prediction held to
     the CPU; the UI server (`apps/ui_server.py`) in a thread on
     127.0.0.1, --device cuda --bf16, seeded random weights: the page,
     /preprocess and /preview on a 576x1024 image, /run at MAIN's size,
     frames and steps (launches held to `expected_launches("tmajor", 25)`,
     the mp4 of /video decoded), its frames against `traj_app.generate`
     called directly (bit-equal, or PSNR_BF16_DB), a bad request's 500 and
     a good request after it, /run_landmarks in hybrid mode (576x1024) and
     keypoint mode (512^2, a 25-frame track), 5 steps each, launches held;
     5m. frame-parallel inference (`--frame_parallel`): `init_distributed`
     with no launcher (NCCL, a world of one) and the (1, 1, 1, 1)
     DeviceMesh; the traj video at MAIN's size and steps, the hybrid video
     (576x1024, 5 steps) and the keypoint video (512^2, 49 frames, 5 steps)
     through their apps' `generate` with the mesh and directly in the
     classic temporal layout, each mesh run's launches held to the classic
     layout's sites (no tmajor launch) and its frames within MESH's PSNR
     of the direct run's, both timed; the classic short kernel at the
     frame-parallel /8 site [18432/n, 25, 5, 64], n = 1, 2, 4, against its
     plain version and timed beside SDPA;
     5g. stage-1 training through `train_app.run` on seeded 40-frame
     clips at SVD-XT widths (384x384, 25 frames, batch 1, fp32, block
     remat, EMA): 4 steps, a checkpoint at step 2, a validation render at
     step 4, each step's launches held to `expected_train_launches`, loss
     and gradient norm finite; the frozen UNet, VAE and CLIP bit-unchanged
     and the adapter moved; the exported adapter through `load_bundle`
     bit-equal; a restore of step 2 bit-equal to the saved state; one step
     through the kernels against `plain_reference()` (TRAIN_PLAIN_REL),
     and the same step in the classic temporal layout (`MOFA_TMAJOR=0`,
     classic short attention launched at its sites); a run resumed from
     step 2 within RESUME_REL of the first run's steps 3 and 4, a planted
     fault (the generator not restored) outside it; one step without block
     remat and its peak; one step through `train_app` in the classic
     layout, its launches held to the classic sites, its time and peak;
     5h. stage 2 through `train_app.run` from 5g's exported adapter at
     the same operating point, a CMP of seeded random weights read from a
     file: run A sequential with AdamW, run B with --overlap_inputs
     --use_8bit_adam, 2 steps each; step 1's control flow and loss equal
     across the runs (CONTROL_REL, STAGE2_RUNS_REL), the flow encoder and
     the conditioning embedding bit-unchanged, each step's launches as
     their sites, step 1 recomputed outside the trainer and a
     planted fault (masks from each clip's first frame) that must miss
     CONTROL_REL; a line a step with the seconds of batch, teacher, mask
     sampling, CMP, forward + backward and optimizer, the peak, and both
     optimizers' state bytes; 5i. the CMP trainer on the shipped config
     (read from a config.yaml it writes) at crop 384, batch 8, the GMFlow
     trainer at 384x512, batch 8 (halved while it does not fit), 3 steps
     each on seeded (image, flow) pairs, and the evaluator on the flow
     checkpoint: losses and EPE finite, both checkpoints reloaded
     bit-equal, the CMP one strictly through load_cmp, a checkpoint
     without one tensor refused;
  6. the GroupNorm / fused-conv entry points: a spatial and a temporal
     resnet block at full width built from `gn_affine`, `gn_silu_conv3x3`
     and `gn_silu_tconv3`, held against the port's stock resnet blocks.
The second line from the end is the kernel table as one JSON object; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


@contextlib.contextmanager
def temporal_layout(layout: str):
    """Run the models in the "tmajor" or the "classic" temporal layout."""
    old = os.environ.get("MOFA_TMAJOR")
    if layout == "classic":
        os.environ["MOFA_TMAJOR"] = "0"
    else:
        os.environ.pop("MOFA_TMAJOR", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MOFA_TMAJOR", None)
        else:
            os.environ["MOFA_TMAJOR"] = old


# ------------------------------------------------------------------ timing

def time_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of fn() over `iters` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_queued_ms(fn, calls: int = 20) -> float:
    """Milliseconds a call of fn() over `calls` calls queued back to back
    between two CUDA events, after one warm-up call: the device's time,
    the host's work of each call hidden behind the calls queued before it
    (time_ms waits for each call, so it also counts the host's work
    before the first launch)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# the least time a kernel could take is the larger of its bytes over the
# memory rate and its operations over the peak rate for their type.
# "split_tf32": fp32 products as three TF32 products (small * big + big *
# small + big * big) on the tensor cores, 495 TFLOP/s dense TF32, so an
# fp32 operation costs three; the fp32 routes' least time ("fp32": the
# CUDA cores' FMA, printed beside it).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "split_tf32": 495e12 / 3}


def bound(ops: float, nbytes: float, kind: str) -> tuple:
    """(bound_ms, "bytes" or "operations") for work of `ops` operations
    of type `kind` (bf16 tensor core, fp32 outside the tensor cores, or
    fp32 as split TF32 on the tensor cores) that must move `nbytes`
    bytes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------- phase 3: kernels

KERNEL_META = {
    "flash_attention": dict(
        source="mofa_tpu_torch/csrc/flash_attention.cu",
        replaces="mofa_tpu/kernels/flash_attention.py:183"),
    "short_attention_tmajor": dict(
        source="mofa_tpu_torch/csrc/short_attention.cu",
        replaces="mofa_tpu/kernels/short_attention.py:246"),
    "ln_geglu_ffn": dict(
        source="mofa_tpu_torch/csrc/ln_geglu_ffn.cu",
        replaces="mofa_tpu/kernels/geglu_ffn.py:390"),
    "softsplat": dict(
        source="mofa_tpu_torch/csrc/softsplat.cu",
        replaces="mofa_tpu/kernels/softsplat_pallas.py:87"),
    "short_attention": dict(
        source="mofa_tpu_torch/csrc/short_attention.cu",
        replaces="mofa_tpu/kernels/short_attention.py:138"),
    "channel_sums": dict(
        source="mofa_tpu_torch/csrc/channel_sums.cu",
        replaces="mofa_tpu/kernels/group_norm.py:92"),
    "gn_silu_conv3x3": dict(
        source="mofa_tpu_torch/csrc/conv3x3.cu",
        replaces="mofa_tpu/kernels/conv_fused.py:190"),
    "gn_silu_tconv3": dict(
        source="mofa_tpu_torch/csrc/conv3x3.cu",
        replaces="mofa_tpu/kernels/conv_fused.py:355"),
    "geglu_ffn": dict(
        source="mofa_tpu_torch/csrc/ln_geglu_ffn.cu",
        replaces="mofa_tpu/kernels/geglu_ffn.py:93"),
    "ln_geglu_ffn_ilv": dict(
        source="mofa_tpu_torch/csrc/ln_geglu_ffn.cu",
        replaces="mofa_tpu/kernels/geglu_ffn.py:344"),
    "ln_geglu_ffn_pipe": dict(
        source="mofa_tpu_torch/csrc/ln_geglu_ffn.cu",
        replaces="mofa_tpu/kernels/geglu_ffn.py:363"),
    "ln_geglu_ffn_tanh": dict(
        source="mofa_tpu_torch/csrc/ln_geglu_ffn.cu",
        replaces="mofa_tpu/kernels/geglu_ffn.py:390"),
}

# Bounds on a kernel's agreement with its plain version.
# fp32: max |kernel - plain| <= tol, or for a (max_rel, rms_rel) pair the
# relative bounds below. Both sides are fp32 math in another summation
# order (atomics for the splat and the channel sums, tiles for the rest);
# the channel sums grow with S, so their bound is relative. Flash, short
# attention (both layouts) and the FFN take their fp32 products as split
# TF32 (three TF32 products, about 22 bits): their bounds sit a few times
# above those routes' sound readings on an H100 (flash 1.9e-6, the FFN
# 1.1e-5 at 14,400 x 640, short attention 1.4-2.0e-6) and an order of
# magnitude or more below a single TF32 product's (2.6e-4, 2.0e-3 and
# 1.7-2.4e-3: planted faults).
# bf16: (max_rel, rms_rel): max |diff| <= max_rel * max |plain| and
# ||diff|| / ||plain|| <= rms_rel. The plain versions round P (attention)
# and the LN output and the GEMM1 result (FFN) to bf16 at other points
# than the kernels do; the fused convs' plain versions round where the
# JAX kernels and these do (the activated y, w, bias and temb; the conv
# summed in fp32 and rounded once), so there only the summation order and
# the fp32 SiLU's last bit differ. The outputs are bf16, so the bounds
# scale with the output. The channel sums are fp32 sums of the same bf16 values on both
# sides. The bf16 kernels are also held, with the same bounds, against
# the plain version in fp32 on their upcast inputs (TF32 off). The bounds
# sit a few times above the sound readings and below those of the planted
# faults, which `planted_faults` checks on every run (readings in PERF.md).
TOL_FP32 = {"flash_attention": 2e-5, "short_attention_tmajor": 1e-5,
            "short_attention": 1e-5, "ln_geglu_ffn": 5e-5, "softsplat": 1e-4,
            "channel_sums": (1e-5, 1e-5)}
TOL_BF16 = {"flash_attention": (2e-2, 7e-3),
            "softsplat": (1e-2, 1e-3),
            "short_attention_tmajor": (2e-2, 7e-3),
            "short_attention": (2e-2, 7e-3),
            "ln_geglu_ffn": (2e-2, 1e-2),
            "channel_sums": (1e-5, 1e-5),
            "gn_silu_conv3x3": (2e-2, 1e-2),
            "gn_silu_tconv3": (2e-2, 1e-2),
            "geglu_ffn": (2e-2, 1e-2),
            "ln_geglu_ffn_ilv": (2e-2, 1e-2),
            "ln_geglu_ffn_pipe": (2e-2, 1e-2),
            "ln_geglu_ffn_tanh": (2e-2, 1e-2)}


def agreement(got, ref):
    """(max |got - ref|, max |ref|, ||got - ref|| / ||ref||), in fp32."""
    d, r = got.float() - ref.float(), ref.float()
    return (d.abs().max().item(), r.abs().max().item(),
            (d.norm() / r.norm()).item())


def within(name, dtype_name, err, ref_max, rms) -> bool:
    tol = (TOL_FP32 if dtype_name == "fp32" else TOL_BF16)[name]
    if not isinstance(tol, tuple):
        return err <= tol
    max_rel, rms_rel = tol
    return err <= max_rel * ref_max and rms <= rms_rel


def judge(name, dtype_name, got, ref) -> tuple:
    """got / ref: a tensor, or a tuple of tensors (an output and its sums),
    each part held to the bounds on its own. Returns (ok, max |diff| and
    max |ref| of the first part, the worst relative RMS of all parts)."""
    import torch
    parts = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
    ok, rms, first = True, 0.0, None
    for g_, r_ in parts:
        e, m, q = agreement(g_, r_)
        ok = (ok and within(name, dtype_name, e, m, q)
              and bool(torch.isfinite(g_).all()))
        rms = max(rms, q)
        first = first or (e, m)
    return ok, first[0], first[1], rms


def upcast(*tensors):
    import torch
    return [t.float() if torch.is_tensor(t) and t.is_floating_point() else t
            for t in tensors]


def _check(results, name, dtype_name, label, kernel_fn, plain_fn, time_it,
           ref32_fn=None, library_fn=None, chain_fn=None, work=None,
           suffix=""):
    """kernel_fn() against plain_fn() (inside plain_reference()), and for
    a bf16 kernel against ref32_fn(), the plain version on fp32 inputs.
    With time_it: the kernel's, the plain version's, library_fn()'s (one
    PyTorch call computing the same function) and chain_fn()'s (the stock
    chain the port runs instead) times, and the bound of `work` = (ops,
    bytes, kind); the first timed shape of a kernel fills its row's keys,
    a shape with a `suffix` fills the same keys with the suffix added."""
    import torch
    from mofa_tpu_torch import kernels
    with torch.no_grad():
        got = kernel_fn()
        torch.cuda.synchronize()
        with kernels.plain_reference():
            ref = plain_fn()
        torch.cuda.synchronize()
        ok, err, ref_max, rms = judge(name, dtype_name, got, ref)
        line = (f"  {name:24s} {dtype_name:4s} {label:38s} max|diff| {err:.3e} "
                f"max|ref| {ref_max:.3e} rel rms {rms:.3e} {'ok' if ok else 'MISS'}")
        if ref32_fn is not None:
            with kernels.plain_reference():
                ref32 = ref32_fn()
            ok32, err32, _, rms32 = judge(name, dtype_name, got, ref32)
            ok = ok and ok32
            line += (f"; vs fp32 plain: max|diff| {err32:.3e} rel rms "
                     f"{rms32:.3e} {'ok' if ok32 else 'MISS'}")
            del ref32
        times = {}
        if time_it:
            times["ms"] = time_ms(kernel_fn)
            with kernels.plain_reference():
                times["plain_ms"] = time_ms(plain_fn)
            if library_fn is not None:
                times["library_ms"] = time_ms(library_fn)
            if chain_fn is not None:
                times["chain_ms"] = time_ms(chain_fn)
            line += "  " + "  ".join(f"{k} {v:.3f}" for k, v in times.items())
    log(line)
    r = results.setdefault(name, dict(max_abs_err=0.0, ms=None, plain_ms=None,
                                      library_ms=None, bound_ms=None,
                                      bound_by=None, ok=True))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ok"] = r["ok"] and ok
    if time_it and (suffix or r["ms"] is None):
        r.update({k + suffix: v for k, v in times.items()})
        b_ms, b_by = bound(*work)
        r["bound_ms" + suffix], r["bound_by" + suffix] = b_ms, b_by
        log(f"  {'':24s}      bound {b_ms:.3f} ms ({b_by})")
    del got, ref
    torch.cuda.empty_cache()


def fp32_cores_bound(r: dict, work: tuple, suffix: str) -> None:
    """An fp32 row's bound on the CUDA cores (FMA at 67 TFLOP/s), beside
    its split-TF32 bound (`bound_ms`): `bound_cores_ms` + suffix."""
    ms, by = bound(work[0], work[1], "fp32")
    r["bound_cores_ms" + suffix] = ms
    log(f"  {'':24s}      bound on the CUDA cores {ms:.3f} ms ({by})")


def queued_times(r: dict, suffix: str, kernel_fn, library_fn) -> None:
    """The kernel's and the library call's device times with the host's
    work of each call hidden behind the calls queued before it
    (`time_queued_ms`): `queued_ms` + suffix, `library_queued_ms` + suffix."""
    import torch
    with torch.no_grad():
        r["queued_ms" + suffix] = time_queued_ms(kernel_fn)
        r["library_queued_ms" + suffix] = time_queued_ms(library_fn)
    log(f"  {'':24s}      queued: kernel {r['queued_ms' + suffix]:.3f} ms, "
        f"library {r['library_queued_ms' + suffix]:.3f} ms")


def ffn_operands(g, c: int, rows: int, dtype, tail: bool = False):
    """(x [rows, c], LN scale and shift [c] fp32, w0 [8c, c], b0 [8c],
    w2 [c, 4c], b2 [c]) drawn from generator g, on its device. tail: the
    gate's pre-activations are exact bf16 values in [-3.5, -2.5] (the g rows
    of w0 are zero, so g is its bias in every version), where the tanh-form
    gelu is 2-45% off the erf form, with the residual and b2 small beside
    the FF output: there the tanh and erf FFNs differ far beyond bf16
    rounding."""
    import torch
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=g.device) * scale
    x = rn(rows, c, scale=0.01 if tail else 1.0).to(dtype)
    ls, lb = rn(c, scale=0.2) + 1.0, rn(c, scale=0.2)
    w0, b0 = rn(8 * c, c, scale=c ** -0.5), rn(8 * c, scale=0.1)
    w2, b2 = rn(c, 4 * c, scale=(4 * c) ** -0.5), rn(c, scale=0.1)
    if tail:
        w0[4 * c:] = 0.0
        b0[4 * c:] = -3.0 + 0.25 * torch.randint(-2, 3, (4 * c,), generator=g,
                                                 device=g.device)
        w2 *= 100.0
        b2.zero_()
    return (x, ls, lb) + tuple(t.to(dtype) for t in (w0, b0, w2, b2))


def ffn_chain(x, ln, w0, b0, w2, b2, approximate: str = "none"):
    """The stock chain the port's model runs where no FFN kernel is taken:
    [F.layer_norm ->] Linear -> a * gelu(g) -> Linear [-> + x] (ln: the LN
    scale and shift, or None for geglu_ffn)."""
    import torch.nn.functional as F
    h = x if ln is None else F.layer_norm(x, x.shape[-1:], ln[0].to(x.dtype),
                                          ln[1].to(x.dtype), 1e-5)
    a, gate = F.linear(h, w0, b0).chunk(2, dim=-1)
    out = F.linear(a * F.gelu(gate, approximate=approximate), w2, b2)
    return out if ln is None else out + x


def tmajor_faulty(q2, k2, v2, t: int, h: int, keys):
    """Plain tmajor attention whose keys and values [B, S, H, T, D] pass
    through `keys` first (a faulty kernel's view of them)."""
    import torch
    bt, s, hd = q2.shape
    heads = lambda x: x.reshape(bt // t, t, s, h, hd // h).permute(0, 2, 3, 1, 4)
    q, k, v = heads(q2), keys(heads(k2)), keys(heads(v2))
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2)
                      * (hd // h) ** -0.5, dim=-1)
    return (p.to(q2.dtype) @ v).permute(0, 3, 1, 2, 4).reshape(bt, s, hd)


def short_walk_warps(d: int) -> int:
    """Warps in the short-attention body's grid-stride walk at a large task
    count: csrc/short_attention.cu launches ShortCfg<D>::BLOCKS_PER_SM (2
    at D = 64, 1 at D = 128) blocks of BF16_WARPS = 4 warps per SM."""
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count * (
        2 if d == 64 else 1) * 4


def planted_faults() -> list:
    """The kernels held, with the bounds of their dtype, against the plain
    version of a faulty kernel. In fp32: one that takes one TF32 product
    for each fp32 product, dropping the split's two correction products
    (FFN at 57,600 x 320, flash at [25, 2304, 5, 64], short attention at
    the training site in both layouts), skips the out
    GEMM's last k-tile of 32 (FFN) or skips a 64-key tile at a ragged L
    (flash, L=1000). In bf16: one that skips a 64-key tile (flash,
    L=9216), leaves the ragged tail's zero-filled keys unmasked (flash,
    L=1000), consumes a ring stage before its barrier completes (flash:
    key tile 3 read as the stale tile 0 of the same stage), skips the last
    wgmma k-step of S (flash: q's last 16 dims unread), never reads the
    last frame (tmajor) or the last key (classic short attention), leaves
    the padded keys T..31 unmasked (tmajor: zero keys with logit 0), leaves
    the last task of every warp's walk unwritten (classic short attention),
    drops a 16-wide chunk of the FFN's inner axis, takes the gate GEMM's
    g box from the a rows in one N tile (a * gelu(a)), skips the out
    GEMM's last k-tile (inner columns 4C-64..4C-1), writes the second
    warpgroup's 64 rows over the first's in every 128 (ilv FFN: the turn
    skipped), gives gate-column tile 0 tile 1's products and tile 1 tile
    0's (pipe FFN: an epilogue reading the other accumulator set; W0's a
    and g rows of the two tiles swapped, b0 kept), drops the gate half of b0
    (geglu_ffn), computes the erf gelu instead of the tanh form (tanh FFN,
    at gate inputs where the two differ), skips the last S-slab of a block
    (channel sums), reads the other CFG half's feature map for the last
    frame or leaves one tap out of the normaliser plane (softsplat 'avg'),
    drops the centre tap, pads the border with silu(b) instead of 0 or
    skips one tap's first 64-channel box (3x3 conv), or drops the t-1 tap,
    pads the frames beyond both ends with silu(b) instead of 0, adds every
    row of a tile the temb of the tile's first frame (2-frame tiles at S =
    9216) or reads tap t+1's box at tap t's frame (temporal conv). Every
    one must MISS; returns the labels of those that passed."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.kernels import tf32_round
    from mofa_tpu_torch.kernels.attention import attention_plain
    from mofa_tpu_torch.kernels.conv_fused import (gn_silu_conv3x3,
                                                   gn_silu_tconv3)
    from mofa_tpu_torch.kernels.flash_attention import flash_attention
    from mofa_tpu_torch.kernels.geglu_ffn import (ffn_gemm_gate_plain,
                                                  ffn_gemm_out_plain,
                                                  ffn_ln_rows_plain, geglu_ffn,
                                                  ln_geglu_ffn)
    from mofa_tpu_torch.kernels.group_norm import (channel_sums,
                                                   channel_sums_plain,
                                                   slab_rows)
    from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                        short_attention_tmajor)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale
                + mean).to(bf)

    def flash_case(length, fault):
        q, k, v = (randn(2, length, 5, 64) for _ in range(3))
        qf, kf, vf = q, k, v
        if fault == "tile":
            keep = torch.cat([torch.arange(64), torch.arange(128, length)])
            kf, vf = k[:, keep.to(dev)], v[:, keep.to(dev)]
        elif fault == "stale":              # 3 stages: tile 3 shares tile 0's
            kf, vf = k.clone(), v.clone()
            kf[:, 384:512], vf[:, 384:512] = k[:, :128], v[:, :128]
        elif fault == "kstep":              # S from d < 48 only
            qf = q.clone()
            qf[..., 48:] = 0
        else:
            pad = torch.zeros(2, 1024 - length, 5, 64, dtype=bf, device=dev)
            kf, vf = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
        return (lambda: flash_attention(q, k, v),
                lambda: flash_attention(qf, kf, vf))

    def tmajor_case(fault):
        q, k, v = (randn(50, 9216, 320) for _ in range(3))
        if fault == "last":
            keys = lambda x: x[..., :24, :]
        else:                               # frames 25..31: zero keys, unmasked
            keys = lambda x: torch.cat([x, x.new_zeros(*x.shape[:3], 7, 64)], -2)
        return (lambda: short_attention_tmajor(q, k, v, 25, 5),
                lambda: tmajor_faulty(q, k, v, 25, 5, keys))

    def short_case(fault):
        q, k, v = (randn(18432, 25, 5, 64) for _ in range(3))
        if fault == "last":
            return (lambda: short_attention(q, k, v),
                    lambda: attention_plain(q, k[:, :24], v[:, :24]))

        def unwritten():                    # tasks (b, h), h fastest
            out = short_attention(q, k, v).transpose(1, 2).reshape(-1, 25, 64)
            out[-short_walk_warps(64):] = 0
            return out.reshape(18432, 5, 25, 64).transpose(1, 2)
        return lambda: short_attention(q, k, v), unwritten

    def short32_case(tmajor):
        """fp32 short attention at the training site, tmajor [25, 2304,
        320] or classic [2304, 25, 5, 64], against one TF32 product for
        each fp32 product (the split's corrections dropped)."""
        rn32 = lambda *s: torch.randn(*s, generator=g, device=dev)
        if tmajor:
            q, k, v = (rn32(25, 2304, 320) for _ in range(3))
            run = lambda: short_attention_tmajor(q, k, v, 25, 5)
            heads = lambda x: x.reshape(1, 25, 2304, 5, 64).permute(0, 2, 3, 1, 4)
            back = lambda o: o.permute(0, 3, 1, 2, 4).reshape(25, 2304, 320)
        else:
            q, k, v = (rn32(2304, 25, 5, 64) for _ in range(3))
            run = lambda: short_attention(q, k, v)
            heads = lambda x: x.transpose(1, 2)
            back = lambda o: o.transpose(1, 2)

        def one_product():
            qh, kh, vh = (tf32_round(heads(t)) for t in (q, k, v))
            p = torch.softmax(qh @ kh.transpose(-1, -2) * 64 ** -0.5, dim=-1)
            return back(tf32_round(p) @ vh)
        return run, one_product

    def ffn_case():
        c = 320
        x = randn(460800, c)
        ls, lb = randn(c, scale=0.2).float() + 1.0, randn(c, scale=0.2).float()
        w0, b0 = randn(8 * c, c, scale=c ** -0.5), randn(8 * c, scale=0.1)
        w2, b2 = randn(c, 4 * c, scale=(4 * c) ** -0.5), randn(c, scale=0.1)
        w2f = w2.clone()
        w2f[:, :16] = 0
        return (lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2),
                lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2f, b2))

    def ffn_stage_case(fault):
        c = 320
        args = ffn_operands(g, c, 460800, bf)
        x, ls, lb, w0, b0, w2, b2 = args
        w0f, w2f = w0.clone(), w2.clone()
        if fault == "gbox":                 # N tile 0's g box from the a rows
            w0f[4 * c:4 * c + 128] = w0[:128]
        else:                               # the out GEMM's last k-tile
            w2f[:, -64:] = 0
        return (lambda: ln_geglu_ffn(*args),
                lambda: ln_geglu_ffn(x, ls, lb, w0f, b0, w2f, b2))

    def ffn_variant_case(fault):
        c, rows = 320, 460800
        args = ffn_operands(g, c, rows, bf, tail=fault == "tanh")
        x, ls, lb, w0, b0, w2, b2 = args
        if fault == "ilv":                  # the turn skipped: rows 0-63 of
            def faulty():                   # every 128 written over 64-127
                out = ln_geglu_ffn(*args)
                blocks = out.view(-1, 128, c)
                blocks[:, 64:] = blocks[:, :64]
                return out
            return lambda: ln_geglu_ffn(*args, variant="ilv"), faulty
        if fault == "pipe":                 # tile j's epilogue from j + 1's set
            w0f = w0.clone()
            for half in (0, 4 * c):         # the a rows, then the g rows
                w0f[half:half + 64] = w0[half + 64:half + 128]
                w0f[half + 64:half + 128] = w0[half:half + 64]
            return (lambda: ln_geglu_ffn(*args, variant="pipe"),
                    lambda: ln_geglu_ffn(x, ls, lb, w0f, b0, w2, b2))
        if fault == "geglu":                # the gate half of b0 dropped
            b0f = b0.clone()
            b0f[4 * c:] = 0
            return (lambda: geglu_ffn(x, w0, b0, w2, b2),
                    lambda: geglu_ffn(x, w0, b0f, w2, b2))
        # tanh: the erf function, at the negative-tail gate inputs
        return lambda: ln_geglu_ffn(*args, variant="tanh"), lambda: ln_geglu_ffn(*args)

    def ffn32_case(fault):
        c = 320
        args = ffn_operands(g, c, 57600, torch.float32)
        x, ls, lb, w0, b0, w2, b2 = args
        if fault == "1xtf32":
            def one_product():
                xn = ffn_ln_rows_plain(x, ls, lb)
                h = ffn_gemm_gate_plain(tf32_round(xn), tf32_round(w0), b0)
                return ffn_gemm_out_plain(tf32_round(h), tf32_round(w2), b2, x)
            return lambda: ln_geglu_ffn(*args), one_product
        w2f = w2.clone()                    # the out GEMM's last k-tile of 32
        w2f[:, -32:] = 0
        return (lambda: ln_geglu_ffn(*args),
                lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2f, b2))

    def flash32_case(fault):
        rn32 = lambda *s: torch.randn(*s, generator=g, device=dev)
        if fault == "1xtf32":
            q, k, v = (rn32(25, 2304, 5, 64) for _ in range(3))

            def one_product():
                qh, kh, vh = (tf32_round(t).transpose(1, 2) for t in (q, k, v))
                p = torch.softmax(qh @ kh.transpose(-1, -2) * 64 ** -0.5, dim=-1)
                return (tf32_round(p) @ vh).transpose(1, 2)
            return lambda: flash_attention(q, k, v), one_product
        q, k, v = (rn32(2, 1000, 5, 64) for _ in range(3))
        keep = torch.cat([torch.arange(64), torch.arange(128, 1000)]).to(dev)
        return (lambda: flash_attention(q, k, v),
                lambda: flash_attention(q, k[:, keep], v[:, keep]))

    def sums_case():
        x3 = randn(50, 9216, 320, mean=0.5)
        cut = x3.shape[1] - slab_rows(320, bf)
        return (lambda: channel_sums(x3),
                lambda: channel_sums_plain(x3[:, :cut]))

    def splat_case(fault):
        from mofa_tpu_torch.kernels.softsplat import softsplat, splat_plain
        h, w, c = SPLAT_SITES[0]
        fr = SPLAT_FRAMES
        src, flow, _ = splat_inputs(g, h, w, c, bf)
        run = lambda: softsplat(src, flow, None, "avg", fr)
        if fault == "source":           # the last frame reads the other half's map
            frame_src = torch.arange(2 * fr, device=dev) // fr
            frame_src[-1] = 0
            return run, lambda: softsplat(src[frame_src], flow, None, "avg")

        def norm_tap_skipped():         # tap (x1, y1) never reaches the plane
            acc = splat_plain(src, flow, None, fr)
            wsum = splat_plain(torch.ones_like(src[..., :1]), flow, None, fr)
            f = flow.float()
            tx = torch.arange(w, device=dev) + f[..., 0]
            ty = torch.arange(h, device=dev)[:, None] + f[..., 1]
            x1, y1 = torch.floor(tx) + 1, torch.floor(ty) + 1
            w3 = (tx - x1 + 1) * (ty - y1 + 1)
            inside = ((x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
                      & torch.isfinite(tx) & torch.isfinite(ty))
            flat = (y1.clamp(0, h - 1) * w + x1.clamp(0, w - 1)).long()
            tap3 = torch.zeros(2 * fr, h * w + 1, device=dev)
            tap3.scatter_add_(1, torch.where(inside, flat, h * w).reshape(2 * fr, -1),
                              torch.where(inside, w3, 0.0).reshape(2 * fr, -1))
            norm = wsum - tap3[:, :h * w].reshape(2 * fr, h, w, 1)
            return (acc / (norm + 1e-7)).to(bf)
        return run, norm_tap_skipped

    def conv_box_case(fault):
        from mofa_tpu_torch.kernels.conv_fused import act_plain
        x = randn(50, 72, 128, 320)
        c = 320
        a, b = randn(50, c, scale=0.3, mean=1.0).float(), randn(50, c, scale=0.2).float()
        w = randn(3, 3, c, c, scale=1.7 / (9 * c) ** 0.5)
        bias = randn(c, scale=0.1).float()
        run = lambda: gn_silu_conv3x3(x, a, b, w, bias)
        if fault == "box":              # tap (0, 0)'s first 64-channel box skipped
            wf = w.clone()
            wf[0, 0, :64] = 0
            return run, lambda: gn_silu_conv3x3(x, a, b, wf, bias)

        def border_silu_b():            # x padded with 0 before the activation
            yp = act_plain(torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)), a, b)
            out = torch.nn.functional.conv2d(yp.permute(0, 3, 1, 2),
                                             w.permute(3, 2, 0, 1))
            return (out.permute(0, 2, 3, 1).float() + bias).to(bf)
        return run, border_silu_b

    def tconv_case(fault):
        from mofa_tpu_torch.kernels.conv_fused import act_plain, tconv3_plain
        x = randn(2, 25, 9216, 320)
        c = 320
        a, b = randn(2, c, scale=0.3, mean=1.0).float(), randn(2, c, scale=0.2).float()
        w = randn(3, c, c, scale=1.7 / (3 * c) ** 0.5)
        bias = randn(c, scale=0.1).float()
        temb = randn(2, 25, c, scale=0.3).float()
        if fault == "frames":           # x padded with 0 frames before the activation
            def frames_silu_b():
                yp = act_plain(torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1)), a, b)
                out = torch.nn.functional.conv2d(
                    yp.permute(0, 3, 1, 2).float(), w.float().permute(2, 1, 0)[..., None])
                return (out.permute(0, 2, 3, 1) + bias.to(bf).float()).to(bf)
            return lambda: gn_silu_tconv3(x, a, b, w, bias), frames_silu_b
        if fault == "temb":             # frames 2k and 2k+1: frame 2k's temb
            first = temb[:, torch.arange(25, device=dev) // 2 * 2]
            return (lambda: gn_silu_tconv3(x, a, b, w, bias, temb),
                    lambda: tconv3_plain(x, a, b, w, bias, first))
        wf = w.clone()                  # tap t+1 read at frame t: y_t (w1 + w2)
        wf[1], wf[2] = (w[1].float() + w[2].float()).to(bf), 0
        return (lambda: gn_silu_tconv3(x, a, b, w, bias),
                lambda: gn_silu_tconv3(x, a, b, wf, bias))

    def conv_case(temporal):
        x = randn(2, 25, 9216, 320) if temporal else randn(50, 72, 128, 320)
        n, c = x.shape[0], 320
        a, b = randn(n, c, scale=0.3, mean=1.0).float(), randn(n, c, scale=0.2).float()
        taps = (3,) if temporal else (3, 3)
        w = randn(*taps, c, c, scale=1.7 / (3 ** len(taps) * c) ** 0.5)
        bias = randn(c, scale=0.1).float()
        wf = w.clone()
        if temporal:
            wf[0] = 0                           # the t-1 tap
        else:
            wf[1, 1] = 0                        # the centre tap
        fn = gn_silu_tconv3 if temporal else gn_silu_conv3x3
        return (lambda: fn(x, a, b, w, bias), lambda: fn(x, a, b, wf, bias))

    cases = [("flash_attention", "B=25 L=2304 H=5 D=64, one TF32 product",
              lambda: flash32_case("1xtf32"), "fp32"),
             ("flash_attention", "B=2 L=1000 H=5 D=64, keys 64-127 skipped",
              lambda: flash32_case("tile"), "fp32"),
             ("ln_geglu_ffn", "rows=57600 C=320, one TF32 product",
              lambda: ffn32_case("1xtf32"), "fp32"),
             ("ln_geglu_ffn", "rows=57600 C=320, out GEMM last k-tile",
              lambda: ffn32_case("ktile"), "fp32"),
             ("short_attention_tmajor", "BT=25 S=2304 HD=320, one TF32 product",
              lambda: short32_case(True), "fp32"),
             ("short_attention", "B=2304 L=25 H=5 D=64, one TF32 product",
              lambda: short32_case(False), "fp32"),
             ("flash_attention", "B=2 L=9216 H=5 D=64, keys 64-127 skipped",
              lambda: flash_case(9216, "tile")),
             ("flash_attention", "B=2 L=1000 H=5 D=64, tail unmasked",
              lambda: flash_case(1000, "tail")),
             ("flash_attention", "B=2 L=9216 H=5 D=64, stale ring stage",
              lambda: flash_case(9216, "stale")),
             ("flash_attention", "B=2 L=9216 H=5 D=64, last S k-step skipped",
              lambda: flash_case(9216, "kstep")),
             ("short_attention_tmajor", "BT=50 S=9216 HD=320, last frame unread",
              lambda: tmajor_case("last")),
             ("short_attention_tmajor", "BT=50 S=9216 HD=320, pad keys unmasked",
              lambda: tmajor_case("pad")),
             ("short_attention", "B=18432 L=25 H=5 D=64, last key unread",
              lambda: short_case("last")),
             ("short_attention", "B=18432 L=25 H=5 D=64, walk's last unwritten",
              lambda: short_case("walk")),
             ("ln_geglu_ffn", "rows=460800 C=320, inner 0-15 dropped",
              ffn_case),
             ("ln_geglu_ffn", "rows=460800 C=320, a*gelu(a) in N tile 0",
              lambda: ffn_stage_case("gbox")),
             ("ln_geglu_ffn", "rows=460800 C=320, out GEMM last k-tile",
              lambda: ffn_stage_case("ktile")),
             ("ln_geglu_ffn_ilv", "rows=460800 C=320, 2nd tile over 1st's rows",
              lambda: ffn_variant_case("ilv")),
             ("ln_geglu_ffn_pipe", "rows=460800 C=320, tile j holds j+1's set",
              lambda: ffn_variant_case("pipe")),
             ("geglu_ffn", "rows=460800 C=320, gate half of b0 dropped",
              lambda: ffn_variant_case("geglu")),
             ("ln_geglu_ffn_tanh", "rows=460800 C=320 tail gates, vs erf",
              lambda: ffn_variant_case("tanh")),
             ("channel_sums", "[50, 9216, 320], last S-slab skipped",
              sums_case),
             ("softsplat", "N=48 h=72 w=128 C=320 avg, last frame's source",
              lambda: splat_case("source")),
             ("softsplat", "N=48 h=72 w=128 C=320 avg, plane skips a tap",
              lambda: splat_case("norm")),
             ("gn_silu_conv3x3", "[50, 72, 128, 320]->320, centre tap dropped",
              lambda: conv_case(False)),
             ("gn_silu_conv3x3", "[50, 72, 128, 320]->320, border silu(b)",
              lambda: conv_box_case("border")),
             ("gn_silu_conv3x3", "[50, 72, 128, 320]->320, one tap box skipped",
              lambda: conv_box_case("box")),
             ("gn_silu_tconv3", "[2, 25, 9216, 320]->320, t-1 tap dropped",
              lambda: conv_case(True)),
             ("gn_silu_tconv3", "[2, 25, 9216, 320]->320, end frames silu(b)",
              lambda: tconv_case("frames")),
             ("gn_silu_tconv3", "[2, 25, 9216, 320]->320, tile's 1st-frame temb",
              lambda: tconv_case("temb")),
             ("gn_silu_tconv3", "[2, 25, 9216, 320]->320, t+1 box at frame t",
              lambda: tconv_case("tap"))]
    passed = []
    for name, label, make, *dn in cases:
        dn = dn[0] if dn else "bf16"
        with torch.no_grad():
            kernel_fn, faulty_fn = make()
            got = kernel_fn()
            with kernels.plain_reference():
                bad = faulty_fn()
            fine, err, ref_max, rms = judge(name, dn, got, bad)
        caught = not fine
        log(f"  {name:24s} {dn:4s} {label:44s} max|diff| {err:.3e} max|ref| "
            f"{ref_max:.3e} rel rms {rms:.3e} "
            f"{'MISS, as it must' if caught else 'PASSED: bounds too loose'}")
        if not caught:
            passed.append(f"{name}: {label}")
        del kernel_fn, faulty_fn, got, bad
        torch.cuda.empty_cache()
    return passed


# the adapter's four warp sites at 576x1024, T = 25: (h, w, C) at /8../64,
# N = 2 feature maps (the CFG halves) x 24 flows each
SPLAT_SITES = ((72, 128, 320), (36, 64, 320), (18, 32, 640), (9, 16, 1280))
SPLAT_FRAMES = 24


def splat_inputs(g, h: int, w: int, c: int, dtype, sources: int = 2):
    """`sources` distinct feature maps [sources, h, w, c] (2: the CFG
    halves; the traj path's two are equal, so a distinct pair shows a frame
    reading the wrong one; the keypoint path warps one), 24 flows a source
    [24 * sources, h, w, 2] of up to 3 px with out-of-bounds and
    non-finite pixels, and a metric [24 * sources, h, w, 1] in [0, 1)."""
    import torch
    dev = g.device
    src = torch.randn(sources, h, w, c, generator=g, device=dev).to(dtype)
    n = sources * SPLAT_FRAMES
    flow = torch.randn(n, h, w, 2, generator=g, device=dev) * 3.0
    flow[:, 0, :, 0] = -40.0
    flow[:, 1, ::7, 1] = float("nan")
    flow[:, 2, ::5, 0] = float("inf")
    metric = torch.rand(n, h, w, 1, generator=g, device=dev)
    return src, flow, metric


def softsplat_avg_old(src, flow, frames: int):
    """The 'avg' wrapper path before the splat's redesign: the feature map
    expanded to every frame, cast to fp32, a ones channel appended (C + 1),
    the raw splat, then the divide and the cast, each its own pass. The
    redesigned kernel's scalar route (C + 1 is not a multiple of 4) is the
    first version's kernel thread for thread: one thread per (pixel,
    channel), four scalar fp32 atomics."""
    import torch
    from mofa_tpu_torch.kernels.softsplat import splat_raw
    n, h, w, c = src.shape
    x = src[:, None].expand(n, frames, h, w, c).reshape(n * frames, h, w, c)
    x = x.float()
    x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    out = splat_raw(x, flow.float())
    return (out[..., :-1] / (out[..., -1:] + 1e-7)).to(src.dtype)


def softsplat_checks(results, g, dev) -> None:
    """softsplat at the adapter's four sites with the source broadcast as
    the adapter passes it (frames_per_source = 24, bf16): the raw splat
    (sums and normaliser plane, fp32 bounds) and every mode against the
    plain version; fp32 at /8. At /8 the raw splat's time (the row's ms)
    and the whole 'avg' call, new against the old wrapper path, with the
    accumulator's zero fill and the raw splat along a smooth flow
    (`avg_call_ms`)."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.kernels.softsplat import softsplat, splat_raw
    bf, fr = torch.bfloat16, SPLAT_FRAMES
    for h, w, c in SPLAT_SITES:
        timed = (h, w) == (72, 128)
        src, flow, metric = splat_inputs(g, h, w, c, bf)
        label = f"N=48 h={h} w={w} C={c} bf16 source x{fr}"
        acc_bytes = 2 * fr * h * w * (c + 1) * 4
        _check(results, "softsplat", "fp32", label + ", raw",
               lambda: splat_raw(src, flow, None, fr, with_norm=True),
               lambda: splat_raw(src, flow, None, fr, with_norm=True), timed,
               work=(8 * 2 * fr * h * w * c, nbytes(src, flow) + acc_bytes,
                     "fp32"))
        for mode in ("sum", "avg", "linear", "soft"):
            m = None if mode in ("sum", "avg") else metric
            _check(results, "softsplat", "bf16", label + f", {mode}",
                   lambda: softsplat(src, flow, m, mode, fr),
                   lambda: softsplat(src, flow, m, mode, fr), False)
        if timed:
            src32 = src.float()
            _check(results, "softsplat", "fp32", f"N=48 h={h} w={w} C={c} "
                   f"fp32 source x{fr}, avg",
                   lambda: softsplat(src32, flow, None, "avg", fr),
                   lambda: softsplat(src32, flow, None, "avg", fr), False)
            old = lambda: softsplat_avg_old(src, flow, fr)
            new = lambda: softsplat(src, flow, None, "avg", fr)
            with torch.no_grad():
                got_old, got_new = old(), new()
                err_old = agreement(got_old, got_new)
                x321 = torch.randn(2 * fr, h, w, c + 1, generator=g, device=dev)
                call = {"new": time_ms(new), "old_wrapper": time_ms(old)}
                with kernels.plain_reference():
                    call["plain"] = time_ms(new)
                call["old_kernel_c321"] = time_ms(lambda: splat_raw(x321, flow))
                # where the raw splat's time goes: the accumulator's zero
                # fill, and the same splat along a smooth flow (the main
                # path's flows are smooth; the checks' are random per pixel)
                call["zero_fill"] = time_ms(lambda: torch.zeros(
                    2 * fr, h, w, c, device=dev, dtype=torch.float32))
                smooth = torch.nn.functional.interpolate(
                    torch.randn(2 * fr, 2, h // 8, w // 8, generator=g, device=dev)
                    * 3.0, size=(h, w), mode="bilinear").permute(0, 2, 3, 1)
                smooth = smooth.contiguous()
                call["raw_smooth_flow"] = time_ms(
                    lambda: splat_raw(src, smooth, None, fr, with_norm=True))
                call["bound"] = bound(8 * 2 * fr * h * w * c,
                                      nbytes(src, flow, got_new), "fp32")[0]
            results["softsplat"]["avg_call_ms"] = call
            log(f"  {'softsplat':24s} bf16 avg call N=48 h={h} w={w} C={c}: "
                + "  ".join(f"{k} {v:.3f}" for k, v in call.items())
                + f" ms; old path vs new: max|diff| {err_old[0]:.3e}")
            if not within("softsplat", "bf16", *err_old):
                results["softsplat"]["ok"] = False
            del src32, x321, got_old, got_new, smooth
        del src, flow, metric
        torch.cuda.empty_cache()


def ffn_stages(results, g, c: int, rows: int) -> None:
    """The bf16 FFN route's three stages alone at rows x c: each against
    its plain version on the same inputs with the bf16 bounds of
    ln_geglu_ffn (h from the gate GEMM alone, so a fault shows in its
    stage), and the gate GEMM's "ilv" and "pipe" schedules against the same
    plain version with their variants' bounds; each stage's time beside
    one cuBLAS call of the same product (F.linear without bias, gate or
    residual: no stock call computes the stages' epilogues), stored as the
    row's `stage_ms_c<c>`. The three gate schedules are timed in turns
    (plain, ilv, pipe, pipe, ilv, plain; the mean of each pair), and each
    schedule's row gets its gate time beside plain's and cuBLAS's."""
    import torch
    import torch.nn.functional as F
    from mofa_tpu_torch.kernels.geglu_ffn import (SCHEDULES, ffn_gemm_gate,
                                                  ffn_gemm_out, ffn_ln_rows)
    x, ls, lb, w0, b0, w2, b2 = ffn_operands(g, c, rows, torch.bfloat16)
    with torch.no_grad():
        xn = ffn_ln_rows(x, ls, lb)
        h = ffn_gemm_gate(xn, w0, b0)
    gate = {s: (lambda s=s: ffn_gemm_gate(xn, w0, b0, schedule=s))
            for s in SCHEDULES}
    runs = {"ln": lambda: ffn_ln_rows(x, ls, lb), "gate": gate["plain"],
            "out": lambda: ffn_gemm_out(h, w2, b2, x)}
    for stage, fn in runs.items():
        _check(results, "ln_geglu_ffn", "bf16", f"{stage} stage rows={rows} C={c}",
               fn, fn, False)
    for s in SCHEDULES[1:]:
        _check(results, f"ln_geglu_ffn_{s}", "bf16",
               f"gate stage rows={rows} C={c}", gate[s], gate["plain"], False)
    with torch.no_grad():
        gate_ms = dict.fromkeys(SCHEDULES, 0.0)
        for s in SCHEDULES + SCHEDULES[::-1]:
            gate_ms[s] += time_ms(gate[s]) / 2
        split = {"ln": time_ms(runs["ln"]), "gate": gate_ms["plain"],
                 **{f"gate_{s}": gate_ms[s] for s in SCHEDULES[1:]},
                 "out": time_ms(runs["out"])}
        split["cublas_gate"] = time_ms(lambda: F.linear(xn, w0))
        split["cublas_out"] = time_ms(lambda: F.linear(h, w2))
    results["ln_geglu_ffn"][f"stage_ms_c{c}"] = split
    for s in SCHEDULES[1:]:
        results[f"ln_geglu_ffn_{s}"][f"stage_ms_c{c}"] = {
            "gate": gate_ms[s], "plain_gate": gate_ms["plain"],
            "cublas_gate": split["cublas_gate"]}
    log(f"  {'ln_geglu_ffn':24s} bf16 stages rows={rows} C={c}: "
        + "  ".join(f"{k} {v:.3f}" for k, v in split.items()) + " ms")
    del x, xn, h, runs, gate
    torch.cuda.empty_cache()


# flash's main-path sites besides /8 (timed at B*T = 50 as `ms_b50`): the
# self-attention of the UNet's and the ControlNet trunk's spatial
# transformer blocks at L >= 576, SVD-XT heads (UNet 5 / 10 / 20, trunk
# 5 / 10 / 10 at /8 / /16 / /32). Each site's launches come from the main
# path's own run (`kernels.launch_counts_by_shape`), which must reach all
# four shapes.
FLASH_SITES = (("/16", 50, 2304, 10, 64),
               ("/32 UNet", 50, 576, 20, 64),
               ("/32 trunk", 50, 576, 10, 128))
FLASH_MAIN_SHAPES = (("/8", 50, 9216, 5, 64),) + FLASH_SITES


# The keypoint path's shapes (512^2, windows of 25 frames, CFG batch 2, so
# B*T = 50 rows): flash at /8 and /16 (/32 has 256 tokens and stays
# plain), the tmajor sites /8 ... /64, the FFN's C=320 / 640 rows, and the
# warp of one source (B rows) along 24 flows at /8 ... /64.
KP_FLASH = ((50, 4096, 5, 64), (50, 1024, 10, 64))
KP_TMAJOR = ((4096, 320, 5), (1024, 640, 10), (256, 1280, 20), (64, 1280, 20))
KP_FFN = ((320, 50 * 4096), (640, 50 * 1024))
KP_SPLAT = ((64, 64, 320), (32, 32, 320), (16, 16, 640), (8, 8, 1280))


def flash_plain_chunks(q, k, v, logit_bytes: float = 8e9):
    """Flash's plain version over batch chunks whose fp32 logits take at
    most `logit_bytes` (at B*T = 50, L = 9216 they would take 85 GB); it is
    row-independent, so the chunks compute the same function."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.kernels.flash_attention import flash_attention
    b, L, h, _ = q.shape
    step = max(1, int(logit_bytes // (h * L * L * 4)))
    with kernels.plain_reference():
        return torch.cat([flash_attention(q[j:j + step], k[j:j + step], v[j:j + step])
                          for j in range(0, b, step)])


def keypoint_kernel_checks(results, g) -> None:
    """The four kernels of the keypoint path against their plain versions
    at that path's shapes, bf16, with the bf16 bounds; the first shape of
    each timed (kernel, plain, SDPA or stock chain, bound), its keys ending
    in `_keypoint`, and flash's /16 site as well (`_keypoint16`). Flash's plain version runs in batch chunks of 10 (its
    fp32 logits at B=50, L=4096 would take 17 GB); it is row-independent,
    so the chunks compute the same function."""
    import torch
    import torch.nn.functional as F
    from mofa_tpu_torch.kernels.flash_attention import flash_attention
    from mofa_tpu_torch.kernels.geglu_ffn import ln_geglu_ffn
    from mofa_tpu_torch.kernels.short_attention import short_attention_tmajor
    from mofa_tpu_torch.kernels.softsplat import softsplat, splat_raw

    bf, dev = torch.bfloat16, g.device
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev).to(bf)
    sfx = "_keypoint"
    for i, (B, L, H, D) in enumerate(KP_FLASH):
        q, k, v = (randn(B, L, H, D) for _ in range(3))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        _check(results, "flash_attention", "bf16", f"keypoint B={B} L={L} H={H} D={D}",
               lambda: flash_attention(q, k, v),
               lambda: torch.cat([flash_attention(q[j:j + 10], k[j:j + 10], v[j:j + 10])
                                  for j in range(0, B, 10)]), True,
               library_fn=lambda: F.scaled_dot_product_attention(qh, kh, vh),
               work=(4 * B * H * L * L * D, 4 * nbytes(q), "bf16"),
               suffix=sfx if i == 0 else sfx + "16")
        del q, k, v, qh, kh, vh
    for i, (S, HD, H) in enumerate(KP_TMAJOR):
        q, k, v = (randn(50, S, HD) for _ in range(3))
        to4 = lambda x: x.reshape(2, 25, S, H, HD // H).permute(
            0, 2, 1, 3, 4).reshape(2 * S, 25, H, HD // H).transpose(1, 2).contiguous()
        q4, k4, v4 = to4(q), to4(k), to4(v)
        _check(results, "short_attention_tmajor", "bf16",
               f"keypoint BT=50 S={S} HD={HD} H={H}",
               lambda: short_attention_tmajor(q, k, v, 25, H),
               lambda: short_attention_tmajor(q, k, v, 25, H), i == 0,
               library_fn=lambda: F.scaled_dot_product_attention(q4, k4, v4),
               work=(4 * 2 * S * H * 25 * 25 * (HD // H), 4 * nbytes(q), "bf16"),
               suffix=sfx)
        del q, k, v, q4, k4, v4
    for i, (C, R) in enumerate(KP_FFN):
        args = ffn_operands(g, C, R, bf)
        x, ls, lb, w0, b0, w2, b2 = args
        _check(results, "ln_geglu_ffn", "bf16", f"keypoint rows={R} C={C}",
               lambda: ln_geglu_ffn(*args), lambda: ln_geglu_ffn(*args), i == 0,
               chain_fn=lambda: ffn_chain(x, (ls, lb), *args[3:]),
               work=(24 * R * C * C, 2 * nbytes(x) + nbytes(w0, w2), "bf16"),
               suffix=sfx)
        del args, x, w0, w2
    fr = SPLAT_FRAMES
    for i, (h, w, c) in enumerate(KP_SPLAT):
        src, flow, _ = splat_inputs(g, h, w, c, bf, sources=1)
        label = f"keypoint N=24 h={h} w={w} C={c} bf16 source x{fr}"
        _check(results, "softsplat", "fp32", label + ", raw",
               lambda: splat_raw(src, flow, None, fr, with_norm=True),
               lambda: splat_raw(src, flow, None, fr, with_norm=True), i == 0,
               work=(8 * fr * h * w * c,
                     nbytes(src, flow) + fr * h * w * (c + 1) * 4, "fp32"),
               suffix=sfx)
        _check(results, "softsplat", "bf16", label + ", avg",
               lambda: softsplat(src, flow, None, "avg", fr),
               lambda: softsplat(src, flow, None, "avg", fr), False)
        del src, flow
    torch.cuda.empty_cache()


def phase_kernels() -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from mofa_tpu_torch.kernels.conv_fused import (conv3x3_plain,
                                                   gn_silu_conv3x3,
                                                   gn_silu_tconv3,
                                                   tconv3_plain)
    from mofa_tpu_torch.kernels.flash_attention import flash_attention
    from mofa_tpu_torch.kernels.geglu_ffn import geglu_ffn, ln_geglu_ffn
    from mofa_tpu_torch.kernels.group_norm import (channel_sums,
                                                   fused_group_norm)
    from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                        short_attention_tmajor)
    from mofa_tpu_torch.models.layers import GroupNorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    results: dict = {}

    def randn(*shape, dtype=torch.float32, scale=1.0, mean=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale
                + mean).to(dtype)

    def sdpa(q, k, v):
        """One PyTorch call on contiguous [B, H, L, D] copies (the copy is
        made here, not timed)."""
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qh, kh, vh)

    # flash: UNet /8 /16 /32 (D=64), trunk /32 (D=128), a ragged L.
    # Batch cut to 2 (bf16) / 1 (fp32): the plain version's fp32 logits
    # at B*T=50, L=9216 would need ~85 GB.
    for L, H, D, timed in ((9216, 5, 64, True), (2304, 10, 64, False),
                           (576, 20, 64, False), (576, 10, 128, False),
                           (1000, 5, 64, False)):
        for dn in ("bf16", "fp32"):
            B = 2 if dn == "bf16" else 1
            q, k, v = (randn(B, L, H, D, dtype=dts[dn]) for _ in range(3))
            _check(results, "flash_attention", dn, f"B={B} L={L} H={H} D={D}",
                   lambda: flash_attention(q, k, v),
                   lambda: flash_attention(q, k, v), timed and dn == "bf16",
                   library_fn=sdpa(q, k, v) if timed and dn == "bf16" else None,
                   work=(4 * B * H * L * L * D, 4 * nbytes(q), "bf16"))
    # the fp32 route at the stage-1 training site (384^2, 25 frames, /8),
    # timed beside its plain version and SDPA's fp32 forward (keys end in
    # _fp32; the bound split TF32's, the CUDA cores' beside it)
    q, k, v = (randn(25, 2304, 5, 64) for _ in range(3))
    work = (4 * 25 * 5 * 2304 ** 2 * 64, 4 * nbytes(q), "split_tf32")
    _check(results, "flash_attention", "fp32", "B=25 L=2304 H=5 D=64",
           lambda: flash_attention(q, k, v), lambda: flash_attention(q, k, v), True,
           library_fn=sdpa(q, k, v), work=work, suffix="_fp32")
    fp32_cores_bound(results["flash_attention"], work, "_fp32")
    del q, k, v
    torch.cuda.empty_cache()
    # flash at the main path's own /8 shape, B*T = 50 (7 of its 21 launches
    # a step): the kernel, SDPA and the plain version in batch chunks
    q, k, v = (randn(50, 9216, 5, 64, dtype=torch.bfloat16) for _ in range(3))
    r = results["flash_attention"]
    with torch.no_grad():
        r["ms_b50"] = time_ms(lambda: flash_attention(q, k, v))
        r["library_ms_b50"] = time_ms(sdpa(q, k, v))
        r["plain_ms_b50"] = time_ms(lambda: flash_plain_chunks(q, k, v))
    r["bound_ms_b50"] = bound(4 * 50 * 5 * 9216 ** 2 * 64, 4 * nbytes(q), "bf16")[0]
    log(f"  {'flash_attention':24s} bf16 {'B=50 L=9216 H=5 D=64 (timing only)':38s} "
        f"ms {r['ms_b50']:.3f}  library_ms {r['library_ms_b50']:.3f}  plain_ms "
        f"{r['plain_ms_b50']:.3f}  bound {r['bound_ms_b50']:.3f} ms (operations)")
    # and beside SDPA at the main path's other sites (FLASH_SITES, stored as
    # the row's `sites`) and at D = 128 with a long L (short rows against
    # two consumer warpgroups)
    r["sites"] = {}
    for site, B, L, H, D in FLASH_SITES + (("D=128 long L", 2, 9216, 5, 128),):
        q, k, v = (randn(B, L, H, D, dtype=torch.bfloat16) for _ in range(3))
        with torch.no_grad():
            ms, lib_ms = time_ms(lambda: flash_attention(q, k, v)), time_ms(sdpa(q, k, v))
            plain_ms = time_ms(lambda: flash_plain_chunks(q, k, v))
        b_ms = bound(4 * B * H * L * L * D, 4 * nbytes(q), "bf16")[0]
        if site.startswith("/"):
            r["sites"][site] = dict(shape=[B, L, H, D], ms=ms, library_ms=lib_ms,
                                    plain_ms=plain_ms, bound_ms=b_ms)
        label = f"B={B} L={L} H={H} D={D} (timing only)"
        log(f"  {'flash_attention':24s} bf16 {label:38s} ms {ms:.3f}  library_ms "
            f"{lib_ms:.3f}  plain_ms {plain_ms:.3f}  bound {b_ms:.3f} ms ({site})")
        del q, k, v
        torch.cuda.empty_cache()
    # tmajor: T=25, CFG batch 2 -> B*T=50 rows of [S, H*D]
    for S, HD, H, timed in ((9216, 320, 5, True), (2304, 640, 10, False),
                            (576, 1280, 20, False), (144, 1280, 20, False),
                            (576, 1280, 10, False)):
        for dn in ("bf16", "fp32"):
            q, k, v = (randn(50, S, HD, dtype=dts[dn]) for _ in range(3))
            lib = None
            if timed and dn == "bf16":       # SDPA on the [B*S, H, T, D] view
                to4 = lambda x: x.reshape(2, 25, S, H, HD // H).permute(
                    0, 2, 1, 3, 4).reshape(2 * S, 25, H, HD // H)
                lib = sdpa(to4(q), to4(k), to4(v))
            _check(results, "short_attention_tmajor", dn,
                   f"BT=50 S={S} HD={HD} H={H}",
                   lambda: short_attention_tmajor(q, k, v, 25, H),
                   lambda: short_attention_tmajor(q, k, v, 25, H),
                   timed and dn == "bf16", library_fn=lib,
                   work=(4 * 2 * S * H * 25 * 25 * (HD // H), 4 * nbytes(q),
                         "bf16"))
    # the fp32 route (split TF32 on mma.sync) at the stage-1 training site
    # (384^2, 25 frames, /8: row 2t), timed beside its plain version and
    # SDPA's fp32 forward on the [B*S, H, T, D] view (keys end in _fp32;
    # the bound split TF32's, the CUDA cores' beside it)
    q, k, v = (randn(25, 2304, 320) for _ in range(3))
    to4 = lambda x: x.reshape(1, 25, 2304, 5, 64).permute(0, 2, 1, 3, 4).reshape(
        2304, 25, 5, 64)
    work = (4 * 2304 * 5 * 25 * 25 * 64, 4 * nbytes(q), "split_tf32")
    _check(results, "short_attention_tmajor", "fp32", "BT=25 S=2304 HD=320 H=5",
           lambda: short_attention_tmajor(q, k, v, 25, 5),
           lambda: short_attention_tmajor(q, k, v, 25, 5), True,
           library_fn=sdpa(to4(q), to4(k), to4(v)), work=work, suffix="_fp32")
    fp32_cores_bound(results["short_attention_tmajor"], work, "_fp32")
    queued_times(results["short_attention_tmajor"], "_fp32",
                 lambda: short_attention_tmajor(q, k, v, 25, 5), sdpa(to4(q), to4(k), to4(v)))
    del q, k, v
    # classic short attention: [B*S, T, H, D] at the /8 temporal site of
    # the classic layout (the only one its gate admits at T=25: bf16
    # timed; fp32 timed as row 5's fp32 shape, keys _fp32), at the classic
    # stage-1 training site (fp32, keys _fp32_train), at D = 128, and at
    # the 256x384, T=8 composition shapes
    for B, L, H, D, timed, dns, sfx in (
            (18432, 25, 5, 64, True, ("bf16", "fp32"), "_fp32"),
            (2304, 25, 5, 64, True, ("fp32",), "_fp32_train"),
            (1111, 25, 3, 128, False, ("bf16", "fp32"), ""),
            (3072, 8, 5, 64, False, ("bf16", "fp32"), ""),
            (768, 8, 10, 64, False, ("bf16", "fp32"), ""),
            (192, 8, 20, 64, False, ("bf16", "fp32"), "")):
        for dn in dns:
            q, k, v = (randn(B, L, H, D, dtype=dts[dn]) for _ in range(3))
            work = (4 * B * H * L * L * D, 4 * nbytes(q),
                    "bf16" if dn == "bf16" else "split_tf32")
            _check(results, "short_attention", dn, f"B={B} L={L} H={H} D={D}",
                   lambda: short_attention(q, k, v),
                   lambda: short_attention(q, k, v), timed,
                   ref32_fn=(lambda: short_attention(*upcast(q, k, v)))
                   if dn == "bf16" else None,
                   library_fn=sdpa(q, k, v) if timed else None,
                   work=work, suffix="" if dn == "bf16" else sfx)
            if timed and dn == "fp32":
                fp32_cores_bound(results["short_attention"], work, sfx)
                queued_times(results["short_attention"], sfx,
                             lambda: short_attention(q, k, v), sdpa(q, k, v))
            del q, k, v
            torch.cuda.empty_cache()
    # ln_geglu_ffn: rows of the /8 (C=320) and /16 (C=640) sites in bf16,
    # and in fp32 the training sites' rows (384^2, 25 frames: 57,600 at
    # C=320, 14,400 at C=640, whose last row tile is ragged), all timed
    # (keys: the C=640 ones end in _c640, the fp32 ones in _fp32); chain:
    # the stock LayerNorm + Linear + gelu gate + Linear + add (TF32 off).
    # The fp32 bound is split TF32's, the CUDA cores' printed beside it
    # (`bound_cores_ms` keys).
    for C, R, R32, suffix in ((320, 460800, 57600, ""), (640, 115200, 14400, "_c640")):
        for dn in ("bf16", "fp32"):
            rows = R if dn == "bf16" else R32
            args = ffn_operands(g, C, rows, dts[dn])
            x, ls, lb, w0, b0, w2, b2 = args
            sfx = suffix if dn == "bf16" else "_fp32" + suffix
            work = (24 * rows * C * C, 2 * nbytes(x) + nbytes(w0, w2),
                    "bf16" if dn == "bf16" else "split_tf32")
            _check(results, "ln_geglu_ffn", dn, f"rows={rows} C={C}",
                   lambda: ln_geglu_ffn(*args), lambda: ln_geglu_ffn(*args),
                   True, chain_fn=lambda: ffn_chain(x, (ls, lb), *args[3:]),
                   work=work, suffix=sfx)
            if dn == "fp32":
                fp32_cores_bound(results["ln_geglu_ffn"], work, sfx)
        del args, x, w0, w2
        ffn_stages(results, g, C, R)
    # the bf16 route at a ragged row count (a partial last row tile)
    for C in (320, 640):
        args = ffn_operands(g, C, 4096 + 7, torch.bfloat16)
        for name, run in (("ln_geglu_ffn", lambda a: ln_geglu_ffn(*a)),
                          ("ln_geglu_ffn_tanh", lambda a: ln_geglu_ffn(*a, variant="tanh")),
                          ("geglu_ffn", lambda a: geglu_ffn(a[0], *a[3:]))):
            _check(results, name, "bf16", f"rows={4096 + 7} C={C}",
                   lambda: run(args), lambda: run(args), False,
                   ref32_fn=lambda: run(upcast(*args)))
    # the other FFN kernels, bf16 only (entry points: no model calls them),
    # at the same shapes, also against the plain version in fp32 on the
    # upcast inputs; tanh also at gate inputs in the negative tail, where
    # it is far from erf (the planted fault holds erf against it there)
    for C, R, timed in ((320, 460800, True), (640, 115200, False)):
        args = ffn_operands(g, C, R, torch.bfloat16)
        x, ls, lb, w0, b0, w2, b2 = args
        for name, run, chain in (
                ("geglu_ffn", lambda a: geglu_ffn(a[0], *a[3:]),
                 lambda: ffn_chain(x, None, *args[3:])),
                ("ln_geglu_ffn_ilv", lambda a: ln_geglu_ffn(*a, variant="ilv"),
                 lambda: ffn_chain(x, (ls, lb), *args[3:])),
                ("ln_geglu_ffn_pipe", lambda a: ln_geglu_ffn(*a, variant="pipe"),
                 lambda: ffn_chain(x, (ls, lb), *args[3:])),
                ("ln_geglu_ffn_tanh", lambda a: ln_geglu_ffn(*a, variant="tanh"),
                 lambda: ffn_chain(x, (ls, lb), *args[3:], approximate="tanh"))):
            _check(results, name, "bf16", f"rows={R} C={C}",
                   lambda: run(args), lambda: run(args), timed,
                   ref32_fn=lambda: run(upcast(*args)),
                   chain_fn=chain if timed else None,
                   work=(24 * R * C * C, 2 * nbytes(x) + nbytes(w0, w2), "bf16"))
        del args, x, w0, w2
    tail = ffn_operands(g, 320, 460800, torch.bfloat16, tail=True)
    tanh = lambda a: ln_geglu_ffn(*a, variant="tanh")
    _check(results, "ln_geglu_ffn_tanh", "bf16", "rows=460800 C=320 tail gates",
           lambda: tanh(tail), lambda: tanh(tail), False,
           ref32_fn=lambda: tanh(upcast(*tail)))
    del tail
    softsplat_checks(results, g, dev)
    keypoint_kernel_checks(results, g)
    # channel sums of GroupNorm inputs [N, S, C] (activations with a mean):
    # UNet /8 and /16 resnets at CFG batch 2 x 25 frames, and the temporal
    # resnet's per-video [B, T*S, C]. Stock chain: the port's GroupNorm on
    # NCHW, which computes these statistics and applies them.
    for N, S, C, hw, timed in ((50, 9216, 320, (72, 128), True),
                               (50, 2304, 640, (36, 64), False),
                               (2, 230400, 320, None, False)):
        for dn in ("bf16", "fp32"):
            if dn == "fp32" and N == 2:
                continue
            x3 = randn(N, S, C, dtype=dts[dn], mean=0.5)
            chain = None
            if timed and dn == "bf16":
                gn = GroupNorm(32, C, eps=1e-6).to(dev, torch.bfloat16)
                x4 = x3.reshape(N, *hw, C).permute(0, 3, 1, 2).contiguous()
                gamma, beta = gn.weight.float(), gn.bias.float()
                xn = x3.reshape(N, *hw, C)
                log(f"  {'':24s}      fused_group_norm (kernel sums + "
                    f"PyTorch apply) "
                    f"{time_ms(lambda: fused_group_norm(xn, gamma, beta, 32, 1e-6)):.3f} ms")
                chain = lambda: gn(x4)
            _check(results, "channel_sums", dn, f"[{N}, {S}, {C}]",
                   lambda: channel_sums(x3), lambda: channel_sums(x3),
                   timed and dn == "bf16", chain_fn=chain,
                   work=(3 * x3.numel(), nbytes(x3) + 2 * N * C * 4, "fp32"))
    # fused GN-SiLU-conv, bf16 only: the resnets' conv1 (temb, output sums)
    # and conv2 (residual) forms at the /8 and /16 widths; stock chain:
    # GroupNorm + SiLU + Conv2d / Conv3d(3,1,1) on NCHW / NCDHW, bf16.
    for temporal, shape, timed in ((False, (50, 72, 128, 320), True),
                                   (False, (50, 36, 64, 640), False),
                                   (True, (2, 25, 9216, 320), True),
                                   (True, (2, 25, 2304, 640), False)):
        name = "gn_silu_tconv3" if temporal else "gn_silu_conv3x3"
        fn, plain = ((gn_silu_tconv3, tconv3_plain) if temporal
                     else (gn_silu_conv3x3, conv3x3_plain))
        n, c = shape[0], shape[-1]
        taps = (3,) if temporal else (3, 3)
        fan_in = 3 ** len(taps) * c
        x = randn(*shape, dtype=torch.bfloat16)
        a, b = randn(n, c, scale=0.3, mean=1.0), randn(n, c, scale=0.2)
        w = randn(*taps, c, c, dtype=torch.bfloat16, scale=1.7 / fan_in ** 0.5)
        bias = randn(c, scale=0.1)
        temb = randn(*((n, shape[1], c) if temporal else (n, c)), scale=0.3)
        res = randn(*shape, dtype=torch.bfloat16)
        chain = None
        if timed:
            gn = GroupNorm(32, c, eps=1e-6).to(dev, torch.bfloat16)
            conv = (torch.nn.Conv3d(c, c, (3, 1, 1), padding=(1, 0, 0))
                    if temporal else torch.nn.Conv2d(c, c, 3, padding=1))
            conv = conv.to(dev, torch.bfloat16)
            if temporal:       # [B, C, T, H, W] at the /8 latent grid
                xs = x.reshape(n, shape[1], 72, 128, c).permute(0, 4, 1, 2, 3)
            else:
                xs = x.permute(0, 3, 1, 2)
            xs = xs.contiguous()
            chain = lambda: conv(F.silu(gn(xs)))
        args = (x, a, b, w, bias)
        for label, kw in (("temb, sums", dict(temb_bias=temb, emit_sums=True)),
                          ("residual", dict(residual=res))):
            kw32 = {k: (v.float() if torch.is_tensor(v) else v)
                    for k, v in kw.items()}
            _check(results, name, "bf16", f"{list(shape)} {label}",
                   lambda: fn(*args, **kw), lambda: plain(*args, **kw),
                   timed and "emit_sums" in kw,
                   ref32_fn=lambda: plain(*upcast(*args), **kw32),
                   chain_fn=chain,
                   work=(2 * (x.numel() // c) * c * fan_in,
                         2 * nbytes(x) + nbytes(w, temb), "bf16"))
        conv_stages(results, temporal, x, a, b, w, bias, temb, res, timed)
        del x, res
        torch.cuda.empty_cache()
    return results


def conv_stages(results, temporal: bool, x, a, b, w, bias, temb, res,
                timed: bool) -> None:
    """A fused conv's two stages alone, each against its plain stage with
    the bf16 bounds of its route (the GEMM on the kernel's own activated y,
    so a fault shows in its stage); timed: each stage beside one cuDNN
    F.conv2d of the same product on the activated bf16 tensor (no bias,
    temb, residual or sums; the temporal conv as a (3, 1) kernel over
    [B, C, T, S]), on its channels-last view and on an NCHW copy, and the
    GEMM's other epilogue forms (neither temb nor sums; the residual);
    then the route, its GEMM and the channels-last cuDNN conv queued back
    to back (`time_queued_ms`, without the wrappers' host work); stored
    as the row's `stage_ms`."""
    import torch
    import torch.nn.functional as F
    from mofa_tpu_torch.kernels.conv_fused import (conv3x3_gemm, gn_silu_act,
                                                   gn_silu_conv3x3,
                                                   gn_silu_tconv3, tconv3_gemm)
    name = "gn_silu_tconv3" if temporal else "gn_silu_conv3x3"
    route_fn = gn_silu_tconv3 if temporal else gn_silu_conv3x3
    gemm_fn = tconv3_gemm if temporal else conv3x3_gemm
    shape = list(x.shape)
    act = lambda: gn_silu_act(x, a, b)
    gemm = lambda: gemm_fn(y, w, bias, temb, emit_sums=True)
    with torch.no_grad():
        y = act()
    _check(results, name, "bf16", f"{shape} act stage", act, act, False)
    _check(results, name, "bf16", f"{shape} gemm stage, temb, sums",
           gemm, gemm, False)
    _check(results, name, "bf16", f"{shape} gemm stage, residual",
           lambda: gemm_fn(y, w, bias, residual=res),
           lambda: gemm_fn(y, w, bias, residual=res), False)
    if timed:
        # cuDNN's OIHW weights: [O, C, 3, 1] over (T, S), or [O, C, 3, 3]
        w_oihw = (w.permute(2, 1, 0)[..., None] if temporal
                  else w.permute(3, 2, 0, 1))
        pad = (1, 0) if temporal else 1
        y_cl, w_cl = y.permute(0, 3, 1, 2), w_oihw.contiguous(
            memory_format=torch.channels_last)
        y_nchw, w_nchw = y_cl.contiguous(), w_oihw.contiguous()
        with torch.no_grad():
            split = {"act": time_ms(act), "gemm": time_ms(gemm),
                     "gemm_no_temb_sums": time_ms(lambda: gemm_fn(y, w, bias)),
                     "gemm_residual": time_ms(
                         lambda: gemm_fn(y, w, bias, residual=res)),
                     "cudnn_nhwc": time_ms(lambda: F.conv2d(y_cl, w_cl, padding=pad)),
                     "cudnn_nchw": time_ms(lambda: F.conv2d(y_nchw, w_nchw, padding=pad)),
                     "route_queued": time_queued_ms(
                         lambda: route_fn(x, a, b, w, bias, temb, emit_sums=True)),
                     "gemm_queued": time_queued_ms(gemm),
                     "cudnn_nhwc_queued": time_queued_ms(
                         lambda: F.conv2d(y_cl, w_cl, padding=pad))}
        results[name]["stage_ms"] = split
        log(f"  {name:24s} bf16 stages {shape}: "
            + "  ".join(f"{k} {v:.3f}" for k, v in split.items()) + " ms")
        del y_cl, w_cl, y_nchw, w_nchw
    del y
    torch.cuda.empty_cache()


# ------------------------------------------- phase 3b: the FFN variants

# The main path's FF sites, rows x C: the spatial blocks see B*T*H*W rows
# (CFG batch 2 x 25 frames at /8 and /16), the temporal blocks B*H*W*T rows
# at /8 (the same count as spatial /8 in another order, which a row-wise
# kernel cannot tell apart; timed on its own draw all the same).
FFN_SHAPES = (("spatial /8", 320, 50 * 72 * 128),
              ("spatial /16", 640, 50 * 36 * 64),
              ("temporal /8", 320, 2 * 9216 * 25))
FFN_RUNS = ("plain", "ilv", "pipe", "tanh", "geglu_ffn", "chain")
# the kernels only this phase runs (no model calls them)
FFN_VARIANT_KERNELS = ("geglu_ffn", "ln_geglu_ffn_ilv", "ln_geglu_ffn_pipe",
                       "ln_geglu_ffn_tanh")


def phase_ffn_variants(dev) -> dict:
    """The counterpart of tools/bench_ffn.py: at each of FFN_SHAPES, bf16,
    one pass through every FFN kernel (its launch counts must equal the
    calls), each variant's max |diff| from "plain" ("ilv" and "pipe" compute
    the same function and must sit within the bf16 bounds; "tanh" is
    reported), and the times of the variants, `geglu_ffn` and the stock
    chain. Returns the launch counts summed over the passes."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.kernels.geglu_ffn import geglu_ffn, ln_geglu_ffn

    g = torch.Generator(device=dev).manual_seed(8)
    total = dict.fromkeys(kernels.KERNELS, 0)
    one_pass = dict.fromkeys(kernels.KERNELS, 0)
    one_pass.update(ln_geglu_ffn=1, ln_geglu_ffn_ilv=1, ln_geglu_ffn_pipe=1,
                    ln_geglu_ffn_tanh=1, geglu_ffn=1)
    bad = []
    for label, c, rows in FFN_SHAPES:
        args = ffn_operands(g, c, rows, torch.bfloat16)
        x, ls, lb, w0, b0, w2, b2 = args
        runs = {v: (lambda v=v: ln_geglu_ffn(*args, variant=v))
                for v in ("plain", "ilv", "pipe", "tanh")}
        runs["geglu_ffn"] = lambda: geglu_ffn(x, w0, b0, w2, b2)
        runs["chain"] = lambda: ffn_chain(x, (ls, lb), w0, b0, w2, b2)
        with torch.no_grad():
            kernels.reset_launch_counts()
            outs = {k: runs[k]() for k in ("plain", "ilv", "pipe", "tanh",
                                           "geglu_ffn")}
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            diffs = []
            for v in ("ilv", "pipe", "tanh"):
                err, ref_max, rms = agreement(outs[v], outs["plain"])
                ok = v == "tanh" or within("ln_geglu_ffn", "bf16", err, ref_max, rms)
                diffs.append(f"{v} {err:.3e} (rel rms {rms:.3e}{'' if ok else ', MISS'})")
                if not ok:
                    bad.append(f"{label}: {v}")
            del outs
            ms = {k: time_ms(runs[k]) for k in FFN_RUNS}
        log(f"  {label:11s} rows={rows} C={c}: " + "  ".join(
            f"{k} {v:.3f}" for k, v in ms.items()) + " ms")
        log(f"  {'':11s} max|diff| from plain: " + "; ".join(diffs))
        log(f"  {'':11s} launches of one pass: "
            + str({k: n for k, n in counts.items() if n}))
        if counts != one_pass:
            bad.append(f"{label}: launches {counts}")
        for k, n in counts.items():
            total[k] += n
        del args, x, w0, w2, runs
        torch.cuda.empty_cache()
    if bad:
        fail(f"FFN variants: {bad}")
    return total


# ------------------------------------------------- inputs of the pipeline

def smooth_inputs(b: int, t: int, h: int, w: int, dev, seed: int):
    """Seeded smooth first frame [B, H, W, 3] in [0, 1] and dense flow
    [B, T-1, H, W, 2] (pixels, std 8): low-resolution noise, bilinear
    upsampled."""
    import torch
    from mofa_tpu_torch.ops.resize import resize_nhwc
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.rand(b, h // 32, w // 32, 3, generator=g, device=dev)
    img = resize_nhwc(img, (h, w), "bilinear")
    flow = torch.randn(b, t - 1, h // 64, w // 64, 2, generator=g, device=dev)
    flow = resize_nhwc(flow * 8.0, (h, w), "bilinear")
    return img.contiguous(), flow.contiguous()


def psnr(a, b) -> float:
    import math
    mse = float(((a.float() - b.float()) ** 2).mean())
    return 10.0 * math.log10(1.0 / max(mse, 1e-20))


def random_bundle(dev, seed: int, dtype):
    import torch
    from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
    from mofa_tpu_torch.models.svd_unet import SVDUNetConfig
    from mofa_tpu_torch.models.vae import VAEConfig
    from mofa_tpu_torch.pipelines.common import ModelBundle
    return ModelBundle.init_random(
        dev, torch.Generator(device=dev).manual_seed(seed), SVDUNetConfig(),
        VAEConfig(), CLIPVisionConfig(), dtype=dtype)


# The kernels each temporal layout of the pipeline launches; the other
# layout's temporal kernel must stay at 0.
LAYOUT_KERNELS = {
    "tmajor": ("flash_attention", "short_attention_tmajor", "ln_geglu_ffn",
               "softsplat"),
    "classic": ("flash_attention", "short_attention", "ln_geglu_ffn",
                "softsplat")}


def flash_levels(h: int, w: int) -> int:
    """How many of the UNet's attention levels (/8, /16, /32) pass the
    flash gate at an h x w video: Lq * Lk >= 576^2, i.e. at least 576
    latent tokens (/64 has a single transformer, in the mid block, below
    it at every size run here)."""
    return sum((h // s) * (w // s) >= 576 for s in (8, 16, 32))


def expected_launches(layout: str, steps: int, adapters: int = 1,
                      size: tuple = (576, 1024), views: int = 1,
                      window_batch: int = 1, warps: int | None = None) -> dict:
    """Launches of one 25-frame-window video at SVD-XT widths with
    `adapters` adapter trunks a denoiser call (the hybrid path runs 2),
    per the sites of each kernel. A video of `views` windows (the keypoint
    path) makes ceil(views / window_batch) denoiser calls a step and warps
    `warps` distinct views once each (default: every view). Per call: flash
    5 in the UNet (down 2, up 3) and 2 a trunk (down) at each level that
    passes the flash gate (`flash_levels`: /8, /16, /32 at 576x1024; /8,
    /16 at 512^2); the FFN kernel 30 in the UNet and 12 a trunk (the
    C=320/640 sites: one FFN a spatial block, two a temporal one);
    spatial-major: 16 temporal sites in the UNet, 7 a trunk; classic: those
    at /8 (UNet down 0 x2, up 3 x3: 5; a trunk's down 0 x2) pass the short
    gate, the H=10/20 ones have L*H > 160 and stay plain. softsplat 4 an
    adapter a warped view (its warp, once a video)."""
    from mofa_tpu_torch import kernels
    calls = steps * -(-views // window_batch)
    warps = views if warps is None else warps
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(flash_attention=(5 + 2 * adapters) * flash_levels(*size) * calls,
                ln_geglu_ffn=(30 + 12 * adapters) * calls,
                softsplat=4 * adapters * warps)
    if layout == "tmajor":
        want["short_attention_tmajor"] = (16 + 7 * adapters) * calls
    else:
        want["short_attention"] = (5 + 2 * adapters) * calls
    return want


# ------------------------------------------ phase 3c: the kernels' backward

# Stage-1 training shapes (384x384, T=25, B=1: 2304 tokens at /8, 576 at
# /16, 144 at /32): flash at /8 and /16 (/32 stays plain), the tmajor
# sites, the FFN at C=320 and 640, the adapter's four warp sites (one
# first frame splatted along 24 flows).
TRAIN_KERNELS = ("flash_attention", "short_attention_tmajor", "ln_geglu_ffn",
                 "softsplat")
BWD_FLASH = ((25, 2304, 5, 64), (25, 576, 10, 64))
BWD_TMAJOR = ((2304, 320, 5), (576, 640, 10), (144, 1280, 20))
BWD_FFN = ((320, 25 * 2304), (640, 25 * 576))
BWD_SPLAT = ((48, 48, 320), (24, 24, 320), (12, 12, 640), (6, 6, 1280))
# the classic layout's site (MOFA_TMAJOR=0): [B*S, T, H, D] at /8; the /8
# resnet's GroupNorm and 3x3 conv input [T, 48, 48, C], its temporal conv's
# [B, T, S, C]
BWD_SHORT = (2304, 25, 5, 64)
BWD_GN = (25, 48, 48, 320)
BWD_TCONV = (1, 25, 2304, 320)
# Bounds on each gradient of a kernel's autograd route (kernel forward,
# stock backward) against plain autograd through the plain version, as
# (max_rel, rms_rel) of each gradient tensor: fp32, both sides fp32 math
# in other orders (the kernels' forward sums, the splat's atomics); bf16,
# the plain version's autograd rounds its intermediates (P, the LN output,
# the gate) to bf16 where the backward functions recompute in fp32, the
# JAX rules' way. A few times above the sound readings (fp32 2.1e-6 /
# 9.8e-7, bf16 6.0e-3 / 2.6e-3 at the worst), far below those of the
# planted faults (0.21 relative RMS and more; PERF.md).
TOL_BWD = {"fp32": (1e-4, 2e-5), "bf16": (2e-2, 1e-2)}


def _grads(fn, inputs, cot):
    """Autograd gradients of fn(*inputs) at `cot` (cot a tensor, or a
    tuple for a tuple output; zeros where autograd never reached)."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    outs, cots = (out, cot) if isinstance(out, tuple) else ((out,), (cot,))
    got = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    return [torch.zeros_like(x) if g_ is None else g_ for x, g_ in zip(leaves, got)]


def _bwd_judge(dtype_name, got, ref) -> tuple:
    """(within TOL_BWD, worst max|diff| / max|ref|, worst relative RMS)
    over the gradient tensors."""
    import torch
    max_rel, rms_rel = TOL_BWD[dtype_name]
    worst_max, worst_rms, ok = 0.0, 0.0, True
    for g_, r_ in zip(got, ref):
        d, r = g_.float() - r_.float(), r_.float()
        m = (d.abs().max() / r.abs().max().clamp(min=1e-30)).item()
        q = (d.norm() / r.norm().clamp(min=1e-30)).item()
        worst_max, worst_rms = max(worst_max, m), max(worst_rms, q)
        ok = ok and m <= max_rel and q <= rms_rel and bool(torch.isfinite(g_).all())
    return ok, worst_max, worst_rms


def phase_backward(kres: dict, g, card: str) -> list:
    """Each training-path kernel's autograd route, and classic short
    attention's, at the training shapes, fp32 and bf16: the gradients
    (kernel forward, the stock backward of kernels/*.py) against plain
    autograd through the plain version, within TOL_BWD; the first shape of
    each timed (the kernel's forward alone,
    `train_fwd_ms_*`, with its bound, `train_fwd_bound_ms_*`, its plain
    version's, `train_fwd_plain_ms_*`, and SDPA's
    forward beside flash's and tmajor's, `train_fwd_library_ms_*`; the
    backward function alone; CUDA events, median of 5; SDPA's backward
    beside flash's and tmajor's), with its bound (`bwd_*` keys of the
    kernel's row). Then one planted fault a kernel, which must miss the
    bounds; then `entry_point_grads`. Returns the loose faults."""
    import torch
    import torch.nn.functional as F
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.kernels import flash_attention as fm
    from mofa_tpu_torch.kernels import geglu_ffn as gm
    from mofa_tpu_torch.kernels import short_attention as sm
    from mofa_tpu_torch.kernels import softsplat as spm

    dev = g.device
    randn = lambda *s, dt: torch.randn(*s, generator=g, device=dev).to(dt)
    loose = []

    log(f"  [card] {card}")

    def check(name, dn, label, fn, inputs, cot, first, bwd_fn=None, work=None,
              library=None, fault=None, fwd_work=None, fwd_library=None):
        got = _grads(fn, inputs, cot)
        torch.cuda.synchronize()
        with kernels.plain_reference():
            ref = _grads(fn, inputs, cot)
        ok, m, q = _bwd_judge(dn, got, ref)
        line = (f"  {name:24s} {dn:4s} {label:34s} grads: max rel {m:.3e} "
                f"rel rms {q:.3e} {'ok' if ok else 'MISS'}")
        r = kres[name]
        r["bwd_ok"] = r.get("bwd_ok", True) and ok
        r["bwd_max_rel_err_" + dn] = max(r.get("bwd_max_rel_err_" + dn, 0.0), m)
        if first:
            with torch.no_grad():
                r["train_fwd_ms_" + dn] = time_ms(lambda: fn(*inputs))
                r["train_fwd_library_ms_" + dn] = (None if fwd_library is None
                                                   else time_ms(fwd_library))
                with kernels.plain_reference():
                    r["train_fwd_plain_ms_" + dn] = time_ms(lambda: fn(*inputs))
            f_ms, f_by = bound(*fwd_work)
            r["train_fwd_bound_ms_" + dn], r["train_fwd_bound_by_" + dn] = f_ms, f_by
            line += f"  fwd {r['train_fwd_ms_' + dn]:.3f} ms (bound {f_ms:.3f}, {f_by}"
            if fwd_work[2] == "split_tf32":       # the fp32 forward on split TF32
                r["train_fwd_bound_cores_ms_" + dn] = bound(fwd_work[0], fwd_work[1],
                                                            "fp32")[0]
                line += f"; CUDA cores {r['train_fwd_bound_cores_ms_' + dn]:.3f}"
            line += ("" if fwd_library is None else
                     f"; SDPA fwd {r['train_fwd_library_ms_' + dn]:.3f}")
            line += f"; plain fwd {r['train_fwd_plain_ms_' + dn]:.3f})"
            r["bwd_ms_" + dn] = time_ms(bwd_fn)
            line += f"  bwd {r['bwd_ms_' + dn]:.3f} ms"
            b_ms, b_by = bound(*work)
            r["bwd_bound_ms_" + dn], r["bwd_bound_by_" + dn] = b_ms, b_by
            line += f"  bound {b_ms:.3f} ({b_by})"
            r["bwd_library_ms_" + dn] = None if library is None else time_ms(library)
            if library is not None:
                line += f"  SDPA bwd {r['bwd_library_ms_' + dn]:.3f}"
        log(line)
        if fault is not None:
            fok, fm_, fq = _bwd_judge(dn, fault(), ref)
            log(f"  {name:24s} {dn:4s} planted fault: max rel {fm_:.3e} rel rms "
                f"{fq:.3e} {'CAUGHT' if not fok else 'LOOSE'}")
            if fok:
                loose.append(f"{name} backward {dn}")
        del got, ref
        torch.cuda.empty_cache()

    def sdpa_bwd(q4, k4, v4, g4):
        leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
        out = F.scaled_dot_product_attention(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True)

    for dn, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        # flash's and the FFN's fp32 forwards run on split TF32
        fwd_kind = "split_tf32" if dn == "fp32" else dn
        for i, (B, L, H, D) in enumerate(BWD_FLASH):
            q, k, v, cot = (randn(B, L, H, D, dt=dt) for _ in range(4))
            with torch.no_grad():
                out = fm.flash_attention(q, k, v)

            def dropped_chunk():
                dq, dk, dv = fm.flash_backward(q, k[:, :-128], v[:, :-128], out, cot)
                pad = torch.zeros_like(k[:, -128:])
                return dq, torch.cat([dk, pad], 1), torch.cat([dv, pad], 1)

            t4 = lambda x: x.transpose(1, 2).contiguous()
            check("flash_attention", dn, f"B={B} L={L} H={H} D={D}",
                  fm.flash_attention, (q, k, v), cot, i == 0,
                  bwd_fn=lambda: fm.flash_backward(q, k, v, out, cot),
                  work=(10 * B * H * L * L * D, 8 * nbytes(q), dn),
                  library=sdpa_bwd(t4(q), t4(k), t4(v), t4(cot)) if i == 0 else None,
                  fault=dropped_chunk if i == 0 else None,
                  fwd_work=(4 * B * H * L * L * D, 4 * nbytes(q), fwd_kind),
                  fwd_library=(lambda a=t4(q), b_=t4(k), c=t4(v):
                               F.scaled_dot_product_attention(a, b_, c)) if i == 0 else None)
            del q, k, v, cot, out
        for i, (S, HD, H) in enumerate(BWD_TMAJOR):
            q, k, v, cot = (randn(25, S, HD, dt=dt) for _ in range(4))

            def last_frame_unread():
                k_, v_ = k.clone(), v.clone()
                k_[-1], v_[-1] = 0, 0
                return sm.tmajor_backward(q, k_, v_, cot, 25, H)

            to4 = lambda x: x.reshape(25, S, H, HD // H).permute(1, 2, 0, 3).contiguous()
            check("short_attention_tmajor", dn, f"BT=25 S={S} HD={HD} H={H}",
                  lambda a, b_, c: sm.short_attention_tmajor(a, b_, c, 25, H),
                  (q, k, v), cot, i == 0,
                  bwd_fn=lambda: sm.tmajor_backward(q, k, v, cot, 25, H),
                  work=(10 * S * H * 25 * 25 * (HD // H), 7 * nbytes(q), dn),
                  library=sdpa_bwd(to4(q), to4(k), to4(v), to4(cot)) if i == 0 else None,
                  fault=last_frame_unread if i == 0 else None,
                  fwd_work=(4 * S * H * 25 * 25 * (HD // H), 4 * nbytes(q), fwd_kind),
                  fwd_library=(lambda a=to4(q), b_=to4(k), c=to4(v):
                               F.scaled_dot_product_attention(a, b_, c)) if i == 0 else None)
            del q, k, v, cot
        # classic short attention at the classic layout's stage-1 site
        # ([B*S, T, H, D]: 2304 tokens at /8, 25 frames)
        q, k, v, cot = (randn(*BWD_SHORT, dt=dt) for _ in range(4))

        def last_key_dropped():
            dq, dk, dv = sm.short_backward(q, k, v, cot)
            dk[:, -1], dv[:, -1] = 0, 0
            return dq, dk, dv

        B, L, H, D = BWD_SHORT
        t4 = lambda x: x.transpose(1, 2).contiguous()
        check("short_attention", dn, f"B={B} L={L} H={H} D={D}", sm.short_attention,
              (q, k, v), cot, True, bwd_fn=lambda: sm.short_backward(q, k, v, cot),
              work=(10 * B * H * L * L * D, 7 * nbytes(q), dn),
              library=sdpa_bwd(t4(q), t4(k), t4(v), t4(cot)), fault=last_key_dropped,
              fwd_work=(4 * B * H * L * L * D, 4 * nbytes(q), fwd_kind),
              fwd_library=(lambda a=t4(q), b_=t4(k), c=t4(v):
                           F.scaled_dot_product_attention(a, b_, c)))
        del q, k, v, cot
        for i, (C, R) in enumerate(BWD_FFN):
            args = ffn_operands(g, C, R, dt)
            cot = randn(R, C, dt=dt)

            def no_dgamma():
                grads = list(gm.ln_ffn_backward(*args, cot))
                grads[1] = torch.zeros_like(grads[1])
                return grads

            check("ln_geglu_ffn", dn, f"rows={R} C={C}", gm.ln_geglu_ffn, args, cot,
                  i == 0, bwd_fn=lambda: gm.ln_ffn_backward(*args, cot),
                  work=(48 * R * C * C, 4 * nbytes(args[0]) + 2 * nbytes(*args[3:]), dn),
                  fault=no_dgamma if i == 0 else None,
                  fwd_work=(24 * R * C * C, 2 * nbytes(args[0]) + nbytes(*args[1:]),
                            fwd_kind))
            del args, cot
        for i, (h, w, c) in enumerate(BWD_SPLAT):
            src, flow, _ = splat_inputs(g, h, w, c, dt, sources=1)
            flow[~torch.isfinite(flow)] = 40.0     # out of bounds: training flows are finite
            cot = randn(SPLAT_FRAMES, h, w, c, dt=dt)
            fr = SPLAT_FRAMES

            def bwd():
                acc, norm = spm.splat_raw(src, flow, None, fr, with_norm=True)
                d_acc, d_norm = spm.normalize_backward(acc, norm, "addeps", cot)
                return spm.splat_backward(src, flow, None, fr, d_acc, d_norm)[:2]

            def flow_sign_flipped():
                d_in, d_flow = bwd()
                return d_in, -d_flow

            check("softsplat", dn, f"N={fr} h={h} w={w} C={c} 'avg'",
                  lambda s_, f_: spm.softsplat(s_, f_, None, "avg", fr), (src, flow),
                  cot, i == 0, bwd_fn=bwd,
                  work=(16 * fr * h * w * c, nbytes(src, flow, cot) + nbytes(src, flow)
                        + 4 * fr * h * w, "fp32"),
                  fault=flow_sign_flipped if i == 0 else None,
                  fwd_work=(8 * fr * h * w * c, nbytes(src, flow, cot) + 4 * fr * h * w,
                            "fp32"))
            del src, flow, cot
    entry_point_grads(check, g)
    return loose


def entry_point_grads(check, g) -> None:
    """The other entry points the JAX package differentiates, one shape
    each at the stage-1 widths (bf16 where the kernel takes only bf16):
    `check` (phase_backward's) holds the gradients of the kernel route to
    plain autograd within TOL_BWD and each one's planted fault outside."""
    import torch
    from mofa_tpu_torch.kernels import conv_fused as cm
    from mofa_tpu_torch.kernels import geglu_ffn as gm
    from mofa_tpu_torch.kernels import group_norm as gnm

    dev, bf, f32 = g.device, torch.bfloat16, torch.float32
    rn = lambda *s, dt=f32, scale=1.0, mean=0.0: (
        torch.randn(*s, generator=g, device=dev) * scale + mean).to(dt)
    c, rows = BWD_FFN[0]
    for name, tail in (("geglu_ffn", False), ("ln_geglu_ffn_ilv", False),
                       ("ln_geglu_ffn_pipe", False), ("ln_geglu_ffn_tanh", True)):
        args = ffn_operands(g, c, rows, bf, tail=tail)
        x, ls, lb, w0, b0, w2, b2 = args
        cot = rn(rows, c, dt=bf)
        if name == "geglu_ffn":
            def fault():                # the gate half of db0 dropped
                grads = list(gm.ffn_backward(x, w0, b0, w2, b2, cot))
                grads[2][4 * c:] = 0
                return grads
            check(name, "bf16", f"rows={rows} C={c}, grads", gm.geglu_ffn,
                  (x, w0, b0, w2, b2), cot, False, fault=fault)
            continue
        variant = name.rsplit("_", 1)[1]
        grads = gm.ln_ffn_backward(*args, cot, "tanh" if variant == "tanh" else "none")
        if variant == "ilv":            # dx of rows 64-127 of every 128 from rows 0-63
            def fault(grads=grads):
                blocks = grads[0].view(-1, 128, c)
                blocks[:, 64:] = blocks[:, :64]
                return grads
        elif variant == "pipe":         # dW0's rows of gate tiles 0 and 1 swapped
            def fault(grads=grads):
                dw0 = grads[3].clone()
                for half in (0, 4 * c):
                    dw0[half:half + 64] = grads[3][half + 64:half + 128]
                    dw0[half + 64:half + 128] = grads[3][half:half + 64]
                return (*grads[:3], dw0, *grads[4:])
        else:                           # the JAX rule's erf gradient, at tail gates
            def fault():
                return gm.ln_ffn_backward(*args, cot)
        check(name, "bf16", f"rows={rows} C={c}, grads",
              lambda *a, v=variant: gm.ln_geglu_ffn(*a, variant=v), args, cot, False,
              fault=fault)
        del args, x, w0, w2, cot, grads

    # the channel sums and the fused GroupNorm, fp32, at the /8 resnet's
    # input (BWD_GN)
    n, c = BWD_GN[0], BWD_GN[-1]
    x = rn(*BWD_GN, mean=0.5)
    x3 = x.view(n, -1, c)
    g1, g2 = rn(n, c), rn(n, c)

    def sums_fault():                   # d Σx² without its factor 2
        return (g1[:, None] + x3 * g2[:, None],)
    check("channel_sums", "fp32", f"{list(x3.shape)}, grads", gnm.channel_sums, (x3,),
          (g1, g2), False, fault=sums_fault)
    scale, bias = rn(c, scale=0.2, mean=1.0), rn(c, scale=0.2)
    cot = rn(*BWD_GN, mean=0.5)

    def stats_held():                   # the statistics held constant
        _, ds, db = gnm.group_norm_backward(x, scale, bias, cot, 32, 1e-6)
        a, _ = gnm.gn_affine(x3, scale, bias, 32, 1e-6)
        return cot * a[:, None, None, :], ds, db
    check("channel_sums", "fp32", f"fused_group_norm {list(BWD_GN)}, grads",
          lambda *t: gnm.fused_group_norm(*t, 32, 1e-6), (x, scale, bias), cot,
          False, fault=stats_held)
    del x, x3, cot

    # the fused convs, bf16: the 3x3 with temb and the output sums on BWD_GN,
    # the temporal with temb and a residual on BWD_TCONV
    for temporal, shape in ((False, BWD_GN), (True, BWD_TCONV)):
        n, c = shape[0], shape[-1]
        x = rn(*shape, dt=bf)
        a, b = rn(n, c, scale=0.3, mean=1.0), rn(n, c, scale=0.2)
        w = rn(*((3,) if temporal else (3, 3)), c, c, dt=bf,
               scale=1.7 / ((3 if temporal else 9) * c) ** 0.5)
        bias = rn(c, scale=0.1)
        temb = rn(*((n, shape[1], c) if temporal else (n, c)), scale=0.3)
        res = rn(*shape, dt=bf) if temporal else None
        plain = cm.tconv3_plain if temporal else cm.conv3x3_plain
        fn = cm.gn_silu_tconv3 if temporal else cm.gn_silu_conv3x3
        inputs = (x, a, b, w, bias, temb) + ((res,) if temporal else ())
        cot = ((rn(*shape, dt=bf),) if temporal else
               (rn(*shape, dt=bf), rn(n, c), rn(n, c)))
        if temporal:
            def fault():                # d temb_bias dropped
                grads = cm.fused_conv_backward(plain, *inputs, True, False, *cot)
                return (*grads[:5], torch.zeros_like(temb), grads[6])
            run = lambda *t: fn(*t)
        else:
            def fault():                # the output sums' cotangents dropped
                grads = cm.fused_conv_backward(
                    plain, *inputs, None, True, True, cot[0],
                    torch.zeros_like(cot[1]), torch.zeros_like(cot[2]))
                return grads[:6]
            run = lambda *t: fn(*t, emit_sums=True)
        name = "gn_silu_tconv3" if temporal else "gn_silu_conv3x3"
        check(name, "bf16", f"{list(shape)} {'temb, residual' if temporal else 'temb, sums'}"
              ", grads", run, inputs, cot if len(cot) > 1 else cot[0], False,
              fault=fault)
        del x, w, res, cot, inputs


# ------------------------------------------------ phase 4: composition

# PSNR bars of the composition check: fp32 kernels vs fp32 plain (the bar
# of tests/test_fullchain_parity.py); bf16 kernels vs bf16 plain (about
# 6 dB, twice the RMS error, below the 41.9 dB reading in PERF.md); the
# bf16 kernels may sit at most BF16_SLACK_DB further from the fp32 plain
# run than the bf16 plain run does (readings 39.02 vs 38.97 dB); and the
# two temporal layouts, one function, agree in bf16 to PSNR_BF16_DB.
PSNR_FP32_DB, PSNR_BF16_DB, BF16_SLACK_DB = 45.0, 36.0, 1.0


def phase_composition(dev) -> None:
    """Full SVD-XT widths, 256x384, T=8, 2 steps: the pipeline through the
    kernels and inside `plain_reference()`, in fp32 and then, with the same
    weights cast, in bf16, each in both temporal layouts. At T=8 every
    temporal site of the classic layout passes the short gate (L*H <= 160
    at H = 5, 10 and 20)."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.pipelines.traj import TrajPipeline

    h, w, t, steps = 256, 384, 8, 2
    bundle = random_bundle(dev, 1, torch.float32)
    img, flow = smooth_inputs(1, t, h, w, dev, seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    lat0 = torch.randn(1, t, h // 8, w // 8, 4, generator=g, device=dev)
    pipe = TrajPipeline(bundle)
    run = lambda: pipe(img, flow, num_inference_steps=steps,
                       noise_aug_strength=0.0, latents=lat0)[0]
    frames = {}
    for dn, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for m in bundle.modules().values():
            m.to(dt)
        for layout in ("tmajor", "classic"):
            with temporal_layout(layout):
                kernels.reset_launch_counts()
                got = run()
                counts = kernels.launch_counts()
                with kernels.plain_reference():
                    ref = run()
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
                fail(f"composition check, {layout} {dn}: non-finite frames")
            sat = float(((ref <= 0.0) | (ref >= 1.0)).float().mean())
            log(f"  {layout} {dn}: launches through the kernels: {counts}")
            log(f"  {layout} {dn}: frames {tuple(got.shape)}, mean "
                f"{float(ref.mean()):.4f}, std {float(ref.std()):.4f}, clipped "
                f"share {sat:.4f}, max|diff| {float((got - ref).abs().max()):.3e}")
            other = "short_attention" if layout == "tmajor" else "short_attention_tmajor"
            if min(counts[k] for k in LAYOUT_KERNELS[layout]) == 0 or counts[other]:
                fail(f"composition check, {layout} {dn}: launches {counts}, "
                     f"expected every one of {LAYOUT_KERNELS[layout]} and no "
                     f"{other}")
            frames[layout, dn] = (got, ref)
    readings = {}
    for layout in ("tmajor", "classic"):
        (k32, p32), (k16, p16) = frames[layout, "fp32"], frames[layout, "bf16"]
        to_truth_p = psnr(p16, p32)
        log(f"  {layout}: bf16 plain vs fp32 plain {to_truth_p:.2f} dB")
        readings.update({
            f"{layout}: fp32 kernels vs fp32 plain": (psnr(k32, p32), PSNR_FP32_DB),
            f"{layout}: bf16 kernels vs bf16 plain": (psnr(k16, p16), PSNR_BF16_DB),
            f"{layout}: bf16 kernels vs fp32 plain": (psnr(k16, p32),
                                                      to_truth_p - BF16_SLACK_DB)})
    readings["classic vs tmajor, bf16 kernels"] = (
        psnr(frames["classic", "bf16"][0], frames["tmajor", "bf16"][0]),
        PSNR_BF16_DB)
    for label, (p, bar) in readings.items():
        log(f"[composition] PSNR {label} {p:.2f} dB (bar {bar:.2f} dB)")
    low = [label for label, (p, bar) in readings.items() if p < bar]
    if low:
        fail(f"composition PSNR below its bar: {low}")
    del bundle, pipe, frames
    torch.cuda.empty_cache()


# ---------------------------------------------------- phase 5: main path

MAIN = dict(h=576, w=1024, t=25, steps=25, decode_chunk_size=8)
CLASSIC_STEPS = 5


def seeded_tracks(h: int, w: int, seed: int, n: int = 6) -> list:
    """n drag tracks of 3-5 click points each, in image pixels: a start in
    the middle 80% of the image, then steps of up to a tenth of its size."""
    import numpy as np
    rng = np.random.RandomState(seed)
    tracks = []
    for _ in range(n):
        pts = [rng.uniform((0.1 * w, 0.1 * h), (0.9 * w, 0.9 * h))]
        for _ in range(rng.randint(2, 5)):
            step = rng.uniform(-0.1, 0.1, 2) * (w, h)
            pts.append(np.clip(pts[-1] + step, 0, (w - 1, h - 1)))
        tracks.append([[float(x), float(y)] for x, y in pts])
    return tracks


def drag_video(bundle, dev, h: int, w: int, t: int, steps: int, seed: int,
               brush=None, phase_times=None, mesh=None):
    """The traj app's generation: a seeded smooth image and seeded tracks
    -> PCHIP -> sparse flow at 384^2 -> CMP (full CMPConfig, seeded random
    weights, fp32) -> flow at (h, w) -> TrajPipeline with `bundle` (frame
    parallel over `mesh` when one is given). Returns (frames
    [T, H, W, 3], flow [1, T-1, H, W, 2], PhaseTimer)."""
    from mofa_tpu_torch.apps.loaders import load_cmp
    from mofa_tpu_torch.apps.traj_app import generate
    from mofa_tpu_torch.utils.profiling import PhaseTimer
    img, _ = smooth_inputs(1, 2, h, w, dev, seed=seed)
    timer = PhaseTimer(dev)
    frames, flow = generate(
        img[0], seeded_tracks(h, w, seed), lambda: load_cmp(None, dev, seed=seed),
        lambda: bundle, timer=timer, brush=brush, num_frames=t,
        num_inference_steps=steps, decode_chunk_size=MAIN["decode_chunk_size"],
        seed=seed + 1, phase_times=phase_times, mesh=mesh)
    return frames, flow, timer


def check_flow(label: str, flow) -> None:
    import torch
    mag = flow.float().norm(dim=-1)
    log(f"  {label}: dense flow {tuple(flow.shape)}, mean |flow| "
        f"{float(mag.mean()):.3f} px, max |flow| {float(mag.max()):.3f} px")
    if not bool(torch.isfinite(flow).all()) or float(mag.max()) == 0.0:
        fail(f"{label}: the dense flow is non-finite or all zero")


def run_video(bundle, dev, layout: str, steps: int) -> dict:
    """One video at MAIN's size in `layout`, from drag tracks through the
    traj app's generation (CMP included), launch counts reset just before
    it and read just after; every phase timed."""
    import torch
    from mofa_tpu_torch import kernels

    log(f"  {layout} layout: drag tracks -> CMP -> {steps} steps, {MAIN['t']} "
        f"frames, {MAIN['h']}x{MAIN['w']}, decode_chunk_size "
        f"{MAIN['decode_chunk_size']}")
    torch.cuda.reset_peak_memory_stats()
    phases: dict = {}
    with temporal_layout(layout):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        frames, flow, timer = drag_video(bundle, dev, MAIN["h"], MAIN["w"],
                                         MAIN["t"], steps, seed=4,
                                         phase_times=phases)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = kernels.launch_counts()
        flash_shapes = kernels.launch_counts_by_shape("flash_attention")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = phases["denoise_step"]
    median = sorted(step_s)[len(step_s) // 2]
    app = timer.totals
    log(f"  phases (s): cmp_load {app['cmp_load']:.3f}, cmp_flow "
        f"{app['cmp_flow']:.3f}, clip_encode {phases['clip_encode'][0]:.3f}, "
        f"vae_encode {phases['vae_encode'][0]:.3f}, warp "
        f"{phases['warp'][0]:.3f}, denoise {sum(step_s):.3f} "
        f"({len(step_s)} steps: first {step_s[0]:.3f}, median "
        f"{median:.3f}), decode {phases['decode'][0]:.3f}; total {total:.3f}")
    log(f"  peak torch.cuda.max_memory_allocated {peak:.2f} GiB")
    log(f"  kernel launches in the {layout} path: {launches}")
    log(f"  flash launches by [B, L, H, D]: {flash_shapes}")
    check_flow(f"{layout} path", flow)
    want = (MAIN["t"], MAIN["h"], MAIN["w"], 3)
    if tuple(frames.shape) != want:
        fail(f"{layout} path frames {tuple(frames.shape)}, expected {want}")
    if not bool(torch.isfinite(frames).all()):
        fail(f"{layout} path produced non-finite frames")
    if launches != expected_launches(layout, steps):
        fail(f"{layout} path launches {launches}, expected "
             f"{expected_launches(layout, steps)}")
    log(f"  frames finite, mean {float(frames.mean()):.4f}, std "
        f"{float(frames.std()):.4f}")
    return dict(launches=launches, flash_shapes=flash_shapes, median_step=median,
                cmp_flow=app["cmp_flow"])


def run_brush_video(bundle, dev) -> None:
    """The motion-brush path (`get_drag_flow_with_brush`: tracks split by
    the brush, each side completed on its own, merged) at the composition
    check's size, 256x384, T=8, 2 steps: the frames must be finite."""
    import numpy as np
    import torch
    h, w = 256, 384
    brush = np.zeros((h, w), np.float32)
    brush[:, : w // 2] = 255.0                     # the left half
    frames, flow, timer = drag_video(bundle, dev, h, w, 8, 2, seed=9, brush=brush)
    check_flow("brush path", flow)
    if tuple(frames.shape) != (8, h, w, 3) or not bool(torch.isfinite(frames).all()):
        fail(f"brush path: frames {tuple(frames.shape)}, finite "
             f"{bool(torch.isfinite(frames).all())}")
    log(f"  brush path: cmp_flow {timer.totals['cmp_flow']:.3f} s, frames finite, "
        f"mean {float(frames.mean()):.4f}")


# ------------------------------------------------ phase 5d: the hybrid path

def seeded_landmarks(h: int, w: int, t: int, seed: int):
    """[t, 68, 2] (x, y) pixels: a seeded face (68 points in an ellipse of
    a fifth of the frame's width and a third of its height, about its
    middle) that drifts and turns a little over the frames, plus jitter;
    inside the frame."""
    import numpy as np
    rng = np.random.RandomState(seed)
    centre = rng.uniform(0.4, 0.6, 2) * (w, h)
    ang, rad = rng.uniform(0, 2 * np.pi, 68), np.sqrt(rng.uniform(0, 1, 68))
    base = np.stack([np.cos(ang), np.sin(ang)], -1) * rad[:, None] * (0.1 * w, 0.17 * h)
    s = np.linspace(0.0, 1.0, t)[:, None, None]
    turn = 0.15 * s * np.stack([-base[..., 1], base[..., 0]], -1)[None]
    drift = s * rng.uniform(-0.04, 0.04, 2) * (w, h)
    lm = centre + base[None] + turn + drift + rng.randn(t, 68, 2)
    return np.clip(lm, 0, (w - 1, h - 1)).astype(np.float32)


def elliptical_mask(h: int, w: int, centre, radii):
    """[h, w] float32: 1 inside the ellipse, 0 outside."""
    import numpy as np
    y, x = np.mgrid[:h, :w]
    inside = ((x - centre[0]) / radii[0]) ** 2 + ((y - centre[1]) / radii[1]) ** 2 <= 1
    return inside.astype(np.float32)


_ST_CODES = {"torch.float32": "F32", "torch.float16": "F16", "torch.bfloat16": "BF16",
             "torch.int64": "I64"}


def write_safetensors(sd: dict, path: str) -> None:
    """{name: tensor} -> a .safetensors file (8-byte little-endian header
    length, the JSON header, the tensors' bytes), written here so the
    check does not rest on the port's reader alone."""
    import torch
    header, off = {}, 0
    for name, t in sd.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_CODES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text)
        for t in sd.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
                    .tobytes())


def write_adapters(dev, root: str, seed: int) -> dict:
    """A landmark adapter and a trajectory adapter at SVD-XT widths with
    seeded random bf16 weights, written as a diffusers tree: the landmark
    one as .safetensors (write_safetensors), the trajectory one as .bin
    (torch.save). Returns part -> the written state dict (CPU)."""
    import torch
    from mofa_tpu_torch.models.mofa_adapter import FlowControlNet, LdmkFlowControlNet
    from mofa_tpu_torch.models.svd_unet import SVDUNetConfig
    from mofa_tpu_torch.pipelines.common import init_random_
    g = torch.Generator(device=dev).manual_seed(seed)
    written = {}
    for part, cls, folder, name in (
            ("controlnet", LdmkFlowControlNet, "ldmk",
             "diffusion_pytorch_model.safetensors"),
            ("controlnet2", FlowControlNet, "drag", "diffusion_pytorch_model.bin")):
        with torch.device(dev):
            m = init_random_(cls(SVDUNetConfig()), g).to(torch.bfloat16)
        sd = {k: v.cpu() for k, v in m.state_dict().items()}
        del m
        os.makedirs(os.path.join(root, folder))
        path = os.path.join(root, folder, name)
        if name.endswith(".safetensors"):
            write_safetensors(sd, path)
        else:
            torch.save(sd, path)
        written[part] = sd
    torch.cuda.empty_cache()
    return written


def run_hybrid_video(dev, card: str) -> dict:
    """The hybrid app's generation (`hybrid_app.generate`) at MAIN's size
    and steps, bf16, B=1: a seeded landmark sequence, seeded drag tracks
    and an elliptical face mask; CMP (full size, seeded random, fp32) for
    the face and the drag flow; both adapters loaded by `load_bundle` from
    files written first (each tensor held bit-equal to what was written),
    UNet, VAE and CLIP seeded random. Launch counts reset just before the
    generation and read just after; every phase timed."""
    import tempfile

    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.apps.hybrid_app import generate
    from mofa_tpu_torch.apps.loaders import load_bundle, load_cmp
    from mofa_tpu_torch.utils.profiling import PhaseTimer

    h, w, t, steps, seed = MAIN["h"], MAIN["w"], MAIN["t"], MAIN["steps"], 11
    img, _ = smooth_inputs(1, 2, h, w, dev, seed=seed)
    lm = seeded_landmarks(h, w, t, seed)
    centre = lm[0].mean(0)
    mask = elliptical_mask(h, w, centre, (0.16 * w, 0.26 * h))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        written = write_adapters(dev, root, seed)
        log(f"  adapters written in {time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{p} {sum(v.numel() for v in sd.values())} parameters"
                        for p, sd in written.items()))
        loaded = {}

        def bundle_loader():
            t1 = time.perf_counter()
            bundle = load_bundle(None, os.path.join(root, "ldmk"), dev,
                                 torch.bfloat16, seed=seed,
                                 controlnet2_dir=os.path.join(root, "drag"), ldmk=True)
            torch.cuda.synchronize()
            loaded["seconds"] = time.perf_counter() - t1
            for part, sd in written.items():
                own = getattr(bundle, part).state_dict()
                if own.keys() != sd.keys():
                    fail(f"hybrid: {part} loaded keys differ from the file's")
                bad = [k for k, v in own.items() if not torch.equal(v.cpu(), sd[k])]
                if bad:
                    fail(f"hybrid: {part} tensors differ from the file's: {bad[:5]}")
            loaded["checked"] = sum(len(sd) for sd in written.values())
            return bundle

        torch.cuda.reset_peak_memory_stats()
        phases: dict = {}
        timer = PhaseTimer(dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        frames, face, drag, _ = generate(
            img[0], lm, seeded_tracks(h, w, seed), mask,
            lambda: load_cmp(None, dev, seed=seed), bundle_loader, timer=timer,
            num_inference_steps=steps, decode_chunk_size=MAIN["decode_chunk_size"],
            seed=seed + 1, phase_times=phases)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = kernels.launch_counts()
        flash_shapes = kernels.launch_counts_by_shape("flash_attention")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = phases["denoise_step"]
    median = sorted(step_s)[len(step_s) // 2]
    app = timer.totals
    log(f"  both adapters loaded from their files in {loaded['seconds']:.3f} s; "
        f"{loaded['checked']} tensors bit-equal to what was written")
    log(f"  phases (s): cmp_load {app['cmp_load']:.3f}, cmp_flow landmarks "
        f"{app['cmp_flow_landmarks']:.3f}, cmp_flow tracks {app['cmp_flow_tracks']:.3f}, "
        f"bundle_load {app['bundle_load']:.3f}, clip_encode "
        f"{phases['clip_encode'][0]:.3f}, vae_encode {phases['vae_encode'][0]:.3f}, "
        f"warp+matting {phases['warp'][0]:.3f}, denoise {sum(step_s):.3f} "
        f"({len(step_s)} steps: first {step_s[0]:.3f}, median {median:.3f}), "
        f"decode {phases['decode'][0]:.3f}; total {total:.3f}")
    log(f"  peak torch.cuda.max_memory_allocated {peak:.2f} GiB; card {card}")
    log(f"  kernel launches in the hybrid path: {launches}")
    log(f"  flash launches by [B, L, H, D]: {flash_shapes}")
    check_flow("hybrid face flow", face)
    check_flow("hybrid drag flow", drag)
    want = (t, h, w, 3)
    if tuple(frames.shape) != want or not bool(torch.isfinite(frames).all()):
        fail(f"hybrid path frames {tuple(frames.shape)} (expected {want}), finite "
             f"{bool(torch.isfinite(frames).all())}")
    if launches != expected_launches("tmajor", steps, adapters=2):
        fail(f"hybrid path launches {launches}, expected "
             f"{expected_launches('tmajor', steps, adapters=2)}")
    log(f"  frames finite, mean {float(frames.mean()):.4f}, std "
        f"{float(frames.std()):.4f}")
    return dict(launches=launches, median_step=median, total=total)


# ------------------------------------------ phase 5e: the keypoint path

# the keypoint CLI's defaults: 125 frames in windows of 25 at stride 12
# (10 views), 512^2, but 10 steps of the CLI's 25: the training phase (5g)
# takes some 400 s, and the script aims to end within 600 (a step is the
# same work at any depth: PERF.md §5 has the 25-step readings)
KEYPOINT = dict(h=512, w=512, t=125, window=25, stride=12, steps=10,
                decode_chunk_size=8)
# window_batch 2 against 1 at 2 steps, bf16, from one set of latents: the
# relative RMS of the latents' difference. Each window's rows compute the
# same function, but the bf16 path is not bitwise repeatable (atomic adds
# in the splat and the overlap sums; other algorithms at twice the batch),
# and the random-weight UNet carries that rounding through the first
# step's cancellation at sigma_0 ~ 700 (the CPU test holds the same in fp32
# to 2e-3). The first full-size reading was 1.76e-2, and window_batch 1
# against a rerun of itself reads the same (PERF.md §6). A batching fault
# (a window denoised with another's features or the other CFG half's
# image latents) moves the latents by their own size.
WINDOW_BATCH_RMS = 5e-2


def run_keypoint_video(dev, card: str) -> dict:
    """The keypoint app's generation (`keypoint_app.generate`) at the CLI's
    defaults (KEYPOINT), bf16, window_batch 1: a seeded smooth 68-point
    track, the CMP (full size, seeded random, fp32) over its 124 frames,
    the landmark-adapter bundle seeded random, then KeypointPipeline over
    10 views. Launch counts reset just before the generation and read just
    after; every phase timed; the peak during the CMP read apart from the
    peak after it. Then the same flow and landmark frames at 2 steps from
    one set of latents with window_batch 1, 2, 2 and 1 (the second run of
    each timed warm): their launches, their agreement (WINDOW_BATCH_RMS)
    and a planted fault that must miss it."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.apps.keypoint_app import generate
    from mofa_tpu_torch.apps.loaders import load_bundle, load_cmp
    from mofa_tpu_torch.pipelines.keypoint import KeypointPipeline, window_views
    from mofa_tpu_torch.utils.profiling import PhaseTimer

    k = KEYPOINT
    h, w, t, seed = k["h"], k["w"], k["t"], 13
    views = window_views(t, k["window"], k["stride"])
    img, _ = smooth_inputs(1, 2, h, w, dev, seed=seed)
    lm = seeded_landmarks(h, w, t, seed)
    peaks, kept = {}, {}

    def bundle_loader():
        # the CMP has run and been freed: its peak is the peak so far
        peaks["cmp"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        kept["bundle"] = load_bundle(None, None, dev, torch.bfloat16, seed=seed, ldmk=True)
        return kept["bundle"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phases: dict = {}
    timer = PhaseTimer(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    frames, flow, raster = generate(
        img[0], lm, lambda: load_cmp(None, dev, seed=seed), bundle_loader, timer=timer,
        window_size=k["window"], stride=k["stride"], num_inference_steps=k["steps"],
        decode_chunk_size=k["decode_chunk_size"], seed=seed + 1, phase_times=phases)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    flash_shapes = kernels.launch_counts_by_shape("flash_attention")
    peaks["after"] = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = phases["denoise_step"]
    median = sorted(step_s)[len(step_s) // 2]
    app = timer.totals
    log(f"  {len(views)} views {views[0]} ... {views[-1]}; CMP over {t - 1} frames at 384^2")
    log(f"  phases (s): cmp_load {app['cmp_load']:.3f}, cmp_flow {app['cmp_flow']:.3f}, "
        f"bundle_load {app['bundle_load']:.3f}, clip_encode {phases['clip_encode'][0]:.3f}, "
        f"vae_encode {phases['vae_encode'][0]:.3f}, warp (all views) "
        f"{phases['warp'][0]:.3f}, denoise {sum(step_s):.3f} ({len(step_s)} steps of "
        f"{len(views)} windows: first {step_s[0]:.3f}, median {median:.3f}; median "
        f"window step {median / len(views):.4f}), decode {phases['decode'][0]:.3f}; "
        f"total {total:.3f}")
    log(f"  peak torch.cuda.max_memory_allocated {max(peaks.values()):.2f} GiB (CMP "
        f"{peaks['cmp']:.2f}, bundle + denoise + decode {peaks['after']:.2f}); card {card}")
    log(f"  kernel launches in the keypoint path: {launches}")
    log(f"  flash launches by [B, L, H, D]: {flash_shapes}")
    check_flow("keypoint flow", flow)
    want = (t, h, w, 3)
    if tuple(frames.shape) != want or not bool(torch.isfinite(frames).all()):
        fail(f"keypoint path frames {tuple(frames.shape)} (expected {want}), finite "
             f"{bool(torch.isfinite(frames).all())}")
    expect = lambda steps, vb: expected_launches(
        "tmajor", steps, size=(h, w), views=len(views), window_batch=vb,
        warps=len(set(views)))
    if launches != expect(k["steps"], 1):
        fail(f"keypoint path launches {launches}, expected {expect(k['steps'], 1)}")
    per_site = k["steps"] * len(views) * 7            # UNet 5 + trunk 2 a level
    for shape in KP_FLASH:
        if flash_shapes.get(shape, 0) != per_site:
            fail(f"keypoint path: flash at {shape} launched "
                 f"{flash_shapes.get(shape, 0)} times, expected {per_site}")
    log(f"  frames finite, mean {float(frames.mean()):.4f}, std "
        f"{float(frames.std()):.4f}")
    del frames
    torch.cuda.empty_cache()

    # window batching: 2 steps, the same flow, raster and latents
    bundle = kept.pop("bundle")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    lat0 = torch.randn(1, t, h // 8, w // 8, 4, generator=g, device=dev)
    ldmk = torch.from_numpy(raster).to(dev)[None]
    out, ab = {}, {}
    # each batch twice: the first run at a batch meets its shapes first
    for vb in (1, 2, "2 again", "1 again"):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = vb if isinstance(vb, int) else int(vb[0])
        out[vb], _ = KeypointPipeline(bundle)(
            img, flow, ldmk, window_size=k["window"], stride=k["stride"],
            num_inference_steps=2, latents=lat0, output_type="latent",
            window_batch=n, generator=torch.Generator(device=dev).manual_seed(seed + 3))
        torch.cuda.synchronize()
        ab[vb] = time.perf_counter() - t1
        got = kernels.launch_counts()
        if got != expect(2, n):
            fail(f"keypoint window_batch={vb}: launches {got}, expected {expect(2, n)}")
        log(f"  window_batch {vb}: 2 steps in {ab[vb]:.3f} s (warp included), "
            f"launches {got}")
    rel_rms = lambda a, b: float((a - b).norm() / b.norm())
    rms, err = rel_rms(out[2], out[1]), float((out[2] - out[1]).abs().max())
    log(f"  window_batch 2 vs 1: max|diff| {err:.3e} of max|latents| "
        f"{float(out[1].abs().max()):.3e}; rel rms {rms:.3e} (bound {WINDOW_BATCH_RMS}); "
        f"each against itself (run to run): rel rms 1 {rel_rms(out['1 again'], out[1]):.3e}, "
        f"2 {rel_rms(out['2 again'], out[2]):.3e}; second runs: window_batch 2 in "
        f"{ab['2 again'] / ab['1 again']:.3f}x the time of 1")
    if not (bool(torch.isfinite(out[2]).all()) and rms <= WINDOW_BATCH_RMS):
        fail(f"keypoint window_batch 2 vs 1: rel rms {rms:.3e} > {WINDOW_BATCH_RMS}")
    # a planted fault the bound must reject: window_batch 2 with the CFG
    # halves' image latents swapped (each window's rows read the other half's)
    import mofa_tpu_torch.pipelines.keypoint as keypoint_module
    real_encode = keypoint_module.encode_vae_image
    keypoint_module.encode_vae_image = lambda *a, **kw: real_encode(*a, **kw).flip(0)
    try:
        faulty, _ = KeypointPipeline(bundle)(
            img, flow, ldmk, window_size=k["window"], stride=k["stride"],
            num_inference_steps=2, latents=lat0, output_type="latent", window_batch=2,
            generator=torch.Generator(device=dev).manual_seed(seed + 3))
    finally:
        keypoint_module.encode_vae_image = real_encode
    fault_rms = rel_rms(faulty, out[1])
    log(f"  planted fault (CFG halves' image latents swapped), window_batch 2 vs 1: "
        f"rel rms {fault_rms:.3e} {'MISS' if fault_rms > WINDOW_BATCH_RMS else 'PASSES'}")
    if fault_rms <= WINDOW_BATCH_RMS:
        fail(f"the window-batch bound lets a planted fault pass: {fault_rms:.3e}")
    del bundle, out, faulty
    torch.cuda.empty_cache()
    return dict(launches=launches, flash_shapes=flash_shapes, median_step=median,
                total=total, peak=max(peaks.values()), window_batch_s=ab,
                window_batch_rms=rms, fault_rms=fault_rms)


# ----------------------------------------------- phase 5f: the audio front

AUDIO_SECONDS, AUDIO_SR, AUDIO_FPS = 6, 16000, 25


def write_wav(path: str, samples, rate: int) -> None:
    """Mono int16 PCM via the stdlib `wave`; samples in [-1, 1]."""
    import wave

    import numpy as np
    pcm = (np.clip(samples, -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


def seeded_face(seed: int) -> dict:
    """A landmarker's output for a face about the middle of the image:
    lmks [478, 3] normalised, lmks3d [468, 3] in cm about the origin, and
    trans_mat placing them 50 cm in front of the camera."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lmks3d = rng.uniform((-7, -9, -4), (7, 9, 4), (468, 3)).astype(np.float32)
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = -50.0
    lmks = np.concatenate([rng.uniform(0.3, 0.7, (478, 2)), np.zeros((478, 1))], 1)
    return dict(lmks=lmks.astype(np.float32), lmks3d=lmks3d, trans_mat=trans)


def run_audio_front(dev) -> dict:
    """The AniPortrait engine of `audio2ldmk_app` at full widths
    (wav2vec2-base: 768 wide, 12 layers; Audio2Mesh and Audio2Pose 512
    wide, 8 decoder layers), seeded random weights, fp32: a seeded 6-second
    16 kHz wav written with `wave` and a seeded face -> landmarks
    [ceil(6 * 25) + 1, 68, 2], finite. Runs twice (the first call includes
    the cuDNN / cuBLAS warm-up); no custom kernel may launch."""
    import math
    import tempfile

    import numpy as np
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.apps.audio2ldmk_app import load_audio_models, reference_face
    from mofa_tpu_torch.models.audio.aniportrait import audio_to_landmarks

    h = w = KEYPOINT["h"]
    t0 = time.perf_counter()
    a2m, a2p = load_audio_models(None, None, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = {n: sum(p.numel() for p in m.parameters()) for n, m in
                (("audio2mesh", a2m), ("audio2pose", a2p))}
    lmks, lmks3d, trans = reference_face(seeded_face(18), w, h)
    rng = np.random.RandomState(19)
    want = (math.ceil(AUDIO_SECONDS * AUDIO_FPS) + 1, 68, 2)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        wav = os.path.join(root, "a.wav")
        write_wav(wav, rng.uniform(-0.5, 0.5, AUDIO_SECONDS * AUDIO_SR), AUDIO_SR)
        kernels.reset_launch_counts()
        times = []
        for _ in range(2):
            t1 = time.perf_counter()
            lm = audio_to_landmarks(a2m, a2p, wav, lmks, lmks3d, trans, [h, w],
                                    fps=AUDIO_FPS, sr=AUDIO_SR)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        launches = kernels.launch_counts()
    log(f"  models built in {load_s:.3f} s, parameters {n_params}")
    log(f"  {AUDIO_SECONDS} s of audio -> landmarks {lm.shape} in {times[0]:.3f} s "
        f"(first call), {times[1]:.3f} s (second); x in [{lm[..., 0].min():.1f}, "
        f"{lm[..., 0].max():.1f}], y in [{lm[..., 1].min():.1f}, {lm[..., 1].max():.1f}]")
    if lm.shape != want or not np.isfinite(lm).all():
        fail(f"audio front: landmarks {lm.shape} (expected {want}), finite "
             f"{bool(np.isfinite(lm).all())}")
    if any(launches.values()):
        fail(f"audio front launched custom kernels: {launches}")
    del a2m, a2p
    torch.cuda.empty_cache()
    return dict(seconds=times)


# ------------------------------------------------ phase 5j: the face stack

# BFM_model_front.mat's size: the front face's vertices and triangles
BFM_VERTICES, BFM_FACES = 35709, 70789


def write_bfm_mat(path: str, rows: int, cols: int, seed: int, n_vertices=None,
                  n_faces=None) -> None:
    """A synthetic BFM .mat in the reference's layout (scipy.io.savemat;
    1-based tri / keypoints / point_buf): a seeded height field on a
    rows x cols grid over [-0.9, 0.9]^2 (a bump toward the camera), two
    triangles a cell, so the face covers most of the 224^2 render. With
    n_vertices / n_faces, the grid's first n_vertices are kept and the
    triangles cut or topped up to n_faces with degenerate ones (a vertex
    twice: zero area, never drawn; overlapping faces would tie in depth,
    which rounding breaks differently on each device). Small seeded id / exp / tex bases, a mean texture in
    [0, 255], 68 keypoints inside the face."""
    import numpy as np
    from scipy.io import savemat
    rng = np.random.RandomState(seed)
    n = n_vertices or rows * cols
    yy, xx = np.meshgrid(np.linspace(0.9, -0.9, rows), np.linspace(-0.9, 0.9, cols),
                         indexing="ij")
    zz = 0.35 * np.exp(-(xx ** 2 + yy ** 2) / 0.5) + 0.01 * rng.randn(rows, cols)
    verts = np.stack([xx, yy, zz], -1).reshape(-1, 3)[:n]
    v00 = (np.arange(rows - 1)[:, None] * cols + np.arange(cols - 1)[None]).reshape(-1)
    tri = np.concatenate([np.stack([v00, v00 + cols, v00 + 1], 1),
                          np.stack([v00 + 1, v00 + cols, v00 + cols + 1], 1)])
    tri = tri[(tri < n).all(1)]
    if n_faces is not None:
        cells = v00[v00 + cols + 1 < n]
        extra = cells[rng.randint(0, len(cells), max(0, n_faces - len(tri)))]
        tri = np.concatenate([tri, np.stack([extra, extra, extra + 1], 1)])
        tri = tri[:n_faces]
    f = len(tri)
    # each vertex's first 8 faces (face ids 1-based; f + 1 is the zero row)
    point_buf = np.full((n, 8), f + 1)
    order = np.argsort(tri.reshape(-1), kind="stable")
    vid = tri.reshape(-1)[order]
    fid = order // 3
    first = np.searchsorted(vid, np.arange(n))
    rank = np.arange(len(vid)) - first[vid]
    keep = rank < 8
    point_buf[vid[keep], rank[keep]] = fid[keep] + 1
    inner = np.nonzero((np.abs(verts[:, 0]) < 0.6) & (np.abs(verts[:, 1]) < 0.6))[0]
    savemat(path, {
        "meanshape": verts.reshape(1, -1).astype(np.float32),
        "idBase": (rng.randn(n * 3, 80) * 0.01).astype(np.float32),
        "exBase": (rng.randn(n * 3, 64) * 0.01).astype(np.float32),
        "keypoints": (rng.choice(inner, 68, replace=len(inner) < 68) + 1)[None].astype(
            np.float64),
        "texBase": (rng.randn(n * 3, 80) * 5).astype(np.float32),
        "meantex": rng.uniform(60, 220, (1, n * 3)).astype(np.float32),
        "tri": (tri + 1).astype(np.float64),
        "point_buf": point_buf.astype(np.float64),
    })


# the face stack's operating point: SadTalker on a 6 s wav (151 landmark
# frames, as the audio front), the --face3dvis render on a 1 s wav (25
# frames of the full BFM mesh at 224^2), the video engine on a 150-frame
# track, opendomain's sadtalker engine into one 25-frame window at 512^2
# (KEYPOINT's size) at 3 steps, and the three image CLIs at 256^2-384 and
# 2 steps (they run for their file handling, which needs no PIL)
FACE = dict(seed=31, wav_s=6, vis_wav_s=1, drive_frames=150, od_frames=25, od_steps=3,
            cli_steps=2, raster_chunk_cpu=64, mask_agree=0.999, colour_tol=1e-4)


def smooth_png(path: str, h: int, w: int, seed: int) -> None:
    """A seeded smooth RGB image (low-resolution noise, bicubic upsampled),
    written with cv2."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    small = (rng.rand(max(h // 32, 2), max(w // 32, 2), 3) * 255).astype(np.uint8)
    cv2.imwrite(path, cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC))


def write_face_weights(root: str, seed: int) -> dict:
    """Seeded random Audio2Exp, Audio2Pose, ReconNet (ResNet-50) and FAN (4
    modules) state dicts under the reference names, written as the
    reference ships them: audio2exp / audio2pose .pth ({"model": ...},
    `module.` prefixes; the pose file with its CVAE encoder and
    discriminator keys), the ReconNet inside a SadTalker-style combined
    .safetensors (`face_3drecon.` keys beside another model's; written
    here, not by the port), the FAN as facexlib's {"state_dict": ...}.
    Returns name -> (path, the state dict the net must load)."""
    import torch
    from mofa_tpu_torch.apps.loaders import init_random_cmp_
    from mofa_tpu_torch.models.audio.face3d_fit import ReconNet
    from mofa_tpu_torch.models.audio.sadtalker import Audio2ExpNet, Audio2PoseCVAE
    from mofa_tpu_torch.models.face_alignment import FAN
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, net in (("exp", Audio2ExpNet()), ("pose", Audio2PoseCVAE()),
                      ("recon", ReconNet()), ("fan", FAN())):
        sd = init_random_cmp_(net, g).state_dict()
        if name in ("exp", "pose"):
            blob = {f"module.{k}": v for k, v in sd.items()}
            if name == "pose":
                blob["module.netG.encoder.MLP.L0.weight"] = torch.randn(128, 262, generator=g)
                blob["module.netD_motion.seq.0.weight"] = torch.randn(64, 6, 3, generator=g)
            path = os.path.join(root, f"audio2{name}.pth")
            torch.save({"model": blob}, path)
        elif name == "recon":
            blob = {f"face_3drecon.{k}": v for k, v in sd.items()}
            blob["audio2exp.mapping1.weight"] = torch.randn(64, 577, generator=g)
            path = os.path.join(root, "SadTalker_face.safetensors")
            write_safetensors(blob, path)
        else:
            path = os.path.join(root, "alignment_WFLW_4HG.pth")
            torch.save({"state_dict": sd}, path)
        out[name] = (path, {k: v for k, v in sd.items()
                            if not k.endswith("num_batches_tracked")})
    return out


def video_frames(path: str) -> int:
    import cv2
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def timed(fn, *args):
    """(fn's result, seconds), the device synchronised after."""
    import torch
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_face_stack(dev, card: str) -> dict:
    """The face stack at full widths (fp32), through the CLIs a user runs:
    weight files written under the reference names and read back strict
    (bit-equal) by the loaders the CLIs' flags reach; `face_fit_app.main`
    (the full FAN and ResNet-50) on a seeded 256^2 PNG; `audio2ldmk_app`'s
    sadtalker engine on a 6 s wav with a synthetic BFM at the front model's
    size (BFM_VERTICES, BFM_FACES), twice; its --face3dvis render on a
    1 s wav, one frame held against the CPU; the video engine;
    `opendomain_app --engine sadtalker` into KEYPOINT's size at a reduced
    depth, its launches held to the keypoint path's sites; then the traj,
    hybrid and keypoint CLIs once each through their files. The face
    stack itself launches no custom kernel."""
    import tempfile

    import cv2
    import numpy as np
    import torch
    from scipy.io import loadmat, savemat
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.apps import (audio2ldmk_app, face_fit_app, hybrid_app,
                                     keypoint_app, opendomain_app, traj_app)
    from mofa_tpu_torch.models.audio import face3d_render, sadtalker
    from mofa_tpu_torch.models.audio.aniportrait import load_wav
    from mofa_tpu_torch.pipelines.keypoint import window_views

    f, seed = FACE, FACE["seed"]
    res: dict = {}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        j = lambda name: os.path.join(root, name)
        t0 = time.perf_counter()
        smooth_png(j("face.png"), 256, 256, seed)
        write_bfm_mat(j("bfm.mat"), 189, 189, seed, BFM_VERTICES, BFM_FACES)
        bfm_mat = loadmat(j("bfm.mat"))
        # the standard landmarks: the synthetic BFM's own 68 keypoints
        ms = bfm_mat["meanshape"].reshape(-1, 3)
        savemat(j("lm3d.mat"), {"lm": (ms - ms.mean(0))[
            bfm_mat["keypoints"].reshape(-1).astype(int) - 1].astype(np.float64)})
        rng = np.random.RandomState(seed)
        write_wav(j("a6.wav"), rng.uniform(-0.5, 0.5, f["wav_s"] * AUDIO_SR), AUDIO_SR)
        write_wav(j("a1.wav"), rng.uniform(-0.5, 0.5, f["vis_wav_s"] * AUDIO_SR), AUDIO_SR)
        weights = write_face_weights(root, seed)
        log(f"  inputs written in {time.perf_counter() - t0:.1f} s: BFM "
            f"{bfm_mat['meanshape'].size // 3} vertices, {len(bfm_mat['tri'])} triangles "
            f"({os.path.getsize(j('bfm.mat')) / 2 ** 20:.0f} MiB); weights "
            + ", ".join(f"{k} {sum(v.numel() for v in sd.values())}"
                        for k, (_, sd) in weights.items()))

        # the weight files, strict through the CLIs' loaders, bit-equal
        nets = (audio2ldmk_app.load_sadtalker_nets(weights["exp"][0], weights["pose"][0], dev)
                + face_fit_app.load_face_nets(weights["recon"][0], weights["fan"][0], dev))
        n_checked = 0
        for name, net in zip(("exp", "pose", "recon", "fan"), nets):
            own, want = net.state_dict(), weights[name][1]
            bad = [k for k, v in want.items() if not torch.equal(own[k].cpu(), v)]
            missing = set(own) - set(want) - {k for k in own if k.endswith("num_batches_tracked")}
            if bad or missing:
                fail(f"face stack: {name} loaded from its file differs: {bad[:5]} {missing}")
            n_checked += len(want)
        exp_net, pose_net = nets[:2]
        del nets
        log(f"  {n_checked} tensors of the four files loaded strict, bit-equal")

        kernels.reset_launch_counts()
        # the face fit, twice
        fit = ["--image", j("face.png"), "--fan_ckpt", weights["fan"][0], "--ckpt",
               weights["recon"][0], "--lm3d_mat", j("lm3d.mat"), "--save", j("coeff.npz")]
        fit_s = [timed(face_fit_app.main, fit)[1] for _ in range(2)]
        out = np.load(j("coeff.npz"), allow_pickle=True)
        shapes = {k: tuple(out[k].shape) for k in ("full_3dmm", "coeff_3dmm", "trans_params")}
        if (shapes != {"full_3dmm": (1, 257), "coeff_3dmm": (1, 76), "trans_params": (8,)}
                or not all(np.isfinite(out[k].astype(np.float64)).all() for k in shapes)):
            fail(f"face_fit_app: npz {shapes}, finite "
                 f"{[bool(np.isfinite(out[k]).all()) for k in shapes]}")
        log(f"  face_fit_app (FAN 4 modules + ResNet-50, 256^2): {fit_s[0]:.3f} s (first "
            f"call), {fit_s[1]:.3f} s (second); trans_params {out['trans_params'].tolist()}")

        # the engines read the fit's crop; the random ReconNet's coefficients
        # are replaced by seeded small ones with a frontal pose, so the
        # mesh stays in front of the camera
        coeff = (rng.randn(1, 257) * 0.1).astype(np.float32)
        coeff[0, 224:227], coeff[0, 254:257] = (0.05, -0.1, 0.02), (0.0, 0.05, 0.0)
        np.savez(j("coeff_st.npz"), full_3dmm=coeff, trans_params=out["trans_params"],
                 crop_info=out["crop_info"])
        common = ["--ref_image_path", j("face.png"), "--coeff_npz", j("coeff_st.npz"),
                  "--bfm_mat", j("bfm.mat")]
        st = common + ["--engine", "sadtalker", "--audio_path", j("a6.wav"), "--exp_ckpt",
                       weights["exp"][0], "--pose_ckpt", weights["pose"][0]]
        st_s = [timed(audio2ldmk_app.main, st + ["--save_dir", j(f"st{i}")])[1]
                for i in range(2)]
        lm = np.load(j("st1/landmarks.npy"))
        want = (f["wav_s"] * AUDIO_FPS + 1, 68, 2)
        if lm.shape != want or not np.isfinite(lm).all():
            fail(f"sadtalker engine: landmarks {lm.shape} (expected {want}), finite "
                 f"{bool(np.isfinite(lm).all())}")
        if not np.array_equal(lm, np.load(j("st0/landmarks.npy"))):
            fail("sadtalker engine: two runs from the same seed differ")
        # its stages, timed apart (the second pass: warm)
        bfm = sadtalker.BFMModel.load(j("bfm.mat"), with_render_data=True)
        wav = load_wav(j("a6.wav"))
        stage = {}
        for _ in range(2):
            mels, stage["mel"] = timed(sadtalker.indiv_mel_windows, wav)
            coeffs, stage["exp+pose nets"] = timed(
                sadtalker.generate_coeffs, exp_net, pose_net, wav, np.concatenate(
                    [coeff[0, 80:144], coeff[0, 224:227], coeff[0, 254:257]]))
            _, stage["bfm landmarks"] = timed(bfm.landmarks, np.repeat(coeff, len(lm), 0))
        log(f"  sadtalker engine ({f['wav_s']} s wav -> {lm.shape}): {st_s[0]:.3f} s "
            f"(first call), {st_s[1]:.3f} s (second), the BFM .mat read included; stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in stage.items()))

        # --face3dvis on a 1 s wav: every frame of the track rendered
        vis = common + ["--engine", "sadtalker", "--audio_path", j("a1.wav"), "--face3dvis",
                        "--save_dir", j("vis")]
        _, vis_s = timed(audio2ldmk_app.main, vis)
        t_vis = f["vis_wav_s"] * AUDIO_FPS
        got = (video_frames(j("vis/3dface.mp4")), video_frames(j("vis/landmarks_vis.mp4")))
        if got != (t_vis, t_vis + 1):
            fail(f"--face3dvis: frames {got}, expected {(t_vis, t_vis + 1)}")
        # the render of one frame on the card against the same code on the CPU
        _, all_c = sadtalker.sadtalker_audio_to_landmarks(
            exp_net, pose_net, bfm, load_wav(j("a1.wav")), coeff, out["trans_params"],
            out["crop_info"].tolist(), return_coeffs=True)
        verts, colors = face3d_render.compute_for_render(bfm, all_c[1 + t_vis // 2][None])
        tri = torch.from_numpy(bfm.face_buf)
        frame = lambda d, **kw: face3d_render.rasterize_mesh(
            torch.from_numpy(verts[0]).to(d), tri.to(d), torch.from_numpy(colors[0]).to(d),
            **kw)
        frame(dev)
        (img_d, mask_d), frame_s = timed(frame, dev)
        (img_c, mask_c), cpu_s = timed(lambda: frame("cpu", face_chunk=f["raster_chunk_cpu"]))
        img_d, mask_d = img_d.cpu(), mask_d.cpu()
        agree = float((mask_d == mask_c).float().mean())
        both = mask_d & mask_c
        diff = (img_d[both] - img_c[both]).abs().amax(-1)
        colour_err = float(diff.max()) if both.any() else 0.0
        off = float((diff > f["colour_tol"]).float().mean()) if both.any() else 0.0
        log(f"  --face3dvis ({t_vis} frames, {BFM_FACES} triangles at 224^2): "
            f"{vis_s:.3f} s the call; one frame {frame_s:.4f} s on the card (blocks of 512), "
            f"{cpu_s:.3f} s on the CPU (blocks of {f['raster_chunk_cpu']}); coverage "
            f"{float(mask_d.float().mean()):.4f}; masks agree on {agree:.6f} of pixels "
            f"(bound {f['mask_agree']}), colours max|diff| {colour_err:.3e} where both "
            f"hit (bound {f['colour_tol']}; {off:.2e} of them beyond it)")
        if agree < f["mask_agree"] or colour_err > f["colour_tol"] or mask_d.float().mean() < 0.3:
            fail("the card's render disagrees with the CPU's, or covers under 30% of the frame")

        # the video engine
        np.savez(j("drive.npz"), coeff_3dmm=(rng.randn(f["drive_frames"], 70) * 0.05)
                 .astype(np.float32))
        _, vid_s = timed(audio2ldmk_app.main, common + [
            "--engine", "video", "--audio_path", j("a1.wav"), "--driving_coeffs_npz",
            j("drive.npz"), "--save_dir", j("vid")])
        lm_v = np.load(j("vid/landmarks.npy"))
        if lm_v.shape != (f["drive_frames"] + 1, 68, 2) or not np.isfinite(lm_v).all():
            fail(f"video engine: landmarks {lm_v.shape}")
        log(f"  video engine ({f['drive_frames']} frames -> {lm_v.shape}): {vid_s:.3f} s")
        face_launches = kernels.launch_counts()
        if any(face_launches.values()):
            fail(f"the face stack launched custom kernels: {face_launches}")
        del exp_net, pose_net
        torch.cuda.empty_cache()

        # opendomain, sadtalker engine -> the keypoint app, 512^2, bf16
        h = w = KEYPOINT["h"]
        smooth_png(j("od.png"), h, w, seed + 1)
        views = window_views(f["od_frames"], KEYPOINT["window"], KEYPOINT["stride"])
        kernels.reset_launch_counts()
        _, od_s = timed(opendomain_app.main, [
            "--engine", "sadtalker", "--image", j("od.png"), "--audio", j("a6.wav"),
            "--coeff_npz", j("coeff_st.npz"), "--bfm_mat", j("bfm.mat"), "--work_dir",
            j("od"), "--output", j("od.mp4"), "--num_frames", str(f["od_frames"]),
            "--window_size", str(KEYPOINT["window"]), "--stride", str(KEYPOINT["stride"]),
            "--num_inference_steps", str(f["od_steps"]), "--target_size", str(h), "--bf16"])
        od_launches = kernels.launch_counts()
        want_l = expected_launches("tmajor", f["od_steps"], size=(h, w), views=len(views),
                                   warps=len(set(views)))
        log(f"  opendomain_app --engine sadtalker ({f['od_frames']} frames, {len(views)} "
            f"views, {f['od_steps']} steps, {h}^2, bf16): {od_s:.3f} s; launches "
            f"{od_launches}")
        if od_launches != want_l:
            fail(f"opendomain sadtalker launches {od_launches}, expected {want_l}")
        if video_frames(j("od/video_silent.mp4")) != f["od_frames"]:
            fail("opendomain: the silent video has the wrong frame count")
        # the first FRONT["frames"] of the engine's coefficient track drive phase 5k
        res["track"] = coeffs[:FRONT["frames"]].astype(np.float32)
        res.update(face_fit_s=fit_s, sadtalker_s=st_s, stages=stage, face3dvis_s=vis_s,
                   frame_s=frame_s, mask_agree=agree, colour_err=colour_err,
                   video_s=vid_s, opendomain_s=od_s, opendomain_launches=od_launches)

        # the image CLIs through their files (cv2 in, mp4 out)
        smooth_png(j("wide.png"), 256, 384, seed + 2)
        brush = np.zeros((256, 384), np.uint8)
        brush[:, :192] = 255
        cv2.imwrite(j("brush.png"), brush)
        with open(j("tracks.json"), "w") as fh:
            json.dump({"tracks": seeded_tracks(256, 384, seed), "motion_brush": j("brush.png")},
                      fh)
        lm_cli = seeded_landmarks(256, 256, 8, seed)
        np.save(j("lm.npy"), lm_cli)
        mask = (elliptical_mask(256, 256, lm_cli[0].mean(0), (60, 80)) * 255).astype(np.uint8)
        cv2.imwrite(j("mask.png"), mask)
        small = ["--num_inference_steps", str(f["cli_steps"]), "--target_size", "256", "--bf16"]
        runs = (("traj_app", traj_app, ["--image", j("wide.png"), "--tracks", j("tracks.json"),
                                        "--num_frames", "8"], 8),
                ("hybrid_app", hybrid_app, ["--image", j("face.png"), "--landmarks",
                                            j("lm.npy"), "--face_mask", j("mask.png")], 8),
                ("keypoint_app", keypoint_app, ["--image", j("face.png"), "--landmarks",
                                                j("lm.npy"), "--num_frames", "8",
                                                "--window_size", "8", "--stride", "4"], 8))
        cli_s = {}
        for name, app, argv, frames in runs:
            _, cli_s[name] = timed(app.main, argv + small + ["--output", j(f"{name}.mp4")])
            if video_frames(j(f"{name}.mp4")) != frames:
                fail(f"{name}.main: {video_frames(j(f'{name}.mp4'))} frames written, "
                     f"expected {frames}")
        log("  the image CLIs through their files, 2 steps, bf16: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in cli_s.items()) + f"; card {card}")
        res["cli_s"] = cli_s
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------ phase 5k: the face front, facerender

# The mediapipe face front and SadTalker's facerender path at full widths,
# fp32: a synthetic face_landmarker .task (tests/torch_ref/tflite_writer.py:
# the three graphs at the published shapes, seeded weights, planted head
# biases so a face is found), the driving video 2 s at 25 fps, facerender
# at 256^2 on 50 frames of phase 5j's coefficient track, GFPGANv1.4's
# widths. Card against CPU: cuDNN may run the fp32 convs in TF32 (PyTorch's
# default, as for phase 5's CMP and phase 5j's face nets) and matmuls stay
# full fp32, so each compiled graph's outputs and one rendered frame are
# held to FRONT["tol"] of their largest magnitude (TF32's 10-bit mantissa
# through tens of layers; a wrong padding, layout or weight moves outputs
# by their own size).
FRONT = dict(seed=41, video_s=2, fps=25, frames=50, size=256, full=(384, 320),
             tol=2e-2, bfm_grid=48)


def load_tflite_writer():
    """tests/torch_ref/tflite_writer.py loaded from its file (a package
    named `tests` installed on the machine may shadow the repo's)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tflite_writer", os.path.join(REPO, "tests", "torch_ref", "tflite_writer.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tflite_bit_equal(module, graph) -> int:
    """The compiled module's tensors (on the card) against the file's
    constants as parsed on the host: each float constant bit-equal, conv
    kernels in the layout the module keeps them (OHWI -> OIHW, depthwise
    [1, H, W, C*m] -> [C*m, 1, H, W]). Returns the count checked."""
    import numpy as np
    import torch
    layout = {op.inputs[1]: op.name for op in graph.ops
              if op.name in ("CONV_2D", "DEPTHWISE_CONV_2D")}
    n = 0
    for name, buf in module.named_buffers():
        tid = int(name[1:])
        want = torch.from_numpy(np.array(graph.constants[tid]))
        if layout.get(tid) == "CONV_2D":
            want = want.permute(0, 3, 1, 2)
        elif layout.get(tid) == "DEPTHWISE_CONV_2D":
            want = want[0].permute(2, 0, 1)[:, None]
        if not torch.equal(buf.cpu(), want):
            fail(f"tflite: tensor {tid} on the card differs from the file")
        n += 1
    return n


def write_facerender_weights(path: str, seed: int) -> dict:
    """Seeded full-width facerender nets (the SPADE generator, the keypoint
    detector, the mapping net, the head-pose estimator) in one .safetensors
    under the reference's prefixes, the SPADE blocks' convs as spectral-norm
    triplets (weight_orig = 2.5 W, seeded u, v), BatchNorm counters and the
    anti-alias kernel as the reference saves them. Returns net -> the state
    dict each must load (the triplets folded here: W / (u W v))."""
    import numpy as np
    import torch
    from mofa_tpu_torch.apps.loaders import init_random_cmp_
    from mofa_tpu_torch.models import facerender as fr
    g = torch.Generator().manual_seed(seed)
    rng = np.random.RandomState(seed)
    nets = {"generator": fr.OcclusionAwareSPADEGenerator(), "kp_detector": fr.KPDetector(),
            "mapping": fr.MappingNet(), "he_estimator": fr.HEEstimator()}
    blob, want = {}, {}
    for name, net in nets.items():
        prefix = fr.FACERENDER_PREFIXES[name]
        sd = init_random_cmp_(net, g).state_dict()
        want[name] = {}
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                blob[prefix + k] = v
                continue
            if name == "generator" and k.endswith((".conv_0.weight", ".conv_1.weight",
                                                   ".conv_s.weight")):
                base = prefix + k[:-len(".weight")]
                w = (v * 2.5).numpy()
                u = rng.randn(w.shape[0]).astype(np.float32)
                vv = rng.randn(w[0].size).astype(np.float32)
                blob.update({base + ".weight_orig": torch.from_numpy(w),
                             base + ".weight_u": torch.from_numpy(u),
                             base + ".weight_v": torch.from_numpy(vv)})
                want[name][k] = torch.from_numpy(w / float(u @ w.reshape(w.shape[0], -1) @ vv))
            else:
                blob[prefix + k] = v
                want[name][k] = v
    blob["kp_extractor.down.weight"] = torch.ones(3, 1, 13, 13)
    write_safetensors(blob, path)
    return want


def run_face_front(dev, card: str, track) -> dict:
    """Phase 5k: the synthetic .task's graphs on the card held to the CPU;
    `face_fit_app --task` (BlazeFace's box, the full FAN and ResNet-50);
    `audio2ldmk_app --task` (the FaceLandmarker on the reference image, the
    AniPortrait engine at full widths); `audio2ldmk_app --engine video
    --driving_video` (a seeded 2 s mp4 fitted frame by frame);
    `facerender_app` at 256^2 on phase 5j's track with `--enhancer gfpgan`
    and `--paste_back` (face_fit_app's crop info). Weight files written
    under the reference's names and read back strict, bit-equal; each stage
    timed; one rendered frame held to the CPU. No custom kernel launches."""
    import tempfile
    import zipfile

    import cv2
    import numpy as np
    import torch
    from scipy.io import loadmat, savemat
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.apps import audio2ldmk_app, face_fit_app, facerender_app
    from mofa_tpu_torch.interop.tflite import TFLiteGraph, compile_tflite
    from mofa_tpu_torch.models import facerender as fr
    from mofa_tpu_torch.models import gfpgan, mp_face
    from mofa_tpu_torch.models.audio.face3d_fit import load_lm3d
    from mofa_tpu_torch.preprocess import enhance, video_fit
    from mofa_tpu_torch.preprocess.image import BICUBIC, pil_resize, read_image
    tflite_writer = load_tflite_writer()

    f, seed = FRONT, FRONT["seed"]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    res: dict = {}
    torch.cuda.reset_peak_memory_stats()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        j = lambda name: os.path.join(root, name)
        t0 = time.perf_counter()
        task = j("face_landmarker_v2_with_blendshapes.task")
        members = tflite_writer.write_task(task, seed)
        fh, fw = f["full"]
        smooth_png(j("full.png"), fh, fw, seed)
        weights = write_face_weights(root, seed)
        fr_want = write_facerender_weights(j("SadTalker_V0.0.2_256.safetensors"), seed)
        gf = gfpgan.init_gfpgan_(gfpgan.GFPGANv1Clean(), torch.Generator().manual_seed(seed))
        gf_sd = gf.state_dict()
        torch.save({"params_ema": gf_sd}, j("GFPGANv1.4.pth"))
        del gf
        write_bfm_mat(j("bfm.mat"), f["bfm_grid"], f["bfm_grid"], seed)
        bfm_mat = loadmat(j("bfm.mat"))
        ms = bfm_mat["meanshape"].reshape(-1, 3)
        savemat(j("lm3d.mat"), {"lm": (ms - ms.mean(0))[
            bfm_mat["keypoints"].reshape(-1).astype(int) - 1].astype(np.float64)})
        rng = np.random.RandomState(seed)
        write_wav(j("a.wav"), rng.uniform(-0.5, 0.5, f["video_s"] * AUDIO_SR), AUDIO_SR)
        # the driving video: the full image drifting a few pixels a frame
        base = cv2.imread(j("full.png"))
        vw = cv2.VideoWriter(j("drive.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), f["fps"], (fw, fh))
        for i in range(f["video_s"] * f["fps"]):
            vw.write(np.roll(base, (i % 7) - 3, axis=1))
        vw.release()
        log(f"  inputs written in {time.perf_counter() - t0:.1f} s: .task "
            + ", ".join(f"{k} {len(v) / 2 ** 20:.2f} MiB" for k, v in members.items())
            + f"; facerender {sum(v.numel() for sd in fr_want.values() for v in sd.values())} "
            f"parameters, GFPGAN {sum(v.numel() for v in gf_sd.values())}")

        # the weight files, strict, bit-equal on the card
        nets = facerender_app.load_facerender(j("SadTalker_V0.0.2_256.safetensors"), dev,
                                              with_he=True)
        n_checked = 0
        for name, net in nets.items():
            own = {k: v for k, v in net.state_dict().items()
                   if not k.endswith("num_batches_tracked")}
            bad = [k for k, v in fr_want[name].items() if not torch.equal(own[k].cpu(), v)]
            if bad or own.keys() != fr_want[name].keys():
                fail(f"facerender: {name} loaded from its file differs: {bad[:5]}")
            n_checked += len(own)
        del nets
        gmodel = gfpgan.load_gfpgan(j("GFPGANv1.4.pth"), dev)
        if any(not torch.equal(v.cpu(), gf_sd[k]) for k, v in gmodel.state_dict().items()):
            fail("GFPGAN loaded from GFPGANv1.4.pth differs")
        n_checked += len(gf_sd)
        lm_card = mp_face.load_face_landmarker(task, dev)
        with zipfile.ZipFile(task) as z:
            graphs = [TFLiteGraph.from_bytes(z.read(m)) for m in tflite_writer.TASK_MEMBERS[:3]]
        mods = (lm_card.detector, lm_card.landmarks, lm_card.blendshapes)
        for mod, graph in zip(mods, graphs):
            n_checked += tflite_bit_equal(mod, graph)
        log(f"  {n_checked} tensors of the facerender, GFPGAN and .task files loaded "
            "strict, bit-equal")

        # each compiled graph on the card against the CPU, and its time
        kernels.reset_launch_counts()
        g = torch.Generator().manual_seed(seed)
        feeds = (torch.rand(1, 128, 128, 3, generator=g) * 2 - 1,
                 torch.rand(1, 256, 256, 3, generator=g),
                 torch.rand(1, 146, 2, generator=g) * 256)
        graph_ms, graph_err = {}, {}
        for name, mod, graph, x in zip(("blazeface", "landmarks", "blendshapes"), mods,
                                       graphs, feeds):
            xd = x.to(dev)
            got = [o.cpu() for o in mod(xd)]
            want = compile_tflite(graph, "cpu")(x)
            err = max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))
                      for a, b in zip(got, want))
            graph_err[name] = err
            graph_ms[name] = time_ms(lambda: mod(xd))
            if err > f["tol"] or not all(torch.isfinite(o).all() for o in got):
                fail(f"tflite {name}: the card's outputs are {err:.3e} of their size from "
                     f"the CPU's (bound {f['tol']})")
        img = cv2.imread(j("full.png"))[..., ::-1].copy()
        det = mp_face.detect_face(lm_card.detector, img.astype(np.float32) / 255.0)
        out = lm_card(img)
        if det is None or out is None:
            fail("the landmarker found no face in the seeded image (planted biases)")
        _, solve_s = timed(lm_card._solve_pose, out["lmks"], fw / fh)
        _, landmarker_s = timed(lm_card, img)
        log("  tflite graphs on the card (ms, median of 5): " + ", ".join(
            f"{k} {v:.3f} (card vs CPU {graph_err[k]:.2e} of max)" for k, v in graph_ms.items())
            + f"; the whole landmarker {landmarker_s:.3f} s, the Procrustes solve "
            f"{solve_s * 1e3:.3f} ms; box {np.round(det[0], 3).tolist()}, score {det[2]:.3f}")

        # face_fit_app --task: BlazeFace's box, the full FAN and ResNet-50
        fit = ["--image", j("full.png"), "--task", task, "--fan_ckpt", weights["fan"][0],
               "--ckpt", weights["recon"][0], "--lm3d_mat", j("lm3d.mat"), "--save",
               j("coeff.npz")]
        _, fit_s = timed(face_fit_app.main, fit)
        fit_out = np.load(j("coeff.npz"), allow_pickle=True)
        if fit_out["full_3dmm"].shape != (1, 257) or not np.isfinite(fit_out["full_3dmm"]).all():
            fail("face_fit_app --task: bad full_3dmm")

        # audio2ldmk_app --task: the FaceLandmarker on the reference image
        _, ap_s = timed(audio2ldmk_app.main, [
            "--ref_image_path", j("full.png"), "--audio_path", j("a.wav"), "--task", task,
            "--save_dir", j("ap")])
        lm_ap = np.load(j("ap/landmarks.npy"))
        if lm_ap.shape != (f["video_s"] * f["fps"] + 1, 68, 2) or not np.isfinite(lm_ap).all():
            fail(f"audio2ldmk_app --task: landmarks {lm_ap.shape}")

        # audio2ldmk_app --engine video --driving_video: the raw-video fit
        coeff = (rng.randn(1, 257) * 0.1).astype(np.float32)
        coeff[0, 224:227], coeff[0, 254:257] = (0.05, -0.1, 0.02), (0.0, 0.05, 0.0)
        np.savez(j("coeff_st.npz"), full_3dmm=coeff, trans_params=fit_out["trans_params"],
                 crop_info=fit_out["crop_info"])
        _, vid_s = timed(audio2ldmk_app.main, [
            "--ref_image_path", j("full.png"), "--audio_path", j("a.wav"), "--engine", "video",
            "--coeff_npz", j("coeff_st.npz"), "--bfm_mat", j("bfm.mat"), "--driving_video",
            j("drive.mp4"), "--task", task, "--fan_ckpt", weights["fan"][0], "--recon_ckpt",
            weights["recon"][0], "--lm3d_mat", j("lm3d.mat"), "--save_dir", j("vid")])
        n_video = f["video_s"] * f["fps"]
        lm_v = np.load(j("vid/landmarks.npy"))
        if lm_v.shape != (n_video + 1, 68, 2) or not np.isfinite(lm_v).all():
            fail(f"--driving_video: landmarks {lm_v.shape}")
        recon, fan = face_fit_app.load_face_nets(weights["recon"][0], weights["fan"][0], dev)
        (track_v, _), fitv_s = timed(video_fit.fit_driving_video, j("drive.mp4"),
                                     lm_card.detector, fan, recon, load_lm3d(j("lm3d.mat")))
        del recon, fan
        log(f"  face_fit_app --task {fit_s:.3f} s; audio2ldmk_app --task ({f['video_s']} s wav) "
            f"{ap_s:.3f} s; --engine video --driving_video ({n_video} frames at {fw}x{fh}) "
            f"{vid_s:.3f} s, its fit alone {fitv_s:.3f} s = {fitv_s / n_video * 1e3:.2f} ms a "
            f"frame (track {track_v.shape})")

        # facerender_app on phase 5j's track, GFPGAN, paste back
        np.savez(j("track.npz"), coeff_3dmm=np.asarray(track, np.float32))
        ci = fit_out["crop_info"].tolist()
        np.savez(j("crop.npz"), crop_info=np.asarray([v for part in ci for v in part], np.int64))
        pic = f["size"]
        cv2.imwrite(j("face.png"), cv2.resize(base, (pic, pic), interpolation=cv2.INTER_AREA))
        fr_args = ["--image", j("face.png"), "--coeff_npz", j("coeff.npz"),
                   "--driving_coeffs_npz", j("track.npz"), "--ckpt",
                   j("SadTalker_V0.0.2_256.safetensors"), "--size", str(pic), "--output",
                   j("render.mp4"), "--enhancer", "gfpgan", "--gfpgan_ckpt",
                   j("GFPGANv1.4.pth"), "--paste_back", "--full_image", j("full.png"),
                   "--crop_info_npz", j("crop.npz")]
        frames8, fr_s = timed(facerender_app.main, fr_args)
        if frames8.shape != (len(track), fh, fw, 3) or video_frames(j("render.mp4")) != len(track):
            fail(f"facerender_app: frames {frames8.shape}, mp4 {video_frames(j('render.mp4'))}")
        # its stages apart (warm), and one frame against the CPU
        nets = facerender_app.load_facerender(j("SadTalker_V0.0.2_256.safetensors"), dev)
        src = pil_resize(read_image(j("face.png")), (pic, pic), BICUBIC)
        source = torch.from_numpy(src.astype(np.float32) / 255.0).permute(2, 0, 1)[None].to(dev)
        src_sem, tgt_sem = fr.build_semantics(
            facerender_app.source_coeff70(fit_out["full_3dmm"]), np.asarray(track))
        src_sem, tgt_sem = torch.from_numpy(src_sem).to(dev), torch.from_numpy(tgt_sem).to(dev)
        stage = {}
        with torch.no_grad():
            for _ in range(2):
                _, stage["keypoints"] = timed(nets["kp_detector"], source)
                _, stage["mapping"] = timed(nets["mapping"], src_sem)
            frames, anim_s = timed(fr.make_animation, source, src_sem, tgt_sem,
                                   nets["generator"], nets["kp_detector"], nets["mapping"])
        k = len(track) // 2
        cpu_nets = facerender_app.load_facerender(j("SadTalker_V0.0.2_256.safetensors"),
                                                  "cpu")
        (want,), cpu_s = timed(lambda: fr.make_animation(
            source.cpu(), src_sem.cpu(), tgt_sem[:, k:k + 1].cpu(), cpu_nets["generator"],
            cpu_nets["kp_detector"], cpu_nets["mapping"])[0])
        del cpu_nets
        frame_err = float((frames[0, k].cpu() - want).abs().max())
        if frame_err > f["tol"] or not torch.isfinite(frames).all():
            fail(f"facerender: frame {k} on the card is {frame_err:.3e} from the CPU's "
                 f"(bound {f['tol']})")
        frames8_raw = (frames[0].permute(0, 2, 3, 1).clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        enh, gf_s = timed(lambda: gfpgan.enhance_aligned(gmodel, frames8_raw.astype(np.float32)
                                                         / 255.0))
        full = cv2.imread(j("full.png"))[..., ::-1].copy()
        crop_info = (tuple(ci[0]), tuple(ci[1]), tuple(ci[2]))
        _, paste_s = timed(enhance.paste_back_frames, (enh * 255).astype(np.uint8), full,
                           crop_info)
        launches = kernels.launch_counts()
        if any(launches.values()):
            fail(f"the face front launched custom kernels: {launches}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n = len(track)
        log(f"  facerender_app ({n} frames at {pic}^2, SPADE generator, --enhancer gfpgan at "
            f"GFPGANv1.4's widths, --paste_back into {fw}x{fh}): {fr_s:.3f} s the call; "
            f"stages: keypoints {stage['keypoints'] * 1e3:.2f} ms, mapping "
            f"{stage['mapping'] * 1e3:.2f} ms, render {anim_s / n * 1e3:.2f} ms a frame, "
            f"GFPGAN {gf_s / n * 1e3:.2f} ms a frame, paste-back {paste_s / n * 1e3:.2f} ms a "
            f"frame; frame {k} card vs CPU max|diff| {frame_err:.3e} (bound {f['tol']}; the "
            f"CPU {cpu_s:.2f} s); peak {peak:.2f} GiB; card {card}")
        res.update(graph_ms=graph_ms, graph_err=graph_err, solve_s=solve_s,
                   landmarker_s=landmarker_s, face_fit_s=fit_s, aniportrait_task_s=ap_s,
                   video_engine_s=vid_s, video_fit_frame_s=fitv_s / n_video,
                   facerender_s=fr_s, stages=stage, render_frame_s=anim_s / n,
                   gfpgan_frame_s=gf_s / n, paste_frame_s=paste_s / n, frame_err=frame_err,
                   peak_gib=peak)
        del nets, gmodel, lm_card
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()
    return res


# ------------------------------------ phase 5l: native, PIRender, FILM, UI

# The native host library at the main path's sizes; PIRender at
# PIRenderConfig() on a 256^2 source, 50 frames; FILM at FilmConfig() on
# 4 frames of 512^2; the UI server on the card (its /run the 25-frame,
# 25-step main path at 576x1024, bf16; /run_landmarks at 5 steps). Card
# against CPU: `tol` of max(1, max |CPU|), cuDNN TF32 allowed as in 5k.
UI = dict(seed=51, pirender_frames=50, pirender_size=256, film_size=512, film_frames=4,
          landmark_steps=5, keypoint_size=512, tol=2e-2, timeout=900)


def host_ms(fn, *args, iters: int = 5):
    """(fn's result, median host ms of `iters` calls)."""
    times, out = [], None
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(times)[len(times) // 2]


def run_native(card: str) -> dict:
    """The native library built with g++ on this machine (a failed build
    fails the run), its four entry points held bit-equal to their numpy
    versions at the main path's sizes: 6 PCHIP tracks over 24 steps
    rasterised at 576x1024, the NMS of a 384^2 score map (15 x 15), the
    neighbour elimination of 256 of its peaks, the PCHIP slopes of each
    track."""
    import numpy as np
    from mofa_tpu_torch import native
    from mofa_tpu_torch.ops.rasterize import rasterize_trajectories
    from mofa_tpu_torch.ops.trajectory import _pchip_derivatives, interpolate_trajectory
    from mofa_tpu_torch.train.flow_sampler import square_nms as square_nms_numpy

    t0 = time.perf_counter()
    if not native.available():
        fail(f"native: the host library did not build: {native.build_error()}")
    log(f"  native: {os.path.relpath(native.library_path(), REPO)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    h, w, t = MAIN["h"], MAIN["w"], MAIN["t"]
    rng = np.random.RandomState(UI["seed"])
    clicks = seeded_tracks(h, w, UI["seed"])
    tracks = np.stack([np.asarray(interpolate_trajectory(tr, t)) for tr in clicks])
    score = rng.rand(384, 384).astype(np.float32)
    knots = [(np.linspace(0, 1, len(tr)), np.asarray(tr, np.float64)[:, 0]) for tr in clicks]
    peaks = [p[:256].astype(np.int64) for p in np.where(native.square_nms(score, 15) > 0)]
    coins = rng.rand(len(peaks[0]) ** 2).astype(np.float32)

    def elim_numpy(rows, cols, d, c):
        keep = native.neighbor_elim_numpy(rows, cols, d, c)
        return rows[keep], cols[keep]

    # name: (the native entry point, its numpy version, their arguments)
    calls = {
        "rasterize_tracks": (native.rasterize_tracks, rasterize_trajectories,
                             (tracks, t - 1, h, w)),
        "square_nms": (native.square_nms, square_nms_numpy, (score, 15)),
        "pchip_derivatives": (
            lambda: [native.pchip_derivatives(x, y) for x, y in knots],
            lambda: [_pchip_derivatives(x, y) for x, y in knots], ()),
        "neighbor_elim": (native.neighbor_elim, elim_numpy,
                          (peaks[0], peaks[1], 7.0, coins))}
    res = {}
    for name, (fn, numpy_fn, args) in calls.items():
        got, ms = host_ms(fn, *args)
        want, np_ms = host_ms(numpy_fn, *args)
        got = got if isinstance(got, (tuple, list)) else [got]
        want = want if isinstance(want, (tuple, list)) else [want]
        if len(got) != len(want) or not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"native: {name} differs from its numpy version")
        res[name] = dict(ms=ms, numpy_ms=np_ms)
        log(f"  native {name}: {ms:.3f} ms, numpy {np_ms:.3f} ms (median of 5, host), "
            f"bit-equal; card {card}")
    if float(native.rasterize_tracks(tracks, t - 1, h, w)[1].sum()) != 6 * (t - 1):
        fail("native: the rasteriser painted the wrong number of points")
    return res


def semantics_windows(frames: int, seed: int, radius: int = 13):
    """A seeded smooth [frames, 73] coefficient track in edge-clamped
    windows of 2 * radius + 1 frames -> [1, frames, 73, 2r + 1] (the
    reference's pirender semantics)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    track = np.cumsum(rng.randn(frames, 73) * 0.05, axis=0) + rng.randn(73) * 0.3
    idx = np.clip(np.arange(frames)[:, None] + np.arange(-radius, radius + 1)[None],
                  0, frames - 1)
    return track[idx].transpose(0, 2, 1)[None].astype(np.float32)


def run_pirender(dev, card: str, root: str) -> dict:
    """PIRender at PIRenderConfig(), fp32: seeded weights written as the
    reference's checkpoint ({"net_G_ema": ...}, `module.` prefixed) and read
    back strict and bit-equal; 50 frames of 27-frame windows through
    `pirender_animation` on a 256^2 source; one frame held to the CPU."""
    import torch
    from mofa_tpu_torch.models import pirender as pr
    from mofa_tpu_torch.models.weights import load_torch_checkpoint, pirender_state_dict
    from mofa_tpu_torch.pipelines.common import init_random_

    u, s = UI, UI["pirender_size"]
    sd = init_random_(pr.FaceGenerator(), torch.Generator().manual_seed(u["seed"])).state_dict()
    path = os.path.join(root, "pirender_checkpoint.pt")
    torch.save({"net_G_ema": {"module." + k: v for k, v in sd.items()}}, path)
    read = pirender_state_dict(load_torch_checkpoint(path))
    with torch.device(dev):
        net = pr.FaceGenerator()
    net.load_state_dict(read, strict=True)
    net.eval()
    bad = [k for k, v in net.state_dict().items() if not torch.equal(v.cpu(), sd[k])]
    if bad:
        fail(f"pirender: tensors changed on the way to the card: {bad[:5]}")
    img, _ = smooth_inputs(1, 2, s, s, dev, seed=u["seed"])
    source = img.permute(0, 3, 1, 2).contiguous()
    sem = torch.from_numpy(semantics_windows(u["pirender_frames"], u["seed"])).to(dev)
    torch.cuda.reset_peak_memory_stats()
    timed(pr.pirender_animation, source, sem[:, :1], net)          # warm-up
    frames, secs = timed(pr.pirender_animation, source, sem, net)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = sem.shape[1]
    if tuple(frames.shape) != (1, n, 3, s, s) or not bool(torch.isfinite(frames).all()):
        fail(f"pirender: frames {tuple(frames.shape)} or non-finite")
    cpu = pr.FaceGenerator().eval()
    cpu.load_state_dict(read, strict=True)
    k = n // 2
    with torch.no_grad():
        want, cpu_s = timed(lambda: cpu(source.cpu(), sem[:, k].cpu())["fake_image"])
    err = float((frames[:, k].cpu() - want).abs().max())
    bound = u["tol"] * max(1.0, float(want.abs().max()))
    if err > bound:
        fail(f"pirender: frame {k} on the card is {err:.3e} from the CPU's (bound {bound})")
    # LayerNorm2d at its largest site (down0, before the pool) beside the
    # stock F.layer_norm over the same (C, H, W)
    norm = net.editing_net.encoder.down0.model[1]
    x = torch.randn(1, norm.weight.shape[0], s, s, device=dev)
    shape = x.shape[1:]
    with torch.no_grad():
        ln_ms = time_ms(lambda: norm(x))
        stock_ms = time_ms(lambda: torch.nn.functional.layer_norm(
            x, shape, norm.weight.expand(shape), norm.bias.expand(shape)))
    log(f"  pirender LayerNorm2d on {tuple(x.shape)}: {ln_ms:.3f} ms (var_mean), "
        f"F.layer_norm {stock_ms:.3f} ms (CUDA events, median of 5); card {card}")
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  pirender ({n_params} parameters, {len(sd)} tensors read back strict): {n} frames "
        f"at {s}^2 in {secs:.3f} s = {secs / n * 1e3:.2f} ms a frame; frame {k} card vs CPU "
        f"max|diff| {err:.3e} (bound {bound:.3e}; the CPU {cpu_s:.2f} s); peak {peak:.2f} GiB; "
        f"card {card}")
    return dict(frame_ms=secs / n * 1e3, err=err, peak_gib=peak, layer_norm_ms=ln_ms,
                stock_layer_norm_ms=stock_ms)


def run_film(dev, card: str) -> dict:
    """FILM at FilmConfig(), fp32, seeded weights: `interpolate_frames`
    over 4 frames of 512^2 (a smooth image moving 8 px a frame) with
    inter_frames 1 and 3, each prediction on the card; one prediction held
    to the CPU."""
    import numpy as np
    import torch
    from mofa_tpu_torch.models import film
    from mofa_tpu_torch.pipelines.common import init_random_

    u, s = UI, UI["film_size"]
    cpu = init_random_(film.FilmNet(), torch.Generator().manual_seed(u["seed"])).eval()
    with torch.device(dev):
        net = film.FilmNet()
    net.load_state_dict(cpu.state_dict(), strict=True)
    net.eval()
    img, _ = smooth_inputs(1, 2, s, s, dev, seed=u["seed"] + 1)
    frames = np.stack([torch.roll(img[0], 8 * i, dims=1).cpu().numpy()
                       for i in range(u["film_frames"])])
    times = []

    @torch.no_grad()
    def predict(x0, x1, dt):
        t0 = time.perf_counter()
        a = torch.from_numpy(np.ascontiguousarray(x0)).to(dev).permute(2, 0, 1)[None]
        b = torch.from_numpy(np.ascontiguousarray(x1)).to(dev).permute(2, 0, 1)[None]
        out = net(a, b, dt)[0].permute(1, 2, 0).cpu().numpy()
        times.append(time.perf_counter() - t0)
        return out

    torch.cuda.reset_peak_memory_stats()
    predict(frames[0], frames[1], 0.5)                              # warm-up
    res = {}
    for inter in (1, 3):
        times.clear()
        out, secs = timed(film.interpolate_frames, frames, inter, predict)
        want = (len(frames) + (len(frames) - 1) * inter, s, s, 3)
        if out.shape != want or not np.isfinite(out).all():
            fail(f"film: inter_frames {inter} gave {out.shape}, want {want}, or non-finite")
        res[inter] = sorted(times)[len(times) // 2] * 1e3
        log(f"  film inter_frames {inter}: {len(times)} predictions at {s}^2 in {secs:.3f} s, "
            f"median {res[inter]:.2f} ms a prediction (host clock, synchronised by the copy "
            f"back); card {card}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = predict(frames[0], frames[1], 0.5)
    with torch.no_grad():
        want, cpu_s = timed(lambda: cpu(torch.from_numpy(frames[:1]).permute(0, 3, 1, 2),
                                        torch.from_numpy(frames[1:2]).permute(0, 3, 1, 2),
                                        0.5)[0].permute(1, 2, 0).numpy())
    err = float(np.abs(got - want).max())
    bound = u["tol"] * max(1.0, float(np.abs(want).max()))
    if err > bound:
        fail(f"film: a prediction on the card is {err:.3e} from the CPU's (bound {bound})")
    n_params = sum(p.numel() for p in net.parameters())
    log(f"  film ({n_params} parameters): a prediction card vs CPU max|diff| {err:.3e} (bound "
        f"{bound:.3e}; the CPU {cpu_s:.2f} s); peak {peak:.2f} GiB; card {card}")
    return dict(prediction_ms=res[3], err=err, peak_gib=peak)


def _http(url: str, body=None, timeout: int = UI["timeout"]):
    """GET (body None) or POST JSON -> the response's bytes."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _png_data_url(path: str) -> str:
    import base64
    with open(path, "rb") as f:
        return "data:image/png;base64," + base64.b64encode(f.read()).decode()


def _npy_b64(arr) -> str:
    import base64
    import io

    import numpy as np
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


@contextlib.contextmanager
def ui_server_thread(argv: list):
    """The port's UI server on 127.0.0.1 (a free port) in a thread; yields
    (base URL, backend); shut down, closed and joined after."""
    import threading
    from mofa_tpu_torch.apps import ui_server
    server = ui_server.make_server(ui_server.build_parser().parse_args(
        argv + ["--host", "127.0.0.1", "--port", "0"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", server.backend
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        if thread.is_alive():
            fail("ui: the server thread did not stop")


def run_ui(dev, card: str, root: str) -> dict:
    """The UI server on the card, --device cuda --bf16, seeded random
    weights: the page, /preprocess and /preview on a 576x1024 image, /run
    (25 frames, 25 steps) with the launches held to the traj video's sites
    and its mp4 decoded; the frames held against `traj_app.generate` called
    directly (same image, tracks, seed; bit-equal, or PSNR_BF16_DB: the
    splat's atomics sum in a run-dependent order); a bad request's 500 and
    a good request after it; /run_landmarks in hybrid mode (576x1024) and
    keypoint mode (512^2, a 25-frame track), 5 steps each, launches held."""
    import urllib.error

    import numpy as np
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.apps import traj_app, ui_server
    from mofa_tpu_torch.apps.loaders import load_bundle, load_cmp
    from mofa_tpu_torch.pipelines.keypoint import window_views
    from mofa_tpu_torch.utils.profiling import PhaseTimer

    u, h, w, t, steps = UI, MAIN["h"], MAIN["w"], MAIN["t"], MAIN["steps"]
    j = lambda name: os.path.join(root, name)
    smooth_png(j("image.png"), h, w, u["seed"])
    tracks = seeded_tracks(h, w, u["seed"])
    base_argv = ["--device", "cuda", "--bf16", "--num_frames", str(t),
                 "--decode_chunk_size", str(MAIN["decode_chunk_size"])]
    seen = []

    def spy(*a, **kw):
        out = traj_app.generate(*a, **kw)
        seen.append(out[0])
        return out

    res: dict = {}
    ui_server.generate = spy
    try:
        with ui_server_thread(base_argv + ["--num_inference_steps", str(steps),
                                           "--target_size", str(h)]) as (base, backend):
            page = _http(base + "/").decode()
            if "canvas" not in page:
                fail("ui: GET / did not serve the page")
            pre, pre_s = timed(lambda: json.loads(_http(
                base + "/preprocess", {"image": _png_data_url(j("image.png")),
                                       "target_size": h})))
            if (pre["height"], pre["width"]) != (h, w):
                fail(f"ui: /preprocess gave {pre['height']}x{pre['width']}")
            prev, prev_s = timed(lambda: json.loads(_http(
                base + "/preview", {"image": pre["image"], "tracks": tracks})))
            for key in ("flow", "hint"):
                if ui_server.data_url_to_array(prev[key]).shape != (h, w, 3):
                    fail(f"ui: /preview {key} has the wrong shape")
            kernels.reset_launch_counts()
            _, run_s = timed(_http, base + "/run", {"image": pre["image"], "tracks": tracks})
            launches = kernels.launch_counts()
            with open(j("run.mp4"), "wb") as f:
                f.write(_http(base + "/video"))
            if launches != expected_launches("tmajor", steps):
                fail(f"ui: /run launches {launches}, expected "
                     f"{expected_launches('tmajor', steps)}")
            if video_frames(j("run.mp4")) != t or len(seen) != 1:
                fail(f"ui: /video holds {video_frames(j('run.mp4'))} frames, want {t}")
            try:
                _http(base + "/run", {"image": pre["image"], "tracks": []})
                fail("ui: a /run without tracks did not fail")
            except urllib.error.HTTPError as e:
                msg = e.read().decode()
                if e.code != 500 or "trajectory" not in msg:
                    fail(f"ui: a bad request gave {e.code} {msg!r}")
            again = json.loads(_http(base + "/preprocess",
                                     {"image": _png_data_url(j("image.png")),
                                      "target_size": h}))
            if again["image"] != pre["image"]:
                fail("ui: the request after the 500 differs")
            image01 = ui_server.data_url_to_array(pre["image"]).astype(np.float32) / 255.0
            backend._bundle = backend._cmp = None
            torch.cuda.empty_cache()
    finally:
        ui_server.generate = traj_app.generate
    ui_frames = seen[0]
    direct, direct_s = timed(lambda: traj_app.generate(
        image01, [[tuple(p) for p in tr] for tr in tracks],
        lambda: load_cmp(None, dev), lambda: load_bundle(None, None, dev, torch.bfloat16),
        timer=PhaseTimer(dev), num_frames=t, num_inference_steps=steps, seed=42)[0])
    same = bool(torch.equal(ui_frames, direct))
    db = psnr(ui_frames, direct)
    if not same and db < PSNR_BF16_DB:
        fail(f"ui: /run's frames are {db:.2f} dB from traj_app.generate's "
             f"(bar {PSNR_BF16_DB} dB)")
    log(f"  ui /preprocess {pre_s:.3f} s, /preview {prev_s:.3f} s, /run ({t} frames, {steps} "
        f"steps, {h}x{w}, bf16) {run_s:.3f} s (traj_app.generate directly {direct_s:.3f} s); "
        f"/run's frames vs the direct call: bit-equal {same}, PSNR {db:.2f} dB (bar "
        f"{PSNR_BF16_DB}); launches {launches}; the 500 and the request after it; card {card}")
    res.update(launches=launches, run_s=run_s, direct_s=direct_s, bit_equal=same, psnr=db)
    del direct, ui_frames
    seen.clear()
    torch.cuda.empty_cache()

    # /run_landmarks: hybrid at 576x1024, keypoint at 512^2, 5 steps each
    lm_steps, ks = u["landmark_steps"], u["keypoint_size"]
    smooth_png(j("face.png"), ks, ks, u["seed"] + 2)
    lm = seeded_landmarks(h, w, t, u["seed"])
    mask = elliptical_mask(h, w, lm[0].mean(0), (0.16 * w, 0.26 * h))
    mask_url = ui_server.array_to_data_url(np.repeat(mask[..., None] * 255, 3, -1))
    kp_views = window_views(t, 25, 12)
    jobs = {"hybrid": dict(body={"image": pre["image"], "landmarks": _npy_b64(lm),
                                 "mode": "hybrid", "tracks": tracks, "brush": mask_url,
                                 "target_size": h},
                           want=expected_launches("tmajor", lm_steps, adapters=2)),
            "keypoint": dict(body={"image": _png_data_url(j("face.png")),
                                   "landmarks": _npy_b64(seeded_landmarks(ks, ks, t,
                                                                          u["seed"] + 3)),
                                   "mode": "keypoint", "target_size": ks},
                             # the reference's view list repeats the last window:
                             # 2 views, 1 distinct warp at 25 frames
                             want=expected_launches("tmajor", lm_steps, size=(ks, ks),
                                                    views=len(kp_views),
                                                    warps=len(set(kp_views))))}
    with ui_server_thread(base_argv + ["--num_inference_steps", str(lm_steps)]) as (base, _):
        for mode, job in jobs.items():
            kernels.reset_launch_counts()
            _, secs = timed(_http, base + "/run_landmarks", job["body"])
            launches = kernels.launch_counts()
            with open(j(f"{mode}.mp4"), "wb") as f:
                f.write(_http(base + "/video"))
            n = video_frames(j(f"{mode}.mp4"))
            if launches != job["want"] or n != t:
                fail(f"ui: /run_landmarks {mode}: launches {launches} (want {job['want']}), "
                     f"{n} frames (want {t})")
            log(f"  ui /run_landmarks {mode} ({lm_steps} steps, {t} frames): {secs:.3f} s "
                f"through {mode}_app.run --device cuda; launches {launches}; card {card}")
            res[f"{mode}_s"] = secs
    torch.cuda.empty_cache()
    return res


def run_slice_ui(dev, card: str) -> dict:
    """Phase 5l: the native host library, PIRender, FILM and the UI server."""
    import tempfile

    import torch
    from mofa_tpu_torch import kernels

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    res = {"native": run_native(card)}
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        kernels.reset_launch_counts()
        res["pirender"] = run_pirender(dev, card, root)
        res["film"] = run_film(dev, card)
        if any(kernels.launch_counts().values()):
            fail(f"pirender / film launched custom kernels: {kernels.launch_counts()}")
        torch.cuda.empty_cache()
        res["ui"] = run_ui(dev, card, root)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return res


# ------------------------------------- phase 5m: frame-parallel inference

# The frame-parallel layer on the card (core/mesh.py, parallel/activation.py,
# the apps' --frame_parallel): one card, so NCCL at world size 1, where the
# all-to-alls, gathers and reductions are local copies. Each video runs
# once with the mesh and once directly in the classic temporal layout (the
# layout the frames policy implies), from the same seeds: the launches
# held to `expected_launches("classic", ...)` (no tmajor launch inside the
# context), the frames to PSNR_DB of the direct call's. The keypoint video
# is cut to 49 frames (4 views, 3 distinct) to keep the script's time.
MESH = dict(steps=25, landmark_steps=5, keypoint_t=49, keypoint_size=512,
            psnr_db=40.0, seed=61)
# the classic short kernel at the frame-parallel /8 site: B = 2 x 9216
# tokens over n ranks
MESH_SHORT_WORLDS = (1, 2, 4)


def frame_parallel_pair(label: str, run, want: dict, card: str) -> dict:
    """run(mesh, phase_times) -> frames, once directly in the classic
    layout and once with the mesh; the mesh run's launches counted and held
    to `want`, its frames against the direct run's."""
    import torch
    from mofa_tpu_torch import kernels
    out = {}
    for name, mesh in (("direct", None), ("frame_parallel", MESH["mesh"])):
        phases: dict = {}
        torch.cuda.reset_peak_memory_stats()
        with temporal_layout("classic" if mesh is None else "tmajor"):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            frames = run(mesh, phases)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = kernels.launch_counts()
        step_s = phases["denoise_step"]
        out[name] = dict(frames=frames, s=secs, launches=launches,
                         median_step=sorted(step_s)[len(step_s) // 2],
                         denoise=sum(step_s), decode=phases["decode"][0],
                         peak=torch.cuda.max_memory_allocated() / 2 ** 30)
    fp, direct = out["frame_parallel"], out["direct"]
    if fp["launches"] != want:
        fail(f"mesh {label}: launches {fp['launches']}, expected {want}")
    if not bool(torch.isfinite(fp["frames"]).all()):
        fail(f"mesh {label}: non-finite frames")
    same = bool(torch.equal(fp["frames"], direct["frames"]))
    db = psnr(fp["frames"], direct["frames"])
    if not same and db < MESH["psnr_db"]:
        fail(f"mesh {label}: frames {db:.2f} dB from the direct call's "
             f"(bar {MESH['psnr_db']} dB)")
    log(f"  mesh {label}: frame-parallel {fp['s']:.3f} s (median step "
        f"{fp['median_step']:.3f}, denoise {fp['denoise']:.3f}, decode "
        f"{fp['decode']:.3f}, peak {fp['peak']:.2f} GiB) vs direct classic "
        f"{direct['s']:.3f} s (median step {direct['median_step']:.3f}, denoise "
        f"{direct['denoise']:.3f}, decode {direct['decode']:.3f}, peak "
        f"{direct['peak']:.2f} GiB); overhead {100 * (fp['s'] / direct['s'] - 1):+.2f}%"
        f" (steps {100 * (fp['median_step'] / direct['median_step'] - 1):+.2f}%); "
        f"frames bit-equal {same}, PSNR {db:.2f} dB (bar {MESH['psnr_db']}); "
        f"launches {fp['launches']}; card {card}")
    res = {k: {kk: vv for kk, vv in v.items() if kk != "frames"} for k, v in out.items()}
    res.update(psnr=db, bit_equal=same)
    return res


def mesh_short_checks(kres: dict) -> None:
    """The classic short kernel at the frame-parallel /8 site [18432/n, 25,
    5, 64], bf16, for n in MESH_SHORT_WORLDS: against its plain version
    (row 5's TOL_BF16) and timed beside SDPA (keys *_mesh<n> of its row)."""
    import torch
    import torch.nn.functional as F
    from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                        short_attention_applicable)
    g = torch.Generator(device="cuda").manual_seed(MESH["seed"])
    for n in MESH_SHORT_WORLDS:
        b = 18432 // n
        if not short_attention_applicable(b, 25, 25, 5, 64):
            fail(f"mesh: the short gate refuses the /8 share at n = {n}")
        q, k, v = (torch.randn(b, 25, 5, 64, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        _check(kres, "short_attention", "bf16", f"B={b} L=25 H=5 D=64 (n={n})",
               lambda: short_attention(q, k, v), lambda: short_attention(q, k, v),
               True, ref32_fn=lambda: short_attention(*upcast(q, k, v)),
               library_fn=lambda: F.scaled_dot_product_attention(qh, kh, vh),
               work=(4 * b * 5 * 25 * 25 * 64, 4 * nbytes(q), "bf16"),
               suffix=f"_mesh{n}")
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()


def run_mesh(dev, card: str, kres: dict) -> dict:
    """Phase 5m: init_distributed on the card with no launcher (NCCL, a
    world of one), the (1, 1, 1, 1) DeviceMesh; the traj video (MAIN),
    the hybrid video (MAIN's size, 5 steps) and the keypoint video (512^2,
    49 frames, 5 steps), each through its app's `generate` with the mesh
    and directly (`frame_parallel_pair`); the classic short kernel at the
    frame-parallel shapes (`mesh_short_checks`)."""
    import torch
    import torch.distributed as dist
    from mofa_tpu_torch.apps import hybrid_app, keypoint_app
    from mofa_tpu_torch.apps.loaders import load_bundle, load_cmp, start_frame_parallel
    from mofa_tpu_torch.pipelines.keypoint import window_views
    from mofa_tpu_torch.utils.profiling import PhaseTimer

    dev, mesh = start_frame_parallel(dev)
    MESH["mesh"] = mesh
    log(f"  process group: backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}, rank {dist.get_rank()}, device {dev}; {mesh}")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail("mesh: expected NCCL at world size 1 with no launcher")
    res: dict = {}
    try:
        h, w, t, seed = MAIN["h"], MAIN["w"], MAIN["t"], MESH["seed"]
        bundle = random_bundle(dev, seed, torch.bfloat16)
        res["traj"] = frame_parallel_pair(
            "traj", lambda m, pt: drag_video(bundle, dev, h, w, t, MESH["steps"], seed,
                                             phase_times=pt, mesh=m)[0],
            expected_launches("classic", MESH["steps"]), card)
        del bundle
        torch.cuda.empty_cache()

        steps = MESH["landmark_steps"]
        img, _ = smooth_inputs(1, 2, h, w, dev, seed=seed)
        lm = seeded_landmarks(h, w, t, seed)
        mask = elliptical_mask(h, w, lm[0].mean(0), (0.16 * w, 0.26 * h))
        hb = load_bundle(None, None, dev, torch.bfloat16, seed=seed,
                         controlnet2_dir="", ldmk=True)
        res["hybrid"] = frame_parallel_pair(
            "hybrid", lambda m, pt: hybrid_app.generate(
                img[0], lm, seeded_tracks(h, w, seed), mask,
                lambda: load_cmp(None, dev, seed=seed), lambda: hb,
                timer=PhaseTimer(dev), num_inference_steps=steps,
                decode_chunk_size=MAIN["decode_chunk_size"], seed=seed + 1,
                phase_times=pt, mesh=m)[0],
            expected_launches("classic", steps, adapters=2), card)
        del hb
        torch.cuda.empty_cache()

        ks, kt = MESH["keypoint_size"], MESH["keypoint_t"]
        kimg, _ = smooth_inputs(1, 2, ks, ks, dev, seed=seed + 2)
        klm = seeded_landmarks(ks, ks, kt, seed + 2)
        views = window_views(kt, KEYPOINT["window"], KEYPOINT["stride"])
        kb = load_bundle(None, None, dev, torch.bfloat16, seed=seed, ldmk=True)
        res["keypoint"] = frame_parallel_pair(
            "keypoint", lambda m, pt: keypoint_app.generate(
                kimg[0], klm, lambda: load_cmp(None, dev, seed=seed), lambda: kb,
                timer=PhaseTimer(dev), window_size=KEYPOINT["window"],
                stride=KEYPOINT["stride"], num_inference_steps=steps,
                decode_chunk_size=KEYPOINT["decode_chunk_size"], seed=seed + 3,
                phase_times=pt, mesh=m)[0],
            expected_launches("classic", steps, size=(ks, ks), views=len(views),
                              warps=len(set(views))), card)
        del kb
        torch.cuda.empty_cache()
        log("  the classic short kernel at the frame-parallel /8 site, bf16")
        mesh_short_checks(kres)
        if not kres["short_attention"]["ok"]:
            fail("mesh: the classic short kernel misses its bound at a "
                 "frame-parallel shape")
    finally:
        MESH.pop("mesh", None)
        dist.destroy_process_group()
    return res


# ------------------------------------------------ phase 5g: training

# Stage-1 training through train_app at SVD-XT widths: the train_stage1.sh
# operating point (384x384, 25 frames, batch 1, fp32, block remat, EMA)
# on seeded 40-frame clips (stride 1: 25 of them fit), 4 steps, a
# checkpoint at step 2, a validation render at step 4.
TRAIN = dict(size=384, frames=25, steps=4, videos=3, video_frames=40)
# |loss difference| / loss of a run resumed from step 2 against the
# uninterrupted run, steps 3 and 4: both fp32 on the same draws; the
# splat's atomics sum in another order each run (first readings 9.1e-7
# and 1.4e-6; PERF.md).
RESUME_REL = 2e-5
# the step through the kernels against the step inside plain_reference():
# |loss diff| / loss and the adapter gradient's relative RMS (fp32 both;
# cuDNN's TF32 convolutions on both sides; first readings 6.9e-7 and
# 3.7e-5)
TRAIN_PLAIN_REL = (1e-5, 5e-4)


def expected_train_launches(steps: int, remat: bool, size: tuple = (384, 384),
                            layout: str = "tmajor") -> dict:
    """Launches of `steps` stage-1 training steps at SVD-XT widths (B=1,
    T=25, one adapter) in a temporal layout: the forward sites of
    `expected_launches` for one denoiser call without CFG (flash 7 at each
    level the gate admits, tmajor 23 or classic short attention 7, the FFN
    42, softsplat 4) plus, with block remat, the recompute of the blocks
    whose outputs need a gradient: all of the trunk's (flash 2 a level,
    tmajor 7 or short 2, FFN 12) and the UNet's up blocks (flash 3 a level,
    tmajor 9 or short 3, FFN 18: the C=320 and 640 up levels, 3
    transformers each; short attention only at C=320). The UNet's down and
    mid blocks read nothing that needs a gradient and are not recomputed;
    the backward functions launch nothing."""
    want = expected_launches(layout, steps, size=size, warps=steps)
    if remat:
        levels = flash_levels(*size)
        want["flash_attention"] += (2 + 3) * levels * steps
        if layout == "tmajor":
            want["short_attention_tmajor"] += (7 + 9) * steps
        else:
            want["short_attention"] += (2 + 3) * steps
        want["ln_geglu_ffn"] += (12 + 18) * steps
    return want


def write_clips(root: str, seed: int) -> tuple:
    """TRAIN['videos'] seeded mp4s (cv2.VideoWriter) of TRAIN['video_frames']
    frames at TRAIN['size']^2: smooth random blobs drifting, so the teacher
    sees motion; and their WebVid-style CSV. Returns (csv, folder)."""
    import cv2
    import numpy as np
    rng = np.random.RandomState(seed)
    n = TRAIN["size"]
    folder = os.path.join(root, "videos")
    os.makedirs(folder, exist_ok=True)
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    with open(os.path.join(root, "clips.csv"), "w") as f:
        f.write("videoid,page_dir,name\n")
        for i in range(TRAIN["videos"]):
            centres = rng.rand(6, 2) * n
            vel = rng.randn(6, 2) * 2.0
            colours = rng.rand(6, 3) * 255
            vw = cv2.VideoWriter(os.path.join(folder, f"clip{i}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 8, (n, n))
            for t in range(TRAIN["video_frames"]):
                img = np.zeros((n, n, 3), np.float32) + 40
                for (cy, cx), (vy, vx), col in zip(centres, vel, colours):
                    d2 = (yy - cy - vy * t) ** 2 + (xx - cx - vx * t) ** 2
                    img += np.exp(-d2 / (2 * 40.0 ** 2))[..., None] * col
                vw.write(np.clip(img, 0, 255).astype(np.uint8))
            vw.release()
            f.write(f"clip{i},,seeded clip {i}\n")
    return os.path.join(root, "clips.csv"), folder


def train_args(csv_path, folder, out, steps, *extra):
    from mofa_tpu_torch.apps import train_app
    return train_app.build_parser().parse_args(
        ["--csv_path", csv_path, "--video_folder", folder, "--output_dir", out,
         "--sample_size", str(TRAIN["size"]), "--sample_n_frames", str(TRAIN["frames"]),
         "--sample_stride", "1", "--num_train_steps", str(steps),
         "--checkpointing_steps", "2", "--validation_steps", "1000", "--use_ema",
         "--seed", "7", *extra])


def train_without_export(args):
    """`train_app.run(args)` without its final export: the Trainer after
    its steps (the export, 2.8 GB of adapter, is checked on the first run
    only; the machine's disk counts every byte written)."""
    from mofa_tpu_torch.apps import train_app
    trainer = train_app.Trainer(args)
    trainer.train()
    return trainer


def check_train_steps(label: str, records: list, remat: bool,
                      layout: str = "tmajor") -> None:
    import math
    want = expected_train_launches(1, remat, layout=layout)
    want = {k: v for k, v in want.items() if v}
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0):
            fail(f"{label}: step {r['step']} loss {r['loss']} grad norm {r['grad_norm']}")
        if r["launches"] != want:
            fail(f"{label}: step {r['step']} launched {r['launches']}, expected {want}")


def phase_train(dev) -> dict:
    """5g: stage-1 training through `train_app.run` (module note above).
    Returns the kernels' launches over the whole first run."""
    import shutil
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.apps import train_app
    from mofa_tpu_torch.apps.loaders import load_bundle
    from mofa_tpu_torch.models.mofa_adapter import FlowControlNet
    from mofa_tpu_torch.train import checkpoint as ckpt_mod
    from mofa_tpu_torch.train.data import ResumableBatches, WebVidDataset
    from mofa_tpu_torch.train.stage import draw, edm_loss
    from mofa_tpu_torch.train.state import TrainState

    root = os.path.join(REPO, "build", "train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    csv_path, folder = write_clips(root, seed=11)
    log(f"[train] {TRAIN['videos']} seeded {TRAIN['video_frames']}-frame clips at "
        f"{TRAIN['size']}^2; TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cuDNN {torch.backends.cudnn.allow_tf32}")

    # the uninterrupted run: 4 steps, a checkpoint at 2 and 4, a render at 4
    out_a = os.path.join(root, "a")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_app.run(train_args(csv_path, folder, out_a, TRAIN["steps"],
                                       "--gradient_checkpointing",
                                       "--validation_steps", str(TRAIN["steps"])))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    total = time.perf_counter() - t0
    n_params = sum(p.numel() for p in trainer.state.params)
    log(f"[train] 4 steps, checkpoint, render and export in {total:.1f} s; adapter "
        f"{n_params} trainable parameters; launches {launches}")
    check_train_steps("train", trainer.records, remat=True)
    want = expected_train_launches(TRAIN["steps"], remat=True)
    for k, v in expected_launches("tmajor", 4, size=(TRAIN["size"],) * 2).items():
        want[k] += v                     # the validation render: 4 CFG steps
    if launches != want:
        fail(f"train: launches {launches}, expected {want} (steps and the render)")
    after = trainer.digests()
    for name, d in trainer.digests_at_setup.items():
        moved = after[name] != d
        if moved != (name == "controlnet"):
            fail(f"train: the {name} {'changed' if moved else 'did not change'}")
    log("[train] UNet, VAE and CLIP bit-unchanged; the adapter moved")
    if not os.path.exists(os.path.join(out_a, f"val_{TRAIN['steps']}.mp4")):
        fail("train: no validation render")

    # the exported adapter (EMA) through load_bundle, bit-equal
    export = os.path.join(out_a, "adapter_final")
    parts = trainer.bundle
    loaded = load_bundle(None, export, device=dev, dtype=torch.float32, seed=1,
                         unet_cfg=parts.unet.cfg, vae_cfg=parts.vae.cfg,
                         clip_cfg=parts.clip.cfg)
    del parts
    want_sd = trainer.state.export_state_dict()
    got_sd = loaded.controlnet.state_dict()
    if got_sd.keys() != want_sd.keys() or any(
            not torch.equal(got_sd[k], want_sd[k].to(dev)) for k in want_sd):
        fail("train: the exported adapter does not load bit-equal")
    log(f"[train] exported adapter ({len(want_sd)} tensors) loads strictly and "
        "bit-equal through load_bundle")
    del loaded, got_sd, want_sd

    # a restore of step 2 into a fresh state: the saved state bit for bit
    mgr = ckpt_mod.CheckpointManager(os.path.join(out_a, "checkpoints"))
    saved = torch.load(mgr.path(2), map_location="cpu", weights_only=True)
    with torch.device(dev):
        fresh = TrainState(FlowControlNet(trainer.state.model.cfg), ema=True)
    extra = mgr.restore(fresh, 2)
    again = fresh.state_dict()
    same = (again["step"] == saved["state"]["step"] == 2
            and all(torch.equal(again["params"][k].cpu(), v)
                    for k, v in saved["state"]["params"].items())
            and all(torch.equal(a.cpu(), b) for a, b in zip(again["ema"],
                                                             saved["state"]["ema"]))
            and torch.equal(extra["generator"], saved["extra"]["generator"]))
    opt_a, opt_b = again["optimizer"]["state"], saved["state"]["optimizer"]["state"]
    same = same and all(torch.equal(opt_a[i][k].cpu(), opt_b[i][k])
                        for i in opt_b for k in opt_b[i])
    if not same:
        fail("train: restoring step 2 does not give the saved state bit-equal")
    del fresh, again, saved
    log("[train] restore of step 2: parameters, AdamW moments and steps, EMA, "
        "step and generator state bit-equal")

    # the step through the kernels against the plain route, same draws
    b = next(iter(ResumableBatches(
        WebVidDataset(csv_path, folder, sample_size=TRAIN["size"], sample_stride=1,
                      sample_n_frames=TRAIN["frames"], seed=7), 1, 1, 7)))
    px = torch.from_numpy(b["pixel_values01"]).to(dev)
    batch = {"pixel_values01": px, "flows": trainer.teacher(px)}
    draws = draw(torch.Generator(device=dev).manual_seed(3), trainer.bundle,
                 *px.shape[:4])
    cn = trainer.state.model

    def loss_and_grads():
        cn.zero_grad(set_to_none=True)
        loss, _ = edm_loss(cn, trainer.bundle, batch, draws, 0.1)
        loss.backward()
        return float(loss.detach()), torch.cat([p.grad.reshape(-1) for p in trainer.state.params
                                       if p.grad is not None])

    kernels.reset_launch_counts()
    l_k, g_k = loss_and_grads()
    step_launches = {k: v for k, v in kernels.launch_counts().items() if v}
    with kernels.plain_reference():
        l_p, g_p = loss_and_grads()
    cn.zero_grad(set_to_none=True)
    rel_l = abs(l_k - l_p) / abs(l_p)
    rel_g = ((g_k - g_p).norm() / g_p.norm()).item()
    log(f"[train] one step through the kernels vs plain_reference(): loss "
        f"{l_k:.6f} vs {l_p:.6f} (rel {rel_l:.3e}), adapter gradient rel rms "
        f"{rel_g:.3e} (bounds {TRAIN_PLAIN_REL}); launches {step_launches}")
    if rel_l > TRAIN_PLAIN_REL[0] or rel_g > TRAIN_PLAIN_REL[1]:
        fail("train: the kernel step departs from the plain step")
    # the same step in the classic temporal layout (MOFA_TMAJOR=0): short
    # attention under autograd at its sites, against plain_reference()
    with temporal_layout("classic"):
        kernels.reset_launch_counts()
        l_k, g_k = loss_and_grads()
        step_launches = {k: v for k, v in kernels.launch_counts().items() if v}
        with kernels.plain_reference():
            l_p, g_p = loss_and_grads()
    cn.zero_grad(set_to_none=True)
    rel_l = abs(l_k - l_p) / abs(l_p)
    rel_g = ((g_k - g_p).norm() / g_p.norm()).item()
    want = {k: v for k, v in expected_train_launches(1, True, layout="classic").items()
            if v}
    log(f"[train] classic layout, one step through the kernels vs plain_reference(): "
        f"loss {l_k:.6f} vs {l_p:.6f} (rel {rel_l:.3e}), adapter gradient rel rms "
        f"{rel_g:.3e} (bounds {TRAIN_PLAIN_REL}); launches {step_launches}")
    if rel_l > TRAIN_PLAIN_REL[0] or rel_g > TRAIN_PLAIN_REL[1]:
        fail("train: the classic-layout kernel step departs from the plain step")
    if step_launches != want:
        fail(f"train: the classic-layout step launched {step_launches}, expected {want}")
    first_losses = {r["step"]: r["loss"] for r in trainer.records}
    del trainer, cn, g_k, g_p, batch, draws
    torch.cuda.empty_cache()

    # resumed from step 2: steps 3 and 4 as the uninterrupted run's
    def resumed(tag: str, steps: int):
        out = os.path.join(root, tag)
        os.makedirs(os.path.join(out, "checkpoints"))
        # a hard link: the machine's disk counts every byte written, and a
        # checkpoint of the adapter with its AdamW moments and EMA is 11 GB
        os.link(mgr.path(2), os.path.join(out, "checkpoints", "checkpoint-2.pt"))
        return train_without_export(train_args(
            csv_path, folder, out, steps, "--gradient_checkpointing",
            "--checkpointing_steps", "1000", "--resume_from_checkpoint", "2"))

    run_b = resumed("b", TRAIN["steps"])
    check_train_steps("resumed", run_b.records, remat=True)
    diffs = {r["step"]: abs(r["loss"] - first_losses[r["step"]]) / abs(first_losses[r["step"]])
             for r in run_b.records}
    log(f"[train] resumed from step 2: losses "
        f"{[round(r['loss'], 6) for r in run_b.records]} vs "
        f"{[round(first_losses[s], 6) for s in (3, 4)]}, rel diff {diffs} "
        f"(bound {RESUME_REL})")
    if sorted(diffs) != [3, 4] or max(diffs.values()) > RESUME_REL:
        fail("train: the resumed run departs from the uninterrupted one")
    del run_b
    torch.cuda.empty_cache()

    # planted fault: the generator state not restored (a fresh one instead)
    restore = ckpt_mod.CheckpointManager.restore

    def restore_without_generator(self, state, step=None):
        extra = restore(self, state, step)
        extra["generator"] = torch.Generator(device=dev).manual_seed(999).get_state()
        return extra

    ckpt_mod.CheckpointManager.restore = restore_without_generator
    try:
        run_c = resumed("c", 3)
    finally:
        ckpt_mod.CheckpointManager.restore = restore
    fault = abs(run_c.records[0]["loss"] - first_losses[3]) / abs(first_losses[3])
    log(f"[train] planted fault, generator not restored: step-3 loss rel diff "
        f"{fault:.3e} {'CAUGHT' if fault > RESUME_REL else 'LOOSE'}")
    if fault <= RESUME_REL:
        fail("train: the resume bound lets an unrestored generator pass")
    del run_c
    torch.cuda.empty_cache()

    # one step without block remat: its peak
    out_d = os.path.join(root, "d")
    run_d = train_without_export(train_args(csv_path, folder, out_d, 1,
                                            "--checkpointing_steps", "1000"))
    check_train_steps("no remat", run_d.records, remat=False)
    r = run_d.records[0]
    log(f"[train] one step without remat: loss {r['loss']:.6f}, fwd+bwd "
        f"{r['fwd_bwd_s']:.3f} s, peak {r['peak_gib']:.2f} GiB")
    del run_d
    torch.cuda.empty_cache()

    # one step through train_app in the classic temporal layout, with remat
    with temporal_layout("classic"):
        run_e = train_without_export(train_args(csv_path, folder, os.path.join(root, "e"),
                                                1, "--gradient_checkpointing",
                                                "--checkpointing_steps", "1000"))
    check_train_steps("classic", run_e.records, remat=True, layout="classic")
    r = run_e.records[0]
    classic_launches = r["launches"]
    log(f"[train] one step in the classic layout (MOFA_TMAJOR=0), remat: loss "
        f"{r['loss']:.6f}, fwd+bwd {r['fwd_bwd_s']:.3f} s, peak {r['peak_gib']:.2f} "
        f"GiB, launches {classic_launches}")
    del run_e
    torch.cuda.empty_cache()
    # stage 2 (phase 5h) starts from the exported adapter on the same clips
    for tag in ("b", "c", "d", "e"):
        shutil.rmtree(os.path.join(root, tag), ignore_errors=True)
    shutil.rmtree(os.path.join(out_a, "checkpoints"), ignore_errors=True)
    return launches, dict(root=root, csv=csv_path, folder=folder, adapter=export,
                          classic_launches=classic_launches)


# ------------------------------------------------ phase 5h: stage 2

# Stage 2 through train_app from phase 5g's exported adapter, at the same
# operating point (384^2, 25 frames, batch 1, fp32, remat, EMA) and clips,
# with a CMP of seeded random weights read from a file: run A sequential
# with AdamW, run B with --overlap_inputs --use_8bit_adam, 2 steps each.
# Step 1 draws the same clip, masks and noise in both and the optimizer
# has not acted yet, so B's control flow equals A's (CONTROL_REL) and its
# loss, and step 1's loss recomputed outside the trainer from the same
# inputs, equal A's within STAGE2_RUNS_REL.
STAGE2_STEPS = 2
# |loss difference| / loss of two fp32 runs of stage 2's step 1: the
# splat's atomics and cuDNN's TF32 convolutions sum in another order each
# run, about 2.4e-6 absolute as in 5g's resume (1.8-2.0e-6 there), which at
# this loss of 0.239 is 1e-5 relative (readings 9.2e-6 and 1.02e-5 A vs B,
# 1.4e-6 and 4.8e-6 recomputed; PERF.md); a generator not restored moves a
# loss by 2.2e-2
STAGE2_RUNS_REL = 5e-5
# the control flow's sum and sum of squares of two computations of step 1's
# batch (the same clip and masks; CMP's fp32 convs rerun): relative bound
CONTROL_REL = 1e-5


def control_rel(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def mask_from_first_frame(flows, rng=None):
    """A planted fault for phase 5h: clip_sample_mask sampling each clip's
    FIRST frame flow instead of its last."""
    import numpy as np
    from mofa_tpu_torch.train.flow_sampler import flow_sampler
    b, t = flows.shape[:2]
    masks = [flow_sampler(flows[i, 0], ("grid", "watershed"), rng=rng)[1] for i in range(b)]
    return np.repeat(np.stack(masks).astype(flows.dtype)[:, None], t, axis=1)


def phase_stage2(dev, train: dict) -> dict:
    """5h (module note above). Returns run A's launches over its steps."""
    import gc
    import shutil
    import numpy as np
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.apps import train_app
    from mofa_tpu_torch.apps.loaders import init_random_cmp_
    from mofa_tpu_torch.models.cmp.model import CMP, CMPConfig
    from mofa_tpu_torch.train import inputs as inputs_mod
    from mofa_tpu_torch.train.checkpoint import import_adapter
    from mofa_tpu_torch.train.data import ResumableBatches, WebVidDataset
    from mofa_tpu_torch.train.stage import draw, edm_loss
    from mofa_tpu_torch.train.state import optimizer_state_bytes

    root = train["root"]
    cmp_path = os.path.join(root, "cmp_seeded.pth.tar")
    cmp = init_random_cmp_(CMP(CMPConfig()), torch.Generator().manual_seed(21))
    torch.save({"step": 0, "state_dict": cmp.state_dict()}, cmp_path)
    del cmp

    def stage2_args(tag, *extra):
        return train_args(train["csv"], train["folder"], os.path.join(root, tag),
                          STAGE2_STEPS, "--stage", "2", "--controlnet_resume",
                          train["adapter"], "--cmp_ckpt", cmp_path,
                          "--gradient_checkpointing", "--checkpointing_steps", "1000",
                          *extra)

    def frozen_digests(trainer):
        cn = trainer.bundle.controlnet
        return {n: train_app.module_digest(getattr(cn, n))
                for n in ("flow_encoder", "controlnet_cond_embedding")}

    runs = {}
    for tag, extra in (("A", ()), ("B", ("--overlap_inputs", "--use_8bit_adam"))):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = train_app.Trainer(stage2_args(tag, *extra))
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        before = frozen_digests(trainer)
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = kernels.launch_counts()
        check_train_steps(f"stage 2 {tag}", trainer.records, remat=True)
        if frozen_digests(trainer) != before:
            fail(f"stage 2 {tag}: the frozen flow encoder or conditioning embedding moved")
        if trainer.digests()["controlnet"] == trainer.digests_at_setup["controlnet"]:
            fail(f"stage 2 {tag}: the adapter did not move")
        opt_bytes = optimizer_state_bytes(trainer.state.optimizer)
        runs[tag] = dict(records=trainer.records, launches=launches, total=total,
                         opt_bytes=opt_bytes, setup=setup)
        log(f"[stage2] run {tag} {' '.join(extra) or '(sequential, AdamW)'}: setup "
            f"{setup:.1f} s, {STAGE2_STEPS} steps in {total:.1f} s; optimizer state "
            f"{opt_bytes} bytes; flow_encoder and controlnet_cond_embedding "
            "bit-unchanged; launches each step as their sites")
        for r in trainer.records:
            log(f"[stage2] {tag} step {r['step']}: " + json.dumps(
                {k: r.get(k) for k in ("loss", "grad_norm", "batch_s", "teacher_s",
                                       "mask_s", "cmp_s", "fwd_bwd_s", "optimizer_s",
                                       "wall_s", "peak_gib")}))
        if tag == "A":
            del trainer                  # B's peak must not count A's state
            gc.collect()
        torch.cuda.empty_cache()
    keep = trainer

    la, lb = runs["A"]["records"][0]["loss"], runs["B"]["records"][0]["loss"]
    rel = abs(la - lb) / abs(la)
    ca = runs["A"]["records"][0]["control_sums"]
    rel_c = control_rel(runs["B"]["records"][0]["control_sums"], ca)
    log(f"[stage2] step 1 loss A {la:.6f} B {lb:.6f}: rel {rel:.3e} (bound "
        f"{STAGE2_RUNS_REL}); control flow sums rel {rel_c:.3e} (bound {CONTROL_REL})")
    if rel > STAGE2_RUNS_REL or rel_c > CONTROL_REL:
        fail("stage 2: the overlapped run's first step departs from the sequential one")
    wall = {t: [round(r["wall_s"], 3) for r in runs[t]["records"]] for t in runs}
    log(f"[stage2] wall a step: B {wall['B']} s beside A {wall['A']} s; optimizer state "
        f"AdamW {runs['A']['opt_bytes']} B, factored {runs['B']['opt_bytes']} B; peak "
        f"A {[r['peak_gib'] for r in runs['A']['records']]} GiB, B "
        f"{[r['peak_gib'] for r in runs['B']['records']]} GiB")

    # step 1's loss again, outside the trainer (B's parts), from the exported
    # adapter on the same clip, masks and draws; then with the masks drawn
    # from each clip's first frame (a planted fault), which must miss the bound
    cn, bundle, args = keep.state.model, keep.bundle, keep.args
    import_adapter(cn, train["adapter"])
    b = next(iter(ResumableBatches(
        WebVidDataset(train["csv"], train["folder"], sample_size=TRAIN["size"],
                      sample_stride=1, sample_n_frames=TRAIN["frames"], seed=args.seed),
        1, STAGE2_STEPS, args.seed)))
    px = torch.from_numpy(b["pixel_values01"]).to(dev)
    flows = keep.teacher(px).cpu().numpy()
    draws = draw(torch.Generator(device=dev).manual_seed(args.seed), bundle, *px.shape[:4])
    cn.remat_blocks = bundle.unet.remat_blocks = False

    def loss_with(sampler):
        """(loss, control flow sums) of step 1's batch with `sampler` as
        clip_sample_mask."""
        real = inputs_mod.clip_sample_mask
        inputs_mod.clip_sample_mask = sampler
        try:
            batch = inputs_mod.make_stage2_batch(keep.cmp, px, flows,
                                                 rng=np.random.RandomState(args.seed))
            with torch.no_grad():
                loss, _ = edm_loss(cn, bundle, batch, draws, args.conditioning_dropout_prob)
            f64 = batch["flows"].double()
            return float(loss), (float(f64.sum()), float((f64 * f64).sum()))
        finally:
            inputs_mod.clip_sample_mask = real

    again, c_again = loss_with(inputs_mod.clip_sample_mask)
    planted, c_planted = loss_with(mask_from_first_frame)
    rel_again, rel_fault = abs(again - la) / abs(la), abs(planted - la) / abs(la)
    rc_again, rc_fault = control_rel(c_again, ca), control_rel(c_planted, ca)
    log(f"[stage2] step 1 recomputed: loss {again:.6f} (rel {rel_again:.3e}), control "
        f"sums rel {rc_again:.3e}; masks from the first frame (planted fault): loss "
        f"{planted:.6f} (rel {rel_fault:.3e}), control sums rel {rc_fault:.3e} "
        f"{'CAUGHT' if rc_fault > CONTROL_REL else 'LOOSE'}")
    if rel_again > STAGE2_RUNS_REL or rc_again > CONTROL_REL:
        fail("stage 2: step 1's loss and control flow do not recompute from its inputs")
    if rc_fault <= CONTROL_REL:
        fail("stage 2: the control-flow bound lets masks from the first frame pass")
    del keep, cn, bundle, draws
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return {"A": runs["A"]["launches"], "B": runs["B"]["launches"]}


# ------------------------------------- phase 5i: the CMP and GMFlow trainers

# train_cmp_app on the shipped CMP config (read from a config.yaml the
# script writes: the card has no PyYAML) at crop 384, batch 8; train_flow_app
# on the teacher's config at 384x512, batch 8 (halved while it does not
# fit); eval_flow_app on the flow checkpoint; 3 steps each, on seeded
# (image, flow) pairs in the triples layout.
FLOW_TRAIN = dict(pairs=8, h=384, w=512, steps=3, batch=8)
# the CMP trainer's learning rate here: the config's 0.1 from a random
# init, without its BatchNorm statistics' warm start, may push a trained
# variance below -eps within 3 steps (ROADMAP Queue 3 item 9)
CMP_SMOKE_LR = 0.01
SHIPPED_CMP_YAML = """\
model:
    arch: CMP
    total_iter: 42000
    lr_steps: [24000, 36000]
    lr_mults: [0.1, 0.1]
    lr: 0.1
    optim: SGD
    warmup_lr: []
    warmup_steps: []
    module:
        arch: CMP
        image_encoder: resnet50
        sparse_encoder: shallownet8x
        flow_decoder: MotionDecoderSkipLayer
        skip_layer: True
        img_enc_dim: 256
        sparse_enc_dim: 16
        output_dim: 198
        decoder_combo: [1, 2, 4]
        pretrained_image_encoder: False
        flow_criterion: "DiscreteLoss"
        nbins: 99
        fmax: 50
data:
    data_mean: [123.675, 116.28, 103.53] # RGB
    data_div: [58.395, 57.12, 57.375]
    crop_size: [384, 384]
    sample_strategy: ['grid', 'watershed']
    train_source:
        - data/train.txt
"""


def write_flow_pairs(root: str, seed: int) -> str:
    """FLOW_TRAIN['pairs'] seeded (img1, img2, flow) triples: smooth blobs,
    the second image the first moved by a smooth flow field (cv2 PNGs and
    Middlebury .flo). Returns the data directory."""
    import cv2
    import numpy as np
    from mofa_tpu_torch.ops.flow_viz import write_flo
    rng = np.random.RandomState(seed)
    h, w = FLOW_TRAIN["h"], FLOW_TRAIN["w"]
    data = os.path.join(root, "pairs")
    os.makedirs(data, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(FLOW_TRAIN["pairs"]):
        img = np.zeros((h, w, 3), np.float32) + 30
        for _ in range(8):
            cy, cx = rng.rand(2) * (h, w)
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 30.0 ** 2))[..., None] \
                * rng.rand(3) * 220
        fx = 6 * np.sin(yy / 40.0 + rng.rand() * 6) + rng.randn() * 3
        fy = 4 * np.cos(xx / 50.0 + rng.rand() * 6) + rng.randn() * 3
        flow = np.stack([fx, fy], -1).astype(np.float32)
        moved = cv2.remap(img, xx - fx, yy - fy, cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT)
        cv2.imwrite(os.path.join(data, f"p{i}_img1.png"), np.clip(img, 0, 255).astype(np.uint8))
        cv2.imwrite(os.path.join(data, f"p{i}_img2.png"), np.clip(moved, 0, 255).astype(np.uint8))
        write_flo(flow, os.path.join(data, f"p{i}_flow.flo"))
    return data


def phase_flow_trainers(dev) -> None:
    """5i (module note above)."""
    import math
    import shutil
    import torch
    from mofa_tpu_torch.apps import eval_flow_app, train_cmp_app, train_flow_app
    from mofa_tpu_torch.apps.loaders import cmp_state_dict, load_cmp
    from mofa_tpu_torch.models.gmflow.model import GMFlow, GMFlowConfig, load_gmflow
    from mofa_tpu_torch.models.weights import load_torch_checkpoint

    root = os.path.join(REPO, "build", "flow_train_smoke")
    shutil.rmtree(root, ignore_errors=True)
    data = write_flow_pairs(root, seed=31)
    config = os.path.join(root, "config.yaml")
    with open(config, "w") as f:
        f.write(SHIPPED_CMP_YAML)

    # the CMP trainer
    steps = FLOW_TRAIN["steps"]
    t0 = time.perf_counter()
    res = train_cmp_app.run(train_cmp_app.build_parser().parse_args(
        ["--data_dir", data, "--output_dir", os.path.join(root, "cmp"), "--config", config,
         "--lr", str(CMP_SMOKE_LR),
         "--crop_size", "384", "--batch_size", "8", "--num_steps", str(steps),
         "--save_every", str(steps), "--log_every", "1", "--seed", "5"]))
    total = time.perf_counter() - t0
    log(f"[cmp_train] {res.cfg}; {steps} steps in {total:.1f} s: " + json.dumps(
        [{k: r[k] for k in ("step", "loss", "batch_s", "step_s", "peak_gib")}
         for r in res.records]))
    if not all(math.isfinite(r["loss"]) for r in res.records):
        fail("cmp_train: a loss is not finite")
    ckpt = res.checkpoints[-1]
    loaded = load_cmp(ckpt, dev, cfg=res.cfg)          # strict
    want = res.model.state_dict()
    got = {k: v for k, v in loaded.state_dict().items() if not k.endswith("num_batches_tracked")}
    if got.keys() != want.keys() or any(not torch.equal(got[k], want[k]) for k in want):
        fail("cmp_train: the checkpoint does not reload bit-equal through load_cmp")
    raw = cmp_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    raw.pop("flow_decoder.head.bias")
    try:
        loaded.load_state_dict(raw, strict=True)
        fail("cmp_train: a checkpoint without flow_decoder.head.bias loaded strictly")
    except RuntimeError:
        log(f"[cmp_train] checkpoint ({len(want)} tensors) reloads bit-equal through "
            "load_cmp(strict=True); one without flow_decoder.head.bias is refused: CAUGHT")
    del res, loaded, want, got
    torch.cuda.empty_cache()

    # the GMFlow trainer: batch 8, halved while it does not fit
    batch = FLOW_TRAIN["batch"]
    while True:
        try:
            t0 = time.perf_counter()
            fres = train_flow_app.run(train_flow_app.build_parser().parse_args(
                ["--data_dir", data, "--output_dir", os.path.join(root, "flow"),
                 "--batch_size", str(batch), "--num_steps", str(steps),
                 "--image_height", str(FLOW_TRAIN["h"]), "--image_width", str(FLOW_TRAIN["w"]),
                 "--save_every", str(steps), "--log_every", "1"]))
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            if batch == 1:
                fail("flow_train: batch 1 does not fit")
            log(f"[flow_train] batch {batch} does not fit the card; halving")
            batch //= 2
    total = time.perf_counter() - t0
    log(f"[flow_train] batch {batch}, {FLOW_TRAIN['h']}x{FLOW_TRAIN['w']}, {steps} steps in "
        f"{total:.1f} s: " + json.dumps(
            [{k: r[k] for k in ("step", "loss", "epe", "batch_s", "step_s", "peak_gib")}
             for r in fres.records]))
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["epe"]) for r in fres.records):
        fail("flow_train: a loss or EPE is not finite")
    with torch.device(dev):
        again = load_gmflow(GMFlow(GMFlowConfig()),
                            load_torch_checkpoint(fres.checkpoints[-1]))
    want = fres.model.state_dict()
    if any(not torch.equal(v, want[k]) for k, v in again.state_dict().items()):
        fail("flow_train: the checkpoint does not reload bit-equal")
    log("[flow_train] checkpoint reloads bit-equal through load_gmflow (strict)")
    del fres, again, want
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    means = eval_flow_app.run(eval_flow_app.build_parser().parse_args(
        ["--data_dir", data, "--gmflow_ckpt", os.path.join(
            root, "flow", f"gmflow_{steps:07d}.pth")]))
    log(f"[eval_flow] {FLOW_TRAIN['pairs']} pairs in {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps(means)}")
    if not all(math.isfinite(v) for v in means.values()):
        fail("eval_flow: a metric is not finite")
    shutil.rmtree(root, ignore_errors=True)


# --------------------------------- phase 6: the GroupNorm / conv entries

FUSED_SLACK = 1.5


def fused_resnet(block, x, temb_bias, temporal: bool):
    """A resnet block (cin == cout, no shortcut) through the entry points:
    `gn_affine` (channel sums), the fused conv with temb and the output
    sums, the second norm's affine from those sums, the fused conv with
    the residual. x channel-last: [N, H, W, C], or [B, T, S, C]."""
    from mofa_tpu_torch.kernels.conv_fused import (gn_silu_conv3x3,
                                                   gn_silu_tconv3)
    from mofa_tpu_torch.kernels.group_norm import gn_affine, stats_from_sums

    def hwio(conv):              # Conv2d [O, C, 3, 3] / Conv3d [O, C, 3, 1, 1]
        w = conv.weight
        return (w[:, :, :, 0, 0].permute(2, 1, 0) if temporal
                else w.permute(2, 3, 1, 0))

    fn = gn_silu_tconv3 if temporal else gn_silu_conv3x3
    n, c = x.shape[0], x.shape[-1]
    x3 = x.reshape(n, -1, c)
    a1, b1 = gn_affine(x3, block.norm1.weight, block.norm1.bias, 32,
                       block.norm1.eps)
    h, s1, s2 = fn(x, a1, b1, hwio(block.conv1), block.conv1.bias,
                   temb_bias=temb_bias, emit_sums=True)
    mean_c, inv_c = stats_from_sums(s1, s2, x3.shape[1], 32, block.norm2.eps)
    a2 = inv_c * block.norm2.weight.float()
    b2 = block.norm2.bias.float() - mean_c * a2
    return fn(h, a2, b2, hwio(block.conv2), block.conv2.bias, residual=x)


def phase_gn_conv(dev) -> dict:
    """The spatial and temporal resnet blocks of the UNet's /8 level at
    CFG batch 2 x 25 frames (576x1024), bf16, through the GroupNorm and
    fused-conv entry points, against the port's stock blocks (GroupNorm +
    SiLU + cuDNN conv): each held to the stock block run in fp32 on the
    upcast inputs (TF32 off), no more than FUSED_SLACK times as far from
    it as the stock bf16 block. Returns the launch counts of one pass
    through both blocks."""
    import torch
    import torch.nn.functional as F
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.models.resnet_blocks import (ResnetBlock2D,
                                                     TemporalResnetBlock)
    from mofa_tpu_torch.pipelines.common import init_random_

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(7)
    c, tc, bf = 320, 1280, torch.bfloat16
    blocks = {"spatial [50, 72, 128, 320]": (
                  ResnetBlock2D(c, c, tc, 1e-6), (50, c, 72, 128), (50, tc), False),
              "temporal [2, 25, 9216, 320]": (
                  TemporalResnetBlock(c, c, tc, 1e-5), (2, c, 25, 72, 128),
                  (2, 25, tc), True)}
    launches = dict.fromkeys(kernels.KERNELS, 0)
    bad = []
    for label, (blk, xshape, tshape, temporal) in blocks.items():
        with torch.no_grad():
            blk = init_random_(blk.to(dev), g)
            x = torch.randn(*xshape, generator=g, device=dev) * 0.8 + 0.2
            temb = torch.randn(*tshape, generator=g, device=dev)
            ref = blk(x, temb)                            # fp32, TF32 off
            blk.to(bf)
            xb, tb = x.to(bf), temb.to(bf)
            stock = blk(xb, tb)
            # the entry points' channel-last layouts
            x_cl = (xb.permute(0, 2, 3, 4, 1).reshape(2, 25, -1, c) if temporal
                    else xb.permute(0, 2, 3, 1)).contiguous()
            temb_bias = blk.time_emb_proj(F.silu(tb)).float()
            kernels.reset_launch_counts()
            fused = fused_resnet(blk, x_cl, temb_bias, temporal)
            torch.cuda.synchronize()
            for name, n in kernels.launch_counts().items():
                launches[name] += n
            got = (fused.reshape(2, 25, 72, 128, c).permute(0, 4, 1, 2, 3)
                   if temporal else fused.permute(0, 3, 1, 2))
            rel = lambda y: ((y.float() - ref).norm() / ref.norm()).item()
            e_fused, e_stock = rel(got), rel(stock)
            ms_fused = time_ms(lambda: fused_resnet(blk, x_cl, temb_bias,
                                                    temporal))
            ms_stock = time_ms(lambda: blk(xb, tb))
        ok = bool(torch.isfinite(got).all()) and e_fused <= FUSED_SLACK * e_stock
        log(f"  {label}: rel rms to the fp32 stock block: fused {e_fused:.3e},"
            f" stock bf16 {e_stock:.3e} {'ok' if ok else 'MISS'}; block ms: "
            f"fused {ms_fused:.3f}, stock {ms_stock:.3f}")
        if not ok:
            bad.append(label)
        del blk, x, temb, ref, xb, tb, stock, x_cl, fused, got
        torch.cuda.empty_cache()
    log(f"  launches of one pass through both blocks: {launches}")
    if bad:
        fail(f"fused resnet blocks off the stock blocks: {bad}")
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(channel_sums=2, gn_silu_conv3x3=2, gn_silu_tconv3=2)
    if launches != want:
        fail(f"GroupNorm / conv entry points launched {launches}, expected {want}")
    return launches


def phase_profile(dev, steps: int = 2) -> None:
    """torch.profiler over the main path at `steps` steps, without the VAE
    decode: device time by kernel name, top 40 (a breakdown, not a
    timing: the profiler adds overhead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mofa_tpu_torch.pipelines.traj import TrajPipeline

    bundle = random_bundle(dev, 0, torch.bfloat16)
    img, flow = smooth_inputs(1, MAIN["t"], MAIN["h"], MAIN["w"], dev, seed=4)
    pipe = TrajPipeline(bundle)
    run = lambda: pipe(img, flow, num_inference_steps=steps,
                       generator=torch.Generator(device=dev).manual_seed(5),
                       output_type="latent")
    run()                                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40,
                                  max_name_column_width=60))


# ------------------------------------------------------------------- main

def disk_writes() -> str:
    """This process's storage writes so far, from /proc/self/io (Linux):
    write_bytes (sent to storage, the page cache's writeback counted) and
    wchar (bytes passed to write calls); the nvcc processes not counted."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
    except OSError as e:
        return f"unknown ({e})"
    gib = lambda k: int(io[k]) / 2 ** 30
    return (f"write_bytes {int(io['write_bytes'])} ({gib('write_bytes'):.2f} GiB), "
            f"wchar {int(io['wchar'])} ({gib('wchar'):.2f} GiB)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "profile", "keypoint",
                                        "train", "ui", "mesh"), default="all")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA GPU")
    if not os.path.isdir(os.path.join(REPO, "mofa_tpu_torch")):
        fail("mofa_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda}")

    if args.phase == "profile":
        phase_profile(torch.device("cuda"))
        return

    # 2. build
    from mofa_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.library()
    log(f"[build] {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")

    if args.phase == "train":
        # the training slice alone: its kernels' backward, the training run
        dev = torch.device("cuda")
        kres = {n: {} for n in KERNEL_META}
        log("[backward] the kernels under autograd, fp32 and bf16")
        loose = phase_backward(kres, torch.Generator(device=dev).manual_seed(13), card)
        bad = [n for n, r in kres.items() if not r.get("bwd_ok", True)]
        if bad or loose:
            fail(f"backward: outside the bounds {bad}; planted faults passing {loose}")
        log("[train] stage-1 training through train_app, SVD-XT widths, fp32")
        _, kept = phase_train(dev)
        log("[stage2] stage 2 through train_app from the exported adapter: sequential "
            "AdamW vs --overlap_inputs --use_8bit_adam, 2 steps each")
        phase_stage2(dev, kept)
        log("[flow_trainers] train_cmp_app, train_flow_app, eval_flow_app at full widths")
        phase_flow_trainers(dev)
        return

    if args.phase == "ui":
        # the native library, PIRender, FILM and the UI server alone (5l)
        log("[ui] the native host library, PIRender, FILM and the UI server on the card")
        run_slice_ui(torch.device("cuda"), card)
        return

    if args.phase == "mesh":
        # the frame-parallel layer alone (5m)
        log("[mesh] frame-parallel inference on the card: NCCL at world 1, the traj, "
            "hybrid and keypoint videos with --frame_parallel's mesh")
        run_mesh(torch.device("cuda"), card, {})
        return

    if args.phase == "keypoint":
        # the keypoint slice alone: its kernels at its shapes, its video, the
        # audio front
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        kres: dict = {}
        log("[kernels] the keypoint path's kernels at its shapes, bf16")
        keypoint_kernel_checks(kres, torch.Generator(device=dev).manual_seed(0))
        bad = [n for n, r in kres.items() if not r["ok"]]
        if bad:
            fail(f"kernels disagree with their plain versions: {bad}")
        log(f"[keypoint] {KEYPOINT}, bf16, through keypoint_app.generate")
        kp = run_keypoint_video(dev, card)
        log(f"[keypoint] video {kp['total']:.3f} s, median step {kp['median_step']:.3f} s")
        log("[audio] the AniPortrait engine at full widths, fp32")
        run_audio_front(dev)
        log("[face] the face stack: face_fit_app, the SadTalker and video engines, "
            "--face3dvis, opendomain --engine sadtalker, the image CLIs' files")
        face_run = run_face_stack(dev, card)
        log("[front] the face front and facerender: the .task's graphs, face_fit_app "
            "--task, audio2ldmk_app --task / --driving_video, facerender_app with GFPGAN "
            "and paste-back, fp32, full widths")
        run_face_front(dev, card, face_run["track"])
        return

    # 3. kernels vs plain versions
    log("[kernels] kernel vs plain version on the card")
    kres = phase_kernels()
    log("[kernels] planted faults against the fp32 and bf16 bounds")
    loose = planted_faults()
    bad = [n for n, r in kres.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    if loose:
        fail(f"the bounds let planted faults pass: {loose}")
    log("[kernels] all within tolerance; every planted fault caught")

    # 3b. the FFN variants at the main path's FF shapes
    log("[ffn_variants] ln_geglu_ffn variants, geglu_ffn and the stock chain,"
        " bf16, ms")
    ffn_launches = phase_ffn_variants(torch.device("cuda"))

    # 3c. the kernels under autograd
    log("[backward] the kernels under autograd at the stage-1 shapes, fp32 and "
        "bf16: gradients vs plain autograd, planted faults")
    loose = phase_backward(kres, torch.Generator(device="cuda").manual_seed(13), card)
    bad = [n for n, r in kres.items() if not r.get("bwd_ok", True)]
    if bad or loose:
        fail(f"backward: outside the bounds {bad}; planted faults passing {loose}")

    launches = dict.fromkeys(KERNEL_META)
    for name in FFN_VARIANT_KERNELS:
        launches[name] = ffn_launches[name]
    if args.phase == "all":
        dev = torch.device("cuda")
        # 4. composition: kernels vs plain_reference() through the pipeline
        log("[composition] full widths, 256x384, T=8, 2 steps, fp32 and bf16,"
            " spatial-major and classic layouts")
        t0 = time.perf_counter()
        phase_composition(dev)
        log(f"[composition] done in {time.perf_counter() - t0:.1f} s")
        # 5. the main path, then 5b. the classic-layout path
        log("[main] the traj app's generation: drag tracks -> PCHIP -> sparse "
            "flow -> CMP -> TrajPipeline, SVD-XT widths, bf16, batched CFG")
        # the app runs with PyTorch's defaults (cuDNN may use TF32 for the
        # CMP's fp32 convs); the checks above turned TF32 off
        torch.backends.cudnn.allow_tf32 = True
        t0 = time.perf_counter()
        bundle = random_bundle(dev, 0, torch.bfloat16)
        torch.cuda.synchronize()
        n_params = {k: sum(p.numel() for p in m.parameters())
                    for k, m in bundle.modules().items()}
        log(f"  random bf16 bundle on the card in {time.perf_counter() - t0:.1f}"
            f" s; parameters {n_params}")
        main_run = run_video(bundle, dev, "tmajor", MAIN["steps"])
        log("[classic] the same video in the classic temporal layout "
            f"(MOFA_TMAJOR=0), {CLASSIC_STEPS} steps")
        classic_run = run_video(bundle, dev, "classic", CLASSIC_STEPS)
        log(f"[classic] median denoise step {classic_run['median_step']:.3f} s"
            f" vs {main_run['median_step']:.3f} s spatial-major")
        # 5c. the motion-brush path of the app
        log("[brush] drag tracks split by a motion brush, 256x384, T=8, 2 steps")
        run_brush_video(bundle, dev)
        del bundle
        torch.cuda.empty_cache()
        # 5d. the hybrid path: landmarks + drag tracks, two adapters
        log("[hybrid] the hybrid app's generation: landmarks + drag tracks -> "
            "CMP -> HybridPipeline (landmark + trajectory adapters loaded from "
            f"files, face mask blend), {MAIN['h']}x{MAIN['w']}, {MAIN['t']} frames, "
            f"{MAIN['steps']} steps, bf16")
        hybrid_run = run_hybrid_video(dev, card)
        log(f"[hybrid] median denoise step {hybrid_run['median_step']:.3f} s vs "
            f"{main_run['median_step']:.3f} s on the traj path; video "
            f"{hybrid_run['total']:.3f} s")
        torch.cuda.empty_cache()
        # 5e. the keypoint path: 125 frames in 10 sliding windows
        log(f"[keypoint] the keypoint app's generation: a landmark track -> CMP -> "
            f"KeypointPipeline (landmark adapter, {KEYPOINT['t']} frames in windows of "
            f"{KEYPOINT['window']} at stride {KEYPOINT['stride']}), "
            f"{KEYPOINT['h']}x{KEYPOINT['w']}, {KEYPOINT['steps']} steps, bf16")
        kp_run = run_keypoint_video(dev, card)
        log(f"[keypoint] median denoise step (10 windows) {kp_run['median_step']:.3f} s; "
            f"video {kp_run['total']:.3f} s; peak {kp_run['peak']:.2f} GiB")
        # 5f. the audio front: wav -> landmark track
        log("[audio] the AniPortrait engine (audio2ldmk_app) at full widths, fp32")
        run_audio_front(dev)
        # 5j. the face stack, and the image CLIs through their files
        log("[face] the face stack: face_fit_app, the SadTalker and video engines, "
            "--face3dvis, opendomain --engine sadtalker, the image CLIs' files")
        face_run = run_face_stack(dev, card)
        # 5k. the face front (mediapipe .task) and the facerender path
        log("[front] the face front and facerender: the .task's graphs, face_fit_app "
            "--task, audio2ldmk_app --task / --driving_video, facerender_app with GFPGAN "
            "and paste-back, fp32, full widths")
        run_face_front(dev, card, face_run["track"])
        # 5l. the native library, PIRender, FILM and the UI server
        log("[ui] the native host library, PIRender, FILM and the UI server (/run at "
            f"{MAIN['h']}x{MAIN['w']}, {MAIN['t']} frames, {MAIN['steps']} steps, bf16)")
        ui_run = run_slice_ui(dev, card)["ui"]
        # 5m. frame-parallel inference (NCCL, world 1)
        log("[mesh] frame-parallel inference: NCCL at world 1, the traj "
            f"({MAIN['steps']} steps), hybrid and keypoint ({MESH['landmark_steps']} "
            "steps) videos with the mesh and directly in the classic layout")
        mesh_run = run_mesh(dev, card, kres)
        # 5g. stage-1 training through train_app
        log("[train] stage-1 training through train_app: 384x384, 25 frames, "
            "batch 1, fp32, block remat, EMA, SVD-XT widths")
        train_launches, kept = phase_train(dev)
        # 5h. stage 2 from the exported adapter
        log("[stage2] stage 2 through train_app from the exported adapter: sequential "
            "AdamW vs --overlap_inputs --use_8bit_adam, 2 steps each")
        stage2_launches = phase_stage2(dev, kept)
        # 5i. the CMP and GMFlow trainers
        log("[flow_trainers] train_cmp_app, train_flow_app, eval_flow_app at full widths")
        phase_flow_trainers(dev)
        # 6. the GroupNorm / fused-conv entry points
        log("[gn_conv] resnet blocks through gn_affine + gn_silu_conv3x3 / "
            "gn_silu_tconv3, bf16")
        gn_launches = phase_gn_conv(dev)
        # each kernel's launches from the run of its own path
        for name in KERNEL_META:
            if name in FFN_VARIANT_KERNELS:
                continue
            source = (classic_run if name == "short_attention" else main_run)
            launches[name] = source["launches"][name]
        for name in ("channel_sums", "gn_silu_conv3x3", "gn_silu_tconv3"):
            launches[name] = gn_launches[name]
        for name in TRAIN_KERNELS:
            kres[name]["train_launches"] = train_launches[name]
            kres[name]["stage2_launches"] = stage2_launches["A"][name]
        for name, n in kept["classic_launches"].items():
            kres[name]["classic_train_launches"] = n
        for name in KERNEL_META:        # the 25-step spatial-major video's own
            kres[name]["main_path_launches"] = main_run["launches"][name]
            kres[name]["hybrid_launches"] = hybrid_run["launches"][name]
            kres[name]["keypoint_launches"] = kp_run["launches"][name]
            kres[name]["opendomain_sadtalker_launches"] = face_run["opendomain_launches"][name]
            kres[name]["ui_launches"] = ui_run["launches"][name]
            kres[name]["mesh_launches"] = {
                k: v["frame_parallel"]["launches"][name] for k, v in mesh_run.items()}
        # flash's launches at each main-path site, from the same run
        by_site = kres["flash_attention"]["main_path_launches_by_site"] = {}
        for site, *shape in FLASH_MAIN_SHAPES:
            n = main_run["flash_shapes"].get(tuple(shape), 0)
            if n == 0:
                fail(f"flash_attention: the main path never launched site {site} {shape}")
            by_site[site] = n

    log(f"[disk] {disk_writes()}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("chain_ms", "ms_b50", "library_ms_b50", "plain_ms_b50", "bound_ms_b50",
             "ms_c640",
             "plain_ms_c640", "chain_ms_c640", "bound_ms_c640", "bound_by_c640",
             "sites", "main_path_launches_by_site", "stage_ms_c320", "stage_ms_c640",
             "avg_call_ms", "stage_ms",
             "main_path_launches", "hybrid_launches", "keypoint_launches",
             "opendomain_sadtalker_launches", "ui_launches", "mesh_launches",
             "ms_keypoint", "plain_ms_keypoint", "library_ms_keypoint",
             "chain_ms_keypoint", "bound_ms_keypoint", "bound_by_keypoint",
             "ms_keypoint16", "plain_ms_keypoint16", "library_ms_keypoint16",
             "bound_ms_keypoint16", "bound_by_keypoint16", "train_launches",
             "stage2_launches", "classic_train_launches",
             "train_fwd_bound_cores_ms_fp32") + tuple(
                 f"{k}_mesh{n}" for n in MESH_SHORT_WORLDS
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")) + tuple(
                 k + s for s in ("_fp32", "_fp32_c640", "_fp32_train")
                 for k in ("ms", "plain_ms", "library_ms", "chain_ms", "bound_ms",
                           "bound_by", "bound_cores_ms", "queued_ms",
                           "library_queued_ms")) + tuple(
                 f"{k}_{d}" for k in ("bwd_ms", "bwd_bound_ms", "bwd_bound_by",
                                      "bwd_library_ms", "bwd_max_rel_err",
                                      "train_fwd_ms", "train_fwd_bound_ms",
                                      "train_fwd_bound_by", "train_fwd_library_ms",
                                      "train_fwd_plain_ms")
                 for d in ("fp32", "bf16"))
    table = {"kernels": [
        dict(name=n, route="cuda", **KERNEL_META[n], launches=launches[n],
             **{k: kres[n][k] for k in keys},
             **{k: kres[n][k] for k in extra if k in kres[n]})
        for n in KERNEL_META]}
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
