"""Chip smoke test of the PyTorch/CUDA port (`mofa_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phase kernels  # build + kernel checks only
    python3 chip_smoke.py --phase profile  # torch.profiler table, 2 steps

Phases, each printed as it finishes:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. the build of the CUDA kernels (nvcc, sm_90a) from `mofa_tpu_torch/csrc`;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, bf16 and fp32, against the bounds of TOL_FP32 / TOL_BF16,
     with the kernel's and the plain version's times (CUDA events,
     median); then planted faults, which the bf16 bounds must reject;
  4. the composition check: the full trajectory pipeline at full SVD-XT
     widths but a small video, once through the kernels and once inside
     `plain_reference()`, in fp32 (PSNR >= 45 dB) and in bf16 (PSNR bars
     beside PSNR_BF16_DB);
  5. the main path: `TrajPipeline` at 576x1024, 25 frames, bf16, batched
     CFG, random seeded weights, timing every phase and counting each
     kernel's launches (every count must be > 0, every frame finite).
The second line from the end is the kernel table as one JSON object; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
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


# ---------------------------------------------------------- phase 3: kernels

KERNEL_META = {
    "flash_attention": dict(
        source="mofa_tpu_torch/csrc/flash_attention.cu",
        replaces="mofa_tpu/kernels/flash_attention.py:183"),
    "short_attention_tmajor": dict(
        source="mofa_tpu_torch/csrc/short_attention_tmajor.cu",
        replaces="mofa_tpu/kernels/short_attention.py:246"),
    "ln_geglu_ffn": dict(
        source="mofa_tpu_torch/csrc/ln_geglu_ffn.cu",
        replaces="mofa_tpu/kernels/geglu_ffn.py:390"),
    "softsplat": dict(
        source="mofa_tpu_torch/csrc/softsplat.cu",
        replaces="mofa_tpu/kernels/softsplat_pallas.py:87"),
}

# Bounds on a kernel's agreement with its plain version.
# fp32: max |kernel - plain| <= tol. Both sides are exact fp32 math in
# another summation order (atomics for the splat, tiles for the rest).
# bf16: (max_rel, rms_rel): max |diff| <= max_rel * max |plain| and
# ||diff|| / ||plain|| <= rms_rel. The plain versions round P (attention)
# or the LN output and the GEMM1 result (FFN) to bf16 at other points than
# the kernels do, and the outputs are bf16, so the bounds scale with the
# output. They sit a few times above the sound readings and below those of
# the planted faults, which `planted_faults` checks on every run (readings
# in PERF.md).
TOL_FP32 = {"flash_attention": 1e-4, "short_attention_tmajor": 1e-4,
            "ln_geglu_ffn": 1e-3, "softsplat": 1e-4}
TOL_BF16 = {"flash_attention": (2e-2, 7e-3),
            "short_attention_tmajor": (2e-2, 7e-3),
            "ln_geglu_ffn": (2e-2, 1e-2)}


def agreement(got, ref):
    """(max |got - ref|, max |ref|, ||got - ref|| / ||ref||), in fp32."""
    d, r = got.float() - ref.float(), ref.float()
    return (d.abs().max().item(), r.abs().max().item(),
            (d.norm() / r.norm()).item())


def within(name, dtype_name, err, ref_max, rms) -> bool:
    if dtype_name == "fp32":
        return err <= TOL_FP32[name]
    max_rel, rms_rel = TOL_BF16[name]
    return err <= max_rel * ref_max and rms <= rms_rel


def _check(results, name, dtype_name, label, kernel_fn, plain_fn, time_it):
    import torch
    from mofa_tpu_torch import kernels
    with torch.no_grad():
        got = kernel_fn()
        torch.cuda.synchronize()
        with kernels.plain_reference():
            ref = plain_fn()
        torch.cuda.synchronize()
        err, ref_max, rms = agreement(got, ref)
        finite = bool(torch.isfinite(got).all())
        ms = plain_ms = None
        if time_it:
            ms = time_ms(kernel_fn)
            with kernels.plain_reference():
                plain_ms = time_ms(plain_fn)
    ok = finite and within(name, dtype_name, err, ref_max, rms)
    log(f"  {name:24s} {dtype_name:4s} {label:34s} max|diff| {err:.3e} "
        f"max|ref| {ref_max:.3e} rel rms {rms:.3e} {'ok' if ok else 'MISS'}"
        + (f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms" if time_it else ""))
    r = results.setdefault(name, dict(max_abs_err=0.0, ms=None, plain_ms=None,
                                      ok=True))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ok"] = r["ok"] and ok
    if time_it and r["ms"] is None:
        r["ms"], r["plain_ms"] = ms, plain_ms
    del got, ref
    torch.cuda.empty_cache()


def tmajor_without_last_frame(q2, k2, v2, t: int, h: int):
    """Plain tmajor attention that never reads the last key frame."""
    import torch
    bt, s, hd = q2.shape
    heads = lambda x: x.reshape(bt // t, t, s, h, hd // h).permute(0, 2, 3, 1, 4)
    q, k, v = heads(q2), heads(k2)[..., :t - 1, :], heads(v2)[..., :t - 1, :]
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2)
                      * (hd // h) ** -0.5, dim=-1)
    return (p.to(q2.dtype) @ v).permute(0, 3, 1, 2, 4).reshape(bt, s, hd)


def planted_faults() -> list:
    """The bf16 kernels held, with the bf16 bounds, against the plain
    version of a faulty kernel: one that skips a 64-key tile (flash,
    L=9216), leaves the ragged tail's zero-filled keys unmasked (flash,
    L=1000), never reads the last frame (tmajor), or drops a 16-wide
    chunk of the FFN's inner axis. Every one must MISS; returns the
    labels of those that passed."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.kernels.flash_attention import flash_attention
    from mofa_tpu_torch.kernels.geglu_ffn import ln_geglu_ffn
    from mofa_tpu_torch.kernels.short_attention import short_attention_tmajor

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def flash_case(length, fault):
        q, k, v = (randn(2, length, 5, 64) for _ in range(3))
        if fault == "tile":
            keep = torch.cat([torch.arange(64), torch.arange(128, length)])
            kf, vf = k[:, keep.to(dev)], v[:, keep.to(dev)]
        else:
            pad = torch.zeros(2, 1024 - length, 5, 64, dtype=bf, device=dev)
            kf, vf = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
        return (lambda: flash_attention(q, k, v),
                lambda: flash_attention(q, kf, vf))

    def tmajor_case():
        q, k, v = (randn(50, 9216, 320) for _ in range(3))
        return (lambda: short_attention_tmajor(q, k, v, 25, 5),
                lambda: tmajor_without_last_frame(q, k, v, 25, 5))

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

    cases = [("flash_attention", "B=2 L=9216 H=5 D=64, keys 64-127 skipped",
              lambda: flash_case(9216, "tile")),
             ("flash_attention", "B=2 L=1000 H=5 D=64, tail unmasked",
              lambda: flash_case(1000, "tail")),
             ("short_attention_tmajor", "BT=50 S=9216 HD=320, last frame unread",
              tmajor_case),
             ("ln_geglu_ffn", "rows=460800 C=320, inner 0-15 dropped",
              ffn_case)]
    passed = []
    for name, label, make in cases:
        with torch.no_grad():
            kernel_fn, faulty_fn = make()
            got = kernel_fn()
            with kernels.plain_reference():
                bad = faulty_fn()
            err, ref_max, rms = agreement(got, bad)
        caught = not within(name, "bf16", err, ref_max, rms)
        log(f"  {name:24s} bf16 {label:42s} max|diff| {err:.3e} max|ref| "
            f"{ref_max:.3e} rel rms {rms:.3e} "
            f"{'MISS, as it must' if caught else 'PASSED: bounds too loose'}")
        if not caught:
            passed.append(f"{name}: {label}")
        del kernel_fn, faulty_fn, got, bad
        torch.cuda.empty_cache()
    return passed


def phase_kernels() -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    import torch
    from mofa_tpu_torch.kernels.flash_attention import flash_attention
    from mofa_tpu_torch.kernels.geglu_ffn import ln_geglu_ffn
    from mofa_tpu_torch.kernels.short_attention import short_attention_tmajor
    from mofa_tpu_torch.kernels.softsplat import splat_raw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    results: dict = {}

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

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
                   lambda: flash_attention(q, k, v), timed and dn == "bf16")
    # tmajor: T=25, CFG batch 2 -> B*T=50 rows of [S, H*D]
    for S, HD, H, timed in ((9216, 320, 5, True), (2304, 640, 10, False),
                            (576, 1280, 20, False), (144, 1280, 20, False),
                            (576, 1280, 10, False)):
        for dn in ("bf16", "fp32"):
            q, k, v = (randn(50, S, HD, dtype=dts[dn]) for _ in range(3))
            _check(results, "short_attention_tmajor", dn,
                   f"BT=50 S={S} HD={HD} H={H}",
                   lambda: short_attention_tmajor(q, k, v, 25, H),
                   lambda: short_attention_tmajor(q, k, v, 25, H),
                   timed and dn == "bf16")
    # ln_geglu_ffn: rows of the /8 (C=320) and /16 (C=640) sites; fp32 on
    # a row cut (its kernel is the plain-FMA correctness path)
    for C, R, timed in ((320, 460800, True), (640, 115200, False)):
        for dn in ("bf16", "fp32"):
            rows = R if dn == "bf16" else 16384 + 7
            dt = dts[dn]
            x = randn(rows, C, dtype=dt)
            ls, lb = randn(C, scale=0.2) + 1.0, randn(C, scale=0.2)
            w0 = randn(8 * C, C, dtype=dt, scale=C ** -0.5)
            b0 = randn(8 * C, dtype=dt, scale=0.1)
            w2 = randn(C, 4 * C, dtype=dt, scale=(4 * C) ** -0.5)
            b2 = randn(C, dtype=dt, scale=0.1)
            _check(results, "ln_geglu_ffn", dn, f"rows={rows} C={C}",
                   lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2),
                   lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2),
                   timed and dn == "bf16")
    # softsplat raw splat: [N*(T-1), h, w, C+1] at /8../64, fp32; smooth
    # flow in [-3, 3] px with some out-of-bounds and non-finite pixels
    for h, w, c, timed in ((72, 128, 321, True), (36, 64, 321, False),
                           (18, 32, 641, False), (9, 16, 1281, False)):
        x = randn(48, h, w, c)
        flow = randn(48, h, w, 2, scale=3.0)
        flow[:, 0, :, 0] = -40.0
        flow[:, 1, ::7, 1] = float("nan")
        flow[:, 2, ::5, 0] = float("inf")
        _check(results, "softsplat", "fp32", f"N=48 h={h} w={w} C={c}",
               lambda: splat_raw(x, flow), lambda: splat_raw(x, flow), timed)
    return results


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


# ------------------------------------------------ phase 4: composition

# PSNR bars of the composition check: fp32 kernels vs fp32 plain (the bar
# of tests/test_fullchain_parity.py); bf16 kernels vs bf16 plain (about
# 6 dB, twice the RMS error, below the 41.9 dB reading in PERF.md); and
# the bf16 kernels may sit at most BF16_SLACK_DB further from the fp32
# plain run than the bf16 plain run does (readings 39.02 vs 38.97 dB).
PSNR_FP32_DB, PSNR_BF16_DB, BF16_SLACK_DB = 45.0, 36.0, 1.0


def phase_composition(dev) -> None:
    """Full SVD-XT widths, 256x384, T=8, 2 steps: the pipeline through the
    kernels and inside `plain_reference()`, in fp32 and then, with the same
    weights cast, in bf16 (the main path's kernels)."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
    from mofa_tpu_torch.models.svd_unet import SVDUNetConfig
    from mofa_tpu_torch.models.vae import VAEConfig
    from mofa_tpu_torch.pipelines.common import ModelBundle
    from mofa_tpu_torch.pipelines.traj import TrajPipeline

    h, w, t, steps = 256, 384, 8, 2
    bundle = ModelBundle.init_random(
        dev, torch.Generator(device=dev).manual_seed(1), SVDUNetConfig(),
        VAEConfig(), CLIPVisionConfig(), dtype=torch.float32)
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
        kernels.reset_launch_counts()
        got = run()
        counts = kernels.launch_counts()
        with kernels.plain_reference():
            ref = run()
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
            fail(f"composition check, {dn}: non-finite frames")
        sat = float(((ref <= 0.0) | (ref >= 1.0)).float().mean())
        log(f"  {dn}: launches through the kernels: {counts}")
        log(f"  {dn}: frames {tuple(got.shape)}, mean {float(ref.mean()):.4f}, "
            f"std {float(ref.std()):.4f}, clipped share {sat:.4f}, "
            f"max|diff| {float((got - ref).abs().max()):.3e}")
        if min(counts.values()) == 0:
            fail(f"composition check, {dn}: did not reach every kernel: "
                 f"{counts}")
        frames[dn] = (got, ref)
    (k32, p32), (k16, p16) = frames["fp32"], frames["bf16"]
    readings = {"fp32 kernels vs fp32 plain": (psnr(k32, p32), PSNR_FP32_DB),
                "bf16 kernels vs bf16 plain": (psnr(k16, p16), PSNR_BF16_DB)}
    to_truth_k, to_truth_p = psnr(k16, p32), psnr(p16, p32)
    readings["bf16 kernels vs fp32 plain"] = (to_truth_k,
                                              to_truth_p - BF16_SLACK_DB)
    log(f"  bf16 plain vs fp32 plain {to_truth_p:.2f} dB")
    for label, (p, bar) in readings.items():
        log(f"[composition] PSNR {label} {p:.2f} dB (bar {bar:.2f} dB)")
    low = [label for label, (p, bar) in readings.items() if p < bar]
    if low:
        fail(f"composition PSNR below its bar: {low}")
    del bundle, pipe, frames, k32, p32, k16, p16
    torch.cuda.empty_cache()


# ---------------------------------------------------- phase 5: main path

MAIN = dict(h=576, w=1024, t=25, steps=25, decode_chunk_size=8)


def phase_main(dev) -> dict:
    """TrajPipeline at 576x1024, 25 frames, bf16, batched CFG."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
    from mofa_tpu_torch.models.svd_unet import SVDUNetConfig
    from mofa_tpu_torch.models.vae import VAEConfig
    from mofa_tpu_torch.pipelines.common import ModelBundle
    from mofa_tpu_torch.pipelines.traj import TrajPipeline

    t0 = time.perf_counter()
    bundle = ModelBundle.init_random(
        dev, torch.Generator(device=dev).manual_seed(0), SVDUNetConfig(),
        VAEConfig(), CLIPVisionConfig(), dtype=torch.bfloat16)
    n_params = {k: sum(p.numel() for p in m.parameters())
                for k, m in bundle.modules().items()}
    torch.cuda.synchronize()
    log(f"  random bf16 bundle on the card in {time.perf_counter() - t0:.1f} s;"
        f" parameters {n_params}")
    img, flow = smooth_inputs(1, MAIN["t"], MAIN["h"], MAIN["w"], dev, seed=4)
    gen = torch.Generator(device=dev).manual_seed(5)
    pipe = TrajPipeline(bundle)
    log(f"  {MAIN['steps']} steps (the full schedule), {MAIN['t']} frames, "
        f"{MAIN['h']}x{MAIN['w']}, decode_chunk_size "
        f"{MAIN['decode_chunk_size']}")
    torch.cuda.reset_peak_memory_stats()
    phases: dict = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    frames, _ = pipe(img, flow, num_inference_steps=MAIN["steps"],
                     decode_chunk_size=MAIN["decode_chunk_size"],
                     generator=gen, phase_times=phases)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = phases["denoise_step"]
    log(f"  phases (s): clip_encode {phases['clip_encode'][0]:.3f}, "
        f"vae_encode {phases['vae_encode'][0]:.3f}, warp "
        f"{phases['warp'][0]:.3f}, denoise {sum(steps):.3f} "
        f"({len(steps)} steps: first {steps[0]:.3f}, median "
        f"{sorted(steps)[len(steps) // 2]:.3f}), decode "
        f"{phases['decode'][0]:.3f}; total {total:.3f}")
    log(f"  peak torch.cuda.max_memory_allocated {peak:.2f} GiB")
    log(f"  kernel launches in the main path: {launches}")
    want = (1, MAIN["t"], MAIN["h"], MAIN["w"], 3)
    if tuple(frames.shape) != want:
        fail(f"main path frames {tuple(frames.shape)}, expected {want}")
    if not bool(torch.isfinite(frames).all()):
        fail("main path produced non-finite frames")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"main path never launched: {missing}")
    log(f"  frames finite, mean {float(frames.mean()):.4f}, std "
        f"{float(frames.std()):.4f}")
    return launches


def phase_profile(dev, steps: int = 2) -> None:
    """torch.profiler over the main path at `steps` steps, without the VAE
    decode: device time by kernel name, top 25 (a breakdown, not a
    timing: the profiler adds overhead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
    from mofa_tpu_torch.models.svd_unet import SVDUNetConfig
    from mofa_tpu_torch.models.vae import VAEConfig
    from mofa_tpu_torch.pipelines.common import ModelBundle
    from mofa_tpu_torch.pipelines.traj import TrajPipeline

    bundle = ModelBundle.init_random(
        dev, torch.Generator(device=dev).manual_seed(0), SVDUNetConfig(),
        VAEConfig(), CLIPVisionConfig(), dtype=torch.bfloat16)
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
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                  max_name_column_width=60))


# ------------------------------------------------------------------- main

def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "kernels", "profile"),
                    default="all")
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

    # 3. kernels vs plain versions
    log("[kernels] kernel vs plain version on the card")
    kres = phase_kernels()
    log("[kernels] planted faults against the bf16 bounds")
    loose = planted_faults()
    bad = [n for n, r in kres.items() if not r["ok"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    if loose:
        fail(f"the bf16 bounds let planted faults pass: {loose}")
    log("[kernels] all within tolerance; every planted fault caught")

    launches = {name: None for name in KERNEL_META}
    if args.phase == "all":
        dev = torch.device("cuda")
        # 4. composition: kernels vs plain_reference() through the pipeline
        log("[composition] full widths, 256x384, T=8, 2 steps, fp32 and bf16")
        t0 = time.perf_counter()
        phase_composition(dev)
        log(f"[composition] done in {time.perf_counter() - t0:.1f} s")
        # 5. the main path
        log("[main] TrajPipeline, SVD-XT widths, bf16, batched CFG")
        launches = phase_main(dev)

    table = {"kernels": [
        dict(name=n, route="cuda", **KERNEL_META[n], launches=launches[n],
             max_abs_err=kres[n]["max_abs_err"], ms=kres[n]["ms"],
             plain_ms=kres[n]["plain_ms"]) for n in KERNEL_META]}
    log(json.dumps(table))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
