"""Chip smoke test of the PyTorch/CUDA port (`mofa_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one card
    python3 chip_smoke.py --phase kernels  # build + kernel checks only
    python3 chip_smoke.py --phase profile  # torch.profiler table, 2 steps

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
     run; flash also timed beside SDPA at the main path's own /8 shape
     (B*T = 50, no plain version: its logits would not fit); then planted
     faults, which the bf16 bounds must reject;
     3b. the FFN variants (tools/bench_ffn.py's A/B): plain, ilv, pipe,
     tanh, geglu_ffn and the stock chain at the main path's three FF
     shapes, their agreement with "plain" and one pass's launch counts;
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


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# the least time a kernel could take is the larger of its bytes over the
# memory rate and its operations over the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}


def bound(ops: float, nbytes: float, kind: str) -> tuple:
    """(bound_ms, "bytes" or "operations") for work of `ops` operations
    of type `kind` (bf16 tensor core, or fp32 outside the tensor cores)
    that must move `nbytes` bytes."""
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
        source="mofa_tpu_torch/csrc/conv_fused.cu",
        replaces="mofa_tpu/kernels/conv_fused.py:190"),
    "gn_silu_tconv3": dict(
        source="mofa_tpu_torch/csrc/conv_fused.cu",
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
# relative bounds below. Both sides are exact fp32 math in another
# summation order (atomics for the splat and the channel sums, tiles for
# the rest); the channel sums grow with S, so their bound is relative.
# bf16: (max_rel, rms_rel): max |diff| <= max_rel * max |plain| and
# ||diff|| / ||plain|| <= rms_rel. The plain versions round P (attention),
# the LN output and the GEMM1 result (FFN), or the conv's output before
# its fp32 epilogue (fused convs) to bf16 at other points than the
# kernels do, and the outputs are bf16, so the bounds scale with the
# output. The channel sums are fp32 sums of the same bf16 values on both
# sides. The bf16 kernels are also held, with the same bounds, against
# the plain version in fp32 on their upcast inputs (TF32 off). The bounds
# sit a few times above the sound readings and below those of the planted
# faults, which `planted_faults` checks on every run (readings in PERF.md).
TOL_FP32 = {"flash_attention": 1e-4, "short_attention_tmajor": 1e-4,
            "short_attention": 1e-4, "ln_geglu_ffn": 1e-3, "softsplat": 1e-4,
            "channel_sums": (1e-5, 1e-5)}
TOL_BF16 = {"flash_attention": (2e-2, 7e-3),
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
           ref32_fn=None, library_fn=None, chain_fn=None, work=None):
    """kernel_fn() against plain_fn() (inside plain_reference()), and for
    a bf16 kernel against ref32_fn(), the plain version on fp32 inputs.
    With time_it: the kernel's, the plain version's, library_fn()'s (one
    PyTorch call computing the same function) and chain_fn()'s (the stock
    chain the port runs instead) times, and the bound of `work` = (ops,
    bytes, kind)."""
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
    if time_it and r["ms"] is None:
        r.update(times)
        r["bound_ms"], r["bound_by"] = bound(*work)
        log(f"  {'':24s}      bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    del got, ref
    torch.cuda.empty_cache()


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
    """The bf16 kernels held, with the bf16 bounds, against the plain
    version of a faulty kernel: one that skips a 64-key tile (flash,
    L=9216), leaves the ragged tail's zero-filled keys unmasked (flash,
    L=1000), consumes a ring stage before its barrier completes (flash:
    key tile 3 read as the stale tile 0 of the same stage), skips the last
    wgmma k-step of S (flash: q's last 16 dims unread), never reads the
    last frame (tmajor) or the last key (classic short attention), leaves
    the padded keys T..31 unmasked (tmajor: zero keys with logit 0), leaves
    the last task of every warp's walk unwritten (classic short attention),
    drops a 16-wide chunk of the FFN's inner axis, leaves
    one 16-row sub-tile of every block unwritten (ilv FFN), skips the last
    inner chunk, the pipeline's drain (pipe FFN), drops the gate half of b0
    (geglu_ffn), computes the erf gelu instead of the tanh form (tanh FFN,
    at gate inputs where the two differ), skips the last S-slab of a block
    (channel sums), or drops the centre tap (3x3 conv) or the t-1 tap
    (temporal conv). Every one must MISS; returns the labels of those that
    passed."""
    import torch
    from mofa_tpu_torch import kernels
    from mofa_tpu_torch.kernels.attention import attention_plain
    from mofa_tpu_torch.kernels.conv_fused import (gn_silu_conv3x3,
                                                   gn_silu_tconv3)
    from mofa_tpu_torch.kernels.flash_attention import flash_attention
    from mofa_tpu_torch.kernels.geglu_ffn import geglu_ffn, ln_geglu_ffn
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

    def ffn_variant_case(fault):
        c, rows = 320, 460800
        args = ffn_operands(g, c, rows, bf, tail=fault == "tanh")
        x, ls, lb, w0, b0, w2, b2 = args
        if fault == "ilv":                  # sub-tile 1 of every block unwritten
            def faulty():
                out = ln_geglu_ffn(*args)
                out.view(-1, 64, c)[:, 16:32] = 0
                return out
            return lambda: ln_geglu_ffn(*args, variant="ilv"), faulty
        if fault == "pipe":                 # the drain skipped: last chunk lost
            w2f = w2.clone()
            w2f[:, -32:] = 0
            return (lambda: ln_geglu_ffn(*args, variant="pipe"),
                    lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2f, b2))
        if fault == "geglu":                # the gate half of b0 dropped
            b0f = b0.clone()
            b0f[4 * c:] = 0
            return (lambda: geglu_ffn(x, w0, b0, w2, b2),
                    lambda: geglu_ffn(x, w0, b0f, w2, b2))
        # tanh: the erf function, at the negative-tail gate inputs
        return lambda: ln_geglu_ffn(*args, variant="tanh"), lambda: ln_geglu_ffn(*args)

    def sums_case():
        x3 = randn(50, 9216, 320, mean=0.5)
        cut = x3.shape[1] - slab_rows(320, bf)
        return (lambda: channel_sums(x3),
                lambda: channel_sums_plain(x3[:, :cut]))

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

    cases = [("flash_attention", "B=2 L=9216 H=5 D=64, keys 64-127 skipped",
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
             ("ln_geglu_ffn_ilv", "rows=460800 C=320, rows 16-31 unwritten",
              lambda: ffn_variant_case("ilv")),
             ("ln_geglu_ffn_pipe", "rows=460800 C=320, drain skipped",
              lambda: ffn_variant_case("pipe")),
             ("geglu_ffn", "rows=460800 C=320, gate half of b0 dropped",
              lambda: ffn_variant_case("geglu")),
             ("ln_geglu_ffn_tanh", "rows=460800 C=320 tail gates, vs erf",
              lambda: ffn_variant_case("tanh")),
             ("channel_sums", "[50, 9216, 320], last S-slab skipped",
              sums_case),
             ("gn_silu_conv3x3", "[50, 72, 128, 320]->320, centre tap dropped",
              lambda: conv_case(False)),
             ("gn_silu_tconv3", "[2, 25, 9216, 320]->320, t-1 tap dropped",
              lambda: conv_case(True))]
    passed = []
    for name, label, make in cases:
        with torch.no_grad():
            kernel_fn, faulty_fn = make()
            got = kernel_fn()
            with kernels.plain_reference():
                bad = faulty_fn()
            fine, err, ref_max, rms = judge(name, "bf16", got, bad)
        caught = not fine
        log(f"  {name:24s} bf16 {label:44s} max|diff| {err:.3e} max|ref| "
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
    from mofa_tpu_torch.kernels.softsplat import splat_raw
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
    # flash at the main path's own /8 shape, B*T = 50 (7 of its 21 launches
    # a step): the kernel and SDPA, no plain version
    q, k, v = (randn(50, 9216, 5, 64, dtype=torch.bfloat16) for _ in range(3))
    r = results["flash_attention"]
    with torch.no_grad():
        r["ms_b50"] = time_ms(lambda: flash_attention(q, k, v))
        r["library_ms_b50"] = time_ms(sdpa(q, k, v))
    r["bound_ms_b50"] = bound(4 * 50 * 5 * 9216 ** 2 * 64, 4 * nbytes(q), "bf16")[0]
    log(f"  {'flash_attention':24s} bf16 {'B=50 L=9216 H=5 D=64 (timing only)':38s} "
        f"ms {r['ms_b50']:.3f}  library_ms {r['library_ms_b50']:.3f}  bound "
        f"{r['bound_ms_b50']:.3f} ms (operations)")
    # and beside SDPA at the trunk's /32 site (the main path's D = 128
    # shape), at the UNet's /32 site (D = 64, the same short L) and at
    # D = 128 with a long L: short rows against two consumer warpgroups
    for B, L, H, D in ((50, 576, 10, 128), (50, 576, 20, 64), (2, 9216, 5, 128)):
        q, k, v = (randn(B, L, H, D, dtype=torch.bfloat16) for _ in range(3))
        with torch.no_grad():
            ms, lib_ms = time_ms(lambda: flash_attention(q, k, v)), time_ms(sdpa(q, k, v))
        label = f"B={B} L={L} H={H} D={D} (timing only)"
        log(f"  {'flash_attention':24s} bf16 {label:38s} ms {ms:.3f}  library_ms "
            f"{lib_ms:.3f}  bound {bound(4 * B * H * L * L * D, 4 * nbytes(q), 'bf16')[0]:.3f} ms")
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
    # classic short attention: [B*S, T, H, D] at the /8 temporal site of
    # the classic layout (the only one its gate admits at T=25), and the
    # 256x384, T=8 composition shapes
    for B, L, H, timed in ((18432, 25, 5, True), (3072, 8, 5, False),
                           (768, 8, 10, False), (192, 8, 20, False)):
        for dn in ("bf16", "fp32"):
            q, k, v = (randn(B, L, H, 64, dtype=dts[dn]) for _ in range(3))
            _check(results, "short_attention", dn, f"B={B} L={L} H={H} D=64",
                   lambda: short_attention(q, k, v),
                   lambda: short_attention(q, k, v), timed and dn == "bf16",
                   ref32_fn=(lambda: short_attention(*upcast(q, k, v)))
                   if dn == "bf16" else None,
                   library_fn=sdpa(q, k, v) if timed and dn == "bf16" else None,
                   work=(4 * B * H * L * L * 64, 4 * nbytes(q), "bf16"))
    # ln_geglu_ffn: rows of the /8 (C=320) and /16 (C=640) sites; fp32 on
    # a row cut (its kernel is the plain-FMA correctness path)
    # chain: the stock LayerNorm + Linear + gelu gate + Linear + add
    for C, R, timed in ((320, 460800, True), (640, 115200, False)):
        for dn in ("bf16", "fp32"):
            rows = R if dn == "bf16" else 16384 + 7
            args = ffn_operands(g, C, rows, dts[dn])
            x, ls, lb, w0, b0, w2, b2 = args
            timed_here = timed and dn == "bf16"
            _check(results, "ln_geglu_ffn", dn, f"rows={rows} C={C}",
                   lambda: ln_geglu_ffn(*args), lambda: ln_geglu_ffn(*args),
                   timed_here,
                   chain_fn=(lambda: ffn_chain(x, (ls, lb), *args[3:]))
                   if timed_here else None,
                   work=(24 * rows * C * C, 2 * nbytes(x) + nbytes(w0, w2),
                         "bf16"))
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
               lambda: splat_raw(x, flow), lambda: splat_raw(x, flow), timed,
               work=(8 * x.numel(), 2 * nbytes(x) + nbytes(flow), "fp32"))
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
    return results


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


def expected_launches(layout: str, steps: int) -> dict:
    """Launches of one 576x1024, 25-frame video at SVD-XT widths, per the
    sites of each kernel: flash 21 per step (UNet down/up /8 /16 /32: 15,
    trunk down: 6), the FFN kernel 42 (the C=320/640 sites, spatial and
    temporal), softsplat 4 (the adapter's warp, once); spatial-major: 23
    temporal sites per step (UNet 16, trunk 7); classic: the 7 at /8 (UNet
    down 0 x2, up 3 x3, trunk down 0 x2) pass the short gate, the H=10/20
    ones have L*H > 160 and stay plain."""
    from mofa_tpu_torch import kernels
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(flash_attention=21 * steps, ln_geglu_ffn=42 * steps,
                softsplat=4)
    if layout == "tmajor":
        want["short_attention_tmajor"] = 23 * steps
    else:
        want["short_attention"] = 7 * steps
    return want


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
               brush=None, phase_times=None):
    """The traj app's generation: a seeded smooth image and seeded tracks
    -> PCHIP -> sparse flow at 384^2 -> CMP (full CMPConfig, seeded random
    weights, fp32) -> flow at (h, w) -> TrajPipeline with `bundle`. Returns
    (frames [T, H, W, 3], flow [1, T-1, H, W, 2], PhaseTimer)."""
    from mofa_tpu_torch.apps.loaders import load_cmp
    from mofa_tpu_torch.apps.traj_app import generate
    from mofa_tpu_torch.utils.profiling import PhaseTimer
    img, _ = smooth_inputs(1, 2, h, w, dev, seed=seed)
    timer = PhaseTimer(dev)
    frames, flow = generate(
        img[0], seeded_tracks(h, w, seed), lambda: load_cmp(None, dev, seed=seed),
        lambda: bundle, timer=timer, brush=brush, num_frames=t,
        num_inference_steps=steps, decode_chunk_size=MAIN["decode_chunk_size"],
        seed=seed + 1, phase_times=phase_times)
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
    return dict(launches=launches, median_step=median, cmp_flow=app["cmp_flow"])


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
    decode: device time by kernel name, top 25 (a breakdown, not a
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

    # 3b. the FFN variants at the main path's FF shapes
    log("[ffn_variants] ln_geglu_ffn variants, geglu_ffn and the stock chain,"
        " bf16, ms")
    ffn_launches = phase_ffn_variants(torch.device("cuda"))

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

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    extra = ("chain_ms", "ms_b50", "library_ms_b50", "bound_ms_b50")
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
