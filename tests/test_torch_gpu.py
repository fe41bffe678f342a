"""The port's CUDA kernels against their plain versions, on a GPU only.

Needs neither JAX nor mofa_tpu, so it runs where only the port is
installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite.)
Elsewhere it skips. chip_smoke.py makes the same comparison at the main
path's shapes; this test uses small ones, including ragged sizes.
"""

import pytest
import torch

from mofa_tpu_torch import kernels
from mofa_tpu_torch.kernels.conv_fused import (conv3x3_gemm, gn_silu_act,
                                               gn_silu_conv3x3, gn_silu_tconv3,
                                               tconv3_gemm)
from mofa_tpu_torch.kernels.flash_attention import flash_attention
from mofa_tpu_torch.kernels.geglu_ffn import (ffn_gemm_gate, ffn_gemm_out,
                                              ffn_ln_rows, geglu_ffn, ln_geglu_ffn)
from mofa_tpu_torch.kernels.group_norm import channel_sums
from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                    short_attention_tmajor)
from mofa_tpu_torch.kernels.softsplat import softsplat, splat_raw


@pytest.mark.gpu
def test_kernels_on_card():
    """CUDA kernels vs their plain versions on small shapes (GPU only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    # fp32: max |diff| <= 1e-4 * max(1, max |ref|), other summation order.
    # bf16: max |diff| <= 2e-2 * max |ref| and ||diff|| / ||ref|| <= 1e-2,
    # the loosest of chip_smoke.py's TOL_BF16 bounds (bf16 outputs and
    # roundings at other points; attention outputs are far below 1, so the
    # bounds scale with the reference).
    for dt, tol, rms_tol in ((torch.float32, 1e-4, None),
                             (torch.bfloat16, 2e-2, 1e-2)):
        q, k, v = (rn(2, 700, 3, 64).to(dt) for _ in range(3))
        q2, k2, v2 = (rn(14, 50, 3 * 128).to(dt) for _ in range(3))
        x = rn(5000, 320).to(dt)
        w0, w2 = (rn(2560, 320) / 18).to(dt), (rn(320, 1280) / 36).to(dt)
        b0, b2 = rn(2560).to(dt), rn(320).to(dt)
        ls, lb = rn(320) + 1, rn(320)
        qs, ks, vs = (rn(37, 25, 2, 128).to(dt) for _ in range(3))
        x3 = (rn(3, 1000, 96) + 0.5).to(dt)
        calls = [lambda: flash_attention(q, k, v),
                 lambda: short_attention_tmajor(q2, k2, v2, 7, 3),
                 lambda: short_attention(qs, ks, vs),
                 lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2),
                 lambda: torch.cat(channel_sums(x3), -1)]
        if dt == torch.float32:
            calls.append(lambda: splat_raw(rn(3, 9, 11, 5), rn(3, 9, 11, 2) * 3))
        else:
            # the fused convs take bf16 only; ragged tiles (5*7 and 3*35
            # output pixels), temb, residual and the output sums
            xc, xt = rn(2, 5, 7, 64).to(dt), rn(2, 3, 35, 64).to(dt)
            a, b = rn(2, 64) * 0.3 + 1, rn(2, 64) * 0.2
            w3, wt = (rn(3, 3, 64, 128) / 24).to(dt), (rn(3, 64, 128) / 14).to(dt)
            bias = rn(128)
            conv = lambda: gn_silu_conv3x3(xc, a, b, w3, bias, rn(2, 128),
                                           rn(2, 5, 7, 128).to(dt), emit_sums=True)
            # the FFN kernels that take bf16 only, on the ragged 5000 rows
            calls += [lambda: geglu_ffn(x, w0, b0, w2, b2)] + [
                lambda v=v: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2, variant=v)
                for v in ("ilv", "pipe", "tanh")]
            calls += [lambda: conv()[0], lambda: torch.cat(conv()[1:], -1),
                      lambda: gn_silu_tconv3(xt, a, b, wt, bias, rn(2, 3, 128),
                                             rn(2, 3, 35, 128).to(dt), silu=False)]
        for fn in calls:
            state = g.get_state()
            got = fn()
            g.set_state(state)
            with kernels.plain_reference():
                ref = fn()
            diff, ref = got.float() - ref.float(), ref.float()
            ref_max = ref.abs().max().item()
            if rms_tol is None:
                assert diff.abs().max().item() <= tol * max(1.0, ref_max)
            else:
                assert diff.abs().max().item() <= tol * ref_max
                assert (diff.norm() / ref.norm()).item() <= rms_tol


def _assert_like_plain(fn, dt):
    """fn() through the kernel against fn() inside plain_reference(), with
    test_kernels_on_card's bounds."""
    got = fn()
    with kernels.plain_reference():
        ref = fn()
    torch.cuda.synchronize()
    diff, ref = got.float() - ref.float(), ref.float()
    assert torch.isfinite(got).all()
    if dt == torch.float32:
        assert diff.abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    else:
        assert diff.abs().max().item() <= 2e-2 * ref.abs().max().item()
        assert (diff.norm() / ref.norm()).item() <= 1e-2


def _card(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *s: torch.randn(*s, generator=g, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("length", [576, 1000, 2304])
def test_flash_on_card(length, d, dt):
    """The wgmma flash kernel (bf16; fp32 its FMA path) at whole and ragged
    128-key tiles, both head widths, against its plain version."""
    rn = _card(length + d)
    q, k, v = (rn(2, length, 3, d).to(dt) for _ in range(3))
    kernels.reset_launch_counts()
    _assert_like_plain(lambda: flash_attention(q, k, v), dt)
    assert kernels.launch_counts()["flash_attention"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("slots", [1, 144])
@pytest.mark.parametrize("frames", [1, 8, 25, 32])
def test_short_body_on_card(frames, slots, dt):
    """The tensor-core short-attention body in both layouts: tmajor at S
    slots (5 heads of 64), and classic at an odd count of sequences (2111 x
    3 heads of 128: 6333 tasks, more than the walk's warps and not a
    multiple of them, so the walks end ragged)."""
    rn = _card(frames * 1000 + slots)
    q2, k2, v2 = (rn(3 * frames, slots, 5 * 64).to(dt) for _ in range(3))
    qs, ks, vs = (rn(2111, frames, 3, 128).to(dt) for _ in range(3))
    kernels.reset_launch_counts()
    _assert_like_plain(lambda: short_attention_tmajor(q2, k2, v2, frames, 5), dt)
    _assert_like_plain(lambda: short_attention(qs, ks, vs), dt)
    counts = kernels.launch_counts()
    assert counts["short_attention_tmajor"] == counts["short_attention"] == 1


_FFN_NAMES = {"plain": "ln_geglu_ffn", "tanh": "ln_geglu_ffn_tanh",
              "ilv": "ln_geglu_ffn_ilv", "pipe": "ln_geglu_ffn_pipe",
              "geglu_ffn": "geglu_ffn"}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(_FFN_NAMES))
@pytest.mark.parametrize("c", [320, 640])
@pytest.mark.parametrize("rows", [4096, 4096 + 7, 16384 + 1])
def test_ffn_route_on_card(rows, c, kind):
    """The bf16 FFN route (LN pass, gate GEMM, out GEMM on wgmma) against
    its plain version at whole and ragged row tiles, one launch count per
    call; then each stage alone against its plain stage: h from the gate
    GEMM (in the variant's schedule) on the kernel's own xn, and the out
    GEMM on it. The ilv schedule's blocks walk pair tiles (two 64-row
    tiles a cluster of two blocks); with the 66 clusters of an H100 five
    of the six shapes here leave blocks an odd tile count (4103 rows, C =
    320: 330 pair tiles, 5 a cluster), so one warpgroup has no last tile."""
    rn = _card(rows + c)
    bf = torch.bfloat16
    x = rn(rows, c).to(bf)
    ls, lb = rn(c) * 0.2 + 1, rn(c) * 0.2
    w0, b0 = (rn(8 * c, c) * c ** -0.5).to(bf), (rn(8 * c) * 0.1).to(bf)
    w2, b2 = (rn(c, 4 * c) * (4 * c) ** -0.5).to(bf), (rn(c) * 0.1).to(bf)
    gelu = "tanh" if kind == "tanh" else "none"
    kernels.reset_launch_counts()
    if kind == "geglu_ffn":
        _assert_like_plain(lambda: geglu_ffn(x, w0, b0, w2, b2), bf)
    else:
        _assert_like_plain(lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2,
                                                variant=kind), bf)
    counts = kernels.launch_counts()
    assert counts[_FFN_NAMES[kind]] == 1 and sum(counts.values()) == 1
    with torch.no_grad():
        xn = x if kind == "geglu_ffn" else ffn_ln_rows(x, ls, lb)
    if kind != "geglu_ffn":
        _assert_like_plain(lambda: ffn_ln_rows(x, ls, lb), bf)
    schedule = kind if kind in ("ilv", "pipe") else "plain"
    _assert_like_plain(lambda: ffn_gemm_gate(xn, w0, b0, gelu, schedule), bf)
    h = ffn_gemm_gate(xn, w0, b0, gelu, schedule)
    resid = None if kind == "geglu_ffn" else x
    _assert_like_plain(lambda: ffn_gemm_out(h, w2, b2, resid), bf)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["plain", "ilv", "pipe"])
@pytest.mark.parametrize("c", [320, 640])
@pytest.mark.parametrize("rows", [129, 64 * 132 * 3 + 1])
def test_gate_schedules_on_card(rows, c, schedule):
    """Each gate GEMM schedule alone against `ffn_gemm_gate_plain`, where a
    block has one tile (129 rows: fewer pair tiles than clusters, so ilv's
    second warpgroup has none, pipe only drains, and a cluster's second
    block may hold rows past M only) and where the last row tile is ragged
    and the blocks' tile counts differ; no launch is counted."""
    rn = _card(rows + c + len(schedule))
    bf = torch.bfloat16
    xn = rn(rows, c).to(bf)
    w0, b0 = (rn(8 * c, c) * c ** -0.5).to(bf), (rn(8 * c) * 0.1).to(bf)
    kernels.reset_launch_counts()
    _assert_like_plain(lambda: ffn_gemm_gate(xn, w0, b0, schedule=schedule), bf)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "avg", "linear-zeroeps", "soft-clipeps"])
@pytest.mark.parametrize("c,dt", [(320, torch.bfloat16), (64, torch.float32),
                                  (6, torch.bfloat16), (5, torch.float32)])
def test_softsplat_on_card(c, dt, mode):
    """The splat (vector reductions at C % 4 == 0, scalar ones otherwise)
    and its normalising pass, from a source broadcast over 3 frames each
    (two distinct sources), with out-of-bounds and non-finite flow, against
    the plain version: the raw sums and the normaliser plane in fp32, then
    the whole mode in the source dtype; one launch count per call."""
    rn = _card(c + len(mode))
    src = rn(2, 9, 13, c).to(dt)
    flow = rn(6, 9, 13, 2) * 3
    flow[:, 0, :, 0] = -40.0
    flow[1, 2, ::3, 1] = float("nan")
    metric = rn(6, 9, 13, 1).abs()
    m = None if mode in ("sum", "avg") else metric
    kernels.reset_launch_counts()
    acc, norm = splat_raw(src, flow, metric, 3, with_norm=True)
    with kernels.plain_reference():
        ref_acc, ref_norm = splat_raw(src, flow, metric, 3, with_norm=True)
    for got, ref in ((acc, ref_acc), (norm, ref_norm)):
        assert (got - ref).abs().max().item() <= 1e-5 * max(1.0, ref.abs().max().item())
    _assert_like_plain(lambda: softsplat(src, flow, m, mode, frames_per_source=3), dt)
    assert kernels.launch_counts()["softsplat"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,c,o", [(2, 5, 7, 64, 128), (3, 12, 40, 96, 192),
                                       (1, 33, 64, 320, 320), (2, 9, 128, 32, 64),
                                       (1, 4, 200, 640, 640)])
def test_conv3x3_route_on_card(n, h, w, c, o):
    """The 3x3 route: the activation pass and the wgmma implicit GEMM
    (output-channel tiles of 160, 128 and 64; pixel tiles of 8 to 128
    columns, ragged at the image's edge; channels past C zero-filled at C =
    96 and 32), each stage alone and composed, with and without SiLU, temb,
    residual and the sums, against their plain versions; one launch count
    per call of the route, none for the stages."""
    rn = _card(n * h * w + c + o)
    bf = torch.bfloat16
    x = (rn(n, h, w, c) * 1.5).to(bf)
    a, b = rn(n, c) * 0.3 + 1, rn(n, c) * 0.2
    wk = (rn(3, 3, c, o) / (3 * c ** 0.5)).to(bf)
    bias, temb, res = rn(o) * 0.1, rn(n, o) * 0.3, rn(n, h, w, o).to(bf)
    kernels.reset_launch_counts()
    for silu in (True, False):
        _assert_like_plain(lambda: gn_silu_act(x, a, b, silu), bf)
    y = gn_silu_act(x, a, b)
    _assert_like_plain(lambda: conv3x3_gemm(y, wk, bias, temb, res), bf)
    assert sum(kernels.launch_counts().values()) == 0
    full = lambda: gn_silu_conv3x3(x, a, b, wk, bias, temb, res, emit_sums=True)
    for i in range(3):                  # the output, then each of its sums
        _assert_like_plain(lambda: full()[i], bf)
    _assert_like_plain(lambda: gn_silu_conv3x3(x, a, b, wk, bias, silu=False), bf)
    counts = kernels.launch_counts()
    assert counts["gn_silu_conv3x3"] == 4 and sum(counts.values()) == 4


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,s,c,o", [(2, 5, 200, 64, 128), (2, 3, 35, 96, 192),
                                       (1, 25, 300, 320, 320), (2, 7, 130, 32, 64),
                                       (1, 4, 1000, 640, 640)])
def test_tconv3_route_on_card(n, t, s, c, o):
    """The temporal route: the activation pass and the 3-tap wgmma GEMM
    (output-channel tiles of 128, 64 and 160; zero frames beyond both ends;
    ragged T and S; pixel tiles of TH frames x TW positions, so that a tile
    spans frames and each row reads temb at its own frame; channels past C
    zero-filled at C = 96 and 32), the GEMM alone and the route composed,
    in both epilogue forms (temb and the sums; the residual) and without
    SiLU, against their plain versions; one launch count per call of the
    route, none for the stages."""
    rn = _card(n * t * s + c + o)
    bf = torch.bfloat16
    x = (rn(n, t, s, c) * 1.5).to(bf)
    a, b = rn(n, c) * 0.3 + 1, rn(n, c) * 0.2
    wk = (rn(3, c, o) * 1.7 / (3 * c) ** 0.5).to(bf)
    bias, temb, res = rn(o) * 0.1, rn(n, t, o) * 0.3, rn(n, t, s, o).to(bf)
    kernels.reset_launch_counts()
    y = gn_silu_act(x, a, b)
    _assert_like_plain(lambda: tconv3_gemm(y, wk, bias, residual=res), bf)
    for i in range(3):                  # the output, then each of its sums
        _assert_like_plain(lambda: tconv3_gemm(y, wk, bias, temb, emit_sums=True)[i], bf)
    assert sum(kernels.launch_counts().values()) == 0
    full = lambda: gn_silu_tconv3(x, a, b, wk, bias, temb, emit_sums=True)
    for i in range(3):
        _assert_like_plain(lambda: full()[i], bf)
    _assert_like_plain(lambda: gn_silu_tconv3(x, a, b, wk, bias, residual=res), bf)
    _assert_like_plain(lambda: gn_silu_tconv3(x, a, b, wk, bias, silu=False), bf)
    counts = kernels.launch_counts()
    assert counts["gn_silu_tconv3"] == 5 and sum(counts.values()) == 5


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_ldmk_encode_features_on_card(dt):
    """The landmark adapter's feature stack (warps through the softsplat
    kernel, occlusion matting, landmark embedding) at the micro widths,
    128x192, T=5, against the same call inside plain_reference(): every
    inject tensor and occlusion mask within test_kernels_on_card's bounds;
    4 softsplat launches (one a scale)."""
    from mofa_tpu_torch.models.mofa_adapter import LdmkFlowControlNet
    from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
    from mofa_tpu_torch.pipelines.common import init_random_
    rn = _card(21)
    g = torch.Generator(device="cuda").manual_seed(22)
    with torch.device("cuda"):
        cn = init_random_(LdmkFlowControlNet(MICRO_UNET_CONFIG), g).to(dt).eval()
    cond, flow = rn(1, 128, 192, 3).to(dt), (rn(1, 4, 128, 192, 2) * 6).to(dt)
    lm = rn(1, 5, 128, 192, 3).sigmoid().to(dt)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False       # fp32 convs on both routes
    try:
        with torch.no_grad():
            kernels.reset_launch_counts()
            got = cn.encode_features(cond, flow, lm)
            counts = kernels.launch_counts()
            with kernels.plain_reference():
                ref = cn.encode_features(cond, flow, lm)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert counts["softsplat"] == 4 and sum(counts.values()) == 4
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        assert a.shape == b.shape and torch.isfinite(a).all()
        diff, b = a.float() - b.float(), b.float()
        if dt == torch.float32:
            assert diff.abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item())
        else:
            assert diff.abs().max().item() <= 2e-2 * b.abs().max().item()
            assert (diff.norm() / b.norm()).item() <= 1e-2


@pytest.mark.gpu
def test_keypoint_window_step_on_card():
    """One step of the windowed KeypointPipeline at the micro widths,
    128x192, 7 frames in windows of 4 at stride 2 (3 views, the last
    ragged), fp32, on the card, with window_batch 1 and 2 (one padded
    group), each against the same call inside plain_reference(), and 2
    against 1: the micro sites take no attention or FFN kernel, so the
    softsplat warps (4 a view, each view encoded once) and the batch's
    algorithms are what differ. Bound: 1e-4 of the latents' scale plus 8
    ulps of the first Euler step's operands (sigma_0 * max |latents|),
    where every route rounds."""
    from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
    from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
    from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
    from mofa_tpu_torch.ops.euler import make_euler_schedule
    from mofa_tpu_torch.pipelines.common import ModelBundle
    from mofa_tpu_torch.pipelines.keypoint import KeypointPipeline
    rn = _card(23)
    clip = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                            num_heads=2, patch_size=16, image_size=48, projection_dim=32)
    bundle = ModelBundle.init_random("cuda", torch.Generator(device="cuda").manual_seed(24),
                                     MICRO_UNET_CONFIG, TINY_VAE_CONFIG, clip, ldmk=True)
    t, h, w = 7, 128, 192
    image = rn(1, h, w, 3).sigmoid()
    flow, lm = rn(1, t - 1, h, w, 2) * 4, rn(1, t, h, w, 3).sigmoid()
    lat = rn(1, t, h // 8, w // 8, 4)
    run = lambda vb: KeypointPipeline(bundle)(
        image, flow, lm, window_size=4, stride=2, num_inference_steps=1,
        noise_aug_strength=0.0, latents=lat, output_type="latent",
        window_batch=vb)[0]
    import numpy as np
    sigma0 = float(make_euler_schedule(1).init_noise_sigma)
    floor = float(np.spacing(np.float32(sigma0 * lat.abs().max().item())))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False       # fp32 convs on every route
    got = {}
    try:
        for vb in (1, 2):
            kernels.reset_launch_counts()
            got[vb] = run(vb)
            counts = kernels.launch_counts()
            with kernels.plain_reference():
                ref = run(vb)
            torch.cuda.synchronize()
            assert counts["softsplat"] == 12 and sum(counts.values()) == 12
            assert got[vb].shape == (1, t, h // 8, w // 8, 4)
            assert torch.isfinite(got[vb]).all()
            atol = 1e-4 * ref.abs().max().item() + 8 * floor
            assert (got[vb] - ref).abs().max().item() <= atol, vb
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    atol = 1e-4 * got[1].abs().max().item() + 8 * floor
    assert (got[2] - got[1]).abs().max().item() <= atol


@pytest.mark.gpu
def test_kernels_raise_under_grad():
    """A kernel without a backward: on a card, its wrapper raises when grad
    is enabled and an input requires grad, and launches under no_grad. The
    training path's kernels launch under grad as well."""
    rn = _card(5)
    bf = torch.bfloat16
    q = rn(2 * 25, 16, 2, 64).to(bf).requires_grad_()
    x = rn(4096, 320).to(bf).requires_grad_()
    ls, lb = rn(320) + 1, rn(320)
    w0, b0 = (rn(2560, 320) / 18).to(bf), rn(2560).to(bf)
    w2, b2 = (rn(320, 1280) / 36).to(bf), rn(320).to(bf)
    xc, a = rn(2, 8, 8, 64).to(bf).requires_grad_(), rn(2, 64)
    w3, bias = (rn(3, 3, 64, 64) / 24).to(bf), rn(64)
    calls = {"short_attention": lambda: short_attention(q, q, q),
             "ln_geglu_ffn_tanh": lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2,
                                                       variant="tanh"),
             "gn_silu_conv3x3": lambda: gn_silu_conv3x3(xc, a, a, w3, bias)}
    kernels.reset_launch_counts()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name}.*no backward"):
            call()
    assert sum(kernels.launch_counts().values()) == 0
    with torch.no_grad():
        for call in calls.values():
            call()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert all(counts[name] == 1 for name in calls)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_path_kernels_backward_on_card(dt):
    """The training path's four kernels under autograd at micro widths:
    each gradient (kernel forward, stock backward) against plain autograd
    through the plain version on the same inputs, one launch each."""
    rn = _card(6)
    big = dt == torch.float32
    tol = 2e-3 if big else 3e-2

    def grads(fn, inputs, weight):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        (out.float() * weight).sum().backward()
        return [t.grad.float() for t in leaves]

    def close(got, ref):
        for g_, r_ in zip(got, ref):
            assert (g_ - r_).norm() <= tol * r_.norm() + 1e-6

    q, k, v = (rn(2, 600, 2, 64).to(dt) for _ in range(3))
    q2, k2, v2 = (rn(2 * 7, 40, 2 * 64).to(dt) for _ in range(3))
    x = rn(4096, 320).to(dt)
    ffn = [x, rn(320) + 1, rn(320), rn(2560, 320) / 18, rn(2560),
           rn(320, 1280) / 36, rn(320)]
    ffn = ffn[:3] + [t.to(dt) for t in ffn[3:]]
    src, flow = rn(1, 12, 16, 64).to(dt), rn(3, 12, 16, 2) * 3
    cases = {
        "flash_attention": (flash_attention, (q, k, v), rn(2, 600, 2, 64)),
        "short_attention_tmajor": (lambda *a: short_attention_tmajor(*a, 7, 2),
                                   (q2, k2, v2), rn(2 * 7, 40, 128)),
        "ln_geglu_ffn": (ln_geglu_ffn, ffn, rn(4096, 320)),
        "softsplat": (lambda s, f: softsplat(s, f, None, "avg", 3), (src, flow),
                      rn(3, 12, 16, 64))}
    for name, (fn, inputs, weight) in cases.items():
        kernels.reset_launch_counts()
        got = grads(fn, inputs, weight)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == 1, name
        with kernels.plain_reference():
            ref = grads(fn, inputs, weight)
        close(got, ref)


@pytest.mark.gpu
def test_tiny_traj_app_on_card(tmp_path):
    """traj_app on its default device at the micro widths, whose attention
    sites (D = 16) no kernel takes: the dispatch keeps them plain PyTorch on
    the card instead of raising (GPU only; PIL reads and writes the files)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the app's default device")
    import json

    import numpy as np
    from mofa_tpu_torch.apps import traj_app
    image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    image.fromarray((rng.rand(70, 140, 3) * 255).astype(np.uint8)).save(tmp_path / "in.png")
    (tmp_path / "t.json").write_text(json.dumps(
        {"tracks": [[[10, 10], [20, 15], [30, 30]], [[100, 40], [90, 30]]]}))
    out = tmp_path / "out.gif"
    traj_app.main(["--image", str(tmp_path / "in.png"), "--tracks",
                   str(tmp_path / "t.json"), "--tiny", "--num_frames", "3",
                   "--num_inference_steps", "2", "--target_size", "64",
                   "--output", str(out)])
    assert out.stat().st_size > 0
