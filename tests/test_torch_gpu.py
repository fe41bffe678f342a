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
from mofa_tpu_torch.kernels.conv_fused import gn_silu_conv3x3, gn_silu_tconv3
from mofa_tpu_torch.kernels.flash_attention import flash_attention
from mofa_tpu_torch.kernels.geglu_ffn import (ffn_gemm_gate, ffn_gemm_out,
                                              ffn_ln_rows, geglu_ffn, ln_geglu_ffn)
from mofa_tpu_torch.kernels.group_norm import channel_sums
from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                    short_attention_tmajor)
from mofa_tpu_torch.kernels.softsplat import splat_raw


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
              "geglu_ffn": "geglu_ffn"}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(_FFN_NAMES))
@pytest.mark.parametrize("c", [320, 640])
@pytest.mark.parametrize("rows", [4096, 4096 + 7, 16384 + 1])
def test_ffn_route_on_card(rows, c, kind):
    """The bf16 FFN route (LN pass, gate GEMM, out GEMM on wgmma) against
    its plain version at whole and ragged 128-row tiles, one launch count
    per call; then each stage alone against its plain stage: h from the
    gate GEMM on the kernel's own xn, and the out GEMM on it."""
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
    _assert_like_plain(lambda: ffn_gemm_gate(xn, w0, b0, gelu), bf)
    h = ffn_gemm_gate(xn, w0, b0, gelu)
    resid = None if kind == "geglu_ffn" else x
    _assert_like_plain(lambda: ffn_gemm_out(h, w2, b2, resid), bf)


@pytest.mark.gpu
def test_kernels_raise_under_grad():
    """The kernels are forward only: on a card, a wrapper raises when grad
    is enabled and an input requires grad, and launches under no_grad."""
    rn = _card(5)
    bf = torch.bfloat16
    q = rn(1, 600, 2, 64).to(bf).requires_grad_()
    x = rn(4096, 320).to(bf).requires_grad_()
    ls, lb = rn(320) + 1, rn(320)
    w0, b0 = (rn(2560, 320) / 18).to(bf), rn(2560).to(bf)
    w2, b2 = (rn(320, 1280) / 36).to(bf), rn(320).to(bf)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="flash_attention.*forward only"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="ln_geglu_ffn.*forward only"):
        ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2)
    assert sum(kernels.launch_counts().values()) == 0
    with torch.no_grad():
        flash_attention(q, q, q)
        ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == counts["ln_geglu_ffn"] == 1


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
