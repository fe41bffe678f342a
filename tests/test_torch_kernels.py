"""The port's kernel modules against the JAX package's Pallas kernels, on CPU.

On CPU every wrapper of `mofa_tpu_torch.kernels` runs its plain PyTorch
version (the CUDA kernels have no CPU mode). Each is checked against the
JAX Pallas kernel in interpret mode, exactly as the JAX package's own
tests run it, and against the JAX plain references, on the same numpy
inputs. Tolerances, fp32: 1e-5 absolute for attention and the splat,
1e-4 relative for the FFN. The CUDA kernels themselves are tested on a
GPU by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from mofa_tpu.kernels.flash_attention import flash_attention as j_flash
from mofa_tpu.kernels.geglu_ffn import _ln_ffn_fwd, _ln_ffn_ref
from mofa_tpu.kernels.short_attention import _tmajor_ref
from mofa_tpu.kernels.short_attention import short_attention_tmajor as j_tmajor
from mofa_tpu.kernels.softsplat import softsplat as j_softsplat
from mofa_tpu.kernels.softsplat import softsplat_oracle_np
from mofa_tpu.kernels.softsplat_pallas import splat_pallas

from mofa_tpu_torch import kernels
from mofa_tpu_torch.kernels.attention import (dot_product_attention,
                                              temporal_attention_tmajor)
from mofa_tpu_torch.kernels.conv_fused import gn_silu_conv3x3, gn_silu_tconv3
from mofa_tpu_torch.kernels.flash_attention import flash_attention
from mofa_tpu_torch.kernels.geglu_ffn import (fused_ffn_applicable, geglu_ffn,
                                              ln_geglu_ffn)
from mofa_tpu_torch.kernels.group_norm import fused_group_norm
from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                    short_attention_tmajor)
from mofa_tpu_torch.kernels.softsplat import softsplat, splat_raw
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ flash

@pytest.mark.parametrize("l,d", [(256, 64), (300, 64), (300, 128), (130, 128)])
def test_flash_matches_pallas_interpret(l, d):
    rng = np.random.RandomState(l + d)
    q, k, v = (rng.randn(2, l, 3, d).astype(np.float32) for _ in range(3))
    got = flash_attention(_t(q), _t(k), _t(v)).numpy()
    ref = _np(jax.jit(lambda a, b, c: j_flash(a, b, c, 128, 128, False))(q, k, v))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_dispatch_sends_big_spatial_sites_to_flash():
    rng = np.random.RandomState(1)
    small = _t(rng.randn(1, 20, 2, 64).astype(np.float32))
    big = _t(rng.randn(1, 576, 1, 64).astype(np.float32))
    # CPU: both run plain math, so the outputs equal the plain version
    for x in (small, big):
        np.testing.assert_allclose(dot_product_attention(x, x, x).numpy(),
                                   flash_attention(x, x, x).numpy(),
                                   rtol=0, atol=0)


# ----------------------------------------------------------------- tmajor

@pytest.mark.parametrize("b,nf,s,h,d", [(2, 7, 12, 2, 64), (1, 25, 6, 1, 128),
                                        (2, 4, 9, 3, 32)])
def test_tmajor_matches_pallas_interpret_and_ref(b, nf, s, h, d):
    rng = np.random.RandomState(nf * s)
    q, k, v = (rng.randn(b * nf, s, h * d).astype(np.float32) for _ in range(3))
    got = short_attention_tmajor(_t(q), _t(k), _t(v), nf, h).numpy()
    pallas, ref = (_np(a) for a in jax.jit(lambda a, b, c: (
        j_tmajor(a, b, c, nf, h, 0, False), _tmajor_ref(a, b, c, nf, h)))(q, k, v))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        temporal_attention_tmajor(_t(q), _t(k), _t(v), nf, h).numpy(), got,
        rtol=0, atol=0)


# -------------------------------------------------------------------- FFN

@pytest.mark.parametrize("c,rows", [(320, 512), (640, 256)])
def test_ln_geglu_ffn_matches_pallas_interpret_and_ref(c, rows):
    rng = np.random.RandomState(c)
    x = rng.randn(rows, c).astype(np.float32)
    ls = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    lb = (0.1 * rng.randn(c)).astype(np.float32)
    w0 = (rng.randn(c, 8 * c) / np.sqrt(c)).astype(np.float32)        # [in, out]
    b0 = (0.1 * rng.randn(8 * c)).astype(np.float32)
    w2 = (rng.randn(4 * c, c) / np.sqrt(4 * c)).astype(np.float32)
    b2 = (0.1 * rng.randn(c)).astype(np.float32)
    got = ln_geglu_ffn(_t(x), _t(ls), _t(lb), _t(w0.T), _t(b0), _t(w2.T),
                       _t(b2)).numpy()
    pallas, ref = (_np(a) for a in jax.jit(lambda *a: (
        _ln_ffn_fwd(*a, variant="plain"), _ln_ffn_ref(*a)))(x, ls, lb, w0, b0, w2, b2))
    # the Pallas kernel's erf is a 1.5e-7 polynomial; the port uses erf
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(got, pallas, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_ffn_dispatch_gate():
    assert fused_ffn_applicable(4096, 320, 320)
    assert fused_ffn_applicable(4097, 640, 640)       # ragged rows allowed
    assert not fused_ffn_applicable(4095, 320, 320)
    assert not fused_ffn_applicable(8192, 1280, 1280)
    assert not fused_ffn_applicable(8192, 320, 640)
    # widths the kernel is not built for stay plain on every device
    assert not fused_ffn_applicable(8192, 64, 64)
    assert not fused_ffn_applicable(8192, 384, 384)


# -------------------------------------------------------------- softsplat

def _splat_case(b=2, h=13, w=17, c=5, scale=4.0, seed=0):
    rng = np.random.RandomState(seed)
    inp = rng.randn(b, h, w, c).astype(np.float32)
    flow = ((rng.rand(b, h, w, 2) * 2 - 1) * scale).astype(np.float32)
    flow[0, 0, :4, 0] = 40.0                     # every tap out of bounds
    flow[1, 3, 2, :] = np.nan                    # non-finite: skipped
    flow[1, 5, 6, 1] = np.inf
    flow[0, 7, 1, 0] = -1.5                      # two taps out of bounds
    return inp, flow


def test_splat_raw_matches_pallas_interpret_and_oracle():
    inp, flow = _splat_case()
    got = splat_raw(_t(inp), _t(flow)).numpy()
    # the one-hot matmul turns a NaN weight into NaN sums (0 * NaN), so the
    # Pallas kernel gets the non-finite pixels as far out-of-bounds flow,
    # which drops all four taps just the same
    pallas = _np(jax.jit(splat_pallas)(inp, np.nan_to_num(flow, nan=1e9, posinf=1e9)))
    oracle = softsplat_oracle_np(inp, flow)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "avg", "linear", "soft",
                                  "avg-zeroeps", "linear-clipeps", "soft-addeps"])
def test_softsplat_modes_match_jax(mode):
    inp, flow = _splat_case(seed=3)
    metric = None
    if not mode.startswith(("sum", "avg")):
        metric = np.random.RandomState(4).rand(*inp.shape[:3], 1).astype(np.float32)
    got = softsplat(_t(inp), _t(flow), None if metric is None else _t(metric),
                    mode).numpy()
    ref = _np(jax.jit(lambda a, f, m: j_softsplat(a, f, m, mode))(inp, flow, metric))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _broadcast_case(seed, frames=3, c=6):
    """Two distinct source maps, each splatted along `frames` flows, and
    a metric in [0, 1); the flow as in _splat_case."""
    inp, flow = _splat_case(b=2 * frames, c=c, seed=seed)
    src = np.random.RandomState(seed + 1).randn(2, *inp.shape[1:]).astype(np.float32)
    metric = np.random.RandomState(seed + 2).rand(*flow.shape[:3], 1).astype(np.float32)
    return src, flow, metric, np.repeat(src, frames, axis=0)


@pytest.mark.parametrize("mode", ["sum", "avg", "linear", "soft"])
def test_softsplat_broadcast_source_matches_jax(mode):
    """frames_per_source = 3: the port splats each of two maps along three
    flows; JAX splats the expanded copy."""
    src, flow, metric, expanded = _broadcast_case(seed=11)
    m = None if mode in ("sum", "avg") else metric
    got = softsplat(_t(src), _t(flow), None if m is None else _t(m), mode,
                    frames_per_source=3).numpy()
    ref = _np(jax.jit(lambda a, f, mm: j_softsplat(a, f, mm, mode))(expanded, flow, m))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("metric_kind", ["ones", "metric"])
def test_splat_norm_plane_matches_pallas_interpret(metric_kind):
    """The raw splat with its normaliser plane, from a broadcast source:
    the sums of (x * m) * w and the plane of m * w against the Pallas
    kernel (interpret mode) on the JAX wrapper's concatenated [x * m, m]."""
    src, flow, metric, expanded = _broadcast_case(seed=12)
    m = np.ones_like(metric) if metric_kind == "ones" else metric
    acc, norm = splat_raw(_t(src), _t(flow),
                          None if metric_kind == "ones" else _t(m), 3,
                          with_norm=True)
    cat = np.concatenate([expanded * m, m], axis=-1)
    pallas = _np(jax.jit(splat_pallas)(cat, np.nan_to_num(flow, nan=1e9, posinf=1e9)))
    np.testing.assert_allclose(acc.numpy(), pallas[..., :-1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(norm.numpy(), pallas[..., -1], rtol=0, atol=1e-5)


# ------------------------------------------------------ device discipline

def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    kernels.reset_launch_counts()
    x = torch.randn(1, 600, 1, 64)
    flash_attention(x, x, x)
    q2 = torch.randn(4, 3, 128)
    short_attention_tmajor(q2, q2, q2, 2, 2)
    c = 320
    ffn = (torch.randn(4100, c), torch.ones(c), torch.zeros(c),
           torch.randn(8 * c, c), torch.zeros(8 * c), torch.randn(c, 4 * c),
           torch.zeros(c))
    for variant in ("plain", "ilv", "pipe", "tanh"):
        ln_geglu_ffn(*ffn, variant=variant)
    geglu_ffn(ffn[0], *ffn[3:])
    softsplat(torch.randn(1, 4, 4, 3), torch.zeros(1, 4, 4, 2))
    q4 = torch.randn(16, 25, 5, 64)
    short_attention(q4, q4, q4)
    x = torch.randn(2, 8, 8, 64)
    a, w3 = torch.ones(2, 64), torch.randn(3, 3, 64, 64)
    fused_group_norm(x, torch.ones(64), torch.zeros(64), 32)
    gn_silu_conv3x3(x, a, a, w3, torch.zeros(64), emit_sums=True)
    gn_silu_tconv3(x, a, a, w3[0], torch.zeros(64))
    assert kernels.launch_counts() == dict.fromkeys(
        ("flash_attention", "short_attention_tmajor", "short_attention",
         "ln_geglu_ffn", "softsplat", "channel_sums", "gn_silu_conv3x3",
         "gn_silu_tconv3", "geglu_ffn", "ln_geglu_ffn_ilv",
         "ln_geglu_ffn_pipe", "ln_geglu_ffn_tanh"), 0)


def test_flash_counts_its_launches_by_shape(monkeypatch):
    """On a card (use_kernel forced True, the launch a no-op) flash counts
    each launch once under its name and once under its [B, L, H, D]; a
    reset clears both."""
    from mofa_tpu_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "use_kernel", lambda *t: True)
    monkeypatch.setattr("mofa_tpu_torch.kernels._build.launch", lambda *a: 0)
    kernels.reset_launch_counts()
    for shape in ((2, 600, 1, 64), (1, 576, 2, 128), (2, 600, 1, 64)):
        q = torch.zeros(*shape, dtype=torch.bfloat16)
        flash_attention(q, q, q)
    assert kernels.launch_counts()["flash_attention"] == 3
    assert kernels.launch_counts_by_shape("flash_attention") == {
        (2, 600, 1, 64): 2, (1, 576, 2, 128): 1}
    assert kernels.launch_counts_by_shape("softsplat") == {}
    kernels.reset_launch_counts()
    assert kernels.launch_counts_by_shape("flash_attention") == {}


def test_devices_without_a_kernel_or_plain_path_raise():
    x = torch.empty(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(x, x, x)
    with pytest.raises(ValueError):
        kernels.use_kernel(torch.zeros(1), x)       # mixed devices


def test_dispatch_sends_a_kernel_only_the_sites_it_takes(monkeypatch):
    """Tensors that pretend to lie on a card (use_kernel -> True): the
    dispatch must route the micro test widths (D = 16), which the kernels
    do not take, to plain PyTorch instead of a wrapper that would raise, and
    still route the SVD-XT widths (D = 64) to the kernels (which cannot be
    built here, so reaching one raises)."""
    from mofa_tpu_torch.kernels import flash_attention as fa
    from mofa_tpu_torch.kernels import short_attention as sa
    from mofa_tpu_torch.kernels.flash_attention import attention_plain
    from mofa_tpu_torch.kernels.short_attention import tmajor_plain
    for mod in (fa, sa):
        monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
    monkeypatch.setattr("mofa_tpu_torch.kernels._build.launch",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("launch")))
    q = torch.randn(1, 600, 2, 16)                 # flash-sized, D = 16
    torch.testing.assert_close(dot_product_attention(q, q, q),
                               attention_plain(q, q, q), rtol=0, atol=0)
    q2 = torch.randn(6, 10, 2 * 16)                # T = 3, D = 16
    torch.testing.assert_close(temporal_attention_tmajor(q2, q2, q2, 3, 2),
                               tmajor_plain(q2, q2, q2, 3, 2), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="launch"):
        dot_product_attention(*(torch.randn(1, 600, 1, 64),) * 3)
    with pytest.raises(RuntimeError, match="launch"):
        temporal_attention_tmajor(*(torch.randn(6, 10, 2 * 64),) * 3, 3, 2)


def test_plain_reference_context_nests_and_restores():
    assert kernels._plain_depth == 0
    with kernels.plain_reference():
        with kernels.plain_reference():
            assert kernels._plain_depth == 2
        assert kernels._plain_depth == 1
    assert kernels._plain_depth == 0
