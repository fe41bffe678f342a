"""The port's GroupNorm-statistics and fused GN-SiLU-conv modules against
the JAX package's Pallas kernels, on CPU, in fp32 and (the convs) in bf16.

On CPU the wrappers of `mofa_tpu_torch.kernels.group_norm` and
`.conv_fused` run their plain PyTorch versions; each is held against the
JAX Pallas kernel in interpret mode (as tests/test_group_norm_kernel.py and
tests/test_conv_fused.py run it) and against the JAX plain references, on
the same numpy inputs. Tolerances are fp32 summation-order bounds: 2e-5
for GroupNorm (sums over at most 2048 x 64 values), 1e-4 of the output's
magnitude for the convolutions (K = 9 x 32 products per output), and the
sums 5e-4 relative (sums of up to 1280 squared outputs), as in those JAX
tests. In bf16 the convs must round where the JAX kernels do (w, bias and
temb rounded to bf16, the conv summed in fp32, one rounding at the end):
at most 0.1% of the outputs may differ from the kernel's, none by more than
one bf16 ulp (fp32 summation order moves a sum across a rounding boundary
now and then). The CUDA kernels are checked on a GPU by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.kernels.conv_fused import (_fused_tconv_fwd, _ref_chain,
                                         _tref_chain)
from mofa_tpu.kernels.conv_fused import gn_silu_conv3x3 as j_conv
from mofa_tpu.kernels.conv_fused import gn_silu_tconv3 as j_tconv
from mofa_tpu.kernels.group_norm import _gn_ref
from mofa_tpu.kernels.group_norm import channel_sums as j_channel_sums
from mofa_tpu.kernels.group_norm import fused_group_norm as j_fused_gn

from mofa_tpu_torch.kernels import conv_fused
from mofa_tpu_torch.kernels._build import _SIGNATURES
from mofa_tpu_torch.kernels.conv_fused import (conv3x3_gemm,
                                               fused_conv_applicable,
                                               fused_tconv_applicable,
                                               gn_silu_act, gn_silu_conv3x3,
                                               gn_silu_tconv3, tconv3_gemm)
from mofa_tpu_torch.kernels.group_norm import (channel_sums, fused_group_norm,
                                               group_norm_plain)
from mofa_tpu_torch import kernels
from tests.torch_port_util import one_torch_thread  # noqa: F401 (autouse)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, ref, rel):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1.0))


# ------------------------------------------------------------- GroupNorm

@pytest.mark.parametrize("shape,groups", [
    ((3, 16, 16, 64), 32),
    ((2, 5, 8, 8, 64), 32),     # temporal layout [B, T, H, W, C]
    ((2, 96, 320), 32),
    ((1, 2048, 128), 8),
])
def test_channel_sums_and_group_norm_match_pallas_interpret(shape, groups):
    rng = np.random.RandomState(len(shape) * shape[-1])
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    c = shape[-1]
    scale = (rng.randn(c) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    x3 = x.reshape(shape[0], -1, c)
    s1, s2 = channel_sums(_t(x3))
    j1, j2 = j_channel_sums(_j(x3))
    # fp32 sums of up to 2048 values of magnitude ~5: relative 2e-6
    np.testing.assert_allclose(s1.numpy(), _np(j1), rtol=2e-6,
                               atol=2e-6 * np.abs(_np(j1)).max())
    np.testing.assert_allclose(s2.numpy(), _np(j2), rtol=2e-6, atol=0)
    got = fused_group_norm(_t(x), _t(scale), _t(bias), groups, 1e-5).numpy()
    pallas = _np(j_fused_gn(_j(x), _j(scale), _j(bias), groups, 1e-5))
    ref = _np(_gn_ref(_j(x), _j(scale), _j(bias), groups, 1e-5))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    plain = group_norm_plain(_t(x), _t(scale), _t(bias), groups, 1e-5).numpy()
    np.testing.assert_allclose(plain, ref, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ fused convs

def _conv_case(n=2, h=12, w=16, c=32, o=48, seed=0, temb=False, res=False):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    x = f(n, h, w, c) * 1.5
    a = f(n, c) * 0.3 + 1.0
    b = f(n, c) * 0.2
    wk = f(3, 3, c, o) * 0.05
    bias = f(o) * 0.1
    tb = f(n, o) * 0.2 if temb else None
    rr = f(n, h, w, o) if res else None
    return x, a, b, wk, bias, tb, rr


@pytest.mark.parametrize("h,silu", [(12, True), (36, True), (4, False)])
def test_conv3x3_matches_pallas_interpret(h, silu):
    x, a, b, w, bias, _, _ = _conv_case(h=h, seed=h)
    got = gn_silu_conv3x3(_t(x), _t(a), _t(b), _t(w), _t(bias), silu=silu)
    args = [_j(v) for v in (x, a, b, w, bias)]
    _close(got, j_conv(*args, None, None, silu, False), 1e-4)
    _close(got, _ref_chain(*args, None, None, silu), 1e-4)


def test_conv3x3_epilogues_and_sums_match_pallas_interpret():
    case = _conv_case(temb=True, res=True, seed=1)
    out, s1, s2 = gn_silu_conv3x3(*[_t(v) for v in case], silu=True,
                                  emit_sums=True)
    j_out, j1, j2 = j_conv(*[_j(v) for v in case], True, True)
    _close(out, j_out, 1e-4)
    _close(out, _ref_chain(*[_j(v) for v in case], True), 1e-4)
    np.testing.assert_allclose(s1.numpy(), _np(j1), rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), _np(j2), rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("silu,temb,res,sums", [(True, True, True, True),
                                                (False, False, False, False),
                                                (True, False, True, False),
                                                (False, True, False, True)])
def test_conv3x3_stages_match_pallas_interpret(silu, temb, res, sums):
    """The 3x3 route's two stages: the activation pass, then the conv of
    the activated tensor (zero padding at the border rows and columns),
    composed, against the JAX kernel `_fused_conv_fwd` in interpret mode."""
    case = _conv_case(temb=temb, res=res, seed=20 + 2 * silu + temb)
    x, a, b, w, bias, tb, rr = [_t(v) for v in case]
    y = gn_silu_act(x, a, b, silu)
    got = conv3x3_gemm(y, w, bias, tb, rr, emit_sums=sums)
    ref = j_conv(*[_j(v) for v in case], silu, sums)
    if sums:
        (got, s1, s2), (ref, j1, j2) = got, ref
        np.testing.assert_allclose(s1.numpy(), _np(j1), rtol=5e-4, atol=1e-4)
        np.testing.assert_allclose(s2.numpy(), _np(j2), rtol=5e-4, atol=1e-4)
    _close(got, ref, 1e-4)
    border = lambda v: np.concatenate([_np(v)[:, [0, -1]].reshape(-1),
                                       _np(v)[:, :, [0, -1]].reshape(-1)])
    _close(border(got), border(ref), 1e-4)
    _close(gn_silu_conv3x3(x, a, b, w, bias, tb, rr, silu), got, 0)


def test_tconv3_epilogues_and_sums_match_pallas_interpret():
    rng = np.random.RandomState(7)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    n, t, s, c, o = 2, 5, 256, 32, 32
    case = (f(n, t, s, c), f(n, c) * 0.3 + 1.0, f(n, c) * 0.2,
            f(3, c, o) * 0.1, f(o) * 0.1, f(n, t, o) * 0.2, f(n, t, s, o))
    out, s1, s2 = gn_silu_tconv3(*[_t(v) for v in case], silu=True,
                                 emit_sums=True)
    j_out, j1, j2 = j_tconv(*[_j(v) for v in case], True, True)
    _close(out, j_out, 1e-4)
    _close(out, _tref_chain(*[_j(v) for v in case], True), 1e-4)
    np.testing.assert_allclose(s1.numpy(), _np(j1), rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), _np(j2), rtol=5e-4, atol=1e-4)
    plain = gn_silu_tconv3(*[_t(v) for v in case[:5]], silu=False)
    _close(plain, _tref_chain(*[_j(v) for v in case[:5]], None, None, False),
           1e-4)


def _tconv_case(n=2, t=5, s=200, c=32, o=48, seed=0, temb=False, res=False):
    """x [n, t, s, c] with a ragged T and an S that is no multiple of 128."""
    rng = np.random.RandomState(seed)
    f = lambda *sh: rng.randn(*sh).astype(np.float32)
    return (f(n, t, s, c) * 1.5, f(n, c) * 0.3 + 1.0, f(n, c) * 0.2,
            f(3, c, o) * 0.1, f(o) * 0.1, f(n, t, o) * 0.2 if temb else None,
            f(n, t, s, o) if res else None)


@pytest.mark.parametrize("silu,temb,res,sums", [(True, True, True, True),
                                                (False, False, False, False),
                                                (True, False, True, False),
                                                (False, True, False, True)])
def test_tconv3_stages_match_pallas_interpret(silu, temb, res, sums):
    """The temporal route's two stages: the activation pass, then the 3-tap
    conv over T of the activated tensor (zero frames beyond both ends),
    composed, against the JAX kernel `_fused_tconv_fwd` in interpret mode
    and against `gn_silu_tconv3` itself."""
    case = _tconv_case(temb=temb, res=res, seed=30 + 2 * silu + temb)
    x, a, b, w, bias, tb, rr = [_t(v) for v in case]
    got = tconv3_gemm(gn_silu_act(x, a, b, silu), w, bias, tb, rr,
                      emit_sums=sums)
    ref = _fused_tconv_fwd(*[_j(v) for v in case], silu, sums)
    fused = gn_silu_tconv3(x, a, b, w, bias, tb, rr, silu, sums)
    if sums:
        (got, s1, s2), fused = got, fused[0]
        np.testing.assert_allclose(s1.numpy(), _np(ref[1]), rtol=5e-4, atol=1e-4)
        np.testing.assert_allclose(s2.numpy(), _np(ref[2]), rtol=5e-4, atol=1e-4)
    _close(got, ref[0], 1e-4)
    ends = lambda v: _np(v)[:, [0, -1]].reshape(-1)     # the zero-padded frames
    _close(ends(got), ends(ref[0]), 1e-4)
    _close(fused, got, 0)


def _bf16_ulps_close(got, ref):
    """At most 0.1% of the elements differ, none by more than one bf16 ulp
    (8 significant bits) of the reference element; an element under 2^-8
    of the largest takes the ulp at that size (near 0 the fp32 sums' order,
    not a rounding point, decides the last bits)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    diff = np.abs(got - ref)
    mag = np.maximum(np.abs(ref), np.ldexp(np.abs(ref).max(), -8))
    ulp = np.ldexp(1.0, np.frexp(mag)[1] - 8)
    assert (diff > ulp).sum() == 0, float((diff / ulp).max())
    assert (diff > 0).mean() <= 1e-3, float((diff > 0).mean())


@jax.jit
def _j_act(x, a, b):
    """The JAX kernels' activated strip: silu(x*a + b) in fp32, rounded to
    x's dtype."""
    y = x.astype(jnp.float32) * a[:, None, None, :] + b[:, None, None, :]
    return (y * jax.nn.sigmoid(y)).astype(x.dtype)


@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("temb,res,sums", [(True, True, True),
                                           (False, False, False),
                                           (True, False, False),
                                           (False, True, True)])
def test_fused_convs_bf16_round_as_pallas_interpret(temporal, temb, res, sums):
    """bf16 x, w and residual, fp32 bias and temb at values bf16 cannot
    hold, against the JAX kernel in interpret mode, which rounds w, bias
    and temb to bf16 and the conv's fp32 sum once, at the end: the fused
    conv and its two stages composed, without the SiLU (x*a + b rounds
    once on both sides), and the GEMM stage on the JAX kernel's own
    SiLU-activated y. (XLA's fp32 SiLU and PyTorch's differ in the last
    bit, which now and then flips a bf16 y and so moves up to 3 O outputs
    by a few ulps: a difference of the SiLU, not of the rounding points
    held here.)"""
    bf = torch.bfloat16
    if temporal:
        case = _tconv_case(o=64, seed=40 + 2 * temb + res, temb=temb, res=res)
        fused, gemm, j_fn = gn_silu_tconv3, tconv3_gemm, j_tconv
    else:
        case = _conv_case(o=64, seed=50 + 2 * temb + res, temb=temb, res=res)
        fused, gemm, j_fn = gn_silu_conv3x3, conv3x3_gemm, j_conv
    x, a, b, w, bias, tb, rr = [_t(v) for v in case]
    x, w, rr = x.to(bf), w.to(bf), None if rr is None else rr.to(bf)
    jx, ja, jb, jw, jbias, jtb, jrr = [_j(v) for v in case]
    jx, jw = jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16)
    jrr = None if jrr is None else jrr.astype(jnp.bfloat16)
    y_silu = torch.from_numpy(_np(_j_act(jx, ja, jb))).to(bf)
    for silu, got in (
            (False, fused(x, a, b, w, bias, tb, rr, False, sums)),
            (False, gemm(gn_silu_act(x, a, b, False), w, bias, tb, rr, sums)),
            (True, gemm(y_silu, w, bias, tb, rr, sums))):
        ref = j_fn(jx, ja, jb, jw, jbias, jtb, jrr, silu, sums)
        if sums:
            for g_, r_ in zip(got[1:], ref[1:]):
                np.testing.assert_allclose(g_.numpy(), _np(r_), rtol=5e-4,
                                           atol=5e-4 * np.abs(_np(r_)).max())
            got, ref = got[0], ref[0]
        assert got.dtype == bf
        _bf16_ulps_close(got.float(), ref.astype(jnp.float32))


def _host_array(ptr, n, ctype):
    return np.ctypeslib.as_array((ctype * n).from_address(ptr)).copy()


@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_conv_kernel_routes_hand_the_kernels_rounded_operands(monkeypatch,
                                                            temporal, fused):
    """On a card (use_kernel forced True, the C entry recorded instead of
    called): each conv route passes its entry as many arguments as the
    entry's signature holds, the weights K-major [O, taps*C] in bf16, and
    bias and temb_bias rounded to bf16, then fp32, as the JAX kernels add
    them; the fused routes count one launch, the GEMM stages none."""
    bf = torch.bfloat16
    n, t, s, c, o = 2, 3, 8, 32, 64
    rng = np.random.RandomState(3)
    f = lambda *sh: torch.from_numpy(rng.randn(*sh).astype(np.float32))
    x, a, b, bias = f(n, t, s, c).to(bf), f(n, c), f(n, c), f(o)
    taps = (3,) if temporal else (3, 3)
    w, temb = f(*taps, c, o).to(bf), f(*((n, t, o) if temporal else (n, o)))
    seen = {}

    def launch(entry, device, *args):
        assert len(args) + 1 == len(_SIGNATURES[entry])     # + the stream
        k = 3 if fused else 1                  # x, a, b or y come first
        wt, pb, pt = args[k:k + 3]
        seen[entry] = (_host_array(wt, w.numel(), ctypes.c_uint16),
                       _host_array(pb, o, ctypes.c_float),
                       _host_array(pt, temb.numel(), ctypes.c_float))

    monkeypatch.setattr(conv_fused, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr("mofa_tpu_torch.kernels._build.launch", launch)
    name = ("gn_silu_" + ("tconv3" if temporal else "conv3x3") if fused
            else ("tconv3" if temporal else "conv3x3") + "_gemm")
    args = (x, a, b) if fused else (x,)
    kernels.reset_launch_counts()
    with torch.no_grad():
        getattr(conv_fused, name)(*args, w, bias, temb, emit_sums=True)
    assert sum(kernels.launch_counts().values()) == int(fused)
    (wt, got_bias, got_temb), = seen.values()
    want_wt = w.reshape(-1, o).t().contiguous().view(torch.int16).numpy()
    np.testing.assert_array_equal(wt.view(np.int16).reshape(o, -1), want_wt)
    np.testing.assert_array_equal(got_bias, bias.to(bf).float().numpy())
    np.testing.assert_array_equal(got_temb,
                                  temb.to(bf).float().reshape(-1).numpy())
    assert not np.array_equal(got_bias, bias.numpy())   # bf16 cannot hold it


def test_fused_conv_gates():
    bf = torch.bfloat16
    assert fused_conv_applicable((50, 72, 128, 320), 320, bf)
    assert fused_conv_applicable((50, 36, 64, 640), 640, bf)
    assert fused_tconv_applicable((2, 25, 9216, 320), 320, bf)
    assert not fused_conv_applicable((50, 18, 32, 1280), 1280, bf)    # > 640
    assert not fused_conv_applicable((2, 12, 16, 32), 48, bf)        # O % 64
    assert not fused_conv_applicable((2, 12, 16, 48), 64, bf)        # C % 32
    assert not fused_tconv_applicable((2, 25, 9216, 320), 320, torch.float32)
