"""The port's GroupNorm-statistics and fused GN-SiLU-conv modules against
the JAX package's Pallas kernels, on CPU, in fp32.

On CPU the wrappers of `mofa_tpu_torch.kernels.group_norm` and
`.conv_fused` run their plain PyTorch versions; each is held against the
JAX Pallas kernel in interpret mode (as tests/test_group_norm_kernel.py and
tests/test_conv_fused.py run it) and against the JAX plain references, on
the same numpy inputs. Tolerances are fp32 summation-order bounds: 2e-5
for GroupNorm (sums over at most 2048 x 64 values), 1e-4 of the output's
magnitude for the convolutions (K = 9 x 32 products per output), and the
sums 5e-4 relative (sums of up to 1280 squared outputs), as in those JAX
tests. The CUDA kernels are checked on a GPU by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.kernels.conv_fused import _ref_chain, _tref_chain
from mofa_tpu.kernels.conv_fused import gn_silu_conv3x3 as j_conv
from mofa_tpu.kernels.conv_fused import gn_silu_tconv3 as j_tconv
from mofa_tpu.kernels.group_norm import _gn_ref
from mofa_tpu.kernels.group_norm import channel_sums as j_channel_sums
from mofa_tpu.kernels.group_norm import fused_group_norm as j_fused_gn

from mofa_tpu_torch.kernels.conv_fused import (conv3x3_gemm,
                                               fused_conv_applicable,
                                               fused_tconv_applicable,
                                               gn_silu_act, gn_silu_conv3x3,
                                               gn_silu_tconv3)
from mofa_tpu_torch.kernels.group_norm import (channel_sums, fused_group_norm,
                                               group_norm_plain)
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


def test_fused_conv_gates():
    bf = torch.bfloat16
    assert fused_conv_applicable((50, 72, 128, 320), 320, bf)
    assert fused_conv_applicable((50, 36, 64, 640), 640, bf)
    assert fused_tconv_applicable((2, 25, 9216, 320), 320, bf)
    assert not fused_conv_applicable((50, 18, 32, 1280), 1280, bf)    # > 640
    assert not fused_conv_applicable((2, 12, 16, 32), 48, bf)        # O % 64
    assert not fused_conv_applicable((2, 12, 16, 48), 64, bf)        # C % 32
    assert not fused_tconv_applicable((2, 25, 9216, 320), 320, torch.float32)
