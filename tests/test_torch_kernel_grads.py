"""The gradients of the kernel entry points that the JAX package
differentiates beyond the training path's four, on the CPU.

Each JAX kernel is a `jax.custom_vjp` whose backward recomputes through a
plain-jnp reference; the port's counterpart is an autograd Function whose
backward is the same math in stock PyTorch. For classic-layout short
attention, `geglu_ffn`, the "ilv" and "pipe" LN-GEGLU FFNs, the channel
sums, the fused GroupNorm and both fused GN-SiLU convs (with their output
sums), the port's backward is held to the JAX rule itself (`_bwd_rule`,
`_ln_bwd_rule`, `_cs_bwd`, `_bwd`, `_vjp_bwd`, `_tvjp_bwd`, one jit
program each) at relative 1e-4 in fp32, and the wrapper's autograd route
(use_kernel forced True, the launch replaced by the plain version) to the
port's backward within 1e-6. The "tanh" FFN is held to torch autograd of
its own forward; the JAX rule differentiates the erf form under every
variant (mofa_tpu/kernels/geglu_ffn.py:427), so its "tanh" gradient is
not that of its forward, which the last case pins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.kernels import conv_fused as j_conv
from mofa_tpu.kernels import geglu_ffn as j_ffn
from mofa_tpu.kernels import group_norm as j_gn
from mofa_tpu.kernels import short_attention as j_short
from mofa_tpu_torch.kernels import conv_fused as conv_mod
from mofa_tpu_torch.kernels import geglu_ffn as ffn_mod
from mofa_tpu_torch.kernels import group_norm as gn_mod
from mofa_tpu_torch.kernels import short_attention as short_mod
from tests.torch_port_util import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_port_util import as_card, jit_fast

GROUPS, EPS = 4, 1e-5


def _close(got, ref, rel):
    """max |got - ref| <= rel * max |ref| for each pair of gradients."""
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None, i
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (i, a.shape, b.shape)
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= rel * scale + 1e-30, (i, err, scale)


def _randn(rng, *shape, scale=1.0, mean=0.0):
    return (rng.randn(*shape) * scale + mean).astype(np.float32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _autograd(fn, inputs, cots):
    """Gradients of fn(*inputs) (a tensor or a tuple) at cots, through the
    route fn takes, None for a None input."""
    leaves = [None if t is None else t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, cots)
    return [None if t is None else t.grad for t in leaves]


def _ffn_inputs(rng, c=16, rows=20, tail=False):
    """x, LN scale and shift, w0 [8C, C], b0, w2 [C, 4C], b2; tail: the gate
    pre-activations near -3, where the tanh gelu is far from erf."""
    x = _randn(rng, rows, c)
    ls, lb = _randn(rng, c, scale=0.2, mean=1.0), _randn(rng, c, scale=0.2)
    w0, b0 = _randn(rng, 8 * c, c, scale=c ** -0.5), _randn(rng, 8 * c, scale=0.1)
    w2, b2 = _randn(rng, c, 4 * c, scale=(4 * c) ** -0.5), _randn(rng, c, scale=0.1)
    if tail:
        w0[4 * c:] *= 0.2
        b0[4 * c:] = -3.0
    return x, ls, lb, w0, b0, w2, b2


def _jax_ln_rule(x, ls, lb, w0, b0, w2, b2, g):
    """JAX `_ln_bwd_rule` on port-layout weights; its dW0 / dW2 back in
    the port's layout."""
    got = _ln_rule_jit((x, ls, lb, w0.T, b0, w2.T, b2), g)
    return [np.asarray(a).T if i in (3, 5) else a for i, a in enumerate(got)]


@jit_fast
def _ln_rule_jit(res, g):
    return j_ffn._ln_bwd_rule(res, g)


def _case_short(rng, monkeypatch):
    q, k, v, g = (_randn(rng, 5, 9, 2, 16) for _ in range(4))
    got = short_mod.short_backward(*_t(q, k, v, g))
    want = jit_fast(lambda r, c: j_short._bwd_rule(0, False, r, c))((q, k, v), g)
    as_card(monkeypatch, short_mod, _launch_short=short_mod.attention_plain)
    routed = _autograd(short_mod.short_attention, _t(q, k, v), _t(g))
    return got, want, routed


def _case_geglu_ffn(rng, monkeypatch):
    x, _, _, w0, b0, w2, b2 = _ffn_inputs(rng)
    g = _randn(rng, *x.shape)
    got = ffn_mod.ffn_backward(*_t(x, w0, b0, w2, b2, g))
    want = jit_fast(j_ffn._bwd_rule)((x, w0.T, b0, w2.T, b2), g)
    want = [np.asarray(a).T if i in (1, 3) else a for i, a in enumerate(want)]
    as_card(monkeypatch, ffn_mod,
            _launch_ffn=lambda name, x_, ln, ws, *a: ffn_mod.ffn_plain(x_, *ws))
    routed = _autograd(ffn_mod.geglu_ffn, _t(x, w0, b0, w2, b2), _t(g))
    return got, want, routed


def _launch_ln_plain(name, x, ln, ws, approximate="none", schedule="plain"):
    return ffn_mod.ln_ffn_plain(x, *ln, *ws, approximate)


def _case_ln_variant(variant):
    def case(rng, monkeypatch):
        args = _ffn_inputs(rng)
        g = _randn(rng, *args[0].shape)
        got = ffn_mod.ln_ffn_backward(*_t(*args, g))
        want = _jax_ln_rule(*args, g)
        as_card(monkeypatch, ffn_mod, _launch_ffn=_launch_ln_plain)
        routed = _autograd(lambda *a: ffn_mod.ln_geglu_ffn(*a, variant=variant),
                           _t(*args), _t(g))
        return got, want, routed
    return case


def _case_tanh(rng, monkeypatch):
    """The reference here is torch autograd of the tanh plain version."""
    args = _ffn_inputs(rng, tail=True)
    g = _randn(rng, *args[0].shape)
    got = ffn_mod.ln_ffn_backward(*_t(*args, g), approximate="tanh")
    want = _autograd(lambda *a: ffn_mod.ln_ffn_plain(*a, "tanh"), _t(*args), _t(g))
    as_card(monkeypatch, ffn_mod, _launch_ffn=_launch_ln_plain)
    routed = _autograd(lambda *a: ffn_mod.ln_geglu_ffn(*a, variant="tanh"),
                       _t(*args), _t(g))
    return got, [w.numpy() for w in want], routed


def _case_channel_sums(rng, monkeypatch):
    x3 = _randn(rng, 3, 10, 8, mean=0.5)
    g1, g2 = _randn(rng, 3, 8), _randn(rng, 3, 8)
    got = (gn_mod.channel_sums_backward(*_t(x3, g1, g2)),)
    want = j_gn._cs_bwd(jnp.asarray(x3), (jnp.asarray(g1), jnp.asarray(g2)))
    as_card(monkeypatch, gn_mod, _launch_sums=gn_mod.channel_sums_plain)
    routed = _autograd(gn_mod.channel_sums, _t(x3), tuple(_t(g1, g2)))
    return got, want, routed


def _case_group_norm(rng, monkeypatch):
    x = _randn(rng, 2, 4, 5, 8, scale=0.05, mean=0.5)   # eps 0.4% of the variance
    scale, bias = _randn(rng, 8, scale=0.2, mean=1.0), _randn(rng, 8, scale=0.2)
    g = _randn(rng, *x.shape)
    got = gn_mod.group_norm_backward(*_t(x, scale, bias, g), GROUPS, EPS)
    want = jit_fast(lambda r, c: j_gn._bwd(GROUPS, EPS, r, c))((x, scale, bias), g)
    as_card(monkeypatch, gn_mod, _launch_sums=gn_mod.channel_sums_plain)
    routed = _autograd(lambda *a: gn_mod.fused_group_norm(*a, GROUPS, EPS),
                       _t(x, scale, bias), _t(g))
    return got, want, routed


def _launch_conv_plain(name, x, w, bias, temb, residual, emit_sums, ab, silu):
    plain = (conv_mod.conv3x3_plain if name == "gn_silu_conv3x3"
             else conv_mod.tconv3_plain)
    return plain(x, *ab, w, bias, temb, residual, silu, emit_sums)


def _case_conv(temporal, emit_sums, with_residual):
    """gn_silu_conv3x3 ([N, H, W, C], temb [N, O]) or gn_silu_tconv3 ([B,
    T, S, C], temb [B, T, O]), C = O = 8, with the output sums' cotangents
    (emit_sums) or a residual."""
    def case(rng, monkeypatch):
        x = _randn(rng, 2, 5, 6, 8)
        a, b = _randn(rng, 2, 8, scale=0.3, mean=1.0), _randn(rng, 2, 8, scale=0.2)
        w = _randn(rng, *((3,) if temporal else (3, 3)), 8, 8, scale=0.15)
        bias = _randn(rng, 8, scale=0.1)
        temb = _randn(rng, *((2, 5, 8) if temporal else (2, 8)), scale=0.3)
        res = _randn(rng, 2, 5, 6, 8) if with_residual else None
        g = (_randn(rng, 2, 5, 6, 8),) + ((_randn(rng, 2, 8), _randn(rng, 2, 8))
                                         if emit_sums else ())
        plain = conv_mod.tconv3_plain if temporal else conv_mod.conv3x3_plain
        inputs = (x, a, b, w, bias, temb, res)
        got = conv_mod.fused_conv_backward(plain, *_t(*inputs), True, emit_sums,
                                           *_t(*g))
        rule = j_conv._tvjp_bwd if temporal else j_conv._vjp_bwd
        want = jit_fast(lambda r, c: rule(True, emit_sums, r, c))(
            inputs, g if emit_sums else g[0])
        as_card(monkeypatch, conv_mod, _launch=_launch_conv_plain)
        fn = conv_mod.gn_silu_tconv3 if temporal else conv_mod.gn_silu_conv3x3
        routed = _autograd(lambda *t: fn(*t, emit_sums=emit_sums), _t(*inputs),
                           tuple(_t(*g)))
        return got, want, routed
    return case


CASES = {"short_attention": _case_short,
         "geglu_ffn": _case_geglu_ffn,
         "ln_geglu_ffn_ilv": _case_ln_variant("ilv"),
         "ln_geglu_ffn_pipe": _case_ln_variant("pipe"),
         "ln_geglu_ffn_tanh": _case_tanh,
         "channel_sums": _case_channel_sums,
         "fused_group_norm": _case_group_norm,
         "gn_silu_conv3x3 sums": _case_conv(False, True, False),
         "gn_silu_tconv3 residual": _case_conv(True, False, True)}


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_the_jax_rule_and_the_route(monkeypatch, name):
    """The port's backward against the JAX rule (tanh: torch autograd of
    its forward) at relative 1e-4, fp32; the wrapper's autograd route, as
    on a card, equal to the backward within 1e-6."""
    got, want, routed = CASES[name](np.random.RandomState(list(CASES).index(name)),
                                    monkeypatch)
    got = [None if a is None else a.detach().numpy() for a in got]
    _close(got, want, 1e-4)
    _close([None if a is None else a.numpy() for a in routed], got, 1e-6)


def test_jax_tanh_rule_is_the_erf_forwards_gradient():
    """The JAX package's `_ln_bwd_rule` under the tanh variant: within 1e-4
    of torch autograd of the erf FFN, and off that of the tanh FFN (the
    function its tanh forward computes) in db0 by more than 1e-2 of it, at
    gate inputs where the two gelus differ: a fault on the reference side
    that the port does not inherit."""
    args = _ffn_inputs(np.random.RandomState(5), tail=True)
    g = _randn(np.random.RandomState(6), *args[0].shape)
    jax_rule = _jax_ln_rule(*args, g)
    erf = _autograd(ffn_mod.ln_ffn_plain, _t(*args), _t(g))
    tanh = _autograd(lambda *a: ffn_mod.ln_ffn_plain(*a, "tanh"), _t(*args), _t(g))
    _close(jax_rule, [t.numpy() for t in erf], 1e-4)
    db0_jax, db0_tanh = np.asarray(jax_rule[4]), tanh[4].numpy()
    assert np.abs(db0_jax - db0_tanh).max() > 1e-2 * np.abs(db0_tanh).max()
