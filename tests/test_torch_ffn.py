"""The port's GEGLU FFN kernels against the JAX package's Pallas kernels, on CPU.

On CPU `mofa_tpu_torch.kernels.geglu_ffn` runs its plain PyTorch versions
(the CUDA kernels have no CPU mode): `geglu_ffn` against JAX `geglu_ffn`
(the `_ffn_kernel` Pallas kernel in interpret mode) and `_ffn_ref`, and
`ln_geglu_ffn(variant=...)` for "ilv", "pipe" and "tanh" against
`_ln_ffn_fwd(variant=...)` in interpret mode (on the CPU the JAX package
runs "pipe" through the plain kernel, as its own tests do) and against
`_ln_ffn_ref` or its tanh counterpart, on the same numpy inputs at the
kernels' widths. Tolerance, fp32: 1e-4 relative to max |ref|, as for the
"plain" kernel in test_torch_kernels.py. The bf16 route of every variant
and of `geglu_ffn` runs three stages (LN, gate GEMM, out GEMM), each with
an entry point and a plain version, the gate GEMM in the schedule its
variant names: their composition is held to the plain FFN and to the JAX
kernels at a ragged row count. The plain FFN's
gradients are held to JAX's VJP, and the wrappers' refusals and grad guard
are driven with use_kernel forced to True and the launch replaced. The
CUDA kernels are tested on a GPU by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.kernels.geglu_ffn import LN_EPS, _ffn_ref, _ln_ffn_fwd, _ln_ffn_ref
from mofa_tpu.kernels.geglu_ffn import geglu_ffn as j_geglu_ffn
from mofa_tpu.kernels.geglu_ffn import ln_geglu_ffn as j_ln_geglu_ffn

from mofa_tpu_torch import kernels
from mofa_tpu_torch.kernels.geglu_ffn import (SCHEDULES, VARIANTS, ffn_gemm_gate,
                                              ffn_gemm_out, ffn_ln_rows, ffn_plain,
                                              geglu_ffn, ln_ffn_plain, ln_geglu_ffn)
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)


def _operands(c, rows, seed):
    """x, LN scale / shift, w0 [C, 8C], b0, w2 [4C, C], b2 (JAX layouts)."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    return (f(rows, c), 1.0 + f(c, scale=0.1), f(c, scale=0.1),
            f(c, 8 * c, scale=c ** -0.5), f(8 * c, scale=0.1),
            f(4 * c, c, scale=(4 * c) ** -0.5), f(c, scale=0.1))


def _torch_args(x, ls, lb, w0, b0, w2, b2):
    """The port's torch Linear layouts: w0 [8C, C], w2 [C, 4C]."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return t(x), t(ls), t(lb), t(w0.T), t(b0), t(w2.T), t(b2)


def _ln_ffn_ref_tanh(x, ls, lb, w0, b0, w2, b2):
    """`_ln_ffn_ref` with the tanh-form gelu (the "tanh" variant)."""
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(x * x, axis=-1, keepdims=True) - mean * mean, 0.0)
    h = (x - mean) * jax.lax.rsqrt(var + LN_EPS) * ls + lb
    a, g = jnp.split(h @ w0 + b0, 2, axis=-1)
    return (a * jax.nn.gelu(g, approximate=True)) @ w2 + b2 + x


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("c,rows", [(320, 512), (640, 256)])
def test_geglu_ffn_matches_pallas_interpret_and_ref(c, rows):
    x, _, _, w0, b0, w2, b2 = ops = _operands(c, rows, seed=c + 1)
    tx, _, _, tw0, tb0, tw2, tb2 = _torch_args(*ops)
    got = geglu_ffn(tx, tw0, tb0, tw2, tb2).numpy()
    kernel, ref = jax.jit(lambda *a: (j_geglu_ffn(*a), _ffn_ref(*a)))(x, w0, b0, w2, b2)
    _close(got, kernel)                       # the Pallas kernel, interpret mode
    _close(got, ref)


@pytest.mark.parametrize("variant", ["ilv", "pipe", "tanh"])
@pytest.mark.parametrize("c,rows", [(320, 512), (640, 256)])
def test_ln_geglu_ffn_variants_match_pallas_interpret_and_ref(variant, c, rows):
    ops = _operands(c, rows, seed=c + 2)
    got = ln_geglu_ffn(*_torch_args(*ops), variant=variant).numpy()
    ref_fn = _ln_ffn_ref_tanh if variant == "tanh" else _ln_ffn_ref
    kernel, ref = jax.jit(lambda *a: (_ln_ffn_fwd(*a, variant=variant), ref_fn(*a)))(*ops)
    _close(got, kernel)
    _close(got, ref)


def test_tanh_variant_is_the_tanh_form():
    """At gate pre-activations in the negative tail (g = b0's gate half, in
    [-3.5, -2.5]; W0's g rows zero) the tanh-form gelu is 2-45% off erf,
    so the variants must differ there by far more than rounding."""
    c = 320
    x, ls, lb, w0, b0, w2, b2 = _operands(c, 64, seed=5)
    w0[:, 4 * c:] = 0.0
    b0[4 * c:] = -3.0 + 0.25 * np.random.RandomState(6).randint(-2, 3, 4 * c)
    args = _torch_args(0.01 * x, ls, lb, w0, b0, 100.0 * w2, 0.0 * b2)
    erf, tanh = ln_geglu_ffn(*args), ln_geglu_ffn(*args, variant="tanh")
    rel = ((tanh - erf).norm() / erf.norm()).item()
    assert rel > 2e-2, rel
    ref = _ln_ffn_ref_tanh(*[jnp.asarray(a.numpy()) for a in
                             (args[0], args[1], args[2], args[3].T, args[4],
                              args[5].T, args[6])])
    _close(tanh.numpy(), ref)


def test_variants_on_cpu_launch_nothing_and_bad_names_raise():
    kernels.reset_launch_counts()
    args = _torch_args(*_operands(320, 70, seed=7))
    plain = ln_geglu_ffn(*args)
    for v in VARIANTS:
        out = ln_geglu_ffn(*args, variant=v)
        if v != "tanh":        # one function, one plain version on the CPU
            assert torch.equal(out, plain)
    geglu_ffn(args[0], *args[3:])
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    with pytest.raises(ValueError):
        ln_geglu_ffn(*args, variant="fast")
    with pytest.raises(ValueError):
        geglu_ffn(args[0], args[3][:, :10], *args[4:])


# ------------------------------------------- the bf16 route's three stages

def _ln_ffn_plain_before(x, ls, lb, w0, b0, w2, b2, approximate="none"):
    """`ln_ffn_plain` as it read before its split into stages (one
    expression), the reference the composed stages must equal bit for bit."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    h = ((xf - mean) * torch.rsqrt(var + LN_EPS) * ls.float() + lb.float()).to(x.dtype)
    a, g = torch.nn.functional.linear(h, w0.to(x.dtype), b0.to(x.dtype)).chunk(2, dim=-1)
    act = a * torch.nn.functional.gelu(g, approximate=approximate)
    return torch.nn.functional.linear(act, w2.to(x.dtype), b2.to(x.dtype)) + x


def _ffn_plain_before(x, w0, b0, w2, b2):
    a, g = torch.nn.functional.linear(x, w0.to(x.dtype), b0.to(x.dtype)).chunk(2, dim=-1)
    return torch.nn.functional.linear(a * torch.nn.functional.gelu(g), w2.to(x.dtype),
                                      b2.to(x.dtype))


def _stages(x, ls, lb, w0, b0, w2, b2, kind):
    """The three stage entry points in turn (on the CPU: their plain
    versions), as the bf16 kernels run them: the gate GEMM in the schedule
    of the variant's name ("ilv", "pipe"), else "plain"."""
    if kind == "geglu_ffn":
        return ffn_gemm_out(ffn_gemm_gate(x, w0, b0), w2, b2)
    xn = ffn_ln_rows(x, ls, lb)
    h = ffn_gemm_gate(xn, w0, b0, "tanh" if kind == "tanh" else "none",
                      schedule=kind if kind in SCHEDULES else "plain")
    return ffn_gemm_out(h, w2, b2, x)


def _jax_ragged(fn, args, block):
    """fn on x padded with zero rows to `block` (the JAX kernels take whole
    row blocks), cut back to x's rows."""
    x = args[0]
    pad = np.concatenate([x, np.zeros((block - x.shape[0], x.shape[1]), x.dtype)])
    return np.asarray(jax.jit(fn)(pad, *args[1:]))[:x.shape[0]]


@pytest.mark.parametrize("kind", ["plain", "tanh", "ilv", "pipe", "geglu_ffn"])
@pytest.mark.parametrize("c", [320, 640])
def test_stages_compose_to_the_plain_versions(c, kind):
    """At a ragged row count: in bf16 the composed stages (the gate GEMM in
    the variant's schedule) equal the plain FFN as it was written before
    the split, exactly; in fp32 they match the JAX kernel of the variant in
    interpret mode (and so the split keeps its rounding points) with the
    tolerance of the tests above."""
    ops = _operands(c, 129, seed=c + 11)
    targs = _torch_args(*ops)
    bf = [t.to(torch.bfloat16) if i not in (1, 2) else t for i, t in enumerate(targs)]
    if kind == "geglu_ffn":
        want = _ffn_plain_before(bf[0], *bf[3:])
        plain = ffn_plain(bf[0], *bf[3:])
    else:
        approx = "tanh" if kind == "tanh" else "none"
        want = _ln_ffn_plain_before(*bf, approximate=approx)
        plain = ln_ffn_plain(*bf, approximate=approx)
        assert torch.equal(ln_geglu_ffn(*bf, variant=kind), want)
    assert torch.equal(_stages(*bf, kind), want)
    assert torch.equal(plain, want)

    got = _stages(*targs, kind).numpy()
    block = 512 if c == 320 else 256
    if kind == "geglu_ffn":
        x, _, _, w0, b0, w2, b2 = ops
        ref = _jax_ragged(j_geglu_ffn, (x, w0, b0, w2, b2), block)
    else:
        ref = _jax_ragged(lambda *a: _ln_ffn_fwd(*a, variant=kind), ops, block)
    _close(got, ref)


def test_plain_ffn_gradients_match_jax_vjp():
    """The plain LN-GEGLU FFN keeps autograd on the CPU; its gradients
    (dx, LN scale and shift, dW0, db0, dW2, db2) match jax.vjp of the JAX
    package's `ln_geglu_ffn` (a custom_vjp whose backward differentiates
    `_ln_ffn_ref`), fp32, relative 1e-4: the oracle of the kernels'
    backward to come."""
    ops = _operands(320, 512, seed=13)
    targs = [t.clone().requires_grad_() for t in _torch_args(*ops)]
    cot = np.random.RandomState(14).randn(512, 320).astype(np.float32)
    out = ln_geglu_ffn(*targs)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(cot))
    grads = jax.jit(lambda args, g: jax.vjp(j_ln_geglu_ffn, *args)[1](g))
    want = grads([jnp.asarray(a) for a in ops], jnp.asarray(cot))
    for i, (t, w) in enumerate(zip(targs, want)):
        grad = t.grad.numpy()
        if i in (3, 5):                     # torch Linear layouts: w0, w2 transposed
            grad = grad.T
        _close(grad, w)


# ------------------------------------------------ refusals and the grad guard

def _fake_card(monkeypatch):
    """The FFN wrappers as if their tensors lay on a card: use_kernel says
    True, and a launch raises RuntimeError("launch") instead of running."""
    from mofa_tpu_torch.kernels import geglu_ffn as mod
    monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
    monkeypatch.setattr("mofa_tpu_torch.kernels._build.launch",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("launch")))


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    _fake_card(monkeypatch)
    bf = torch.bfloat16
    x, ls, lb, w0, b0, w2, b2 = _torch_args(*_operands(320, 64, seed=15))
    xb, w0b, b0b, w2b, b2b = (t.to(bf) for t in (x, w0, b0, w2, b2))
    h = torch.zeros(64, 1280, dtype=bf)
    refused = [
        lambda: geglu_ffn(x, w0, b0, w2, b2),                        # fp32
        lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2, variant="tanh"),
        lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2, variant="pipe"),
        lambda: ffn_ln_rows(x, ls, lb),                              # fp32
        lambda: ffn_ln_rows(xb[:, :256], ls[:256], lb[:256]),        # C = 256
        lambda: ffn_ln_rows(xb[None], ls, lb),                       # not [rows, C]
        lambda: ffn_gemm_gate(xb, w0b[:, :10], b0b),
        lambda: ffn_gemm_gate(xb, w0b, b0b[:100]),
        lambda: ffn_gemm_gate(xb, w0b, b0b, "sigmoid"),
        lambda: ffn_gemm_gate(xb, w0b, b0b, schedule="fast"),
        lambda: ffn_gemm_gate(xb, w0b, b0b, "tanh", schedule="ilv"),
        lambda: ffn_gemm_gate(xb, w0b, b0b, "tanh", schedule="pipe"),
        lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2, variant="ilv"),  # fp32
        lambda: ffn_gemm_out(h[:, :640], w2b, b2b),
        lambda: ffn_gemm_out(h, w2b, b2b, residual=xb[:10]),
        lambda: ffn_gemm_out(h.float(), w2b, b2b)]
    for i, call in enumerate(refused):
        with pytest.raises(ValueError):
            call()
    taken = [lambda: ln_geglu_ffn(x, ls, lb, w0, b0, w2, b2),          # fp32 path
             lambda: ln_geglu_ffn(xb, ls, lb, w0b, b0b, w2b, b2b, variant="tanh"),
             lambda: geglu_ffn(xb, w0b, b0b, w2b, b2b),
             lambda: ffn_ln_rows(xb, ls, lb),
             lambda: ffn_gemm_gate(xb, w0b, b0b, "tanh"),
             lambda: ffn_gemm_gate(xb, w0b, b0b, schedule="ilv"),
             lambda: ffn_gemm_gate(xb, w0b, b0b, schedule="pipe"),
             lambda: ln_geglu_ffn(xb, ls, lb, w0b, b0b, w2b, b2b, variant="ilv"),
             lambda: ln_geglu_ffn(xb, ls, lb, w0b, b0b, w2b, b2b, variant="pipe"),
             lambda: ffn_gemm_out(h, w2b, b2b, residual=xb)]
    for call in taken:
        with pytest.raises(RuntimeError, match="launch"):
            call()


def test_grad_guard_refuses_inputs_that_require_grad(monkeypatch):
    """A kernel without a backward: with grad enabled, an input that
    requires grad must raise before any launch, naming the kernel; under
    no_grad, or without such an input, the guard lets the launch through.
    The plain version on CPU tensors keeps autograd, and the models' FFN
    variant ("plain") has a backward, so under grad it reaches its launch."""
    x = torch.randn(8, 320, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        kernels.check_no_grad("flash_attention", torch.zeros(1), x)
    kernels.check_no_grad("flash_attention", x.detach(), None)
    with torch.no_grad():
        kernels.check_no_grad("flash_attention", x)

    args = list(_torch_args(*_operands(320, 16, seed=16)))
    args[3].requires_grad_()                                  # w0
    assert ln_geglu_ffn(*args).grad_fn is not None            # the plain path
    _fake_card(monkeypatch)
    with pytest.raises(RuntimeError, match="ln_geglu_ffn_tanh.*no backward"):
        ln_geglu_ffn(*args, variant="tanh")
    with pytest.raises(RuntimeError, match="geglu_ffn.*no backward"):
        geglu_ffn(args[0], *args[3:])
    with pytest.raises(RuntimeError, match="launch"):
        ln_geglu_ffn(*args)
    with torch.no_grad(), pytest.raises(RuntimeError, match="launch"):
        ln_geglu_ffn(*args)
