"""The port's GEGLU FFN kernels against the JAX package's Pallas kernels, on CPU.

On CPU `mofa_tpu_torch.kernels.geglu_ffn` runs its plain PyTorch versions
(the CUDA kernels have no CPU mode): `geglu_ffn` against JAX `geglu_ffn`
(the `_ffn_kernel` Pallas kernel in interpret mode) and `_ffn_ref`, and
`ln_geglu_ffn(variant=...)` for "ilv", "pipe" and "tanh" against
`_ln_ffn_fwd(variant=...)` in interpret mode (on the CPU the JAX package
runs "pipe" through the plain kernel, as its own tests do) and against
`_ln_ffn_ref` or its tanh counterpart, on the same numpy inputs at the
kernels' widths. Tolerance, fp32: 1e-4 relative to max |ref|, as for the
"plain" kernel in test_torch_kernels.py. The CUDA kernels are tested on a
GPU by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.kernels.geglu_ffn import LN_EPS, _ffn_ref, _ln_ffn_fwd, _ln_ffn_ref
from mofa_tpu.kernels.geglu_ffn import geglu_ffn as j_geglu_ffn

from mofa_tpu_torch import kernels
from mofa_tpu_torch.kernels.geglu_ffn import VARIANTS, geglu_ffn, ln_geglu_ffn
from tests.torch_port_util import one_torch_thread  # noqa: F401 (autouse)


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
    args = [jnp.asarray(a) for a in (x, w0, b0, w2, b2)]
    _close(got, j_geglu_ffn(*args))           # the Pallas kernel, interpret mode
    _close(got, _ffn_ref(*args))


@pytest.mark.parametrize("variant", ["ilv", "pipe", "tanh"])
@pytest.mark.parametrize("c,rows", [(320, 512), (640, 256)])
def test_ln_geglu_ffn_variants_match_pallas_interpret_and_ref(variant, c, rows):
    ops = _operands(c, rows, seed=c + 2)
    got = ln_geglu_ffn(*_torch_args(*ops), variant=variant).numpy()
    args = [jnp.asarray(a) for a in ops]
    _close(got, _ln_ffn_fwd(*args, variant=variant))
    _close(got, (_ln_ffn_ref_tanh if variant == "tanh" else _ln_ffn_ref)(*args))


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
