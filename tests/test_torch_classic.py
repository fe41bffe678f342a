"""The port's classic temporal layout against the JAX package, on CPU, fp32.

The classic layout transposes the temporal block's rows to [B*S, T, C]
and runs its self-attention as short attention over T; it is what the JAX
package runs under `MOFA_TMAJOR=0` (and, on its own, at an odd batch
B > 1 with the HW-major context quirk on). One `monkeypatch.setenv`
switches both packages. Short attention is held against the JAX Pallas
kernel in interpret mode (as tests/test_short_attention.py runs it);
modules and the MICRO UNet against mofa_tpu on the same weights
(tests/torch_port_util.py) and numpy inputs. Tolerances are fp32
summation-order bounds: 2e-5 absolute for attention (the bound of
tests/test_short_attention.py), 1e-4 of the output's magnitude for
modules (as tests/test_torch_models.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.kernels.short_attention import _short_attn_ref
from mofa_tpu.kernels.short_attention import short_attention as j_short
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG as J_MICRO
from mofa_tpu.models.transformer_blocks import \
    TransformerSpatioTemporalModel as JTransformer
from mofa_tpu.models.weights import convert_torch_state_dict

from mofa_tpu_torch.kernels import attention
from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                    short_attention_applicable)
from mofa_tpu_torch.models import layers
from mofa_tpu_torch.models.svd_unet import (MICRO_UNET_CONFIG,
                                            UNetSpatioTemporalConditionModel)
from mofa_tpu_torch.models.transformer_blocks import (
    TransformerSpatioTemporalModel, tmajor_enabled)
from tests.torch_port_util import jax_unet, sd_np, seeded, template
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, ref, rel=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _spy(monkeypatch, module, name):
    """Count the calls of module.name (still calling through)."""
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


# ------------------------------------------------------- short attention

@pytest.mark.parametrize("b,l,h,d", [(146, 7, 5, 64), (64, 25, 5, 64)])
def test_short_attention_matches_pallas_interpret(b, l, h, d):
    rng = np.random.RandomState(b + l)
    q, k, v = (rng.randn(b, l, h, d).astype(np.float32) for _ in range(3))
    got = short_attention(_t(q), _t(k), _t(v)).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(got, np.asarray(j_short(jq, jk, jv, 0, False)),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_short_attn_ref(jq, jk, jv)),
                               rtol=0, atol=2e-5)
    # the dispatch admits these sites and sends them to short_attention
    assert short_attention_applicable(b, l, l, h, d, torch.float32)
    np.testing.assert_array_equal(
        attention.dot_product_attention(_t(q), _t(k), _t(v)).numpy(), got)


def test_short_attention_gate_on_svd_shapes():
    # classic temporal sites at 576x1024, T=25, CFG batch 2: /8 is admitted,
    # /16 (H=10) has L*H = 250 > 160 and stays plain
    assert short_attention_applicable(18432, 25, 25, 5, 64)
    assert not short_attention_applicable(4608, 25, 25, 10, 64)
    assert not short_attention_applicable(1, 25, 25, 5, 64)          # B = 1
    assert not short_attention_applicable(8, 25, 25, 1, 64)          # B*L < 224
    assert not short_attention_applicable(18432, 33, 33, 4, 64)      # L > 32
    assert not short_attention_applicable(18432, 25, 24, 5, 64)      # Lq != Lk
    assert not short_attention_applicable(18432, 25, 25, 5, 32)      # D
    assert not short_attention_applicable(18432, 25, 25, 5, 64, torch.float16)


# ------------------------------------------------------------ transformer

@pytest.mark.parametrize("quirk,bsz,env", [
    (True, 1, "0"), (True, 2, "0"), (False, 2, "0"),
    (True, 3, None),       # odd B > 1 with the quirk: classic on its own
], ids=["quirk-B1", "quirk-B2", "noquirk-B2", "quirk-B3-auto"])
def test_transformer_classic_matches_jax(monkeypatch, quirk, bsz, env):
    """One head of 64 (the short kernel's width) at 8x8, T=3: for B >= 2
    every temporal self-attention of the classic layout passes the short
    gate. At B = 3 with the quirk the context is the raw HW-major indexing,
    which raised in the port before it had the classic layout."""
    if env is not None:
        monkeypatch.setenv("MOFA_TMAJOR", env)
    else:
        monkeypatch.delenv("MOFA_TMAJOR", raising=False)
    assert not tmajor_enabled(bsz, 1, quirk)
    m = seeded(TransformerSpatioTemporalModel(1, 64, 64, 1, 24, quirk), 2)
    jm = JTransformer(1, 64, 1, 24, time_context_hw_major_quirk=quirk)
    rng = np.random.RandomState(bsz)
    x = rng.randn(bsz * 3, 8, 8, 64).astype(np.float32)
    ehs = rng.randn(bsz * 3, 1, 24).astype(np.float32)
    ind = np.zeros((bsz, 3), np.float32)
    tpl = template(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(ehs), jnp.asarray(ind)))
    params = convert_torch_state_dict(tpl, sd_np(m))
    short = _spy(monkeypatch, attention, "short_attention")
    tmajor = _spy(monkeypatch, layers, "temporal_attention_tmajor")
    with torch.no_grad():
        got = m(_t(x.transpose(0, 3, 1, 2)), _t(ehs), _t(ind))
    assert not tmajor and len(short) == (bsz > 1)
    ref = jax.jit(jm.apply)(params, x, ehs, ind)
    _close(got.permute(0, 2, 3, 1).numpy(), ref)


# -------------------------------------------------------------- MICRO UNet

@pytest.fixture(scope="module")
def micro_unet():
    unet = seeded(UNetSpatioTemporalConditionModel(MICRO_UNET_CONFIG), 3)
    return (unet, *jax_unet(J_MICRO, unet))


def test_micro_unet_classic_matches_jax_and_tmajor(micro_unet, monkeypatch):
    unet, ju, ju_p = micro_unet
    rng = np.random.RandomState(2)
    b, t = 2, 3
    sample = rng.randn(b, t, 8, 8, 8).astype(np.float32)
    ehs = rng.randn(b, 1, 32).astype(np.float32)
    ids = np.tile(np.array([[6.0, 128.0, 0.02]], np.float32), (b, 1))
    run = lambda: unet(_t(sample), 15.3, _t(ehs), _t(ids)).numpy()
    monkeypatch.delenv("MOFA_TMAJOR", raising=False)
    tmajor = _spy(monkeypatch, layers, "temporal_attention_tmajor")
    with torch.no_grad():
        tm = run()
        assert tmajor
        monkeypatch.setenv("MOFA_TMAJOR", "0")
        n_tmajor = len(tmajor)
        cl = run()
    assert len(tmajor) == n_tmajor                  # classic: none at all
    ref = jax.jit(lambda p, x, e, i: ju.apply(p, x, 15.3, e, i))(
        ju_p, sample, ehs, ids)
    _close(cl, ref)
    # the two layouts compute one function (other reduction shapes only)
    _close(cl, tm, 1e-5)
