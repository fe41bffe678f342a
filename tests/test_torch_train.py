"""The port's stage-1 training slice against the JAX package, on the CPU.

- the backward of each training-path kernel (flash attention, the tmajor
  temporal attention, the LN-GEGLU FFN, the softsplat splat and its
  normaliser) against jax.vjp of the JAX kernel's custom VJP and against
  autograd of the port's plain version; each wrapper's autograd Function
  driven on the CPU with its launch replaced by the plain version;
- the EDM schedule and scalings, `add_noise`, and `edm_loss` against JAX's
  forward at MICRO widths with JAX's own draws (one jit);
- block remat against no remat, and a float64 directional-derivative
  check of the adapter's gradient;
- AdamW + clipping + EMA against optax, the freeze mask, the adapter's
  init from the UNet;
- checkpoints, the exported adapter through `load_bundle`, the flow cache
  and its teacher fingerprint, the WebVid dataset, the tiny GMFlow teacher
  and its strict loader, and `train_app --tiny --device cpu` (training,
  resume, `--precompute_flows`, the refusals).

The JAX side runs forward functions and kernel-sized VJPs only (no
`value_and_grad` of a bundle).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mofa_tpu.kernels.flash_attention import flash_attention as j_flash
from mofa_tpu.kernels.geglu_ffn import ln_geglu_ffn as j_ln_geglu_ffn
from mofa_tpu.kernels.short_attention import short_attention_tmajor as j_tmajor
from mofa_tpu.kernels.softsplat import softsplat as j_softsplat
from mofa_tpu.models.clip_vision import CLIPVisionConfig as JCLIPConfig
from mofa_tpu.models.gmflow.model import GMFlow as JGMFlow
from mofa_tpu.models.gmflow.model import GMFlowConfig as JGMFlowConfig
from mofa_tpu.models.gmflow.model import get_optical_flows as j_optical_flows
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG as J_MICRO
from mofa_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from mofa_tpu.models.weights import convert_gmflow_state_dict
from mofa_tpu.models.weights import init_adapter_from_unet as j_init_adapter
from mofa_tpu.ops.edm import edm_scalings as j_edm_scalings
from mofa_tpu.ops.euler import add_noise as j_add_noise
from mofa_tpu.pipelines.common import ModelBundle as JBundle
from mofa_tpu.train.data import WebVidDataset as JWebVidDataset
from mofa_tpu.train.flow_cache import clip_key as j_clip_key
from mofa_tpu.train.sampler import GivenIterationSampler as JSampler
from mofa_tpu.train.sampler import flow_epe as j_flow_epe
from mofa_tpu.train.stage import edm_loss as j_edm_loss
from mofa_tpu.train.state import freeze_mask as j_freeze_mask

from mofa_tpu_torch.apps import train_app
from mofa_tpu_torch.apps.loaders import load_bundle
from mofa_tpu_torch.kernels import flash_attention as flash_mod
from mofa_tpu_torch.kernels import geglu_ffn as ffn_mod
from mofa_tpu_torch.kernels import short_attention as short_mod
from mofa_tpu_torch.kernels import softsplat as splat_mod
from mofa_tpu_torch.models.clip_vision import TINY_CLIP_CONFIG, CLIPVisionConfig
from mofa_tpu_torch.models.gmflow.model import (GMFlow, TINY_GMFLOW_CONFIG,
                                                get_optical_flows, load_gmflow)
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG
from mofa_tpu_torch.models.weights import init_adapter_from_unet
from mofa_tpu_torch.ops.edm import edm_scalings, rand_cosine_interpolated
from mofa_tpu_torch.ops.euler import add_noise
from mofa_tpu_torch.pipelines.common import ModelBundle, init_random_
from mofa_tpu_torch.train.checkpoint import CheckpointManager
from mofa_tpu_torch.train.data import ResumableBatches, WebVidDataset
from mofa_tpu_torch.train.flow_cache import TeacherFlowCache, teacher_fingerprint
from mofa_tpu_torch.train.sampler import GivenIterationSampler, flow_epe
from mofa_tpu_torch.train.stage import draw, edm_loss, make_train_step
from mofa_tpu_torch.train.state import STAGE2_FROZEN, TrainState, freeze_mask
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)
from tests.torch_port_util import (_cached_templates, _tree, as_card, jax_clip,
                                   jax_flow_controlnet, jax_ldmk_controlnet,
                                   jax_unet, jax_vae, jax_vjp, jit_fast, sd_np,
                                   seeded, shapes_of, template_key, trace_tree)

CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
               patch_size=16, image_size=48, projection_dim=32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, rel):
    """max |got - ref| <= rel * max |ref| (fp32 summation orders)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max() + 1e-30, \
        (np.abs(got - ref).max(), np.abs(ref).max())


def _grads(fn, inputs, cot):
    """Autograd gradients of sum(fn(*inputs) * cot) w.r.t. every input."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(cot)
    return [t.grad for t in leaves]


# ------------------------------------------------ the kernels' backward

def test_flash_backward_matches_jax_vjp(monkeypatch):
    """Ragged lengths (Lq 200, Lk 136, neither a block multiple), fp32,
    backward chunks of 64 rows: relative 1e-4 to jax.vjp of the JAX
    flash_attention (Pallas forward in interpret mode, `_flash_bwd`) and
    to autograd of `attention_plain`; the Function's route equal to it."""
    rng = np.random.RandomState(0)
    q = rng.randn(2, 200, 2, 64).astype(np.float32)
    k, v = (rng.randn(2, 136, 2, 64).astype(np.float32) for _ in range(2))
    g = rng.randn(2, 200, 2, 64).astype(np.float32)
    plain = _grads(flash_mod.attention_plain, [_t(q), _t(k), _t(v)], _t(g))
    out = flash_mod.attention_plain(_t(q), _t(k), _t(v))
    got = flash_mod.flash_backward(_t(q), _t(k), _t(v), out, _t(g), chunk=64)
    want = jax_vjp(lambda a, b, c: j_flash(a, b, c), (q, k, v), g)
    for a, b, c in zip(got, plain, want):
        _close(a.numpy(), b.numpy(), 1e-4)
        _close(a.numpy(), c, 1e-4)
    as_card(monkeypatch, flash_mod, _launch=flash_mod.attention_plain)
    routed = _grads(flash_mod.flash_attention, [_t(q), _t(k), _t(v)], _t(g))
    for a, b in zip(routed, got):
        _close(a.numpy(), b.numpy(), 1e-6)


def test_tmajor_backward_matches_jax_vjp(monkeypatch):
    """T = 7 frames, 12 tokens, 2 heads of 64: `tmajor_backward` against
    jax.vjp of the JAX short_attention_tmajor (its `_tmajor_bwd_rule`),
    relative 1e-4; the Function's route equal to it."""
    rng = np.random.RandomState(1)
    q, k, v, g = (rng.randn(2 * 7, 12, 128).astype(np.float32) for _ in range(4))
    got = short_mod.tmajor_backward(_t(q), _t(k), _t(v), _t(g), 7, 2)
    want = jax_vjp(lambda a, b, c: j_tmajor(a, b, c, 7, 2), (q, k, v), g)
    for a, c in zip(got, want):
        _close(a.numpy(), c, 1e-4)
    as_card(monkeypatch, short_mod,
             _launch_tmajor=lambda *a: short_mod.tmajor_plain(*a))
    routed = _grads(lambda a, b, c: short_mod.short_attention_tmajor(a, b, c, 7, 2),
                    [_t(q), _t(k), _t(v)], _t(g))
    for a, b in zip(routed, got):
        _close(a.numpy(), b.numpy(), 1e-6)


def test_ln_ffn_backward_matches_jax_vjp(monkeypatch):
    """All seven gradients (dx, d LN scale, d LN shift, dW0, db0, dW2, db2)
    at C = 320, 300 rows: relative 1e-4 to jax.vjp of the JAX ln_geglu_ffn
    (`_ln_bwd_rule`; Flax layouts, so the weights transpose); the
    Function's route equal to `ln_ffn_backward`."""
    rng = np.random.RandomState(2)
    c, rows = 320, 300
    x = rng.randn(rows, c).astype(np.float32)
    ls, lb = (1 + 0.1 * rng.randn(c)).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)
    w0 = (rng.randn(8 * c, c) / np.sqrt(c)).astype(np.float32)
    b0 = (0.1 * rng.randn(8 * c)).astype(np.float32)
    w2 = (rng.randn(c, 4 * c) / np.sqrt(4 * c)).astype(np.float32)
    b2 = (0.1 * rng.randn(c)).astype(np.float32)
    g = rng.randn(rows, c).astype(np.float32)
    ops = [_t(a) for a in (x, ls, lb, w0, b0, w2, b2)]
    got = ffn_mod.ln_ffn_backward(*ops, _t(g))
    want = jax_vjp(j_ln_geglu_ffn, (x, ls, lb, w0.T, b0, w2.T, b2), g)
    for i, (a, w) in enumerate(zip(got, want)):
        a = a.numpy()
        _close(a.T if i in (3, 5) else a, w, 1e-4)
    as_card(monkeypatch, ffn_mod,
             _launch_ffn=lambda name, x, ln, ws, *a: ffn_mod.ln_ffn_plain(x, *ln, *ws))
    routed = _grads(ffn_mod.ln_geglu_ffn, ops, _t(g))
    for a, b in zip(routed, got):
        _close(a.numpy(), b.numpy(), 1e-6)


def _splat_inputs(seed, s=1, fps=3, h=13, w=17, c=5):
    rng = np.random.RandomState(seed)
    src = rng.randn(s, h, w, c).astype(np.float32)
    flow = (rng.randn(s * fps, h, w, 2) * 3).astype(np.float32)
    return src, flow, rng.randn(s * fps, h, w, c).astype(np.float32)


def test_splat_backward_matches_jax_vjp(monkeypatch):
    """'avg' softsplat at a ragged 13 x 17 from one source splatted along
    3 flows (frames_per_source): d_in and d_flow of `splat_backward` +
    `normalize_backward` against jax.vjp of the JAX softsplat (its
    `_splat_bwd`, the source expanded to the 3 frames there), relative
    1e-4; through the Functions (splat and normaliser) the same."""
    src, flow, g = _splat_inputs(3)
    acc, norm = splat_mod.splat_plain(_t(src), _t(flow), None, 3, with_norm=True)
    d_acc, d_norm = splat_mod.normalize_backward(acc, norm, "addeps", _t(g))
    d_in, d_flow, d_m = splat_mod.splat_backward(_t(src), _t(flow), None, 3,
                                                 d_acc, d_norm)
    assert d_m is None
    src3 = np.repeat(src, 3, axis=0)
    jd_in, jd_flow = jax_vjp(lambda a, f: j_softsplat(a, f, None, "avg"),
                              (src3, flow), g)
    _close(d_in.numpy(), np.asarray(jd_in).sum(0, keepdims=True), 1e-4)
    _close(d_flow.numpy(), jd_flow, 1e-4)
    plain = _grads(lambda a, f: splat_mod.softsplat(a, f, None, "avg", 3),
                   [_t(src), _t(flow)], _t(g))
    _close(d_in.numpy(), plain[0].numpy(), 1e-4)
    _close(d_flow.numpy(), plain[1].numpy(), 1e-4)

    def launch(inp, fl, m, fps, with_norm):
        out = splat_mod.splat_plain(inp, fl, m, fps, with_norm)
        return out if with_norm else (out, None)

    as_card(monkeypatch, splat_mod, _launch_splat=launch,
             _launch_normalize=splat_mod.normalize_plain)
    routed = _grads(lambda a, f: splat_mod.softsplat(a, f, None, "avg", 3),
                    [_t(src), _t(flow)], _t(g))
    _close(routed[0].numpy(), d_in.numpy(), 1e-6)
    _close(routed[1].numpy(), d_flow.numpy(), 1e-6)


@pytest.mark.parametrize("mode", ["linear", "soft-zeroeps", "sum"])
def test_splat_backward_metric_modes(monkeypatch, mode):
    """The metric modes (and 'sum', no normaliser) through the Functions:
    d_in, d_flow and d metric against autograd of the plain version,
    relative 1e-5."""
    src, flow, g = _splat_inputs(4, s=2, fps=2, h=9, w=11, c=3)
    metric = np.random.RandomState(5).randn(4, 9, 11, 1).astype(np.float32)
    inputs = [_t(src), _t(flow)] + ([] if mode == "sum" else [_t(metric)])
    fn = lambda a, f, *m: splat_mod.softsplat(a, f, m[0] if m else None, mode, 2)
    plain = _grads(fn, inputs, _t(g))

    def launch(inp, fl, m, fps, with_norm):
        out = splat_mod.splat_plain(inp, fl, m, fps, with_norm)
        return out if with_norm else (out, None)

    as_card(monkeypatch, splat_mod, _launch_splat=launch,
             _launch_normalize=splat_mod.normalize_plain)
    routed = _grads(fn, inputs, _t(g))
    for a, b in zip(routed, plain):
        _close(a.numpy(), b.numpy(), 1e-5)


# ------------------------------------------------ the EDM schedule and loss

def test_edm_schedule_and_scalings_match_jax():
    """`rand_cosine_interpolated` on injected uniforms (JAX's own draw of
    the key), `edm_scalings` and `add_noise`: relative 1e-6."""
    from mofa_tpu.ops.edm import rand_cosine_interpolated as j_rci
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (6,), dtype=jnp.float32))
    got = rand_cosine_interpolated((6,), uniform=_t(u))
    _close(got.numpy(), j_rci(key, (6,)), 1e-6)
    sig = np.asarray([0.002, 0.05, 0.7, 3.0, 80.0, 700.0], np.float32)
    for a, b in zip(edm_scalings(_t(sig)), j_edm_scalings(jnp.asarray(sig))):
        _close(a.numpy(), b, 1e-6)
    rng = np.random.RandomState(8)
    x, n = rng.randn(3, 2, 4).astype(np.float32), rng.randn(3, 2, 4).astype(np.float32)
    _close(add_noise(_t(x), _t(n), _t(sig[:3])).numpy(),
           j_add_noise(jnp.asarray(x), jnp.asarray(n), jnp.asarray(sig[:3])), 1e-6)


@pytest.fixture(scope="module")
def micro():
    """A seeded MICRO bundle (the adapter drawn from the UNet) and its
    mofa_tpu twin through the converters."""
    bundle = ModelBundle.init_random("cpu", torch.Generator().manual_seed(0),
                                     MICRO_UNET_CONFIG, TINY_VAE_CONFIG,
                                     CLIPVisionConfig(**CLIP_KW))
    unet, unet_p = jax_unet(J_MICRO, bundle.unet)
    cn, cn_p = jax_flow_controlnet(J_MICRO, bundle.controlnet)
    vae, vae_p = jax_vae(J_TINY_VAE, bundle.vae)
    clip, clip_p = jax_clip(JCLIPConfig(**CLIP_KW), bundle.clip)
    return bundle, JBundle(unet, unet_p, cn, cn_p, vae, vae_p, clip, clip_p)


def _jax_draws(key, b, t, lat):
    """The draws JAX's edm_loss makes from `key` (stage.py:84's split)."""
    from mofa_tpu.ops.edm import rand_cosine_interpolated as j_rci
    k_vae, k_noise, k_sigma, k_drop = jax.random.split(key, 4)
    return {"vae_eps": _t(np.asarray(jax.random.normal(k_vae, (b * t,) + lat))),
            "noise": _t(np.asarray(jax.random.normal(k_noise, (b, t) + lat))),
            "sigmas": _t(np.asarray(j_rci(k_sigma, (b,)))),
            "drop_p": _t(np.asarray(jax.random.uniform(k_drop, (b,))))}


def test_edm_loss_matches_jax(micro):
    """The stage-1 loss at MICRO widths, B = 4, T = 2, 64 x 64 (eight
    frames: one VAE chunk), fp32, with JAX's draws, q = 0.25 and a key
    whose dropout p puts one sample in each case (CLIP dropped; both; the
    image latent dropped; neither): relative 1e-4 to JAX's edm_loss (one
    jit; fp32 convs in other orders, the weighting up to (1 + s^2) / s^2).
    Without dropout (q = 0) the port's loss equals its loss at q = 0.25
    with every p above 3q."""
    bundle, jb = micro
    b, t, h, w = 4, 2, 64, 64
    lat = (h // 8, w // 8, 4)
    q = 0.25
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(200))
               if sorted(int(p // q) for p in np.asarray(jax.random.uniform(
                   jax.random.split(k, 4)[3], (b,)))) == [0, 1, 2, 3])
    rng = np.random.RandomState(9)
    batch = {"pixel_values01": rng.rand(b, t, h, w, 3).astype(np.float32),
             "flows": (rng.randn(b, t - 1, h, w, 2) * 2).astype(np.float32)}
    want = float(jit_fast(lambda p, bt, k: j_edm_loss(p, jb, bt, k, cond_dropout_prob=q)[0])(
        jb.controlnet_params, batch, key))
    tb = {k_: _t(v) for k_, v in batch.items()}
    draws = _jax_draws(key, b, t, lat)
    with torch.no_grad():
        got, _ = edm_loss(bundle.controlnet, bundle, tb, draws, q)
        kept = dict(draws, drop_p=torch.full((b,), 0.99))
        none, _ = edm_loss(bundle.controlnet, bundle, tb, kept, 0.0)
        none_q, _ = edm_loss(bundle.controlnet, bundle, tb, kept, q)
    assert abs(float(got) - want) <= 1e-4 * abs(want), (float(got), want)
    assert float(none) == float(none_q) and float(none) != float(got)


def test_edm_loss_ldmk_matches_jax(micro):
    """`edm_loss(ldmk=True)`: a MICRO LdmkFlowControlNet in the bundle's
    place, the batch's rasterised landmark frames [B, T, H, W, 3] passed to
    it; B = 4, T = 2, 64 x 64, JAX's draws: relative 1e-4 to JAX's
    edm_loss(ldmk=True) (one jit). Blank landmark frames change the loss."""
    import dataclasses
    from mofa_tpu_torch.models.mofa_adapter import LdmkFlowControlNet
    bundle, jb = micro
    ldmk = seeded(LdmkFlowControlNet(MICRO_UNET_CONFIG), 17)
    jcn, jcn_p = jax_ldmk_controlnet(J_MICRO, ldmk)
    jb = dataclasses.replace(jb, controlnet=jcn, controlnet_params=jcn_p)
    bundle = dataclasses.replace(bundle, controlnet=ldmk)
    b, t, h, w = 4, 2, 64, 64     # test_edm_loss_matches_jax's shapes: JAX's traces reused
    rng = np.random.RandomState(18)
    batch = {"pixel_values01": rng.rand(b, t, h, w, 3).astype(np.float32),
             "flows": (rng.randn(b, t - 1, h, w, 2) * 2).astype(np.float32),
             "landmarks": (rng.rand(b, t, h, w, 3) > 0.97).astype(np.float32)}
    key = jax.random.PRNGKey(19)
    want = float(jit_fast(lambda p, bt, k: j_edm_loss(p, jb, bt, k, cond_dropout_prob=0.1,
                                                      ldmk=True)[0])(jcn_p, batch, key))
    with torch.no_grad():
        got, _ = edm_loss(ldmk, bundle, {k_: _t(v) for k_, v in batch.items()},
                          _jax_draws(key, b, t, (h // 8, w // 8, 4)), 0.1, ldmk=True)
        blank, _ = edm_loss(ldmk, bundle, {k_: _t(v) for k_, v in dict(
            batch, landmarks=np.zeros_like(batch["landmarks"])).items()},
            _jax_draws(key, b, t, (h // 8, w // 8, 4)), 0.1, ldmk=True)
    assert abs(float(got) - want) <= 1e-4 * abs(want), (float(got), want)
    assert float(blank) != float(got)


def _micro_loss(bundle, cn, dtype, seed=10):
    """The stage-1 loss at MICRO, B = 1, T = 3, 64 x 64, fixed draws."""
    rng = np.random.RandomState(seed)
    b, t, h, w = 1, 3, 64, 64
    batch = {"pixel_values01": _t(rng.rand(b, t, h, w, 3).astype(np.float32)).to(dtype),
             "flows": _t((rng.randn(b, t - 1, h, w, 2) * 2).astype(np.float32)).to(dtype)}
    draws = {"vae_eps": _t(rng.randn(b * t, 8, 8, 4)).to(dtype),
             "noise": _t(rng.randn(b, t, 8, 8, 4)).to(dtype),
             "sigmas": torch.tensor([1.3], dtype=dtype),
             "drop_p": torch.tensor([0.9], dtype=dtype)}
    return lambda: edm_loss(cn, bundle, batch, draws, 0.1)[0]


def _grad(p):
    """p's gradient, zeros where autograd never reached it (the cross
    attention's q and k over one context token)."""
    return torch.zeros_like(p) if p.grad is None else p.grad.clone()


def _shifted(loss, params, d, h) -> float:
    """loss() with params moved by h * d (restored after)."""
    for p, di in zip(params, d):
        p.add_(h * di)
    val = float(loss())
    for p, di in zip(params, d):
        p.sub_(h * di)
    return val


def test_remat_gradients_equal_and_hold_directional_derivatives(micro):
    """The adapter's gradients with block remat (UNet and trunk) equal
    those without it, bit for bit, in fp32; in float64 (every plain
    version computes in float64 then) the gradient holds the loss's
    derivative along three random unit directions: a central difference
    at eps = 1e-6 within 1e-7 of <g, d> (its truncation error, which goes
    as eps^2, reads 4e-5 at eps = 1e-4 and 5e-9 at 1e-6; the float64
    rounding of the loss adds about 1e-8)."""
    bundle, _ = micro
    cn = bundle.controlnet
    cn.requires_grad_(True)
    try:
        loss = _micro_loss(bundle, cn, torch.float32)
        grads = []
        for remat in (False, True):
            cn.remat_blocks = bundle.unet.remat_blocks = remat
            cn.zero_grad(set_to_none=True)
            loss().backward()
            grads.append([_grad(p) for p in cn.parameters()])
        for a, b in zip(*grads):
            assert torch.equal(a, b)
        cn.remat_blocks = bundle.unet.remat_blocks = True
        for m in bundle.modules().values():
            m.double()
        loss64 = _micro_loss(bundle, cn, torch.float64)
        cn.zero_grad(set_to_none=True)
        loss64().backward()
        params = list(cn.parameters())
        g = [_grad(p) for p in params]
        gen = torch.Generator().manual_seed(11)
        gen = torch.Generator().manual_seed(11)
        eps = 1e-6
        with torch.no_grad():
            for _ in range(3):
                d = [torch.randn(p.shape, generator=gen, dtype=torch.float64)
                     for p in params]
                rnorm = float(sum((di * di).sum() for di in d)) ** 0.5
                d = [di / rnorm for di in d]
                fd = (_shifted(loss64, params, d, eps)
                      - _shifted(loss64, params, d, -eps)) / (2 * eps)
                an = float(sum((gi * di).sum() for gi, di in zip(g, d)))
                assert abs(fd - an) <= 1e-7 * abs(an), (fd, an)
    finally:
        for m in bundle.modules().values():
            m.float()
        cn.requires_grad_(False)
        cn.remat_blocks = bundle.unet.remat_blocks = False
        cn.zero_grad(set_to_none=True)


def test_init_adapter_from_unet_matches_jax(micro):
    """FlowControlNet.from_unet: the port's copy, carried to Flax, equals
    mofa_tpu's init_adapter_from_unet; the copied modules equal the
    UNet's, the others kept."""
    bundle, jb = micro
    cn = init_random_(type(bundle.controlnet)(MICRO_UNET_CONFIG),
                      torch.Generator().manual_seed(12))
    before = {k: v.clone() for k, v in cn.state_dict().items()}
    init_adapter_from_unet(cn, bundle.unet)
    _, got = jax_flow_controlnet(J_MICRO, cn)
    _, fresh = jax_flow_controlnet(J_MICRO, init_random_(
        type(bundle.controlnet)(MICRO_UNET_CONFIG), torch.Generator().manual_seed(12)))
    want = j_init_adapter(fresh, jb.unet_params)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    unet_sd = bundle.unet.state_dict()
    for k, v in cn.state_dict().items():
        copied = k.split(".")[0] in ("conv_in", "time_embedding", "down_blocks",
                                     "mid_block")
        assert torch.equal(v, unet_sd[k] if copied else before[k]), k


# ------------------------------------------------ optimizer, freeze mask

def test_adamw_clip_ema_step_matches_optax():
    """Three steps of clip-to-1.0 + AdamW (lr 1e-2 so the weights move,
    wd 1e-2) on a small two-layer tree against optax's chain, and the EMA
    against e * d + p * (1 - d) in JAX: relative 1e-5. The first step's
    gradient is clipped (norm above 1), the later ones not."""
    mod = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Linear(5, 3))
    init_random_(mod, torch.Generator().manual_seed(13))
    params = {k: jnp.asarray(v.detach().numpy().copy())
              for k, v in mod.state_dict().items()}
    state = TrainState(mod, lr=1e-2, ema=True, ema_decay=0.9)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2))
    opt = tx.init(params)
    ema = dict(params)
    rng = np.random.RandomState(14)
    for step, scale in enumerate((3.0, 0.05, 0.05)):
        g = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
             for k, v in params.items()}
        for n, p in zip(state.names, state.params):
            p.grad = _t(g[n]).clone()
        norm = state.apply_gradients()
        assert abs(float(norm) - float(optax.global_norm(g))) <= 1e-6 * float(norm)
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
        ema = {k: ema[k] * jnp.float32(0.9) + params[k] * (1 - jnp.float32(0.9))
               for k in params}
        for i, n in enumerate(state.names):
            _close(state.params[i].detach().numpy(), params[n], 1e-5)
            _close(state.ema[i].numpy(), ema[n], 1e-5)
    assert state.step == 3


def test_freeze_mask_matches_jax():
    """STAGE2_FROZEN on the port's names and on the same paths '/'-joined
    as the JAX mask sees them: the same parameters frozen; a frozen one
    gets no update."""
    from mofa_tpu_torch.models.mofa_adapter import FlowControlNet
    cn = FlowControlNet(MICRO_UNET_CONFIG)
    mask = freeze_mask(cn, STAGE2_FROZEN)
    tree = {}
    for name in mask:
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = 0.0
    jmask = j_freeze_mask({"params": tree}, STAGE2_FROZEN)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp[1:]).replace("/", "."): v
            for kp, v in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    assert flat == mask
    assert any(not v for v in mask.values()) and any(mask.values())
    state = TrainState(cn, frozen_patterns=STAGE2_FROZEN)
    assert all(mask[n] for n in state.names)
    assert not cn.flow_encoder.encoders[0].conv_in.weight.requires_grad


# ------------------------------------------------ data, cache, teacher

def _write_clips(root, n=2, frames=20, h=48, w=64, seed=0):
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    with open(os.path.join(root, "clips.csv"), "w") as f:
        f.write("videoid,page_dir,name\n")
        for i in range(n):
            vw = cv2.VideoWriter(os.path.join(root, "videos", f"v{i}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 8, (w, h))
            base = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            for k in range(frames):
                vw.write(np.roll(base, 2 * k, axis=1))
            vw.release()
            f.write(f"v{i},,clip {i}\n")
    return os.path.join(root, "clips.csv"), os.path.join(root, "videos")


def test_webvid_dataset_and_sampler_match_jax(tmp_path):
    """The port's dataset and the JAX one on cv2-written clips, one seed:
    the same clips (bit for bit), keys and RandomState draws; the sampler's
    index sequence and `flow_epe` equal to JAX's; the resumable stream at a
    start equal to the stream from 0 past that many batches."""
    csv_path, folder = _write_clips(str(tmp_path))
    kw = dict(sample_size=32, sample_stride=3, sample_n_frames=4, seed=5)
    ds, jds = WebVidDataset(csv_path, folder, **kw), JWebVidDataset(csv_path, folder, **kw)
    for i in (0, 1, 1):
        a, b = ds[i], jds[i]
        np.testing.assert_array_equal(a["pixel_values01"], b["pixel_values01"])
        assert a["clip_key"] == b["clip_key"]
        assert a["pixel_values01"].shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(GivenIterationSampler(5, 7, 2, seed=3).indices,
                                  JSampler(5, 7, 2, seed=3).indices)
    rng = np.random.RandomState(6)
    pred, gt = rng.randn(2, 5, 7, 2) * 3, rng.randn(2, 5, 7, 2) * 3
    valid = (rng.rand(2, 5, 7) > 0.3).astype(np.float32)
    for v in (None, valid):
        assert flow_epe(pred, gt, v) == j_flow_epe(pred, gt, v)
    full = list(ResumableBatches(ds, 1, 4, seed=5))
    tail = list(ResumableBatches(ds, 1, 4, seed=5, start=2))
    assert len(full) == 4 and len(tail) == 2
    for a, b in zip(full[2:], tail):
        np.testing.assert_array_equal(a["pixel_values01"], b["pixel_values01"])
        assert a["clip_key"] == b["clip_key"]
    vid, start = full[0]["clip_key"][0].split(":")[:2]
    assert full[0]["clip_key"][0] == j_clip_key(vid, int(start), 3, 4, 32)


def test_flow_cache_round_trip_fingerprint_and_contains(tmp_path):
    """A round trip (fp16 storage), `contains`, and a cache filled by one
    teacher refusing another teacher's fingerprint (the teacher's weights
    or precision changed)."""
    teacher = init_random_(GMFlow(TINY_GMFLOW_CONFIG), torch.Generator().manual_seed(0))
    fp = teacher_fingerprint(teacher, TINY_GMFLOW_CONFIG, "fp32", (64, 96))
    cache = TeacherFlowCache(str(tmp_path), fp)
    flows = np.random.RandomState(1).randn(2, 3, 8, 8, 2).astype(np.float32)
    keys = ["a:0:4x4:64", "b:1:4x4:64"]
    assert not cache.contains(keys[0]) and cache.get_batch(keys) is None
    cache.put_batch(keys, flows)
    assert cache.contains(keys[0]) and len(cache) == 2
    np.testing.assert_array_equal(cache.get_batch(keys),
                                  flows.astype(np.float16).astype(np.float32))
    assert TeacherFlowCache(str(tmp_path), fp).contains(keys[1])
    assert teacher_fingerprint(teacher, TINY_GMFLOW_CONFIG, "bf16", (64, 96)) != fp
    with torch.no_grad():
        teacher.refine_proj.bias[0] += 1.0
    other = teacher_fingerprint(teacher, TINY_GMFLOW_CONFIG, "fp32", (64, 96))
    with pytest.raises(ValueError, match="filled by teacher"):
        TeacherFlowCache(str(tmp_path), other)


class _WithPreds:
    """A JAX GMFlow for `get_optical_flows` whose apply runs the training
    mode (return_preds) and keeps the predictions, returning the flow."""

    def __init__(self, module):
        self.module, self.preds = module, None

    def apply(self, params, img0, img1):
        flow, self.preds = self.module.apply(params, img0, img1, return_preds=True)
        return flow


def test_tiny_gmflow_matches_jax_and_loads_strictly():
    """The tiny teacher (2 layers, 2 refinements) at 64 x 96 on a 3-frame
    clip, on UniMatch-named weights carried to Flax by mofa_tpu's
    converter: relative 1e-4 to JAX's get_optical_flows (op by op: its
    81-tap loops make a jit program dearer to lower and compile); the same
    JAX call run in the training mode, whose return_preds predictions (one
    a scale, one a refinement, at full size) the port's forward with
    return_preds gives within 1e-4, its flow the teacher's. `load_gmflow`
    takes `module.` prefixes and drops `upsampler.` keys; a missing key
    raises."""
    m = init_random_(GMFlow(TINY_GMFLOW_CONFIG), torch.Generator().manual_seed(2)).eval()
    jcfg = JGMFlowConfig(num_transformer_layers=2, num_reg_refine=2)
    jm = _WithPreds(JGMFlow(jcfg))
    size = (64, 96)
    jp = convert_gmflow_state_dict(_tree("gmflow", jcfg), sd_np(m))
    vid = np.random.RandomState(3).rand(1, 3, 64, 96, 3).astype(np.float32)
    got = get_optical_flows(m, _t(vid), size).numpy()
    want = np.asarray(j_optical_flows(jm, jp, jnp.asarray(vid), size))
    _close(got, want, 1e-4)
    px = _t(vid * 255.0)
    with torch.no_grad():
        flow, preds = m(px[:, 0].expand(2, -1, -1, -1), px[0, 1:], return_preds=True)
    _close(flow.numpy(), want[0], 1e-4)
    assert len(preds) == len(jm.preds) == jcfg.num_scales + jcfg.num_reg_refine
    for g, r in zip(preds, jm.preds):
        _close(g.numpy(), r, 1e-4)
    sd = {"module." + k: v for k, v in m.state_dict().items()}
    sd["upsampler.0.weight"] = torch.zeros(1)
    other = load_gmflow(GMFlow(TINY_GMFLOW_CONFIG), sd)
    for k, v in other.state_dict().items():
        assert torch.equal(v, m.state_dict()[k])
    sd.pop("module.refine_proj.bias")
    with pytest.raises(RuntimeError, match="refine_proj.bias"):
        load_gmflow(GMFlow(TINY_GMFLOW_CONFIG), sd)


def test_cached_flax_templates_match_a_fresh_trace():
    """The Flax tree shapes `_tree` reads from tests/torch_ref/
    flax_templates.json.gz equal a fresh trace of the module init, for the
    two cheapest families (the file's other trees come from the same
    script)."""
    for family, cfg in (("clip", JCLIPConfig(**CLIP_KW)), ("vae", J_TINY_VAE)):
        cached = _tree(family, cfg)
        assert shapes_of(cached) == shapes_of(trace_tree(family, cfg)), family
        assert template_key(family, cfg) in _cached_templates()


# ------------------------------------------------ the app, checkpoints

def _train_args(tmp, csv_path, folder, out, *extra):
    return train_app.build_parser().parse_args(
        ["--csv_path", csv_path, "--video_folder", folder, "--output_dir", out,
         "--device", "cpu", "--tiny", "--sample_size", "64", "--sample_n_frames",
         "3", "--sample_stride", "2", "--num_train_steps", "2",
         "--checkpointing_steps", "1", "--validation_steps", "100", "--use_ema",
         "--gradient_checkpointing", "--seed", "3", *extra])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`train_app --tiny --device cpu` for 2 steps (a checkpoint each),
    then again resumed from step 1."""
    tmp = str(tmp_path_factory.mktemp("train"))
    csv_path, folder = _write_clips(tmp, h=64, w=80)
    first = train_app.run(_train_args(tmp, csv_path, folder, os.path.join(tmp, "a")))
    resumed = train_app.run(_train_args(tmp, csv_path, folder, os.path.join(tmp, "a"),
                                        "--resume_from_checkpoint", "1"))
    return tmp, csv_path, folder, first, resumed


def test_train_app_tiny_writes_checkpoints_and_adapter(trained):
    """2 steps: finite losses and positive grad norms, checkpoints 1 and 2,
    the adapter moved from its init; the exported adapter (the EMA) read
    back by `load_bundle` strictly and bit-equal."""
    tmp, _, _, first, _ = trained
    out = os.path.join(tmp, "a")
    assert [r["step"] for r in first.records] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in first.records)
    assert CheckpointManager(os.path.join(out, "checkpoints")).all_steps() == [1, 2]
    export = os.path.join(out, "adapter_final")
    bundle = load_bundle(None, export, device="cpu", unet_cfg=MICRO_UNET_CONFIG,
                         vae_cfg=TINY_VAE_CONFIG,
                         clip_cfg=TINY_CLIP_CONFIG)
    want = first.state.export_state_dict()
    got = bundle.controlnet.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ema0 = dict(zip(first.state.names, first.state.ema))
    assert any(not torch.equal(p, ema0[n]) for n, p in
               zip(first.state.names, first.state.params))


def test_train_app_appends_each_step_to_metrics_jsonl(trained):
    """Each step's scalars go to <output_dir>/metrics.jsonl through
    MetricsWriter, appended across the resumed run: steps 1, 2, then 2
    again, each line equal to its record."""
    tmp, _, _, first, resumed = trained
    with open(os.path.join(tmp, "a", "metrics.jsonl")) as fh:
        lines = [json.loads(line) for line in fh]
    recs = first.records + resumed.records
    assert [m["step"] for m in lines] == [1, 2, 2]
    for m, r in zip(lines, recs):
        assert set(m) == {"step", "time", "loss", "grad_norm", "sigma_mean", "wall_s"}
        assert (m["loss"], m["grad_norm"], m["sigma_mean"], m["wall_s"]) == (
            r["loss"], r["grad_norm"], r["sigma_mean"], r["wall_s"])


def test_checkpoint_restore_and_resume_are_bit_exact(trained):
    """Checkpoint 2 restored into a fresh state equals the trained state bit
    for bit (params, AdamW moments and steps, EMA, step); the run resumed
    from checkpoint 1 gives step 2's loss and grad norm exactly and ends in
    the same state (one CPU thread: deterministic); a missing checkpoint
    raises."""
    tmp, _, _, first, resumed = trained
    assert [r["step"] for r in resumed.records] == [2]
    assert resumed.records[0]["loss"] == first.records[1]["loss"]
    assert resumed.records[0]["grad_norm"] == first.records[1]["grad_norm"]
    fresh = TrainState(type(first.state.model)(MICRO_UNET_CONFIG), ema=True)
    mgr = CheckpointManager(os.path.join(tmp, "a", "checkpoints"))
    extra = mgr.restore(fresh, 2)
    assert "generator" in extra and fresh.step == 2
    for a, b, c in zip(fresh.params, first.state.params, resumed.state.params):
        assert torch.equal(a, b) and torch.equal(b, c)
    for a, b in zip(fresh.ema, first.state.ema):
        assert torch.equal(a, b)
    sa, sb = fresh.optimizer.state_dict(), first.state.optimizer.state_dict()
    for i in sb["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    with pytest.raises(FileNotFoundError):
        mgr.restore(fresh, 7)


def test_precompute_flows_fills_the_cache_for_its_teacher(tmp_path):
    """`--precompute_flows` writes each scheduled clip's teacher flows once
    (a second pass finds them all), and a cache filled by the fp32 teacher
    refuses the bf16 one."""
    csv_path, folder = _write_clips(str(tmp_path), h=64, w=80)
    cache = str(tmp_path / "cache")
    args = lambda *extra: _train_args(str(tmp_path), csv_path, folder,
                                      str(tmp_path / "out"), "--flow_cache", cache,
                                      "--precompute_flows", *extra)
    assert train_app.run(args()) == 2
    assert train_app.run(args()) == 0
    with pytest.raises(ValueError, match="filled by teacher"):
        train_app.run(args("--teacher_bf16"))


def test_gradient_accumulation_averages_the_micro_batches(micro, monkeypatch):
    """`make_train_step` with 2 micro-batches: the step's loss is the mean
    of theirs, and the gradient it applies is the mean of the two
    micro-batches' gradients (relative 1e-5), as the JAX package's
    accumulation step averages them."""
    bundle, _ = micro
    cn = bundle.controlnet
    rng = np.random.RandomState(15)
    batch = {"pixel_values01": _t(rng.rand(2, 1, 2, 64, 64, 3).astype(np.float32)),
             "flows": _t((rng.randn(2, 1, 1, 64, 64, 2) * 2).astype(np.float32))}
    state = TrainState(cn, lr=0.0, weight_decay=0.0)
    try:
        singles, losses = [], []
        for i in range(2):
            cn.zero_grad(set_to_none=True)
            g = torch.Generator().manual_seed(16)
            for _ in range(i):              # draws of the earlier micro-batch
                draw(g, bundle, 1, 2, 64, 64)
            d = draw(g, bundle, 1, 2, 64, 64)
            loss, _ = edm_loss(cn, bundle, {k: v[i] for k, v in batch.items()}, d)
            loss.backward()
            losses.append(float(loss.detach()))
            singles.append([_grad(p) for p in state.params])
        cn.zero_grad(set_to_none=True)
        step = make_train_step(bundle, state, torch.Generator().manual_seed(16),
                               accum_steps=2)
        grads = []
        monkeypatch.setattr(state.optimizer, "step", lambda: grads.extend(
            p.grad.clone() for p in state.params))     # the clipped gradient
        metrics = step(batch)
        assert abs(float(metrics["loss"]) - sum(losses) / 2) <= 1e-6 * abs(sum(losses))
        norm = float(metrics["grad_norm"])
        scale = min(1.0, 1.0 / norm)                 # the clip to 1.0
        for got, a, b in zip(grads, *singles):
            _close(got.numpy(), ((a + b) / 2 * scale).numpy(), 1e-5)
    finally:
        cn.requires_grad_(False)
        cn.zero_grad(set_to_none=True)
        cn.remat_blocks = bundle.unet.remat_blocks = False


def test_train_app_refuses_what_is_not_ported(tmp_path):
    """The mesh options exit naming their ROADMAP item, before any model is
    built; stage 2, the CMP options, --overlap_inputs and --use_8bit_adam
    are ported and pass the refusal check."""
    args = _train_args(str(tmp_path), "none.csv", "none", str(tmp_path), "--mesh_data", "2")
    with pytest.raises(SystemExit, match="ROADMAP Queue 1 item 13"):
        train_app.run(args)
    for extra in (["--stage", "2"], ["--cmp_ckpt", "x"], ["--cmp_bf16"],
                  ["--overlap_inputs"], ["--use_8bit_adam"]):
        train_app.refuse_unported(_train_args(str(tmp_path), "none.csv", "none",
                                              str(tmp_path), *extra))
