"""The port's model modules against the JAX package's, in fp32 on CPU.

Weights go port `state_dict()` -> mofa_tpu's converters -> Flax params
(tests/torch_port_util.py), so both packages run the same parameters;
`state_dict_from_flax` must carry those params back to the port's state
dict exactly. Inputs come from numpy seeds. Tolerances are fp32
summation-order bounds, relative to the output's magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models.clip_vision import CLIPVisionConfig as JCLIPConfig
from mofa_tpu.models.layers import GroupNorm as JGroupNorm
from mofa_tpu.models.layers import get_timestep_embedding as j_temb
from mofa_tpu.models.resnet_blocks import \
    SpatioTemporalResBlock as JSpatioTemporalResBlock
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG as J_MICRO
from mofa_tpu.models.transformer_blocks import \
    TransformerSpatioTemporalModel as JTransformer
from mofa_tpu.models.vae import TINY_VAE_CONFIG as J_TINY_VAE
from mofa_tpu.models.weights import convert_torch_state_dict

from mofa_tpu_torch.models.clip_vision import (CLIPVisionConfig,
                                               CLIPVisionModelWithProjection)
from mofa_tpu_torch.models.layers import GroupNorm, get_timestep_embedding
from mofa_tpu_torch.models.mofa_adapter import FlowControlNet
from mofa_tpu_torch.models.resnet_blocks import SpatioTemporalResBlock
from mofa_tpu_torch.models.svd_unet import (MICRO_UNET_CONFIG,
                                            UNetSpatioTemporalConditionModel)
from mofa_tpu_torch.models.transformer_blocks import (
    TransformerSpatioTemporalModel, time_context)
from mofa_tpu_torch.models.vae import (TINY_VAE_CONFIG,
                                       AutoencoderKLTemporalDecoder)
from mofa_tpu_torch.models.weights import state_dict_from_flax
from tests.torch_port_util import (jax_clip, jax_flow_controlnet, jax_unet,
                                   jax_vae, sd_np, seeded, template)
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)

CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
               patch_size=16, image_size=48, projection_dim=32)


def _close(got, ref, rel=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _roundtrip(module, params, family):
    """state_dict_from_flax(params) == module.state_dict(), bit for bit."""
    back = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                family)
    sd = module.state_dict()
    missing = set(sd) - set(back)
    # at layers_per_block=1 the VAE decoder's mid attention is in the
    # checkpoint but never runs; the Flax tree has no such module
    assert all(k.startswith("decoder.mid_block.attentions.") for k in missing)
    assert set(back) <= set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k].float()), k


# ------------------------------------------------------------------ layers

def test_timestep_embedding_matches_jax():
    ts = np.array([0.0, 1.0, 17.5, 999.0], np.float32)
    # sin/cos of arguments up to ~1000: one fp32 ulp of the argument
    # (6e-5) is the bound between two exp implementations
    for dim in (8, 9, 320):
        _close(get_timestep_embedding(_t(ts), dim).numpy(),
               j_temb(jnp.asarray(ts), dim), rel=1e-4)


@pytest.mark.parametrize("pool", [1, 3])
def test_group_norm_pool_leading(pool):
    rng = np.random.RandomState(pool)
    x = rng.randn(6, 64, 5, 7).astype(np.float32)                 # NCHW
    gn = seeded(GroupNorm(32, 64, eps=1e-6))
    got = gn(_t(x), pool_leading=pool).detach().numpy()
    # JAX GroupNorm on NHWC with the same params
    jm = JGroupNorm(32, 1e-6)
    params = {"params": {"scale": gn.weight.detach().numpy(),
                         "bias": gn.bias.detach().numpy()}}
    ref = jm.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)), pool_leading=pool)
    _close(got, np.asarray(ref).transpose(0, 3, 1, 2), rel=1e-5)
    if pool > 1:   # == torch's 5-D GroupNorm over C/G x T x H x W
        x5 = _t(x).reshape(2, 3, 64, 5, 7).transpose(1, 2)
        ref5 = torch.nn.functional.group_norm(x5, 32, gn.weight, gn.bias, 1e-6)
        _close(got, ref5.transpose(1, 2).reshape(6, 64, 5, 7).detach().numpy(),
               rel=1e-5)


def test_spatio_temporal_res_block_matches_jax():
    m = seeded(SpatioTemporalResBlock(32, 64, 16, eps=1e-6), 1)
    jm = JSpatioTemporalResBlock(64, eps=1e-6)
    rng = np.random.RandomState(0)
    x = rng.randn(6, 6, 5, 32).astype(np.float32)                  # [B*T,h,w,C]
    temb = rng.randn(6, 16).astype(np.float32)
    ind = np.zeros((2, 3), np.float32)
    tpl = template(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(temb), jnp.asarray(ind)))
    params = convert_torch_state_dict(tpl, sd_np(m))
    with torch.no_grad():
        got = m(_t(x.transpose(0, 3, 1, 2)), _t(temb), _t(ind))
    ref = jax.jit(jm.apply)(params, x, temb, ind)
    _close(got.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("quirk", [True, False])
def test_transformer_spatio_temporal_matches_jax(quirk):
    """B=2 (one CFG pair) exercises the pairwise HW-major context quirk,
    the tmajor temporal attention and the single-token cross-attention."""
    m = seeded(TransformerSpatioTemporalModel(2, 32, 64, 1, 24, quirk), 2)
    jm = JTransformer(2, 32, 1, 24, time_context_hw_major_quirk=quirk)
    rng = np.random.RandomState(1)
    x = rng.randn(2 * 3, 4, 5, 64).astype(np.float32)
    ehs = rng.randn(2 * 3, 1, 24).astype(np.float32)
    ind = np.zeros((2, 3), np.float32)
    tpl = template(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(ehs), jnp.asarray(ind)))
    params = convert_torch_state_dict(tpl, sd_np(m))
    with torch.no_grad():
        got = m(_t(x.transpose(0, 3, 1, 2)), _t(ehs), _t(ind))
    ref = jax.jit(jm.apply)(params, x, ehs, ind)
    _close(got.permute(0, 2, 3, 1).numpy(), ref)


def test_time_context_quirk_pairs_cfg_sides():
    tc = _t(np.arange(2 * 3, dtype=np.float32).reshape(2, 1, 3))
    ctx = time_context(tc, 5, quirk=True)                       # [2, 5, 1, 3]
    # row (b, hw) reads CFG side (b*HW + hw) % 2
    for b in range(2):
        for hw in range(5):
            assert torch.equal(ctx[b, hw, 0], tc[(b * 5 + hw) % 2, 0])
    with pytest.raises(ValueError):
        time_context(_t(np.zeros((3, 1, 3), np.float32)), 5, quirk=True)


# ------------------------------------------------------ UNet + adapter

@pytest.fixture(scope="module")
def unet_and_adapter():
    unet = seeded(UNetSpatioTemporalConditionModel(MICRO_UNET_CONFIG), 3)
    cn = seeded(FlowControlNet(MICRO_UNET_CONFIG), 4)
    return (unet, *jax_unet(J_MICRO, unet), cn, *jax_flow_controlnet(J_MICRO, cn))


def test_adapter_and_unet_match_jax(unet_and_adapter):
    unet, ju, ju_p, cn, jc, jc_p = unet_and_adapter
    rng = np.random.RandomState(2)
    b, t, h, w = 2, 3, 64, 64
    sample = rng.randn(b, t, h // 8, w // 8, 8).astype(np.float32)
    ehs = rng.randn(b, 1, 32).astype(np.float32)
    ids = np.tile(np.array([[6.0, 128.0, 0.02]], np.float32), (b, 1))
    cond = rng.rand(b, h, w, 3).astype(np.float32) * 2 - 1
    flow = (rng.rand(b, t - 1, h, w, 2).astype(np.float32) * 6 - 3)
    # a small timestep: sin/cos arguments near 500 carry one fp32 ulp
    # (3e-5) of embedding difference, which the random MLPs amplify
    with torch.no_grad():
        inject = cn.encode_features(_t(cond), _t(flow))
        down, mid = cn(_t(sample), 15.3, _t(ehs), _t(ids),
                       precomputed_features=inject)
        out = unet(_t(sample), 15.3, _t(ehs), _t(ids), down, mid)
    j_inject = jax.jit(lambda p, c, f: jc.apply(
        p, c, f, method=type(jc).encode_features))(jc_p, cond, flow)
    for g, r in zip(inject, j_inject):
        _close(g.numpy(), r, rel=1e-5)
    j_down, j_mid = jax.jit(lambda p, x, e, i, f: jc.apply(
        p, x, 15.3, e, i, precomputed_features=f))(jc_p, sample, ehs, ids,
                                                   j_inject)
    assert len(down) == len(j_down) == 8
    for g, r in zip(down + (mid,), tuple(j_down) + (j_mid,)):
        _close(g.numpy(), r)
    j_out = jax.jit(lambda p, x, e, i, d, m: ju.apply(
        p, x, 15.3, e, i, down_block_additional_residuals=d,
        mid_block_additional_residual=m))(ju_p, sample, ehs, ids, j_down, j_mid)
    _close(out.numpy(), j_out)


def test_unet_and_adapter_weights_round_trip(unet_and_adapter):
    unet, _, ju_p, cn, _, jc_p = unet_and_adapter
    _roundtrip(unet, ju_p, "unet")
    _roundtrip(cn, jc_p, "flow_controlnet")


# -------------------------------------------------------------- VAE, CLIP

def test_vae_encode_decode_match_jax():
    vae = seeded(AutoencoderKLTemporalDecoder(TINY_VAE_CONFIG), 5)
    jv, jv_p = jax_vae(J_TINY_VAE, vae)
    _roundtrip(vae, jv_p, "vae")
    rng = np.random.RandomState(3)
    img = rng.rand(2, 32, 48, 3).astype(np.float32) * 2 - 1
    z = rng.randn(6, 4, 6, 4).astype(np.float32)
    with torch.no_grad():
        lat = vae.encode_mode(_t(img))
        frames = vae.decode(_t(z), 3)
    _close(lat.numpy(), jax.jit(lambda p, x: jv.apply(
        p, x, method=type(jv).encode_mode))(jv_p, img))
    _close(frames.numpy(), jax.jit(lambda p, x: jv.apply(
        p, x, 3, method=type(jv).decode))(jv_p, z))


def test_vae_mid_attention_runs_at_two_layers_per_block():
    """layers_per_block=2 runs resnet, attention, resnet in the decoder mid
    block (the full SVD VAE); at 1 the attention is skipped."""
    cfg = dict(block_out_channels=(32, 32), layers_per_block=2)
    from mofa_tpu.models.vae import VAEConfig as JVAEConfig
    from mofa_tpu_torch.models.vae import VAEConfig
    vae = seeded(AutoencoderKLTemporalDecoder(VAEConfig(**cfg)), 6)
    jv, jv_p = jax_vae(JVAEConfig(**cfg), vae)
    _roundtrip(vae, jv_p, "vae")
    z = np.random.RandomState(4).randn(2, 5, 6, 4).astype(np.float32)
    with torch.no_grad():
        frames = vae.decode(_t(z), 2)
    _close(frames.numpy(), jax.jit(lambda p, x: jv.apply(
        p, x, 2, method=type(jv).decode))(jv_p, z))


def test_clip_matches_jax():
    clip = seeded(CLIPVisionModelWithProjection(CLIPVisionConfig(**CLIP_KW)), 7)
    jm, jp = jax_clip(JCLIPConfig(**CLIP_KW), clip)
    _roundtrip(clip, jp, "clip")
    x = np.random.RandomState(5).rand(2, 48, 48, 3).astype(np.float32)
    with torch.no_grad():
        got = clip(_t(x))
    _close(got.numpy(), jax.jit(jm.apply)(jp, x))
