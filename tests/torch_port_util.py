"""Helpers shared by tests/test_torch_*.py: the same weights in both packages.

The port's modules are the source of weights (seeded `init_random_`);
mofa_tpu's checkpoint converters carry their `state_dict()` into Flax
param trees, exactly as they carry a real checkpoint. The Flax trees'
structure comes from `jax.eval_shape` of the module init (shapes only; an
eager Flax init of the UNet alone takes ~50 s on this CPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mofa_tpu.models.clip_vision import CLIPVisionModelWithProjection as JCLIP
from mofa_tpu.models.mofa_adapter import FlowControlNet as JFlowControlNet
from mofa_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JUNet
from mofa_tpu.models.vae import AutoencoderKLTemporalDecoder as JVAE
from mofa_tpu.models.weights import (convert_clip_vision_state_dict,
                                     convert_flow_controlnet_state_dict,
                                     convert_torch_state_dict,
                                     convert_vae_state_dict)

from mofa_tpu_torch.pipelines.common import init_random_


def seeded(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    return init_random_(module, torch.Generator().manual_seed(seed)).eval()


def sd_np(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def template(init_fn) -> dict:
    """Zero-filled Flax param tree with the structure init_fn() returns."""
    shapes = jax.eval_shape(init_fn)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def jax_unet(cfg, torch_module):
    m = JUNet(cfg)
    tpl = template(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, cfg.in_channels)), 1.0,
        jnp.zeros((1, 1, cfg.cross_attention_dim)), jnp.zeros((1, 3))))
    return m, convert_torch_state_dict(tpl, sd_np(torch_module))


def jax_flow_controlnet(cfg, torch_module):
    m = JFlowControlNet(cfg)
    tpl = template(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, cfg.in_channels)), 1.0,
        jnp.zeros((1, 1, cfg.cross_attention_dim)), jnp.zeros((1, 3)),
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 64, 64, 2))))
    return m, convert_flow_controlnet_state_dict(tpl, sd_np(torch_module))


def jax_vae(cfg, torch_module):
    m = JVAE(cfg)
    tpl = template(lambda: m.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 64, 64, 3)), num_frames=1))
    return m, convert_vae_state_dict(tpl, sd_np(torch_module))


def jax_clip(cfg, torch_module):
    m = JCLIP(cfg)
    tpl = template(lambda: m.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.image_size, cfg.image_size, 3))))
    return m, convert_clip_vision_state_dict(tpl, sd_np(torch_module))
