"""Helpers shared by tests/test_torch_*.py: the same weights in both packages.

The port's modules are the source of weights (seeded `init_random_`);
mofa_tpu's checkpoint converters carry their `state_dict()` into Flax
param trees, exactly as they carry a real checkpoint. The Flax trees'
structure comes from `jax.eval_shape` of the module init (shapes only; an
eager Flax init of the UNet alone takes ~50 s on this CPU).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models.clip_vision import CLIPVisionModelWithProjection as JCLIP
from mofa_tpu.models.cmp.model import CMP as JCMP
from mofa_tpu.models.mofa_adapter import FlowControlNet as JFlowControlNet
from mofa_tpu.models.svd_unet import UNetSpatioTemporalConditionModel as JUNet
from mofa_tpu.models.vae import AutoencoderKLTemporalDecoder as JVAE
from mofa_tpu.models.weights import (convert_clip_vision_state_dict,
                                     convert_cmp_state_dict,
                                     convert_flow_controlnet_state_dict,
                                     convert_torch_state_dict,
                                     convert_vae_state_dict)

from mofa_tpu_torch.pipelines.common import init_random_


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a port test module's PyTorch ops on one intra-op thread.

    The tensors here are tiny, so threads buy nothing; and with several
    pytest workers on one machine, every worker's OpenMP pool spinning on
    all cores makes the small ops many times slower. Each test module
    imports this fixture (autouse), so it holds for that module only and
    the thread count is restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def seeded(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    return init_random_(module, torch.Generator().manual_seed(seed)).eval()


def sd_np(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def template(init_fn) -> dict:
    """Zero-filled Flax param tree with the structure init_fn() returns."""
    shapes = jax.eval_shape(init_fn)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


@functools.lru_cache(maxsize=None)
def _tree(family: str, cfg) -> dict:
    """The zero-filled tree of one model family at `cfg` (a frozen config),
    traced once per process: tracing the init costs seconds, and the
    converters fill a deep copy, never the tree itself."""
    z = jnp.zeros
    if family == "unet":
        return template(lambda: JUNet(cfg).init(
            jax.random.PRNGKey(0), z((1, 2, 8, 8, cfg.in_channels)), 1.0,
            z((1, 1, cfg.cross_attention_dim)), z((1, 3))))
    if family == "flow_controlnet":
        return template(lambda: JFlowControlNet(cfg).init(
            jax.random.PRNGKey(0), z((1, 2, 8, 8, cfg.in_channels)), 1.0,
            z((1, 1, cfg.cross_attention_dim)), z((1, 3)), z((1, 64, 64, 3)),
            z((1, 1, 64, 64, 2))))
    if family == "vae":
        return template(lambda: JVAE(cfg).init(jax.random.PRNGKey(0), z((1, 64, 64, 3)),
                                               num_frames=1))
    return template(lambda: JCLIP(cfg).init(
        jax.random.PRNGKey(0), z((1, cfg.image_size, cfg.image_size, 3))))


def jax_unet(cfg, torch_module):
    return JUNet(cfg), convert_torch_state_dict(_tree("unet", cfg), sd_np(torch_module))


def jax_flow_controlnet(cfg, torch_module):
    return JFlowControlNet(cfg), convert_flow_controlnet_state_dict(
        _tree("flow_controlnet", cfg), sd_np(torch_module))


def jax_vae(cfg, torch_module):
    return JVAE(cfg), convert_vae_state_dict(_tree("vae", cfg), sd_np(torch_module))


def jax_clip(cfg, torch_module):
    return JCLIP(cfg), convert_clip_vision_state_dict(_tree("clip", cfg),
                                                      sd_np(torch_module))


def cmp_template(cfg, size: int = 64) -> dict:
    """Zero-filled Flax param tree of the CMP at `cfg`."""
    m = JCMP(cfg)
    z = lambda c: jnp.zeros((1, size, size, c))
    return template(lambda: m.init(jax.random.PRNGKey(0), z(3), z(2), z(2)))


def jax_cmp(cfg, torch_module):
    """The Flax CMP holding the port CMP's weights (BatchNorm statistics
    included), through mofa_tpu's checkpoint converter, strict."""
    return JCMP(cfg), convert_cmp_state_dict(cmp_template(cfg), sd_np(torch_module),
                                             strict=True)
