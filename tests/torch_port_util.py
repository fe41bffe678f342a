"""Helpers shared by tests/test_torch_*.py: the same weights in both packages.

The port's modules are the source of weights (seeded `init_random_`);
mofa_tpu's checkpoint converters carry their `state_dict()` into Flax
param trees, exactly as they carry a real checkpoint. The Flax trees'
structure comes from `jax.eval_shape` of the module init (shapes only; an
eager Flax init of the UNet alone takes ~50 s on a CPU). The trees the
port tests build in many modules (`_tree`: the MICRO UNet and adapters,
the tiny VAE, CLIP, CMP and GMFlow) are traced once, offline, by
`python -m tests.torch_ref.flax_templates`, which writes their shapes to
tests/torch_ref/flax_templates.json.gz; `_tree` reads them from there
(`test_cached_flax_templates_match_a_fresh_trace` holds two of them to a
fresh trace) and traces any other config as before.
"""

from __future__ import annotations

import functools
import gzip
import json
import os

import flax.core.meta
import flax.core.scope
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models.clip_vision import CLIPVisionModelWithProjection as JCLIP
from mofa_tpu.models.cmp.model import CMP as JCMP
from mofa_tpu.models.mofa_adapter import FlowControlNet as JFlowControlNet
from mofa_tpu.models.mofa_adapter import LdmkFlowControlNet as JLdmkFlowControlNet
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


def _param_no_recheck(self, name, init_fn, *init_args, unbox=True, **init_kwargs):
    """Flax's `Scope.param` without its apply-time shape re-check.

    On every apply, Flax traces each existing parameter's initializer
    (`jax.eval_shape`) only to compare shapes: about 900 traces, some 4 s,
    per trace of the MICRO UNet, nearly half of it. The trees here come
    from mofa_tpu's strict converters, which hold every shape against a
    template traced from the module's own init, so the re-check finds
    nothing new. A parameter that does not exist yet takes Flax's own
    path."""
    if not self.has_variable("params", name):
        if _shapes_only and init_args and _is_shape(init_args[0]):
            init_fn = _zeros_init
        return _FLAX_PARAM(self, name, init_fn, *init_args, unbox=unbox,
                           **init_kwargs)
    self.reserve(name, "params")
    value = self.get_variable("params", name)
    return flax.core.meta.unbox(value) if unbox else value


_FLAX_PARAM = flax.core.scope.Scope.param
_shapes_only = False        # True while `template` traces an init


def _is_shape(arg) -> bool:
    return isinstance(arg, tuple) and all(isinstance(d, int) for d in arg)


def _zeros_init(_key, shape, dtype=jnp.float32):
    """What `template` keeps of an initializer: its shape and dtype (the
    template is zeros either way); tracing Flax's random initializers cost
    about 5 ms a parameter."""
    return jnp.zeros(shape, dtype)


@pytest.fixture(scope="module", autouse=True)
def flax_apply_without_shape_recheck():
    """Run a port test module's Flax applies without the shape re-check of
    `_param_no_recheck` (each test module imports this fixture, autouse);
    Flax's own method is restored after the module."""
    flax.core.scope.Scope.param = _param_no_recheck
    yield
    flax.core.scope.Scope.param = _FLAX_PARAM


# XLA CPU compile options for one-shot test programs: the backend's
# optimisation off and LLVM's expensive passes skipped (the MICRO edm_loss
# compiles in about 12 s instead of about 40; fp32 math either way)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jit_fast(fn):
    """jax.jit(fn), each new argument signature compiled with FAST_COMPILE
    (the compiled programs kept per signature)."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree_util.tree_flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(compiler_options=FAST_COMPILE)
        return compiled[key](*args)

    return call


def jax_vjp(fn, args, cot):
    """jax.vjp of fn at args applied to cot, as one jit program (eager
    dispatch of the interpret-mode kernels costs several times more)."""
    return jit_fast(lambda a, c: jax.vjp(fn, *a)[1](c))(tuple(args), cot)


def as_card(monkeypatch, mod, **launches):
    """`mod`'s wrappers as on a card (use_kernel True), each named launch
    function replaced by a plain-version stand-in: the autograd Functions
    then run on the CPU."""
    monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
    for name, fn in launches.items():
        monkeypatch.setattr(mod, name, fn)


def seeded(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    return init_random_(module, torch.Generator().manual_seed(seed)).eval()


def sd_np(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def template(init_fn) -> dict:
    """Zero-filled Flax param tree with the structure init_fn() returns
    (each parameter whose initializer takes a shape traced as zeros of it,
    under the module's `flax_apply_without_shape_recheck`)."""
    global _shapes_only
    _shapes_only = True
    try:
        shapes = jax.eval_shape(init_fn)
    finally:
        _shapes_only = False
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


TEMPLATE_FILE = os.path.join(os.path.dirname(__file__), "torch_ref",
                             "flax_templates.json.gz")


def template_key(family: str, cfg) -> str:
    return f"{family}|{cfg!r}"


@functools.lru_cache(maxsize=None)
def _cached_templates() -> dict:
    if not os.path.exists(TEMPLATE_FILE):
        return {}
    with gzip.open(TEMPLATE_FILE, "rt") as f:
        return json.load(f)


def tree_from_shapes(flat: dict) -> dict:
    """{"a/b/leaf": [shape, dtype]} -> the nested zero-filled tree."""
    tree: dict = {}
    for path, (shape, dtype) in flat.items():
        node = tree
        *parts, leaf = path.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = np.zeros(shape, dtype)
    return tree


def shapes_of(tree: dict) -> dict:
    """The inverse of `tree_from_shapes`."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(k.key for k in kp): [list(v.shape), str(v.dtype)]
            for kp, v in flat}


@functools.lru_cache(maxsize=None)
def _tree(family: str, cfg) -> dict:
    """The zero-filled tree of one model family at `cfg` (a frozen config):
    from TEMPLATE_FILE where it holds the config, else traced, once per
    process (tracing the init costs seconds; the converters fill a deep
    copy, never the tree itself)."""
    cached = _cached_templates().get(template_key(family, cfg))
    if cached is not None:
        return tree_from_shapes(cached)
    return trace_tree(family, cfg)


def trace_tree(family: str, cfg) -> dict:
    """`_tree` by tracing the Flax init."""
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
    if family == "ldmk_controlnet":
        return template(lambda: JLdmkFlowControlNet(cfg).init(
            jax.random.PRNGKey(0), z((1, 2, 8, 8, cfg.in_channels)), 1.0,
            z((1, 1, cfg.cross_attention_dim)), z((1, 3)), z((1, 64, 64, 3)),
            z((1, 1, 64, 64, 2)), z((1, 2, 64, 64, 3))))
    if family == "vae":
        return template(lambda: JVAE(cfg).init(jax.random.PRNGKey(0), z((1, 64, 64, 3)),
                                               num_frames=1))
    if family == "cmp":
        m = JCMP(cfg)
        x = lambda c: z((1, 64, 64, c))
        return template(lambda: m.init(jax.random.PRNGKey(0), x(3), x(2), x(2)))
    if family == "gmflow":
        from mofa_tpu.models.gmflow.model import GMFlow as JGMFlow
        img = z((1, 64, 96, 3))
        return template(lambda: JGMFlow(cfg).init(jax.random.PRNGKey(0), img, img))
    return template(lambda: JCLIP(cfg).init(
        jax.random.PRNGKey(0), z((1, cfg.image_size, cfg.image_size, 3))))


def jax_unet(cfg, torch_module):
    return JUNet(cfg), convert_torch_state_dict(_tree("unet", cfg), sd_np(torch_module))


def jax_flow_controlnet(cfg, torch_module):
    return JFlowControlNet(cfg), convert_flow_controlnet_state_dict(
        _tree("flow_controlnet", cfg), sd_np(torch_module))


def jax_ldmk_controlnet(cfg, torch_module):
    """The Flax landmark adapter holding the port's weights, through
    mofa_tpu's adapter converter (strict)."""
    return JLdmkFlowControlNet(cfg), convert_flow_controlnet_state_dict(
        _tree("ldmk_controlnet", cfg), sd_np(torch_module))


def jax_vae(cfg, torch_module):
    return JVAE(cfg), convert_vae_state_dict(_tree("vae", cfg), sd_np(torch_module))


def jax_clip(cfg, torch_module):
    return JCLIP(cfg), convert_clip_vision_state_dict(_tree("clip", cfg),
                                                      sd_np(torch_module))


def cmp_template(cfg) -> dict:
    """Zero-filled Flax param tree of the CMP at `cfg` (a deep copy)."""
    import copy
    return copy.deepcopy(_tree("cmp", cfg))


def jax_cmp(cfg, torch_module):
    """The Flax CMP holding the port CMP's weights (BatchNorm statistics
    included), through mofa_tpu's checkpoint converter, strict."""
    return JCMP(cfg), convert_cmp_state_dict(cmp_template(cfg), sd_np(torch_module),
                                             strict=True)
