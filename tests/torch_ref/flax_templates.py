"""Writes tests/torch_ref/flax_templates.json.gz: the shapes of the Flax
param trees the port tests build, traced from mofa_tpu's module inits
(the MICRO UNet and both adapters, the tiny VAEs and CLIP of the port
tests, the tiny and the shipped CMP, the tiny GMFlow).

    JAX_PLATFORMS=cpu python -m tests.torch_ref.flax_templates

`tests/torch_port_util.py::_tree` reads the file instead of tracing each
of these inits again in every test process.
"""

import dataclasses
import gzip
import json

import jax

from mofa_tpu.models.clip_vision import CLIPVisionConfig
from mofa_tpu.models.cmp.model import TINY_CMP_CONFIG, CMPConfig
from mofa_tpu.models.gmflow.model import GMFlowConfig
from mofa_tpu.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu.models.vae import TINY_VAE_CONFIG, VAEConfig

# the tiny CLIP of tests/test_fullchain_parity.py, as the port tests build it
CLIP_KW = dict(hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
               patch_size=16, image_size=48, projection_dim=32)
ENTRIES = (("unet", MICRO_UNET_CONFIG), ("flow_controlnet", MICRO_UNET_CONFIG),
           ("ldmk_controlnet", MICRO_UNET_CONFIG), ("vae", TINY_VAE_CONFIG),
           ("clip", CLIPVisionConfig(**CLIP_KW)), ("cmp", TINY_CMP_CONFIG),
           ("cmp", CMPConfig()),
           ("gmflow", GMFlowConfig(num_transformer_layers=2, num_reg_refine=2)),
           # test_torch_hybrid.py's join-by-height adapter and
           # test_torch_models.py's two-layer VAE
           ("ldmk_controlnet", dataclasses.replace(
               MICRO_UNET_CONFIG, block_out_channels=(32, 32, 64, 64))),
           ("vae", VAEConfig(block_out_channels=(32, 32), layers_per_block=2)))


def main():
    jax.config.update("jax_platforms", "cpu")
    from tests.torch_port_util import (TEMPLATE_FILE, shapes_of, template_key,
                                       trace_tree)
    out = {template_key(f, c): shapes_of(trace_tree(f, c)) for f, c in ENTRIES}
    with gzip.open(TEMPLATE_FILE, "wt") as f:
        json.dump(out, f, sort_keys=True)
    print(f"{TEMPLATE_FILE}: {len(out)} trees")


if __name__ == "__main__":
    main()
