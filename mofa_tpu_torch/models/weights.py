"""JAX (Flax) parameter trees -> this package's state dicts.

`state_dict_from_flax` is the exact inverse of mofa_tpu's torch -> Flax
converters (`convert_torch_state_dict`, `convert_flow_controlnet_state_dict`,
`convert_vae_state_dict`, `convert_clip_vision_state_dict`, and for the
"cmp" family `convert_cmp_state_dict`, whose Sequential indices and
BatchNorm buffers (`mean` / `var` -> `running_mean` / `running_var`) are
restored by `_cmp_parts`):

- names: Flax folds torch list indices into names (`down_blocks.0` ->
  `down_blocks_0`) and flattens some paths (`mid_block_resnets_0`); the
  inverse splits them with the vocabulary of this package's module names,
  drops the Flax wrapper levels (`Conv_0`, `Dense_0`), and restores each
  family's own nesting (the adapter's `trunk`, CLIP's `vision_model`);
- tensors: Flax `kernel`s go back to torch `weight`s (dense [I, O] ->
  [O, I], conv HWIO -> OIHW, DHWIO -> OIDHW) and norm `scale` -> `weight`.

Real checkpoints load into this package directly with `load_state_dict`;
this module lets the tests drive both packages with the same parameters.
"""

from __future__ import annotations

import re

import numpy as np
import torch

FAMILIES = ("unet", "flow_controlnet", "vae", "clip", "cmp")

# module / parameter names of this package that contain underscores or
# digits (single words need no entry: any unknown token stands alone)
_VOCAB = {
    "down_blocks", "up_blocks", "mid_block", "conv_in", "conv_out",
    "conv_shortcut", "time_emb_proj", "spatial_res_block",
    "temporal_res_block", "time_mixer", "mix_factor", "transformer_blocks",
    "temporal_transformer_blocks", "norm_in", "ff_in", "to_q", "to_k", "to_v",
    "to_out", "proj_in", "proj_out", "time_pos_embed", "linear_1", "linear_2",
    "time_embedding", "add_embedding", "conv_norm_out",
    "controlnet_down_blocks", "controlnet_mid_block",
    "controlnet_cond_embedding", "flow_encoder", "quant_conv", "group_norm",
    "time_conv_out", "self_attn", "q_proj", "k_proj", "v_proj", "out_proj",
    "layer_norm1", "layer_norm2", "pre_layrnorm", "post_layernorm",
    "visual_projection", "patch_embedding", "class_embedding",
    "position_embedding",
}
_WRAPPERS = {"Conv_0", "Dense_0"}


def _split_name(name: str) -> list[str]:
    """'mid_block_resnets_0' -> ['mid_block', 'resnets', '0']."""
    tokens = name.split("_")
    out, i = [], 0
    while i < len(tokens):
        for j in range(len(tokens), i, -1):
            cand = "_".join(tokens[i:j])
            if cand in _VOCAB or j == i + 1:
                out.append(cand)
                i = j
                break
    return out


def _to_torch(leaf: str, value: np.ndarray):
    """Flax leaf -> (torch leaf name, tensor value)."""
    if leaf == "kernel":
        perm = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
        return "weight", value.transpose(perm[value.ndim])
    if leaf == "scale":
        return "weight", value
    return leaf, value


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _family_key(family: str, parts: list[str]) -> list[str]:
    if family == "flow_controlnet" and parts[0] == "trunk":
        return parts[1:]
    if family == "clip":
        head = parts[0]
        if head in ("patch_embedding", "class_embedding", "position_embedding"):
            return ["vision_model", "embeddings"] + parts
        if head == "layers":
            return ["vision_model", "encoder"] + parts
        if head in ("pre_layrnorm", "post_layernorm"):
            return ["vision_model"] + parts
    return parts


def _cmp_parts(mods: list[str]) -> list[str]:
    """The inverse of mofa_tpu's `remap_cmp_key` for the shipped CMP:
    `layer1_0` -> layer1.0, `downsample_1` / `features_4` -> .1 / .4, the
    decoder's `decoderN_i` + conv|bn -> its Sequential index (a MaxPool leads
    decoder2/4/8), `fusion8` / `skipconv4` + conv|bn -> .0 / .1."""
    parts, i = [], 0
    while i < len(mods):
        m = mods[i]
        dec = re.fullmatch(r"(decoder([1248]))_(\d)", m)
        if dec and i + 1 < len(mods):
            conv_at = (0 if dec.group(2) == "1" else 1) + 3 * int(dec.group(3))
            parts += [dec.group(1), str(conv_at + (mods[i + 1] == "bn"))]
            i += 2
            continue
        if re.fullmatch(r"(fusion|skipconv)\d", m) and i + 1 < len(mods):
            parts += [m, "1" if mods[i + 1] == "bn" else "0"]
            i += 2
            continue
        idx = re.fullmatch(r"(layer\d|downsample|features)_(\d+)", m)
        parts += list(idx.groups()) if idx else [m]
        i += 1
    return parts


def state_dict_from_flax(params_np: dict, family: str) -> dict:
    """Flax param tree (numpy leaves, with or without the top 'params'
    level) of `family` in FAMILIES -> this package's state dict (fp32)."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    root = params_np.get("params", params_np)
    sd = {}
    for path, value in _flatten(root):
        value = np.asarray(value, dtype=np.float32)
        *mods, leaf = path
        if family == "cmp":                  # BatchNorm mean / var: buffers
            if leaf in ("mean", "var"):
                name = f"running_{leaf}"
            else:
                name, value = _to_torch(leaf, value)
            key = ".".join(_cmp_parts(mods) + [name])
            sd[key] = torch.from_numpy(np.ascontiguousarray(value))
            continue
        parts = []
        for m in mods:
            if m not in _WRAPPERS:
                parts += _split_name(m)
        if family == "clip" and not parts and leaf == "position_embedding":
            parts, name = ["position_embedding"], "weight"     # nn.Embedding
        else:
            name, value = _to_torch(leaf, value)
        key = ".".join(_family_key(family, parts + [name]))
        sd[key] = torch.from_numpy(np.ascontiguousarray(value))
    return sd
