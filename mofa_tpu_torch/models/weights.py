"""Checkpoint readers, and JAX (Flax) parameter trees -> this package's state dicts.

`load_safetensors` reads the safetensors format by hand (an 8-byte
little-endian header length, a JSON header of dtype / shape / data_offsets,
then the raw bytes), memory-mapped, for F32, F16, BF16 and I64;
`load_torch_checkpoint` reads a `torch.save` file with `weights_only=True`;
`save_safetensors` writes the same format (what training exports).
`init_adapter_from_unet` is the reference's `FlowControlNet.from_unet`
weight copy.

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
  family's own nesting (the adapters' `trunk`, CLIP's `vision_model`; the
  landmark adapter's `occlusions_8` / `zero_outs_8` split back into the
  reference's scale-keyed `occlusions.8` / `zero_outs.8`);
- tensors: Flax `kernel`s go back to torch `weight`s (dense [I, O] ->
  [O, I], conv HWIO -> OIHW, DHWIO -> OIDHW) and norm `scale` -> `weight`.

Real checkpoints load into this package directly with `load_state_dict`;
this module lets the tests drive both packages with the same parameters.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

FAMILIES = ("unet", "flow_controlnet", "ldmk_controlnet", "vae", "clip", "cmp")

# I64: transformers' CLIP files may carry the int64 `position_ids` buffer
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64}


def load_safetensors(path: str) -> dict:
    """A .safetensors file -> {name: CPU tensor}, read without the
    `safetensors` package. The file is mapped copy-on-write: each tensor is
    a view of the mapping (the file itself is never written). Raises on a
    dtype other than F32 / F16 / BF16 / I64 and on offsets that do not fit
    the tensor or the file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="c")
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"only {sorted(_SAFETENSORS_DTYPES)} are read")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= data.size - base or \
                end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin, end} "
                             f"for {count} x {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=base + begin).reshape(shape)
    return out


def save_safetensors(sd: dict, path: str) -> None:
    """{name: tensor} -> a .safetensors file that `load_safetensors` (and
    the `safetensors` package) reads back bit for bit: the 8-byte header
    length, the JSON header padded to 8 bytes, the tensors' bytes in order.
    Written to a temporary name and renamed, so a reader never sees half a
    file."""
    codes = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    header, off, blobs = {}, 0, []
    for name, t in sd.items():
        if t.dtype not in codes:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code here")
        blob = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + blob.size]}
        off += blob.size
        blobs.append(blob)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text)
        for blob in blobs:
            f.write(blob.tobytes())
    os.replace(tmp, path)


def init_adapter_from_unet(controlnet: torch.nn.Module,
                           unet: torch.nn.Module) -> torch.nn.Module:
    """FlowControlNet.from_unet (the reference's controlnet_sdv.py:617-627;
    mofa_tpu/models/weights.py:519): conv_in, time_embedding, down_blocks
    and mid_block copied by name from the frozen UNet into the adapter
    trunk, strictly; add_embedding, the conditioning embedding, the flow
    encoder and the zero convs keep their own init. In place; returns the
    adapter."""
    with torch.no_grad():
        for name in ("conv_in", "time_embedding", "down_blocks", "mid_block"):
            getattr(controlnet, name).load_state_dict(
                getattr(unet, name).state_dict(), strict=True)
    return controlnet


def unwrap_state_dict(checkpoint: dict) -> dict:
    """The state dict of a training checkpoint: the dict under
    "state_dict" (or "model" / "module"), `module.` prefixes stripped."""
    sd = checkpoint
    for key in ("state_dict", "model", "module"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
    return {re.sub(r"^(module\.)+", "", k): v for k, v in sd.items()}


def load_torch_checkpoint(path: str) -> dict:
    """A `torch.save` file (.bin / .pth) -> its state dict on the CPU
    (`weights_only=True`: tensors and containers, no arbitrary objects)."""
    return unwrap_state_dict(torch.load(path, map_location="cpu",
                                        weights_only=True))


def read_state_dict(path: str) -> dict:
    """A weight file -> its state dict: `.safetensors` through
    `load_safetensors`, anything else (.pth, .pth.tar, .bin, .pt) through
    `load_torch_checkpoint`."""
    return (load_safetensors(path) if path.endswith(".safetensors")
            else load_torch_checkpoint(path))


def _without_counters(sd: dict, drop=lambda k: False) -> dict:
    """`module.` prefixes stripped; BatchNorm's `num_batches_tracked` and
    the keys `drop` names removed (a BatchNorm loads strict without its
    counter)."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^(module\.)+", "", k)
        if not k.endswith("num_batches_tracked") and not drop(k):
            out[k] = v
    return out


# The face stack's checkpoints -> the state dicts its modules load with
# strict=True (the keys mofa_tpu's convert_sadtalker_exp,
# convert_sadtalker_pose, convert_face3d_recon_state_dict and
# convert_fan_state_dict read).

def sadtalker_exp_state_dict(sd: dict) -> dict:
    """audio2exp_00300-model.pth (SimpleWrapperV2) -> Audio2ExpNet's."""
    return _without_counters(sd)


def sadtalker_pose_state_dict(sd: dict) -> dict:
    """audio2pose_00140-model.pth (Audio2Pose) -> Audio2PoseCVAE's: the
    training-only CVAE encoder (`netG.encoder.*`) and discriminator
    (`netD*`) dropped."""
    return _without_counters(sd, lambda k: k.startswith(("netD", "netG.encoder.")))


def face3d_recon_state_dict(sd: dict) -> dict:
    """A Deep3DFaceRecon checkpoint (epoch_20.pth, its net under
    "net_recon") or SadTalker's combined .safetensors (the net under the
    `face_3drecon.` prefix, beside other models' keys) -> ReconNet's."""
    if isinstance(sd.get("net_recon"), dict):
        sd = sd["net_recon"]
    prefix = "face_3drecon."
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return _without_counters(sd)


def fan_state_dict(sd: dict) -> dict:
    """facexlib's alignment_WFLW_4HG.pth -> FAN's."""
    return _without_counters(sd)


def pirender_state_dict(sd: dict, prefix: str = "") -> dict:
    """A PIRenderer checkpoint -> FaceGenerator's (models/pirender.py): the
    generator under "net_G_ema" (SadTalker's facerender_pirender file), or
    under "net_G", or the state dict itself; `module.` prefixes stripped,
    then only the keys under `prefix` kept, without it (what mofa_tpu's
    convert_pirender_state_dict accepts), BatchNorm counters dropped."""
    for key in ("net_G_ema", "net_G"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
            break
    sd = _without_counters(sd)
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd

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
    "position_embedding", "controlnet_ldmk_embedding", "zero_outs",
    "matting_mask",
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
    if family in ("flow_controlnet", "ldmk_controlnet") and parts[0] == "trunk":
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
    """The inverse of mofa_tpu's `remap_cmp_key`: `layer1_0` -> layer1.0,
    `downsample_1` / `features_4` -> .1 / .4, the decoders' `decoderN_i` +
    conv|bn -> its Sequential index (a MaxPool leads decoder2/4/8),
    `fusion8` / `skipconv4` and the AlexNet encoder's `conv1` ... `fc7` +
    conv|bn -> .0 / .1, the FlowNet decoder's `deconvN` -> deconvN.0."""
    parts, i = [], 0
    while i < len(mods):
        m = mods[i]
        dec = re.fullmatch(r"(decoder([1248]))_(\d)", m)
        if dec and i + 1 < len(mods):
            conv_at = (0 if dec.group(2) == "1" else 1) + 3 * int(dec.group(3))
            parts += [dec.group(1), str(conv_at + (mods[i + 1] == "bn"))]
            i += 2
            continue
        if re.fullmatch(r"(fusion|skipconv|conv|fc)\d", m) and i + 1 < len(mods) \
                and mods[i + 1] in ("conv", "bn"):
            parts += [m, "1" if mods[i + 1] == "bn" else "0"]
            i += 2
            continue
        if re.fullmatch(r"deconv\d", m):
            parts += [m, "0"]
            i += 1
            continue
        idx = re.fullmatch(r"(layer\d|downsample|features)_(\d+)", m)
        parts += list(idx.groups()) if idx else [m]
        i += 1
    return parts


def _cmp_transposed(mods: list[str]) -> bool:
    """A FlowNet decoder's transposed conv, whose Flax kernel mofa_tpu keeps
    pre-flipped in HWIO."""
    return bool(mods) and re.fullmatch(r"deconv\d|upsampled_flow\d_to_\d", mods[-1]) is not None


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
            elif leaf == "kernel" and _cmp_transposed(mods):
                # HWIO, flipped -> ConvTranspose2d's [I, O, kh, kw]
                name, value = "weight", value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
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
