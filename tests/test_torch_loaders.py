"""Reference-format weight files into the port's bundle, on the CPU.

A MICRO / TINY dual-adapter bundle (landmark adapter + trajectory adapter)
is written part by part into a diffusers-style tree in `tmp_path`, as
`.safetensors` (by the small writer below, or the `safetensors` package
where the reader is held against it) and as `torch.save` `.bin`, and read
back through `load_bundle` bit for bit. No file from outside the
repository is needed.
"""

import json

import pytest
import torch

from mofa_tpu_torch.apps.loaders import load_bundle, part_state_dict
from mofa_tpu_torch.models.clip_vision import CLIPVisionConfig
from mofa_tpu_torch.models.mofa_adapter import FlowControlNet, LdmkFlowControlNet
from mofa_tpu_torch.models.svd_unet import MICRO_UNET_CONFIG
from mofa_tpu_torch.models.vae import TINY_VAE_CONFIG, AutoencoderKLTemporalDecoder
from mofa_tpu_torch.models.weights import (load_safetensors, load_torch_checkpoint,
                                           unwrap_state_dict)
from mofa_tpu_torch.pipelines.common import ModelBundle
from mofa_tpu_torch.pipelines.hybrid import HybridPipeline
from tests.torch_port_util import one_torch_thread  # noqa: F401 (autouse)

CLIP_CFG = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                            num_heads=2, patch_size=16, image_size=48,
                            projection_dim=32)
CFGS = dict(unet_cfg=MICRO_UNET_CONFIG, vae_cfg=TINY_VAE_CONFIG, clip_cfg=CLIP_CFG)
_CODES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
          torch.int64: "I64", torch.float64: "F64"}
# where each part's file lives in a reference tree, and its name by format
DIFFUSERS = {"safetensors": "diffusion_pytorch_model.safetensors",
             "bin": "diffusion_pytorch_model.bin"}
LAYOUT = {"unet": ("svd/unet", DIFFUSERS), "vae": ("svd/vae", DIFFUSERS),
          "clip": ("svd/image_encoder", {"safetensors": "model.safetensors",
                                         "bin": "pytorch_model.bin"}),
          "controlnet": ("ldmk", DIFFUSERS), "controlnet2": ("drag", DIFFUSERS)}
POSITION_IDS = "vision_model.embeddings.position_ids"


def write_safetensors(sd: dict, path) -> None:
    """The safetensors layout: 8-byte little-endian header length, the JSON
    header (8-byte aligned, with metadata), the tensors' bytes."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in sd.items():
        raw = t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text + b"".join(blobs))


def _random_bundle(seed: int = 0) -> ModelBundle:
    return ModelBundle.init_random("cpu", torch.Generator().manual_seed(seed),
                                   **CFGS, ldmk=True, dual=True)


def _write_tree(root, bundle: ModelBundle, fmt: str, edit=None) -> dict:
    """Each part's state dict (CLIP's with transformers' `position_ids`)
    into its reference file; edit(part, sd) may change a part's dict first.
    Returns the part -> written dict."""
    written = {}
    for part, module in bundle.modules().items():
        sd = dict(module.state_dict())
        if part == "clip":
            npos = (CLIP_CFG.image_size // CLIP_CFG.patch_size) ** 2 + 1
            sd[POSITION_IDS] = torch.arange(npos)[None]
        if edit is not None:
            edit(part, sd)
        folder, names = LAYOUT[part]
        (root / folder).mkdir(parents=True, exist_ok=True)
        path = root / folder / names[fmt]
        if fmt == "safetensors":
            write_safetensors(sd, path)
        else:
            torch.save(sd, path)
        written[part] = sd
    return written


def _load(root, dtype=torch.float32):
    return load_bundle(str(root / "svd"), str(root / "ldmk"), "cpu", dtype, **CFGS,
                       controlnet2_dir=str(root / "drag"), ldmk=True)


def test_safetensors_reader_matches_the_package(tmp_path):
    """F32 / F16 / BF16 / I64 read as the `safetensors` package reads them
    (memory-mapped views, the file untouched by writes to them); any other
    dtype raises."""
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(1)
    sd = {"a": torch.randn(3, 5, generator=g),
          "b": torch.randn(7, generator=g).half(),
          "c": torch.randn(2, 3, 4, generator=g).bfloat16(),
          "ids": torch.arange(9)[None], "empty": torch.zeros(0, 3)}
    st.save_file(sd, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = load_safetensors(str(tmp_path / "x.safetensors"))
    ref = st.load_file(str(tmp_path / "x.safetensors"))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
    got["a"].add_(1.0)
    assert torch.equal(st.load_file(str(tmp_path / "x.safetensors"))["a"], sd["a"])
    write_safetensors({"d": torch.zeros(2, dtype=torch.float64)},
                      tmp_path / "d.safetensors")
    with pytest.raises(ValueError, match="'d' has dtype F64"):
        load_safetensors(str(tmp_path / "d.safetensors"))


def test_load_torch_checkpoint_unwraps(tmp_path):
    t = torch.arange(4.0)
    torch.save({"state_dict": {"module.module.w": t}, "step": 3}, tmp_path / "c.bin")
    assert list(load_torch_checkpoint(str(tmp_path / "c.bin"))) == ["w"]
    assert unwrap_state_dict({"model": {"w": t}})["w"] is t


@pytest.mark.parametrize("fmt,dtype", [("safetensors", torch.float32),
                                       ("bin", torch.float32),
                                       ("safetensors", torch.bfloat16)])
def test_load_bundle_round_trip(tmp_path, fmt, dtype):
    """Every part of a dual-adapter bundle back from its file with
    strict=True, bit for bit (in bf16: the source cast to bf16); CLIP's
    `position_ids` dropped by name."""
    src = _random_bundle()
    written = _write_tree(tmp_path, src, fmt)
    assert POSITION_IDS in written["clip"]
    got = _load(tmp_path, dtype)
    assert isinstance(got.controlnet, LdmkFlowControlNet)
    assert isinstance(got.controlnet2, FlowControlNet)
    for part, module in got.modules().items():
        ref = src.modules()[part].state_dict()
        own = module.state_dict()
        assert own.keys() == ref.keys(), part
        for k, v in own.items():
            assert v.dtype == dtype and v.device.type == "cpu", (part, k)
            assert torch.equal(v, ref[k].to(dtype)), (part, k)
        assert not module.training
    HybridPipeline(got)                       # a dual-adapter bundle


@pytest.mark.parametrize("fault", ["missing", "unexpected"])
def test_load_bundle_names_the_key_at_fault(tmp_path, fault):
    """strict=True: a key the module has and the file lacks, or the other
    way round, raises with the key's name."""
    key = "controlnet_ldmk_embedding.conv_in.weight"
    bogus = "controlnet_ldmk_embedding.conv_extra.weight"

    def edit(part, sd):
        if part == "controlnet":
            if fault == "missing":
                del sd[key]
            else:
                sd[bogus] = torch.zeros(1)

    _write_tree(tmp_path, _random_bundle(), "safetensors", edit)
    with pytest.raises(RuntimeError, match=key if fault == "missing" else bogus):
        _load(tmp_path)


def test_vae_dead_mid_block_attention_rule(tmp_path):
    """diffusers' temporal decoder holds a mid-block attention that never
    runs at layers_per_block = 1; the port's decoder keeps the module, so the
    file's keys load into it. Only a module without it has them dropped."""
    vae = AutoencoderKLTemporalDecoder(TINY_VAE_CONFIG)
    path = tmp_path / "vae.safetensors"
    write_safetensors(vae.state_dict(), path)
    dead = "decoder.mid_block.attentions."
    sd = part_state_dict("vae", str(path), vae)
    assert any(k.startswith(dead) for k in sd)
    vae.load_state_dict(sd, strict=True)
    del vae.decoder.mid_block.attentions
    sd = part_state_dict("vae", str(path), vae)
    assert not any(k.startswith(dead) for k in sd)
    vae.load_state_dict(sd, strict=True)


def test_second_adapter_exists_whenever_its_dir_is_given():
    """controlnet2_dir="" gives a seeded random trajectory adapter (the
    hybrid app's default); None gives none, which HybridPipeline refuses."""
    both = load_bundle(None, None, "cpu", **CFGS, controlnet2_dir="", ldmk=True)
    assert isinstance(both.controlnet, LdmkFlowControlNet)
    assert isinstance(both.controlnet2, FlowControlNet)
    assert both.controlnet2.flow_encoder.zeroconvs[0].weight.abs().min() > 0
    one = load_bundle(None, None, "cpu", **CFGS)
    assert one.controlnet2 is None and isinstance(one.controlnet, FlowControlNet)
    assert "controlnet2" not in one.modules()
    with pytest.raises(ValueError, match="dual-adapter"):
        HybridPipeline(one)
    # the random parts are drawn as ModelBundle.init_random draws them
    ref = ModelBundle.init_random("cpu", torch.Generator().manual_seed(0), **CFGS)
    for part, module in one.modules().items():
        assert all(torch.equal(a, b) for a, b in zip(
            module.parameters(), ref.modules()[part].parameters())), part
