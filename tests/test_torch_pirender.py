"""The port's PIRender face generator (mofa_tpu_torch/models/pirender.py) against mofa_tpu's, on the CPU.

The weights are the port's seeded state dict under the reference's names,
carried into Flax by mofa_tpu's `convert_pirender_state_dict` (strict):
the ConvTranspose2d weights [I, O, 3, 3] as they are, the LayerNorm2d
affines [C, 1, 1], the Sequential nestings. At TINY_PIRENDER_CONFIG, 64^2,
fp32, batch 2, within 1e-4 of max(1, max |JAX|):

- `FaceGenerator`'s flow_field, warp_image and fake_image (one JAX
  compile for the module);
- the ConvTranspose2d (k3 s2 p1 op1) and LayerNorm2d each alone;
- `pirender_animation` over 3 frames against per-frame JAX calls;
- the checkpoint reader (`net_G_ema`, `module.`, a prefix) loaded strict
  and bit-equal, and a missing key refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models import pirender as JP
from mofa_tpu.models.weights import convert_pirender_state_dict

from mofa_tpu_torch.models import pirender as PP
from mofa_tpu_torch.models.weights import load_torch_checkpoint, pirender_state_dict
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   jit_fast, one_torch_thread, sd_np, seeded, template)

CFG = PP.TINY_PIRENDER_CONFIG
S = 64
TOL = 1e-4


def _close(got, want, msg=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * scale, err_msg=msg)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def nets():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JP.TINY_PIRENDER_CONFIG)
    port = seeded(PP.FaceGenerator(CFG), 3)
    jnet = JP.FaceGenerator(JP.TINY_PIRENDER_CONFIG)
    tree = template(lambda: jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)),
                                      jnp.zeros((1, 73, 27))))
    params = convert_pirender_state_dict(tree, sd_np(port), strict=True)
    apply = jit_fast(lambda img, sem: jnet.apply(params, img, sem))
    rng = np.random.RandomState(0)
    img = rng.rand(2, S, S, 3).astype(np.float32)
    sems = rng.randn(2, 3, 73, 27).astype(np.float32)
    return port, jnet, params, apply, img, sems


def test_face_generator_matches_jax(nets):
    port, _, _, apply, img, sems = nets
    want = apply(img, sems[:, 0])
    with torch.no_grad():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(sems[:, 0]))
    assert got["flow_field"].shape == (2, 2, S // 2, S // 2)
    for key in ("flow_field", "warp_image", "fake_image"):
        _close(nhwc(got[key]), want[key], key)
    with torch.no_grad():
        warp_only = port(torch.from_numpy(img).permute(0, 3, 1, 2),
                         torch.from_numpy(sems[:, 0]), stage="warp")
    assert "fake_image" not in warp_only
    torch.testing.assert_close(warp_only["warp_image"], got["warp_image"], rtol=0, atol=0)


def test_conv_transpose_and_layer_norm_alone(nets):
    """The decoder's ConvTranspose2d against JAX's input-dilated conv on
    the converter's flipped HWIO kernel, and LayerNorm2d on its squeezed
    affine."""
    port, _, params, _, _, _ = nets
    rng = np.random.RandomState(1)
    block = port.warpping_net.hourglass.decoder.decoder1
    x = rng.randn(2, 7, 5, block.conv_s.in_channels).astype(np.float32)
    p = params["params"]["warpping_net"]["hourglass"]["decoder_1"]["conv_s"]
    want = JP.TorchConvTranspose2d(block.conv_s.out_channels).apply({"params": p}, x)
    with torch.no_grad():
        got = block.conv_s(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, block.conv_s.out_channels, 14, 10)
    _close(nhwc(got), want, "ConvTranspose2d")

    norm = port.warpping_net.flow_out[0]
    x = rng.randn(2, 6, 4, norm.weight.shape[0]).astype(np.float32) * 3 + 1
    p = params["params"]["warpping_net"]["flow_norm"]
    want = JP.LayerNorm2d().apply({"params": p}, x)
    with torch.no_grad():
        got = norm(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(nhwc(got), want, "LayerNorm2d")


def test_pirender_animation_matches_per_frame_jax(nets):
    port, _, _, apply, img, sems = nets
    got = PP.pirender_animation(torch.from_numpy(img).permute(0, 3, 1, 2),
                                torch.from_numpy(sems), port)
    assert got.shape == (2, 3, 3, S, S)
    for f in range(3):
        _close(nhwc(got[:, f]), apply(img, sems[:, f])["fake_image"], f"frame {f}")
    assert float(got.abs().max()) <= 1.0


def test_checkpoint_reader_strict_round_trip(nets, tmp_path):
    """SadTalker's layout ({"net_G_ema": ...}, `module.` prefixed) through a
    torch.save file, and a state dict under a prefix, load strict into a
    fresh generator whose outputs equal the seeded one's bit for bit; a
    checkpoint without one tensor is refused."""
    port, _, _, _, img, sems = nets
    sd = port.state_dict()
    path = tmp_path / "pirender.pt"
    torch.save({"net_G_ema": {"module." + k: v for k, v in sd.items()},
                "net_G": {}}, path)
    fresh = PP.FaceGenerator(CFG).eval()
    fresh.load_state_dict(pirender_state_dict(load_torch_checkpoint(str(path))), strict=True)
    nested = {"pirender." + k: v for k, v in sd.items()}
    nested["other.weight"] = torch.zeros(1)
    again = PP.FaceGenerator(CFG).eval()
    again.load_state_dict(pirender_state_dict(nested, prefix="pirender."), strict=True)
    x, s = torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(sems[:, 1])
    with torch.no_grad():
        want = port(x, s)["fake_image"]
        for net in (fresh, again):
            torch.testing.assert_close(net(x, s)["fake_image"], want, rtol=0, atol=0)
    # the dead branch's parameters are part of the checkpoint
    assert "editing_net.decoder.res0.res0.conv1.weight" in sd
    short = dict(sd)
    short.pop("warpping_net.hourglass.decoder.decoder1.conv_1.weight")
    with pytest.raises(RuntimeError, match="conv_1.weight"):
        PP.FaceGenerator(CFG).load_state_dict(pirender_state_dict(short), strict=True)
