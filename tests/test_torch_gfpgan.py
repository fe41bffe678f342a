"""The port's GFPGAN and enhancer stage against mofa_tpu's, on the CPU.

- GFPGANv1Clean at TINY_GFPGAN_CONFIG (both latent modes) with the port's
  seeded state dict carried into Flax by mofa_tpu's
  `convert_gfpgan_state_dict` (strict), within 1e-4 of max |JAX|;
  `enhance_aligned` against mofa_tpu's on [4, 48, 40, 3] frames;
- the checkpoint reader: GFPGANv1.4.pth's {"params_ema": ...} and a flat
  file loaded strict, bit-equal; a file missing a tensor refused;
- `paste_back_frames` equal to mofa_tpu's (cv2 on both sides), `crop_box`,
  and the `enhance_frames` contract (none / npz / gfpgan / errors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models import gfpgan as JG
from mofa_tpu.models.weights import convert_gfpgan_state_dict
from mofa_tpu.preprocess import enhance as JE

from mofa_tpu_torch.models import gfpgan as PG
from mofa_tpu_torch.preprocess import enhance as PE
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   jit_fast, one_torch_thread, sd_np, template)

CFG = PG.TINY_GFPGAN_CONFIG


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _pair(input_is_latent=True, different_w=True, seed=0):
    port = PG.init_gfpgan_(PG.GFPGANv1Clean(**CFG, input_is_latent=input_is_latent,
                                            different_w=different_w),
                           torch.Generator().manual_seed(seed)).eval()
    jm = JG.GFPGANv1Clean(**CFG, input_is_latent=input_is_latent, different_w=different_w)
    s = CFG["out_size"]
    tree = template(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3))))
    return port, jm, convert_gfpgan_state_dict(tree, sd_np(port))


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("latent", [True, False])
def test_gfpgan_matches_jax(pair, latent):
    """input_is_latent (GFPGANv1.4) and the style-MLP path (not
    different_w): the grouped modulated convs, SFT, the stored noise."""
    port, jm, params = pair if latent else _pair(False, False, seed=1)
    s = CFG["out_size"]
    x = np.random.RandomState(1).rand(2, s, s, 3).astype(np.float32) * 2 - 1
    want = jit_fast(jm.apply)(params, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, s, s, 3) and np.abs(got).max() > 0.1
    _close(got, want)


def test_enhance_aligned_matches_jax(pair):
    port, jm, params = pair
    # two batches of the same shape: one JAX compile
    frames = np.random.RandomState(4).rand(4, 48, 40, 3).astype(np.float32)
    want = JG.enhance_aligned(jm, params, frames, batch=2)
    got = PG.enhance_aligned(port, frames, batch=2)
    assert got.shape == frames.shape and got.min() >= 0 and got.max() <= 1
    _close(got, want)


def test_checkpoint_reader_strict(tmp_path):
    port = PG.init_gfpgan_(PG.GFPGANv1Clean(**CFG), torch.Generator().manual_seed(5))
    sd = port.state_dict()
    for name, blob in (("ema.pth", {"params_ema": sd, "params": {}}),
                       ("flat.pth", {f"module.{k}": v for k, v in sd.items()})):
        torch.save(blob, tmp_path / name)
        got = PG.load_gfpgan(str(tmp_path / name), "cpu", tiny=True).state_dict()
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert any(k.startswith("stylegan_decoder.noises.noise") for k in sd)
    torch.save({"params_ema": {k: v for k, v in sd.items() if "to_rgb1" not in k}},
               tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="to_rgb1"):
        PG.load_gfpgan(str(tmp_path / "short.pth"), "cpu", tiny=True)


def _crop_info():
    return ((64, 64), (10, 8, 58, 56), (4, 2, 40, 44))


def test_paste_back_matches_jax():
    rng = np.random.RandomState(0)
    full = (rng.rand(80, 90, 3) * 255).astype(np.uint8)
    crops = (rng.rand(3, 32, 32, 3) * 100 + 120).astype(np.uint8)
    for ext in (False, True):
        assert PE.crop_box(_crop_info(), ext) == JE.crop_box(_crop_info(), ext)
        np.testing.assert_array_equal(PE.paste_back_frames(crops, full, _crop_info(), ext),
                                      JE.paste_back_frames(crops, full, _crop_info(), ext))
    with pytest.raises(ValueError):
        PE.paste_back_frames(crops[:1], full[:20, :20], ((64, 64), (5, 5, 6, 6), (3, 3, 1, 1)))


def test_enhance_frames_contract(tmp_path):
    frames = (np.random.RandomState(6).rand(2, 16, 16, 3) * 255).astype(np.uint8)
    assert PE.enhance_frames(frames, "none") is frames
    enhanced = np.full((2, 16, 16, 3), 7, np.uint8)
    np.savez(tmp_path / "enh.npz", frames=enhanced)
    np.testing.assert_array_equal(PE.enhance_frames(frames, "npz", str(tmp_path / "enh.npz")),
                                  enhanced)
    np.savez(tmp_path / "bad.npz", frames=np.zeros((5, 16, 16, 3), np.uint8))
    for args in (("npz", None), ("npz", str(tmp_path / "bad.npz")), ("gfpgan",), ("what",)):
        with pytest.raises(ValueError):
            PE.enhance_frames(frames, *args, device="cpu")
    out = PE.enhance_frames(frames, "gfpgan", tiny=True, device="cpu")
    assert out.shape == frames.shape and out.dtype == np.uint8
