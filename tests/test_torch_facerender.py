"""The port's facerender (mofa_tpu_torch/models/facerender.py) against mofa_tpu's, on the CPU.

Each net's weights are the port's seeded state dict (BatchNorm statistics
random too) carried into Flax by mofa_tpu's `convert_facerender_state_dict`
(strict), so the port's module names are the ones the reference's
checkpoint keys map to:

- KPDetector, HEEstimator, MappingNet, the SPADE generator and the plain
  generator at TINY_FACERENDER_CONFIG, fp32, within 1e-4 of max |JAX|
  (prediction, occlusion map, keypoints, the pose dicts);
- `keypoint_transformation` and `build_semantics`;
- `make_animation` over 2 frames against the JAX scan;
- spectral-norm folding bit-equal to mofa_tpu's `_fold_spectral_norm`, and
  the combined-checkpoint reader: generator. / kp_extractor. / mapping. /
  he_estimator. prefixes with spectral-norm triplets, BatchNorm counters,
  `down.weight` and `.sigma` entries, loaded strict;
- `facerender_app.main --tiny` with PIL blocked: the render, `--enhancer
  gfpgan` (tiny) and `--paste_back` (cv2 in, mp4 out).
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models import facerender as JF
from mofa_tpu.models.weights import _fold_spectral_norm, convert_facerender_state_dict

from mofa_tpu_torch.apps import facerender_app
from mofa_tpu_torch.apps.loaders import init_random_cmp_
from mofa_tpu_torch.models import facerender as PF
from mofa_tpu_torch.models.weights import save_safetensors
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   jit_fast, one_torch_thread, sd_np, template)

CFG = PF.TINY_FACERENDER_CONFIG
JCFG = JF.TINY_FACERENDER_CONFIG
S = 32


def _close(got, want, tol=1e-4, msg=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale, err_msg=msg)


def _seeded(net, seed):
    return init_random_cmp_(net, torch.Generator().manual_seed(seed)).eval()


def _jax(jnet, port, net, *args):
    tree = template(lambda: jnet.init(jax.random.PRNGKey(0), *args))
    return convert_facerender_state_dict(tree, sd_np(port), net=net)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(3)
    return dict(img=rng.rand(1, S, S, 3).astype(np.float32),
                kp_src=(rng.rand(1, CFG.num_kp, 3).astype(np.float32) - 0.5),
                kp_drv=(rng.rand(1, CFG.num_kp, 3).astype(np.float32) - 0.5),
                sem=rng.randn(1, 70, 27).astype(np.float32),
                tgt=rng.randn(1, 2, 70, 27).astype(np.float32))


@pytest.fixture(scope="module")
def nets(inputs):
    """The port's kp detector, mapping and plain generator with their Flax
    twins (jitted applies and converted trees)."""
    i = inputs
    kp = _seeded(PF.KPDetector(CFG), 1)
    mp = _seeded(PF.MappingNet(CFG), 2)
    gen = _seeded(PF.OcclusionAwareGenerator(CFG), 3)
    jkp, jmp, jgen = JF.KPDetector(JCFG), JF.MappingNet(JCFG), JF.OcclusionAwareGenerator(JCFG)
    return dict(
        port=(kp, mp, gen), modules=(jkp, jmp, jgen),
        params=(_jax(jkp, kp, "kp_detector", i["img"]), _jax(jmp, mp, "mapping", i["sem"]),
                _jax(jgen, gen, "generator", i["img"], i["kp_drv"], i["kp_src"])))


def test_kp_detector_and_mapping_match_jax(nets, inputs):
    (kp, mp, _), (jkp, jmp, _), (kpp, mpp, _) = nets["port"], nets["modules"], nets["params"]
    with torch.no_grad():
        got = kp(_nchw(inputs["img"])).numpy()
        got_he = mp(torch.from_numpy(inputs["sem"]))
    _close(got, jit_fast(jkp.apply)(kpp, inputs["img"]))
    want_he = jit_fast(jmp.apply)(mpp, inputs["sem"])
    for k in ("yaw", "pitch", "roll", "t", "exp"):
        _close(got_he[k].numpy(), want_he[k], msg=k)


@pytest.fixture(scope="module")
def he_estimator():
    """HEEstimator at its fixed 256-2048 widths (30M parameters), seeded once."""
    return _seeded(PF.HEEstimator(CFG), 4)


def test_he_estimator_matches_jax(he_estimator):
    """HEEstimator on a 32^2 image (1^2 after its three strided blocks); its
    quirk (fc_roll feeds 'yaw') kept."""
    img = np.random.RandomState(2).rand(1, 32, 32, 3).astype(np.float32)
    port = he_estimator
    jnet = JF.HEEstimator(JCFG)
    params = _jax(jnet, port, "he_estimator", img)
    want = jit_fast(jnet.apply)(params, img)
    with torch.no_grad():
        got = port(_nchw(img))
    for k in ("yaw", "pitch", "roll", "t", "exp"):
        _close(got[k].numpy(), want[k], msg=k)


def test_spade_generator_matches_jax(inputs):
    """The SPADE generator (its decoder at the fixed 512 / 256 / 64 widths)
    with the tiny trunk: prediction and occlusion map."""
    i = inputs
    port = _seeded(PF.OcclusionAwareSPADEGenerator(CFG), 5)
    jnet = JF.OcclusionAwareSPADEGenerator(JCFG)
    params = _jax(jnet, port, "generator", i["img"], i["kp_drv"], i["kp_src"])
    want = jit_fast(jnet.apply)(params, i["img"], i["kp_drv"], i["kp_src"])
    with torch.no_grad():
        got = port(_nchw(i["img"]), torch.from_numpy(i["kp_drv"]), torch.from_numpy(i["kp_src"]))
    assert got["prediction"].shape == (1, 3, S, S)
    _close(got["prediction"].permute(0, 2, 3, 1).numpy(), want["prediction"])
    _close(got["occlusion_map"][:, 0].numpy(), np.asarray(want["occlusion_map"])[..., 0])


def test_make_animation_matches_jax_scan(nets, inputs):
    """Two frames through the port's loop against mofa_tpu's lax.scan; the
    plain generator's prediction and the transformed keypoints."""
    i = inputs
    (kp, mp, gen), (jkp, jmp, jgen), (kpp, mpp, genp) = (nets["port"], nets["modules"],
                                                         nets["params"])
    want = JF.make_animation(jnp.asarray(i["img"]), jnp.asarray(i["sem"]),
                             jnp.asarray(i["tgt"]), jgen, genp, jkp, kpp, jmp, mpp)
    got = PF.make_animation(_nchw(i["img"]), torch.from_numpy(i["sem"]),
                            torch.from_numpy(i["tgt"]), gen, kp, mp)
    assert got.shape == (1, 2, 3, S, S)
    _close(got.permute(0, 1, 3, 4, 2).numpy(), want)
    rng = np.random.RandomState(4)
    kpc = rng.randn(2, 15, 3).astype(np.float32)
    he = {k: rng.randn(2, n).astype(np.float32)
          for k, n in (("yaw", 66), ("pitch", 66), ("roll", 66), ("t", 3), ("exp", 45))}
    _close(PF.keypoint_transformation(torch.from_numpy(kpc),
                                      {k: torch.from_numpy(v) for k, v in he.items()}).numpy(),
           JF.keypoint_transformation(jnp.asarray(kpc), {k: jnp.asarray(v) for k, v in he.items()}),
           tol=1e-5)
    src, gen70 = rng.randn(1, 70).astype(np.float32), rng.randn(9, 70).astype(np.float32)
    for kw in (dict(), dict(expression_scale=1.5, still_mode=True)):
        for a, b in zip(PF.build_semantics(src, gen70, **kw), JF.build_semantics(src, gen70, **kw)):
            np.testing.assert_array_equal(a, b)


def _triplets(sd: dict, rng) -> dict:
    """The SPADE blocks' convs as spectral_norm stores them."""
    out = {}
    for k, v in sd.items():
        if re.search(r"\.(conv_0|conv_1|conv_s)\.weight$", k):
            base = k[:-len(".weight")]
            out[base + ".weight_orig"] = v * 3.0
            out[base + ".weight_u"] = torch.from_numpy(rng.randn(v.shape[0]).astype(np.float32))
            out[base + ".weight_v"] = torch.from_numpy(
                rng.randn(v[0].numel()).astype(np.float32))
        else:
            out[k] = v
    return out


def test_checkpoint_reader_folds_spectral_norm(tmp_path, he_estimator):
    """A combined checkpoint as SadTalker_V0.0.2_256.safetensors lays it
    out: the four nets by prefix, the SPADE convs as spectral-norm
    triplets, BatchNorm counters, the anti-alias `down.weight`, a
    `.sigma`; read strict, each folded weight bit-equal to mofa_tpu's."""
    rng = np.random.RandomState(6)
    nets = {"generator": _seeded(PF.OcclusionAwareSPADEGenerator(CFG), 7),
            "kp_extractor": _seeded(PF.KPDetector(CFG), 8),
            "mapping": _seeded(PF.MappingNet(CFG), 9),
            "he_estimator": he_estimator}
    blob = {}
    for prefix, net in nets.items():
        sd = _triplets(net.state_dict(), rng) if prefix == "generator" else net.state_dict()
        blob.update({f"{prefix}.{k}": v.clone() for k, v in sd.items()})
    blob["kp_extractor.down.weight"] = torch.ones(3, 1, 13, 13)
    blob["generator.decoder.G_middle_0.conv_0.sigma"] = torch.ones(1)
    assert any(k.endswith("num_batches_tracked") for k in blob)
    path = str(tmp_path / "facerender.safetensors")
    save_safetensors(blob, path)
    loaded = facerender_app.load_facerender(path, "cpu", CFG, with_he=True)
    gen_sd = {k[len("generator."):]: v.numpy() for k, v in blob.items()
              if k.startswith("generator.") and not k.endswith(".sigma")}
    folded = _fold_spectral_norm(gen_sd)
    got = loaded["generator"].state_dict()
    n_folded = 0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(v.numpy(), folded[k], err_msg=k)
        n_folded += k + "_orig" in gen_sd
    assert n_folded == 8 * 2 + 2      # conv_0, conv_1 of 8 blocks, conv_s of up_0 / up_1
    for name, prefix in (("kp_detector", "kp_extractor"), ("mapping", "mapping"),
                         ("he_estimator", "he_estimator")):
        for k, v in loaded[name].state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, blob[f"{prefix}.{k}"]), (name, k)
    # a file without one of the mapping net's tensors is refused (the
    # keypoint detector loads first, the mapping net raises)
    short = {k: v for k, v in blob.items() if k.startswith(("kp_extractor.", "mapping."))
             and k != "mapping.fc_t.bias"}
    save_safetensors(short, path)
    with pytest.raises(RuntimeError, match="fc_t.bias"):
        facerender_app.load_facerender(path, "cpu", CFG)


def test_nets_built_on_their_device():
    """Every parameter and buffer of the facerender nets and GFPGAN lands on
    the device of the `torch.device` context they are built under (the apps
    build them so, on the card)."""
    from mofa_tpu_torch.models.gfpgan import TINY_GFPGAN_CONFIG, GFPGANv1Clean
    with torch.device("meta"):
        nets = [PF.KPDetector(CFG), PF.MappingNet(CFG), PF.OcclusionAwareSPADEGenerator(CFG),
                PF.OcclusionAwareGenerator(CFG), PF.HEEstimator(CFG),
                GFPGANv1Clean(**TINY_GFPGAN_CONFIG)]
    for net in nets:
        for name, t in list(net.named_parameters()) + list(net.named_buffers()):
            assert t.device.type == "meta", (type(net).__name__, name)


def test_facerender_app_tiny_without_pil(tmp_path, monkeypatch):
    """`main --tiny` on the CPU with PIL blocked: the render, GFPGAN (tiny)
    and the paste back into a full image, cv2 in, mp4 out."""
    import cv2
    monkeypatch.setitem(sys.modules, "PIL", None)
    rng = np.random.RandomState(3)
    cv2.imwrite(str(tmp_path / "src.png"), (rng.rand(40, 40, 3) * 255).astype(np.uint8))
    cv2.imwrite(str(tmp_path / "full.png"), (rng.rand(120, 100, 3) * 255).astype(np.uint8))
    np.savez(tmp_path / "first.npz", full_3dmm=rng.randn(1, 257).astype(np.float32) * 0.1)
    np.savez(tmp_path / "drv.npz", coeff_3dmm=rng.randn(3, 70).astype(np.float32) * 0.1)
    np.savez(tmp_path / "ci.npz", crop_info=np.asarray([100, 120, 20, 30, 80, 100,
                                                       5, 5, 50, 60], np.int64))
    out = str(tmp_path / "out.mp4")
    frames = facerender_app.main([
        "--image", str(tmp_path / "src.png"), "--coeff_npz", str(tmp_path / "first.npz"),
        "--driving_coeffs_npz", str(tmp_path / "drv.npz"), "--output", out, "--tiny",
        "--device", "cpu", "--enhancer", "gfpgan", "--paste_back",
        "--full_image", str(tmp_path / "full.png"), "--crop_info_npz", str(tmp_path / "ci.npz")])
    assert frames.shape == (3, 120, 100, 3) and os.path.getsize(out) > 0
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()
