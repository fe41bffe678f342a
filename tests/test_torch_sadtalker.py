"""The port's SadTalker audio stack against the JAX package, on the CPU.

The wav2lip mel front and the blink ratios bit-equal to mofa_tpu's;
Audio2ExpNet, the CVAE decoder (with its ResUnet) and the windowed
Audio2PoseCVAE (JAX's latent draws injected) within `_close`'s 1e-4 of
max |JAX|, fp32, their weights the port's seeded state dicts carried into
Flax by mofa_tpu's `convert_sadtalker_exp` / `convert_sadtalker_pose`
(strict); the BFM loaded from a .mat and its landmarks to 1e-6 of their
scale; `sadtalker_audio_to_landmarks` over 1.4 s (one full 32-frame pose
window and a 3-frame tail) and `sadtalker_video_to_landmarks` to 1e-3 px;
the strict checkpoint readers of both nets. Each JAX model is one jit
program, compiled once for the module (`jit_fast`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models.audio import sadtalker as J
from mofa_tpu.models.weights import convert_sadtalker_exp, convert_sadtalker_pose

from chip_smoke import write_bfm_mat
from mofa_tpu_torch.apps.audio2ldmk_app import load_sadtalker_nets
from mofa_tpu_torch.apps.loaders import init_random_cmp_
from mofa_tpu_torch.models.audio import sadtalker as P
from tests.test_torch_audio import _close
from tests.torch_port_util import jit_fast, sd_np, template
from tests.torch_port_util import (flax_apply_without_shape_recheck,  # noqa: F401
                                   one_torch_thread)  # (both autouse)

SR, FPS = 16000, 25
WAV_SECONDS = 1.4          # 35 frames: a 32-frame window and a 3-frame tail


def _seeded(net, seed):
    """Seeded random weights and BatchNorm statistics (the app's init)."""
    return init_random_cmp_(net, torch.Generator().manual_seed(seed)).eval()


class _Jitted:
    """A Flax module whose `apply` is one fast-compiled jit program a
    signature (mofa_tpu's drivers call `.apply` eagerly, op by op)."""

    def __init__(self, module):
        self.apply = jit_fast(module.apply)


@pytest.fixture(scope="module")
def exp_pair():
    port = _seeded(P.Audio2ExpNet(), 1)
    tree = template(lambda: J.Audio2ExpNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 80, 16, 1)), jnp.zeros((1, 64)),
        jnp.zeros((1, 1))))
    return port, _Jitted(J.Audio2ExpNet()), convert_sadtalker_exp(tree, sd_np(port))


@pytest.fixture(scope="module")
def pose_pair():
    port = _seeded(P.Audio2PoseCVAE(), 2)
    tree = template(lambda: J.Audio2PoseCVAE().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 34, 80, 16)), jnp.zeros((1, 6)),
        jnp.asarray([0]), jax.random.PRNGKey(2)))
    sd = sd_np(port)
    # the reference file's training-only parts, which the converter drops
    sd["netG.encoder.MLP.L0.weight"] = np.zeros((4, 4), np.float32)
    sd["netD_motion.seq.0.weight"] = np.zeros(3, np.float32)
    return port, _Jitted(J.Audio2PoseCVAE()), convert_sadtalker_pose(tree, sd, strict=True)


def _wav(seconds, seed):
    return (np.random.RandomState(seed).randn(int(seconds * SR)) * 0.1).astype(np.float32)


def _jax_latents(key, windows: int, b: int = 1):
    """The latents Audio2PoseCVAE draws from `key`, one a window."""
    out = []
    for _ in range(windows):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (b, 64))))
    return out


def test_mel_front_and_blinks_equal_jax():
    wav = _wav(1.3, 0)
    np.testing.assert_array_equal(P.melspectrogram(wav), J.melspectrogram(wav))
    got = P.indiv_mel_windows(wav, fps=FPS)
    assert got.shape == (32, 80, 16)
    np.testing.assert_array_equal(got, J.indiv_mel_windows(wav, fps=FPS))
    for t in (20, 35, 151):
        np.testing.assert_array_equal(P.blink_ratio(t, np.random.RandomState(42)),
                                      J.blink_ratio(t, np.random.RandomState(42)))
    assert P.blink_ratio(151, np.random.RandomState(42)).any()


def test_audio2exp_matches_jax(exp_pair):
    """SimpleWrapperV2 on a 10-window chunk; its names are the reference's
    (`audio_encoder.<i>.conv_block.{0,1}.*`, `mapping1.*`)."""
    port, jm, params = exp_pair
    assert "audio_encoder.12.conv_block.1.running_var" in port.state_dict()
    rng = np.random.RandomState(3)
    mel, ref = rng.randn(10, 80, 16).astype(np.float32), rng.randn(10, 64).astype(np.float32)
    ratio = rng.rand(10, 1).astype(np.float32)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (mel, ref, ratio))).numpy()
    _close(got, jm.apply(params, jnp.asarray(mel)[..., None], ref, ratio))


def test_cvae_decoder_matches_jax(pose_pair):
    """The decoder alone (class bias, MLP, the ResUnet's transposed convs
    on the reference's [I, O, kh, kw] weights) at batch 2."""
    port, _, params = pose_pair
    rng = np.random.RandomState(4)
    z, ref = rng.randn(2, 64).astype(np.float32), rng.randn(2, 6).astype(np.float32)
    emb, cls = rng.randn(2, 32, 512).astype(np.float32), np.array([3, 45])
    want = jit_fast(J.CVAEDecoder().apply)({"params": params["params"]["decoder"]},
                                           z, cls, ref, emb)
    with torch.no_grad():
        got = port.netG.decoder(torch.from_numpy(z), torch.from_numpy(cls),
                                torch.from_numpy(ref), torch.from_numpy(emb)).numpy()
    _close(got, want)


def test_audio2pose_cvae_matches_jax(pose_pair):
    """The windowed sampling over 36 mel windows (one full window, a
    3-frame tail from the last 32, the zero lead frame), with JAX's latents."""
    port, jm, params = pose_pair
    rng = np.random.RandomState(5)
    mels, ref = rng.randn(1, 36, 80, 16).astype(np.float32), rng.randn(1, 6).astype(np.float32)
    key = jax.random.PRNGKey(6)
    with torch.no_grad():
        got = port(torch.from_numpy(mels), torch.from_numpy(ref), torch.tensor([7]),
                   z=_jax_latents(key, 2)).numpy()
    assert got.shape == (1, 36, 6)
    np.testing.assert_array_equal(got[0, 0], ref[0])
    _close(got, jm.apply(params, mels, ref, jnp.asarray([7]), key))


@pytest.fixture(scope="module")
def bfm_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bfm") / "bfm.mat")
    write_bfm_mat(path, 12, 14, seed=8)
    return P.BFMModel.load(path), J.BFMModel.load(path)


def _coeff257(seed):
    return (np.random.RandomState(seed).randn(1, 257) * 0.1).astype(np.float32)


TRANS = np.array([256, 256, 1.1, 120.0, 130.0, 10, 12, 224], np.float32)
CROP = ((256, 256), (0, 0, 256, 256), (4, 6, 250, 251))


def test_bfm_landmarks_equal_jax(bfm_pair):
    pb, jb = bfm_pair
    for name in ("mean_shape", "id_base", "exp_base", "keypoints"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    coeffs = np.concatenate([_coeff257(s) for s in (9, 10, 11)])
    got, ref = pb.landmarks(coeffs), jb.landmarks(coeffs)
    assert got.shape == (3, 68, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    track = np.random.RandomState(12).randn(5, 70).astype(np.float32)
    full = P.compose_full_coeffs(coeffs[:1], track)
    np.testing.assert_array_equal(full, J.compose_full_coeffs(coeffs[:1], track))
    np.testing.assert_array_equal(P.uncrop_landmarks(got, TRANS, CROP),
                                  J.uncrop_landmarks(got, TRANS, CROP))


def test_sadtalker_audio_to_landmarks_matches_jax(exp_pair, pose_pair, bfm_pair):
    """wav -> [T + 1, 68, 2]: the exp net over 10-frame chunks (10 and 5),
    the pose CVAE over 36 windows with JAX's latents, savgol, the BFM."""
    exp, j_exp, exp_params = exp_pair
    pose, j_pose, pose_params = pose_pair
    pb, jb = bfm_pair
    wav, coeff = _wav(WAV_SECONDS, 13), _coeff257(14)
    key = jax.random.PRNGKey(15)
    got, got_c = P.sadtalker_audio_to_landmarks(
        exp, pose, pb, wav, coeff, TRANS, CROP, pose_style=4,
        z=_jax_latents(key, 2), return_coeffs=True)
    ref, ref_c = J.sadtalker_audio_to_landmarks(
        j_exp, exp_params, j_pose, pose_params, jb, wav, coeff, TRANS, CROP,
        pose_style=4, key=key, return_coeffs=True)
    t = int(WAV_SECONDS * FPS)
    assert got.shape == ref.shape == (t + 1, 68, 2) and np.isfinite(got).all()
    np.testing.assert_array_equal(got_c[0], coeff[0])
    np.testing.assert_allclose(got_c, ref_c, rtol=0, atol=1e-4 * np.abs(ref_c).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)      # pixels


def test_generate_coeffs_draws_from_generator(exp_pair, pose_pair):
    """Without z, the latents come from the generator (seeded 42 when none
    is given): the same seed gives the same track, another seed another."""
    exp, pose = exp_pair[0], pose_pair[0]
    wav, ref70 = _wav(0.5, 16), np.random.RandomState(17).randn(70).astype(np.float32)
    a = P.generate_coeffs(exp, pose, wav, ref70)
    b = P.generate_coeffs(exp, pose, wav, ref70,
                          generator=torch.Generator().manual_seed(42))
    c = P.generate_coeffs(exp, pose, wav, ref70,
                          generator=torch.Generator().manual_seed(43))
    assert a.shape == (12, 70)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[:, 64:], c[:, 64:])
    np.testing.assert_array_equal(a[:, :64], c[:, :64])


def test_sadtalker_video_to_landmarks_equals_jax(bfm_pair):
    pb, jb = bfm_pair
    coeff = _coeff257(18)
    driving = (np.random.RandomState(19).randn(9, 70) * 0.1).astype(np.float32)
    got, got_c = P.sadtalker_video_to_landmarks(pb, coeff, driving, TRANS, CROP,
                                                return_coeffs=True)
    ref, ref_c = J.sadtalker_video_to_landmarks(jb, coeff, driving, TRANS, CROP,
                                                return_coeffs=True)
    assert got.shape == (10, 68, 2)
    np.testing.assert_array_equal(got_c, ref_c)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_sadtalker_checkpoints_load_strict(tmp_path):
    """audio2exp / audio2pose files as the reference writes them ({"model":
    ...}, `module.` prefixes, BatchNorm counters, the pose file's CVAE
    encoder and discriminator) load strict through the app's loader, every
    tensor equal; a missing or an unexpected key raises."""
    exp, pose = _seeded(P.Audio2ExpNet(), 20), _seeded(P.Audio2PoseCVAE(), 21)
    files = {}
    for net, name in ((exp, "exp.pth"), (pose, "pose.pth")):
        sd = {f"module.{k}": v for k, v in net.state_dict().items()}
        if net is pose:
            sd["module.netG.encoder.MLP.L0.weight"] = torch.zeros(4, 4)
            sd["module.netD_motion.seq.0.weight"] = torch.zeros(3)
        assert any(k.endswith("num_batches_tracked") for k in sd)
        torch.save({"model": sd}, tmp_path / name)
        files[name] = sd
    got_exp, got_pose = load_sadtalker_nets(str(tmp_path / "exp.pth"),
                                            str(tmp_path / "pose.pth"), "cpu")
    for got, want in ((got_exp, exp), (got_pose, pose)):
        for k, v in want.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got.state_dict()[k], v), k
    missing = dict(files["exp.pth"])
    del missing["module.mapping1.bias"]
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="mapping1.bias"):
        load_sadtalker_nets(str(tmp_path / "missing.pth"), None, "cpu")
    extra = dict(files["exp.pth"], **{"module.mapping2.weight": torch.zeros(2)})
    torch.save(extra, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="mapping2.weight"):
        load_sadtalker_nets(str(tmp_path / "extra.pth"), None, "cpu")
