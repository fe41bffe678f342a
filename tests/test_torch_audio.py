"""The port's AniPortrait audio front against the JAX package, on the CPU.

wav2vec2, Audio2Mesh and Audio2Pose at TINY_W2V_CONFIG widths (a 64-wide
decoder), their weights the port's seeded state dicts carried into Flax
by mofa_tpu's `convert_audio_state_dict`; both checkpoint spellings of the
weight-normed positional conv; the wav reader; `audio_to_landmarks` over
a 6-second wav (two 5-second chunks, the tail merged); and the
audio2ldmk and opendomain CLIs end to end. fp32 throughout.
"""

import math
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mofa_tpu.models.audio.aniportrait import Audio2Mesh as JAudio2Mesh
from mofa_tpu.models.audio.aniportrait import Audio2Pose as JAudio2Pose
from mofa_tpu.models.audio.aniportrait import audio_to_landmarks as j_audio_to_landmarks
from mofa_tpu.models.audio.aniportrait import load_wav as j_load_wav
from mofa_tpu.models.audio.wav2vec2 import TINY_W2V_CONFIG as J_TINY_W2V
from mofa_tpu.models.audio.wav2vec2 import Wav2Vec2Encoder as JWav2Vec2
from mofa_tpu.models.weights import convert_audio_state_dict

from mofa_tpu_torch.apps import audio2ldmk_app, opendomain_app
from mofa_tpu_torch.models.audio.aniportrait import (Audio2Mesh, Audio2Pose,
                                                     audio_state_dict,
                                                     audio_to_landmarks,
                                                     convert_ldmk_to_68, load_wav)
from mofa_tpu_torch.models.audio.wav2vec2 import TINY_W2V_CONFIG, Wav2Vec2Model
from tests.torch_port_util import sd_np, seeded, template
from tests.torch_port_util import one_torch_thread  # noqa: F401 (autouse)

LATENT, SR, FPS = 64, 16000, 25


def _audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randn(1, int(seconds * SR)).astype(np.float32)


def _flax(module, *args):
    """(the Flax module, its zero-filled param tree at these call args)."""
    return module, template(lambda: module.init(jax.random.PRNGKey(0), *args))


class _Jitted:
    """A Flax module whose `apply` is one jit program (static: the
    positions of its int arguments); mofa_tpu's audio_to_landmarks calls
    `.apply` eagerly, which compiles op by op."""

    def __init__(self, module, static):
        self.apply = jax.jit(module.apply, static_argnums=static)


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def test_wav2vec2_matches_jax():
    """The encoder with its frame-rate interpolation (49 conv frames -> 30
    and -> 70), the port's state dict under a prefix, as a checkpoint
    nests it."""
    port = seeded(Wav2Vec2Model(TINY_W2V_CONFIG), 1)
    audio = _audio(1.0, 2)
    jm, tree = _flax(JWav2Vec2(J_TINY_W2V), jnp.asarray(audio), 30)
    apply = jax.jit(jm.apply, static_argnums=2)
    params = convert_audio_state_dict(
        {"params": {"enc": tree["params"]}},
        {f"enc.{k}": v for k, v in sd_np(port).items()})["params"]["enc"]
    for seq_len in (30, 70):
        with torch.no_grad():
            got = port(torch.from_numpy(audio), seq_len).numpy()
        _close(got, apply({"params": params}, jnp.asarray(audio), seq_len))


@pytest.mark.parametrize("spelling", ["weight_norm", "parametrizations"])
def test_weight_normed_pos_conv_loads_strict(spelling):
    """A checkpoint's positional conv as weight_g / weight_v or as
    parametrizations.weight.original0 / original1 (g [1, 1, K] at dim=2)
    loads with strict=True into g * v / ||v||, the norm over dims 0, 1,
    the merge of mofa_tpu's converter."""
    port = Wav2Vec2Model(TINY_W2V_CONFIG)
    sd = port.state_dict()
    key = "encoder.pos_conv_embed.conv."
    g_torch = torch.Generator().manual_seed(4)
    v = torch.randn(sd[key + "weight"].shape, generator=g_torch)
    g = torch.rand(1, 1, v.shape[2], generator=g_torch) + 0.5
    del sd[key + "weight"]
    names = (("weight_g", "weight_v") if spelling == "weight_norm" else
             ("parametrizations.weight.original0", "parametrizations.weight.original1"))
    sd[key + names[0]], sd[key + names[1]] = g, v
    port.load_state_dict(sd, strict=True)
    merged = torch.nn.utils.parametrizations.weight_norm(
        torch.nn.Conv1d(v.shape[1], v.shape[0], v.shape[2]), dim=2)
    with torch.no_grad():
        merged.parametrizations.weight.original0.copy_(g)
        merged.parametrizations.weight.original1.copy_(v)
    torch.testing.assert_close(port.encoder.pos_conv_embed.conv.weight, merged.weight,
                               rtol=1e-6, atol=0)


def test_audio2mesh_matches_jax():
    port = seeded(Audio2Mesh(TINY_W2V_CONFIG, latent_dim=LATENT), 3)
    assert not torch.equal(port.out_fn.weight, torch.zeros_like(port.out_fn.weight))
    assert not Audio2Mesh(TINY_W2V_CONFIG, latent_dim=LATENT).out_fn.weight.any()
    audio = _audio(1.2, 5)
    seq_len = math.ceil(audio.shape[1] / SR * FPS)
    jm, tree = _flax(JAudio2Mesh(J_TINY_W2V, latent_dim=LATENT), jnp.asarray(audio), seq_len)
    params = convert_audio_state_dict(tree, sd_np(port))
    with torch.no_grad():
        got = port(torch.from_numpy(audio), seq_len).numpy()
    _close(got, _Jitted(jm, 2).apply(params, jnp.asarray(audio), seq_len))


@pytest.fixture(scope="module")
def pose_pair():
    """Two decoder layers (eight in the CLI's --tiny and at full width): the
    rollout re-runs the decoder at every position, in both packages."""
    port = seeded(Audio2Pose(TINY_W2V_CONFIG, latent_dim=LATENT, num_layers=2), 6)
    jm, tree = _flax(JAudio2Pose(J_TINY_W2V, latent_dim=LATENT, num_layers=2),
                     jnp.zeros((1, SR), jnp.float32), 25, 42)
    return port, _Jitted(jm, (2, 3)), convert_audio_state_dict(tree, sd_np(port))


def test_audio2pose_matches_jax(pose_pair):
    """The autoregressive rollout over 30 positions (ALiBi causal mask,
    diagonal cross mask, id 42); the decoder's names are torch's
    nn.TransformerDecoder ones, its packed in_proj split by the converter."""
    port, jm, params = pose_pair
    assert port.transformer_decoder.layers[0].norm1.eps == 1e-6
    assert "transformer_decoder.layers.0.self_attn.in_proj_weight" in port.state_dict()
    audio = _audio(1.2, 7)
    with torch.no_grad():
        got = port(torch.from_numpy(audio), 30, 42).numpy()
        assert port(torch.from_numpy(audio), 0).shape == (1, 0, 6)
    _close(got, jm.apply(params, jnp.asarray(audio), 30, 42))


def _write_wav(path, samples: np.ndarray, rate: int) -> None:
    """int16 PCM; samples [n] or [n, channels] in [-1, 1]."""
    pcm = (np.clip(samples, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())


def test_load_wav_stereo_resampled_matches_jax(tmp_path):
    rng = np.random.RandomState(8)
    _write_wav(tmp_path / "s.wav", rng.uniform(-0.8, 0.8, (22050, 2)), 22050)
    got = load_wav(str(tmp_path / "s.wav"))
    assert got.dtype == np.float32 and got.shape == (16000,)
    np.testing.assert_array_equal(got, j_load_wav(str(tmp_path / "s.wav")))


def _face(h: int, w: int, seed: int) -> dict:
    """A landmarker's output for a face about the middle of an h x w image:
    lmks [478, 3] normalised, lmks3d [468, 3] in cm about the origin, and a
    trans_mat placing them 50 cm in front of the camera."""
    rng = np.random.RandomState(seed)
    lmks3d = rng.uniform((-7, -9, -4), (7, 9, 4), (468, 3)).astype(np.float32)
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = -50.0
    lmks = np.concatenate([rng.uniform(0.3, 0.7, (478, 2)), np.zeros((478, 1))], 1)
    return dict(lmks=lmks.astype(np.float32), lmks3d=lmks3d, trans_mat=trans)


def test_audio_to_landmarks_matches_jax(pose_pair, tmp_path):
    """A 6-second wav: Audio2Mesh over 150 frames, Audio2Pose over one
    chunk of 150 (the 5-second chunk and the 1-second tail merged), the
    pose smoothed and projected, the reference face first: [151, 68, 2]."""
    a2p, j_a2p, a2p_params = pose_pair
    a2m = seeded(Audio2Mesh(TINY_W2V_CONFIG, latent_dim=LATENT), 9)
    j_a2m, tree = _flax(JAudio2Mesh(J_TINY_W2V, latent_dim=LATENT),
                        jnp.zeros((1, SR), jnp.float32), 25)
    a2m_params = convert_audio_state_dict(tree, sd_np(a2m))
    rng = np.random.RandomState(10)
    _write_wav(tmp_path / "a.wav", rng.uniform(-0.5, 0.5, 6 * SR), SR)
    face = _face(64, 96, 11)
    lmks = face["lmks"][:, :2] * (96, 64)
    args = (str(tmp_path / "a.wav"), lmks, face["lmks3d"], face["trans_mat"], [64, 96])
    got = audio_to_landmarks(a2m, a2p, *args)
    ref = j_audio_to_landmarks(_Jitted(j_a2m, 2), a2m_params, j_a2p, a2p_params, *args)
    assert got.shape == ref.shape == (151, 68, 2) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], convert_ldmk_to_68(lmks[None])[0])
    # pixels; the pose and the mesh offsets in fp32 through two packages
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_audio_state_dict_loads_strict(tmp_path):
    """An AniPortrait-style checkpoint (module. prefixes, the rebuilt
    buffers, wav2vec2's masked_spec_embed) loads strict into both models
    through the app's loader."""
    m, p = (seeded(cls(TINY_W2V_CONFIG, latent_dim=LATENT), 12) for cls in
            (Audio2Mesh, Audio2Pose))
    for model, name in ((m, "a2m.pt"), (p, "a2p.pt")):
        sd = {f"module.{k}": v for k, v in model.state_dict().items()}
        sd["module.audio_encoder.masked_spec_embed"] = torch.zeros(32)
        if model is p:
            sd["PPE.pe"], sd["biased_mask"] = torch.zeros(1, 600, LATENT), torch.zeros(8, 600, 600)
        torch.save(sd, tmp_path / name)
        assert audio_state_dict(sd).keys() == model.state_dict().keys()
    a2m, a2p = audio2ldmk_app.load_audio_models(str(tmp_path / "a2m.pt"),
                                                str(tmp_path / "a2p.pt"), "cpu", tiny=True)
    for got, want in ((a2m, m), (a2p, p)):
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k


@pytest.fixture
def face_files(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(13)
    Image.fromarray((rng.rand(70, 90, 3) * 255).astype(np.uint8)).save(tmp_path / "in.png")
    np.savez(tmp_path / "face.npz", **_face(70, 90, 14))
    _write_wav(tmp_path / "a.wav", rng.uniform(-0.5, 0.5, int(1.1 * SR)), SR)
    return tmp_path


def test_audio2ldmk_cli_on_cpu(face_files):
    d = face_files
    audio2ldmk_app.main(["--ref_image_path", str(d / "in.png"), "--audio_path",
                         str(d / "a.wav"), "--face_npz", str(d / "face.npz"),
                         "--save_dir", str(d / "out"), "--device", "cpu", "--tiny"])
    lm = np.load(d / "out" / "landmarks.npy")
    assert lm.shape == (math.ceil(1.1 * FPS) + 1, 68, 2) and np.isfinite(lm).all()
    # random weights, zero mesh offsets: the track stays about the face
    assert (lm[1:].min((0, 1)) > -90).all() and (lm[1:].max((0, 1)) < 180).all()
    for extra in (["--engine", "sadtalker"], ["--engine", "video"], ["--task", "x.task"]):
        with pytest.raises(SystemExit, match="slice 4"):
            audio2ldmk_app.main(["--ref_image_path", str(d / "in.png"), "--audio_path",
                                 str(d / "a.wav"), "--face_npz", str(d / "face.npz"),
                                 "--save_dir", str(d / "x"), "--device", "cpu"] + extra)
    assert not (d / "x").exists()


def test_opendomain_cli_on_cpu(face_files):
    """Audio -> landmarks.npy -> a 7-frame keypoint video (windows of 4,
    stride 2) at the micro widths, muxed or copied to the output."""
    from PIL import Image
    d = face_files
    out = d / "out.gif"
    opendomain_app.main(["--image", str(d / "in.png"), "--audio", str(d / "a.wav"),
                         "--face_npz", str(d / "face.npz"), "--work_dir", str(d / "w"),
                         "--output", str(out), "--device", "cpu", "--tiny",
                         "--target_size", "64", "--num_frames", "7", "--window_size",
                         "4", "--stride", "2", "--num_inference_steps", "1"])
    assert np.load(d / "w" / "landmarks.npy").shape == (29, 68, 2)
    assert Image.open(out).n_frames == 7
