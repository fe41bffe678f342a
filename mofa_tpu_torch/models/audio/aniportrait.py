"""AniPortrait audio -> landmark models in PyTorch, and the audio2ldmk driver.

Counterpart of mofa_tpu/models/audio/aniportrait.py (reference
MOFA-Video-Hybrid/aniportrait):
- Audio2Mesh (src/audio_models/model.py:11-71): wav2vec2 hidden states ->
  in_fn -> out_fn (zero-initialised) -> per-frame offsets of the 468
  mediapipe vertices (1404 = 468 * 3), added to the reference face's 3D
  landmarks;
- Audio2Pose (src/audio_models/pose_model.py:58-125): wav2vec2 features
  -> in_fn, an autoregressive 8-layer post-norm transformer decoder
  (`transformer_decoder`, torch's own layer names) with an ALiBi-biased
  causal self-attention mask, a diagonal-only cross-attention mask, a
  learned id embedding and a sinusoidal position encoding -> a 6-dof pose
  a frame. Its LayerNorm epsilon is mofa_tpu's (Flax's 1e-6), not torch's
  1e-5 default, which the reference's nn.TransformerDecoderLayer uses;
- the pose utilities (src/utils/pose_util.py), `smooth_pose_seq` and the
  468 -> 68 index table (audio2ldmk.py:62-160);
- `audio_to_landmarks` (audio2ldmk.py:184-294): 5-second chunks for the
  pose, the last chunk merged into the one before.

The rollout is a loop over positions; each step decodes the prefix only
(the causal mask makes a position's output independent of later tokens).
The models run no custom kernel: their attention is PyTorch's SDPA, as the
JAX package leaves it to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from mofa_tpu_torch.models.audio.wav2vec2 import (Wav2Vec2Config, Wav2Vec2Model,
                                                  normalize_audio)

# 468-pt mediapipe -> 68-pt dlib-style landmark index table
# (audio2ldmk.py:62-160)
MEDIAPIPE_TO_68 = np.array([
    234, 93, 132, 58, 172, 136, 150, 176, 152, 400, 379, 365, 397, 288, 361,
    323, 454,                                      # face contour
    70, 63, 105, 66, 107,                          # right eyebrow
    336, 296, 334, 293, 300,                       # left eyebrow
    168, 6, 195, 4,                                # nose bridge
    239, 241, 19, 461, 459,                        # nose bottom
    33, 160, 158, 133, 153, 144,                   # right eye
    362, 385, 387, 263, 373, 380,                  # left eye
    61, 40, 37, 0, 267, 270, 291, 321, 314, 17, 84, 91,   # outer lips
    78, 81, 13, 311, 308, 402, 14, 178,            # inner lips
], np.int64)

# keys of an AniPortrait checkpoint that hold no parameter of these
# modules: buffers the code rebuilds (the position encoding, the biased
# mask) and wav2vec2's training-only masked-spectrum embedding
UNUSED_CHECKPOINT_KEYS = ("PPE.pe", "biased_mask", "masked_spec_embed",
                          "num_batches_tracked")


def convert_ldmk_to_68(mediapipe_ldmk: np.ndarray) -> np.ndarray:
    """[T, 468+, 2] -> [T, 68, 2]."""
    return np.asarray(mediapipe_ldmk)[:, MEDIAPIPE_TO_68]


def audio_state_dict(checkpoint: dict) -> dict:
    """An AniPortrait audio2mesh.pt / audio2pose.pt state dict -> the one
    Audio2Mesh / Audio2Pose load with strict=True: `module.` prefixes and
    the UNUSED_CHECKPOINT_KEYS dropped (the positional conv's weight-norm
    halves are merged by the module on load)."""
    out = {}
    for k, v in checkpoint.items():
        while k.startswith("module."):
            k = k[len("module."):]
        if not k.endswith(UNUSED_CHECKPOINT_KEYS):
            out[k] = v
    return out


# ------------------------------------------------------------ audio feature

def load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """PCM wav -> mono float32 samples at target_sr (stdlib `wave`, the
    channels averaged, a polyphase resample; the librosa.load of the
    reference, for wav files)."""
    import wave
    from scipy.signal import resample_poly
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        ch = f.getnchannels()
        raw = f.readframes(n)
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    data = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    data /= float(np.iinfo(dtype).max)
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    if sr != target_sr:
        g = math.gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
    return data


def prepare_audio_feature(wav_path: str, fps: int = 25,
                          sampling_rate: int = 16000) -> dict:
    """audio_util.prepare_audio_feature: normalized samples + frame count."""
    samples = load_wav(wav_path, sampling_rate)
    return {"audio_feature": normalize_audio(samples),
            "seq_len": math.ceil(len(samples) / sampling_rate * fps)}


# ------------------------------------------------------------------ models

class Audio2Mesh(nn.Module):
    def __init__(self, w2v_cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 latent_dim: int = 512, out_dim: int = 1404):
        super().__init__()
        self.audio_encoder = Wav2Vec2Model(w2v_cfg)
        self.in_fn = nn.Linear(w2v_cfg.hidden_size, latent_dim)
        self.out_fn = nn.Linear(latent_dim, out_dim)
        nn.init.zeros_(self.out_fn.weight)
        nn.init.zeros_(self.out_fn.bias)

    def forward(self, audio: torch.Tensor, seq_len: int) -> torch.Tensor:
        """[B, samples] -> vertex offsets [B, seq_len, out_dim]."""
        return self.out_fn(self.in_fn(self.audio_encoder(audio, seq_len)))


def alibi_biased_mask(n_head: int, max_seq_len: int) -> np.ndarray:
    """init_biased_mask (pose_model.py:11-32) with period=1: causal mask +
    per-head ALiBi-slope distance bias. Returns [H, L, L] additive."""

    def slopes(n):
        def pow2(n):
            start = 2 ** (-2 ** -(math.log2(n) - 3))
            return [start * start ** i for i in range(n)]
        if math.log2(n).is_integer():
            return pow2(n)
        closest = 2 ** math.floor(math.log2(n))
        return pow2(closest) + slopes(2 * closest)[0::2][: n - closest]

    sl = np.asarray(slopes(n_head), np.float32)
    bias = -np.arange(max_seq_len, dtype=np.float32)[::-1]
    alibi = np.zeros((max_seq_len, max_seq_len), np.float32)
    for i in range(max_seq_len):
        alibi[i, : i + 1] = bias[-(i + 1):]
    alibi = sl[:, None, None] * alibi[None]
    causal = np.triu(np.full((max_seq_len, max_seq_len), -np.inf, np.float32), 1)
    return causal[None] + alibi


def sinusoidal_ppe(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class Audio2Pose(nn.Module):
    def __init__(self, w2v_cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 latent_dim: int = 512, out_dim: int = 6, n_head: int = 8,
                 num_layers: int = 8):
        super().__init__()
        self.n_head, self.out_dim = n_head, out_dim
        self.audio_encoder = Wav2Vec2Model(w2v_cfg)
        self.pose_map = nn.Linear(out_dim, latent_dim)
        self.in_fn = nn.Linear(w2v_cfg.hidden_size, latent_dim)
        self.pose_map_r = nn.Linear(latent_dim, out_dim)
        self.id_embed = nn.Embedding(100, latent_dim)
        layer = nn.TransformerDecoderLayer(latent_dim, n_head, 2 * latent_dim,
                                           dropout=0.0, layer_norm_eps=1e-6,
                                           batch_first=True)
        self.transformer_decoder = nn.TransformerDecoder(layer, num_layers)

    def forward(self, audio: torch.Tensor, seq_len: int,
                id_seed: int = 42) -> torch.Tensor:
        """[B, samples] -> pose [B, seq_len, 6], rolled out one position a
        step from the pose_map of a zero pose."""
        b, t = audio.shape[0], seq_len
        if t == 0:
            return audio.new_zeros(b, 0, self.out_dim)
        hidden = self.in_fn(self.audio_encoder(audio, t))
        dev, d = hidden.device, hidden.shape[-1]
        id_vec = self.id_embed(torch.full((b,), id_seed, dtype=torch.long,
                                          device=dev))[:, None]
        ppe = torch.from_numpy(sinusoidal_ppe(t, d)).to(dev)
        biased = torch.from_numpy(alibi_biased_mask(self.n_head, t)).to(dev)
        # diagonal-only cross attention (enc_dec_mask, pose_model.py:35-39)
        mem_mask = torch.full((t, t), -math.inf, device=dev).fill_diagonal_(0.0)
        tokens = self.pose_map(hidden.new_zeros(b, 1, self.out_dim))
        poses = []
        for i in range(t):
            x = self.transformer_decoder(
                tokens + ppe[: i + 1] + id_vec, hidden,
                tgt_mask=biased[:, : i + 1, : i + 1].repeat(b, 1, 1),
                memory_mask=mem_mask[: i + 1])
            poses.append(self.pose_map_r(x[:, i]))
            tokens = torch.cat([tokens, self.pose_map(poses[-1])[:, None]], dim=1)
        return torch.stack(poses, dim=1)


# --------------------------------------------------------------- pose utils

def create_perspective_matrix(aspect_ratio: float) -> np.ndarray:
    deg2rad = np.pi / 180.0
    near, far = 1.0, 10000.0
    f = 1.0 / np.tan(deg2rad * 63 / 2.0)
    denom = 1.0 / (near - far)
    p = np.zeros(16, np.float32)
    p[0] = f / aspect_ratio
    p[5] = -f                   # flipped Y (pose_util.py:27)
    p[10] = (near + far) * denom
    p[11] = -1.0
    p[14] = far * near * denom
    return p


def euler_and_translation_to_matrix(euler_deg, translation) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R
    m = np.eye(4)
    m[:3, :3] = R.from_euler("xyz", euler_deg, degrees=True).as_matrix()
    m[:3, 3] = translation
    return m


def matrix_to_euler_and_translation(matrix: np.ndarray):
    from scipy.spatial.transform import Rotation as R
    euler = R.from_matrix(matrix[:3, :3]).as_euler("xyz", degrees=True)
    return euler, matrix[:3, 3]


def project_points(points_3d: np.ndarray, trans_mat: np.ndarray,
                   pose_vectors: np.ndarray, image_shape) -> np.ndarray:
    """[L, N, 3] verts + per-frame 6-dof pose -> [L, N, 2] pixel coords."""
    P = create_perspective_matrix(
        image_shape[1] / image_shape[0]).reshape(4, 4).T
    L, N, _ = points_3d.shape
    out = np.zeros((L, N, 2))
    for i in range(L):
        homog = np.hstack([points_3d[i], np.ones((N, 1))])
        full = trans_mat @ euler_and_translation_to_matrix(
            pose_vectors[i][:3], pose_vectors[i][3:])
        proj = homog @ full.T @ P
        xy = proj[:, :2] / proj[:, 3:4]
        out[i, :, 0] = (xy[:, 0] + 1) * 0.5 * image_shape[1]
        out[i, :, 1] = (xy[:, 1] + 1) * 0.5 * image_shape[0]
    return out


def smooth_pose_seq(pose_seq: np.ndarray, window_size: int = 5) -> np.ndarray:
    out = np.zeros_like(pose_seq)
    for i in range(len(pose_seq)):
        lo = max(0, i - window_size // 2)
        hi = min(len(pose_seq), i + window_size // 2 + 1)
        out[i] = np.mean(pose_seq[lo:hi], axis=0)
    return out


# ------------------------------------------------------------------ driver

@torch.no_grad()
def audio_to_landmarks(a2m: Audio2Mesh, a2p: Audio2Pose, wav_path: str,
                       ref_lmks: np.ndarray, ref_lmks3d: np.ndarray,
                       trans_mat: np.ndarray, image_shape,
                       fps: int = 25, sr: int = 16000,
                       id_seed: int = 42) -> np.ndarray:
    """audio2ldmk.py's main (:184-294): a wav -> [seq_len + 1, 68, 2]
    landmark track (the reference face first), on the models' device.

    ref_lmks [468+, 2] pixel coords of the reference image; ref_lmks3d
    [468, 3]; trans_mat [4, 4]; image_shape (height, width)."""
    sample = prepare_audio_feature(wav_path, fps=fps, sampling_rate=sr)
    dev = next(a2m.parameters()).device
    audio = torch.from_numpy(sample["audio_feature"]).to(dev)[None]
    seq_len = sample["seq_len"]

    pred = a2m(audio, seq_len)[0].float().cpu().numpy()
    pred = pred.reshape(pred.shape[0], -1, 3) + ref_lmks3d

    # 5-second chunking with merged tail (audio2ldmk.py:246-267)
    chunk = sr * 5
    bounds = list(range(0, audio.shape[1], chunk)) + [audio.shape[1]]
    chunks = [audio[:, s:e] for s, e in zip(bounds[:-1], bounds[1:])]
    lens = [5 * fps] * (len(chunks) - 1) + [seq_len % (5 * fps)]
    if len(chunks) > 1:
        chunks[-2] = torch.cat([chunks[-2], chunks[-1]], dim=1)
        lens[-2] += lens[-1]
        chunks, lens = chunks[:-1], lens[:-1]
    poses = []
    for au, ln in zip(chunks, lens):
        p = a2p(au, int(ln), id_seed)[0].float().cpu().numpy()
        p[:, :3] *= 0.5
        poses.append(p)
    pose_seq = smooth_pose_seq(np.concatenate(poses, 0), 7)

    projected = project_points(pred, trans_mat, pose_seq, image_shape)
    projected = np.concatenate([ref_lmks[None, :468, :2], projected], axis=0)
    return convert_ldmk_to_68(projected)
