"""SadTalker audio -> 3DMM coefficients in PyTorch, the BFM landmarks, and the drivers.

Counterpart of mofa_tpu/models/audio/sadtalker.py (reference
MOFA-Video-Hybrid/sadtalker_audio2pose):
- the wav2lip mel front (src/utils/audio.py, src/generate_batch.py):
  `melspectrogram`, the per-frame [80, 16] windows and the blink ratios,
  numpy on the host (a copy of the JAX package's numpy, bit-equal);
- `Audio2ExpNet` = SimpleWrapperV2 (src/audio2exp_models/networks.py):
  the wav2lip conv encoder over [N, 1, 80, 16] mel windows, then
  Linear(512 + 64 + 1 -> 64);
- `Audio2PoseCVAE`, the test path of Audio2Pose (src/audio2pose_models/):
  the wav2lip encoder, the CVAE decoder (class bias on the latent, an MLP,
  a ResUnet over the [1, 32, 6] pose map), sampled in 32-frame windows
  with a left-padded tail and a zero lead frame;
- `generate_coeffs` (src/test_audio2coeff.py:74-105): exp in 10-frame
  chunks, the pose over T + 1 windows, Savitzky-Golay smoothing;
- `BFMModel` (src/face3d/models/bfm.py) and the landmark projection, the
  coefficient splice and the uncrop of visualize.py:20-133, numpy.

The modules are NCHW with the reference's state-dict names
(`audio_encoder.<i>.conv_block.{0,1}.*`, `mapping1.*` for the exp net;
`audio_encoder.audio_encoder.*` and `netG.decoder.*` for the pose net), so
the reference checkpoints load with `strict=True` once
`models.weights.sadtalker_*_state_dict` has dropped what the test path
does not use. BatchNorm is eval-mode, eps 1e-5. The nets run no custom
kernel: cuDNN convolutions and stock ops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

# ---------------------------------------------------------------- mel (wav2lip)

MEL_PARAMS = dict(num_mels=80, n_fft=800, hop_size=200, win_size=800,
                  sample_rate=16000, preemphasis=0.97, min_level_db=-100,
                  ref_level_db=20, fmin=55, fmax=7600, max_abs_value=4.0)


def _mel_filterbank(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    """librosa.filters.mel (Slaney scale + norm), numpy."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = (f - 0.0) / (200.0 / 3)
        log_t = f >= 1000.0
        mel = np.where(log_t, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                       / (np.log(6.4) / 27.0), mel)
        return mel

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = 0.0 + (200.0 / 3) * m
        log_t = m >= 15.0
        f = np.where(log_t, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
        return f

    fftfreqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, len(fftfreqs)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def melspectrogram(wav: np.ndarray) -> np.ndarray:
    """wav2lip melspectrogram (audio.py:45-50): preemphasis -> STFT (hann,
    centred reflect pad) -> Slaney mel -> dB -> symmetric normalisation.
    Returns [80, frames]."""
    from scipy.signal import lfilter
    p = MEL_PARAMS
    y = lfilter([1.0, -p["preemphasis"]], [1.0], wav).astype(np.float64)
    n_fft, hop, win = p["n_fft"], p["hop_size"], p["win_size"]
    pad = n_fft // 2
    y = np.pad(y, (pad, pad), mode="reflect")
    window = np.hanning(win + 1)[:-1]
    frames = 1 + (len(y) - n_fft) // hop
    spec = np.empty((n_fft // 2 + 1, frames), np.complex128)
    for t in range(frames):
        spec[:, t] = np.fft.rfft(y[t * hop:t * hop + n_fft] * window)
    mel = _mel_filterbank(p["sample_rate"], n_fft, p["num_mels"],
                          p["fmin"], p["fmax"]) @ np.abs(spec)
    min_level = np.exp(p["min_level_db"] / 20 * np.log(10))
    db = 20 * np.log10(np.maximum(min_level, mel)) - p["ref_level_db"]
    m = p["max_abs_value"]
    norm = np.clip((2 * m) * ((db - p["min_level_db"]) / -p["min_level_db"]) - m,
                   -m, m)
    return norm.astype(np.float32)


def parse_audio_length(audio_length: int, sr: int, fps: int):
    bit_per_frames = sr / fps
    num_frames = int(audio_length / bit_per_frames)
    return int(num_frames * bit_per_frames), num_frames


def indiv_mel_windows(wav: np.ndarray, fps: int = 25, step: int = 16) -> np.ndarray:
    """Per-frame [80, 16] mel windows (generate_batch.py:53-80): [T, 80, 16]."""
    length, num_frames = parse_audio_length(len(wav), 16000, fps)
    wav = np.pad(wav[:length], (0, max(0, length - len(wav))))
    orig_mel = melspectrogram(wav).T           # [frames, 80]
    out = []
    for i in range(num_frames):
        start = int(80.0 * ((i - 2) / float(fps)))
        idx = np.clip(np.arange(start, start + step), 0, orig_mel.shape[0] - 1)
        out.append(orig_mel[idx].T)
    return np.asarray(out)


def blink_ratio(num_frames: int, rng=None) -> np.ndarray:
    """generate_blink_seq_randomly (generate_batch.py:37-49): [T, 1]."""
    rng = rng or np.random
    ratio = np.zeros((num_frames, 1), np.float32)
    if num_frames <= 20:
        return ratio
    frame_id = 0
    while frame_id < num_frames:
        start = rng.choice(range(min(10, num_frames), min(int(num_frames / 2), 70)))
        if frame_id + start + 5 <= num_frames - 1:
            ratio[frame_id + start:frame_id + start + 5, 0] = [0.5, 0.9, 1.0, 0.9, 0.5]
            frame_id = frame_id + start + 5
        else:
            break
    return ratio


# ---------------------------------------------------------------- modules

class Conv2d(nn.Module):
    """wav2lip Conv2d + BN (+ residual) + ReLU (audio2exp_models/networks.py:5-24)."""

    def __init__(self, cin: int, cout: int, kernel, stride, padding,
                 residual: bool = False, use_act: bool = True):
        super().__init__()
        self.conv_block = nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, padding),
                                        nn.BatchNorm2d(cout))
        self.residual, self.use_act = residual, use_act

    def forward(self, x):
        y = self.conv_block(x)
        if self.residual:
            y = y + x
        return torch.relu(y) if self.use_act else y


# (cout, kernel, stride, padding, residual) of the 13 wav2lip blocks
_W2L_SPEC = (
    (32, 3, 1, 1, False), (32, 3, 1, 1, True), (32, 3, 1, 1, True),
    (64, 3, (3, 1), 1, False), (64, 3, 1, 1, True), (64, 3, 1, 1, True),
    (128, 3, 3, 1, False), (128, 3, 1, 1, True), (128, 3, 1, 1, True),
    (256, 3, (3, 2), 1, False), (256, 3, 1, 1, True),
    (512, 3, 1, 0, False), (512, 1, 1, 0, False),
)


def wav2lip_audio_encoder() -> nn.Sequential:
    """[N, 1, 80, 16] mel window -> [N, 512, 1, 1] (the shared wav2lip stack)."""
    blocks, cin = [], 1
    for cout, k, s, p, res in _W2L_SPEC:
        blocks.append(Conv2d(cin, cout, k, s, p, residual=res))
        cin = cout
    return nn.Sequential(*blocks)


class Audio2ExpNet(nn.Module):
    """SimpleWrapperV2: the wav2lip encoder + Linear(512 + 64 + 1 -> 64)."""

    def __init__(self):
        super().__init__()
        self.audio_encoder = wav2lip_audio_encoder()
        self.mapping1 = nn.Linear(512 + 64 + 1, 64)

    def forward(self, mel, ref, ratio):
        """mel [N, 80, 16]; ref [N, 64]; ratio [N, 1] -> exp [N, 64]."""
        x = self.audio_encoder(mel[:, None]).flatten(1)
        return self.mapping1(torch.cat([x, ref, ratio], dim=-1))


class ResidualConv(nn.Module):
    """audio2pose_models/networks.py:5-26: a pre-BN block plus a conv skip."""

    def __init__(self, cin: int, cout: int, stride=1):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.BatchNorm2d(cin), nn.ReLU(),
            nn.Conv2d(cin, cout, 3, stride=stride, padding=1),
            nn.BatchNorm2d(cout), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1))
        self.conv_skip = nn.Sequential(nn.Conv2d(cin, cout, 3, stride=stride, padding=1),
                                       nn.BatchNorm2d(cout))

    def forward(self, x):
        return self.conv_block(x) + self.conv_skip(x)


class Upsample(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride):
        super().__init__()
        self.upsample = nn.ConvTranspose2d(cin, cout, kernel, stride)

    def forward(self, x):
        return self.upsample(x)


class PoseResUnet(nn.Module):
    """ResUnet over the [N, 1, seq_len, 6] pose map (res_unet.py:6-66)."""

    def __init__(self, channel: int = 1, filters: Sequence[int] = (32, 64, 128, 256)):
        super().__init__()
        f = filters
        self.input_layer = nn.Sequential(
            nn.Conv2d(channel, f[0], 3, padding=1), nn.BatchNorm2d(f[0]), nn.ReLU(),
            nn.Conv2d(f[0], f[0], 3, padding=1))
        self.input_skip = nn.Sequential(nn.Conv2d(channel, f[0], 3, padding=1))
        self.residual_conv_1 = ResidualConv(f[0], f[1], (2, 1))
        self.residual_conv_2 = ResidualConv(f[1], f[2], (2, 1))
        self.bridge = ResidualConv(f[2], f[3], (2, 1))
        self.upsample_1 = Upsample(f[3], f[3], (2, 1), (2, 1))
        self.up_residual_conv1 = ResidualConv(f[3] + f[2], f[2])
        self.upsample_2 = Upsample(f[2], f[2], (2, 1), (2, 1))
        self.up_residual_conv2 = ResidualConv(f[2] + f[1], f[1])
        self.upsample_3 = Upsample(f[1], f[1], (2, 1), (2, 1))
        self.up_residual_conv3 = ResidualConv(f[1] + f[0], f[0])
        self.output_layer = nn.Sequential(nn.Conv2d(f[0], 1, 1, 1), nn.Sigmoid())

    def forward(self, x):
        x1 = self.input_layer(x) + self.input_skip(x)
        x2 = self.residual_conv_1(x1)
        x3 = self.residual_conv_2(x2)
        x4 = self.bridge(x3)
        x6 = self.up_residual_conv1(torch.cat([self.upsample_1(x4), x3], dim=1))
        x8 = self.up_residual_conv2(torch.cat([self.upsample_2(x6), x2], dim=1))
        x10 = self.up_residual_conv3(torch.cat([self.upsample_3(x8), x1], dim=1))
        return self.output_layer(x10)


class CVAEDecoder(nn.Module):
    """DECODER (cvae.py:99-150): class-biased latent + audio -> pose motion."""

    def __init__(self, layer_sizes: Sequence[int] = (128, 192), latent_size: int = 64,
                 num_classes: int = 46, audio_emb_in: int = 512,
                 audio_emb_out: int = 6, seq_len: int = 32):
        super().__init__()
        self.resunet = PoseResUnet()
        self.seq_len = seq_len
        self.MLP = nn.Sequential()
        sizes = [latent_size + seq_len * audio_emb_out + 6] + list(layer_sizes)
        for i, (cin, cout) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.MLP.add_module(f"L{i}", nn.Linear(cin, cout))
            self.MLP.add_module(f"A{i}" if i + 1 < len(layer_sizes) else "sigmoid",
                                nn.ReLU() if i + 1 < len(layer_sizes) else nn.Sigmoid())
        self.pose_linear = nn.Linear(6, 6)
        self.linear_audio = nn.Linear(audio_emb_in, audio_emb_out)
        self.classbias = nn.Parameter(torch.randn(num_classes, latent_size))

    def forward(self, z, class_id, ref, audio_emb):
        """z [B, latent]; class_id [B] int; ref [B, 6]; audio_emb
        [B, seq_len, 512] -> pose motion [B, seq_len, 6]."""
        bs = z.shape[0]
        audio_out = self.linear_audio(audio_emb).reshape(bs, -1)
        z = z + self.classbias[class_id]
        x = self.MLP(torch.cat([ref, z, audio_out], dim=-1))
        x = x.reshape(bs, self.seq_len, -1)[:, None]          # [B, 1, 32, 6]
        return self.pose_linear(self.resunet(x)[:, 0])


class AudioEncoder(nn.Module):
    """audio2pose_models/audio_encoder.py: the wav2lip stack over a
    [B, T, 80, 16] window sequence -> [B, T, 512]."""

    def __init__(self):
        super().__init__()
        self.audio_encoder = wav2lip_audio_encoder()

    def forward(self, mels):
        b, t = mels.shape[:2]
        emb = self.audio_encoder(mels.reshape(b * t, 1, 80, 16))
        return emb.reshape(b, t, -1)


class _CVAE(nn.Module):
    """The CVAE's test-time half (the training encoder is not built)."""

    def __init__(self, latent_size: int, seq_len: int):
        super().__init__()
        self.decoder = CVAEDecoder(latent_size=latent_size, seq_len=seq_len)


class Audio2PoseCVAE(nn.Module):
    """Test-time Audio2Pose (audio2pose.py:48-96): windowed CVAE sampling."""

    def __init__(self, latent_size: int = 64, seq_len: int = 32):
        super().__init__()
        self.latent_size, self.seq_len = latent_size, seq_len
        self.audio_encoder = AudioEncoder()
        self.netG = _CVAE(latent_size, seq_len)

    def forward(self, indiv_mels, ref_pose, class_id, generator=None, z=None):
        """indiv_mels [B, T, 80, 16] (window 0 = the reference frame);
        ref_pose [B, 6]; class_id [B] -> pose [B, T, 6] (a zero motion
        lead frame, then T - 1 predictions). One latent [B, latent] a
        window (each whole 32-frame window, then the tail's): z[i] when
        given, else drawn from `generator`."""
        b, t_all = indiv_mels.shape[:2]
        mels = indiv_mels[:, 1:]
        div, re = divmod(t_all - 1, self.seq_len)
        dec = self.netG.decoder

        def latent(i):
            if z is not None:
                zi = z[i] if torch.is_tensor(z[i]) else torch.from_numpy(np.array(z[i]))
                return zi.to(ref_pose.device, ref_pose.dtype)
            return torch.randn((b, self.latent_size), generator=generator,
                               device=ref_pose.device, dtype=ref_pose.dtype)

        preds = [torch.zeros((b, 1, 6), dtype=ref_pose.dtype, device=ref_pose.device)]
        for i in range(div):
            emb = self.audio_encoder(mels[:, i * self.seq_len:(i + 1) * self.seq_len])
            preds.append(dec(latent(i), class_id, ref_pose, emb))
        if re != 0:
            emb = self.audio_encoder(mels[:, -self.seq_len:])
            if emb.shape[1] != self.seq_len:        # short audio: pad left
                pad = emb[:, :1].expand(-1, self.seq_len - emb.shape[1], -1)
                emb = torch.cat([pad, emb], dim=1)
            preds.append(dec(latent(div), class_id, ref_pose, emb)[:, -re:])
        return ref_pose[:, None] + torch.cat(preds, dim=1)


# ---------------------------------------------------------------- drivers

def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


@torch.no_grad()
def generate_coeffs(exp_net: Audio2ExpNet, pose_net: Audio2PoseCVAE,
                    wav: np.ndarray, ref_coeff70: np.ndarray,
                    pose_style: int = 0, fps: int = 25,
                    generator: Optional[torch.Generator] = None,
                    still: bool = False,
                    ref_pose_coeff: Optional[np.ndarray] = None,
                    z=None) -> np.ndarray:
    """Audio2Coeff.generate (test_audio2coeff.py:74-105): wav + reference
    70-d coeff -> [T, 70] coefficient track (exp 64 + pose 6). The nets
    run on their own device in fp32; `generator` (on that device; seeded
    42 when None) draws the pose latents, or `z` gives them."""
    from scipy.signal import savgol_filter
    dev = _device(exp_net)
    if generator is None and z is None:
        generator = torch.Generator(device=dev).manual_seed(42)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    mels = indiv_mel_windows(wav, fps=fps)       # [T, 80, 16]
    t = mels.shape[0]
    ratio = (blink_ratio(t, np.random.RandomState(42)) if not still
             else np.zeros((t, 1), np.float32))

    # exp: 10-frame chunks (audio2exp.py:21-33)
    ref_exp = np.repeat(ref_coeff70[None, :64], t, axis=0)
    exp_pred = np.concatenate([
        exp_net(to_dev(mels[i:i + 10]), to_dev(ref_exp[i:i + 10]),
                to_dev(ratio[i:i + 10])).cpu().numpy()
        for i in range(0, t, 10)], axis=0)                  # [T, 64]

    # pose: windowed CVAE over T + 1 windows (window 0 = the reference frame)
    mels_pose = to_dev(np.concatenate([mels[:1], mels], 0))[None]
    pose_pred = pose_net(mels_pose, to_dev(ref_coeff70[None, 64:70]),
                         torch.tensor([pose_style], device=dev), generator=generator,
                         z=z)[0, :t].cpu().numpy()          # [T, 6]

    win = 13 if t >= 13 else (max(3, (t - 1) // 2 * 2 + 1))
    pose_pred = savgol_filter(pose_pred, win, 2, axis=0)

    coeffs = np.concatenate([exp_pred, pose_pred], axis=-1).astype(np.float32)
    if ref_pose_coeff is not None:
        rp = ref_pose_coeff[:, 64:70]
        reps = -(-t // rp.shape[0])
        rp = np.tile(rp, (reps, 1))[:t]
        coeffs[:, 64:70] += rp - rp[0:1]
    if still:
        coeffs[1:, 64:] = coeffs[0:1, 64:]
    return coeffs


@dataclasses.dataclass
class BFMModel:
    """Basel Face Model landmark math (face3d/models/bfm.py; data external)."""

    mean_shape: np.ndarray       # [N*3]
    id_base: np.ndarray          # [N*3, 80]
    exp_base: np.ndarray         # [N*3, 64]
    keypoints: np.ndarray        # [68] vertex ids
    focal: float = 1015.0
    center: float = 112.0
    camera_distance: float = 10.0
    # the render's data (bfm.py:50-58), with with_render_data=True;
    # face3d_render reads them
    tex_base: Optional[np.ndarray] = None    # [N*3, 80]
    mean_tex: Optional[np.ndarray] = None    # [N*3]
    face_buf: Optional[np.ndarray] = None    # [F, 3] vertex ids
    point_buf: Optional[np.ndarray] = None   # [N, 8] face ids

    @classmethod
    def load(cls, mat_path: str, with_render_data: bool = False) -> "BFMModel":
        """BFM_model_front.mat: the mean shape recentred (bfm.py:68-72),
        1-based indices made 0-based."""
        from scipy.io import loadmat
        m = loadmat(mat_path)
        ms = m["meanshape"].astype(np.float32).reshape(-1, 3)
        ms = ms - ms.mean(axis=0, keepdims=True)
        extra = {}
        if with_render_data:
            extra = dict(tex_base=m["texBase"].astype(np.float32),
                         mean_tex=m["meantex"].astype(np.float32).reshape(-1),
                         face_buf=m["tri"].astype(np.int64) - 1,
                         point_buf=m["point_buf"].astype(np.int64) - 1)
        return cls(mean_shape=ms.reshape(-1),
                   id_base=m["idBase"].astype(np.float32),
                   exp_base=m["exBase"].astype(np.float32),
                   keypoints=np.squeeze(m["keypoints"]).astype(np.int64) - 1,
                   **extra)

    def landmarks(self, coeffs: np.ndarray) -> np.ndarray:
        """[B, 257] full coeffs -> [B, 68, 2] landmarks in 224-crop coords
        (y up, as facemodel.pred_lm before the flip in visualize.py:86)."""
        idc, expc = coeffs[:, :80], coeffs[:, 80:144]
        angles, trans = coeffs[:, 224:227], coeffs[:, 254:257]
        shape = (idc @ self.id_base.T + expc @ self.exp_base.T
                 + self.mean_shape[None]).reshape(len(coeffs), -1, 3)
        shape = shape @ _rotation(angles) + trans[:, None]
        shape[..., -1] = self.camera_distance - shape[..., -1]
        proj = np.array([[self.focal, 0, self.center],
                         [0, self.focal, self.center],
                         [0, 0, 1.0]], np.float32).T
        p = shape @ proj
        xy = p[..., :2] / p[..., 2:]
        return xy[:, self.keypoints]


def _rotation(angles: np.ndarray) -> np.ndarray:
    """compute_rotation (bfm.py:175-209): (Rz @ Ry @ Rx).T per sample."""
    out = np.zeros((len(angles), 3, 3), np.float32)
    for i, (x, y, z) in enumerate(angles):
        rx = np.array([[1, 0, 0], [0, np.cos(x), -np.sin(x)],
                       [0, np.sin(x), np.cos(x)]])
        ry = np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0],
                       [-np.sin(y), 0, np.cos(y)]])
        rz = np.array([[np.cos(z), -np.sin(z), 0],
                       [np.sin(z), np.cos(z), 0], [0, 0, 1]])
        out[i] = (rz @ ry @ rx).T
    return out


def compose_full_coeffs(first_frame_coeff257: np.ndarray,
                        coeff_track70: np.ndarray) -> np.ndarray:
    """visualize.py:36-40: the predicted exp / pose spliced into the first
    frame's full 257-d coefficients."""
    full = np.repeat(first_frame_coeff257, len(coeff_track70), axis=0).copy()
    full[:, 80:144] = coeff_track70[:, :64]
    full[:, 224:227] = coeff_track70[:, 64:67]
    full[:, 254:] = coeff_track70[:, 67:]
    return full


def uncrop_landmarks(landmarks224: np.ndarray, trans_params: np.ndarray,
                     crop_info) -> np.ndarray:
    """visualize.py:64-91: 224-crop coords -> original image coords."""
    s = trans_params[2]
    orig_left, orig_up = int(trans_params[5]), int(trans_params[6])
    (_, _), (clx, cly, crx, cry), (lx, ly, rx, ry) = crop_info
    ox1, oy1 = int(clx) + int(lx), int(cly) + int(ly)
    ox2, oy2 = int(clx) + int(rx), int(cly) + int(ry)
    lm = landmarks224.copy()
    lm[..., 1] = 224 - lm[..., 1]
    scale = np.array([[(ox2 - ox1) / 256.0, (oy2 - oy1) / 256.0]])
    shift = np.array([[orig_left, orig_up]])
    shift2 = np.array([[ox1, oy1]])
    return (lm + shift) / s * scale + shift2


def sadtalker_audio_to_landmarks(exp_net, pose_net, bfm: BFMModel, wav: np.ndarray,
                                 first_frame_coeff257: np.ndarray,
                                 trans_params: np.ndarray, crop_info,
                                 pose_style: int = 0, fps: int = 25,
                                 generator=None, still: bool = False,
                                 return_coeffs: bool = False, z=None):
    """The SadTalker --face3dvis landmark path (inference.py:31-134 +
    visualize.py:20-133): wav + first-frame 3DMM fit -> [T + 1, 68, 2]
    landmarks in original image coords (frame 0 = the reference pose).
    With return_coeffs, also the [T + 1, 257] coefficient track
    (face3d_render.render_face_video renders it)."""
    ref70 = np.concatenate([first_frame_coeff257[0, 80:144],
                            first_frame_coeff257[0, 224:227],
                            first_frame_coeff257[0, 254:257]])
    coeffs = generate_coeffs(exp_net, pose_net, wav, ref70, pose_style=pose_style,
                             fps=fps, generator=generator, still=still, z=z)
    full = compose_full_coeffs(first_frame_coeff257, coeffs)
    all_coeffs = np.concatenate([first_frame_coeff257, full], axis=0)
    lm = uncrop_landmarks(bfm.landmarks(all_coeffs), trans_params, crop_info)
    return (lm, all_coeffs) if return_coeffs else lm


def sadtalker_video_to_landmarks(bfm: BFMModel, first_frame_coeff257: np.ndarray,
                                 driving_coeffs70: np.ndarray,
                                 trans_params: np.ndarray, crop_info,
                                 relative_pose: bool = True,
                                 return_coeffs: bool = False):
    """Video-driven retargeting (the sadtalker_video2pose path): a driving
    video's per-frame exp + pose track steers the reference identity, its
    pose taken relative to its first frame."""
    coeffs = driving_coeffs70.astype(np.float32).copy()
    if relative_pose:
        ref_pose = np.concatenate([first_frame_coeff257[0, 224:227],
                                   first_frame_coeff257[0, 254:257]])
        coeffs[:, 64:70] = ref_pose[None] + (coeffs[:, 64:70] - coeffs[0:1, 64:70])
    full = compose_full_coeffs(first_frame_coeff257, coeffs)
    all_coeffs = np.concatenate([first_frame_coeff257, full], axis=0)
    lm = uncrop_landmarks(bfm.landmarks(all_coeffs), trans_params, crop_info)
    return (lm, all_coeffs) if return_coeffs else lm
