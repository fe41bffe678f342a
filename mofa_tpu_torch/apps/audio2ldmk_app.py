"""Audio -> landmarks.npy CLI (the AniPortrait engine).

Counterpart of mofa_tpu/apps/audio2ldmk_app.py (reference
MOFA-Video-Hybrid/aniportrait/audio2ldmk.py): wav -> wav2vec2 ->
Audio2Mesh (+ the reference face's 3D landmarks) -> Audio2Pose (5-second
chunks) -> smoothing -> perspective projection -> 468 -> 68 ->
landmarks.npy, the [T, 68, 2] track `keypoint_app` and `hybrid_app` read.

    python -m mofa_tpu_torch.apps.audio2ldmk_app --ref_image_path in.png \
        --audio_path a.wav --face_npz face.npz --save_dir out
    python -m mofa_tpu_torch.apps.audio2ldmk_app ... --device cpu --tiny

The reference face comes as --face_npz: mediapipe FaceLandmarker output
with keys lmks [478, 2 or 3] (normalised x, y), lmks3d [468, 3] and
trans_mat [4, 4]. The in-framework landmarker (--task) and the sadtalker
and video engines are not ported yet (ROADMAP.md Queue 1, slice 4): they
exit with a message and run nothing else. Weights come from --a2m_ckpt /
--a2p_ckpt (AniPortrait's audio2mesh.pt / audio2pose.pt, loaded strict)
or are seeded random (Audio2Mesh's out_fn stays zero, as in a fresh
model). It runs on the CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofa_tpu_torch.apps.traj_app import resolve_device
from mofa_tpu_torch.models.audio.aniportrait import (Audio2Mesh, Audio2Pose,
                                                     audio_state_dict,
                                                     audio_to_landmarks)
from mofa_tpu_torch.models.audio.wav2vec2 import TINY_W2V_CONFIG, Wav2Vec2Config
from mofa_tpu_torch.models.weights import load_torch_checkpoint
from mofa_tpu_torch.pipelines.common import init_random_

NOT_PORTED = ("is not ported yet: it belongs to ROADMAP.md Queue 1, slice 4 "
              "(the audio, landmark and face stack)")


def build_parser():
    p = argparse.ArgumentParser(description="MOFA audio -> landmarks (PyTorch)")
    p.add_argument("--ref_image_path", required=True)
    p.add_argument("--audio_path", required=True)
    p.add_argument("--face_npz", default=None,
                   help="mediapipe landmarker output: lmks, lmks3d, trans_mat")
    p.add_argument("--task", default=None,
                   help="mediapipe .task bundle (the in-framework landmarker; "
                        "not ported yet)")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--a2m_ckpt", default=None, help="audio2mesh.pt")
    p.add_argument("--a2p_ckpt", default=None, help="audio2pose.pt")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--engine", choices=("aniportrait", "sadtalker", "video"),
                   default="aniportrait")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="tiny wav2vec2 and a 64-wide decoder (smoke runs; no real weights)")
    return p


def load_audio_models(a2m_ckpt, a2p_ckpt, device, tiny: bool = False):
    """(Audio2Mesh, Audio2Pose) in eval mode on `device`: each from its
    checkpoint (strict), or seeded random without one."""
    w2v = TINY_W2V_CONFIG if tiny else Wav2Vec2Config()
    latent = 64 if tiny else 512
    generator = torch.Generator(device=device).manual_seed(0)
    models = []
    for cls, kw, ckpt in ((Audio2Mesh, dict(out_dim=1404), a2m_ckpt),
                          (Audio2Pose, dict(out_dim=6), a2p_ckpt)):
        with torch.device(device):
            m = cls(w2v, latent_dim=latent, **kw)
        if ckpt:
            m.load_state_dict(audio_state_dict(load_torch_checkpoint(ckpt)), strict=True)
        else:
            init_random_(m, generator)
            if cls is Audio2Mesh:       # a fresh model's out_fn is zero
                torch.nn.init.zeros_(m.out_fn.weight)
                torch.nn.init.zeros_(m.out_fn.bias)
        models.append(m.eval().requires_grad_(False))
    return tuple(models)


def reference_face(face: dict, width: int, height: int) -> tuple:
    """(lmks [478, 2] in pixels, lmks3d [468, 3], trans_mat [4, 4]) from
    the landmarker's contract (lmks normalised)."""
    lmks = np.asarray(face["lmks"], np.float32)[:, :2].copy()
    lmks[:, 0] *= width
    lmks[:, 1] *= height
    return (lmks, np.asarray(face["lmks3d"], np.float32),
            np.asarray(face["trans_mat"], np.float32))


def run(args):
    if args.engine != "aniportrait":
        raise SystemExit(f"--engine {args.engine} {NOT_PORTED}")
    if args.task:
        raise SystemExit(f"--task (the mediapipe landmarker) {NOT_PORTED}; "
                         "pass the reference face as --face_npz")
    if not args.face_npz:
        raise SystemExit("need --face_npz (lmks, lmks3d, trans_mat)")
    from PIL import Image

    dev = resolve_device(args.device)
    width, height = Image.open(args.ref_image_path).size
    lmks, lmks3d, trans_mat = reference_face(np.load(args.face_npz), width, height)
    a2m, a2p = load_audio_models(args.a2m_ckpt, args.a2p_ckpt, dev, args.tiny)
    landmarks = audio_to_landmarks(a2m, a2p, args.audio_path, lmks, lmks3d,
                                   trans_mat, [height, width], fps=args.fps,
                                   sr=args.sr)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "landmarks.npy")
    np.save(out, landmarks)
    print(f"wrote {out} {landmarks.shape}")


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
