"""Audio -> landmarks.npy CLI: the AniPortrait, SadTalker and video engines.

Counterpart of mofa_tpu/apps/audio2ldmk_app.py. Each engine writes
landmarks.npy, the [T, 68, 2] track `keypoint_app` and `hybrid_app` read:

- aniportrait (the default; reference MOFA-Video-Hybrid/aniportrait/
  audio2ldmk.py): wav -> wav2vec2 -> Audio2Mesh (+ the reference face's
  3D landmarks) -> Audio2Pose (5-second chunks) -> smoothing ->
  perspective projection -> 468 -> 68. The reference face comes as
  --face_npz: mediapipe FaceLandmarker output with keys lmks [478, 2 or 3]
  (normalised x, y), lmks3d [468, 3] and trans_mat [4, 4]. Weights from
  --a2m_ckpt / --a2p_ckpt (audio2mesh.pt / audio2pose.pt, strict) or
  seeded random (Audio2Mesh's out_fn zero, as in a fresh model);
- sadtalker (sadtalker_audio2pose inference.py): wav -> the wav2lip mel
  windows -> Audio2Exp and the Audio2Pose CVAE (latents drawn from a
  generator seeded 42) -> a [T, 70] coefficient track -> the BFM's 68
  landmarks, uncropped to the image of --coeff_npz (face_fit_app's
  output: full_3dmm [1, 257], trans_params [8], crop_info) with the BFM
  of --bfm_mat (BFM_model_front.mat). Weights from --exp_ckpt /
  --pose_ckpt (audio2exp_00300-model.pth / audio2pose_00140-model.pth,
  strict) or seeded random. --face3dvis also renders the BFM mesh of
  every frame to 3dface.mp4 (224^2, the z-buffer of
  models/audio/face3d_render.py on the device) and the landmark dots to
  landmarks_vis.mp4;
- video: a driving video's per-frame [T, 70] track retargets the
  --coeff_npz identity, pose relative to the driving track's first frame.
  The track is --driving_coeffs_npz (key coeff_3dmm), or is fitted from
  the raw --driving_video (preprocess/video_fit.py): BlazeFace from --task,
  the AWing FAN (--fan_ckpt, --fan_tiny or seeded random), ReconNet
  (--recon_ckpt, --recon_tiny or seeded random) and --lm3d_mat, each
  frame resized to 256^2.

    python -m mofa_tpu_torch.apps.audio2ldmk_app --ref_image_path in.png \
        --audio_path a.wav --face_npz face.npz --save_dir out
    python -m mofa_tpu_torch.apps.audio2ldmk_app --engine sadtalker \
        --ref_image_path in.png --audio_path a.wav --coeff_npz coeff.npz \
        --bfm_mat BFM_model_front.mat --save_dir out --face3dvis
    python -m mofa_tpu_torch.apps.audio2ldmk_app ... --device cpu --tiny

The aniportrait engine's reference face is --face_npz, or the mediapipe
FaceLandmarker run on --ref_image_path from a face_landmarker .task bundle
(--task; models/mp_face.py). It runs on the CUDA device unless `--device
cpu` is given; images are read through cv2.
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
from mofa_tpu_torch.models.audio.sadtalker import (Audio2ExpNet, Audio2PoseCVAE,
                                                   BFMModel,
                                                   sadtalker_audio_to_landmarks,
                                                   sadtalker_video_to_landmarks)
from mofa_tpu_torch.models.audio.wav2vec2 import TINY_W2V_CONFIG, Wav2Vec2Config
from mofa_tpu_torch.models.weights import (load_torch_checkpoint, read_state_dict,
                                           sadtalker_exp_state_dict,
                                           sadtalker_pose_state_dict)
from mofa_tpu_torch.pipelines.common import init_random_
from mofa_tpu_torch.preprocess.image import read_image

def build_parser():
    p = argparse.ArgumentParser(description="MOFA audio -> landmarks (PyTorch)")
    p.add_argument("--ref_image_path", required=True)
    p.add_argument("--audio_path", required=True)
    p.add_argument("--face_npz", default=None,
                   help="mediapipe landmarker output: lmks, lmks3d, trans_mat")
    p.add_argument("--task", default=None,
                   help="mediapipe face_landmarker .task bundle: the FaceLandmarker "
                        "on --ref_image_path (instead of --face_npz); BlazeFace for "
                        "--driving_video")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--a2m_ckpt", default=None, help="audio2mesh.pt")
    p.add_argument("--a2p_ckpt", default=None, help="audio2pose.pt")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--engine", choices=("aniportrait", "sadtalker", "video"),
                   default="aniportrait")
    p.add_argument("--driving_coeffs_npz", default=None,
                   help="video engine: the driving video's per-frame [T, 70] "
                        "exp + pose track (key coeff_3dmm)")
    p.add_argument("--driving_video", default=None,
                   help="video engine: a raw driving video, fitted frame by frame "
                        "(BlazeFace via --task, the FAN, ReconNet, --lm3d_mat)")
    p.add_argument("--fan_ckpt", default=None,
                   help="facexlib alignment_WFLW_4HG.pth for --driving_video")
    p.add_argument("--fan_tiny", action="store_true",
                   help="a 1-module FAN of random weights (smoke runs)")
    p.add_argument("--recon_ckpt", default=None,
                   help="Deep3DFaceRecon net_recon checkpoint for --driving_video")
    p.add_argument("--recon_tiny", action="store_true",
                   help="a tiny ReconNet of random weights (smoke runs)")
    p.add_argument("--lm3d_mat", default=None,
                   help="similarity_Lm3D_all.mat for --driving_video")
    p.add_argument("--max_frames", type=int, default=None)
    # the sadtalker and video engines' inputs
    p.add_argument("--bfm_mat", default=None, help="BFM_model_front.mat")
    p.add_argument("--coeff_npz", default=None,
                   help="face_fit_app output: full_3dmm [1, 257], trans_params "
                        "[8], crop_info")
    p.add_argument("--exp_ckpt", default=None, help="audio2exp_00300-model.pth")
    p.add_argument("--pose_ckpt", default=None, help="audio2pose_00140-model.pth")
    p.add_argument("--pose_style", type=int, default=0)
    p.add_argument("--face3dvis", action="store_true",
                   help="also render 3dface.mp4 (the BFM mesh, z-buffer) and "
                        "landmarks_vis.mp4 (the dots), as inference.py --face3dvis")
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


def extract_face(args, img: np.ndarray, dev) -> dict:
    """The reference face (lmks normalised [478, 3], lmks3d [468, 3],
    trans_mat [4, 4]): the FaceLandmarker on the image when --task is
    given (the reference's mp_utils.LMKExtractor, audio2ldmk.py:207-218),
    else the --face_npz contract."""
    if args.task:
        from mofa_tpu_torch.models.mp_face import load_face_landmarker
        out = load_face_landmarker(args.task, dev)(img)
        if out is None:
            raise SystemExit("No face detected.")  # audio2ldmk.py:218
        return out
    if not args.face_npz:
        raise SystemExit("need --task (the FaceLandmarker) or --face_npz "
                         "(lmks, lmks3d, trans_mat)")
    return dict(np.load(args.face_npz))


def load_sadtalker_nets(exp_ckpt, pose_ckpt, device, seed: int = 0):
    """(Audio2ExpNet, Audio2PoseCVAE) in eval mode on `device`, fp32: each
    from its checkpoint (strict), or seeded random without one (BatchNorm
    statistics included)."""
    from mofa_tpu_torch.apps.loaders import init_random_cmp_
    generator = torch.Generator(device=device).manual_seed(seed)
    nets = []
    for cls, ckpt, to_sd in ((Audio2ExpNet, exp_ckpt, sadtalker_exp_state_dict),
                             (Audio2PoseCVAE, pose_ckpt, sadtalker_pose_state_dict)):
        with torch.device(device):
            net = cls()
        if ckpt:
            net.load_state_dict(to_sd(read_state_dict(ckpt)), strict=True)
        else:
            init_random_cmp_(net, generator)     # any BatchNorm net
        nets.append(net.eval().requires_grad_(False))
    return tuple(nets)


def read_coeff_npz(path: str):
    """(full_3dmm [1, 257], trans_params [8], crop_info) of a face fit."""
    data = np.load(path, allow_pickle=True)
    coeff257 = data["full_3dmm"].astype(np.float32).reshape(1, -1)
    trans_params = data["trans_params"].astype(np.float32).reshape(-1)
    crop_info = data["crop_info"].tolist() if "crop_info" in data else (
        (256, 256), (0, 0, 256, 256), (0, 0, 256, 256))
    return coeff257, trans_params, crop_info


def _need(args, *names):
    missing = [n for n in names if not getattr(args, n)]
    if missing:
        raise SystemExit(f"--engine {args.engine} needs " +
                         ", ".join("--" + n for n in missing))


def _save(args, landmarks):
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "landmarks.npy")
    np.save(out, landmarks)
    print(f"wrote {out} {landmarks.shape}")


def run_sadtalker(args, dev):
    """wav + a first-frame 3DMM fit -> landmarks.npy (and --face3dvis)."""
    from mofa_tpu_torch.models.audio.aniportrait import load_wav
    _need(args, "coeff_npz", "bfm_mat")
    coeff257, trans_params, crop_info = read_coeff_npz(args.coeff_npz)
    bfm = BFMModel.load(args.bfm_mat, with_render_data=args.face3dvis)
    exp_net, pose_net = load_sadtalker_nets(args.exp_ckpt, args.pose_ckpt, dev)
    landmarks, all_coeffs = sadtalker_audio_to_landmarks(
        exp_net, pose_net, bfm, load_wav(args.audio_path, args.sr), coeff257,
        trans_params, crop_info, pose_style=args.pose_style, fps=args.fps,
        generator=torch.Generator(device=dev).manual_seed(42), return_coeffs=True)
    _save(args, landmarks)
    if args.face3dvis:
        write_face3dvis(args, bfm, landmarks, all_coeffs, dev)


def write_face3dvis(args, bfm, landmarks, all_coeffs, dev):
    """visualize.py:99-129: 3dface.mp4 (the rendered BFM mesh of the
    predicted track, 224^2) and the landmark dots on a white canvas at the
    reference image's size."""
    from mofa_tpu_torch.apps.loaders import write_video
    from mofa_tpu_torch.models.audio.face3d_render import (draw_landmark_video,
                                                           render_face_video)
    frames = render_face_video(bfm, all_coeffs[1:], device=dev)
    write_video(frames.astype(np.float32) / 255.0,
                os.path.join(args.save_dir, "3dface.mp4"), fps=args.fps)
    h, w = read_image(args.ref_image_path).shape[:2]
    dots = draw_landmark_video(landmarks, h, w)
    write_video(dots.astype(np.float32) / 255.0,
                os.path.join(args.save_dir, "landmarks_vis.mp4"), fps=args.fps)
    print(f"wrote {os.path.join(args.save_dir, '3dface.mp4')}")


def fit_driving(args) -> np.ndarray:
    """A raw driving video -> its [T, 70] track (preprocess/video_fit.py):
    the reference's automatic per-frame chain
    (sadtalker_video2pose/inference.py:79-92)."""
    from mofa_tpu_torch.apps.face_fit_app import load_face_nets
    from mofa_tpu_torch.models.audio.face3d_fit import load_lm3d
    from mofa_tpu_torch.models.mp_face import load_face_detector
    from mofa_tpu_torch.preprocess.video_fit import fit_driving_video
    if not args.task:
        raise SystemExit("--driving_video needs --task (BlazeFace)")
    if not args.lm3d_mat:
        raise SystemExit("--driving_video needs --lm3d_mat")
    dev = resolve_device(args.device)
    recon, fan = load_face_nets(args.recon_ckpt, args.fan_ckpt, dev,
                                tiny=args.recon_tiny, fan_tiny=args.fan_tiny)
    coeff70, _ = fit_driving_video(args.driving_video, load_face_detector(args.task, dev),
                                   fan, recon, load_lm3d(args.lm3d_mat),
                                   max_frames=args.max_frames)
    return coeff70


def run_video(args):
    """A driving video's coefficient track (fitted from --driving_video, or
    --driving_coeffs_npz) -> landmarks.npy."""
    _need(args, "coeff_npz", "bfm_mat")
    if args.driving_video:
        driving = fit_driving(args)
    elif args.driving_coeffs_npz:
        driving = np.load(args.driving_coeffs_npz)["coeff_3dmm"]
    else:
        raise SystemExit("--engine video needs --driving_video or --driving_coeffs_npz")
    coeff257, trans_params, crop_info = read_coeff_npz(args.coeff_npz)
    landmarks = sadtalker_video_to_landmarks(BFMModel.load(args.bfm_mat), coeff257,
                                             driving, trans_params, crop_info)
    _save(args, landmarks)


def run(args):
    if args.engine == "video":
        return run_video(args)
    dev = resolve_device(args.device)
    if args.engine == "sadtalker":
        return run_sadtalker(args, dev)
    img = read_image(args.ref_image_path)
    height, width = img.shape[:2]
    lmks, lmks3d, trans_mat = reference_face(extract_face(args, img, dev), width, height)
    a2m, a2p = load_audio_models(args.a2m_ckpt, args.a2p_ckpt, dev, args.tiny)
    landmarks = audio_to_landmarks(a2m, a2p, args.audio_path, lmks, lmks3d,
                                   trans_mat, [height, width], fps=args.fps,
                                   sr=args.sr)
    _save(args, landmarks)


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
