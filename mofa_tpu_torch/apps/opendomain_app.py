"""One-shot keypoint facial animation: audio -> landmarks -> video.

Counterpart of mofa_tpu/apps/opendomain_app.py (the reference
MOFA-Video-Keypoint/inference_opendomain.py, which chains three processes):
here in one process, `audio2ldmk_app` (the AniPortrait engine) writes
landmarks.npy into --work_dir, `keypoint_app` renders it, and the audio is
muxed in with ffmpeg where there is one (else the silent video is copied).

    python -m mofa_tpu_torch.apps.opendomain_app --image in.png --audio a.wav \
        --face_npz face.npz --bf16
    python -m mofa_tpu_torch.apps.opendomain_app ... --device cpu --tiny \
        --target_size 64 --num_frames 7 --window_size 4 --stride 2 \
        --num_inference_steps 1

Only the aniportrait engine is ported, so there is no --engine; the JAX
CLI's --cfg_split (a 16 GB TPU workaround) is dropped.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

from mofa_tpu_torch.apps import audio2ldmk_app, keypoint_app


def build_parser():
    p = argparse.ArgumentParser(
        description="MOFA open-domain facial animation, audio-driven (PyTorch)")
    p.add_argument("--image", required=True)
    p.add_argument("--audio", required=True)
    p.add_argument("--output", default="output.mp4")
    p.add_argument("--work_dir", default="./opendomain_out")
    p.add_argument("--face_npz", required=True)
    p.add_argument("--a2m_ckpt", default=None)
    p.add_argument("--a2p_ckpt", default=None)
    p.add_argument("--svd_dir", default=None)
    p.add_argument("--controlnet_dir", default=None)
    p.add_argument("--cmp_ckpt", default=None)
    p.add_argument("--num_frames", type=int, default=125)
    p.add_argument("--window_size", type=int, default=25)
    p.add_argument("--window_batch", type=int, default=1)
    p.add_argument("--stride", type=int, default=12)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--target_size", type=int, default=512)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    return p


def run(args):
    os.makedirs(args.work_dir, exist_ok=True)
    common = ["--device", args.device] + (["--tiny"] if args.tiny else [])

    # stage 1: audio -> landmarks.npy (the reference's contract)
    ldmk_args = ["--ref_image_path", args.image, "--audio_path", args.audio,
                 "--save_dir", args.work_dir,
                 "--fps", str(args.fps), "--face_npz", args.face_npz] + common
    for flag, val in (("--a2m_ckpt", args.a2m_ckpt), ("--a2p_ckpt", args.a2p_ckpt)):
        if val:
            ldmk_args += [flag, val]
    audio2ldmk_app.main(ldmk_args)

    # stage 2: landmarks -> windowed video
    silent_path = os.path.join(args.work_dir, "video_silent" +
                               os.path.splitext(args.output)[1])
    kp_args = ["--image", args.image,
               "--landmarks", os.path.join(args.work_dir, "landmarks.npy"),
               "--output", silent_path, "--num_frames", str(args.num_frames),
               "--window_size", str(args.window_size), "--stride", str(args.stride),
               "--window_batch", str(args.window_batch),
               "--num_inference_steps", str(args.num_inference_steps),
               "--target_size", str(args.target_size), "--fps", str(args.fps),
               "--seed", str(args.seed)] + common
    for flag, val in (("--svd_dir", args.svd_dir),
                      ("--controlnet_dir", args.controlnet_dir),
                      ("--cmp_ckpt", args.cmp_ckpt)):
        if val:
            kp_args += [flag, val]
    if args.bf16:
        kp_args += ["--bf16"]
    keypoint_app.main(kp_args)

    # stage 3: mux the audio in (inference_opendomain.py:169-172)
    if shutil.which("ffmpeg") and args.output.endswith(".mp4"):
        subprocess.run(["ffmpeg", "-v", "quiet", "-y", "-i", silent_path,
                        "-i", args.audio, "-c:v", "copy", "-shortest",
                        args.output], check=True)
    else:
        shutil.copyfile(silent_path, args.output)
        print("no ffmpeg (or not an mp4): wrote the silent video")
    print(f"wrote {args.output}")


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
