"""3DMM fit CLI: an image -> the `--coeff_npz` of the SadTalker engine.

Counterpart of mofa_tpu/apps/face_fit_app.py (the reference's
CropAndExtract, sadtalker_audio2pose/src/utils/preprocess.py:46-175):
image + 68-point keypoints (y down) -> the POS alignment and 224 crop ->
ReconNet (ResNet-50 + seven coefficient heads) -> an npz with full_3dmm
[1, 257], coeff_3dmm [1, 76], trans_params [8] and crop_info, which
`audio2ldmk_app --engine sadtalker` reads.

    python -m mofa_tpu_torch.apps.face_fit_app --image in.png --kp kp.npy \
        --lm3d_mat similarity_Lm3D_all.mat --ckpt epoch_20.pth --save coeff.npz
    python -m mofa_tpu_torch.apps.face_fit_app --image in.png \
        --fan_ckpt alignment_WFLW_4HG.pth --bbox 40,30,220,230 ...
    python -m mofa_tpu_torch.apps.face_fit_app ... --device cpu --fan_tiny --tiny

The image is read through cv2 and resized to --pic_size square (Pillow's
bilinear, reproduced without PIL). The keypoints come from --kp ([68, 2],
.npy or whitespace text) or from the AWing FAN (models/face_alignment.py:
--fan_ckpt, or --fan_tiny, one module of random weights) on the --bbox
crop, on BlazeFace's box (--task, a mediapipe .task bundle; the box
padded as the video fit pads it, models/mp_face.py) or on the whole
image. --ckpt is a
net_recon checkpoint (.pth / .pth.tar, or SadTalker's combined
.safetensors, whose `face_3drecon.` keys are taken), loaded strict;
without one the net has seeded random weights. It runs on the CUDA device
unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mofa_tpu_torch.apps.loaders import init_random_cmp_
from mofa_tpu_torch.apps.traj_app import resolve_device
from mofa_tpu_torch.models.audio.face3d_fit import (TINY_RECON, ReconNet, fit_image,
                                                    load_lm3d)
from mofa_tpu_torch.models.face_alignment import (FAN, get_landmarks,
                                                  landmark_98_to_68)
from mofa_tpu_torch.models.weights import (face3d_recon_state_dict, fan_state_dict,
                                           read_state_dict)
from mofa_tpu_torch.preprocess.image import BILINEAR, pil_resize, read_image


def build_parser():
    p = argparse.ArgumentParser(description="MOFA 3DMM face fit (PyTorch)")
    p.add_argument("--image", required=True)
    p.add_argument("--kp", default=None,
                   help="[68, 2] keypoints (.npy or whitespace .txt); omit to "
                        "detect them with the FAN (--fan_ckpt / --fan_tiny)")
    p.add_argument("--fan_ckpt", default=None, help="facexlib alignment_WFLW_4HG.pth")
    p.add_argument("--bbox", default=None,
                   help="face box 'x1,y1,x2,y2' for the FAN crop (default: "
                        "BlazeFace's with --task, else the whole image)")
    p.add_argument("--task", default=None,
                   help="mediapipe .task bundle: the face box from BlazeFace "
                        "(instead of --bbox)")
    p.add_argument("--fan_tiny", action="store_true",
                   help="a 1-module FAN of random weights (smoke runs)")
    p.add_argument("--lm3d_mat", required=True,
                   help="similarity_Lm3D_all.mat (the BFM fitting directory)")
    p.add_argument("--ckpt", default=None,
                   help="net_recon checkpoint (epoch_*.pth / SadTalker .safetensors)")
    p.add_argument("--save", required=True, help="output npz path")
    p.add_argument("--pic_size", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="a tiny ReconNet (layers 1, 1, 1, 1, width 8; smoke runs)")
    return p


def load_face_nets(recon_ckpt, fan_ckpt, device, tiny: bool = False,
                   fan_tiny: bool = False, fan: bool = True, seed: int = 0):
    """(ReconNet, FAN or None) in eval mode on `device`, fp32: each from
    its checkpoint (strict), else seeded random (BatchNorm statistics
    included)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        recon = ReconNet(**TINY_RECON) if tiny else ReconNet()
        fan_net = (FAN(num_modules=1) if fan_tiny else FAN()) if fan else None
    for net, ckpt, to_sd in ((recon, recon_ckpt, face3d_recon_state_dict),
                             (fan_net, fan_ckpt, fan_state_dict)):
        if net is None:
            continue
        if ckpt:
            net.load_state_dict(to_sd(read_state_dict(ckpt)), strict=True)
        else:
            init_random_cmp_(net, generator)     # any BatchNorm net
        net.eval().requires_grad_(False)
    return recon, fan_net


def detect_kp(fan: FAN, img_rgb: np.ndarray, bbox=None) -> np.ndarray:
    """68 keypoints (x, y, y down) of the face in the box (x1, y1, x2, y2),
    or in the whole image: the FAN's 98 points mapped to 68 and uncropped
    (extract_kp_videos_safe.py:64-77)."""
    h, w = img_rgb.shape[:2]
    x1, y1, x2, y2 = bbox if bbox is not None else (0, 0, w, h)
    # degenerate (zero-area) boxes grow to two pixels
    crop = img_rgb[y1:max(y2, y1 + 2), x1:max(x2, x1 + 2)]
    kp = landmark_98_to_68(get_landmarks(fan, crop))
    kp[:, 0] += x1
    kp[:, 1] += y1
    return kp.astype(np.float32)


def run(args):
    if not (args.kp or args.fan_ckpt or args.fan_tiny):
        raise SystemExit("need --kp or --fan_ckpt / --fan_tiny")
    dev = resolve_device(args.device)
    img = pil_resize(read_image(args.image), (args.pic_size, args.pic_size), BILINEAR)
    recon, fan = load_face_nets(args.ckpt, args.fan_ckpt, dev, tiny=args.tiny,
                                fan_tiny=args.fan_tiny, fan=not args.kp)
    if args.kp:
        kp = (np.load(args.kp) if args.kp.endswith(".npy")
              else np.loadtxt(args.kp)).reshape(-1, 2).astype(np.float32)
    else:
        bbox = None
        if args.bbox:
            bbox = [int(v) for v in args.bbox.split(",")]
        elif args.task:   # BlazeFace's box (mofa_tpu/apps/face_fit_app.py:67-71)
            from mofa_tpu_torch.models.mp_face import load_face_detector
            from mofa_tpu_torch.preprocess.video_fit import detect_video_boxes
            box = detect_video_boxes(img[None], load_face_detector(args.task, dev))[0]
            bbox = [int(v) for v in box]
        kp = detect_kp(fan, img, bbox)
    full, coeff, tp = fit_image(recon, img, kp, load_lm3d(args.lm3d_mat))
    h = w = args.pic_size
    crop_info = np.array(((w, h), (0, 0, w, h), (0, 0, w, h)), object)
    os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
    np.savez(args.save, full_3dmm=full, coeff_3dmm=coeff, trans_params=tp,
             crop_info=crop_info)
    print(f"wrote {args.save} full_3dmm{full.shape} trans_params={tp[:5]}")


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
