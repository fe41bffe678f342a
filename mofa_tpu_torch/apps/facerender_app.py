"""Talking-head renderer CLI: SadTalker's facerender path.

Counterpart of mofa_tpu/apps/facerender_app.py (the reference's
sadtalker_audio2pose/inference.py without --face3dvis ->
src/facerender/animate.py AnimateFromCoeff.generate): a source image, its
first-frame 3DMM fit and a predicted coefficient track -> the facevid2vid
render (models/facerender.py), a frame at a time; then the optional face
enhancer and the paste back into the full image (preprocess/enhance.py).

    python -m mofa_tpu_torch.apps.facerender_app --image face.png \
        --coeff_npz coeff.npz --driving_coeffs_npz track.npz \
        --ckpt SadTalker_V0.0.2_256.safetensors --output out.mp4 \
        [--enhancer gfpgan --gfpgan_ckpt GFPGANv1.4.pth] \
        [--paste_back --full_image full.png --crop_info_npz crop.npz]
    python -m mofa_tpu_torch.apps.facerender_app ... --device cpu --tiny

--coeff_npz holds `full_3dmm` (face_fit_app's output); --driving_coeffs_npz
`coeff_3dmm` [F, 70] (exp + pose). --ckpt is the combined facerender
checkpoint (generator. / kp_extractor. / mapping. / he_estimator.
prefixes), read strict; without it the nets are seeded random. --tiny runs
TINY_FACERENDER_CONFIG with the plain generator at 32^2 (and the tiny
GFPGAN). Images are read with cv2 and resized as Pillow's default
(BICUBIC, reproduced by preprocess/image.py; no PIL). It runs on the CUDA
device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mofa_tpu_torch.apps.traj_app import resolve_device
from mofa_tpu_torch.preprocess.image import BICUBIC, pil_resize, read_image


def build_parser():
    p = argparse.ArgumentParser(description="MOFA facerender (PyTorch)")
    p.add_argument("--image", required=True)
    p.add_argument("--coeff_npz", required=True, help="first-frame fit npz (full_3dmm)")
    p.add_argument("--driving_coeffs_npz", required=True,
                   help="npz with coeff_3dmm [F, 70]")
    p.add_argument("--output", default="facerender.mp4")
    p.add_argument("--ckpt", default=None,
                   help="combined facerender checkpoint (.safetensors / .pth)")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--expression_scale", type=float, default=1.0)
    p.add_argument("--still", action="store_true")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--tiny", action="store_true",
                   help="the tiny config at 32^2 (smoke runs; no real weights)")
    p.add_argument("--enhancer", default="none", choices=["none", "gfpgan", "npz"],
                   help="face enhancer: GFPGAN v1 clean (models/gfpgan.py, aligned-crop "
                        "mode) or frames restored elsewhere (npz)")
    p.add_argument("--gfpgan_ckpt", default=None, help="GFPGANv1.4.pth for --enhancer gfpgan")
    p.add_argument("--enhanced_npz", default=None,
                   help="npz with {'frames': uint8 [T,H,W,3]} from an external enhancer")
    p.add_argument("--paste_back", action="store_true",
                   help="seamless-clone the rendered crop into the full source image "
                        "(paste_pic.py)")
    p.add_argument("--full_image", default=None, help="the full source image for --paste_back")
    p.add_argument("--crop_info_npz", default=None,
                   help="npz with 'crop_info' = [rw,rh, clx,cly,crx,cry, lx,ly,rx,ry]")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a CUDA device) or cpu")
    return p


def load_facerender(ckpt, device, cfg=None, spade: bool = True, seed: int = 0,
                    with_he: bool = False) -> dict:
    """The facerender nets in eval mode on `device`, fp32: kp_detector,
    mapping, generator (the SPADE generator, or with `spade=False` the
    plain one) and, with `with_he`, he_estimator, at `cfg` (default the
    full FaceRenderConfig). From the combined checkpoint `ckpt` (strict),
    else seeded random (BatchNorm statistics included)."""
    from mofa_tpu_torch.apps.loaders import init_random_cmp_
    from mofa_tpu_torch.models import facerender as fr
    from mofa_tpu_torch.models.weights import read_state_dict
    cfg = cfg or fr.FaceRenderConfig()
    with torch.device(device):
        nets = {"kp_detector": fr.KPDetector(cfg), "mapping": fr.MappingNet(cfg),
                "generator": (fr.OcclusionAwareSPADEGenerator(cfg) if spade
                              else fr.OcclusionAwareGenerator(cfg))}
        if with_he:
            nets["he_estimator"] = fr.HEEstimator(cfg)
    sds = fr.facerender_state_dicts(read_state_dict(ckpt)) if ckpt else {}
    g = torch.Generator(device=device).manual_seed(seed)
    for name, net in nets.items():
        if ckpt:
            if name not in sds:
                raise KeyError(f"{ckpt} has no {fr.FACERENDER_PREFIXES[name]}* weights")
            net.load_state_dict(sds[name], strict=True)
        else:
            init_random_cmp_(net, g)
        net.eval().requires_grad_(False)
    return nets


def source_coeff70(full_3dmm: np.ndarray) -> np.ndarray:
    """full_3dmm [1, 257] -> exp + angle + trans [1, 70] (a [1, 70+] input
    is taken as it is)."""
    first = np.asarray(full_3dmm, np.float32).reshape(1, -1)
    if first.shape[1] >= 257:
        return np.concatenate([first[:, 80:144], first[:, 224:227], first[:, 254:257]],
                              axis=1)
    return first[:, :70]


def render(args, dev) -> np.ndarray:
    """The facerender frames, uint8 [F, S, S, 3]."""
    from mofa_tpu_torch.models import facerender as fr
    size = 32 if args.tiny else args.size
    img = pil_resize(read_image(args.image), (size, size), BICUBIC)
    source = torch.from_numpy(img.astype(np.float32) / 255.0).permute(2, 0, 1)[None]
    src70 = source_coeff70(np.load(args.coeff_npz, allow_pickle=True)["full_3dmm"])
    driving = np.load(args.driving_coeffs_npz)["coeff_3dmm"][:, :70]
    src_sem, tgt_sem = fr.build_semantics(src70, driving,
                                          expression_scale=args.expression_scale,
                                          still_mode=args.still)
    nets = load_facerender(args.ckpt, dev, fr.TINY_FACERENDER_CONFIG if args.tiny else None,
                           spade=not args.tiny)
    frames = fr.make_animation(source.to(dev), torch.from_numpy(src_sem).to(dev),
                               torch.from_numpy(tgt_sem).to(dev), nets["generator"],
                               nets["kp_detector"], nets["mapping"])
    out = frames[0].permute(0, 2, 3, 1).cpu().numpy()
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def run(args):
    from mofa_tpu_torch.apps.loaders import write_video
    from mofa_tpu_torch.preprocess.enhance import enhance_frames, paste_back_frames
    if args.paste_back and not (args.full_image and args.crop_info_npz):
        raise SystemExit("--paste_back needs --full_image and --crop_info_npz")
    dev = resolve_device(args.device)
    out8 = render(args, dev)
    out8 = enhance_frames(out8, method=args.enhancer, npz_path=args.enhanced_npz,
                          ckpt=args.gfpgan_ckpt, tiny=args.tiny, device=dev)
    if args.paste_back:
        full = read_image(args.full_image)
        ci = np.load(args.crop_info_npz)["crop_info"].astype(np.int64)
        crop_info = (tuple(ci[0:2]), tuple(ci[2:6]), tuple(ci[6:10]))
        out8 = paste_back_frames(out8, full, crop_info)
    write_video(out8.astype(np.float32) / 255.0, args.output, fps=args.fps)
    print(f"wrote {args.output} ({out8.shape[0]} frames @ {out8.shape[2]}x{out8.shape[1]})")
    return out8


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
