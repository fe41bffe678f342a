"""Flow-dataset discovery and readers for the GMFlow and CMP trainers.

Counterpart of mofa_tpu/train/flow_datasets.py (the reference loaders of
Training/train_utils/unimatch/dataloader/flow/datasets.py: MpiSintel
:141-170, FlyingChairs :173-189, FlyingThings3D :192-227, KITTI :278-297,
and the KITTI 16-bit PNG and PFM codecs of utils/frame_utils.py).
Discovery is host code returning lazy sample records; `load_sample` reads
(img1, img2, flow, valid) as float32 numpy arrays, channel-last, the
images through cv2 converted to RGB (the JAX package reads them with PIL,
which the card's machine lacks; both decode 8-bit PNG / PPM to the same
values).

Layouts:
- ``triples``: ``<stem>_img1.<ext>``, ``<stem>_img2.<ext>``,
  ``<stem>_flow.flo`` (ext png / ppm / jpg).
- ``chairs``: FlyingChairs ``<root>/*.ppm`` in sorted pairs with one
  ``*.flo`` per pair.
- ``sintel``: ``<root>/<split>/<clean|final>/<scene>/frame_NNNN.png``
  with ``<root>/<split>/flow/<scene>/frame_NNNN.flo`` for consecutive
  frames.
- ``kitti``: ``<root>/<split>/image_2/NNNNNN_10.png`` + ``_11.png`` with
  ``flow_occ/NNNNNN_10.png`` 16-bit flow + valid.
- ``things``: FlyingThings3D ``<root>/<dstype>/<split>/*/*/left/*.png``
  with ``optical_flow/<split>/*/*/<direction>/left/*.pfm``, left camera,
  both temporal directions.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class FlowSample:
    img1_path: str
    img2_path: str
    flow_path: Optional[str] = None  # None for test splits without GT
    flow_format: str = "flo"         # "flo" | "kitti_png" | "pfm"


def read_flow_kitti(path: str):
    """frame_utils.py:102-107 — 16-bit PNG, (uv - 2^15)/64, third
    channel is the validity mask."""
    import cv2

    png = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if png is None:
        raise FileNotFoundError(f"cannot read {path}")
    png = png[:, :, ::-1].astype(np.float32)  # BGR -> RGB = (u, v, valid)
    flow, valid = (png[:, :, :2] - 2 ** 15) / 64.0, png[:, :, 2]
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray):
    """frame_utils.py:117-121."""
    import cv2

    uv = 64.0 * flow + 2 ** 15
    valid = np.ones(flow.shape[:2] + (1,), np.float32)
    png = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(path, png[:, :, ::-1])


def read_pfm(path: str) -> np.ndarray:
    """frame_utils.py readPFM — PF/Pf header, dims line, scale line whose
    sign encodes endianness; rows stored bottom-up. Flow .pfm files are
    3-channel with the last channel discarded (read_gen)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().rstrip())
        dt = "<f" if scale < 0 else ">f"
        data = np.frombuffer(f.read(), dtype=dt)
    data = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    data = np.flipud(data).astype(np.float32)
    return data[:, :, :2] if channels == 3 else data


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0):
    """frame_utils.py writePFM — little-endian (negative scale), rows
    bottom-up; 2-channel flow is padded to the 3-channel PF form."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3 and data.shape[2] == 2:
        data = np.concatenate([data, np.zeros_like(data[..., :1])], axis=-1)
    header = b"PF" if data.ndim == 3 else b"Pf"
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        f.write(np.flipud(data).astype("<f").tobytes())


def _discover_things(root: str, split: str = "TRAIN",
                     dstype: str = "frames_cleanpass") -> List[FlowSample]:
    """FlyingThings3D (datasets.py:192-227): left camera, both temporal
    directions; into_past swaps the image pair and uses the next flow."""
    out = []
    scene_imgs = sorted(glob.glob(os.path.join(root, dstype, split, "*", "*")))
    scene_flows = sorted(glob.glob(os.path.join(root, "optical_flow", split,
                                                "*", "*")))
    for direction in ("into_future", "into_past"):
        img_dirs = [os.path.join(d, "left") for d in scene_imgs]
        flow_dirs = [os.path.join(d, direction, "left") for d in scene_flows]
        for idir, fdir in zip(img_dirs, flow_dirs):
            images = sorted(glob.glob(os.path.join(idir, "*.png")))
            flows = sorted(glob.glob(os.path.join(fdir, "*.pfm")))
            for i in range(len(flows) - 1):
                if direction == "into_future":
                    out.append(FlowSample(images[i], images[i + 1], flows[i],
                                          flow_format="pfm"))
                else:
                    out.append(FlowSample(images[i + 1], images[i],
                                          flows[i + 1], flow_format="pfm"))
    return out


def _discover_triples(root: str) -> List[FlowSample]:
    out = []
    for flo in sorted(glob.glob(os.path.join(root, "*_flow.flo"))):
        stem = flo[: -len("_flow.flo")]
        imgs = {}
        for tag in ("img1", "img2"):
            hits = sorted(glob.glob(f"{stem}_{tag}.*"))
            hits = [h for h in hits if not h.endswith(".flo")]
            if not hits:
                raise FileNotFoundError(f"missing {stem}_{tag}.* next to {flo}")
            imgs[tag] = hits[0]
        out.append(FlowSample(imgs["img1"], imgs["img2"], flo))
    return out


def _discover_chairs(root: str) -> List[FlowSample]:
    images = sorted(glob.glob(os.path.join(root, "*.ppm")))
    flows = sorted(glob.glob(os.path.join(root, "*.flo")))
    if len(images) != 2 * len(flows):
        raise ValueError(f"FlyingChairs layout: {len(images)} ppm vs {len(flows)} flo")
    return [FlowSample(images[2 * i], images[2 * i + 1], flows[i])
            for i in range(len(flows))]


def _discover_sintel(root: str, split: str = "training",
                     dstype: str = "clean") -> List[FlowSample]:
    image_root = os.path.join(root, split, dstype)
    flow_root = os.path.join(root, split, "flow")
    out = []
    for scene in sorted(os.listdir(image_root)):
        frames = sorted(glob.glob(os.path.join(image_root, scene, "*.png")))
        flows = (sorted(glob.glob(os.path.join(flow_root, scene, "*.flo")))
                 if os.path.isdir(os.path.join(flow_root, scene)) else [])
        for i in range(len(frames) - 1):
            out.append(FlowSample(frames[i], frames[i + 1],
                                  flows[i] if i < len(flows) else None))
    return out


def _discover_kitti(root: str, split: str = "training") -> List[FlowSample]:
    base = os.path.join(root, split)
    img1 = sorted(glob.glob(os.path.join(base, "image_2", "*_10.png")))
    img2 = sorted(glob.glob(os.path.join(base, "image_2", "*_11.png")))
    if len(img1) != len(img2):
        raise ValueError("KITTI image_2 pairs mismatch")
    out = []
    for a, b in zip(img1, img2):
        flo = os.path.join(base, "flow_occ", os.path.basename(a))
        out.append(FlowSample(a, b, flo if os.path.isfile(flo) else None,
                              flow_format="kitti_png"))
    return out


def discover_flow_samples(root: str, layout: str = "auto",
                          **kw) -> List[FlowSample]:
    """layout: auto | triples | chairs | sintel | kitti | things.
    ``auto`` sniffs the directory structure in that order."""
    if layout == "auto":
        if glob.glob(os.path.join(root, "*_flow.flo")):
            layout = "triples"
        elif glob.glob(os.path.join(root, "*.ppm")):
            layout = "chairs"
        elif os.path.isdir(os.path.join(root, kw.get("split", "training"),
                                        kw.get("dstype", "clean"))):
            layout = "sintel"
        elif os.path.isdir(os.path.join(root, kw.get("split", "training"),
                                        "image_2")):
            layout = "kitti"
        elif os.path.isdir(os.path.join(root, "optical_flow")):
            layout = "things"
        else:
            raise ValueError(f"cannot sniff flow-dataset layout in {root}")
    fn = {"triples": _discover_triples, "chairs": _discover_chairs,
          "sintel": _discover_sintel, "kitti": _discover_kitti,
          "things": _discover_things}[layout]
    samples = fn(root, **kw) if layout in ("sintel", "kitti", "things") \
        else fn(root)
    if not samples:
        raise FileNotFoundError(f"no samples found in {root} (layout={layout})")
    return samples


def read_image_rgb(path: str) -> np.ndarray:
    """An 8-bit image file -> [H, W, 3] float32 RGB (cv2, BGR reversed)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return np.ascontiguousarray(img[:, :, ::-1]).astype(np.float32)


def load_sample(s: FlowSample):
    """Returns (img1, img2, flow, valid) float32 numpy, channel-last.
    flow / valid are None when the sample has no ground truth (test
    splits)."""
    from mofa_tpu_torch.ops.flow_viz import read_flo

    img1 = read_image_rgb(s.img1_path)
    img2 = read_image_rgb(s.img2_path)
    if s.flow_path is None:
        return img1, img2, None, None
    if s.flow_format == "kitti_png":
        flow, valid = read_flow_kitti(s.flow_path)
    elif s.flow_format == "pfm":
        flow = read_pfm(s.flow_path)
        valid = ((np.abs(flow[..., 0]) < 1000)
                 & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
    else:
        flow = read_flo(s.flow_path)
        # .flo datasets mark invalid pixels with huge magnitudes
        # (datasets.py:89-93): valid = |u|, |v| < 1000
        valid = ((np.abs(flow[..., 0]) < 1000)
                 & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
    return img1, img2, flow.astype(np.float32), valid.astype(np.float32)
