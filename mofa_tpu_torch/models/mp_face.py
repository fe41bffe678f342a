"""The mediapipe FaceLandmarker in PyTorch: BlazeFace, the 478-point landmarks,
the blendshapes and the facial geometry.

Counterpart of mofa_tpu/models/mp_face.py (the reference's LMKExtractor,
MOFA-Video-Hybrid/aniportrait/src/utils/mp_utils.py:19-93), on the .task
bundle's own .tflite graphs compiled by `interop/tflite.py`:

1. BlazeFace short-range (`detect_face`): the frame letterboxed to a
   square, resized to 128^2 as `jax.image.resize(..., "linear")` resizes
   (a triangle filter widened by the downscale factor: antialiased; the
   weight tables built in float32 as JAX builds them), scaled to [-1, 1];
   896 SSD anchors (`blaze_anchors`), sigmoid scores clipped at +-100,
   weighted NMS at IoU 0.3, score >= 0.5 (`decode_detections`,
   `weighted_nms`, on the host as in JAX).
2. The ROI: the eye line's rotation, the box scaled 1.5x square-long, and
   a rotated 256^2 crop in [0, 1] (`FaceLandmarker._crop256`: bilinear
   taps from floor(s - 0.5), indices clamped at the edge, as the JAX
   package samples; not grid_sample's zero padding).
3. The landmark net -> 478 x (x, y, z) / 256, projected back to
   image-normalised coordinates; presence = sigmoid(logit) >= 0.5.
4. The blendshape net on the 146-landmark subset in pixels -> 52 scores
   (the first, neutral, dropped).
5. The geometry (`_solve_pose`, host numpy SVD): weighted orthogonal
   Procrustes against the canonical metric face of the .task's
   geometry_pipeline_metadata_landmarks.binarypb -> trans_mat [4, 4] and
   the metric landmarks lmks3d [468, 3].

The nets run on their modules' device; the rest is host numpy.
"""

from __future__ import annotations

import functools
import struct
import zipfile
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from mofa_tpu_torch.interop.tflite import TFLiteGraph, TFLiteModule, compile_tflite

# mediapipe/tasks/cc/vision/face_landmarker/face_blendshapes_graph.cc
# kLandmarksSubsetIdxs (146 2-D landmarks fed to the blendshape model)
BLENDSHAPE_SUBSET = np.array([
    0, 1, 4, 5, 6, 7, 8, 10, 13, 14, 17, 21, 33, 37,
    39, 40, 46, 52, 53, 54, 55, 58, 61, 63, 65, 66, 67, 70,
    78, 80, 81, 82, 84, 87, 88, 91, 93, 95, 103, 105, 107, 109,
    127, 132, 133, 136, 144, 145, 146, 148, 149, 150, 152, 153, 154, 155,
    157, 158, 159, 160, 161, 162, 163, 168, 172, 173, 176, 178, 181, 185,
    191, 195, 197, 234, 246, 249, 251, 263, 267, 269, 270, 276, 282, 283,
    284, 285, 288, 291, 293, 295, 296, 297, 300, 308, 310, 311, 312, 314,
    317, 318, 321, 323, 324, 332, 334, 336, 338, 356, 361, 362, 365, 373,
    374, 375, 377, 378, 379, 380, 381, 382, 384, 385, 386, 387, 388, 389,
    390, 397, 398, 400, 402, 405, 409, 415, 454, 466, 468, 469, 470, 471,
    472, 473, 474, 475, 476, 477], dtype=np.int32)

DETECTOR_MEMBER = "face_detector.tflite"
LANDMARKS_MEMBER = "face_landmarks_detector.tflite"
BLENDSHAPES_MEMBER = "face_blendshapes.tflite"
GEOMETRY_MEMBER = "geometry_pipeline_metadata_landmarks.binarypb"


# ---------- geometry metadata (protobuf wire format, no schema) ----------

def _varint(b: bytes, i: int) -> Tuple[int, int]:
    r, s = 0, 0
    while True:
        x = b[i]
        i += 1
        r |= (x & 0x7F) << s
        if not x & 0x80:
            return r, i
        s += 7


def _wire_fields(buf: bytes):
    i = 0
    while i < len(buf):
        tag, i = _varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
            yield fno, v
        elif wt == 2:
            ln, i = _varint(buf, i)
            yield fno, buf[i:i + ln]
            i += ln
        elif wt == 5:
            yield fno, struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wt == 1:
            yield fno, struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _packed_varints(buf: bytes) -> List[int]:
    out, i = [], 0
    while i < len(buf):
        v, i = _varint(buf, i)
        out.append(v)
    return out


def parse_geometry_metadata(buf: bytes):
    """GeometryPipelineMetadata -> (canonical [468, 5] xyzuv, tris [N, 3],
    Procrustes weights [468]). Field 1 is the canonical Mesh3d (vertex
    buffer field 3, index buffer field 4), field 2 each WeightedLandmarkRef
    (landmark_id 1, weight 2). Repeated fields are read unpacked or packed
    (a packed index buffer as the varints protobuf packs)."""
    verts: List[float] = []
    tris: List[int] = []
    wrefs: List[Tuple[int, float]] = []
    for fno, v in _wire_fields(buf):
        if fno == 1:  # Mesh3d
            for f2, v2 in _wire_fields(v):
                if f2 == 3:
                    if isinstance(v2, bytes):  # packed floats
                        verts.extend(struct.unpack(f"<{len(v2) // 4}f", v2))
                    else:
                        verts.append(float(v2))
                elif f2 == 4:
                    if isinstance(v2, bytes):
                        tris.extend(_packed_varints(v2))
                    else:
                        tris.append(int(v2))
        elif fno == 2:  # WeightedLandmarkRef
            lid, wgt = 0, 0.0
            for f2, v2 in _wire_fields(v):
                if f2 == 1:
                    lid = int(v2)
                elif f2 == 2:
                    wgt = float(v2)
            wrefs.append((lid, wgt))
    canonical = np.asarray(verts, np.float32).reshape(-1, 5)
    weights = np.zeros(len(canonical), np.float32)
    for lid, wgt in wrefs:
        weights[lid] = wgt
    return canonical, np.asarray(tris, np.int64).reshape(-1, 3), weights


# ---------- BlazeFace anchors (short-range config) ----------

def blaze_anchors() -> np.ndarray:
    """896 SSD anchor centres for the 128x128 short-range face detector
    (strides [8, 16, 16, 16], fixed anchor size, offset 0.5)."""
    anchors = []
    for stride, per_cell in ((8, 2), (16, 6)):
        g = 128 // stride
        for y in range(g):
            for x in range(g):
                cx, cy = (x + 0.5) / g, (y + 0.5) / g
                anchors.extend([(cx, cy)] * per_cell)
    return np.asarray(anchors, np.float32)  # [896, 2]


def decode_detections(raw_boxes: np.ndarray, raw_scores: np.ndarray,
                      anchors: np.ndarray, score_thresh: float = 0.5):
    """TensorsToDetections: [896, 16] + [896, 1] -> (boxes xyxy, 6 kps,
    scores), coordinates normalised to the 128-square input."""
    s = 1.0 / 128.0
    scores = 1.0 / (1.0 + np.exp(-np.clip(
        raw_scores[:, 0].astype(np.float64), -100, 100)))
    keep = scores >= score_thresh
    rb, a, scores = raw_boxes[keep], anchors[keep], scores[keep]
    cx, cy = rb[:, 0] * s + a[:, 0], rb[:, 1] * s + a[:, 1]
    w, h = rb[:, 2] * s, rb[:, 3] * s
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    kps = rb[:, 4:16].reshape(-1, 6, 2) * s + a[:, None, :]
    return boxes, kps, scores


def weighted_nms(boxes, kps, scores, iou_thresh: float = 0.3):
    """Mediapipe's WEIGHTED NMS: overlapping candidates blended, score-weighted."""
    order = np.argsort(-scores)
    out = []
    alive = np.ones(len(scores), bool)
    for i in order:
        if not alive[i]:
            continue
        ix1 = np.maximum(boxes[i, 0], boxes[:, 0])
        iy1 = np.maximum(boxes[i, 1], boxes[:, 1])
        ix2 = np.minimum(boxes[i, 2], boxes[:, 2])
        iy2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
        area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                + (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
                - inter)
        iou = np.where(area > 0, inter / np.maximum(area, 1e-12), 0.0)
        group = alive & (iou > iou_thresh)
        wsum = scores[group].sum()
        out.append((
            (boxes[group] * scores[group, None]).sum(0) / wsum,
            (kps[group] * scores[group, None, None]).sum(0) / wsum,
            scores[i]))
        alive &= ~group
    return out


# ---------- the detector ----------

@functools.lru_cache(maxsize=None)
def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of `jax.image.resize(..., "linear")` (antialias on):
    the triangle kernel, widened by in / out when downscaling, each row
    normalised; float32 arithmetic in JAX's order
    (jax/_src/image/scale.py::compute_weight_mat)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = weights.sum(0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).T.astype(f32)


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] float32 -> [out_h, out_w, C] as jax.image.resize's "linear"."""
    h, w = img.shape[:2]
    out = img
    if h != out_h:
        m = torch.from_numpy(linear_resize_matrix(h, out_h)).to(img.device)
        out = torch.einsum("oh,hwc->owc", m, out)
    if w != out_w:
        m = torch.from_numpy(linear_resize_matrix(w, out_w)).to(img.device)
        out = torch.einsum("ow,hwc->hoc", m, out)
    return out


@torch.no_grad()
def detect_face(detector: TFLiteModule, img01: np.ndarray):
    """BlazeFace short-range on one frame. img01 [H, W, 3] float in [0, 1]
    -> the best face (box xyxy, 6 kps, score) in image-normalised
    coordinates, or None. Standalone so the driving-video fit
    (preprocess/video_fit.py) uses it without the landmark models."""
    h, w = img01.shape[:2]
    size = max(h, w)
    pad_y, pad_x = (size - h) // 2, (size - w) // 2
    sq = np.zeros((size, size, 3), np.float32)
    sq[pad_y:pad_y + h, pad_x:pad_x + w] = img01
    dev = _device(detector)
    x = resize_linear(torch.from_numpy(sq).to(dev), 128, 128)
    x = x[None] * 2.0 - 1.0
    raw_box, raw_score = detector(x)
    boxes, kps, scores = decode_detections(
        raw_box[0].cpu().numpy(), raw_score[0].cpu().numpy(), blaze_anchors())
    if len(scores) == 0:
        return None
    dets = weighted_nms(boxes, kps, scores)
    box, kp, score = dets[0]

    def unpad(pts):  # letterbox square [0, 1] -> image-normalised [0, 1]
        pts = pts * size
        pts[..., 0] = (pts[..., 0] - pad_x) / w
        pts[..., 1] = (pts[..., 1] - pad_y) / h
        return pts
    return unpad(box.reshape(2, 2)).reshape(4), unpad(kp), score


def _device(module: torch.nn.Module) -> torch.device:
    return next(module.buffers()).device


def load_face_detector(path: str, device="cuda") -> TFLiteModule:
    """The BlazeFace module from a bare .tflite, a face_landmarker .task
    bundle or a graph saved with `save_npz`."""
    if path.endswith(".task"):
        graph = TFLiteGraph.from_task(path, DETECTOR_MEMBER)
    elif path.endswith(".npz"):
        graph = TFLiteGraph.load_npz(path)
    else:
        graph = TFLiteGraph.from_path(path)
    return compile_tflite(graph, device)


# ---------- the landmarker ----------

@dataclass(eq=False)
class FaceLandmarker:
    """LMKExtractor: `landmarker(img_rgb) -> dict or None`. Build it with
    `load_face_landmarker`."""

    detector: TFLiteModule
    landmarks: TFLiteModule
    blendshapes: TFLiteModule
    canonical: np.ndarray        # [468, 5] xyzuv (metric mesh)
    tris: np.ndarray             # [N, 3]
    proc_weights: np.ndarray     # [468]

    @staticmethod
    def _crop256(img: torch.Tensor, cx, cy, half, rot) -> torch.Tensor:
        """Rotated square crop (pixel coordinates) of img [H, W, 3] ->
        [1, 256, 256, 3]: bilinear taps from floor(s - 0.5), indices
        clamped to the image, fp32 as the JAX package samples."""
        h, w = img.shape[:2]
        dev, f32 = img.device, torch.float32
        cx, cy, half, rot = (torch.tensor(v, dtype=f32, device=dev)
                             for v in (cx, cy, half, rot))
        u = (torch.arange(256, dtype=f32, device=dev) + 0.5) / 256.0 * 2.0 - 1.0
        gy, gx = torch.meshgrid(u, u, indexing="ij")
        c, s = torch.cos(rot), torch.sin(rot)
        sx = cx + half * (gx * c - gy * s)
        sy = cy + half * (gx * s + gy * c)
        x0 = torch.floor(sx - 0.5)
        y0 = torch.floor(sy - 0.5)
        fx = (sx - 0.5 - x0)[..., None]
        fy = (sy - 0.5 - y0)[..., None]

        def tap(xi, yi):
            xi = xi.to(torch.int32).clamp(0, w - 1).long()
            yi = yi.to(torch.int32).clamp(0, h - 1).long()
            return img[yi, xi]
        v = (tap(x0, y0) * ((1 - fx) * (1 - fy))
             + tap(x0 + 1, y0) * (fx * (1 - fy))
             + tap(x0, y0 + 1) * ((1 - fx) * fy)
             + tap(x0 + 1, y0 + 1) * (fx * fy))
        return v[None]

    def _solve_pose(self, lmks: np.ndarray, aspect: float):
        """Normalised screen landmarks [478, 3] -> (trans_mat [4, 4], metric
        landmarks [468, 3], the canonical mesh's vertex count: the 10 iris
        points have no metric counterpart, mp_utils.py:82-84).

        Weak perspective, as the JAX package derives mediapipe's geometry
        pipeline: unproject to the near plane of the 63-degree vFOV camera,
        solve the weighted orthogonal Procrustes problem canonical ->
        runtime for (s, R, t) (the .task's weights), depth d = near / s.
        lmks3d = the runtime points in the canonical frame."""
        near = 1.0
        top = near * np.tan(np.radians(63.0 / 2))
        right = top * aspect
        n = len(self.canonical)
        x = (lmks[:n, 0] * 2 - 1) * right
        y = -(lmks[:n, 1] * 2 - 1) * top          # y up in metric space
        z = -lmks[:n, 2] * right                  # z toward the camera
        runtime = np.stack([x, y, z], -1)

        can = self.canonical[:, :3]
        wgt = self.proc_weights[:, None]
        wsum = self.proc_weights.sum()
        mu_r = (runtime * wgt).sum(0) / wsum
        mu_c = (can * wgt).sum(0) / wsum
        rc, cc = runtime - mu_r, can - mu_c
        cov = (rc * wgt).T @ cc
        U, S, Vt = np.linalg.svd(cov)
        d = np.sign(np.linalg.det(U @ Vt))
        D = np.diag([1.0, 1.0, d])
        R = U @ D @ Vt
        var_c = ((cc ** 2) * wgt).sum()
        scale = (S * np.diag(D)).sum() / max(var_c, 1e-12)
        t = mu_r - scale * R @ mu_c
        depth = near / max(scale, 1e-9)

        trans = np.eye(4, dtype=np.float32)
        trans[:3, :3] = R
        trans[:3, 3] = np.array([t[0] / scale, t[1] / scale, -depth], np.float32)
        metric = (runtime - t) @ R / scale        # R^-1 (runtime - t) / s
        return trans, metric.astype(np.float32)

    @torch.no_grad()
    def __call__(self, img_rgb: np.ndarray) -> Optional[dict]:
        """img_rgb uint8 / float [H, W, 3] -> the mp_utils.LMKExtractor dict
        (lmks [478, 3] image-normalised, lmks3d [468, 3] metric, trans_mat
        [4, 4], faces [N, 3] 1-based, bs [51]) or None if no face."""
        img01 = np.asarray(img_rgb, np.float32)
        if img01.max() > 2.0:
            img01 = img01 / 255.0
        h, w = img01.shape[:2]

        det = detect_face(self.detector, img01)
        if det is None:
            return None
        box, kp, _ = det
        # FaceDetectionsToRoi: eye-line rotation, 1.5x square-long box
        rot = float(np.arctan2(-(kp[1, 1] - kp[0, 1]) * h,
                               (kp[1, 0] - kp[0, 0]) * w))
        cx, cy = (box[0] + box[2]) / 2 * w, (box[1] + box[3]) / 2 * h
        side = max((box[2] - box[0]) * w, (box[3] - box[1]) * h)
        half = side * 1.5 / 2

        dev = _device(self.landmarks)
        crop = self._crop256(torch.from_numpy(img01).to(dev), float(cx), float(cy),
                             float(half), -rot)
        out = self.landmarks(crop)
        raw = out[0].cpu().numpy().reshape(478, 3) / 256.0
        presence = 1.0 / (1.0 + np.exp(-float(out[1].cpu().numpy().ravel()[0])))
        if presence < 0.5:
            return None

        c, s = np.cos(-rot), np.sin(-rot)
        lx, ly = raw[:, 0] * 2 - 1, raw[:, 1] * 2 - 1
        px = cx + half * (lx * c - ly * s)
        py = cy + half * (lx * s + ly * c)
        pz = raw[:, 2] * (2 * half) / w           # z scaled by the ROI width
        lmks = np.stack([px / w, py / h, pz], -1).astype(np.float32)

        sel = lmks[BLENDSHAPE_SUBSET][:, :2] * np.array([w, h], np.float32)
        bs = self.blendshapes(torch.from_numpy(sel).to(dev)[None])[0].cpu().numpy()

        trans_mat, metric = self._solve_pose(lmks, w / h)
        return {"lmks": lmks, "lmks3d": metric, "trans_mat": trans_mat,
                "faces": self.tris + 1, "bs": bs[1:].astype(np.float32)}


def load_face_landmarker(task_path: str, device="cuda") -> FaceLandmarker:
    """The landmarker from a mediapipe face_landmarker .task bundle (the
    reference ships one at aniportrait/src/utils/mp_models/)."""
    with zipfile.ZipFile(task_path) as z:
        graphs = [TFLiteGraph.from_bytes(z.read(m))
                  for m in (DETECTOR_MEMBER, LANDMARKS_MEMBER, BLENDSHAPES_MEMBER)]
        canonical, tris, wgt = parse_geometry_metadata(z.read(GEOMETRY_MEMBER))
    nets = [compile_tflite(g, device) for g in graphs]
    return FaceLandmarker(*nets, canonical, tris, wgt)
