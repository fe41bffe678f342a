"""BFM face rendering for the SadTalker `--face3dvis` video, in PyTorch.

Counterpart of mofa_tpu/models/audio/face3d_render.py (the reference
rasterises the Basel Face Model mesh with pytorch3d,
sadtalker_audio2pose/src/face3d/util/nvdiffrast.py:32-126, for the
`3dface.mp4` beside `landmarks.npy`):

- the shading (bfm.py:87-173: texture, per-vertex normals, second-order
  spherical-harmonics light) is numpy on the host, a copy of the JAX
  package's;
- `rasterize_mesh` is a z-buffer in stock PyTorch on the mesh's device:
  blocks of `face_chunk` faces, each block's edge functions evaluated
  over the P pixels of the block's screen box (the JAX version takes
  every pixel of the frame; a pixel outside the box is outside every face
  of the block, so the result is the same), the nearest hit kept. The
  edge functions, weights and colours are elementwise products and sums
  in a fixed order, not the JAX version's [P, 2] x [2, 3C] product, so
  every device rounds them alike (the CPU and the card draw the same
  pixels). The JAX version is jnp under jit (no Pallas kernel), so this
  is plain tensor code too.

Camera (facerecon_model.py:93): a vertex at camera coords (x, y, z) lands
at column focal * x / z + center and row size - (focal * y / z + center),
pixel centres at +0.5; colours are interpolated perspective-correct;
znear 5, zfar 15. pytorch3d's `rast_out > 0` mask quirk (face 0 counts as
background, nvdiffrast.py:110) is kept behind `mask_quirk`. Ties: within
a block the first face of least depth wins (argmin), across blocks an
earlier block's hit is kept unless a later one is strictly nearer.
"""

from __future__ import annotations

import numpy as np
import torch

from mofa_tpu_torch.models.audio.sadtalker import _rotation

# SH constants (bfm.py:19-23)
_SH_A = (np.pi, 2 * np.pi / np.sqrt(3.0), 2 * np.pi / np.sqrt(8.0))
_SH_C = (1 / np.sqrt(4 * np.pi), np.sqrt(3.0) / np.sqrt(4 * np.pi),
         3 * np.sqrt(5.0) / np.sqrt(12 * np.pi))
INIT_LIT = np.array([0.8, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)


def compute_texture(tex_base: np.ndarray, mean_tex: np.ndarray,
                    tex_coeff: np.ndarray, normalize: bool = True) -> np.ndarray:
    """bfm.py:103-116: [B, 80] tex coeffs -> [B, N, 3] RGB in (0, 1)."""
    tex = tex_coeff @ tex_base.T + mean_tex.reshape(1, -1)
    if normalize:
        tex = tex / 255.0
    return tex.reshape(len(tex_coeff), -1, 3)


def compute_norm(face_shape: np.ndarray, face_buf: np.ndarray,
                 point_buf: np.ndarray) -> np.ndarray:
    """bfm.py:118-139: per-vertex normals, the face normals (cross products
    of edges, a zero row appended) gathered through point_buf, each
    normalised."""
    v1 = face_shape[:, face_buf[:, 0]]
    v2 = face_shape[:, face_buf[:, 1]]
    v3 = face_shape[:, face_buf[:, 2]]
    face_norm = np.cross(v1 - v2, v2 - v3)
    face_norm = face_norm / np.maximum(
        np.linalg.norm(face_norm, axis=-1, keepdims=True), 1e-12)
    face_norm = np.concatenate(
        [face_norm, np.zeros((face_norm.shape[0], 1, 3), face_norm.dtype)], axis=1)
    vertex_norm = face_norm[:, point_buf].sum(axis=2)
    return vertex_norm / np.maximum(
        np.linalg.norm(vertex_norm, axis=-1, keepdims=True), 1e-12)


def compute_color(face_texture: np.ndarray, face_norm: np.ndarray,
                  gamma: np.ndarray) -> np.ndarray:
    """bfm.py:141-173: second-order spherical-harmonics light. face_texture
    [B, N, 3] in (0, 1), face_norm [B, N, 3] rotated, gamma [B, 27]."""
    a, c = _SH_A, _SH_C
    b = gamma.shape[0]
    gamma = gamma.reshape(b, 3, 9) + INIT_LIT.reshape(1, 1, 9)
    gamma = gamma.transpose(0, 2, 1)  # [B, 9, 3]
    n = face_norm
    ones = np.ones_like(n[..., :1])
    y = np.concatenate([
        a[0] * c[0] * ones,
        -a[1] * c[1] * n[..., 1:2],
        a[1] * c[1] * n[..., 2:],
        -a[1] * c[1] * n[..., :1],
        a[2] * c[2] * n[..., :1] * n[..., 1:2],
        -a[2] * c[2] * n[..., 1:2] * n[..., 2:],
        0.5 * a[2] * c[2] / np.sqrt(3.0) * (3 * n[..., 2:] ** 2 - 1),
        -a[2] * c[2] * n[..., :1] * n[..., 2:],
        0.5 * a[2] * c[2] * (n[..., :1] ** 2 - n[..., 1:2] ** 2),
    ], axis=-1)                       # [B, N, 9]
    return np.einsum("bnk,bkc->bnc", y, gamma) * face_texture


def compute_for_render(bfm, coeffs257: np.ndarray):
    """bfm.py:275-300: [B, 257] coeffs -> camera-space vertices [B, N, 3]
    and lit per-vertex colours [B, N, 3]; `bfm` is a `sadtalker.BFMModel`
    loaded with its render data."""
    idc, expc = coeffs257[:, :80], coeffs257[:, 80:144]
    texc, gamma = coeffs257[:, 144:224], coeffs257[:, 227:254]
    angles, trans = coeffs257[:, 224:227], coeffs257[:, 254:257]
    shape = (idc @ bfm.id_base.T + expc @ bfm.exp_base.T
             + bfm.mean_shape[None]).reshape(len(coeffs257), -1, 3)
    rot = _rotation(angles)
    verts = shape @ rot + trans[:, None]
    verts[..., -1] = bfm.camera_distance - verts[..., -1]
    tex = compute_texture(bfm.tex_base, bfm.mean_tex, texc)
    norm = compute_norm(shape, bfm.face_buf, bfm.point_buf)
    colors = compute_color(tex, np.einsum("bnd,bde->bne", norm, rot), gamma)
    return verts.astype(np.float32), colors.astype(np.float32)


@torch.no_grad()
def rasterize_mesh(verts: torch.Tensor, tri: torch.Tensor, colors: torch.Tensor, *,
                   size: int = 224, focal: float = 1015.0, center: float = 112.0,
                   znear: float = 5.0, zfar: float = 15.0, face_chunk: int = 512,
                   mask_quirk: bool = True):
    """Z-buffer rasterisation of one mesh, on the tensors' device.

    verts [N, 3] fp32 camera coords (y up, +z away), tri [M, 3] integer
    vertex ids, colors [N, 3] -> (image [size, size, 3], mask [size, size]).
    The faces are padded to whole blocks with degenerate ones (vertex 0
    thrice: zero area, never hit); a block's temporaries are [P, C, 3]
    fp32, P the pixels of its screen box (at most size^2)."""
    dev = verts.device
    n_faces = tri.shape[0]
    # a block never holds more faces than the mesh (the result does not
    # depend on the blocking: the earliest face of least depth wins)
    face_chunk = max(1, min(face_chunk, n_faces))
    n_pad = -n_faces % face_chunk
    tri = tri.long()
    if n_pad:
        tri = torch.cat([tri, tri.new_zeros(n_pad, 3)], dim=0)

    z = verts[:, 2]
    col = focal * verts[:, 0] / z + center
    row = size - (focal * verts[:, 1] / z + center)
    pts = torch.stack([col, row], dim=-1)                  # [N, 2] screen

    first_valid = 1 if mask_quirk else 0
    zbuf = torch.full((size * size,), float("inf"), device=dev)
    img = torch.zeros((size * size, 3), device=dev)
    hit = torch.zeros((size * size,), dtype=torch.bool, device=dev)
    # each block's screen box, in one transfer: a pixel whose centre lies
    # outside a face's box is never inside the face, so a block's edge
    # functions are evaluated only over its box's pixels, widened by one
    # pixel against the edge functions' rounding (the whole frame when a
    # vertex projects to a non-finite point)
    block_pts = pts[tri].reshape(-1, face_chunk * 3, 2)
    boxes = torch.cat([block_pts.amin(1), block_pts.amax(1)], 1).cpu().numpy()
    for bi, base in enumerate(range(0, tri.shape[0], face_chunk)):
        x0, y0, x1, y1 = boxes[bi]
        if np.isfinite(boxes[bi]).all():
            c0, c1 = (int(np.clip(v, 0, size)) for v in (np.floor(x0) - 1, np.ceil(x1) + 1))
            r0, r1 = (int(np.clip(v, 0, size)) for v in (np.floor(y0) - 1, np.ceil(y1) + 1))
        else:
            c0, c1, r0, r1 = 0, size, 0, size
        if c1 <= c0 or r1 <= r0:
            continue
        cols = torch.arange(c0, c1, device=dev)
        rows = torch.arange(r0, r1, device=dev)
        win_idx = (rows[:, None] * size + cols[None, :]).reshape(-1)
        pix = torch.stack([(win_idx % size).float() + 0.5,
                           (win_idx // size).float() + 0.5], dim=-1)   # [P, 2]
        p = pix.shape[0]
        pidx = torch.arange(p, device=dev)

        tb = tri[base:base + face_chunk]                   # [C, 3]
        v, vz, vc = pts[tb], z[tb], colors[tb]             # [C, 3, 2], [C, 3], [C, 3, 3]
        # edge function e_k(p) = cross(v_{k+1} - v_k, p - v_k), affine in p:
        # (-a_y) p_x + a_x p_y + (a_y v_x - a_x v_y)
        a = v[:, (1, 2, 0)] - v                            # [C, 3, 2] edge vectors
        wmat = torch.stack([-a[..., 1], a[..., 0]], dim=-1)          # [C, 3, 2]
        bias = a[..., 1] * v[..., 0] - a[..., 0] * v[..., 1]         # [C, 3]
        # elementwise (no matmul): each op rounds once, alike on every device
        e = (pix[:, 0, None, None] * wmat[None, ..., 0]
             + pix[:, 1, None, None] * wmat[None, ..., 1]) + bias[None]    # [P, C, 3]
        # signed 2 * area = cross(v1 - v0, v2 - v0) = cross(a0, -a2)
        area = a[:, 0, 0] * (-a[:, 2, 1]) - a[:, 0, 1] * (-a[:, 2, 0])   # [C]
        inside = torch.where(area[None] >= 0, (e >= 0).all(-1), (e <= 0).all(-1))
        inside &= area.abs()[None] > 1e-9                            # [P, C]
        # the weight of vertex j is the opposite edge's function e_{(j+1) % 3}
        safe_area = torch.where(area.abs() > 1e-9, area, torch.ones_like(area))
        bary = e[..., (1, 2, 0)] / safe_area[None, :, None]
        # perspective-correct attribute weights
        inv_z = 1.0 / vz                                             # [C, 3]
        bz = bary * inv_z[None]
        denom = bz[..., 0] + bz[..., 1] + bz[..., 2]                 # [P, C]
        zc = 1.0 / torch.where(denom != 0, denom, torch.ones_like(denom))
        inside &= (zc >= znear) & (zc <= zfar)
        face_ids = base + torch.arange(tb.shape[0], device=dev)
        inside &= ((face_ids >= first_valid) & (face_ids < n_faces))[None]

        zc = torch.where(inside, zc, torch.full_like(zc, float("inf")))
        best = torch.argmin(zc, dim=1)                               # [P]
        best_z = zc[pidx, best]
        win = best_z < zbuf[win_idx]
        wpc = bz[pidx, best] * best_z[:, None]                       # [P, 3]
        vb = vc[best]                                                # [P, 3, 3]
        color = wpc[:, 0, None] * vb[:, 0] + wpc[:, 1, None] * vb[:, 1] + wpc[:, 2, None] * vb[:, 2]
        img[win_idx] = torch.where(win[:, None], color, img[win_idx])
        zbuf[win_idx] = torch.where(win, best_z, zbuf[win_idx])
        hit[win_idx] |= win
    img = torch.where(hit[:, None], img, torch.zeros_like(img))
    return img.reshape(size, size, 3), hit.reshape(size, size)


def render_face_video(bfm, coeffs257: np.ndarray, size: int = 224,
                      face_chunk: int = 512, device="cpu") -> np.ndarray:
    """visualize.py:99-117: [B, 257] coeffs -> uint8 frames [B, H, W, 3]
    (RGB, black background), the reference's `pred_face` video; the
    rasteriser runs on `device`."""
    verts, colors = compute_for_render(bfm, coeffs257)
    tri = torch.from_numpy(bfm.face_buf.astype(np.int64)).to(device)
    frames = []
    for b in range(len(verts)):
        img, _ = rasterize_mesh(torch.from_numpy(verts[b]).to(device), tri,
                                torch.from_numpy(colors[b]).to(device), size=size,
                                face_chunk=face_chunk)
        frames.append(img.clamp(0.0, 1.0).cpu().numpy())
    return (np.stack(frames) * 255.0).astype(np.uint8)


def draw_landmark_video(landmarks: np.ndarray, height: int, width: int,
                        radius: int = 2) -> np.ndarray:
    """visualize.py:119-126: landmark dots on a white canvas (the index
    text overlay is dropped; the dots carry the same information)."""
    t = len(landmarks)
    frames = np.full((t, height, width, 3), 255, np.uint8)
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    dy, dx = np.nonzero((yy ** 2 + xx ** 2) <= radius ** 2)
    dy, dx = dy - radius, dx - radius
    for k in range(t):
        for x, y in landmarks[k]:
            cy, cx = int(round(float(y))), int(round(float(x)))
            ys = np.clip(cy + dy, 0, height - 1)
            xs = np.clip(cx + dx, 0, width - 1)
            frames[k, ys, xs] = (0, 255, 0)
    return frames
