"""Deep3DFaceRecon 3DMM fitting (SadTalker's CropAndExtract core) in PyTorch.

Counterpart of mofa_tpu/models/audio/face3d_fit.py (reference
sadtalker_audio2pose/src/face3d/models/networks.py:69-105 and
src/face3d/util/preprocess.py:17-135):

- `ReconNet` = ReconNetWrapper(resnet50, use_last_fc=False): a
  torchvision ResNet-50 backbone (`backbone.*`) and seven 1x1 coefficient
  heads (`final_layers.<i>.*`) -> the 257-d BFM coefficients; NCHW, the
  reference's state-dict names, so net_recon checkpoints load strict.
  `layers` / `width` shrink it for tests (the JAX tests' tiny net is
  (1, 1, 1, 1), 8);
- `pos_similarity`, `extract_5p`, `load_lm3d`, `align_img`: the POS
  least-squares fit of 5 landmarks to the standard 3-D face, then the
  bicubic resize and 224 crop, on uint8 arrays (Pillow's resize and crop
  reproduced by `preprocess/image.py`, zeros outside the image);
- `fit_image`: image + 68 keypoints -> (full_3dmm [1, 257], coeff_3dmm
  [1, 76], trans_params [8]), the `--coeff_npz` contract.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.models.cmp.model import Bottleneck
from mofa_tpu_torch.preprocess.image import BICUBIC, pil_crop, pil_resize

# final_layers widths (networks.py:84-92): id / exp / tex / angle / gamma /
# (tx, ty) / tz, concatenated to the 257-d BFM coefficient vector
HEAD_DIMS = (80, 64, 80, 3, 27, 2, 1)
TINY_RECON = dict(layers=(1, 1, 1, 1), width=8)


class ResNetBackbone(nn.Module):
    """torchvision's ResNet with Bottleneck blocks, without its fc:
    [B, 3, H, W] -> [B, 32 * width, 1, 1] (the mean pool)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        cin = width
        for li, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
            planes = width * 2 ** li
            stage = [Bottleneck(cin, planes, stride=stride, downsample=True)]
            stage += [Bottleneck(planes * 4, planes) for _ in range(blocks - 1)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*stage))
            cin = planes * 4

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return x.mean(dim=(2, 3), keepdim=True)


class ReconNet(nn.Module):
    """ReconNetWrapper: [B, 3, 224, 224] in (0, 1) -> [B, 257]."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.backbone = ResNetBackbone(layers, width)
        self.final_layers = nn.ModuleList(nn.Conv2d(width * 32, d, 1) for d in HEAD_DIMS)

    def forward(self, x):
        x = self.backbone(x)
        return torch.cat([head(x) for head in self.final_layers], dim=1).flatten(1)


# ---------------------------------------------------------------- align

def pos_similarity(xp: np.ndarray, x: np.ndarray):
    """preprocess.py:17-38 POS: the least-squares (t, s) mapping the
    standard 3-D landmarks x [3, N] onto image points xp [2, N]."""
    npts = xp.shape[1]
    a = np.zeros([2 * npts, 8])
    a[0:2 * npts - 1:2, 0:3] = x.transpose()
    a[0:2 * npts - 1:2, 3] = 1
    a[1:2 * npts:2, 4:7] = x.transpose()
    a[1:2 * npts:2, 7] = 1
    b = np.reshape(xp.transpose(), [2 * npts, 1])
    k, _, _, _ = np.linalg.lstsq(a, b, rcond=None)
    r1, r2 = k[0:3], k[4:7]
    s = (np.linalg.norm(r1) + np.linalg.norm(r2)) / 2
    t = np.stack([k[3], k[7]], axis=0)
    return t, s


def extract_5p(lm: np.ndarray) -> np.ndarray:
    """preprocess.py:96-102: 68 -> 5 canonical points."""
    idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    p = np.stack([lm[idx[0]], np.mean(lm[idx[[1, 2]]], 0),
                  np.mean(lm[idx[[3, 4]]], 0), lm[idx[5]], lm[idx[6]]], axis=0)
    return p[[1, 2, 0, 3, 4]]


def load_lm3d(mat_path: str) -> np.ndarray:
    """load_mats.py:105-116: the standard 5 landmarks of
    similarity_Lm3D_all.mat."""
    from scipy.io import loadmat
    return extract_5p(loadmat(mat_path)["lm"])


def align_img(img: np.ndarray, lm: np.ndarray, lm3d_std: np.ndarray,
              target_size: float = 224.0, rescale_factor: float = 102.0):
    """preprocess.py:105-135: (trans_params [8] object array, img224 uint8
    [224, 224, 3], lm_new). `img` is uint8 [H, W, 3]; `lm` is [68, 2] with
    y UP (the caller flips, preprocess.py:147). Pillow's bicubic resize,
    then the crop (zeros outside the image)."""
    h0, w0 = img.shape[:2]
    lm5p = extract_5p(lm) if lm.shape[0] != 5 else lm
    t, s = pos_similarity(lm5p.transpose(), lm3d_std.transpose())
    s = rescale_factor / s

    w = (w0 * s).astype(np.int32)
    h = (h0 * s).astype(np.int32)
    left = np.round(w / 2 - target_size / 2
                    + ((t[0] - w0 / 2) * s).item()).astype(np.int32)
    up = np.round(h / 2 - target_size / 2
                  + ((h0 / 2 - t[1]) * s).item()).astype(np.int32)
    img_new = pil_resize(img, (int(w), int(h)), BICUBIC)
    img_new = pil_crop(img_new, (int(left), int(up), int(left + target_size),
                                 int(up + target_size)))
    lm_new = np.stack([lm[:, 0] - t[0] + w0 / 2,
                       lm[:, 1] - t[1] + h0 / 2], axis=1) * s
    lm_new = lm_new - np.array([[w / 2 - target_size / 2, h / 2 - target_size / 2]])
    trans_params = np.array([w0, h0, s, t[0], t[1], left, up, target_size],
                            dtype=object)
    return trans_params, img_new, lm_new


@torch.no_grad()
def fit_image(recon: ReconNet, img: np.ndarray, lm68_ydown: np.ndarray,
              lm3d_std: np.ndarray):
    """CropAndExtract.generate's inner loop (utils/preprocess.py:135-168):
    uint8 [H, W, 3] image + 68 keypoints (y down) -> (full_3dmm [1, 257],
    coeff_3dmm [1, 76] (exp, angle, trans, trans_params[2:]),
    trans_params [8]); the net runs on its own device."""
    h = img.shape[0]
    lm = lm68_ydown.astype(np.float32).copy()
    lm[:, -1] = h - 1 - lm[:, -1]
    trans_params, im224, _ = align_img(img, lm, lm3d_std)
    dev = next(recon.parameters()).device
    x = torch.from_numpy(im224.astype(np.float32) / 255.0).permute(2, 0, 1)[None]
    full = recon(x.to(dev)).cpu().numpy()                # [1, 257]
    tp = np.array([float(np.asarray(v).reshape(-1)[0]) for v in trans_params],
                  np.float32)
    coeff = np.concatenate([full[:, 80:144], full[:, 224:227],
                            full[:, 254:257], tp[None, 2:]], axis=1)
    return full, coeff, tp
