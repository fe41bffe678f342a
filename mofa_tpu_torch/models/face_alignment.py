"""AWing FAN 98-point face alignment in PyTorch, and the 98 -> 68 mapping.

Counterpart of mofa_tpu/models/face_alignment.py (facexlib's
`awing_arch.py` and `alignment.landmark_98_to_68`, which the reference's
extract_kp_videos_safe.py:18-80 calls): four stacked hourglasses with
CoordConv and boundary channels, 98 + 1 heatmaps at a quarter of the
input's size. NCHW with facexlib's state-dict names
(`alignment_WFLW_4HG.pth` loads strict after
`models.weights.fan_state_dict`).

`get_landmarks` / `get_landmarks_batch` resize each crop to 256 with
cv2 (bilinear), feed BGR in [0, 1], decode the last module's heatmaps
(argmax, a quarter-pixel step toward the larger neighbour, +0.5) and scale
back to the crop's pixels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class ConvBlock(nn.Module):
    """Three BN-ReLU-conv stages concatenated (out/2, out/4, out/4), plus a
    BN-ReLU-1x1 shortcut where the width changes."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        o2, o4 = out_planes // 2, out_planes // 4
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = _conv3x3(in_planes, o2)
        self.bn2 = nn.BatchNorm2d(o2)
        self.conv2 = _conv3x3(o2, o4)
        self.bn3 = nn.BatchNorm2d(o4)
        self.conv3 = _conv3x3(o4, o4)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(
                nn.BatchNorm2d(in_planes), nn.ReLU(),
                nn.Conv2d(in_planes, out_planes, 1, bias=False))

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.cat([out1, out2, out3], dim=1) + residual


def add_coords(x, with_r: bool, boundary=None):
    """AddCoordsTh: the [-1, 1] row and column coordinates appended (and the
    radius, and the coordinates where the boundary heatmap exceeds 0.05).
    x [B, C, H, W]; boundary [B, 1, H, W]."""
    b, _, h, w = x.shape
    xx = (torch.arange(h, dtype=torch.float32, device=x.device) / (h - 1) * 2 - 1)
    xx = xx[None, None, :, None].expand(b, 1, h, w)
    yy = (torch.arange(w, dtype=torch.float32, device=x.device) / (w - 1) * 2 - 1)
    yy = yy[None, None, None, :].expand(b, 1, h, w)
    parts = [x, xx.to(x.dtype), yy.to(x.dtype)]
    if with_r:
        rr = torch.sqrt(xx ** 2 + yy ** 2)
        parts.append((rr / rr.max()).to(x.dtype))
    if boundary is not None:
        keep = boundary.clamp(0.0, 1.0) > 0.05
        parts.append(torch.where(keep, xx, torch.zeros_like(xx)).to(x.dtype))
        parts.append(torch.where(keep, yy, torch.zeros_like(yy)).to(x.dtype))
    return torch.cat(parts, dim=1)


class CoordConvTh(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, with_r: bool = True, with_boundary: bool = False,
                 first_one: bool = False):
        super().__init__()
        self.with_r, self.with_boundary = with_r, with_boundary
        cin = in_channels + 2 + int(with_r) + (2 if with_boundary and not first_one else 0)
        self.conv = nn.Conv2d(cin, out_channels, kernel_size, stride,
                              padding=kernel_size // 2)

    def forward(self, x, heatmap=None):
        boundary = (heatmap[:, -1:] if self.with_boundary and heatmap is not None
                    else None)
        ret = add_coords(x, self.with_r, boundary)
        return self.conv(ret), ret[:, -2:]


class HourGlass(nn.Module):
    def __init__(self, depth: int = 4, features: int = 256, first_one: bool = False):
        super().__init__()
        self.depth = depth
        self.coordconv = CoordConvTh(features, features, 1, with_r=True,
                                     with_boundary=True, first_one=first_one)
        for level in range(depth, 0, -1):
            self.add_module(f"b1_{level}", ConvBlock(features, features))
            self.add_module(f"b2_{level}", ConvBlock(features, features))
            if level == 1:
                self.add_module(f"b2_plus_{level}", ConvBlock(features, features))
            self.add_module(f"b3_{level}", ConvBlock(features, features))

    def _recurse(self, level: int, inp):
        up1 = self._modules[f"b1_{level}"](inp)
        low1 = self._modules[f"b2_{level}"](F.avg_pool2d(inp, 2, stride=2))
        if level > 1:
            low2 = self._recurse(level - 1, low1)
        else:
            low2 = self._modules[f"b2_plus_{level}"](low1)
        low3 = self._modules[f"b3_{level}"](low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x, heatmap=None):
        x, last_channel = self.coordconv(x, heatmap)
        return self._recurse(self.depth, x), last_channel


class FAN(nn.Module):
    """AWing FAN: [B, 3, H, W] BGR in [0, 1] -> the list of per-module
    (landmarks + 1)-channel heatmaps [B, L + 1, H / 4, W / 4]."""

    def __init__(self, num_modules: int = 4, num_landmarks: int = 98):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = CoordConvTh(3, 64, 7, stride=2, with_r=True, with_boundary=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256, first_one=i == 0))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", nn.BatchNorm2d(256))
            self.add_module(f"l{i}", nn.Conv2d(256, num_landmarks + 1, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(num_landmarks + 1, 256, 1))

    def forward(self, x):
        x, _ = self.conv1(x)
        x = F.relu(self.bn1(x))
        x = F.avg_pool2d(self.conv2(x), 2, stride=2)
        x = self.conv4(self.conv3(x))
        previous, tmp_out, outputs = x, None, []
        for i in range(self.num_modules):
            hg, _ = self._modules[f"m{i}"](previous, tmp_out)
            ll = self._modules[f"top_m_{i}"](hg)
            ll = F.relu(self._modules[f"bn_end{i}"](self._modules[f"conv_last{i}"](ll)))
            tmp_out = self._modules[f"l{i}"](ll)
            outputs.append(tmp_out)
            if i < self.num_modules - 1:
                previous = (previous + self._modules[f"bl{i}"](ll)
                            + self._modules[f"al{i}"](tmp_out))
        return outputs


def calculate_points(heatmaps: np.ndarray) -> np.ndarray:
    """Heatmaps [B, N, H, W] -> landmark coords [B, N, 2] (x, y) in heatmap
    pixels: argmax, a 0.25-pixel step by the gradient's sign, + 0.5
    (facexlib awing_arch.calculate_points)."""
    b, n, h, w = heatmaps.shape
    hw = h * w
    line = heatmaps.reshape(b * n, hw)
    idx = np.argmax(line, axis=1)
    preds = np.stack([idx % w, idx // w], axis=1).astype(np.float32)
    r = np.arange(b * n)
    x_up = line[r, np.clip(idx + 1, 0, hw - 1)]
    x_down = line[r, np.clip(idx - 1, 0, hw - 1)]
    y_up = line[r, np.clip(idx + w, 0, hw - 1)]
    y_down = line[r, np.clip(idx - w, 0, hw - 1)]
    preds += 0.25 * np.sign(np.stack([x_up - x_down, y_up - y_down], axis=1))
    preds += 0.5
    return preds.reshape(b, n, 2)


def landmark_98_to_68(lm98: np.ndarray) -> np.ndarray:
    """WFLW 98 points -> ibug 68 (facexlib alignment.landmark_98_to_68: the
    jaw's every second point, the eyebrows' two-row midpoints, the nose and
    mouth as they are, six of each eye's eight points)."""
    lm68 = np.zeros((68, 2), np.float32)
    for i in range(0, 33, 2):                      # jaw
        lm68[i // 2] = lm98[i]
    lm68[17] = lm98[33]                            # left eyebrow
    lm68[18] = (lm98[34] + lm98[41]) / 2
    lm68[19] = (lm98[35] + lm98[40]) / 2
    lm68[20] = (lm98[36] + lm98[39]) / 2
    lm68[21] = (lm98[37] + lm98[38]) / 2
    lm68[22] = (lm98[42] + lm98[50]) / 2           # right eyebrow
    lm68[23] = (lm98[43] + lm98[49]) / 2
    lm68[24] = (lm98[44] + lm98[48]) / 2
    lm68[25] = (lm98[45] + lm98[47]) / 2
    lm68[26] = lm98[46]
    lm68[27:36] = lm98[51:60]                      # nose
    for dst, src in zip(range(36, 42), (60, 61, 63, 64, 65, 67)):  # left eye
        lm68[dst] = lm98[src]
    for dst, src in zip(range(42, 48), (68, 69, 71, 72, 73, 75)):  # right eye
        lm68[dst] = lm98[src]
    lm68[48:68] = lm98[76:96]                      # mouth
    return lm68


@torch.no_grad()
def get_landmarks_batch(net: FAN, crops_rgb) -> np.ndarray:
    """The FAN over T face crops in one batch: each crop resized to 256
    (cv2), BGR in [0, 1]. Returns [T, 98, 2] in each crop's own pixels."""
    import cv2
    sizes = [c.shape[:2] for c in crops_rgb]
    inp = np.stack([cv2.resize(np.asarray(c), (256, 256))[..., ::-1].astype(np.float32)
                    / 255.0 for c in crops_rgb])
    dev = next(net.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(inp.transpose(0, 3, 1, 2))).to(dev)
    heat = net(x)[-1][:, :-1].float().cpu().numpy()      # the boundary map dropped
    pred = calculate_points(heat)
    for i, (h, w) in enumerate(sizes):
        pred[i, :, 0] *= w / 64.0
        pred[i, :, 1] *= h / 64.0
    return pred


def get_landmarks(net: FAN, img_rgb: np.ndarray) -> np.ndarray:
    """facexlib FAN.get_landmarks: one crop -> [98, 2] (x, y) in its pixels."""
    return get_landmarks_batch(net, [img_rgb])[0]
