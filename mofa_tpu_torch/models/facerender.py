"""SadTalker's facerender (facevid2vid) in PyTorch: coefficients -> talking-head video.

Counterpart of mofa_tpu/models/facerender.py (the reference's
sadtalker_audio2pose/src/facerender/modules/: keypoint_detector.py,
mapping.py, dense_motion.py, generator.py, make_animation.py). NCHW /
NCDHW, the reference's module names, so the checkpoint's state dict loads
strict once spectral norm is folded:

- `KPDetector` (keypoint_detector.py:10-83): anti-aliased 1/4 downscale,
  a 2-D hourglass encoder reshaped into 3-D, the 3-D decoder, a softmax
  heatmap per keypoint -> canonical 3-D keypoints [B, K, 3];
- `HEEstimator` (:86-180): ResNet bottlenecks -> head-pose bins,
  translation and expression offsets (the reference's quirk kept: its
  `fc_roll` head feeds "yaw" and `fc_yaw` feeds "roll");
- `MappingNet` (mapping.py:8-47): a window of 3DMM coefficients -> the
  same pose / expression dict;
- `DenseMotionNetwork` (dense_motion.py:9-121): sparse motions from the
  keypoints, the compressed feature warped by each (`F.grid_sample` on
  5-D input: trilinear, zero padding, align_corners=False), gaussian
  heatmaps, a 3-D hourglass -> the dense deformation and the occlusion
  map;
- `OcclusionAwareSPADEGenerator` (generator.py:163-254), the renderer
  `AnimateFromCoeff` uses (full widths: `FaceRenderConfig`), and
  `OcclusionAwareGenerator` (:8-118), the plain decoder of the `--tiny`
  route; both share `_Trunk` (encoder, 3-D resblocks, dense motion,
  deform);
- `kp2gaussian`, `keypoint_transformation` (make_animation.py:66-98),
  `build_semantics` (generate_facerender_batch.py:8-110);
- `make_animation` (make_animation.py:101-139): the keypoints and the
  source pose once, then a loop over the frames under `torch.no_grad()`
  (the JAX package scans them; batching frames is later work);
- BatchNorm runs on its stored statistics (eval mode);
- `facerender_state_dicts`: SadTalker_V0.0.2_256.safetensors (or a .pth)
  -> the four nets' state dicts by prefix (`generator.`, `kp_extractor.`,
  `mapping.`, `he_estimator.`): spectral-norm triplets folded to W / sigma
  (sigma = u W v with the stored power-iteration vectors, in numpy as
  mofa_tpu's `_fold_spectral_norm` computes it), the BatchNorm counters,
  the fixed anti-alias `down.weight` and `.sigma` entries dropped
  (`apps/facerender_app.py::load_facerender` loads them, strict).

Channel counts follow the JAX package's modules (inferred from the
inputs), which equal the reference's at the full configuration.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


# ---------------------------------------------------------------- utilities

def make_coordinate_grid_3d(d: int, h: int, w: int, device=None, dtype=torch.float32):
    """util.py:53-70: the identity grid in [-1, 1], [D, H, W, 3] as (x, y, z)."""
    ar = lambda n: 2 * (torch.arange(n, dtype=dtype, device=device) / (n - 1)) - 1
    zz, yy, xx = torch.meshgrid(ar(d), ar(h), ar(w), indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """vol [B, C, D, H, W], grid [B, Do, Ho, Wo, 3] (x, y, z in [-1, 1]) ->
    [B, C, Do, Ho, Wo]: trilinear, zero padding, align_corners=False."""
    return F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def kp2gaussian(kp: torch.Tensor, spatial_size, kp_variance: float) -> torch.Tensor:
    """util.py:12-32: [B, K, 3] keypoints -> [B, K, D, H, W] gaussians."""
    d, h, w = spatial_size
    grid = make_coordinate_grid_3d(d, h, w, kp.device, kp.dtype)
    diff = grid[None, None] - kp[:, :, None, None, None, :]
    return torch.exp(-0.5 * diff.square().sum(-1) / kp_variance)


def _bn(c, three_d=False):
    return nn.BatchNorm3d(c) if three_d else nn.BatchNorm2d(c)


# ---------------------------------------------------------------- blocks

class DownBlock2d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.avg_pool2d(F.relu(self.norm(self.conv(x))), 2)


class UpBlock2d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm = nn.BatchNorm2d(cout)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return F.relu(self.norm(self.conv(x)))


class UpBlock3d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 3, padding=1)
        self.norm = nn.BatchNorm3d(cout)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
        return F.relu(self.norm(self.conv(x)))


class DownBlock3d(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, 3, padding=1)
        self.norm = nn.BatchNorm3d(cout)

    def forward(self, x):
        return F.avg_pool3d(F.relu(self.norm(self.conv(x))), (1, 2, 2))


class SameBlock2d(nn.Module):
    def __init__(self, cin, cout, kernel=3, lrelu=False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2)
        self.norm = nn.BatchNorm2d(cout)
        self.lrelu = lrelu

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.leaky_relu(x, 0.01) if self.lrelu else F.relu(x)


class ResBlock(nn.Module):
    """util.py ResBlock2d / ResBlock3d: norm-relu-conv twice, plus x."""

    def __init__(self, c, three_d=False):
        super().__init__()
        conv = nn.Conv3d if three_d else nn.Conv2d
        self.norm1, self.conv1 = _bn(c, three_d), conv(c, c, 3, padding=1)
        self.norm2, self.conv2 = _bn(c, three_d), conv(c, c, 3, padding=1)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return x + self.conv2(F.relu(self.norm2(h)))


class ResBottleneck(nn.Module):
    def __init__(self, c, stride=1):
        super().__init__()
        self.conv1, self.norm1 = nn.Conv2d(c, c // 4, 1), nn.BatchNorm2d(c // 4)
        self.conv2 = nn.Conv2d(c // 4, c // 4, 3, stride=stride, padding=1)
        self.norm2 = nn.BatchNorm2d(c // 4)
        self.conv3, self.norm3 = nn.Conv2d(c // 4, c, 1), nn.BatchNorm2d(c)
        self.stride = stride
        if stride != 1:
            self.skip, self.norm4 = nn.Conv2d(c, c, 1, stride=stride), nn.BatchNorm2d(c)

    def forward(self, x):
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        h = self.norm3(self.conv3(h))
        if self.stride != 1:
            x = self.norm4(self.skip(x))
        return F.relu(h + x)


class _Encoder3d(nn.Module):
    def __init__(self, cin, be, num_blocks, max_features):
        super().__init__()
        self.down_blocks = nn.ModuleList()
        for i in range(num_blocks):
            cout = min(max_features, be * 2 ** (i + 1))
            self.down_blocks.append(DownBlock3d(cin, cout))
            cin = cout


class _Decoder3d(nn.Module):
    def __init__(self, cin, be, num_blocks, max_features):
        super().__init__()
        skips = [cin] + [min(max_features, be * 2 ** (i + 1)) for i in range(num_blocks)]
        self.up_blocks = nn.ModuleList()
        c = skips[-1]
        for i in reversed(range(num_blocks)):
            cout = min(max_features, be * 2 ** i)
            self.up_blocks.append(UpBlock3d(c, cout))
            c = cout + skips[i]
        self.conv = nn.Conv3d(c, c, 3, padding=1)
        self.norm = nn.BatchNorm3d(c)
        self.out_filters = c


class Hourglass3d(nn.Module):
    """util.py Hourglass over [B, C, D, H, W] (pools and upsamples H, W)."""

    def __init__(self, cin, be, num_blocks, max_features):
        super().__init__()
        self.encoder = _Encoder3d(cin, be, num_blocks, max_features)
        self.decoder = _Decoder3d(cin, be, num_blocks, max_features)
        self.out_filters = self.decoder.out_filters

    def forward(self, x):
        outs = [x]
        for down in self.encoder.down_blocks:
            outs.append(down(outs[-1]))
        out = outs.pop()
        for up in self.decoder.up_blocks:
            out = torch.cat([up(out), outs.pop()], dim=1)
        return F.relu(self.decoder.norm(self.decoder.conv(out)))


class AntiAliasInterpolation2d(nn.Module):
    """util.py AntiAliasInterpolation2d: a gaussian blur (sigma = (1/s - 1)
    / 2, 2 round(4 sigma) + 1 taps) and a strided pick. Its kernel is
    fixed (a non-persistent buffer, the checkpoint's `down.weight`
    dropped)."""

    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.scale = scale
        sigma = (1 / scale - 1) / 2
        ks = 2 * round(sigma * 4) + 1
        g = np.arange(ks, dtype=np.float32)
        g = np.exp(-((g - (ks - 1) / 2) ** 2) / (2 * sigma ** 2))
        k2 = np.outer(g, g)
        k2 /= k2.sum()
        self.ka = ks // 2
        self.kb = self.ka - 1 if ks % 2 == 0 else self.ka
        self.register_buffer("weight", torch.tensor(np.ascontiguousarray(
            np.broadcast_to(k2, (channels, 1, ks, ks)))), persistent=False)

    def forward(self, x):
        x = F.pad(x, (self.ka, self.kb, self.ka, self.kb))
        out = F.conv2d(x, self.weight, groups=x.shape[1])
        step = int(1 / self.scale)
        return out[:, :, ::step, ::step]


# ---------------------------------------------------------------- models

@dataclasses.dataclass(frozen=True)
class FaceRenderConfig:
    """facerender.yaml's model_params (common / kp / he / generator / mapping)."""
    num_kp: int = 15
    image_channel: int = 3
    feature_channel: int = 32
    # kp_detector
    kp_block_expansion: int = 32
    kp_max_features: int = 1024
    kp_scale_factor: float = 0.25
    kp_num_blocks: int = 5
    kp_reshape_channel: int = 16384
    kp_reshape_depth: int = 16
    temperature: float = 0.1
    # he_estimator
    he_block_expansion: int = 64
    num_bins: int = 66
    # generator
    gen_block_expansion: int = 64
    gen_max_features: int = 512
    num_down_blocks: int = 2
    reshape_channel: int = 32
    reshape_depth: int = 16
    num_resblocks: int = 6
    # dense motion
    dm_block_expansion: int = 32
    dm_max_features: int = 1024
    dm_num_blocks: int = 5
    dm_compress: int = 4
    # mapping
    coeff_nc: int = 70
    descriptor_nc: int = 1024
    mapping_layers: int = 3


TINY_FACERENDER_CONFIG = FaceRenderConfig(
    num_kp=5, feature_channel=4, kp_block_expansion=8, kp_max_features=32,
    kp_num_blocks=2, kp_reshape_channel=32, kp_reshape_depth=4,
    he_block_expansion=8, num_bins=66, gen_block_expansion=8,
    gen_max_features=16, num_down_blocks=2, reshape_channel=4,
    reshape_depth=4, num_resblocks=1, dm_block_expansion=8,
    dm_max_features=16, dm_num_blocks=2, dm_compress=2,
    coeff_nc=70, descriptor_nc=32, mapping_layers=3)


class _KPHourglass(nn.Module):
    def __init__(self, cfg: FaceRenderConfig):
        super().__init__()
        be, mx, n = cfg.kp_block_expansion, cfg.kp_max_features, cfg.kp_num_blocks
        self.down_blocks = nn.Module()
        cin = cfg.image_channel
        for i in range(n):
            cout = min(mx, be * 2 ** (i + 1))
            self.down_blocks.add_module(f"down{i}", DownBlock2d(cin, cout))
            cin = cout
        self.conv = nn.Conv2d(cin, cfg.kp_reshape_channel, 1)
        self.up_blocks = nn.Module()
        cin = cfg.kp_reshape_channel // cfg.kp_reshape_depth
        for i in range(n):
            cout = min(mx, be * 2 ** (n - i - 1))
            self.up_blocks.add_module(f"up{i}", UpBlock3d(cin, cout))
            cin = cout
        self.out_filters = cin
        self.n, self.depth = n, cfg.kp_reshape_depth

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self.down_blocks, f"down{i}")(x)
        x = self.conv(x)
        b, c, h, w = x.shape
        x = x.view(b, c // self.depth, self.depth, h, w)
        for i in range(self.n):
            x = getattr(self.up_blocks, f"up{i}")(x)
        return x


class KPDetector(nn.Module):
    """keypoint_detector.py:10-83: image [B, 3, H, W] in [0, 1] -> the
    canonical keypoints [B, K, 3]."""

    def __init__(self, cfg: FaceRenderConfig = FaceRenderConfig()):
        super().__init__()
        self.cfg = cfg
        self.predictor = _KPHourglass(cfg)
        self.kp = nn.Conv3d(self.predictor.out_filters, cfg.num_kp, 3, padding=1)
        self.down = AntiAliasInterpolation2d(cfg.image_channel, cfg.kp_scale_factor)

    def forward(self, image):
        x = self.down(image) if self.cfg.kp_scale_factor != 1 else image
        pred = self.kp(self.predictor(x))                # [B, K, D, H, W]
        b, k, d, h, w = pred.shape
        heat = F.softmax(pred.reshape(b, k, -1).float() / self.cfg.temperature, dim=2)
        heat = heat.reshape(b, k, d, h, w)
        grid = make_coordinate_grid_3d(d, h, w, pred.device)
        return (heat[..., None] * grid[None, None]).sum(dim=(2, 3, 4)).to(image.dtype)


class HEEstimator(nn.Module):
    """keypoint_detector.py:86-180: image -> head-pose bins, t, exp."""

    def __init__(self, cfg: FaceRenderConfig = FaceRenderConfig()):
        super().__init__()
        be = cfg.he_block_expansion
        self.conv1 = nn.Conv2d(cfg.image_channel, be, 7, stride=2, padding=3)
        self.norm1 = nn.BatchNorm2d(be)
        self.conv2, self.norm2 = nn.Conv2d(be, 256, 1), nn.BatchNorm2d(256)
        self.block1 = nn.Sequential()
        for i in range(3):
            self.block1.add_module(f"b1_{i}", ResBottleneck(256))
        self.conv3, self.norm3 = nn.Conv2d(256, 512, 1), nn.BatchNorm2d(512)
        self.block2 = ResBottleneck(512, stride=2)
        self.block3 = nn.Sequential()
        for i in range(3):
            self.block3.add_module(f"b3_{i}", ResBottleneck(512))
        self.conv4, self.norm4 = nn.Conv2d(512, 1024, 1), nn.BatchNorm2d(1024)
        self.block4 = ResBottleneck(1024, stride=2)
        self.block5 = nn.Sequential()
        for i in range(5):
            self.block5.add_module(f"b5_{i}", ResBottleneck(1024))
        self.conv5, self.norm5 = nn.Conv2d(1024, 2048, 1), nn.BatchNorm2d(2048)
        self.block6 = ResBottleneck(2048, stride=2)
        self.block7 = nn.Sequential()
        for i in range(2):
            self.block7.add_module(f"b7_{i}", ResBottleneck(2048))
        self.fc_roll = nn.Linear(2048, cfg.num_bins)
        self.fc_pitch = nn.Linear(2048, cfg.num_bins)
        self.fc_yaw = nn.Linear(2048, cfg.num_bins)
        self.fc_t = nn.Linear(2048, 3)
        self.fc_exp = nn.Linear(2048, 3 * cfg.num_kp)

    def forward(self, image):
        x = F.relu(self.norm1(self.conv1(image)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = F.relu(self.norm2(self.conv2(x)))
        x = self.block1(x)
        x = F.relu(self.norm3(self.conv3(x)))
        x = self.block3(self.block2(x))
        x = F.relu(self.norm4(self.conv4(x)))
        x = self.block5(self.block4(x))
        x = F.relu(self.norm5(self.conv5(x)))
        x = self.block7(self.block6(x)).mean(dim=(2, 3))
        # the reference's quirk: fc_roll feeds 'yaw' and fc_yaw 'roll'
        return {"yaw": self.fc_roll(x), "pitch": self.fc_pitch(x), "roll": self.fc_yaw(x),
                "t": self.fc_t(x), "exp": self.fc_exp(x)}


class MappingNet(nn.Module):
    """mapping.py:8-47: a coefficient window [B, coeff_nc, T] -> pose dict."""

    def __init__(self, cfg: FaceRenderConfig = FaceRenderConfig()):
        super().__init__()
        nc = cfg.descriptor_nc
        self.first = nn.Sequential(nn.Conv1d(cfg.coeff_nc, nc, 7))
        self.layers = cfg.mapping_layers
        for i in range(cfg.mapping_layers):
            setattr(self, f"encoder{i}", nn.Sequential(
                nn.LeakyReLU(0.1), nn.Conv1d(nc, nc, 3, dilation=3)))
        self.fc_roll = nn.Linear(nc, cfg.num_bins)
        self.fc_pitch = nn.Linear(nc, cfg.num_bins)
        self.fc_yaw = nn.Linear(nc, cfg.num_bins)
        self.fc_t = nn.Linear(nc, 3)
        self.fc_exp = nn.Linear(nc, 3 * cfg.num_kp)

    def forward(self, x):
        out = self.first(x)
        for i in range(self.layers):
            out = getattr(self, f"encoder{i}")(out) + out[:, :, 3:-3]
        out = out.mean(dim=2)                             # AdaptiveAvgPool1d(1)
        return {"yaw": self.fc_yaw(out), "pitch": self.fc_pitch(out),
                "roll": self.fc_roll(out), "t": self.fc_t(out), "exp": self.fc_exp(out)}


class DenseMotionNetwork(nn.Module):
    """dense_motion.py:9-121 over [B, C, D, H, W] features."""

    def __init__(self, cfg: FaceRenderConfig):
        super().__init__()
        k = cfg.num_kp
        self.num_kp = k
        self.compress = nn.Conv3d(cfg.feature_channel, cfg.dm_compress, 1)
        self.norm = nn.BatchNorm3d(cfg.dm_compress)
        self.hourglass = Hourglass3d((k + 1) * (cfg.dm_compress + 1), cfg.dm_block_expansion,
                                     cfg.dm_num_blocks, cfg.dm_max_features)
        c = self.hourglass.out_filters
        self.mask = nn.Conv3d(c, k + 1, 7, padding=3)
        self.occlusion = nn.Conv2d(c * cfg.reshape_depth, 1, 7, padding=3)

    def forward(self, feature, kp_driving, kp_source):
        b, _, d, h, w = feature.shape
        k = self.num_kp
        feat = F.relu(self.norm(self.compress(feature)))
        c = feat.shape[1]
        # sparse motions (dense_motion.py:34-57)
        identity = make_coordinate_grid_3d(d, h, w, feature.device, torch.float32)
        coord = identity[None, None] - kp_driving[:, :, None, None, None, :]
        driving_to_source = coord + kp_source[:, :, None, None, None, :]
        sparse = torch.cat([identity[None, None].expand(b, 1, d, h, w, 3),
                            driving_to_source], dim=1)    # [B, K+1, D, H, W, 3]
        # deformed features (dense_motion.py:59-66)
        rep = feat[:, None].expand(b, k + 1, c, d, h, w).reshape(b * (k + 1), c, d, h, w)
        deformed = grid_sample_3d(rep, sparse.reshape(b * (k + 1), d, h, w, 3))
        deformed = deformed.view(b, k + 1, c, d, h, w)
        # heatmaps (dense_motion.py:68-79)
        heat = (kp2gaussian(kp_driving, (d, h, w), 0.01)
                - kp2gaussian(kp_source, (d, h, w), 0.01))
        heat = torch.cat([torch.zeros_like(heat[:, :1]), heat], dim=1)[:, :, None]
        inp = torch.cat([heat, deformed], dim=2).view(b, -1, d, h, w)
        pred = self.hourglass(inp)
        mask = F.softmax(self.mask(pred).float(), dim=1)
        mask = torch.where(mask < 1e-3, torch.zeros_like(mask), mask)    # :110
        deformation = (sparse.permute(0, 1, 5, 2, 3, 4) * mask[:, :, None]).sum(dim=1)
        occ = torch.sigmoid(self.occlusion(pred.reshape(b, -1, h, w)).float())
        return {"mask": mask, "deformation": deformation.permute(0, 2, 3, 4, 1).to(feature.dtype),
                "occlusion_map": occ}


class SPADE(nn.Module):
    """util.py:446-466: a parameter-free instance norm modulated by the
    segmentation feature (resized nearest)."""

    def __init__(self, norm_nc, label_nc, nhidden=128):
        super().__init__()
        self.mlp_shared = nn.Sequential(nn.Conv2d(label_nc, nhidden, 3, padding=1), nn.ReLU())
        self.mlp_gamma = nn.Conv2d(nhidden, norm_nc, 3, padding=1)
        self.mlp_beta = nn.Conv2d(nhidden, norm_nc, 3, padding=1)

    def forward(self, x, seg):
        normalized = F.instance_norm(x, eps=1e-5)
        if seg.shape[2:] != x.shape[2:]:
            seg = F.interpolate(seg, size=x.shape[2:], mode="nearest")
        actv = self.mlp_shared(seg)
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin, fout, label_nc):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = nn.Conv2d(fin, fmiddle, 3, padding=1)
        self.conv_1 = nn.Conv2d(fmiddle, fout, 3, padding=1)
        self.norm_0 = SPADE(fin, label_nc)
        self.norm_1 = SPADE(fmiddle, label_nc)
        if self.learned_shortcut:
            self.conv_s = nn.Conv2d(fin, fout, 1, bias=False)
            self.norm_s = SPADE(fin, label_nc)

    def forward(self, x, seg):
        xs = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, seg), 0.2))
        dx = self.conv_1(F.leaky_relu(self.norm_1(dx, seg), 0.2))
        return xs + dx


class SPADEDecoder(nn.Module):
    """generator.py:121-160: fc to 512, six 512 SPADE blocks, two 2x
    nearest upsamples with SPADE blocks to 256 and 64, conv to RGB."""

    def __init__(self, cin):
        super().__init__()
        self.fc = nn.Conv2d(cin, 512, 3, padding=1)
        for i in range(6):
            setattr(self, f"G_middle_{i}", SPADEResnetBlock(512, 512, cin))
        self.up_0 = SPADEResnetBlock(512, 256, cin)
        self.up_1 = SPADEResnetBlock(256, 64, cin)
        self.conv_img = nn.Conv2d(64, 3, 3, padding=1)

    def forward(self, feature):
        seg = feature
        x = self.fc(feature)
        for i in range(6):
            x = getattr(self, f"G_middle_{i}")(x, seg)
        x = self.up_0(F.interpolate(x, scale_factor=2, mode="nearest"), seg)
        x = self.up_1(F.interpolate(x, scale_factor=2, mode="nearest"), seg)
        x = self.conv_img(F.leaky_relu(x, 0.2))
        return torch.sigmoid(x.float())


class _Trunk(nn.Module):
    """The shared encoder + dense motion + deform of both generators
    (generator.py:72-110 / :215-245); its modules sit at the generator's
    top level, as in the reference."""

    def __init__(self, cfg: FaceRenderConfig, first_kernel: int):
        super().__init__()
        be, mx = cfg.gen_block_expansion, cfg.gen_max_features
        self.cfg = cfg
        self.first = SameBlock2d(cfg.image_channel, be, kernel=first_kernel)
        self.down_blocks = nn.ModuleList()
        cin = be
        for i in range(cfg.num_down_blocks):
            cout = min(mx, be * 2 ** (i + 1))
            self.down_blocks.append(DownBlock2d(cin, cout))
            cin = cout
        self.second = nn.Conv2d(cin, mx, 1)
        self.resblocks_3d = nn.Sequential()
        for i in range(cfg.num_resblocks):
            self.resblocks_3d.add_module(f"3dr{i}", ResBlock(cfg.reshape_channel, three_d=True))
        self.dense_motion_network = DenseMotionNetwork(cfg)
        self.third = SameBlock2d(cfg.reshape_channel * cfg.reshape_depth, be * 4, lrelu=True)
        self.fourth = nn.Conv2d(be * 4, be * 4, 1)

    def trunk(self, source_image, kp_driving, kp_source):
        cfg = self.cfg
        x = self.first(source_image)
        for down in self.down_blocks:
            x = down(x)
        x = self.second(x)
        b, _, h, w = x.shape
        feat3d = self.resblocks_3d(x.view(b, cfg.reshape_channel, cfg.reshape_depth, h, w))
        dm = self.dense_motion_network(feat3d, kp_driving, kp_source)
        out = grid_sample_3d(feat3d, dm["deformation"])
        out = self.fourth(self.third(out.reshape(b, -1, h, w)))
        occ = dm["occlusion_map"]
        if occ.shape[2:] != out.shape[2:]:
            occ = F.interpolate(occ, size=out.shape[2:], mode="bilinear")
        return out * occ.to(out.dtype), dm


class OcclusionAwareSPADEGenerator(_Trunk):
    """generator.py:163-254: source image [B, 3, H, W], driving and source
    keypoints [B, K, 3] -> prediction [B, 3, H, W] in [0, 1], mask,
    occlusion map."""

    def __init__(self, cfg: FaceRenderConfig = FaceRenderConfig()):
        super().__init__(cfg, first_kernel=3)
        self.decoder = SPADEDecoder(cfg.gen_block_expansion * 4)

    def forward(self, source_image, kp_driving, kp_source):
        out, dm = self.trunk(source_image, kp_driving, kp_source)
        return {"prediction": self.decoder(out), "mask": dm["mask"],
                "occlusion_map": dm["occlusion_map"]}


class OcclusionAwareGenerator(_Trunk):
    """generator.py:8-118: the plain facevid2vid decoder (2-D resblocks, 2x
    nearest up blocks, a 7x7 conv, sigmoid)."""

    def __init__(self, cfg: FaceRenderConfig = FaceRenderConfig()):
        super().__init__(cfg, first_kernel=7)
        be = cfg.gen_block_expansion
        self.resblocks_2d = nn.Sequential()
        for i in range(cfg.num_resblocks):
            self.resblocks_2d.add_module(f"2dr{i}", ResBlock(be * 4))
        self.up_blocks = nn.ModuleList()
        cin = be * 4
        for i in range(cfg.num_down_blocks):
            cout = max(be, be * 2 ** (cfg.num_down_blocks - i - 1))
            self.up_blocks.append(UpBlock2d(cin, cout))
            cin = cout
        self.final = nn.Conv2d(cin, cfg.image_channel, 7, padding=3)

    def forward(self, source_image, kp_driving, kp_source):
        out, dm = self.trunk(source_image, kp_driving, kp_source)
        out = self.resblocks_2d(out)
        for up in self.up_blocks:
            out = up(out)
        return {"prediction": torch.sigmoid(self.final(out).float()), "mask": dm["mask"],
                "occlusion_map": dm["occlusion_map"]}


# ---------------------------------------------------------------- driver

def headpose_pred_to_degree(pred):
    """make_animation.py:31-37."""
    idx = torch.arange(pred.shape[-1], dtype=torch.float32, device=pred.device)
    return (F.softmax(pred.float(), dim=-1) * idx).sum(-1) * 3 - 99


def get_rotation_matrix(yaw, pitch, roll):
    """make_animation.py:39-63 (pitch @ yaw @ roll; degrees via pi = 3.14)."""
    yaw, pitch, roll = [a / 180 * 3.14 for a in (yaw, pitch, roll)]
    o, z = torch.ones_like(yaw), torch.zeros_like(yaw)
    pitch_mat = torch.stack([o, z, z, z, torch.cos(pitch), -torch.sin(pitch),
                             z, torch.sin(pitch), torch.cos(pitch)], -1).reshape(-1, 3, 3)
    yaw_mat = torch.stack([torch.cos(yaw), z, torch.sin(yaw), z, o, z,
                           -torch.sin(yaw), z, torch.cos(yaw)], -1).reshape(-1, 3, 3)
    roll_mat = torch.stack([torch.cos(roll), -torch.sin(roll), z, torch.sin(roll),
                            torch.cos(roll), z, z, z, o], -1).reshape(-1, 3, 3)
    return torch.einsum("bij,bjk,bkm->bim", pitch_mat, yaw_mat, roll_mat)


def keypoint_transformation(kp_canonical, he, wo_exp: bool = False):
    """make_animation.py:66-98: rotate the canonical keypoints by the head
    pose, translate (x and z zeroed), add the expression offsets."""
    yaw = he.get("yaw_in", None)
    pitch = he.get("pitch_in", None)
    roll = he.get("roll_in", None)
    yaw = headpose_pred_to_degree(he["yaw"]) if yaw is None else yaw
    pitch = headpose_pred_to_degree(he["pitch"]) if pitch is None else pitch
    roll = headpose_pred_to_degree(he["roll"]) if roll is None else roll
    rot = get_rotation_matrix(yaw, pitch, roll)
    kp_rotated = torch.einsum("bmp,bkp->bkm", rot, kp_canonical.float())
    t = he["t"].float() * torch.tensor([0.0, 1.0, 0.0], device=kp_canonical.device)
    exp = torch.zeros_like(he["exp"]) if wo_exp else he["exp"]
    return kp_rotated + t[:, None] + exp.float().reshape(exp.shape[0], -1, 3)


@torch.no_grad()
def make_animation(source_image, source_semantics, target_semantics, generator,
                   kp_detector, mapping):
    """make_animation.py:101-139. source_image [B, 3, H, W] in [0, 1];
    source_semantics [B, C, T_win]; target_semantics [B, F, C, T_win] ->
    frames [B, F, 3, H, W] in [0, 1], a frame at a time."""
    kp_canonical = kp_detector(source_image)
    kp_source = keypoint_transformation(kp_canonical, mapping(source_semantics))
    frames = []
    for f in range(target_semantics.shape[1]):
        kp_driving = keypoint_transformation(kp_canonical, mapping(target_semantics[:, f]))
        frames.append(generator(source_image, kp_driving, kp_source)["prediction"])
    return torch.stack(frames, dim=1)


def build_semantics(source_coeff70: np.ndarray, generated_coeff70: np.ndarray,
                    expression_scale: float = 1.0, still_mode: bool = False,
                    semantic_radius: int = 13):
    """generate_facerender_batch.py:8-110: coefficient tracks -> semantics
    windows. source [1, 70] -> [1, 70, 2R+1] (tiled); generated [F, 70] ->
    [1, F, 70, 2R+1] (edge-clamped sliding windows)."""
    src = np.asarray(source_coeff70, np.float32).reshape(1, -1)
    gen = np.asarray(generated_coeff70, np.float32).copy()
    gen[:, :64] = gen[:, :64] * expression_scale
    if still_mode:
        gen[:, 64:] = np.repeat(src[:, 64:70], len(gen), axis=0)
    win = 2 * semantic_radius + 1
    source_semantics = np.repeat(src[:, :, None], win, axis=2)
    f = len(gen)
    idx = np.arange(f)[:, None] + np.arange(-semantic_radius, semantic_radius + 1)[None]
    idx = np.clip(idx, 0, f - 1)
    target = gen[idx].transpose(0, 2, 1)[None]        # [1, F, 70, win]
    return source_semantics, target


# ---------------------------------------------------------------- weights

FACERENDER_PREFIXES = {"generator": "generator.", "kp_detector": "kp_extractor.",
                       "mapping": "mapping.", "he_estimator": "he_estimator."}


def fold_spectral_norm(sd: dict) -> dict:
    """torch spectral_norm triplets (weight_orig / weight_u / weight_v) ->
    the effective weight W / sigma, sigma = u @ W.flat @ v (the stored
    power-iteration vectors; eval mode does not update them), in numpy
    float32 as mofa_tpu's `_fold_spectral_norm` computes it."""
    bases = {k[:-len(".weight_orig")] for k in sd if k.endswith(".weight_orig")}
    out = {k: v for k, v in sd.items()
           if not (k.rsplit(".", 1)[0] in bases
                   and k.rsplit(".", 1)[-1] in ("weight_orig", "weight_u", "weight_v"))}
    for base in bases:
        w, u, v = (np.asarray(torch.as_tensor(sd[base + s]).float().numpy(), np.float32)
                   for s in (".weight_orig", ".weight_u", ".weight_v"))
        sigma = float(u @ w.reshape(w.shape[0], -1) @ v)
        out[base + ".weight"] = torch.from_numpy(w / sigma)
    return out


def facerender_state_dicts(sd: dict) -> dict:
    """A combined facerender checkpoint -> {"generator", "kp_detector",
    "mapping", "he_estimator": state dict} (each net's keys under its
    prefix; a net absent from the file gets no entry)."""
    out = {}
    for net, prefix in FACERENDER_PREFIXES.items():
        sub = {}
        for k, v in sd.items():
            k = re.sub(r"^(module\.)+", "", k)
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
            if k.endswith("num_batches_tracked") or k == "down.weight" or k.endswith(".sigma"):
                continue
            sub[k] = v
        if sub:
            out[net] = fold_spectral_norm(sub)
    return out
