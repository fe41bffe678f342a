"""CMP (Conditional Motion Propagation): sparse-to-dense flow completion.

Counterpart of mofa_tpu/models/cmp/model.py for the shipped inference
configuration (the reference's models/cmp): a dilated ResNet-50 image
encoder (layer3 dilation 2, layer4 dilation 4, output stride 8, a 1x1 head
to 256 channels; skip features [image, conv1, layer1]), the ShallowNet8x
sparse encoder (16 channels at /8), MotionDecoderSkipLayer (four pooled
branches and skip fusions, 198 logits at /2), the Fuser (a softmax
expectation per axis over 99 bins, fmax 50) and a final bilinear
(align_corners) x2 upsample.

Module and parameter names are the reference checkpoint's
(`image_encoder.layer1.0.conv1.weight`, `flow_decoder.decoder1.0.weight`,
`...running_mean`), so `ckpt_iter_42000.pth.tar` loads with `strict=True`
(apps/loaders.py::load_cmp). Inside the model tensors are NCHW; the public
layouts follow the JAX package: image, sparse flow, mask and flow [N, H, W,
C]. BatchNorm runs on its stored statistics (`eval()`). The inference
quirk is kept: the model sees `image*2-1` (`cmp_preprocess`), never the
YAML's Normalize transform.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.ops.resize import resize_hw, resize_nhwc


@dataclasses.dataclass(frozen=True)
class CMPConfig:
    img_enc_dim: int = 256
    sparse_enc_dim: int = 16
    output_dim: int = 198
    nbins: int = 99
    fmax: float = 50.0
    resnet_layers: tuple = (3, 4, 6, 3)
    base_width: int = 64
    # the reference's architecture selectors; the port builds the shipped
    # configuration only (resnet50 + shallownet8x + MotionDecoderSkipLayer)
    image_encoder: str = "resnet50"
    sparse_encoder: str = "shallownet8x"
    flow_decoder: str = "MotionDecoderSkipLayer"
    decoder_combo: tuple = (1, 2, 4)
    skip_layer: bool = True


TINY_CMP_CONFIG = CMPConfig(img_enc_dim=32, sparse_enc_dim=8, output_dim=18,
                            nbins=9, fmax=50.0, resnet_layers=(1, 1, 1, 1),
                            base_width=8)
SHIPPED = ("resnet50", "shallownet8x", "MotionDecoderSkipLayer", True)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            # the reference zeroes the downsample conv's stride under
            # dilation too, so the stride applies on conv2 only
            ds_stride = stride if dilation == 1 else 1
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=ds_stride, bias=False),
                nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(h + residual)


class ResNetDilated(nn.Module):
    """Output stride 8: layer3 and layer4 keep the /8 grid, dilated 2 and 4."""

    def __init__(self, cfg: CMPConfig):
        super().__init__()
        bw = cfg.base_width
        self.conv1 = nn.Conv2d(3, bw, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(bw)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        specs = ((bw, 1, 1), (bw * 2, 2, 1), (bw * 4, 1, 2), (bw * 8, 1, 4))
        inplanes = bw
        for li, ((planes, stride, dil), nblocks) in enumerate(
                zip(specs, cfg.resnet_layers)):
            blocks = []
            for bi in range(nblocks):
                blocks.append(Bottleneck(inplanes, planes, stride if bi == 0 else 1,
                                         dil, downsample=bi == 0))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.conv5 = nn.Conv2d(inplanes, cfg.img_enc_dim, 1)

    def forward(self, img):
        conv1 = F.relu(self.bn1(self.conv1(img)))                 # /2
        layer1 = self.layer1(self.maxpool(conv1))                 # /4
        x = self.layer4(self.layer3(self.layer2(layer1)))         # /8
        return self.conv5(x), [img, conv1, layer1]


class ShallowNet8x(nn.Module):
    def __init__(self, cfg: CMPConfig):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(4, 16, 5, stride=2, padding=2), nn.BatchNorm2d(16), nn.ReLU(),
            nn.MaxPool2d(2, 2),
            nn.Conv2d(16, cfg.sparse_enc_dim, 3, padding=1),
            nn.BatchNorm2d(cfg.sparse_enc_dim), nn.ReLU(),
            nn.AvgPool2d(2, 2))

    def forward(self, sparse):
        return self.features(sparse)


def _conv_bn_relu(cin: int, cout: int) -> list:
    return [nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU()]


def _upsample(x, size):
    return resize_hw(x, size, "bilinear", align_corners=True)


class MotionDecoderSkipLayer(nn.Module):
    def __init__(self, cfg: CMPConfig):
        super().__init__()
        cin, bw = cfg.img_enc_dim + cfg.sparse_enc_dim, cfg.base_width
        for pool in (1, 2, 4, 8):
            layers = [] if pool == 1 else [nn.MaxPool2d(pool, pool)]
            layers += (_conv_bn_relu(cin, 128) + _conv_bn_relu(128, 128)
                       + _conv_bn_relu(128, 128))
            setattr(self, f"decoder{pool}", nn.Sequential(*layers))
        self.fusion8 = nn.Sequential(*_conv_bn_relu(4 * 128, 256))
        self.skipconv4 = nn.Sequential(*_conv_bn_relu(4 * bw, 128))
        self.fusion4 = nn.Sequential(*_conv_bn_relu(256 + 128, 128))
        self.skipconv2 = nn.Sequential(*_conv_bn_relu(bw, 32))
        self.fusion2 = nn.Sequential(*_conv_bn_relu(128 + 32, 64))
        self.head = nn.Conv2d(64, cfg.output_dim, 1)

    def forward(self, x, skip_feat):
        _, conv1, layer1 = skip_feat
        size = x.shape[2:]
        branches = [self.decoder1(x)] + [
            _upsample(getattr(self, f"decoder{p}")(x), size) for p in (2, 4, 8)]
        f8 = self.fusion8(torch.cat(branches, dim=1))
        s4 = self.skipconv4(layer1)
        f4 = self.fusion4(torch.cat([_upsample(f8, layer1.shape[2:]), s4], dim=1))
        s2 = self.skipconv2(conv1)
        f2 = self.fusion2(torch.cat([_upsample(f4, conv1.shape[2:]), s2], dim=1))
        return self.head(f2)


def fuser_convert_flow(flow_prob: torch.Tensor, nbins: int, fmax: float) -> torch.Tensor:
    """[N, H, W, 2*nbins] logits -> [N, H, W, 2] expected flow (softmax in
    fp32 over each axis's bins)."""
    step = 2 * fmax / float(nbins)
    mesh = (torch.arange(nbins, dtype=torch.float32, device=flow_prob.device) * step
            - fmax + step / 2)
    logits = flow_prob.float()
    fx = (torch.softmax(logits[..., :nbins], dim=-1) * mesh).sum(-1)
    fy = (torch.softmax(logits[..., nbins:], dim=-1) * mesh).sum(-1)
    return torch.stack([fx, fy], dim=-1).to(flow_prob.dtype)


def cmp_preprocess(image01: torch.Tensor) -> torch.Tensor:
    """(0, 1) image -> CMP input, as the reference's CMP_demo.run (image*2-1
    only)."""
    return image01 * 2.0 - 1.0


class CMP(nn.Module):
    """(image, sparse, mask) -> dense flow at the input's resolution."""

    def __init__(self, cfg: CMPConfig = CMPConfig()):
        super().__init__()
        got = (cfg.image_encoder, cfg.sparse_encoder, cfg.flow_decoder, cfg.skip_layer)
        if got != SHIPPED:
            raise NotImplementedError(f"the port builds the shipped CMP {SHIPPED}; "
                                      f"got {got}")
        self.cfg = cfg
        self.image_encoder = ResNetDilated(cfg)
        self.flow_encoder = ShallowNet8x(cfg)
        self.flow_decoder = MotionDecoderSkipLayer(cfg)

    def forward(self, image, sparse, mask):
        """image [N, H, W, 3] already preprocessed to (-1, 1); sparse, mask
        [N, H, W, 2]. Returns flow [N, H, W, 2]."""
        nchw = lambda t: t.permute(0, 3, 1, 2)
        sparse_enc = self.flow_encoder(torch.cat([nchw(sparse), nchw(mask)], dim=1))
        img_enc, skips = self.image_encoder(nchw(image))
        logits = self.flow_decoder(torch.cat([img_enc, sparse_enc], dim=1), skips)
        logits = logits.permute(0, 2, 3, 1)                     # [N, h, w, 2*nbins]
        flow = fuser_convert_flow(logits, self.cfg.nbins, self.cfg.fmax)
        if flow.shape[1:3] != image.shape[1:3]:
            flow = resize_nhwc(flow, tuple(image.shape[1:3]), "bilinear", True)
        return flow
