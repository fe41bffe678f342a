"""CMP (Conditional Motion Propagation): sparse-to-dense flow completion.

Counterpart of mofa_tpu/models/cmp/model.py (the reference's models/cmp).
The shipped configuration: a dilated ResNet-50 image encoder (layer3
dilation 2, layer4 dilation 4, output stride 8, a 1x1 head to 256
channels; skip features [image, conv1, layer1]), the ShallowNet8x sparse
encoder (16 channels at /8), MotionDecoderSkipLayer (four pooled branches
and skip fusions, 198 logits at /2), the Fuser (a softmax expectation per
axis over 99 bins, fmax 50) and a final bilinear (align_corners) x2
upsample. The reference's other experiment configurations, which CMP
training selects by `CMPConfig`: the BN AlexNet FCN encoders (output
stride 8 or 32), the shallownet32x sparse encoder, MotionDecoderPlain and
MotionDecoderFlowNet (per-scale logits, finest first); `CMP.logits` gives
the decoder's raw logits, the training loss's input, and
`cmp_config_from_yaml` reads the reference's experiment config.yaml.

Module and parameter names are the reference checkpoint's
(`image_encoder.layer1.0.conv1.weight`, `flow_decoder.decoder1.0.weight`,
`...running_mean`), so `ckpt_iter_42000.pth.tar` loads with `strict=True`
(apps/loaders.py::load_cmp). Inside the model tensors are NCHW; the public
layouts follow the JAX package: image, sparse flow, mask and flow [N, H, W,
C]. BatchNorm runs on its stored statistics (`eval()`). The inference
quirk is kept: the model sees `image*2-1` (`cmp_preprocess`), never the
YAML's Normalize transform.

Training (models/cmp/train.py) swaps each `nn.BatchNorm2d` for
`StatsAffineBatchNorm`, whose running mean and variance are parameters
under the same names: the JAX package keeps them as params and trains them
by gradient (ROADMAP Queue 3 item 9). Its state dict is the inference
CMP's, which `load_cmp` reads back into nn.BatchNorm2d.
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
    # the reference's architecture selectors (models/cmp/models/modules/
    # cmp.py:9-25): the shipped config is resnet50 + shallownet8x +
    # MotionDecoderSkipLayer; alexnet_fcn_{8x,32x}, shallownet32x and the
    # Plain / FlowNet decoders are the other experiment configs
    image_encoder: str = "resnet50"
    sparse_encoder: str = "shallownet8x"
    flow_decoder: str = "MotionDecoderSkipLayer"
    decoder_combo: tuple = (1, 2, 4)
    skip_layer: bool = True


TINY_CMP_CONFIG = CMPConfig(img_enc_dim=32, sparse_enc_dim=8, output_dim=18,
                            nbins=9, fmax=50.0, resnet_layers=(1, 1, 1, 1),
                            base_width=8)


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
    """shallownet8x (a final average pool of 2) or, with final_pool=8,
    shallownet32x."""

    def __init__(self, cfg: CMPConfig, final_pool: int = 2):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(4, 16, 5, stride=2, padding=2), nn.BatchNorm2d(16), nn.ReLU(),
            nn.MaxPool2d(2, 2),
            nn.Conv2d(16, cfg.sparse_enc_dim, 3, padding=1),
            nn.BatchNorm2d(cfg.sparse_enc_dim), nn.ReLU(),
            nn.AvgPool2d(final_pool, final_pool))

    def forward(self, sparse):
        return self.features(sparse)


def _conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                  pad: int | None = None) -> list:
    pad = kernel // 2 if pad is None else pad
    return [nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad),
            nn.BatchNorm2d(cout), nn.ReLU()]


def _branch(cin: int, pool: int, blocks: int) -> nn.Sequential:
    """A decoder branch: a max pool (pool > 1), then `blocks` conv-BN-ReLU
    of 128 channels."""
    layers = [] if pool == 1 else [nn.MaxPool2d(pool, pool)]
    for i in range(blocks):
        layers += _conv_bn_relu(cin if i == 0 else 128, 128)
    return nn.Sequential(*layers)


def _upsample(x, size):
    return resize_hw(x, size, "bilinear", align_corners=True)


class MotionDecoderSkipLayer(nn.Module):
    def __init__(self, cfg: CMPConfig):
        super().__init__()
        cin, bw = cfg.img_enc_dim + cfg.sparse_enc_dim, cfg.base_width
        for pool in (1, 2, 4, 8):
            setattr(self, f"decoder{pool}", _branch(cin, pool, 3))
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


class MotionDecoderPlain(nn.Module):
    """Pooled branches of two conv-BN-ReLU each (the pools of
    `decoder_combo`), upsampled back (bilinear, align_corners), concatenated,
    a 1x1 head; no encoder skips."""

    def __init__(self, cfg: CMPConfig):
        super().__init__()
        self.combo = tuple(cfg.decoder_combo)
        cin = cfg.img_enc_dim + cfg.sparse_enc_dim
        for pool in self.combo:
            setattr(self, f"decoder{pool}", _branch(cin, pool, 2))
        self.head = nn.Conv2d(128 * len(self.combo), cfg.output_dim, 1)

    def forward(self, x):
        size = x.shape[2:]
        outs = [getattr(self, f"decoder{p}")(x) for p in self.combo]
        outs = [h if p == 1 else _upsample(h, size) for p, h in zip(self.combo, outs)]
        return self.head(torch.cat(outs, dim=1))


def _deconv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1), nn.LeakyReLU(0.1))


class MotionDecoderFlowNet(nn.Module):
    """The SkipLayer decoder's four branches and fusion8, then a FlowNet
    coarse-to-fine head: logits predicted at /8, upsampled by transposed
    convs and refined against the encoder's skips (layer1 at /4, conv1 at
    /2, the image at /1). Returns [logits1, logits2, logits4, logits8]."""

    def __init__(self, cfg: CMPConfig):
        super().__init__()
        cin, bw, out = cfg.img_enc_dim + cfg.sparse_enc_dim, cfg.base_width, cfg.output_dim
        for pool in (1, 2, 4, 8):
            setattr(self, f"decoder{pool}", _branch(cin, pool, 3))
        self.fusion8 = nn.Sequential(*_conv_bn_relu(4 * 128, 256))
        c4, c2 = 4 * bw + 128 + out, bw + 128 + out
        self.predict_flow8 = nn.Conv2d(256, out, 3, padding=1)
        self.upsampled_flow8_to_4 = nn.ConvTranspose2d(out, out, 4, 2, 1, bias=False)
        self.deconv8 = _deconv(256, 128)
        self.predict_flow4 = nn.Conv2d(c4, out, 3, padding=1)
        self.upsampled_flow4_to_2 = nn.ConvTranspose2d(out, out, 4, 2, 1, bias=False)
        self.deconv4 = _deconv(c4, 128)
        self.predict_flow2 = nn.Conv2d(c2, out, 3, padding=1)
        self.upsampled_flow2_to_1 = nn.ConvTranspose2d(out, out, 4, 2, 1, bias=False)
        self.deconv2 = _deconv(c2, 64)
        self.predict_flow1 = nn.Conv2d(3 + 64 + out, out, 3, padding=1)

    def forward(self, x, skip_feat):
        img, conv1, layer1 = skip_feat
        size = x.shape[2:]
        branches = [self.decoder1(x)] + [
            _upsample(getattr(self, f"decoder{p}")(x), size) for p in (2, 4, 8)]
        feat8 = self.fusion8(torch.cat(branches, dim=1))
        flow8 = self.predict_flow8(feat8)
        concat4 = torch.cat([layer1, self.deconv8(feat8),
                             self.upsampled_flow8_to_4(flow8)], dim=1)
        flow4 = self.predict_flow4(concat4)
        concat2 = torch.cat([conv1, self.deconv4(concat4),
                             self.upsampled_flow4_to_2(flow4)], dim=1)
        flow2 = self.predict_flow2(concat2)
        concat1 = torch.cat([img, self.deconv2(concat2),
                             self.upsampled_flow2_to_1(flow2)], dim=1)
        return [self.predict_flow1(concat1), flow2, flow4, flow8]


class AlexNetFCN(nn.Module):
    """The BN AlexNet as an FCN encoder: strides (2, 2, 2, 1) with stride8
    (alexnet_fcn_8x), else (4, 2, 2, 2) (alexnet_fcn_32x); no skip features
    (dropout is the identity at inference and in the JAX package)."""

    def __init__(self, cfg: CMPConfig, stride8: bool = True):
        super().__init__()
        s = (2, 2, 2, 1) if stride8 else (4, 2, 2, 2)
        self.conv1 = nn.Sequential(*_conv_bn_relu(3, 96, 11, s[0], 5))
        self.pool1 = nn.MaxPool2d(3, s[1], padding=1)
        self.conv2 = nn.Sequential(*_conv_bn_relu(96, 256, 5))
        self.pool2 = nn.MaxPool2d(3, s[2], padding=1)
        self.conv3 = nn.Sequential(*_conv_bn_relu(256, 384))
        self.conv4 = nn.Sequential(*_conv_bn_relu(384, 384))
        self.conv5 = nn.Sequential(*_conv_bn_relu(384, 256))
        self.pool5 = nn.MaxPool2d(3, s[3], padding=1)
        self.fc6 = nn.Sequential(*_conv_bn_relu(256, 4096))
        self.fc7 = nn.Sequential(*_conv_bn_relu(4096, 4096, 1))
        self.conv8 = nn.Conv2d(4096, cfg.img_enc_dim, 1)

    def forward(self, img):
        x = self.pool1(self.conv1(img))
        x = self.pool2(self.conv2(x))
        x = self.pool5(self.conv5(self.conv4(self.conv3(x))))
        return self.conv8(self.fc7(self.fc6(x)))


class StatsAffineBatchNorm(nn.Module):
    """A BatchNorm on its stored statistics whose running mean and variance
    are parameters, trained by gradient as the JAX package trains its
    BatchNorm's `mean` / `var`. Computed as the JAX module does: x * inv +
    (bias - mean * inv), inv = weight / sqrt(var + eps), in fp32."""

    def __init__(self, bn: nn.BatchNorm2d):
        super().__init__()
        self.eps = bn.eps
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, nn.Parameter(getattr(bn, name).detach().clone()))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shape = (1, -1, 1, 1)
        return (x.float() * inv.view(shape)
                + (self.bias - self.running_mean * inv).view(shape)).to(x.dtype)


def _swap_modules(module: nn.Module, kind, make) -> nn.Module:
    for name, child in list(module.named_children()):
        if isinstance(child, kind):
            setattr(module, name, make(child))
        else:
            _swap_modules(child, kind, make)
    return module


def bn_stats_as_parameters(module: nn.Module) -> nn.Module:
    """Each nn.BatchNorm2d of `module` replaced by a StatsAffineBatchNorm
    holding the same values under the same names (in place)."""
    return _swap_modules(module, nn.BatchNorm2d, StatsAffineBatchNorm)


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
        if cfg.skip_layer and cfg.flow_decoder != "MotionDecoderSkipLayer":
            # the reference's assertion (modules/cmp.py:16-17)
            raise ValueError("skip_layer needs the MotionDecoderSkipLayer decoder")
        if cfg.flow_decoder != "MotionDecoderPlain" and cfg.image_encoder != "resnet50":
            raise ValueError(f"{cfg.flow_decoder} needs the resnet50 encoder's skips")
        self.cfg = cfg
        self.image_encoder = {
            "resnet50": lambda: ResNetDilated(cfg),
            "alexnet_fcn_8x": lambda: AlexNetFCN(cfg, stride8=True),
            "alexnet_fcn_32x": lambda: AlexNetFCN(cfg, stride8=False),
        }[cfg.image_encoder]()
        self.flow_encoder = ShallowNet8x(
            cfg, final_pool=8 if cfg.sparse_encoder == "shallownet32x" else 2)
        self.flow_decoder = {
            "MotionDecoderSkipLayer": MotionDecoderSkipLayer,
            "MotionDecoderPlain": MotionDecoderPlain,
            "MotionDecoderFlowNet": MotionDecoderFlowNet,
        }[cfg.flow_decoder](cfg)

    def logits(self, image, sparse, mask):
        """The decoder's raw 2*nbins logits [N, h, w, 2*nbins] (at /2 for the
        SkipLayer decoder; the training loss's input); for the FlowNet
        decoder a list of them, finest first."""
        nchw = lambda t: t.permute(0, 3, 1, 2)
        sparse_enc = self.flow_encoder(torch.cat([nchw(sparse), nchw(mask)], dim=1))
        if self.cfg.image_encoder == "resnet50":
            img_enc, skips = self.image_encoder(nchw(image))
        else:
            img_enc, skips = self.image_encoder(nchw(image)), None
        x = torch.cat([img_enc, sparse_enc], dim=1)
        if self.cfg.flow_decoder == "MotionDecoderPlain":
            return self.flow_decoder(x).permute(0, 2, 3, 1)
        out = self.flow_decoder(x, skips)
        if isinstance(out, list):
            return [o.permute(0, 2, 3, 1) for o in out]
        return out.permute(0, 2, 3, 1)

    def forward(self, image, sparse, mask):
        """image [N, H, W, 3] already preprocessed to (-1, 1); sparse, mask
        [N, H, W, 2]. Returns flow [N, H, W, 2]."""
        logits = self.logits(image, sparse, mask)
        if isinstance(logits, list):
            logits = logits[0]                                  # FlowNet: finest
        flow = fuser_convert_flow(logits, self.cfg.nbins, self.cfg.fmax)
        if flow.shape[1:3] != image.shape[1:3]:
            flow = resize_nhwc(flow, tuple(image.shape[1:3]), "bilinear", True)
        return flow


def parse_yaml_subset(text: str) -> dict:
    """The subset of YAML the reference's CMP config.yaml is written in:
    nested block mappings by indentation, `key: value` scalars (int, float,
    bool, null, quoted or bare strings), inline lists `[a, b]`, block lists
    of scalars (`- item` under a key), `#` comments. Anything else raises."""
    root: dict = {}
    stack = [(-1, root, None, None)]         # (indent, node, parent, key)
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        while stack[-1][0] >= indent:
            stack.pop()
        _, node, parent, key = stack[-1]
        if body == "-" or body.startswith("- "):
            if node == {} and parent is not None:
                node = parent[key] = []
                stack[-1] = (stack[-1][0], node, parent, key)
            if not isinstance(node, list):
                raise ValueError(f"unsupported YAML line: {raw!r}")
            node.append(_yaml_scalar(body[1:].strip()))
            continue
        if ":" not in body or not isinstance(node, dict):
            raise ValueError(f"unsupported YAML line: {raw!r}")
        name, _, rest = body.partition(":")
        name, rest = name.strip(), rest.strip()
        if rest:
            node[name] = _yaml_scalar(rest)
        else:
            node[name] = {}
            stack.append((indent, node[name], node, name))
    return root


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if ch in "'\"" and quote in (None, ch):
            quote = None if quote else ch
        elif ch == "#" and quote is None and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _yaml_scalar(text: str):
    if text.startswith("[") and text.endswith("]"):
        inner = text[1:-1].strip()
        return [_yaml_scalar(t.strip()) for t in inner.split(",")] if inner else []
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def cmp_config_from_yaml(path: str) -> CMPConfig:
    """The reference CMP experiment config.yaml (experiments/semiauto_annot/
    resnet50_vip+mpii_liteflow/config.yaml) -> CMPConfig, read with
    `parse_yaml_subset` (no PyYAML): the `model.module` mapping (or
    `model`, or the top level), as the JAX package reads it."""
    with open(path) as f:
        raw = parse_yaml_subset(f.read())
    model = raw.get("model", {})
    margs = model["module"] if "module" in model else raw.get("model", raw)
    return CMPConfig(
        img_enc_dim=int(margs.get("img_enc_dim", 256)),
        sparse_enc_dim=int(margs.get("sparse_enc_dim", 16)),
        output_dim=int(margs.get("output_dim", 198)),
        nbins=int(margs.get("nbins", 99)),
        fmax=float(margs.get("fmax", 50)),
        image_encoder=str(margs.get("image_encoder", "resnet50")),
        sparse_encoder=str(margs.get("sparse_encoder", "shallownet8x")),
        flow_decoder=str(margs.get("flow_decoder", "MotionDecoderSkipLayer")),
        decoder_combo=tuple(margs.get("decoder_combo", (1, 2, 4))),
        skip_layer=bool(margs.get("skip_layer", True)),
    )
