"""GFPGAN v1 'clean' face restorer in PyTorch (NCHW, the checkpoint's names).

Counterpart of mofa_tpu/models/gfpgan.py: the reference's optional face
enhancer (sadtalker_audio2pose/src/utils/face_enhancer.py:42-123 runs
TencentARC GFPGANv1.4 through `GFPGANer`). The architecture is gfpgan's
`gfpganv1_clean_arch.py` with basicsr's `stylegan2_clean_arch.py`: a U-Net
encoder whose up path yields a scale and a shift (SFT) per level, and a
StyleGAN2 decoder that modulates half of each level's channels with them
(GFPGANv1.4: out_size 512, channel_multiplier 2, different_w,
input_is_latent, sft_half, narrow 1).

- `ModulatedConv2d`: the style-modulated (and demodulated) weight of each
  sample as one grouped conv with groups = batch, the reference's own
  formulation (the JAX package vmaps a conv per sample);
- the noise of each StyleConv is the stored buffer `noises.noise<i>`
  (the JAX package's `noise_mode="stored"`, deterministic; the
  reference's randomize_noise draws fresh normals);
- `gfpgan_state_dict`: GFPGANv1.4.pth ({"params_ema": ...}, {"params":
  ...} or flat) -> this module's state dict, loaded strict. The reference's
  names and layouts are this module's, so no tensor changes
  (mofa_tpu's `convert_gfpgan_state_dict` transposes for Flax only);
- `enhance_aligned`: `GFPGANer(has_aligned=True)`: each frame taken as an
  aligned face crop, resized to out_size, restored, resized back.
"""

from __future__ import annotations

import math
import re
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.ops.resize import resize_nhwc


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _clean_channels(narrow: float, cm: float) -> dict:
    return {4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
            32: int(512 * narrow), 64: int(256 * cm * narrow),
            128: int(128 * cm * narrow), 256: int(64 * cm * narrow),
            512: int(32 * cm * narrow), 1024: int(16 * cm * narrow)}


def _resize2x(x, up: bool):
    """F.interpolate by 2 or 1/2, bilinear, align_corners=False."""
    return F.interpolate(x, scale_factor=2.0 if up else 0.5, mode="bilinear",
                         align_corners=False)


class ModulatedConv2d(nn.Module):
    def __init__(self, cin, cout, k, num_style_feat, demodulate=True,
                 sample_mode: Optional[str] = None, eps: float = 1e-8):
        super().__init__()
        self.cout, self.k = cout, k
        self.demodulate, self.sample_mode, self.eps = demodulate, sample_mode, eps
        self.modulation = nn.Linear(num_style_feat, cin)
        self.weight = nn.Parameter(torch.empty(1, cout, cin, k, k))

    def forward(self, x, style):
        b, c = x.shape[:2]
        w = self.weight * self.modulation(style).view(b, 1, c, 1, 1)
        if self.demodulate:
            demod = torch.rsqrt(w.pow(2).sum([2, 3, 4]) + self.eps)
            w = w * demod.view(b, self.cout, 1, 1, 1)
        if self.sample_mode is not None:
            x = _resize2x(x, self.sample_mode == "upsample")
        h, wd = x.shape[2:]
        out = F.conv2d(x.reshape(1, b * c, h, wd),
                       w.reshape(b * self.cout, c, self.k, self.k),
                       padding=self.k // 2, groups=b)
        return out.view(b, self.cout, h, wd)


class StyleConv(nn.Module):
    def __init__(self, cin, cout, k, num_style_feat, sample_mode=None):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(cin, cout, k, num_style_feat,
                                              demodulate=True, sample_mode=sample_mode)
        self.weight = nn.Parameter(torch.zeros(1))            # noise strength
        self.bias = nn.Parameter(torch.zeros(1, cout, 1, 1))

    def forward(self, x, style, noise):
        out = self.modulated_conv(x, style) * 2 ** 0.5      # the clean arch's gain
        return _lrelu(out + self.weight * noise + self.bias)


class ToRGB(nn.Module):
    def __init__(self, cin, num_style_feat, upsample=True):
        super().__init__()
        self.upsample = upsample
        self.modulated_conv = ModulatedConv2d(cin, 3, 1, num_style_feat, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            out = out + (_resize2x(skip, True) if self.upsample else skip)
        return out


class ConstantInput(nn.Module):
    def __init__(self, ch, size=4):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, ch, size, size))


class StyleGAN2GeneratorCSFT(nn.Module):
    """The clean StyleGAN2 generator with channel-split SFT conditions."""

    def __init__(self, out_size=512, num_style_feat=512, num_mlp=8,
                 channel_multiplier=2, narrow=1, sft_half=True):
        super().__init__()
        self.num_style_feat, self.sft_half = num_style_feat, sft_half
        ch = _clean_channels(narrow, channel_multiplier)
        layers = [nn.Identity()]                       # NormStyleCode (no weights)
        for _ in range(num_mlp):
            layers += [nn.Linear(num_style_feat, num_style_feat), nn.LeakyReLU(0.2)]
        self.style_mlp = nn.Sequential(*layers)
        self.constant_input = ConstantInput(ch[4])
        self.style_conv1 = StyleConv(ch[4], ch[4], 3, num_style_feat)
        self.to_rgb1 = ToRGB(ch[4], num_style_feat, upsample=False)
        self.log_size = int(math.log2(out_size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.noises = nn.Module()
        for li in range(self.num_layers):
            r = 2 ** ((li + 5) // 2)
            self.noises.register_buffer(f"noise{li}", torch.zeros(1, 1, r, r))
        cin = ch[4]
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            self.style_convs.append(StyleConv(cin, cout, 3, num_style_feat,
                                              sample_mode="upsample"))
            self.style_convs.append(StyleConv(cout, cout, 3, num_style_feat))
            self.to_rgbs.append(ToRGB(cout, num_style_feat))
            cin = cout

    def mapping(self, x):
        """NormStyleCode (over the feature axis) then the MLP."""
        x = x * torch.rsqrt(torch.mean(x.square(), dim=1, keepdim=True) + 1e-8)
        return self.style_mlp(x)

    def forward(self, latent, conditions, input_is_latent: bool = True):
        """latent [B, num_latent, D] (or [B, D], repeated); conditions: the
        2 * (log_size - 2) SFT tensors (scale, shift per level)."""
        nsf = self.num_style_feat
        if not input_is_latent:
            latent = self.mapping(latent.reshape(-1, nsf)).reshape(latent.shape)
        if latent.ndim == 2:
            latent = latent[:, None].repeat(1, self.num_latent, 1)
        b = latent.shape[0]
        noises = [getattr(self.noises, f"noise{i}") for i in range(self.num_layers)]
        out = self.constant_input.weight.repeat(b, 1, 1, 1)
        out = self.style_conv1(out, latent[:, 0], noises[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for k in range(len(self.to_rgbs)):
            out = self.style_convs[2 * k](out, latent[:, i], noises[i])
            if i < len(conditions):
                scale, shift = conditions[i - 1], conditions[i]
                if self.sft_half:
                    same, sft = torch.split(out, out.shape[1] // 2, dim=1)
                    out = torch.cat([same, sft * scale + shift], dim=1)
                else:
                    out = out * scale + shift
            out = self.style_convs[2 * k + 1](out, latent[:, i + 1], noises[i + 1])
            skip = self.to_rgbs[k](out, latent[:, i + 2], skip)
            i += 2
        return skip


class ResBlock(nn.Module):
    """gfpganv1_clean_arch.ResBlock: conv-lrelu, bilinear resample by 2,
    conv-lrelu, plus the resampled input through a 1x1 skip."""

    def __init__(self, cin, cout, mode: str):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cin, 3, 1, 1)
        self.conv2 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.skip = nn.Conv2d(cin, cout, 1, bias=False)
        self.up = mode == "up"

    def forward(self, x):
        out = _lrelu(self.conv2(_resize2x(_lrelu(self.conv1(x)), self.up)))
        return out + self.skip(_resize2x(x, self.up))


def _sft_head(c, cout):
    return nn.Sequential(nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.2),
                         nn.Conv2d(c, cout, 3, 1, 1))


class GFPGANv1Clean(nn.Module):
    def __init__(self, out_size=512, num_style_feat=512, channel_multiplier=2,
                 num_mlp=8, input_is_latent=True, different_w=True, narrow=1,
                 sft_half=True):
        super().__init__()
        self.out_size = out_size
        self.input_is_latent, self.different_w = input_is_latent, different_w
        self.num_style_feat = num_style_feat
        ch = _clean_channels(narrow * 0.5, channel_multiplier)
        self.log_size = int(math.log2(out_size))
        self.conv_body_first = nn.Conv2d(3, ch[out_size], 1)
        cin = ch[out_size]
        self.conv_body_down = nn.ModuleList()
        for i in range(self.log_size, 2, -1):
            self.conv_body_down.append(ResBlock(cin, ch[2 ** (i - 1)], "down"))
            cin = ch[2 ** (i - 1)]
        self.final_conv = nn.Conv2d(cin, ch[4], 3, 1, 1)
        cin = ch[4]
        self.conv_body_up = nn.ModuleList()
        self.toRGB = nn.ModuleList()
        self.condition_scale = nn.ModuleList()
        self.condition_shift = nn.ModuleList()
        for i in range(3, self.log_size + 1):
            cout = ch[2 ** i]
            self.conv_body_up.append(ResBlock(cin, cout, "up"))
            self.toRGB.append(nn.Conv2d(cout, 3, 1))
            sft_out = cout if sft_half else cout * 2
            self.condition_scale.append(_sft_head(cout, sft_out))
            self.condition_shift.append(_sft_head(cout, sft_out))
            cin = cout
        lin_out = (self.log_size * 2 - 2) * num_style_feat if different_w else num_style_feat
        self.final_linear = nn.Linear(ch[4] * 4 * 4, lin_out)
        self.stylegan_decoder = StyleGAN2GeneratorCSFT(
            out_size, num_style_feat, num_mlp, channel_multiplier, narrow, sft_half)

    def forward(self, x):
        """x [B, 3, S, S] in [-1, 1] (S = out_size) -> restored [B, 3, S, S]."""
        feat = _lrelu(self.conv_body_first(x))
        skips = []
        for down in self.conv_body_down:
            feat = down(feat)
            skips.insert(0, feat)
        feat = _lrelu(self.final_conv(feat))
        style_code = self.final_linear(feat.reshape(feat.shape[0], -1))
        if self.different_w:
            style_code = style_code.view(style_code.shape[0], -1, self.num_style_feat)
        conditions = []
        for i, up in enumerate(self.conv_body_up):
            feat = up(feat + skips[i])
            conditions += [self.condition_scale[i](feat), self.condition_shift[i](feat)]
            # the encoder's RGB heads (toRGB) feed only the training loss
        return self.stylegan_decoder(style_code, conditions,
                                     input_is_latent=self.input_is_latent)


TINY_GFPGAN_CONFIG = dict(out_size=32, num_style_feat=16, num_mlp=2,
                          channel_multiplier=0.125, narrow=0.0625, sft_half=True)


def init_gfpgan_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: convs, linears and modulated convs N(0,
    1/fan_in), their biases (and the StyleConvs' noise strengths)
    N(0, 0.02^2), the modulations' biases 1 (a unit style scale, as the
    reference initialises them), the constant input and the noise buffers
    N(0, 1)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("constant_input.weight"):
                p.normal_(0.0, 1.0, generator=generator)
            elif name.endswith("modulation.bias"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=generator)
            elif p.ndim >= 2:
                fan_in = p[0].numel() if p.ndim < 5 else p[0, 0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=generator)
            else:
                p.normal_(0.0, 0.02, generator=generator)
        for _, buf in model.named_buffers():
            buf.normal_(0.0, 1.0, generator=generator)
    return model


def gfpgan_state_dict(checkpoint: dict) -> dict:
    """GFPGANv1.4.pth -> GFPGANv1Clean's state dict: the dict under
    "params_ema" (else "params", else the file itself), `module.`
    prefixes stripped."""
    sd = checkpoint
    for wrap in ("params_ema", "params"):
        if isinstance(sd.get(wrap), dict):
            sd = sd[wrap]
            break
    return {re.sub(r"^(module\.)+", "", k): v for k, v in sd.items()}


def load_gfpgan(ckpt: Optional[str], device, tiny: bool = False, seed: int = 0) -> GFPGANv1Clean:
    """GFPGANv1Clean (GFPGANv1.4's config, or TINY_GFPGAN_CONFIG) in eval
    mode on `device`, fp32: from `ckpt` (strict), else seeded random."""
    from mofa_tpu_torch.models.weights import load_torch_checkpoint
    with torch.device(device):
        model = GFPGANv1Clean(**TINY_GFPGAN_CONFIG) if tiny else GFPGANv1Clean()
    if ckpt:
        model.load_state_dict(gfpgan_state_dict(
            torch.load(ckpt, map_location="cpu", weights_only=True)), strict=True)
    else:
        init_gfpgan_(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


@torch.no_grad()
def enhance_aligned(model: GFPGANv1Clean, frames01: np.ndarray, batch: int = 4) -> np.ndarray:
    """`GFPGANer(has_aligned=True)`: each frame an aligned face crop
    (face_enhancer.py feeds facerender's frames). frames01 [T, H, W, 3]
    float in [0, 1] -> the same shape and range, restored."""
    t, h, w = frames01.shape[:3]
    s = model.out_size
    dev = next(model.parameters()).device
    x = resize_nhwc(torch.from_numpy(np.asarray(frames01, np.float32)).to(dev), (s, s))
    x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
    out = torch.cat([model(x[i:i + batch]) for i in range(0, t, batch)])
    out = torch.clamp(out / 2 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
    return resize_nhwc(out, (h, w)).cpu().numpy()
