"""PIRenderer's face generator (SadTalker's 'pirender' face model) in PyTorch.

Counterpart of mofa_tpu/models/pirender.py (the reference's
sadtalker_audio2pose/src/facerender/pirender/: face_model.py:62-182 over
the blocks of base_function.py), NCHW, with the reference's module names,
so a checkpoint's `net_G_ema` state dict loads strict
(`models/weights.py::pirender_state_dict`):

- `MappingNet` (face_model.py:90-115): a [B, 73, 27] semantics window ->
  the descriptor [B, D, 1] (a 7-tap conv, then dilated 3-tap convs, each
  added to its input cropped by 3 at both ends, and a mean over time);
- `WarpingNet` (:117-148): the ADAIN hourglass (instance norm modulated by
  the descriptor; stride-2 4x4 convs down, ConvTranspose2d(3, 2, 1,
  output_padding=1) up, skips concatenated), a LayerNorm2d / LeakyReLU /
  7x7 conv flow head -> the flow [B, 2, H/4, W/4] in pixels, turned into a
  sample grid (`convert_flow_to_deformation`), resized bilinearly to the
  image and sampled with `F.grid_sample` (bilinear, zeros,
  align_corners=False);
- `EditingNet` (:150-182): `FineEncoder` over the source and the warped
  image, `FineDecoder` with ADAIN res blocks -> the frame (tanh);
- `FineADAINResBlock2d` keeps the reference's dead branch's parameters
  (`conv1`, `norm1`: computed and overwritten there,
  base_function.py:316-320) so a checkpoint loads strict; its output never
  entered the result, so it is not computed;
- `pirender_animation` (pirender_animate.py:76-84): one frame a call over
  [B, F, 73, 27] semantics windows.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PIRenderConfig:
    """facerender_pirender.yaml gen.param."""
    image_nc: int = 3
    descriptor_nc: int = 256
    max_nc: int = 256
    coeff_nc: int = 73
    mapping_layers: int = 3
    warp_encoder_layer: int = 5
    warp_decoder_layer: int = 3
    warp_base_nc: int = 32
    edit_layer: int = 3
    edit_num_res_blocks: int = 2
    edit_base_nc: int = 64


TINY_PIRENDER_CONFIG = PIRenderConfig(
    descriptor_nc=16, max_nc=16, mapping_layers=1, warp_encoder_layer=3,
    warp_decoder_layer=2, warp_base_nc=4, edit_layer=2,
    edit_num_res_blocks=1, edit_base_nc=4)


def _act(x):
    return F.leaky_relu(x, 0.1)


def convert_flow_to_deformation(flow: torch.Tensor) -> torch.Tensor:
    """flow_util.py: [B, 2, H, W] pixel flow -> [B, H, W, 2] sample grid in
    [-1, 1] (x, y)."""
    _, _, h, w = flow.shape
    norm = 2 * torch.cat([flow[:, :1] / (w - 1), flow[:, 1:] / (h - 1)], 1)
    x = 2 * (torch.arange(w, device=flow.device, dtype=flow.dtype) / (w - 1)) - 1
    y = 2 * (torch.arange(h, device=flow.device, dtype=flow.dtype) / (h - 1)) - 1
    grid = torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], -1)
    return grid[None] + norm.permute(0, 2, 3, 1)


def warp_image(source: torch.Tensor, deformation: torch.Tensor) -> torch.Tensor:
    """flow_util.py warp_image: the grid resized bilinearly to the source's
    size where it differs, then `F.grid_sample` (bilinear, zeros,
    align_corners=False)."""
    h, w = source.shape[2:]
    if deformation.shape[1:3] != (h, w):
        deformation = F.interpolate(deformation.permute(0, 3, 1, 2), size=(h, w),
                                    mode="bilinear").permute(0, 2, 3, 1)
    return F.grid_sample(source, deformation, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


class LayerNorm2d(nn.Module):
    """base_function.py:11-28: layer norm over (C, H, W) with a per-channel
    affine, stored [C, 1, 1]. The statistics come from `var_mean` over the
    three axes: `F.layer_norm` over one sample's C*H*W values (up to 8.4M
    here) is many times slower on CUDA (chip_smoke.py phase 5l times
    both)."""

    def __init__(self, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n_out, 1, 1))
        self.bias = nn.Parameter(torch.zeros(n_out, 1, 1))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


class ADAIN(nn.Module):
    """base_function.py:162-192: instance norm, scaled by 1 + gamma and
    shifted by beta, both from the descriptor through an MLP."""

    def __init__(self, norm_nc: int, feature_nc: int, hidden: int = 128):
        super().__init__()
        self.mlp_shared = nn.Sequential(nn.Linear(feature_nc, hidden), nn.ReLU())
        self.mlp_gamma = nn.Linear(hidden, norm_nc)
        self.mlp_beta = nn.Linear(hidden, norm_nc)

    def forward(self, x, z):
        normalized = F.instance_norm(x, eps=1e-5)
        actv = self.mlp_shared(z.reshape(z.shape[0], -1))
        gamma = self.mlp_gamma(actv)[:, :, None, None]
        beta = self.mlp_beta(actv)[:, :, None, None]
        return normalized * (1 + gamma) + beta


class MappingNet(nn.Module):
    """face_model.py:90-115."""

    def __init__(self, coeff_nc: int, descriptor_nc: int, layer: int):
        super().__init__()
        self.layer = layer
        self.first = nn.Sequential(nn.Conv1d(coeff_nc, descriptor_nc, 7))
        for i in range(layer):
            setattr(self, f"encoder{i}", nn.Sequential(
                nn.LeakyReLU(0.1), nn.Conv1d(descriptor_nc, descriptor_nc, 3, dilation=3)))

    def forward(self, x):                             # [B, C, T]
        out = self.first(x)
        for i in range(self.layer):
            out = getattr(self, f"encoder{i}")(out) + out[:, :, 3:-3]
        return out.mean(dim=2, keepdim=True)          # [B, D, 1]


class ADAINEncoderBlock(nn.Module):
    def __init__(self, input_nc: int, output_nc: int, feature_nc: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(input_nc, output_nc, 4, 2, 1)
        self.conv_1 = nn.Conv2d(output_nc, output_nc, 3, 1, 1)
        self.norm_0 = ADAIN(input_nc, feature_nc)
        self.norm_1 = ADAIN(output_nc, feature_nc)

    def forward(self, x, z):
        x = self.conv_0(_act(self.norm_0(x, z)))
        return self.conv_1(_act(self.norm_1(x, z)))


class ADAINDecoderBlock(nn.Module):
    def __init__(self, input_nc: int, output_nc: int, hidden_nc: int, feature_nc: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(input_nc, hidden_nc, 3, 1, 1)
        self.conv_1 = nn.ConvTranspose2d(hidden_nc, output_nc, 3, 2, 1, output_padding=1)
        self.conv_s = nn.ConvTranspose2d(input_nc, output_nc, 3, 2, 1, output_padding=1)
        self.norm_0 = ADAIN(input_nc, feature_nc)
        self.norm_1 = ADAIN(hidden_nc, feature_nc)
        self.norm_s = ADAIN(input_nc, feature_nc)

    def forward(self, x, z):
        x_s = self.conv_s(_act(self.norm_s(x, z)))
        dx = self.conv_0(_act(self.norm_0(x, z)))
        dx = self.conv_1(_act(self.norm_1(dx, z)))
        return x_s + dx


class ADAINEncoder(nn.Module):
    def __init__(self, image_nc, pose_nc, ngf, img_f, layers):
        super().__init__()
        self.layers = layers
        self.input_layer = nn.Conv2d(image_nc, ngf, 7, 1, 3)
        for i in range(layers):
            setattr(self, f"encoder{i}", ADAINEncoderBlock(
                min(ngf * 2 ** i, img_f), min(ngf * 2 ** (i + 1), img_f), pose_nc))

    def forward(self, x, z):
        out = self.input_layer(x)
        outs = [out]
        for i in range(self.layers):
            out = getattr(self, f"encoder{i}")(out, z)
            outs.append(out)
        return outs


class ADAINDecoder(nn.Module):
    def __init__(self, descriptor_nc, ngf, img_f, encoder_layers, decoder_layers):
        super().__init__()
        self.levels = list(range(encoder_layers - decoder_layers, encoder_layers))[::-1]
        for i in self.levels:
            in_nc = min(ngf * 2 ** (i + 1), img_f) * (1 if i == encoder_layers - 1 else 2)
            out_nc = min(ngf * 2 ** i, img_f)
            setattr(self, f"decoder{i}", ADAINDecoderBlock(in_nc, out_nc, out_nc,
                                                           descriptor_nc))
        self.output_nc = out_nc * 2

    def forward(self, feats, z):
        out = feats.pop()
        for i in self.levels:
            out = getattr(self, f"decoder{i}")(out, z)
            out = torch.cat([out, feats.pop()], 1)
        return out


class ADAINHourglass(nn.Module):
    """base_function.py:31-92."""

    def __init__(self, image_nc, descriptor_nc, ngf, img_f, encoder_layers, decoder_layers):
        super().__init__()
        self.encoder = ADAINEncoder(image_nc, descriptor_nc, ngf, img_f, encoder_layers)
        self.decoder = ADAINDecoder(descriptor_nc, ngf, img_f, encoder_layers,
                                    decoder_layers)
        self.output_nc = self.decoder.output_nc

    def forward(self, x, z):
        return self.decoder(self.encoder(x, z), z)


class WarpingNet(nn.Module):
    """face_model.py:117-148."""

    def __init__(self, cfg: PIRenderConfig):
        super().__init__()
        self.hourglass = ADAINHourglass(cfg.image_nc, cfg.descriptor_nc, cfg.warp_base_nc,
                                        cfg.max_nc, cfg.warp_encoder_layer,
                                        cfg.warp_decoder_layer)
        nc = self.hourglass.output_nc
        self.flow_out = nn.Sequential(LayerNorm2d(nc), nn.LeakyReLU(0.1),
                                      nn.Conv2d(nc, 2, 7, 1, 3))

    def forward(self, image, descriptor):
        flow = self.flow_out(self.hourglass(image, descriptor))
        warped = warp_image(image, convert_flow_to_deformation(flow))
        return {"flow_field": flow, "warp_image": warped}


class FineADAINResBlock2d(nn.Module):
    def __init__(self, input_nc: int, feature_nc: int):
        super().__init__()
        self.conv1 = nn.Conv2d(input_nc, input_nc, 3, 1, 1)   # the dead branch's
        self.conv2 = nn.Conv2d(input_nc, input_nc, 3, 1, 1)
        self.norm1 = ADAIN(input_nc, feature_nc)              # the dead branch's
        self.norm2 = ADAIN(input_nc, feature_nc)

    def forward(self, x, z):
        return self.norm2(self.conv2(x), z) + x


class FineADAINResBlocks(nn.Module):
    def __init__(self, num_block: int, input_nc: int, feature_nc: int):
        super().__init__()
        self.num_block = num_block
        for i in range(num_block):
            setattr(self, f"res{i}", FineADAINResBlock2d(input_nc, feature_nc))

    def forward(self, x, z):
        for i in range(self.num_block):
            x = getattr(self, f"res{i}")(x, z)
        return x


class _ConvNormAct(nn.Module):
    """FirstBlock2d / DownBlock2d / UpBlock2d / Jump (base_function.py):
    `model` = conv, LayerNorm2d, LeakyReLU(0.1)."""

    def __init__(self, input_nc: int, output_nc: int, kernel: int):
        super().__init__()
        self.model = nn.Sequential(nn.Conv2d(input_nc, output_nc, kernel, 1, kernel // 2),
                                   LayerNorm2d(output_nc), nn.LeakyReLU(0.1))

    def forward(self, x):
        return self.model(x)


class FinalBlock2d(nn.Module):
    def __init__(self, input_nc: int, output_nc: int):
        super().__init__()
        self.model = nn.Sequential(nn.Conv2d(input_nc, output_nc, 7, 1, 3))

    def forward(self, x):
        return torch.tanh(self.model(x))


class FineEncoder(nn.Module):
    def __init__(self, image_nc, ngf, img_f, layers):
        super().__init__()
        self.layers = layers
        self.first = _ConvNormAct(image_nc, ngf, 7)
        for i in range(layers):
            setattr(self, f"down{i}", _ConvNormAct(min(ngf * 2 ** i, img_f),
                                                   min(ngf * 2 ** (i + 1), img_f), 3))

    def forward(self, x):
        x = self.first(x)
        outs = [x]
        for i in range(self.layers):
            x = F.avg_pool2d(getattr(self, f"down{i}")(x), 2)    # DownBlock2d's pool
            outs.append(x)
        return outs


class FineDecoder(nn.Module):
    def __init__(self, image_nc, feature_nc, ngf, img_f, layers, num_block):
        super().__init__()
        self.layers = layers
        for i in reversed(range(layers)):
            in_nc = min(ngf * 2 ** (i + 1), img_f)
            out_nc = min(ngf * 2 ** i, img_f)
            setattr(self, f"up{i}", _ConvNormAct(in_nc, out_nc, 3))
            setattr(self, f"res{i}", FineADAINResBlocks(num_block, in_nc, feature_nc))
            setattr(self, f"jump{i}", _ConvNormAct(out_nc, out_nc, 3))
        self.final = FinalBlock2d(out_nc, image_nc)

    def forward(self, feats, z):
        out = feats.pop()
        for i in reversed(range(self.layers)):
            out = getattr(self, f"res{i}")(out, z)
            out = getattr(self, f"up{i}")(F.interpolate(out, scale_factor=2))  # nearest
            out = getattr(self, f"jump{i}")(feats.pop()) + out
        return self.final(out)


class EditingNet(nn.Module):
    """face_model.py:150-182."""

    def __init__(self, cfg: PIRenderConfig):
        super().__init__()
        self.encoder = FineEncoder(cfg.image_nc * 2, cfg.edit_base_nc, cfg.max_nc,
                                   cfg.edit_layer)
        self.decoder = FineDecoder(cfg.image_nc, cfg.descriptor_nc, cfg.edit_base_nc,
                                   cfg.max_nc, cfg.edit_layer, cfg.edit_num_res_blocks)

    def forward(self, image, warped, descriptor):
        return self.decoder(self.encoder(torch.cat([image, warped], 1)), descriptor)


class FaceGenerator(nn.Module):
    """face_model.py:62-88: source image [B, 3, H, W] and a semantics
    window [B, 73, 27] -> {"flow_field", "warp_image", "fake_image"}
    (no "fake_image" when stage == "warp")."""

    def __init__(self, cfg: PIRenderConfig = PIRenderConfig()):
        super().__init__()
        self.cfg = cfg
        self.mapping_net = MappingNet(cfg.coeff_nc, cfg.descriptor_nc, cfg.mapping_layers)
        self.warpping_net = WarpingNet(cfg)
        self.editing_net = EditingNet(cfg)

    def forward(self, input_image, driving_source, stage=None):
        descriptor = self.mapping_net(driving_source)
        out = self.warpping_net(input_image, descriptor)
        if stage != "warp":
            out["fake_image"] = self.editing_net(input_image, out["warp_image"], descriptor)
        return out


@torch.no_grad()
def pirender_animation(source_image: torch.Tensor, target_semantics: torch.Tensor,
                       model: FaceGenerator) -> torch.Tensor:
    """pirender_animate.py:76-84: source_image [B, 3, H, W];
    target_semantics [B, F, 73, 27] -> frames [B, F, 3, H, W] in [-1, 1],
    a frame a call."""
    frames = [model(source_image, target_semantics[:, f])["fake_image"]
              for f in range(target_semantics.shape[1])]
    return torch.stack(frames, dim=1)
