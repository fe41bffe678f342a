"""MOFA-Adapters: `FlowControlNet` (trajectory) and `LdmkFlowControlNet`
(landmark / face) (PyTorch).

Counterparts of mofa_tpu/models/mofa_adapter.py (reference
svdxt_featureflow_forward_controlnet_s2d_fixcmp_norefine.py:181-384 and
MOFA-Video-Hybrid models/ldmk_ctrlnet.py:190-575). The warped multi-scale
feature stack depends only on (first frame, flow[, landmark frames]), not
on the latent or the timestep, so `encode_features` runs ONCE per video
and the denoise loop reuses it; all T-1 frames of a scale are splatted in
one softsplat call (kernels/softsplat.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.kernels.softsplat import softsplat
from mofa_tpu_torch.models.controlnet_sdv import (
    ControlNetConditioningEmbeddingSVD, ControlNetSDVModel)
from mofa_tpu_torch.models.hourglass import ForegroundMatting
from mofa_tpu_torch.models.svd_unet import SVDUNetConfig
from mofa_tpu_torch.ops.resize import resize_nhwc


class _EncoderLayer(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_in = nn.Conv2d(cin, cout, 3, padding=1, stride=2)


class FirstFrameEncoder(nn.Module):
    """Pyramid of the /8 cond embedding: stride-2 conv + silu per level,
    each level's output through a 1x1 zero conv. The landmark adapter's
    copy has no zero convs (`use_zeroconv=False`, ldmk_ctrlnet.py:145) and
    returns the raw conv features."""

    def __init__(self, cin: int, channels=(320, 640, 1280),
                 use_zeroconv: bool = True):
        super().__init__()
        self.encoders = nn.ModuleList([])
        for ch in channels:
            self.encoders.append(_EncoderLayer(cin, ch))
            cin = ch
        self.zeroconvs = (nn.ModuleList([nn.Conv2d(ch, ch, 1) for ch in channels])
                          if use_zeroconv else None)

    def forward(self, x):
        outs = []
        for i, enc in enumerate(self.encoders):
            x = F.silu(enc.conv_in(x))
            outs.append(x if self.zeroconvs is None else self.zeroconvs[i](x))
        return outs


def batched_warp(cond: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """cond [N, h, w, c], flows [N, T-1, h, w, 2] -> [N, T-1, h, w, c]
    ('avg' softsplat of the same features along every frame's flow; the
    splat reads each of the N feature maps once for its T-1 frames)."""
    n, tm1 = flows.shape[:2]
    h, w, c = cond.shape[1:]
    warped = softsplat(cond, flows.reshape(n * tm1, h, w, 2), None, "avg",
                       frames_per_source=tm1)
    return warped.reshape(n, tm1, h, w, c)


class FlowControlNet(ControlNetSDVModel):
    """Trajectory MOFA-Adapter: the ControlNetSDV trunk plus the first-frame
    flow encoder, whose warped features are injected at every scale."""

    def __init__(self, cfg: SVDUNetConfig = SVDUNetConfig(),
                 conditioning_embedding_out_channels=(16, 32, 96, 256)):
        super().__init__(cfg, conditioning_embedding_out_channels)
        c0 = cfg.block_out_channels[0]
        self.flow_encoder = FirstFrameEncoder(
            c0, (c0,) + tuple(cfg.block_out_channels[1:3]))

    def encode_features(self, controlnet_cond, controlnet_flow):
        """controlnet_cond [N, H, W, 3]; controlnet_flow [N, T-1, H, W, 2]
        (pixel resolution). Returns 4 tensors [N*T, h_s, w_s, c_s] at
        /8 ... /64: the feature itself for frame 0, its warps after."""
        cond = self.controlnet_cond_embedding(controlnet_cond.permute(0, 3, 1, 2))
        feats = [cond] + self.flow_encoder(cond)
        n, tm1, fh = controlnet_flow.shape[:3]
        inject = []
        for feat in feats:
            feat = feat.permute(0, 2, 3, 1)                      # [N, h, w, c]
            scale = fh // feat.shape[1]
            # nearest-downsample the flow to the feature's grid, / scale
            f = resize_nhwc(controlnet_flow, feat.shape[1:3], method="nearest") / scale
            warped = batched_warp(feat, f)
            full = torch.cat([feat[:, None], warped], dim=1)     # [N, T, h, w, c]
            inject.append(full.reshape((n * (tm1 + 1),) + full.shape[2:]))
        return inject

    def forward(self, sample, timestep, encoder_hidden_states, added_time_ids,
                controlnet_cond=None, controlnet_flow=None,
                conditioning_scale: float = 1.0,
                precomputed_features: Optional[list] = None):
        """Returns (down_block_res_samples, mid_block_res_sample)."""
        inject = precomputed_features
        if inject is None:
            inject = self.encode_features(controlnet_cond, controlnet_flow)
        return self.trunk(sample, timestep, encoder_hidden_states,
                          added_time_ids, inject_features=inject,
                          conditioning_scale=conditioning_scale)


MATTING_SCALES = (8, 16, 32, 64)


class LdmkFlowControlNet(ControlNetSDVModel):
    """Landmark / face MOFA-Adapter: the trunk, the first-frame flow encoder
    without zero convs, a second conditioning embedding for the rasterised
    landmark frames, and occlusion matting + a 1x1 zero-out conv per scale
    (`occlusions` / `zero_outs`, keyed by the scale as in the reference)."""

    def __init__(self, cfg: SVDUNetConfig = SVDUNetConfig(),
                 conditioning_embedding_out_channels=(16, 32, 96, 256)):
        super().__init__(cfg, conditioning_embedding_out_channels)
        c0 = cfg.block_out_channels[0]
        self.controlnet_ldmk_embedding = ControlNetConditioningEmbeddingSVD(
            c0, (16, 32, 64, 128))
        self.flow_encoder = FirstFrameEncoder(
            c0, (c0,) + tuple(cfg.block_out_channels[1:3]), use_zeroconv=False)
        chans = dict(zip(MATTING_SCALES, (c0, c0) + tuple(cfg.block_out_channels[1:3])))
        self.occlusions = nn.ModuleDict(
            {str(s): ForegroundMatting(chans[s]) for s in MATTING_SCALES})
        self.zero_outs = nn.ModuleDict(
            {str(s): nn.Conv2d(chans[s], chans[s], 1) for s in MATTING_SCALES})

    def encode_features(self, controlnet_cond, controlnet_flow, landmarks):
        """controlnet_cond [N, H, W, 3]; controlnet_flow [N, T-1, H, W, 2]
        (pixels); landmarks [N, T, H, W, 3] rasterised landmark frames.
        Returns (4 inject tensors [N*T, h_s, w_s, c_s] at /8 ... /64, and
        the occlusion masks [N, T-1, h_s, w_s, 1] of each scale)."""
        c0 = self.cfg.block_out_channels[0]
        cond = self.controlnet_cond_embedding(controlnet_cond.permute(0, 3, 1, 2))
        feats = [cond] + self.flow_encoder(cond)
        n, tm1, fh = controlnet_flow.shape[:3]
        t = landmarks.shape[1]
        lm = self.controlnet_ldmk_embedding(
            landmarks.reshape((n * t,) + landmarks.shape[2:]).permute(0, 3, 1, 2))
        lm = lm.permute(0, 2, 3, 1)                              # [N*T, H/8, W/8, c0]
        # the landmark embedding joins the c0-channel features whose height
        # matches it, at /8 or nearest-resized by 1/2 and 1/4
        # (ldmk_ctrlnet.py:474,501-504): keyed by height, as the reference
        ldmk_by_size = {lm.shape[1]: lm}
        for s in (2, 4):
            scaled = resize_nhwc(lm, (lm.shape[1] // s, lm.shape[2] // s),
                                 method="nearest")
            ldmk_by_size[scaled.shape[1]] = scaled
        inject, occ_masks = [], []
        for feat in feats:
            feat = feat.permute(0, 2, 3, 1)                      # [N, h, w, c]
            h, w, c = feat.shape[1:]
            scale = fh // h
            f = resize_nhwc(controlnet_flow, (h, w), method="nearest") / scale
            warped = batched_warp(feat, f).reshape(n * tm1, h, w, c)
            ref = feat[:, None].expand(n, tm1, h, w, c).reshape(n * tm1, h, w, c)
            nchw = lambda x: x.permute(0, 3, 1, 2)
            matted, mask = self.occlusions[str(scale)](
                nchw(ref), nchw(f.reshape(n * tm1, h, w, 2)), nchw(warped))
            matted = self.zero_outs[str(scale)](matted).permute(0, 2, 3, 1)
            occ_masks.append(mask.permute(0, 2, 3, 1).reshape(n, tm1, h, w, 1))
            full = torch.cat([feat[:, None], matted.reshape(n, tm1, h, w, c)], dim=1)
            full = full.reshape(n * t, h, w, c)
            if c == c0 and h in ldmk_by_size:
                full = full + ldmk_by_size[h]
            inject.append(full)
        return inject, occ_masks

    def forward(self, sample, timestep, encoder_hidden_states, added_time_ids,
                controlnet_cond=None, controlnet_flow=None, landmarks=None,
                conditioning_scale: float = 1.0,
                precomputed_features: Optional[list] = None):
        """Returns (down_block_res_samples, mid_block_res_sample)."""
        inject = precomputed_features
        if inject is None:
            inject, _ = self.encode_features(controlnet_cond, controlnet_flow,
                                             landmarks)
        return self.trunk(sample, timestep, encoder_hidden_states,
                          added_time_ids, inject_features=inject,
                          conditioning_scale=conditioning_scale)
