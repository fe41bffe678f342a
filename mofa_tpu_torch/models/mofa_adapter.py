"""MOFA-Adapters: `FlowControlNet` (trajectory) and `LdmkFlowControlNet`
(landmark / face) (PyTorch).

Counterparts of mofa_tpu/models/mofa_adapter.py (reference
svdxt_featureflow_forward_controlnet_s2d_fixcmp_norefine.py:181-384 and
MOFA-Video-Hybrid models/ldmk_ctrlnet.py:190-575). The warped multi-scale
feature stack depends only on (first frame, flow[, landmark frames]), not
on the latent or the timestep, so `encode_features` runs ONCE per video
and the denoise loop reuses it; all T-1 frames of a scale are splatted in
one softsplat call (kernels/softsplat.py).

`encode_features(..., rows=...)` computes only the given rows of the
[N*T, ...] stack (frame-parallel inference: a rank's frames), warping
along those frames' flows alone; one splat call per run of a source's
frames unless every source takes as many.
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


def row_plan(n: int, t: int, rows=None) -> list[tuple[int, list[int]]]:
    """The rows of an [n*t, ...] frame stack (row ids; None: all) as
    [(source n, its ascending frames t)], in row order."""
    if rows is None:
        return [(i, list(range(t))) for i in range(n)]
    plan: list[tuple[int, list[int]]] = []
    for r in rows:
        r = int(r)
        if not 0 <= r < n * t:
            raise ValueError(f"row {r} is outside [0, {n * t})")
        if not plan or plan[-1][0] != r // t or plan[-1][1][-1] >= r % t:
            plan.append((r // t, []))
        plan[-1][1].append(r % t)
    return plan


def warp_rows(feat: torch.Tensor, flows: torch.Tensor, plan) -> torch.Tensor:
    """feat [N, h, w, c], flows [N, T-1, h, w, 2] -> the warps of the
    planned frames t > 0, [sum of their counts, h, w, c], in plan order
    ('avg' softsplat of source n along flows[n, t-1]). Sources that take
    the same number of frames in a run of consecutive n share one call; a
    run planned twice is warped once."""
    jobs = [(i, [f - 1 for f in ts if f > 0]) for i, ts in plan]
    jobs = [(i, ks) for i, ks in jobs if ks]
    if not jobs:
        return feat.new_empty((0,) + feat.shape[1:])
    ns = [i for i, _ in jobs]
    k = len(jobs[0][1])
    if (all(len(ks) == k for _, ks in jobs)
            and ns == list(range(ns[0], ns[0] + len(ns)))):
        if all(ks == list(range(k)) for _, ks in jobs) and k == flows.shape[1]:
            f = flows[ns[0]:ns[-1] + 1]
        else:
            f = torch.stack([flows[i, ks] for i, ks in jobs])
        return batched_warp(feat[ns[0]:ns[-1] + 1], f).reshape(
            (-1,) + feat.shape[1:])
    done: dict = {}
    for i, ks in jobs:
        if (i, tuple(ks)) not in done:
            done[i, tuple(ks)] = batched_warp(feat[i:i + 1], flows[i:i + 1, ks])[0]
    return torch.cat([done[i, tuple(ks)] for i, ks in jobs])


def batched_warp(cond: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """cond [N, h, w, c], flows [N, T-1, h, w, 2] -> [N, T-1, h, w, c]
    ('avg' softsplat of the same features along every frame's flow; the
    splat reads each of the N feature maps once for its T-1 frames)."""
    n, tm1 = flows.shape[:2]
    h, w, c = cond.shape[1:]
    warped = softsplat(cond, flows.reshape(n * tm1, h, w, 2), None, "avg",
                       frames_per_source=tm1)
    return warped.reshape(n, tm1, h, w, c)


def _assemble(feat: torch.Tensor, warped: torch.Tensor, plan) -> torch.Tensor:
    """The planned rows: feat[n] for frame 0, the next warp for the rest."""
    if len(plan) == feat.shape[0] and warped.shape[0] == sum(
            len(ts) - 1 for _, ts in plan) and all(ts[0] == 0 for _, ts in plan):
        k = warped.shape[0] // len(plan)
        if all(len(ts) == k + 1 for _, ts in plan):       # every source whole
            full = torch.cat([feat[:, None],
                              warped.reshape((len(plan), k) + feat.shape[1:])], 1)
            return full.reshape((-1,) + feat.shape[1:])
    pieces, at = [], 0
    for i, ts in plan:
        if ts[0] == 0:
            pieces.append(feat[i:i + 1])
        k = len(ts) - (ts[0] == 0)
        pieces.append(warped[at:at + k])
        at += k
    return torch.cat(pieces)


class FlowControlNet(ControlNetSDVModel):
    """Trajectory MOFA-Adapter: the ControlNetSDV trunk plus the first-frame
    flow encoder, whose warped features are injected at every scale."""

    def __init__(self, cfg: SVDUNetConfig = SVDUNetConfig(),
                 conditioning_embedding_out_channels=(16, 32, 96, 256)):
        super().__init__(cfg, conditioning_embedding_out_channels)
        c0 = cfg.block_out_channels[0]
        self.flow_encoder = FirstFrameEncoder(
            c0, (c0,) + tuple(cfg.block_out_channels[1:3]))

    def encode_features(self, controlnet_cond, controlnet_flow, rows=None):
        """controlnet_cond [N, H, W, 3]; controlnet_flow [N, T-1, H, W, 2]
        (pixel resolution). Returns 4 tensors [N*T, h_s, w_s, c_s] at
        /8 ... /64: the feature itself for frame 0, its warps after.
        rows: ascending row ids of the N*T stack to compute (all when
        None); the tensors then hold those rows."""
        cond = self.controlnet_cond_embedding(controlnet_cond.permute(0, 3, 1, 2))
        feats = [cond] + self.flow_encoder(cond)
        n, tm1, fh = controlnet_flow.shape[:3]
        plan = row_plan(n, tm1 + 1, rows)
        inject = []
        for feat in feats:
            feat = feat.permute(0, 2, 3, 1)                      # [N, h, w, c]
            scale = fh // feat.shape[1]
            # nearest-downsample the flow to the feature's grid, / scale
            f = resize_nhwc(controlnet_flow, feat.shape[1:3], method="nearest") / scale
            inject.append(_assemble(feat, warp_rows(feat, f, plan), plan))
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

    def encode_features(self, controlnet_cond, controlnet_flow, landmarks,
                        rows=None):
        """controlnet_cond [N, H, W, 3]; controlnet_flow [N, T-1, H, W, 2]
        (pixels); landmarks [N, T, H, W, 3] rasterised landmark frames.
        Returns (4 inject tensors [N*T, h_s, w_s, c_s] at /8 ... /64, and
        the occlusion masks [N, T-1, h_s, w_s, 1] of each scale). rows: as
        in FlowControlNet.encode_features; the masks are then those of the
        rows' frames t > 0, [count, h_s, w_s, 1]."""
        c0 = self.cfg.block_out_channels[0]
        cond = self.controlnet_cond_embedding(controlnet_cond.permute(0, 3, 1, 2))
        feats = [cond] + self.flow_encoder(cond)
        n, tm1, fh = controlnet_flow.shape[:3]
        t = landmarks.shape[1]
        plan = row_plan(n, t, rows)
        lm_frames = landmarks.reshape((n * t,) + landmarks.shape[2:])
        if rows is not None:
            lm_frames = lm_frames[torch.as_tensor(
                [i * t + f for i, ts in plan for f in ts],
                device=lm_frames.device)]
        warp_n = torch.as_tensor([i for i, ts in plan for f in ts if f > 0],
                                 device=cond.device, dtype=torch.long)
        warp_t = torch.as_tensor([f - 1 for _, ts in plan for f in ts if f > 0],
                                 device=cond.device, dtype=torch.long)
        lm = self.controlnet_ldmk_embedding(lm_frames.permute(0, 3, 1, 2))
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
            warped = warp_rows(feat, f, plan)
            ref, f = ((feat[:, None].expand(n, tm1, h, w, c).reshape(n * tm1, h, w, c),
                       f.reshape(n * tm1, h, w, 2)) if rows is None else
                      (feat[warp_n], f[warp_n, warp_t]))
            nchw = lambda x: x.permute(0, 3, 1, 2)
            matted, mask = self.occlusions[str(scale)](
                nchw(ref), nchw(f), nchw(warped))
            matted = self.zero_outs[str(scale)](matted).permute(0, 2, 3, 1)
            mask = mask.permute(0, 2, 3, 1)
            occ_masks.append(mask.reshape(n, tm1, h, w, 1) if rows is None
                             else mask)
            full = _assemble(feat, matted, plan)
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
