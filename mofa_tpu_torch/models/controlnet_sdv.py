"""ControlNetSDV trunk: the SVD-shaped ControlNet of the MOFA adapter (PyTorch).

Counterpart of mofa_tpu/models/controlnet_sdv.py (reference
`ControlNetSDVModel`): conv_in, time / added-time embeddings, the SVD
down blocks and mid block with the trunk's own head counts
(`cfg.controlnet_num_attention_heads`, (5, 10, 10, 20) at SVD-XT width,
which gives D = 128 at the /32 level), one 1x1 `controlnet_down_blocks`
conv per skip and a `controlnet_mid_block`, plus the 4-layer conditioning
embedding. Module names are the reference's, flat on the model. With
`remat_blocks = True` the down and mid blocks run under activation
checkpointing while grad is on (models/svd_unet.py). Inside a
frame_parallel context the trunk runs on this rank's frames, as the UNet
does, and returns this rank's rows of the residuals: the UNet reads them
under the same context.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mofa_tpu_torch.models.svd_unet import (SVDUNetConfig, build_down_blocks,
                                            build_embeddings, build_mid_block,
                                            embed_timestep_and_ids,
                                            frame_rows, frames_to_nchw,
                                            maybe_remat,
                                            nchw_to_nhwc, run_down_block)


class ControlNetConditioningEmbeddingSVD(nn.Module):
    """Image -> /8 latent-space embedding: conv_in, 3 x (conv, stride-2
    conv) with silu, conv_out."""

    def __init__(self, emb_channels: int,
                 block_out: Tuple[int, ...] = (16, 32, 96, 256),
                 cond_channels: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(cond_channels, block_out[0], 3, padding=1)
        blocks = []
        for i in range(len(block_out) - 1):
            blocks.append(nn.Conv2d(block_out[i], block_out[i], 3, padding=1))
            blocks.append(nn.Conv2d(block_out[i], block_out[i + 1], 3,
                                    padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(block_out[-1], emb_channels, 3, padding=1)

    def forward(self, x):
        x = F.silu(self.conv_in(x))
        for b in self.blocks:
            x = F.silu(b(x))
        return self.conv_out(x)


class ControlNetSDVModel(nn.Module):
    """The trunk; `FlowControlNet` (models/mofa_adapter.py) extends it."""

    def __init__(self, cfg: SVDUNetConfig = SVDUNetConfig(),
                 conditioning_embedding_out_channels=(16, 32, 96, 256)):
        super().__init__()
        self.cfg = cfg
        self.remat_blocks = False
        heads = cfg.controlnet_num_attention_heads
        build_embeddings(self, cfg)
        self.down_blocks = build_down_blocks(cfg, heads)
        self.mid_block = build_mid_block(cfg, heads)
        c0 = cfg.block_out_channels[0]
        convs = [nn.Conv2d(c0, c0, 1)]
        for i, ch in enumerate(cfg.block_out_channels):
            convs += [nn.Conv2d(ch, ch, 1) for _ in range(cfg.layers_per_block)]
            if i != len(cfg.block_out_channels) - 1:
                convs.append(nn.Conv2d(ch, ch, 1))
        self.controlnet_down_blocks = nn.ModuleList(convs)
        cm = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(cm, cm, 1)
        self.controlnet_cond_embedding = ControlNetConditioningEmbeddingSVD(
            c0, conditioning_embedding_out_channels)

    def trunk(self, sample, timestep, encoder_hidden_states, added_time_ids,
              inject_features: Optional[list] = None,
              conditioning_scale: float = 1.0):
        """sample [B, T, H, W, C_in]. inject_features: [B*T, h_s, w_s, c_s]
        tensors added at each scale (index 0 after conv_in, index i after
        down block i-1, the last one once more before the mid block).
        Returns (down residuals, mid residual), each [B*T, h, w, c]
        (inside frame_parallel, this rank's rows)."""
        cfg = self.cfg
        bsz, nf = sample.shape[:2]
        emb = embed_timestep_and_ids(self, cfg, timestep, added_time_ids, bsz,
                                     sample.dtype)
        emb = emb.repeat_interleave(nf, dim=0)
        ehs = encoder_hidden_states.repeat_interleave(nf, dim=0)
        indicator = torch.zeros(bsz, nf, dtype=sample.dtype,
                                device=sample.device)
        feats = (None if inject_features is None else
                 [frame_rows(f, bsz * nf).permute(0, 3, 1, 2).contiguous()
                  for f in inject_features])

        x = self.conv_in(frames_to_nchw(sample))
        if feats is not None:
            x = x + feats[0]
        samples = (x,)
        for i, block in enumerate(self.down_blocks):
            x, res = maybe_remat(self.remat_blocks, run_down_block, block, x,
                                 emb, ehs, indicator)
            if feats is not None:
                x = x + feats[min(i + 1, len(feats) - 1)]
            samples += res
        if feats is not None:
            x = x + feats[-1]
        x = maybe_remat(self.remat_blocks, self.mid_block, x, emb, ehs,
                        indicator)

        down = tuple(nchw_to_nhwc(zc(s) * conditioning_scale)
                     for s, zc in zip(samples, self.controlnet_down_blocks))
        mid = nchw_to_nhwc(self.controlnet_mid_block(x) * conditioning_scale)
        return down, mid
