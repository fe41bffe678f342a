"""Attention dispatch: one call site for the UNet, trunk, CLIP and VAE.

Counterpart of mofa_tpu/kernels/attention.py. A site goes to a CUDA kernel
where the JAX package sends it to a Pallas kernel on the TPU:

- spatial attention with Lq·Lk >= 576² -> `flash_attention`;
- every temporal self-attention in the spatial-major layout ->
  `short_attention_tmajor`.

Every other site (CLIP's 257 tokens, the small spatial sites) stays plain
PyTorch: matmul with fp32 logits and softmax. On CPU tensors the kernel
wrappers run their plain versions, so the math is the same either way.
"""

from __future__ import annotations

from mofa_tpu_torch.kernels.flash_attention import (attention_plain,
                                                    flash_attention)
from mofa_tpu_torch.kernels.short_attention import short_attention_tmajor

FLASH_MIN_SEQ = 576


def dot_product_attention(q, k, v):
    """[B, Lq, H, D] q, [B, Lk, H, D] k/v -> [B, Lq, H, D]; fp32 softmax."""
    if q.shape[1] * k.shape[1] >= FLASH_MIN_SEQ ** 2:
        return flash_attention(q, k, v)
    return attention_plain(q, k, v)


def temporal_attention_tmajor(q2, k2, v2, num_frames: int, heads: int):
    """[B*T, S, H*D] rows -> [B*T, S, H*D], attention over the frame axis
    per (batch, spatial token, head)."""
    return short_attention_tmajor(q2, k2, v2, num_frames, heads)
