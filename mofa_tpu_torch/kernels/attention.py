"""Attention dispatch: one call site for the UNet, trunk, CLIP and VAE.

Counterpart of mofa_tpu/kernels/attention.py. A site goes to a CUDA kernel
where the JAX package sends it to a Pallas kernel on the TPU:

- short self-attention that `short_attention_applicable` admits (Lq == Lk
  <= 32, L*H <= 160, B > 1, B*L >= 224: the temporal sites of the classic
  layout) -> `short_attention`;
- spatial attention with Lq·Lk >= 576² -> `flash_attention`;
- every temporal self-attention in the spatial-major layout ->
  `short_attention_tmajor`.

Each gate admits only what its kernel takes (D of 64 or 128, T <= 32,
flash at most 65535 batch·heads), so
no site reaches a kernel that would raise. Every other site (CLIP's 257
tokens, the small spatial sites, the short sites the gate refuses, the
micro test widths) stays plain PyTorch: matmul with fp32 logits and
softmax. On CPU tensors the kernel wrappers run their plain versions, so
the math is the same either way.
"""

from __future__ import annotations

from mofa_tpu_torch.kernels.flash_attention import (attention_plain,
                                                    flash_attention,
                                                    flash_kernel_takes)
from mofa_tpu_torch.kernels.short_attention import (short_attention,
                                                    short_attention_applicable,
                                                    short_attention_tmajor,
                                                    tmajor_applicable,
                                                    tmajor_plain)

FLASH_MIN_SEQ = 576


def dot_product_attention(q, k, v):
    """[B, Lq, H, D] q, [B, Lk, H, D] k/v -> [B, Lq, H, D]; fp32 softmax."""
    b, lq, h, d = q.shape
    if short_attention_applicable(b, lq, k.shape[1], h, d, q.dtype):
        return short_attention(q, k, v)
    if (lq * k.shape[1] >= FLASH_MIN_SEQ ** 2
            and flash_kernel_takes(d, q.dtype, b * h)):
        return flash_attention(q, k, v)
    return attention_plain(q, k, v)


def temporal_attention_tmajor(q2, k2, v2, num_frames: int, heads: int):
    """[B*T, S, H*D] rows -> [B*T, S, H*D], attention over the frame axis
    per (batch, spatial token, head)."""
    if tmajor_applicable(num_frames, q2.shape[-1], heads, q2.dtype):
        return short_attention_tmajor(q2, k2, v2, num_frames, heads)
    return tmajor_plain(q2, k2, v2, num_frames, heads)
