"""Temporal self-attention in the spatial-major ("tmajor") layout.

Counterpart of mofa_tpu/kernels/short_attention.py::short_attention_tmajor.
q/k/v arrive as the projections' natural rows [B*T, S, H*D]; attention
runs over the frame axis for every (batch, spatial token, head). The CUDA
kernel `csrc/short_attention_tmajor.cu` replaces the TPU's `_tmajor_kernel`:
one warp per (b, s, head), the T x T logits in registers, an exact
max-subtracted softmax (the TPU default is a clamped fixed-max softmax).
It is bound by device memory (one read of q/k/v, one write); see the
source note. Forward only.
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.kernels import use_kernel

launches = 0
MAX_FRAMES = 32
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tmajor_plain(q2, k2, v2, num_frames: int, heads: int) -> torch.Tensor:
    """Plain version (mofa_tpu `_tmajor_ref`): transpose, per-(b, s, head)
    softmax attention with fp32 logits, transpose back."""
    bt, s, hd = q2.shape
    b = bt // num_frames
    d = hd // heads

    def to_bshd(x):                      # -> [B, S, H, T, D]
        return x.reshape(b, num_frames, s, heads, d).permute(0, 2, 3, 1, 4)

    q, k, v = to_bshd(q2), to_bshd(k2), to_bshd(v2)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    probs = torch.softmax(logits, dim=-1).to(q2.dtype)
    out = torch.matmul(probs, v)                             # [B, S, H, T, D]
    return out.permute(0, 3, 1, 2, 4).reshape(bt, s, hd)


def short_attention_tmajor(q2, k2, v2, num_frames: int,
                           heads: int) -> torch.Tensor:
    """[B*T, S, H*D] q/k/v -> [B*T, S, H*D]; attention over frames."""
    global launches
    bt, s, hd = q2.shape
    if k2.shape != q2.shape or v2.shape != q2.shape or bt % num_frames:
        raise ValueError(f"bad tmajor shapes {tuple(q2.shape)}, T={num_frames}")
    if not use_kernel(q2, k2, v2):
        return tmajor_plain(q2, k2, v2, num_frames, heads)
    d = hd // heads
    if (num_frames > MAX_FRAMES or d not in HEAD_DIMS or hd % heads
            or q2.dtype not in _DTYPES or k2.dtype != q2.dtype
            or v2.dtype != q2.dtype):
        raise ValueError(f"tmajor kernel takes T<={MAX_FRAMES}, D in "
                         f"{HEAD_DIMS}, fp32/bf16; got T={num_frames}, "
                         f"D={hd / heads}, {q2.dtype}")
    from mofa_tpu_torch.kernels._build import launch
    q2, k2, v2 = q2.contiguous(), k2.contiguous(), v2.contiguous()
    out = torch.empty_like(q2)
    launch("mofa_tmajor_attention", q2.device, q2.data_ptr(), k2.data_ptr(),
           v2.data_ptr(), out.data_ptr(), bt // num_frames, num_frames, s,
           heads, d, _DTYPES[q2.dtype])
    launches += 1
    return out
