"""Flash attention forward over [B, L, H, D].

Counterpart of mofa_tpu/kernels/flash_attention.py::flash_attention. The
CUDA kernel `csrc/flash_attention.cu` replaces the TPU's
`_flash_fwd_kernel`. bf16, FlashAttention-3 in shape: one block per
(batch·head, 64 rows per consumer warpgroup: three at D = 64, two at
D = 128); a producer warpgroup streams K/V tiles of 128 keys with TMA into
a ring of shared-memory stages behind mbarriers; the consumers run S = QK^T
and O += PV on `wgmma` (P from registers) with the exact online-max softmax
on the accumulator fragments (the TPU default is the clamped fixed-max
softmax, exact only for logits <= 69), each pipelined one tile deep and
taking turns to issue, so the softmax overlaps the products. It is bound
by tensor-core operations and the softmax's exp2; the [L, L] logits never
reach device memory. fp32
inputs take a plain-FMA correctness kernel. D in {64, 128}; ragged L is
masked in the kernel. Forward only.
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.kernels import count_launch, use_kernel

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_kernel_takes(d: int, dtype) -> bool:
    """What the CUDA kernel takes: D in HEAD_DIMS, fp32 or bf16."""
    return d in HEAD_DIMS and dtype in _DTYPES


def kernel_operands(q, k, v):
    """q, k, v [B, L, H, D] as the CUDA kernel takes them, made contiguous;
    ValueError for what it does not take: D outside HEAD_DIMS, a dtype
    other than fp32 / bf16 or not shared by all three, more than 65535
    batch·heads (the grid's y), data not 16-byte aligned (the rule of TMA
    and of the 16-byte copies)."""
    b, _, h, d = q.shape
    if (not flash_kernel_takes(d, q.dtype) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"flash kernel takes D in {HEAD_DIMS} and one dtype of "
                         f"fp32/bf16; got D={d}, {q.dtype}, {k.dtype}, {v.dtype}")
    if b * h > 65535:
        raise ValueError(f"flash kernel takes B*H <= 65535; got {b * h}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash kernel takes 16-byte aligned q/k/v")
    return q, k, v


def attention_plain(q, k, v) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D]: fp32 logits and
    softmax, probabilities cast to the input dtype before P·V (the JAX
    package's naive attention)."""
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))      # [B, H, L, D]
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


def flash_attention(q, k, v) -> torch.Tensor:
    """[B, Lq, H, D] q, [B, Lk, H, D] k/v -> [B, Lq, H, D]."""
    if (q.ndim != 4 or k.shape != v.shape or q.shape[0] != k.shape[0]
            or q.shape[2:] != k.shape[2:]):
        raise ValueError(f"bad shapes {tuple(q.shape)} {tuple(k.shape)}")
    if not use_kernel(q, k, v):
        return attention_plain(q, k, v)
    b, lq, h, d = q.shape
    q, k, v = kernel_operands(q, k, v)
    from mofa_tpu_torch.kernels._build import launch
    out = torch.empty_like(q)
    launch("mofa_flash_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), b, lq, k.shape[1], h, d, _DTYPES[q.dtype])
    count_launch("flash_attention")
    return out
