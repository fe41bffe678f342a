"""Flash attention forward over [B, L, H, D].

Counterpart of mofa_tpu/kernels/flash_attention.py::flash_attention. The
CUDA kernel `csrc/flash_attention.cu` replaces the TPU's
`_flash_fwd_kernel`: one block per (batch·head, 64-row query tile), a loop
over 64-key K/V tiles double-buffered in shared memory, `mma.sync` tensor
cores for bf16 (bf16 in, fp32 accumulate) with the softmax on the
accumulator registers, and the exact online-max softmax (the TPU default
is the clamped fixed-max softmax, exact only for logits <= 69). It is
bound by tensor-core issue and the softmax's exp2; the [L, L] logits never
reach device memory. D in {64, 128}; ragged L is masked in the kernel.
Forward only.
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.kernels import use_kernel

launches = 0
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    global launches
    if (q.ndim != 4 or k.shape != v.shape or q.shape[0] != k.shape[0]
            or q.shape[2:] != k.shape[2:]):
        raise ValueError(f"bad shapes {tuple(q.shape)} {tuple(k.shape)}")
    if not use_kernel(q, k, v):
        return attention_plain(q, k, v)
    b, lq, h, d = q.shape
    if (d not in HEAD_DIMS or q.dtype not in _DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"flash kernel takes D in {HEAD_DIMS} and fp32/bf16;"
                         f" got D={d}, {q.dtype}")
    from mofa_tpu_torch.kernels._build import launch
    q, k, v = (x.contiguous() for x in (q, k, v))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        q, k, v = (x.clone() for x in (q, k, v))
    out = torch.empty_like(q)
    launch("mofa_flash_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), b, lq, k.shape[1], h, d, _DTYPES[q.dtype])
    launches += 1
    return out
