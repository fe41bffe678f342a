"""Attention over short sequences (L <= 32): the temporal self-attention.

Two kernels of one CUDA body, `csrc/short_attention.cu`: each warp walks
its own (sequence, head) tasks with the next task's bf16 rows in flight
(16-byte `cp.async`, double buffer), runs QK^T and PV as a 32 x 32 x D
problem on tensor cores (`mma.sync`, `ldmatrix` fragments) with an exact
max-subtracted softmax in fp32 (the TPU default is a clamped fixed-max
softmax), and writes 16-byte rows. fp32 inputs run the same body on three
bf16 terms of each operand. Both are bound by device memory (one read of
q/k/v, one write); see the source note.

- `short_attention_tmajor`, counterpart of
  mofa_tpu/kernels/short_attention.py::short_attention_tmajor: q/k/v
  arrive as the projections' natural rows [B*T, S, H*D] (the spatial-major
  layout) and attention runs over the frame axis for every (batch,
  spatial token, head). Replaces the TPU's `_tmajor_fwd`.
- `short_attention`, counterpart of ::short_attention: q/k/v [B, L, H, D]
  (the classic temporal layout [B*S, T, H, D]), attention per (sequence,
  head). It is the tmajor layout with S = 1, so the same body serves it.
  Replaces the TPU's `_short_attn_fwd`, which packs 224 rows under a
  block-diagonal mask only to fill the MXU.

`short_attention_tmajor` has a gradient: on a CUDA tensor with grad
enabled it runs the kernel forward inside `_TmajorFunction`, whose
backward, `tmajor_backward`, is the JAX package's `_tmajor_bwd_rule`
(short_attention.py:306): the VJP of the plain version, recomputed.
`short_attention` has none yet (ROADMAP Queue 2): its kernel route raises
under grad.
"""
from __future__ import annotations

import torch

from mofa_tpu_torch.kernels import (check_no_grad, count_launch, math_dtype,
                                    use_kernel)
from mofa_tpu_torch.kernels.flash_attention import attention_plain

MAX_FRAMES = 32                  # one 32-row tensor-core tile
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the sites the JAX package sends to its short-sequence kernel
# (kernels/attention.py PACK_MAX_FOLDED, short_attention.py _TARGET_ROWS)
PACK_MAX_FOLDED = 160
TARGET_ROWS = 224


def _kernel_takes(length: int, d: int, dtype) -> bool:
    return 1 <= length <= MAX_FRAMES and d in HEAD_DIMS and dtype in _DTYPES


def short_attention_applicable(b: int, l_q: int, l_k: int, h: int, d: int,
                               dtype=torch.bfloat16) -> bool:
    """The dispatch gate of the short kernel: self-attention-shaped
    (Lq == Lk <= 32), L*H <= 160, B > 1, B*L >= 224 (the JAX package's
    gate without its TPU-backend test), and only what the kernel takes."""
    return (l_q == l_k and l_q * h <= PACK_MAX_FOLDED and b > 1
            and b * l_q >= TARGET_ROWS and _kernel_takes(l_q, d, dtype))


def tmajor_applicable(num_frames: int, hd: int, heads: int, dtype) -> bool:
    """The dispatch gate of the tmajor kernel: every temporal site it takes
    (all of them at SVD-XT widths, D = 64, T <= 32); the others (the micro
    test widths, D = 16) stay plain PyTorch on every device."""
    return hd % heads == 0 and _kernel_takes(num_frames, hd // heads, dtype)


def tmajor_plain(q2, k2, v2, num_frames: int, heads: int) -> torch.Tensor:
    """Plain version (mofa_tpu `_tmajor_ref`): transpose, per-(b, s, head)
    softmax attention with fp32 logits, transpose back."""
    bt, s, hd = q2.shape
    b = bt // num_frames
    d = hd // heads

    def to_bshd(x):                      # -> [B, S, H, T, D]
        return x.reshape(b, num_frames, s, heads, d).permute(0, 2, 3, 1, 4)

    q, k, v = to_bshd(q2), to_bshd(k2), to_bshd(v2)
    acc = math_dtype(q.dtype)
    logits = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * d ** -0.5
    probs = torch.softmax(logits, dim=-1).to(q2.dtype)
    out = torch.matmul(probs, v)                             # [B, S, H, T, D]
    return out.permute(0, 3, 1, 2, 4).reshape(bt, s, hd)


def kernel_operands(q, k, v, length: int, d: int):
    """q, k, v as the CUDA body takes them, made contiguous; ValueError for
    what it does not take: L outside 1..MAX_FRAMES, D outside HEAD_DIMS, a
    dtype other than fp32 / bf16 or not shared by all three, data not
    16-byte aligned (its 16-byte copies and row writes)."""
    if (not _kernel_takes(length, d, q.dtype) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"short-attention kernel takes L<={MAX_FRAMES}, D in "
                         f"{HEAD_DIMS}, one dtype of fp32/bf16; got L={length}, "
                         f"D={d}, {q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("short-attention kernel takes 16-byte aligned q/k/v")
    return q, k, v


def _launch(entry: str, q, k, v, *dims: int) -> torch.Tensor:
    from mofa_tpu_torch.kernels._build import launch
    out = torch.empty_like(q)
    launch(entry, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), *dims, _DTYPES[q.dtype])
    return out


def tmajor_backward(q2, k2, v2, g, num_frames: int, heads: int):
    """(dq2, dk2, dv2) at `g` = d out: the VJP of `tmajor_plain`,
    recomputed (the JAX package's `_tmajor_bwd_rule`)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (q2, k2, v2)]
        out = tmajor_plain(*leaves, num_frames, heads)
        return torch.autograd.grad(out, leaves, g)


def _launch_tmajor(q2, k2, v2, num_frames: int, heads: int) -> torch.Tensor:
    bt, s, hd = q2.shape
    if hd % heads:
        raise ValueError(f"tmajor kernel: H*D={hd} is not a multiple of H={heads}")
    d = hd // heads
    q2, k2, v2 = kernel_operands(q2, k2, v2, num_frames, d)
    out = _launch("mofa_tmajor_attention", q2, k2, v2, bt // num_frames,
                  num_frames, s, heads, d)
    count_launch("short_attention_tmajor")
    return out


class _TmajorFunction(torch.autograd.Function):
    """The kernel forward; `tmajor_backward` for the gradient."""

    @staticmethod
    def forward(ctx, q2, k2, v2, num_frames, heads):
        ctx.save_for_backward(q2, k2, v2)
        ctx.dims = (num_frames, heads)
        return _launch_tmajor(q2, k2, v2, num_frames, heads)

    @staticmethod
    def backward(ctx, g):
        return (*tmajor_backward(*ctx.saved_tensors, g, *ctx.dims), None, None)


def short_attention_tmajor(q2, k2, v2, num_frames: int,
                           heads: int) -> torch.Tensor:
    """[B*T, S, H*D] q/k/v -> [B*T, S, H*D]; attention over frames."""
    bt = q2.shape[0]
    if k2.shape != q2.shape or v2.shape != q2.shape or bt % num_frames:
        raise ValueError(f"bad tmajor shapes {tuple(q2.shape)}, T={num_frames}")
    if not use_kernel(q2, k2, v2):
        return tmajor_plain(q2, k2, v2, num_frames, heads)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q2, k2, v2)):
        return _TmajorFunction.apply(q2, k2, v2, num_frames, heads)
    return _launch_tmajor(q2, k2, v2, num_frames, heads)


def short_attention(q, k, v) -> torch.Tensor:
    """[B, L, H, D] q/k/v (L <= 32) -> [B, L, H, D]; fp32 softmax. The
    plain version is `attention_plain` (mofa_tpu `_short_attn_ref`, the
    same math as the naive attention)."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"bad short-attention shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if not use_kernel(q, k, v):
        return attention_plain(q, k, v)
    check_no_grad("short_attention", q, k, v)
    b, length, h, d = q.shape
    q, k, v = kernel_operands(q, k, v, length, d)
    out = _launch("mofa_short_attention", q, k, v, b, length, h, d)
    count_launch("short_attention")
    return out
