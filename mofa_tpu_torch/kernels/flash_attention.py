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
reach device memory. fp32 inputs
(training) take the same tiled forward on split TF32: a pass writes q and
k as big / small TF32 planes and v transposed ([B·H, D, keys], the
K-major operand tf32 `wgmma` takes) as two planes; each product is
small * big + big * small + big * big with fp32 accumulation, about 22 of
fp32's 24 bits, P split in registers (`split_tf32_plain` has the
arithmetic). D in {64, 128}; ragged L is masked in the kernel.

The gradient (`flash_backward`) is the JAX package's `_flash_bwd`
(mofa_tpu/kernels/flash_attention.py:207) in stock PyTorch: fp32, one
query chunk at a time, so that only [B, H, chunk, Lk] logits are live.
The kernel writes no log-sum-exp, so each chunk recomputes its rows'
statistics from the logits it already holds. On a CUDA tensor with grad
enabled the wrapper runs the kernel forward inside `_FlashFunction`,
which saves q, k, v and the output for that backward.
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.kernels import count_launch, math_dtype, use_kernel

HEAD_DIMS = (64, 128)
BWD_CHUNK = 256                            # query rows a backward chunk recomputes
MAX_BATCH_HEADS = 65535                    # the grid's y dimension
KEY_PAD = 64                               # the fp32 route's Vt key padding (the C source's)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_kernel_takes(d: int, dtype, batch_heads: int) -> bool:
    """What the CUDA kernel takes: D in HEAD_DIMS, fp32 or bf16, at most
    MAX_BATCH_HEADS batch·heads."""
    return (d in HEAD_DIMS and dtype in _DTYPES
            and batch_heads <= MAX_BATCH_HEADS)


def kernel_operands(q, k, v):
    """q, k, v [B, L, H, D] as the CUDA kernel takes them, made contiguous;
    ValueError for what it does not take: D outside HEAD_DIMS, a dtype
    other than fp32 / bf16 or not shared by all three, more than 65535
    batch·heads (the grid's y), data not 16-byte aligned (the rule of TMA
    and of the 16-byte copies)."""
    b, _, h, d = q.shape
    if (not flash_kernel_takes(d, q.dtype, b * h) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"flash kernel takes D in {HEAD_DIMS}, one dtype of "
                         f"fp32/bf16 and B*H <= {MAX_BATCH_HEADS}; got D={d}, "
                         f"{q.dtype}, {k.dtype}, {v.dtype}, B*H={b * h}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash kernel takes 16-byte aligned q/k/v")
    return q, k, v


def attention_plain(q, k, v) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D]: fp32 logits and
    softmax (float64 for float64 inputs), probabilities cast to the input
    dtype before P·V (the JAX package's naive attention)."""
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))      # [B, H, L, D]
    acc = math_dtype(q.dtype)
    logits = torch.matmul(qh.to(acc), kh.to(acc).transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


def flash_backward(q, k, v, out, g, chunk: int = BWD_CHUNK):
    """(dq, dk, dv) of softmax(q k^T / sqrt(D)) v at `g` = d out, all
    [B, L, H, D]: `_flash_bwd`'s math in fp32, query chunk by query chunk
    (the probabilities recomputed from each chunk's logits and their
    log-sum-exp), each gradient cast back to its input's dtype."""
    scale = q.shape[-1] ** -0.5
    kf, vf = k.float(), v.float()
    dk = torch.zeros(kf.shape, device=k.device, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    dq = []
    for i in range(0, q.shape[1], chunk):
        qb, gb, ob = (x[:, i:i + chunk].float() for x in (q, g, out))
        logits = torch.einsum("bchd,bkhd->bhck", qb, kf) * scale
        p = torch.exp(logits - torch.logsumexp(logits, dim=-1, keepdim=True))
        dv += torch.einsum("bhck,bchd->bkhd", p, gb)
        dp = torch.einsum("bchd,bkhd->bhck", gb, vf)
        delta = (gb * ob).sum(-1).transpose(1, 2)               # [B, H, C]
        ds = p * (dp - delta[..., None])
        dq.append(torch.einsum("bhck,bkhd->bchd", ds, kf) * scale)
        dk += torch.einsum("bhck,bchd->bkhd", ds, qb) * scale
    return (torch.cat(dq, dim=1).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def f32_scratch_elems(b: int, lq: int, lk: int, h: int, d: int) -> int:
    """Floats of the fp32 route's scratch: the big and small planes of q
    and k, and of v transposed with its keys padded to KEY_PAD."""
    lp = -(-lk // KEY_PAD) * KEY_PAD
    return 2 * b * h * d * (lq + lk + lp)


def _launch(q, k, v) -> torch.Tensor:
    b, lq, h, d = q.shape
    q, k, v = kernel_operands(q, k, v)
    from mofa_tpu_torch.kernels._build import launch
    out = torch.empty_like(q)
    scratch = None
    if q.dtype == torch.float32:
        scratch = torch.empty(f32_scratch_elems(b, lq, k.shape[1], h, d),
                              device=q.device, dtype=torch.float32)
    launch("mofa_flash_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, lq,
           k.shape[1], h, d, _DTYPES[q.dtype])
    count_launch("flash_attention", (b, lq, h, d))
    return out


class _FlashFunction(torch.autograd.Function):
    """The kernel forward; `flash_backward` for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        out = _launch(q, k, v)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return flash_backward(*ctx.saved_tensors, g)


def flash_attention(q, k, v) -> torch.Tensor:
    """[B, Lq, H, D] q, [B, Lk, H, D] k/v -> [B, Lq, H, D]."""
    if (q.ndim != 4 or k.shape != v.shape or q.shape[0] != k.shape[0]
            or q.shape[2:] != k.shape[2:]):
        raise ValueError(f"bad shapes {tuple(q.shape)} {tuple(k.shape)}")
    if not use_kernel(q, k, v):
        return attention_plain(q, k, v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashFunction.apply(q, k, v)
    return _launch(q, k, v)
