"""Fused LayerNorm -> GEGLU feed-forward -> residual.

Counterpart of mofa_tpu/kernels/geglu_ffn.py::ln_geglu_ffn (variant
"plain"). The CUDA kernel `csrc/ln_geglu_ffn.cu` replaces the TPU's
`_ln_ffn_kernel`: a 64-row tile is normalised into shared memory, then the
4C inner axis is walked in chunks (GEMM1 -> exact erf gelu gate -> GEMM2
into fp32 register accumulators), with the weight tiles double-buffered
from L2 by `cp.async` and `mma.sync` tensor cores for bf16. The [rows, 8C]
intermediate never reaches device memory. It is bound by tensor-core issue
and the L2 weight reads; see the source note. Weights use torch Linear
layouts: w0 [8C, C], w2 [C, 4C]. Forward only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mofa_tpu_torch.kernels import use_kernel

launches = 0
LN_EPS = 1e-5
MIN_FUSED_ROWS = 4096
KERNEL_DIMS = (320, 640)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_ffn_applicable(rows: int, dim: int, dim_out: int) -> bool:
    """The sites the JAX package sends to its Pallas kernel on the TPU
    (C <= 640, geglu_ffn.py:38-49), without the TPU-only block-divisibility
    rule, and only at the widths the kernel is built for (SVD-XT's 320 and
    640); other widths stay plain PyTorch on every device."""
    return dim in KERNEL_DIMS and dim_out == dim and rows >= MIN_FUSED_ROWS


def ln_ffn_plain(x, ln_weight, ln_bias, w0, b0, w2, b2) -> torch.Tensor:
    """Plain version (mofa_tpu `_ln_ffn_ref`): LayerNorm with fp32 stats
    (E[x^2] - mean^2), cast to x's dtype, GEGLU FF in x's dtype, residual."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    h = ((xf - mean) * torch.rsqrt(var + LN_EPS) * ln_weight.float()
         + ln_bias.float()).to(x.dtype)
    a, g = F.linear(h, w0.to(x.dtype), b0.to(x.dtype)).chunk(2, dim=-1)
    act = a * F.gelu(g)
    return F.linear(act, w2.to(x.dtype), b2.to(x.dtype)) + x


def ln_geglu_ffn(x, ln_weight, ln_bias, w0, b0, w2, b2) -> torch.Tensor:
    """x [..., C] -> x + FF(LN(x)); LN params [C]; w0 [8C, C], b0 [8C],
    w2 [C, 4C], b2 [C] (cast to x's dtype, LN params to fp32)."""
    global launches
    c = x.shape[-1]
    if w0.shape != (8 * c, c) or w2.shape != (c, 4 * c):
        raise ValueError(f"bad FF weights {tuple(w0.shape)} {tuple(w2.shape)}")
    if not use_kernel(x, ln_weight, ln_bias, w0, b0, w2, b2):
        return ln_ffn_plain(x, ln_weight, ln_bias, w0, b0, w2, b2)
    if c not in KERNEL_DIMS or x.dtype not in _DTYPES:
        raise ValueError(f"ln_geglu_ffn kernel takes C in {KERNEL_DIMS} and "
                         f"fp32/bf16; got C={c}, {x.dtype}")
    from mofa_tpu_torch.kernels._build import launch
    dt = x.dtype
    x2 = x.reshape(-1, c).contiguous()
    args = [x2, ln_weight.float().contiguous(), ln_bias.float().contiguous(),
            w0.to(dt).contiguous(), b0.to(dt).contiguous(),
            w2.to(dt).contiguous(), b2.to(dt).contiguous()]
    args = [a.clone() if a.data_ptr() % 32 else a for a in args]
    out = torch.empty_like(args[0])
    launch("mofa_ln_geglu_ffn", x.device, *[a.data_ptr() for a in args],
           out.data_ptr(), x2.shape[0], c, _DTYPES[dt])
    launches += 1
    return out.reshape(x.shape)
