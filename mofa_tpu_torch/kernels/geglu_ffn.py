"""The GEGLU feed-forward kernels: fused LN -> GEGLU FF -> residual, and the FF alone.

Counterpart of mofa_tpu/kernels/geglu_ffn.py:

- `ln_geglu_ffn(..., variant=)`: x + FF(LN(x)), with the JAX package's
  `_ln_ffn_fwd(variant=...)` names. "plain" (the default, and the only one
  a model calls) replaces `_ln_ffn_kernel`; "tanh" is that kernel with the
  tanh-form gelu; "ilv" replaces `_ln_ffn_kernel_ilv` (row sub-tiles that
  never wait on one another); "pipe" replaces `_ln_ffn_kernel_pipe` (GEMM1
  of the next inner chunk issued before the gate and GEMM2 of this one).
- `geglu_ffn`: FF(x) without LN or residual; replaces `_ffn_kernel`.

All five run one CUDA source, `csrc/ln_geglu_ffn.cu`: a 64-row tile in
shared memory, the 4C inner axis walked in chunks (GEMM1 -> gelu gate in
fp32 -> GEMM2 into fp32 register accumulators) on `mma.sync` tensor cores,
weight tiles streamed from L2 by `cp.async`. The [rows, 8C] intermediate
never reaches device memory. They are bound by tensor-core issue and the
L2 weight reads; the source note describes each schedule. Weights use
torch Linear layouts: w0 [8C, C], w2 [C, 4C]. The "plain" kernel also has
an fp32 path; the others take bf16 only and raise on fp32 tensors on a
card. Forward only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mofa_tpu_torch.kernels import count_launch, use_kernel

LN_EPS = 1e-5
MIN_FUSED_ROWS = 4096
KERNEL_DIMS = (320, 640)
VARIANTS = ("plain", "ilv", "pipe", "tanh")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fused_ffn_applicable(rows: int, dim: int, dim_out: int) -> bool:
    """The sites the JAX package sends to its Pallas kernel on the TPU
    (C <= 640, geglu_ffn.py:38-49), without the TPU-only block-divisibility
    rule, and only at the widths the kernel is built for (SVD-XT's 320 and
    640); other widths stay plain PyTorch on every device."""
    return dim in KERNEL_DIMS and dim_out == dim and rows >= MIN_FUSED_ROWS


def ffn_plain(x, w0, b0, w2, b2) -> torch.Tensor:
    """Plain version (mofa_tpu `_ffn_ref`): GEGLU FF in x's dtype."""
    a, g = F.linear(x, w0.to(x.dtype), b0.to(x.dtype)).chunk(2, dim=-1)
    return F.linear(a * F.gelu(g), w2.to(x.dtype), b2.to(x.dtype))


def ln_ffn_plain(x, ln_weight, ln_bias, w0, b0, w2, b2,
                 approximate: str = "none") -> torch.Tensor:
    """Plain version (mofa_tpu `_ln_ffn_ref`): LayerNorm with fp32 stats
    (E[x^2] - mean^2), cast to x's dtype, GEGLU FF in x's dtype (gelu
    `approximate` "none", or "tanh" for the tanh variant), residual."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    h = ((xf - mean) * torch.rsqrt(var + LN_EPS) * ln_weight.float()
         + ln_bias.float()).to(x.dtype)
    a, g = F.linear(h, w0.to(x.dtype), b0.to(x.dtype)).chunk(2, dim=-1)
    act = a * F.gelu(g, approximate=approximate)
    return F.linear(act, w2.to(x.dtype), b2.to(x.dtype)) + x


def _check_weights(c, w0, w2):
    if w0.shape != (8 * c, c) or w2.shape != (c, 4 * c):
        raise ValueError(f"bad FF weights {tuple(w0.shape)} {tuple(w2.shape)}")


def _launch(name, entry, x, ln, weights, dtypes, with_dtype):
    """Launch C entry `entry` on x [..., C] with the LN params `ln` (or
    none) and (w0, b0, w2, b2) cast to x's dtype; returns out like x."""
    c, dt = x.shape[-1], x.dtype
    if c not in KERNEL_DIMS or dt not in dtypes:
        raise ValueError(f"{name} kernel takes C in {KERNEL_DIMS} and "
                         f"{[str(d) for d in dtypes]}; got C={c}, {dt}")
    from mofa_tpu_torch.kernels._build import launch
    x2 = x.reshape(-1, c).contiguous()
    args = ([x2] + [p.float().contiguous() for p in ln]
            + [w.to(dt).contiguous() for w in weights])
    args = [a.clone() if a.data_ptr() % 32 else a for a in args]
    out = torch.empty_like(args[0])
    tail = (x2.shape[0], c) + ((_DTYPES[dt],) if with_dtype else ())
    launch(entry, x.device, *[a.data_ptr() for a in args], out.data_ptr(), *tail)
    count_launch(name)
    return out.reshape(x.shape)


def ln_geglu_ffn(x, ln_weight, ln_bias, w0, b0, w2, b2,
                 variant: str = "plain") -> torch.Tensor:
    """x [..., C] -> x + FF(LN(x)); LN params [C]; w0 [8C, C], b0 [8C],
    w2 [C, 4C], b2 [C] (cast to x's dtype, LN params to fp32). `variant`
    picks the kernel's schedule, as the JAX package's `_ln_ffn_fwd` does:
    "plain", "ilv" and "pipe" compute one function; "tanh" uses the
    tanh-form gelu."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    _check_weights(x.shape[-1], w0, w2)
    if not use_kernel(x, ln_weight, ln_bias, w0, b0, w2, b2):
        return ln_ffn_plain(x, ln_weight, ln_bias, w0, b0, w2, b2,
                            "tanh" if variant == "tanh" else "none")
    if variant == "plain":
        return _launch("ln_geglu_ffn", "mofa_ln_geglu_ffn", x,
                       (ln_weight, ln_bias), (w0, b0, w2, b2), _DTYPES, True)
    return _launch(f"ln_geglu_ffn_{variant}", f"mofa_ln_geglu_ffn_{variant}", x,
                   (ln_weight, ln_bias), (w0, b0, w2, b2), (torch.bfloat16,),
                   False)


def geglu_ffn(x, w0, b0, w2, b2) -> torch.Tensor:
    """x [..., C] -> FF(x) (no LayerNorm, no residual); weights as in
    `ln_geglu_ffn`. The kernel takes bf16 only."""
    _check_weights(x.shape[-1], w0, w2)
    if not use_kernel(x, w0, b0, w2, b2):
        return ffn_plain(x, w0, b0, w2, b2)
    return _launch("geglu_ffn", "mofa_geglu_ffn", x, (), (w0, b0, w2, b2),
                   (torch.bfloat16,), False)
