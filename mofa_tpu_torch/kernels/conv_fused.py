"""Fused GroupNorm-apply + SiLU + convolution, channel-last.

Counterpart of mofa_tpu/kernels/conv_fused.py:

    out = conv(silu(x*a + b)) + bias [+ temb_bias] [+ residual]

with the GroupNorm affine folded into per-(N, C) fp32 vectors a, b (from
`group_norm.gn_affine`), and optionally the per-(N, O) fp32 Σ and Σ² of
the output (before its cast), so that the next GroupNorm needs no
statistics pass.

- `gn_silu_conv3x3`: 3x3 spatial conv, x [N, H, W, C], w HWIO [3, 3, C, O],
  temb_bias [N, O], residual [N, H, W, O]; replaces the TPU's
  `_fused_conv_fwd` kernel.
- `gn_silu_tconv3`: the (3, 1, 1) temporal conv over T, x [B, T, S, C],
  w [3, C, O], temb_bias [B, T, O], residual [B, T, S, O]; replaces
  `_fused_tconv_fwd`.

Both run one CUDA kernel, `csrc/conv_fused.cu`: an implicit GEMM (M =
output pixels, N = O, K = taps x C) on `mma.sync` tensor cores, templated
on the tap geometry (9 taps over (H, W) with a one-pixel halo, or 3 taps
over T at a stride of S*C), with the affine and SiLU applied in fp32 while
each output tile's input window is staged into shared memory. It is bound
by tensor-core throughput. The kernel takes bf16 only (the main path's
type); fp32 tensors on a card raise. As in the JAX package, no model calls
these functions. Forward only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mofa_tpu_torch.kernels import count_launch, use_kernel

MAX_FUSED_CHANNELS = 640
K_CHUNK, O_TILE = 32, 64          # the kernel's K step and output-channel tile


def _kernel_takes(c: int, o: int, dtype) -> bool:
    return (dtype == torch.bfloat16 and c <= MAX_FUSED_CHANNELS
            and o <= MAX_FUSED_CHANNELS and c % K_CHUNK == 0 and o % O_TILE == 0)


def fused_conv_applicable(x_shape, o_channels: int,
                          dtype=torch.bfloat16) -> bool:
    """x [N, H, W, C]: C, O <= 640 (the JAX gate without its TPU test and
    VMEM estimate) and what the kernel takes."""
    return len(x_shape) == 4 and _kernel_takes(x_shape[-1], o_channels, dtype)


# x [B, T, S, C] for the (3, 1, 1) temporal conv: one kernel template, one gate
fused_tconv_applicable = fused_conv_applicable


def _activate(x, a, b, silu: bool):
    """silu(x*a + b) in fp32 over [N, ..., C], cast to x's dtype."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = x.float() * a.float().reshape(shape) + b.float().reshape(shape)
    return (F.silu(y) if silu else y).to(x.dtype)


def _epilogue(out, x, bias, temb, residual, emit_sums):
    """fp32 conv output [N, A, B, O] + bias [+ temb] [+ residual] -> x's
    dtype, with (Σ, Σ²) over the middle axes of the fp32 sum."""
    out = out + bias.float()
    if temb is not None:
        out = out + temb
    if residual is not None:
        out = out + residual.float()
    if emit_sums:
        return out.to(x.dtype), out.sum((1, 2)), (out * out).sum((1, 2))
    return out.to(x.dtype)


def conv3x3_plain(x, a, b, w, bias, temb_bias=None, residual=None,
                  silu: bool = True, emit_sums: bool = False):
    """Plain version (mofa_tpu `_ref_chain`): the affine and SiLU in fp32,
    cast to x's dtype, a 3x3 conv with zero padding of the ACTIVATED
    tensor, then bias, temb and residual added in fp32 before the cast."""
    y = _activate(x, a, b, silu).permute(0, 3, 1, 2)              # NCHW
    out = F.conv2d(y, w.to(x.dtype).permute(3, 2, 0, 1), padding=1)
    temb = None if temb_bias is None else temb_bias.float()[:, None, None, :]
    return _epilogue(out.permute(0, 2, 3, 1).float(), x, bias, temb, residual,
                     emit_sums)


def tconv3_plain(x, a, b, w, bias, temb_bias=None, residual=None,
                 silu: bool = True, emit_sums: bool = False):
    """Plain version (mofa_tpu `_tref_chain`): as `conv3x3_plain`, with a
    3-tap conv over T (zero frames beyond both ends)."""
    y = _activate(x, a, b, silu).permute(0, 3, 1, 2)              # [B, C, T, S]
    wk = w.to(x.dtype).permute(2, 1, 0)[..., None]                 # [O, C, 3, 1]
    out = F.conv2d(y, wk, padding=(1, 0))
    temb = None if temb_bias is None else temb_bias.float()[:, :, None, :]
    return _epilogue(out.permute(0, 2, 3, 1).float(), x, bias, temb, residual,
                     emit_sums)


def _launch_conv(name, entry, x, a, b, w, bias, temb_bias, residual, silu,
                 emit_sums):
    n, rows, cols, c = x.shape
    o = w.shape[-1]
    if not _kernel_takes(c, o, x.dtype) or (residual is not None
                                            and residual.dtype != x.dtype):
        raise ValueError(f"{name} kernel takes bf16 x and residual with C, O "
                         f"<= {MAX_FUSED_CHANNELS}, C % {K_CHUNK} == 0 and "
                         f"O % {O_TILE} == 0; got C={c}, O={o}, {x.dtype}")
    from mofa_tpu_torch.kernels._build import launch
    dev = x.device
    f32 = lambda t: None if t is None else t.float().contiguous()
    # weights as [O, taps*C] rows, K contiguous (the mma B operand)
    wt = w.to(x.dtype).reshape(-1, o).t().contiguous()
    res = None if residual is None else residual.contiguous()
    args = [x.contiguous(), f32(a), f32(b), wt, f32(bias), f32(temb_bias), res]
    args = [t.clone() if t is not None and t.data_ptr() % 16 else t for t in args]
    out = torch.empty(n, rows, cols, o, device=dev, dtype=x.dtype)
    s1 = s2 = None
    if emit_sums:
        s1, s2 = torch.zeros(2, n, o, device=dev, dtype=torch.float32).unbind(0)
    ptr = lambda t: None if t is None else t.data_ptr()
    launch(entry, dev, *[ptr(t) for t in args], out.data_ptr(), ptr(s1),
           ptr(s2), n, rows, cols, c, o, int(silu))
    count_launch(name)
    return (out, s1, s2) if emit_sums else out


def _check(x, a, b, w, taps, temb_bias, temb_shape, residual, o):
    if x.ndim != 4 or w.shape != taps + (x.shape[-1], o):
        raise ValueError(f"bad conv shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    nc = (x.shape[0], x.shape[-1])
    if a.shape != nc or b.shape != nc:
        raise ValueError(f"a, b must be {nc}; got {tuple(a.shape)} {tuple(b.shape)}")
    if temb_bias is not None and tuple(temb_bias.shape) != temb_shape:
        raise ValueError(f"temb_bias must be {temb_shape}")
    if residual is not None and residual.shape != x.shape[:3] + (o,):
        raise ValueError(f"residual must be {x.shape[:3] + (o,)}")


def gn_silu_conv3x3(x, a, b, w, bias, temb_bias=None, residual=None,
                    silu: bool = True, emit_sums: bool = False):
    """out = conv3x3(silu(x*a + b)) + bias [+ temb_bias] [+ residual].

    x [N, H, W, C]; a/b [N, C] fp32; w [3, 3, C, O]; bias [O]; temb_bias
    [N, O] or None; residual [N, H, W, O] or None. Returns out, or
    (out, s1, s2) with emit_sums: [N, O] fp32 Σ and Σ² of the output."""
    o = w.shape[-1]
    _check(x, a, b, w, (3, 3), temb_bias, (x.shape[0], o), residual, o)
    tensors = [t for t in (x, a, b, w, bias, temb_bias, residual) if t is not None]
    if not use_kernel(*tensors):
        return conv3x3_plain(x, a, b, w, bias, temb_bias, residual, silu,
                             emit_sums)
    return _launch_conv("gn_silu_conv3x3", "mofa_gn_silu_conv3x3", x, a, b, w,
                        bias, temb_bias, residual, silu, emit_sums)


def gn_silu_tconv3(x, a, b, w, bias, temb_bias=None, residual=None,
                   silu: bool = True, emit_sums: bool = False):
    """out = conv_(3 over T)(silu(x*a + b)) + bias [+ temb_bias] [+ residual].

    x [B, T, S, C]; a/b [B, C] fp32; w [3, C, O]; bias [O]; temb_bias
    [B, T, O] or None; residual [B, T, S, O] or None."""
    o = w.shape[-1]
    _check(x, a, b, w, (3,), temb_bias, (x.shape[0], x.shape[1], o), residual, o)
    tensors = [t for t in (x, a, b, w, bias, temb_bias, residual) if t is not None]
    if not use_kernel(*tensors):
        return tconv3_plain(x, a, b, w, bias, temb_bias, residual, silu,
                            emit_sums)
    return _launch_conv("gn_silu_tconv3", "mofa_gn_silu_tconv3", x, a, b, w,
                        bias, temb_bias, residual, silu, emit_sums)
