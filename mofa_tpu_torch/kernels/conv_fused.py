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

Both run `csrc/conv3x3.cu`, split at the TPU kernels' own rounding point
(the activated strip rounded to the output dtype before its matmuls) into
two stages, each with an entry point and a plain version here:

- `gn_silu_act`: y = silu(x*a + b) in fp32, rounded to bf16, one pass
  (x [B, T, S, C] is seen as [N, H, W, C]);
- `conv3x3_gemm` / `tconv3_gemm`: the conv of y + bias [+ temb]
  [+ residual] (and the sums), one persistent `wgmma` implicit GEMM
  template over 9 taps (dy, dx) or 3 taps over T, fed by TMA, whose
  out-of-bounds zero fill is the zero padding of the activated tensor.

The wrappers allocate y per call and count one launch per call; the
stage entry points launch one stage each and count nothing (`chip_smoke.py`
uses them to place a fault in its stage). Rounding, as the JAX kernels
(mofa_tpu/kernels/conv_fused.py:162,199,327,364): w, bias and temb_bias
are rounded to x's dtype before the fp32 epilogue adds them, and the conv
accumulates in fp32 over the rounded y and w, with one rounding at the
end; in fp32 the roundings are no-ops. The kernels take bf16 only (the
main path's type); fp32 tensors on a card raise. As in the JAX package,
no model calls these functions.

The fused entry points have the JAX package's gradients: on a CUDA
tensor with grad enabled the kernel forward runs inside an autograd
Function whose backward is the VJP of the plain chain, recomputed, with
the sums' cotangents where `emit_sums` returns them and None for an
absent temb_bias or residual (`_vjp_bwd` / `_tvjp_bwd`,
conv_fused.py:440 / :407): `fused_conv_backward`. The stages, the port's
own entry points, raise under grad on their kernel routes
(`kernels.check_no_grad`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mofa_tpu_torch.kernels import (check_no_grad, count_launch, kernel_route,
                                    use_kernel, vjp_plain)

MAX_FUSED_CHANNELS = 640
K_CHUNK, O_TILE = 32, 64          # the gate's channel multiples (C, O)


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


def act_plain(x, a, b, silu: bool = True):
    """silu(x*a + b) in fp32 over [N, ..., C], cast to x's dtype (the plain
    version of `gn_silu_act`, and the first step of both convs' plain
    versions). x*a + b is rounded to fp32 once, as the kernel's `fmaf` and
    XLA's fused multiply-add round it: the product of a bf16 or fp32 x and
    an fp32 a is exact in fp64."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    y = (x.double() * a.double().reshape(shape)
         + b.double().reshape(shape)).float()
    return (F.silu(y) if silu else y).to(x.dtype)


def _rounded(t, dtype):
    """bias or temb_bias as the JAX kernels add it: rounded to the conv's
    dtype, then fp32 (None stays None)."""
    return None if t is None else t.to(dtype).float()


def _epilogue(out, dtype, bias, temb, residual, emit_sums):
    """fp32 conv output [N, A, B, O] + bias [+ temb, broadcast] [+ residual]
    -> dtype, with (Σ, Σ²) over the middle axes of the fp32 sum."""
    out = out + _rounded(bias, dtype)
    if temb is not None:
        out = out + _rounded(temb, dtype)
    if residual is not None:
        out = out + residual.float()
    if emit_sums:
        return out.to(dtype), out.sum((1, 2)), (out * out).sum((1, 2))
    return out.to(dtype)


def _conv_fp32(y, w_oihw, padding):
    """The conv of y [N, A, B, C] in fp32 on its values and w's rounded to
    y's dtype: exact products (bf16 values pass TF32 unchanged), fp32 sums,
    NCHW [N, O, A, B] out."""
    return F.conv2d(y.permute(0, 3, 1, 2).float(), w_oihw.to(y.dtype).float(),
                    padding=padding)


def conv3x3_plain(x, a, b, w, bias, temb_bias=None, residual=None,
                  silu: bool = True, emit_sums: bool = False):
    """Plain version (mofa_tpu `_ref_chain`, rounded as its kernel): the
    affine and SiLU in fp32, cast to x's dtype, a 3x3 conv with zero
    padding of the ACTIVATED tensor, then bias, temb and residual added in
    fp32 before the cast; the composition of the two stages' plain
    versions."""
    return conv3x3_gemm_plain(act_plain(x, a, b, silu), w, bias, temb_bias,
                              residual, emit_sums)


def tconv3_plain(x, a, b, w, bias, temb_bias=None, residual=None,
                 silu: bool = True, emit_sums: bool = False):
    """Plain version (mofa_tpu `_tref_chain`, rounded as its kernel): as
    `conv3x3_plain`, with a 3-tap conv over T (zero frames beyond both
    ends)."""
    return tconv3_gemm_plain(act_plain(x, a, b, silu), w, bias, temb_bias,
                             residual, emit_sums)


def _weights_k_major(w, o, dtype):
    """HWIO taps [..., C, O] -> [O, taps*C] rows, K contiguous (the GEMM's
    B operand)."""
    return w.to(dtype).reshape(-1, o).t().contiguous()


def _aligned(*tensors):
    """Contiguous, 16-byte aligned copies where needed; None stays None."""
    out = []
    for t in tensors:
        if t is not None:
            t = t.contiguous()
            t = t.clone() if t.data_ptr() % 16 else t
        out.append(t)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sums(emit_sums, n, o, dev):
    if not emit_sums:
        return None, None
    return torch.zeros(2, n, o, device=dev, dtype=torch.float32).unbind(0)


def _refuse(name, c, o, x, residual):
    if not _kernel_takes(c, o, x.dtype) or (residual is not None
                                            and residual.dtype != x.dtype):
        raise ValueError(f"{name} kernel takes bf16 x and residual with C, O "
                         f"<= {MAX_FUSED_CHANNELS}, C % {K_CHUNK} == 0 and "
                         f"O % {O_TILE} == 0; got C={c}, O={o}, {x.dtype}")


def _launch(name, x, w, bias, temb_bias, residual, emit_sums, ab=(),
            silu: bool = True):
    """C entry `mofa_<name>` on the card. With ab = (a, b), a fused conv:
    the two stages through a y scratch allocated here, one launch counted;
    without, a GEMM stage on an activated x, no count."""
    n, o = x.shape[0], w.shape[-1]
    _refuse(name, x.shape[-1], o, x, residual)
    from mofa_tpu_torch.kernels._build import launch
    args = _aligned(x, *(t.float() for t in ab), _weights_k_major(w, o, x.dtype),
                    _rounded(bias, x.dtype), _rounded(temb_bias, x.dtype),
                    residual)
    if ab:
        args.append(torch.empty_like(args[0]))         # y
    out = torch.empty(x.shape[:3] + (o,), device=x.device, dtype=x.dtype)
    s1, s2 = _sums(emit_sums, n, o, x.device)
    launch(f"mofa_{name}", x.device, *map(_ptr, args), out.data_ptr(),
           _ptr(s1), _ptr(s2), *x.shape, o, *([int(silu)] if ab else []))
    if ab:
        count_launch(name)
    return (out, s1, s2) if emit_sums else out


def _check(name, x, w, taps, temb_bias, temb_shape, residual, ab=()):
    """x (or y) [N, A, B, C], w taps + [C, O], temb_bias of temb_shape,
    residual [N, A, B, O], each of ab [N, C]."""
    o, nc = w.shape[-1], (x.shape[0], x.shape[-1])
    if (x.ndim != 4 or w.shape != taps + (x.shape[-1], o)
            or any(t.shape != nc for t in ab)
            or temb_bias is not None and tuple(temb_bias.shape) != temb_shape
            or residual is not None and residual.shape != x.shape[:3] + (o,)):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}; a, b must be {nc}, temb_bias "
                         f"{temb_shape}, residual {x.shape[:3] + (o,)}")


def fused_conv_backward(plain, x, a, b, w, bias, temb_bias, residual, silu,
                        emit_sums, *grads):
    """The gradients of (x, a, b, w, bias, temb_bias, residual) at `grads`
    (d out, and d s1, d s2 with emit_sums): the VJP of the plain chain
    `plain` (`conv3x3_plain` or `tconv3_plain`), recomputed; None for an
    absent temb_bias or residual."""
    return vjp_plain(lambda *t: plain(*t, silu=silu, emit_sums=emit_sums),
                     (x, a, b, w, bias, temb_bias, residual), tuple(grads))


def _fused_route(name, plain, x, a, b, w, bias, temb_bias, residual, silu,
                 emit_sums):
    return kernel_route(
        lambda x_, a_, b_, *rest: _launch(name, x_, *rest, emit_sums, (a_, b_), silu),
        lambda *t: fused_conv_backward(plain, *t[:7], silu, emit_sums, *t[7:]),
        x, a, b, w, bias, temb_bias, residual)


def gn_silu_conv3x3(x, a, b, w, bias, temb_bias=None, residual=None,
                    silu: bool = True, emit_sums: bool = False):
    """out = conv3x3(silu(x*a + b)) + bias [+ temb_bias] [+ residual].

    x [N, H, W, C]; a/b [N, C] fp32; w [3, 3, C, O]; bias [O]; temb_bias
    [N, O] or None; residual [N, H, W, O] or None. Returns out, or
    (out, s1, s2) with emit_sums: [N, O] fp32 Σ and Σ² of the output."""
    o = w.shape[-1]
    _check("gn_silu_conv3x3", x, w, (3, 3), temb_bias, (x.shape[0], o),
           residual, (a, b))
    tensors = [t for t in (x, a, b, w, bias, temb_bias, residual) if t is not None]
    if not use_kernel(*tensors):
        return conv3x3_plain(x, a, b, w, bias, temb_bias, residual, silu,
                             emit_sums)
    return _fused_route("gn_silu_conv3x3", conv3x3_plain, x, a, b, w, bias,
                        temb_bias, residual, silu, emit_sums)


# --------------------------------------------------- the stage entry points

def conv3x3_gemm_plain(y, w, bias, temb_bias=None, residual=None,
                       emit_sums: bool = False):
    """Stage 2's plain version, 3x3: the conv of the activated y (zero
    padding) in fp32, then bias, temb and residual added in fp32 before
    the cast."""
    out = _conv_fp32(y, w.permute(3, 2, 0, 1), 1)
    temb = None if temb_bias is None else temb_bias[:, None, None, :]
    return _epilogue(out.permute(0, 2, 3, 1), y.dtype, bias, temb, residual,
                     emit_sums)


def tconv3_gemm_plain(y, w, bias, temb_bias=None, residual=None,
                      emit_sums: bool = False):
    """Stage 2's plain version, temporal: y [B, T, S, C], w [3, C, O], the
    3-tap conv over T (zero frames beyond both ends) in fp32, then bias,
    temb [B, T, O] and residual added in fp32 before the cast."""
    out = _conv_fp32(y, w.permute(2, 1, 0)[..., None], (1, 0))   # [B, O, T, S]
    temb = None if temb_bias is None else temb_bias[:, :, None, :]
    return _epilogue(out.permute(0, 2, 3, 1), y.dtype, bias, temb, residual,
                     emit_sums)


def gn_silu_act(x, a, b, silu: bool = True):
    """Stage 1 of both convs: x [N, H, W, C] (or [B, T, S, C]), a/b [N, C]
    fp32 -> silu(x*a + b) in x's shape and dtype."""
    if x.ndim != 4 or a.shape != (x.shape[0], x.shape[-1]) or b.shape != a.shape:
        raise ValueError(f"gn_silu_act: bad shapes {tuple(x.shape)} "
                         f"{tuple(a.shape)} {tuple(b.shape)}")
    if not use_kernel(x, a, b):
        return act_plain(x, a, b, silu)
    check_no_grad("gn_silu_act", x, a, b)
    _refuse("gn_silu_act", x.shape[-1], O_TILE, x, None)
    from mofa_tpu_torch.kernels._build import launch
    x, a, b = _aligned(x, a.float(), b.float())
    y = torch.empty_like(x)
    launch("mofa_gn_silu_act", x.device, x.data_ptr(), a.data_ptr(),
           b.data_ptr(), y.data_ptr(), *x.shape, int(silu))
    return y


def conv3x3_gemm(y, w, bias, temb_bias=None, residual=None,
                 emit_sums: bool = False):
    """Stage 2 of `gn_silu_conv3x3`: y [N, H, W, C] (activated), w [3, 3,
    C, O], bias [O], temb_bias [N, O] or None, residual [N, H, W, O] or
    None -> out, or (out, s1, s2) with emit_sums."""
    _check("conv3x3_gemm", y, w, (3, 3), temb_bias, (y.shape[0], w.shape[-1]),
           residual)
    tensors = [t for t in (y, w, bias, temb_bias, residual) if t is not None]
    if not use_kernel(*tensors):
        return conv3x3_gemm_plain(y, w, bias, temb_bias, residual, emit_sums)
    check_no_grad("conv3x3_gemm", *tensors)
    return _launch("conv3x3_gemm", y, w, bias, temb_bias, residual, emit_sums)


def tconv3_gemm(y, w, bias, temb_bias=None, residual=None,
                emit_sums: bool = False):
    """Stage 2 of `gn_silu_tconv3`: y [B, T, S, C] (activated), w [3, C,
    O], bias [O], temb_bias [B, T, O] or None, residual [B, T, S, O] or
    None -> out, or (out, s1, s2) with emit_sums."""
    _check("tconv3_gemm", y, w, (3,), temb_bias,
           (y.shape[0], y.shape[1], w.shape[-1]), residual)
    tensors = [t for t in (y, w, bias, temb_bias, residual) if t is not None]
    if not use_kernel(*tensors):
        return tconv3_gemm_plain(y, w, bias, temb_bias, residual, emit_sums)
    check_no_grad("tconv3_gemm", *tensors)
    return _launch("tconv3_gemm", y, w, bias, temb_bias, residual, emit_sums)


def gn_silu_tconv3(x, a, b, w, bias, temb_bias=None, residual=None,
                   silu: bool = True, emit_sums: bool = False):
    """out = conv_(3 over T)(silu(x*a + b)) + bias [+ temb_bias] [+ residual].

    x [B, T, S, C]; a/b [B, C] fp32; w [3, C, O]; bias [O]; temb_bias
    [B, T, O] or None; residual [B, T, S, O] or None."""
    o = w.shape[-1]
    _check("gn_silu_tconv3", x, w, (3,), temb_bias,
           (x.shape[0], x.shape[1], o), residual, (a, b))
    tensors = [t for t in (x, a, b, w, bias, temb_bias, residual) if t is not None]
    if not use_kernel(*tensors):
        return tconv3_plain(x, a, b, w, bias, temb_bias, residual, silu,
                            emit_sums)
    return _fused_route("gn_silu_tconv3", tconv3_plain, x, a, b, w, bias,
                        temb_bias, residual, silu, emit_sums)
