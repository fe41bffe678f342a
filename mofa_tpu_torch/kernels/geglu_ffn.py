"""The GEGLU feed-forward kernels: fused LN -> GEGLU FF -> residual, and the FF alone.

Counterpart of mofa_tpu/kernels/geglu_ffn.py:

- `ln_geglu_ffn(..., variant=)`: x + FF(LN(x)), with the JAX package's
  `_ln_ffn_fwd(variant=...)` names. "plain" (the default, and the only one
  a model calls) replaces `_ln_ffn_kernel`; "tanh" is that kernel with the
  tanh-form gelu; "ilv" replaces `_ln_ffn_kernel_ilv` (row sub-blocks that
  never wait on one another) and "pipe" `_ln_ffn_kernel_pipe` (the next
  block's first GEMM issued before this block's gate). All four compute
  one function at the same rounding points ("tanh" with its own gelu).
- `geglu_ffn`: FF(x) without LN or residual; replaces `_ffn_kernel`.

All run one CUDA source, `csrc/ln_geglu_ffn.cu`. In bf16 each is three
kernels launched in turn, each a stage with its own entry point and plain
version here:

- `ffn_ln_rows`: xn = LN(x), bf16 (skipped by `geglu_ffn`);
- `ffn_gemm_gate`: h = a * gelu(g), [a | g] = xn W0^T + b0, bf16 [rows, 4C]
  (a persistent `wgmma` GEMM fed by TMA, the gate in its epilogue), in one
  of three schedules: "plain" (the gate after each tile's products), and
  for the "ilv" and "pipe" variants schedules of the same name whose gate
  runs beside the tensor cores ("ilv": two warpgroups taking turns at the
  products; "pipe": two accumulator sets in each warpgroup);
- `ffn_gemm_out`: out = h W2^T + b2 (+ x), the same GEMM mainloop.

The wrappers allocate the xn and h scratch per call and count one launch
per call, under the variant's own name; the stage entry points launch one
stage each and count nothing (`chip_smoke.py` uses them to place a fault
in its stage and to time each gate schedule). Weights use torch Linear
layouts: w0 [8C, C], w2 [C, 4C]. The "plain" variant also has an fp32
route (training, which runs in fp32): the same three stages on split
TF32, each GEMM operand written as a big and a small TF32 plane (the LN
pass's xn, the gate GEMM's h, W0 and W2 split once a call) and each
product taken as small * big + big * small + big * big on `wgmma`, fp32
accumulation, about 22 of fp32's 24 bits (`split_tf32_plain` has its
arithmetic); the others take bf16 only and raise on fp32 tensors on a
card.

`ln_geglu_ffn` (every variant) and `geglu_ffn` have a gradient: with
grad enabled on a CUDA tensor the kernel forward runs inside an autograd
Function (`kernels.kernel_route`) whose backward is the VJP of the
function it computes, recomputed: `ln_ffn_backward`, the JAX package's
`_ln_bwd_rule` (geglu_ffn.py:427), for "plain", "ilv" and "pipe", and
with the tanh-form gelu for "tanh" (the JAX rule differentiates the erf
form whatever the variant, so its "tanh" gradient is not that of its
forward; the port's is); `ffn_backward`, the JAX `_bwd_rule` (:126), for
`geglu_ffn`. The stage entry points, the port's own, raise under grad on
their kernel routes (`kernels.check_no_grad`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mofa_tpu_torch.kernels import (check_no_grad, count_launch, kernel_route,
                                    math_dtype, use_kernel, vjp_plain)

LN_EPS = 1e-5
MIN_FUSED_ROWS = 4096
KERNEL_DIMS = (320, 640)
VARIANTS = ("plain", "ilv", "pipe", "tanh")
SCHEDULES = ("plain", "ilv", "pipe")       # the gate GEMM's, in the C entry's order
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GELU = ("none", "tanh")


def fused_ffn_applicable(rows: int, dim: int, dim_out: int) -> bool:
    """The sites the JAX package sends to its Pallas kernel on the TPU
    (C <= 640, geglu_ffn.py:38-49), without the TPU-only block-divisibility
    rule, and only at the widths the kernel is built for (SVD-XT's 320 and
    640); other widths stay plain PyTorch on every device."""
    return dim in KERNEL_DIMS and dim_out == dim and rows >= MIN_FUSED_ROWS


# ---------------------------------------------------------- plain versions

def ffn_ln_rows_plain(x, ln_weight, ln_bias) -> torch.Tensor:
    """LayerNorm with fp32 statistics (E[x^2] - mean^2), scale and shift in
    fp32, cast to x's dtype (mofa_tpu `_ln_ffn_ref`'s first line)."""
    acc = math_dtype(x.dtype)
    xf = x.to(acc)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    return ((xf - mean) * torch.rsqrt(var + LN_EPS) * ln_weight.to(acc)
            + ln_bias.to(acc)).to(x.dtype)


def ffn_gemm_gate_plain(xn, w0, b0, approximate: str = "none") -> torch.Tensor:
    """a * gelu(g), [a | g] = xn W0^T + b0, in xn's dtype (gelu
    `approximate` "none", or "tanh" for the tanh variant)."""
    a, g = F.linear(xn, w0.to(xn.dtype), b0.to(xn.dtype)).chunk(2, dim=-1)
    return a * F.gelu(g, approximate=approximate)


def ffn_gemm_out_plain(h, w2, b2, residual=None) -> torch.Tensor:
    """h W2^T + b2 (+ residual), in h's dtype."""
    out = F.linear(h, w2.to(h.dtype), b2.to(h.dtype))
    return out if residual is None else out + residual


def ffn_plain(x, w0, b0, w2, b2) -> torch.Tensor:
    """Plain version (mofa_tpu `_ffn_ref`): GEGLU FF in x's dtype."""
    return ffn_gemm_out_plain(ffn_gemm_gate_plain(x, w0, b0), w2, b2)


def ln_ffn_plain(x, ln_weight, ln_bias, w0, b0, w2, b2,
                 approximate: str = "none") -> torch.Tensor:
    """Plain version (mofa_tpu `_ln_ffn_ref`): LayerNorm with fp32 stats,
    cast to x's dtype, GEGLU FF in x's dtype, residual."""
    xn = ffn_ln_rows_plain(x, ln_weight, ln_bias)
    return ffn_gemm_out_plain(ffn_gemm_gate_plain(xn, w0, b0, approximate),
                              w2, b2, x)


# ------------------------------------------------------------ the kernels

def _check_weights(c, w0, w2):
    if w0.shape != (8 * c, c) or w2.shape != (c, 4 * c):
        raise ValueError(f"bad FF weights {tuple(w0.shape)} {tuple(w2.shape)}")


def _operands(name, x, ln, weights, dtypes):
    """x as [rows, C] and the LN params (fp32) and weights (x's dtype),
    contiguous and 32-byte aligned; ValueError for a width or dtype the
    kernel does not take."""
    c, dt = x.shape[-1], x.dtype
    if c not in KERNEL_DIMS or dt not in dtypes:
        raise ValueError(f"{name} kernel takes C in {KERNEL_DIMS} and "
                         f"{[str(d) for d in dtypes]}; got C={c}, {dt}")
    args = ([x.reshape(-1, c).contiguous()] + [p.float().contiguous() for p in ln]
            + [w.to(dt).contiguous() for w in weights])
    return [a.clone() if a.data_ptr() % 32 else a for a in args]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scratch(rows, c, dtype, device, ln=True):
    """The C entry's scratch: bf16, xn [rows, C] (with LN) and h [rows, 4C];
    fp32, the big and small TF32 planes of xn [2, rows, C] and h [2, rows,
    4C], and of W0 and W2 (24 C^2 floats)."""
    if dtype == torch.bfloat16:
        xn = torch.empty(rows, c, device=device, dtype=dtype) if ln else None
        return xn, torch.empty(rows, 4 * c, device=device, dtype=dtype), None
    f32 = dict(device=device, dtype=torch.float32)
    return (torch.empty(2, rows, c, **f32), torch.empty(2, rows, 4 * c, **f32),
            torch.empty(24 * c * c, **f32))


def _launch_ffn(name, x, ln, weights, approximate="none", schedule="plain"):
    """ln_geglu_ffn (ln = (scale, shift)) or geglu_ffn (ln = ()): the three
    stages with the gate GEMM's `schedule` in bf16 or, for "plain" in
    fp32, on split TF32; one count per call, under `name`."""
    from mofa_tpu_torch.kernels._build import launch
    dtypes = _DTYPES if name == "ln_geglu_ffn" else (torch.bfloat16,)
    args = _operands(name, x, ln, weights, dtypes)
    x2, c = args[0], x.shape[-1]
    rows, dev = x2.shape[0], x.device
    out = torch.empty_like(x2)
    xn, h, ws = _scratch(rows, c, x2.dtype, dev, bool(ln))
    if ln:
        launch("mofa_ln_geglu_ffn", dev, *map(_ptr, args), _ptr(xn), _ptr(h), _ptr(ws),
               out.data_ptr(), rows, c, _DTYPES[x2.dtype], _GELU.index(approximate),
               SCHEDULES.index(schedule))
    else:
        launch("mofa_geglu_ffn", dev, *map(_ptr, args), h.data_ptr(),
               out.data_ptr(), rows, c)
    count_launch(name)
    return out.reshape(x.shape)


def ln_ffn_backward(x, ln_weight, ln_bias, w0, b0, w2, b2, g,
                    approximate: str = "none"):
    """(dx, d ln_weight, d ln_bias, dw0, db0, dw2, db2) at `g` = d out:
    the VJP of `ln_ffn_plain` (gelu `approximate`), recomputed (with the
    erf gelu, the JAX package's `_ln_bwd_rule`); each gradient in its
    input's dtype."""
    return vjp_plain(lambda *a: ln_ffn_plain(*a, approximate),
                     (x, ln_weight, ln_bias, w0, b0, w2, b2), g)


def ffn_backward(x, w0, b0, w2, b2, g):
    """(dx, dw0, db0, dw2, db2) at `g` = d out: the VJP of `ffn_plain`,
    recomputed (the JAX package's `_bwd_rule`)."""
    return vjp_plain(ffn_plain, (x, w0, b0, w2, b2), g)


def _approximate(variant: str) -> str:
    return "tanh" if variant == "tanh" else "none"


def _launch_ln_ffn(variant, x, ln_weight, ln_bias, w0, b0, w2, b2):
    """The variant's kernel: the gate GEMM's schedule of its name ("tanh":
    plain's, with the tanh gelu), counted under its kernel's name."""
    name = "ln_geglu_ffn" if variant == "plain" else f"ln_geglu_ffn_{variant}"
    schedule = variant if variant in SCHEDULES else "plain"
    return _launch_ffn(name, x, (ln_weight, ln_bias), (w0, b0, w2, b2),
                       _approximate(variant), schedule)


def ln_geglu_ffn(x, ln_weight, ln_bias, w0, b0, w2, b2,
                 variant: str = "plain") -> torch.Tensor:
    """x [..., C] -> x + FF(LN(x)); LN params [C]; w0 [8C, C], b0 [8C],
    w2 [C, 4C], b2 [C] (cast to x's dtype, LN params to fp32). `variant`
    picks the kernel's schedule, as the JAX package's `_ln_ffn_fwd` does:
    "plain", "ilv" and "pipe" compute one function (the gate GEMM of the
    schedule of that name); "tanh" uses the tanh-form gelu."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    _check_weights(x.shape[-1], w0, w2)
    approximate = _approximate(variant)
    operands = (x, ln_weight, ln_bias, w0, b0, w2, b2)
    if not use_kernel(*operands):
        return ln_ffn_plain(*operands, approximate)
    return kernel_route(lambda *a: _launch_ln_ffn(variant, *a),
                        lambda *a: ln_ffn_backward(*a, approximate), *operands)


def geglu_ffn(x, w0, b0, w2, b2) -> torch.Tensor:
    """x [..., C] -> FF(x) (no LayerNorm, no residual); weights as in
    `ln_geglu_ffn`. The kernel takes bf16 only."""
    _check_weights(x.shape[-1], w0, w2)
    if not use_kernel(x, w0, b0, w2, b2):
        return ffn_plain(x, w0, b0, w2, b2)
    return kernel_route(lambda a, *w: _launch_ffn("geglu_ffn", a, (), w),
                        ffn_backward, x, w0, b0, w2, b2)


# ------------------------------------------------- the stage entry points

def _stage_operands(name, *tensors):
    """bf16 tensors with the last dim a kernel width, contiguous and 32-byte
    aligned; ValueError otherwise."""
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} takes bf16 tensors; got {t.dtype}")
        t = t.contiguous()
        out.append(t.clone() if t.data_ptr() % 32 else t)
    return out


def _stage_width(name, c):
    if c not in KERNEL_DIMS:
        raise ValueError(f"{name} takes C in {KERNEL_DIMS}; got C={c}")
    return c


def ffn_ln_rows(x, ln_weight, ln_bias) -> torch.Tensor:
    """Stage 1 of the bf16 FFN: x [rows, C] -> LN(x) [rows, C]."""
    if not use_kernel(x, ln_weight, ln_bias):
        return ffn_ln_rows_plain(x, ln_weight, ln_bias)
    check_no_grad("ffn_ln_rows", x, ln_weight, ln_bias)
    from mofa_tpu_torch.kernels._build import launch
    c = _stage_width("ffn_ln_rows", x.shape[-1])
    if x.ndim != 2 or ln_weight.shape != (c,) or ln_bias.shape != (c,):
        raise ValueError(f"ffn_ln_rows: bad shapes {tuple(x.shape)} "
                         f"{tuple(ln_weight.shape)} {tuple(ln_bias.shape)}")
    (x,) = _stage_operands("ffn_ln_rows", x)
    ls, lb = (p.float().contiguous() for p in (ln_weight, ln_bias))
    ls, lb = (p.clone() if p.data_ptr() % 32 else p for p in (ls, lb))
    xn = torch.empty_like(x)
    launch("mofa_ffn_ln_rows", x.device, x.data_ptr(), ls.data_ptr(),
           lb.data_ptr(), xn.data_ptr(), x.shape[0], c)
    return xn


def ffn_gemm_gate(xn, w0, b0, approximate: str = "none",
                  schedule: str = "plain") -> torch.Tensor:
    """Stage 2: xn [rows, C], w0 [8C, C], b0 [8C] -> a * gelu(g) [rows, 4C].
    `schedule` names the GEMM's schedule ("plain", "ilv", "pipe", after the
    variants that run it); every schedule computes one function, whose
    plain version is `ffn_gemm_gate_plain`. "ilv" and "pipe" take the erf
    gelu only."""
    if approximate not in _GELU:
        raise ValueError(f"approximate must be one of {_GELU}, got {approximate!r}")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
    if schedule != "plain" and approximate != "none":
        raise ValueError(f"the {schedule!r} schedule computes the erf gelu only")
    if not use_kernel(xn, w0, b0):
        return ffn_gemm_gate_plain(xn, w0, b0, approximate)
    check_no_grad("ffn_gemm_gate", xn, w0, b0)
    from mofa_tpu_torch.kernels._build import launch
    c = _stage_width("ffn_gemm_gate", xn.shape[-1])
    if xn.ndim != 2 or w0.shape != (8 * c, c) or b0.shape != (8 * c,):
        raise ValueError(f"ffn_gemm_gate: bad shapes {tuple(xn.shape)} "
                         f"{tuple(w0.shape)} {tuple(b0.shape)}")
    xn, w0, b0 = _stage_operands("ffn_gemm_gate", xn, w0, b0)
    h = torch.empty(xn.shape[0], 4 * c, device=xn.device, dtype=xn.dtype)
    launch("mofa_ffn_gemm_gate", xn.device, xn.data_ptr(), w0.data_ptr(),
           b0.data_ptr(), h.data_ptr(), xn.shape[0], c, _GELU.index(approximate),
           SCHEDULES.index(schedule))
    return h


def ffn_gemm_out(h, w2, b2, residual=None) -> torch.Tensor:
    """Stage 3: h [rows, 4C], w2 [C, 4C], b2 [C] -> h W2^T + b2 (+ residual
    [rows, C])."""
    tensors = [t for t in (h, w2, b2, residual) if t is not None]
    if not use_kernel(*tensors):
        return ffn_gemm_out_plain(h, w2, b2, residual)
    check_no_grad("ffn_gemm_out", *tensors)
    from mofa_tpu_torch.kernels._build import launch
    c = _stage_width("ffn_gemm_out", w2.shape[0])
    rows = h.shape[0]
    if (h.ndim != 2 or h.shape[1] != 4 * c or w2.shape != (c, 4 * c)
            or b2.shape != (c,)
            or (residual is not None and residual.shape != (rows, c))):
        raise ValueError(f"ffn_gemm_out: bad shapes {tuple(h.shape)} "
                         f"{tuple(w2.shape)} {tuple(b2.shape)}")
    h, w2, b2, residual = _stage_operands("ffn_gemm_out", h, w2, b2, residual)
    out = torch.empty(rows, c, device=h.device, dtype=h.dtype)
    launch("mofa_ffn_gemm_out", h.device, h.data_ptr(), w2.data_ptr(),
           b2.data_ptr(), _ptr(residual), out.data_ptr(), rows, c)
    return out
