"""Forward softmax splatting (softsplat), channel-last.

Counterpart of mofa_tpu/kernels/softsplat.py. The splat is the CUDA
kernel `csrc/softsplat.cu` (replacing the TPU's
`kernels/softsplat_pallas.py::splat_pallas`, which computes the scatter
as one-hot matmuls because the TPU has no atomics): fp32 vector
reductions into an accumulator and, for the normalised modes, a separate
[B, H, W] normaliser plane; then one pass divides and casts. See the
source note.

The modes ('sum' / 'avg' / 'linear' / 'soft') and the eps policies
('-addeps' / '-zeroeps' / '-clipeps') compute exactly what the JAX
wrapper computes: the JAX wrapper appends the normaliser as a channel
(ones, the metric m, or exp(metric)) to x * m and splats both; here the
same per-tap values, (x * m) * w and m * w, go to the accumulator and the
plane. Layout: ten_in [S, H, W, C], ten_flow [B, H, W, 2] with
flow[..., 0] = dx (columns), flow[..., 1] = dy (rows), ten_metric
[B, H, W, 1]. `frames_per_source` = B / S: output frame b splats source
frame b // frames_per_source, so a caller that warps one feature map
along many flows passes it once instead of an expanded copy.

The gradient is the JAX package's `_splat_bwd` (softsplat.py:157) in
stock PyTorch: `splat_backward` gathers d acc and d norm at each
source pixel's four taps (d_in; d_flow from the bilinear weights'
derivatives, floor() held constant; d_metric), and `normalize_backward`
is the VJP of `normalize_plain`. On CUDA tensors with grad enabled the
splat and the normalising pass run their kernels inside `_SplatFunction`
and `_NormalizeFunction`, which save their inputs for those backwards.
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.kernels import count_launch, math_dtype, use_kernel

MODES = ("sum", "avg", "linear", "soft")
EPS_POLICIES = ("addeps", "zeroeps", "clipeps")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(inp, flow, metric, frames_per_source):
    b = flow.shape[0]
    if (inp.ndim != 4 or flow.shape[1:] != inp.shape[1:3] + (2,)
            or frames_per_source < 1 or b != inp.shape[0] * frames_per_source):
        raise ValueError(f"bad shapes {tuple(inp.shape)} / {tuple(flow.shape)} "
                         f"with frames_per_source={frames_per_source}")
    if metric is not None and metric.shape not in (flow.shape[:3],
                                                   flow.shape[:3] + (1,)):
        raise ValueError(f"metric must be {tuple(flow.shape[:3])} (+ (1,)); "
                         f"got {tuple(metric.shape)}")


def splat_plain(inp: torch.Tensor, flow: torch.Tensor,
                metric: torch.Tensor | None = None,
                frames_per_source: int = 1, with_norm: bool = False):
    """Plain version by `index_add_` (mirrors mofa_tpu's `_splat_xla`).

    inp [S, H, W, C] (any float dtype, read as fp32), flow [B, H, W, 2],
    metric m [B, H, W(, 1)] or None (m = 1), B = S * frames_per_source.
    Returns acc [B, H, W, C] fp32 = the sum over taps of (x * m) * w, and
    with_norm also the normaliser plane [B, H, W] fp32 = the sum of m * w."""
    _check(inp, flow, metric, frames_per_source)
    B, (_, H, W, C) = flow.shape[0], inp.shape
    P = H * W
    dev, acc = inp.device, math_dtype(inp.dtype)
    cols = torch.arange(W, device=dev, dtype=acc)[None, None, :]
    rows = torch.arange(H, device=dev, dtype=acc)[None, :, None]
    flow = flow.to(acc)
    tx = (cols + flow[..., 0]).reshape(B, P)
    ty = (rows + flow[..., 1]).reshape(B, P)
    finite = torch.isfinite(tx) & torch.isfinite(ty)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    x1, y1 = x0 + 1.0, y0 + 1.0
    frame_src = torch.arange(B, device=dev) // frames_per_source
    src = inp.to(acc)[frame_src].reshape(B * P, C)
    m = None if metric is None else metric.to(acc).reshape(B * P, 1)
    if m is not None:
        src = src * m
    out = torch.zeros(B * P + 1, C, device=dev, dtype=acc)
    norm = torch.zeros(B * P + 1, device=dev, dtype=acc)
    base = (torch.arange(B, device=dev) * P)[:, None]
    for xi, yi, w in ((x0, y0, (x1 - tx) * (y1 - ty)),
                      (x1, y0, (tx - x0) * (y1 - ty)),
                      (x0, y1, (x1 - tx) * (ty - y0)),
                      (x1, y1, (tx - x0) * (ty - y0))):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & finite
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long() + base
        idx = torch.where(inside, flat, B * P).reshape(-1)   # B*P = dropped
        w = torch.where(inside, w, 0.0).reshape(-1, 1)
        out.index_add_(0, idx, src * w)
        if with_norm:
            norm.index_add_(0, idx, (w if m is None else m * w)[:, 0])
    out = out[:B * P].reshape(B, H, W, C)
    return (out, norm[:B * P].reshape(B, H, W)) if with_norm else out


def _taps(flow: torch.Tensor, H: int, W: int):
    """Per bilinear tap of each source pixel: (inside [B, P], flat target
    index [B, P], weight w, dw/d flow_x, dw/d flow_y), floor() held
    constant, as the JAX package's `_splat_bwd` lists them."""
    B, dev = flow.shape[0], flow.device
    cols = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    rows = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    flow = flow.float()
    tx = (cols + flow[..., 0]).reshape(B, H * W)
    ty = (rows + flow[..., 1]).reshape(B, H * W)
    finite = torch.isfinite(tx) & torch.isfinite(ty)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    x1, y1 = x0 + 1.0, y0 + 1.0
    for xi, yi, w, dwdx, dwdy in (
            (x0, y0, (x1 - tx) * (y1 - ty), -(y1 - ty), -(x1 - tx)),
            (x1, y0, (tx - x0) * (y1 - ty), (y1 - ty), -(tx - x0)),
            (x0, y1, (x1 - tx) * (ty - y0), -(ty - y0), (x1 - tx)),
            (x1, y1, (tx - x0) * (ty - y0), (ty - y0), (tx - x0))):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & finite
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        yield inside, flat, w, dwdx, dwdy


def splat_backward(inp, flow, metric, frames_per_source, g_acc, g_norm=None):
    """Gradients of `splat_plain(inp, flow, metric, frames_per_source,
    with_norm=g_norm is not None)` at g_acc [B, H, W, C] (and g_norm
    [B, H, W]): (d_in [S, H, W, C] in inp's dtype, d_flow [B, H, W, 2] in
    flow's, d_metric shaped as metric or None). Each source pixel gathers
    the output gradient at its four taps: d_in from the weights, d_flow
    from their derivatives (the JAX package's `_splat_bwd`), d_metric from
    both sums."""
    B, (_, H, W, C) = flow.shape[0], inp.shape
    P, dev = H * W, inp.device
    frame_src = torch.arange(B, device=dev) // frames_per_source
    src = inp.float()[frame_src].reshape(B, P, C)
    m = None if metric is None else metric.float().reshape(B, P)
    ga = g_acc.float().reshape(B, P, C)
    gn = None if g_norm is None else g_norm.float().reshape(B, P)
    d_src = torch.zeros(B, P, C, device=dev, dtype=torch.float32)
    d_fx = torch.zeros(B, P, device=dev, dtype=torch.float32)
    d_fy = torch.zeros_like(d_fx)
    d_m = None if m is None else torch.zeros_like(d_fx)
    for inside, flat, w, dwdx, dwdy in _taps(flow, H, W):
        g_tap = torch.gather(ga, 1, flat[..., None].expand(B, P, C))
        g_tap = torch.where(inside[..., None], g_tap, 0.0)      # [B, P, C]
        d_src += w[..., None] * g_tap
        gi = (g_tap * src).sum(-1)                              # d / d (x m w)
        if gn is not None:
            gi = gi + torch.where(inside, torch.gather(gn, 1, flat), 0.0)
        if d_m is not None:
            d_m += w * gi
            gi = gi * m
        d_fx += dwdx * gi
        d_fy += dwdy * gi
    if m is not None:
        d_src = d_src * m[..., None]
    d_in = torch.zeros(inp.shape[0], P, C, device=dev, dtype=torch.float32)
    d_in.index_add_(0, frame_src, d_src)
    d_flow = torch.stack([d_fx, d_fy], dim=-1).reshape(B, H, W, 2)
    return (d_in.reshape(inp.shape).to(inp.dtype), d_flow.to(flow.dtype),
            None if d_m is None else d_m.reshape(metric.shape).to(metric.dtype))


def _launch_splat(inp, flow, metric, frames_per_source, with_norm):
    if inp.dtype not in _DTYPES:
        raise TypeError(f"the softsplat kernel takes fp32 or bf16; got {inp.dtype}")
    from mofa_tpu_torch.kernels._build import launch
    B, (_, H, W, C) = flow.shape[0], inp.shape
    src = inp.contiguous()
    if src.data_ptr() % 16:
        src = src.clone()
    f = flow.float().contiguous()
    m = None if metric is None else metric.float().reshape(B, H, W).contiguous()
    acc = torch.zeros(B, H, W, C, device=inp.device, dtype=torch.float32)
    norm = (torch.zeros(B, H, W, device=inp.device, dtype=torch.float32)
            if with_norm else None)
    launch("mofa_softsplat", inp.device, src.data_ptr(), f.data_ptr(),
           None if m is None else m.data_ptr(), acc.data_ptr(),
           None if norm is None else norm.data_ptr(), B, H, W, C,
           frames_per_source, _DTYPES[src.dtype])
    count_launch("softsplat")
    return acc, norm


class _SplatFunction(torch.autograd.Function):
    """The splat kernel; `splat_backward` for the gradient. Returns
    (acc, norm), norm None without with_norm."""

    @staticmethod
    def forward(ctx, inp, flow, metric, frames_per_source, with_norm):
        ctx.save_for_backward(inp, flow, metric)
        ctx.frames_per_source = frames_per_source
        acc, norm = _launch_splat(inp, flow, metric, frames_per_source, with_norm)
        return acc, norm

    @staticmethod
    def backward(ctx, g_acc, g_norm):
        inp, flow, metric = ctx.saved_tensors
        d_in, d_flow, d_m = splat_backward(inp, flow, metric,
                                           ctx.frames_per_source, g_acc, g_norm)
        return d_in, d_flow, d_m, None, None


def splat_raw(inp: torch.Tensor, flow: torch.Tensor,
              metric: torch.Tensor | None = None,
              frames_per_source: int = 1, with_norm: bool = False):
    """Raw (un-normalised) forward splat, as `splat_plain`: the kernel
    takes inp in fp32 or bf16 and the rest as fp32. One launch count."""
    _check(inp, flow, metric, frames_per_source)
    tensors = [t for t in (inp, flow, metric) if t is not None]
    if not use_kernel(*tensors):
        return splat_plain(inp, flow, metric, frames_per_source, with_norm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        acc, norm = _SplatFunction.apply(inp, flow, metric, frames_per_source,
                                         with_norm)
    else:
        acc, norm = _launch_splat(inp, flow, metric, frames_per_source, with_norm)
    return (acc, norm) if with_norm else acc


def normalize_plain(acc: torch.Tensor, norm: torch.Tensor | None,
                    eps: str | None, dtype) -> torch.Tensor:
    """acc / f(norm) in fp32, cast to `dtype` (the JAX wrapper's tail);
    norm None: a cast ('sum')."""
    if norm is None:
        return acc.to(dtype)
    norm = norm[..., None]
    if eps == "addeps":
        norm = norm + 1e-7
    elif eps == "zeroeps":
        norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    elif eps == "clipeps":
        norm = norm.clamp(min=1e-7)
    return (acc / norm).to(dtype)


def normalize_backward(acc, norm, eps, g):
    """(d acc, d norm or None) at `g` = d out: the VJP of
    `normalize_plain`, recomputed."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (acc, norm)
                  if t is not None]
        out = normalize_plain(leaves[0], leaves[1] if norm is not None else None,
                              eps, g.dtype)
        grads = torch.autograd.grad(out, leaves, g)
    return grads[0], (grads[1] if norm is not None else None)


class _NormalizeFunction(torch.autograd.Function):
    """The normalising kernel; `normalize_backward` for the gradient."""

    @staticmethod
    def forward(ctx, acc, norm, eps, dtype):
        ctx.save_for_backward(acc, norm)
        ctx.eps = eps
        return _launch_normalize(acc, norm, eps, dtype)

    @staticmethod
    def backward(ctx, g):
        acc, norm = ctx.saved_tensors
        return (*normalize_backward(acc, norm, ctx.eps, g), None, None)


def normalize(acc: torch.Tensor, norm: torch.Tensor | None, eps: str | None,
              dtype) -> torch.Tensor:
    """The normalising pass: one CUDA launch on a card (counted with its
    splat: no count of its own), `normalize_plain` on the CPU."""
    tensors = [t for t in (acc, norm) if t is not None]
    if not use_kernel(*tensors):
        return normalize_plain(acc, norm, eps, dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _NormalizeFunction.apply(acc, norm, eps, dtype)
    return _launch_normalize(acc, norm, eps, dtype)


def _launch_normalize(acc, norm, eps, dtype) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise TypeError(f"the softsplat kernel writes fp32 or bf16; got {dtype}")
    from mofa_tpu_torch.kernels._build import launch
    acc = acc.contiguous()
    out = torch.empty(acc.shape, device=acc.device, dtype=dtype)
    code = -1 if norm is None else EPS_POLICIES.index(eps)
    launch("mofa_softsplat_normalize", acc.device, acc.data_ptr(),
           None if norm is None else norm.contiguous().data_ptr(),
           out.data_ptr(), acc[..., 0].numel(), acc.shape[-1], code,
           _DTYPES[dtype])
    return out


def softsplat(ten_in: torch.Tensor, ten_flow: torch.Tensor,
              ten_metric: torch.Tensor | None = None, mode: str = "avg",
              frames_per_source: int = 1) -> torch.Tensor:
    """Forward softmax splatting, channel-last; fp32 math, output in the
    input dtype (mofa_tpu.kernels.softsplat.softsplat), with output frame
    b splatting source frame b // frames_per_source."""
    parts = mode.split("-")
    base = parts[0]
    eps = parts[1] if len(parts) > 1 else "addeps"
    if base not in MODES or eps not in EPS_POLICIES:
        raise ValueError(mode)
    if base in ("sum", "avg"):
        m = None
    elif base == "linear":
        m = ten_metric.to(math_dtype(ten_in.dtype))
    else:
        m = torch.exp(ten_metric.to(math_dtype(ten_in.dtype)))
    if base == "sum":
        acc, norm = splat_raw(ten_in, ten_flow, None, frames_per_source), None
    else:
        acc, norm = splat_raw(ten_in, ten_flow, m, frames_per_source,
                              with_norm=True)
    return normalize(acc, norm, eps, ten_in.dtype)
