"""Forward softmax splatting (softsplat), channel-last.

Counterpart of mofa_tpu/kernels/softsplat.py. The raw bilinear splat is
the CUDA kernel `csrc/softsplat.cu` (replacing the TPU's
`kernels/softsplat_pallas.py::_splat_kernel`, which computes the scatter
as one-hot matmuls because the TPU has no atomics): one thread per
(source pixel, channel) with fp32 `atomicAdd` into the 4 taps. It is
bound by the atomics and the input read; see the source note.

The mode normalisation ('sum' / 'avg' / 'linear' / 'soft') and the eps
policies ('-addeps' / '-zeroeps' / '-clipeps') stay here in PyTorch,
exactly as in the JAX wrapper. Layout: ten_in [B, H, W, C], ten_flow
[B, H, W, 2] with flow[..., 0] = dx (columns), flow[..., 1] = dy (rows).
Forward only; the gather backward comes with training.
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.kernels import check_no_grad, count_launch, use_kernel



def splat_plain(inp: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] x [B, H, W, 2] -> [B, H, W, C] fp32 by `index_add_`
    (mirrors mofa_tpu's `_splat_xla`)."""
    B, H, W, C = inp.shape
    P = H * W
    dev = inp.device
    cols = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
    rows = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
    tx = (cols + flow[..., 0]).reshape(B, P)
    ty = (rows + flow[..., 1]).reshape(B, P)
    finite = torch.isfinite(tx) & torch.isfinite(ty)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    x1, y1 = x0 + 1.0, y0 + 1.0
    src = inp.reshape(B * P, C)
    out = torch.zeros(B * P + 1, C, device=dev, dtype=torch.float32)
    base = (torch.arange(B, device=dev) * P)[:, None]
    for xi, yi, w in ((x0, y0, (x1 - tx) * (y1 - ty)),
                      (x1, y0, (tx - x0) * (y1 - ty)),
                      (x0, y1, (x1 - tx) * (ty - y0)),
                      (x1, y1, (tx - x0) * (ty - y0))):
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & finite
        flat = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long() + base
        idx = torch.where(inside, flat, B * P).reshape(-1)   # B*P = dropped
        vals = src * torch.where(inside, w, 0.0).reshape(-1, 1)
        out.index_add_(0, idx, vals)
    return out[:B * P].reshape(B, H, W, C)


def splat_raw(inp: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Raw (un-normalised) forward splat, fp32 in and out."""
    if inp.dtype != torch.float32 or flow.dtype != torch.float32:
        raise TypeError("splat_raw takes fp32 tensors")
    if inp.ndim != 4 or flow.shape != inp.shape[:3] + (2,):
        raise ValueError(f"bad shapes {tuple(inp.shape)} / {tuple(flow.shape)}")
    if not use_kernel(inp, flow):
        return splat_plain(inp, flow)
    check_no_grad("softsplat", inp, flow)
    from mofa_tpu_torch.kernels._build import launch
    inp, flow = inp.contiguous(), flow.contiguous()
    B, H, W, C = inp.shape
    out = torch.zeros_like(inp)
    launch("mofa_softsplat_f32", inp.device, inp.data_ptr(), flow.data_ptr(),
           out.data_ptr(), B, H, W, C)
    count_launch("softsplat")
    return out


def softsplat(ten_in: torch.Tensor, ten_flow: torch.Tensor,
              ten_metric: torch.Tensor | None = None,
              mode: str = "avg") -> torch.Tensor:
    """Forward softmax splatting, channel-last; fp32 math, output in the
    input dtype (mofa_tpu.kernels.softsplat.softsplat)."""
    base = mode.split("-")[0]
    if base not in ("sum", "avg", "linear", "soft"):
        raise ValueError(mode)
    dt = ten_in.dtype
    x = ten_in.float()
    f = ten_flow.float()
    if base == "sum":
        return splat_raw(x, f).to(dt)
    if base == "avg":
        x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    elif base == "linear":
        m = ten_metric.float()
        x = torch.cat([x * m, m], dim=-1)
    else:
        m = torch.exp(ten_metric.float())
        x = torch.cat([x * m, m], dim=-1)
    out = splat_raw(x, f)
    norm = out[..., -1:]
    parts = mode.split("-")
    if len(parts) == 1 or parts[1] == "addeps":
        norm = norm + 1e-7
    elif parts[1] == "zeroeps":
        norm = torch.where(norm == 0.0, torch.ones_like(norm), norm)
    elif parts[1] == "clipeps":
        norm = norm.clamp(min=1e-7)
    return (out[..., :-1] / norm).to(dt)
