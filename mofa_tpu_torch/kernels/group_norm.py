"""GroupNorm with one-pass per-channel statistics, channel-last.

Counterpart of mofa_tpu/kernels/group_norm.py. The CUDA kernel
`csrc/channel_sums.cu` replaces the TPU's `_stats_kernel`
(`_channel_sums`): x3 [N, S, C] -> per-(N, C) fp32 Σx and Σx² in one read
of x. Threads run along C with 16-byte loads, each block reduces a slab of
S rows in registers and shared memory, and the slabs meet in fp32
`atomicAdd`s (so the sum order, and the last bits of the sums, change from
run to run). It is bound by device memory: one read of x.

As in the JAX package, the group combine and the `x*a + b` apply stay
plain tensor ops on the tiny [N, C] statistics, and no model calls these
functions: the port's resnet blocks run `models/layers.GroupNorm`.

Both entry points have the JAX package's gradients: on a CUDA tensor
with grad enabled `channel_sums` runs its kernel inside an autograd
Function whose backward is `channel_sums_backward` (`_cs_bwd`,
group_norm.py:116, the sums' cotangents broadcast over S), and
`fused_group_norm` its whole forward inside one whose backward is the VJP
of `group_norm_plain` recomputed (`_bwd`, :184).
"""

from __future__ import annotations

import torch

from mofa_tpu_torch.kernels import (count_launch, kernel_route, use_kernel,
                                    vjp_plain)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNKS = 256          # C / (values per 16-byte load): one block's threads


def _values_per_load(dtype) -> int:
    return 16 // (4 if dtype == torch.float32 else 2)


def _kernel_takes(c: int, dtype) -> bool:
    vec = _values_per_load(dtype)
    return dtype in _DTYPES and c % vec == 0 and c // vec <= MAX_CHUNKS


def slab_rows(c: int, dtype) -> int:
    """Rows of S that one block of the kernel reduces (csrc/channel_sums.cu:
    MAX_CHUNKS // (C / values per load) row groups x 32 rows each)."""
    return MAX_CHUNKS // (c // _values_per_load(dtype)) * 32


def channel_sums_plain(x3: torch.Tensor):
    """Plain version: (Σx, Σx²) over axis 1 of [N, S, C], fp32."""
    xf = x3.float()
    return xf.sum(1), (xf * xf).sum(1)


def channel_sums_backward(x3, g1, g2):
    """d x3 at the cotangents (g1, g2) [N, C] of (Σx, Σx²): g1 + 2 x g2
    over S in fp32, cast to x3's dtype (the JAX package's `_cs_bwd`)."""
    return (g1[:, None] + 2.0 * x3.float() * g2[:, None]).to(x3.dtype)


def _launch_sums(x3):
    n, s, c = x3.shape
    if not _kernel_takes(c, x3.dtype):
        raise ValueError(f"channel_sums kernel takes fp32/bf16 with C a multiple "
                         f"of one 16-byte load and at most {MAX_CHUNKS} loads; "
                         f"got C={c}, {x3.dtype}")
    from mofa_tpu_torch.kernels._build import launch
    x3 = x3.contiguous()
    if x3.data_ptr() % 16:
        x3 = x3.clone()
    sums = torch.zeros(2, n, c, device=x3.device, dtype=torch.float32)
    launch("mofa_channel_sums", x3.device, x3.data_ptr(), sums[0].data_ptr(),
           sums[1].data_ptr(), n, s, c, _DTYPES[x3.dtype])
    count_launch("channel_sums")
    return sums[0], sums[1]


def channel_sums(x3: torch.Tensor):
    """x3 [N, S, C] -> (s1, s2), each [N, C] fp32, in one pass over x3."""
    if x3.ndim != 3:
        raise ValueError(f"channel_sums takes [N, S, C]; got {tuple(x3.shape)}")
    if not use_kernel(x3):
        return channel_sums_plain(x3)
    return kernel_route(_launch_sums,
                        lambda x, g1, g2: (channel_sums_backward(x, g1, g2),), x3)


def stats_from_sums(s1, s2, spatial_count: int, num_groups: int, eps: float):
    """(s1, s2) [N, C] per-channel sums -> (mean_c, inv_c) [N, C] fp32 with
    group-combined statistics (the same math as torch GroupNorm)."""
    n0, c = s1.shape
    g = num_groups
    cnt = spatial_count * (c // g)
    gs1 = s1.reshape(n0, g, c // g).sum(-1)
    gs2 = s2.reshape(n0, g, c // g).sum(-1)
    mean = gs1 / cnt
    var = (gs2 / cnt - mean * mean).clamp(min=0.0)
    inv = torch.rsqrt(var + eps)
    return (mean.repeat_interleave(c // g, dim=-1),
            inv.repeat_interleave(c // g, dim=-1))


def gn_affine(x3, scale, bias, num_groups: int, eps: float):
    """The folded GroupNorm affine of x3 [N, S, C]: a, b [N, C] fp32 with
    GroupNorm(x) = x*a + b, statistics from `channel_sums`."""
    s1, s2 = channel_sums(x3)
    mean_c, inv_c = stats_from_sums(s1, s2, x3.shape[1], num_groups, eps)
    a = inv_c * scale.float()[None, :]
    return a, bias.float()[None, :] - mean_c * a


def group_norm_plain(x, scale, bias, num_groups: int, eps: float):
    """Plain GroupNorm on [N, ..., C] (mofa_tpu `_gn_ref`): fp32 statistics
    over all middle axes and the group's channels, E[x²] - mean² variance."""
    c = x.shape[-1]
    n0 = x.shape[0]
    xf = x.float().reshape(n0, -1, c)
    mean_c, inv_c = stats_from_sums(xf.sum(1), (xf * xf).sum(1), xf.shape[1],
                                    num_groups, eps)
    y = (xf - mean_c[:, None]) * (inv_c * scale.float())[:, None] + bias.float()
    return y.reshape(x.shape).to(x.dtype)


def group_norm_backward(x, scale, bias, g, num_groups: int, eps: float):
    """(dx, d scale, d bias) at `g` = d out: the VJP of `group_norm_plain`,
    recomputed (the JAX package's `_bwd`, the VJP of `_gn_ref`)."""
    return vjp_plain(lambda *a: group_norm_plain(*a, num_groups, eps),
                     (x, scale, bias), g)


def _fused_apply(x, scale, bias, num_groups: int, eps: float):
    n0, c = x.shape[0], x.shape[-1]
    a, b = gn_affine(x.reshape(n0, -1, c), scale, bias, num_groups, eps)
    bshape = (n0,) + (1,) * (x.ndim - 2) + (c,)
    return (x.float() * a.reshape(bshape) + b.reshape(bshape)).to(x.dtype)


def fused_group_norm(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm of x [N, ..., C] (scale / bias [C]) with one-pass
    statistics: `channel_sums`, then x*a + b in fp32, cast to x's dtype."""
    if not use_kernel(x, scale, bias):
        return _fused_apply(x, scale, bias, num_groups, eps)
    return kernel_route(
        lambda *a: _fused_apply(*a, num_groups, eps),
        lambda *a: group_norm_backward(*a, num_groups, eps), x, scale, bias)
