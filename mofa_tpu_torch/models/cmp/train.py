"""CMP training: losses, warps, the step LR schedule, SGD, the train step.

Counterpart of mofa_tpu/models/cmp/train.py (the reference's
models/cmp/losses.py, models/modules/warp.py, utils/scheduler.py and
SingleStageModel's step, single_stage_model.py:10-72):

- `discrete_flow_loss` (DiscreteLoss, with the `target >= nbins` clamp),
  `multi_discrete_flow_loss` (linear or quadratic bins), `kld_loss`,
  `edge_aware_loss` (smooth L1 between Sobel edge maps);
- `grid_sample_norm`, `warp_backward` (the reference's align_corners=True
  grid sampled with align_corners=False, kept) and `warp_forward_sorted`
  (collisions won by the largest flow magnitude);
- `step_lr_schedule` (warmup interpolation, then milestone multipliers);
- `CMPSGD`, optax's `chain(add_decayed_weights, sgd(schedule, momentum))`:
  the decayed weights added to the gradient, a momentum trace g + m * t,
  the step -lr(k) * t with the schedule read at update k;
- `make_cmp_train_step`: the discrete loss on `CMP.logits`, every
  parameter differentiated. As in the JAX package, whose BatchNorm keeps
  `mean` / `var` as params, the BatchNorm statistics are parameters here
  (`bn_stats_as_parameters`) and SGD moves them (ROADMAP Queue 3 item 9);
  inference keeps nn.BatchNorm2d in eval().

Tensors are [N, H, W, C] as in the JAX package.
"""

from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mofa_tpu_torch.models.gmflow.model import bilinear_sample
from mofa_tpu_torch.ops.resize import resize_nhwc


# ------------------------------------------------------------------ losses

def _check_odd(nbins: int) -> None:
    if nbins % 2 != 1:
        raise ValueError(f"nbins must be odd, got {nbins}")


def _ce(logits: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, bins[..., None]).squeeze(-1).mean()


def discrete_flow_loss(logits: torch.Tensor, target_flow: torch.Tensor,
                       nbins: int = 99, fmax: float = 50.0) -> torch.Tensor:
    """DiscreteLoss: the flow quantised into nbins a component, the
    cross-entropies of both components summed; bins >= nbins clamped to
    nbins - 1. logits [N, h, w, 2*nbins] (bilinear, align_corners, to the
    target's size where it differs); target_flow [N, H, W, 2]."""
    _check_odd(nbins)
    step = 2 * fmax / float(nbins)
    if logits.shape[1:3] != target_flow.shape[1:3]:
        logits = resize_nhwc(logits, tuple(target_flow.shape[1:3]), "bilinear",
                             align_corners=True)
    t = target_flow.clamp(-fmax + 1e-3, fmax - 1e-3)
    bins = torch.floor((t + fmax) / step).long().clamp(max=nbins - 1)
    return _ce(logits[..., :nbins], bins[..., 0]) + _ce(logits[..., nbins:], bins[..., 1])


def multi_discrete_flow_loss(logits, target_flow, nbins: int = 19,
                             fmax: float = 47.5, xy_weight=(1.0, 1.0),
                             quantize_strategy: str = "linear"):
    """MultiDiscreteLoss: linear or quadratic bins, weighted per component."""
    _check_odd(nbins)
    step = 2 * fmax / float(nbins)
    t = target_flow.clamp(-fmax + 1e-3, fmax - 1e-3)
    if quantize_strategy == "linear":
        bins = torch.floor((t + fmax) / step)
    elif quantize_strategy == "quadratic":
        root = torch.sqrt(t.abs() / (4 * fmax))
        bins = torch.where(t > 0, torch.floor(nbins * root + nbins / 2.0),
                           torch.floor(-nbins * root + nbins / 2.0))
    else:
        raise ValueError(quantize_strategy)
    bins = bins.long()
    wx, wy = xy_weight
    return wx * _ce(logits[..., :nbins], bins[..., 0]) + \
        wy * _ce(logits[..., nbins:], bins[..., 1])


def kld_loss(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.sum(1 + logvar - mean ** 2 - torch.exp(logvar))


def _sobel_edge_map(x: torch.Tensor) -> torch.Tensor:
    """Per-channel Sobel gx / gy (depthwise, zero padding 1), magnitude
    sqrt(gx^2 + gy^2 + 1e-5), mean over channels: [N, H, W, C] -> [N, H, W, 1]."""
    c = x.shape[-1]
    kx = x.new_tensor([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype=torch.float32)
    ky = x.new_tensor([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], dtype=torch.float32)
    xin = x.float().permute(0, 3, 1, 2)

    def depthwise(k):
        return F.conv2d(xin, k.expand(c, 1, 3, 3), padding=1, groups=c)

    mag = torch.sqrt(depthwise(kx) ** 2 + depthwise(ky) ** 2 + 1e-5)
    return mag.mean(dim=1, keepdim=True).permute(0, 2, 3, 1)


def edge_aware_loss(pred_flow: torch.Tensor, target_flow: torch.Tensor) -> torch.Tensor:
    """EdgeAwareLoss: the mean smooth L1 (Huber, delta 1) between the Sobel
    edge maps of the prediction (resized to the target's size, bilinear,
    align_corners) and of the target."""
    if pred_flow.shape[1:3] != target_flow.shape[1:3]:
        pred_flow = resize_nhwc(pred_flow, tuple(target_flow.shape[1:3]), "bilinear",
                                align_corners=True)
    return F.huber_loss(_sobel_edge_map(pred_flow), _sobel_edge_map(target_flow),
                        delta=1.0)


# ------------------------------------------------------------------ warps

def grid_sample_norm(image: torch.Tensor, grid: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """torch's grid_sample on [-1, 1] coordinates with zero padding, NHWC:
    image [B, H, W, C], grid [B, H', W', 2] (x, y)."""
    h, w = image.shape[1:3]
    if align_corners:
        px = (grid[..., 0] + 1) * (w - 1) / 2
        py = (grid[..., 1] + 1) * (h - 1) / 2
    else:
        px = ((grid[..., 0] + 1) * w - 1) / 2
        py = ((grid[..., 1] + 1) * h - 1) / 2
    return bilinear_sample(image, torch.stack([px, py], dim=-1))


def warp_backward(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """WarpingLayerBWFlow: a grid built for align_corners=True, sampled
    with grid_sample's default align_corners=False (the reference's
    mismatch, kept)."""
    h, w = image.shape[1:3]
    gx = torch.linspace(-1.0, 1.0, w, device=image.device)
    gy = torch.linspace(-1.0, 1.0, h, device=image.device)
    base = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), dim=-1)[None]
    norm = torch.stack([flow[..., 0] / ((w - 1.0) / 2.0),
                        flow[..., 1] / ((h - 1.0) / 2.0)], dim=-1)
    return grid_sample_norm(image, base + norm, align_corners=False)


def warp_forward_sorted(image: torch.Tensor, flow: torch.Tensor,
                        ret_mask: bool = False):
    """WarpingLayerFWFlow: each source pixel scattered to its target (the
    flow truncated to integers, clamped to the image); where sources
    collide the one of the largest flow magnitude wins (ties by position,
    as a stable sort orders them). With ret_mask also the holes [B, H, W,
    1]: 1 where no source landed."""
    b, h, w, c = image.shape
    n = h * w
    dev = image.device
    xs = torch.arange(w, device=dev).repeat(h)
    ys = torch.arange(h, device=dev).repeat_interleave(w)
    fx = flow[..., 0].reshape(b, n).to(torch.int32)
    fy = flow[..., 1].reshape(b, n).to(torch.int32)
    tx = (xs[None] + fx).clamp(0, w - 1)
    ty = (ys[None] + fy).clamp(0, h - 1)
    tgt = (ty * w + tx).long()                                  # [B, N]
    v = (flow[..., 0] ** 2 + flow[..., 1] ** 2).reshape(b, n)
    order = torch.argsort(v, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    win = torch.full((b, n), -1, dtype=rank.dtype, device=dev).scatter_reduce(
        1, tgt, rank, reduce="amax", include_self=True)
    keep = rank == win.gather(1, tgt)
    src = torch.where(keep[..., None], image.reshape(b, n, c), 0.0)
    idx = torch.where(keep, tgt, n)                             # losers past the end
    out = torch.zeros(b, n + 1, c, dtype=image.dtype, device=dev)
    out = out.scatter_add(1, idx[..., None].expand(b, n, c), src)[:, :n]
    hole = torch.ones(b, n, dtype=image.dtype, device=dev).scatter(
        1, tgt, torch.zeros_like(tgt, dtype=image.dtype))
    warped = out.reshape(b, h, w, c)
    if ret_mask:
        return warped, hole.reshape(b, h, w, 1)
    return warped


# ------------------------------------------------------------------ schedule

def step_lr_schedule(base_lr: float, milestones: Sequence[int],
                     lr_mults: Sequence[float], warmup_lr: Sequence[float] = (),
                     warmup_steps: Sequence[int] = ()):
    """StepLRScheduler as a function of the update count: a piecewise
    linear warmup through (warmup_steps, warmup_lr) from base_lr, then
    the milestone multipliers (from the last warmup lr where there is a
    warmup). Computed in fp32, as the JAX schedule is."""
    if len(milestones) != len(lr_mults):
        raise ValueError("one multiplier a milestone")
    f32 = np.float32
    cum = [1.0]
    for m in lr_mults:
        cum.append(cum[-1] * m)
    cum = np.asarray(cum, np.float32)
    xi = np.asarray([0] + list(warmup_steps), np.float32)
    li = np.asarray([base_lr] + list(warmup_lr), np.float32)

    def schedule(step: int) -> float:
        scale = cum[bisect.bisect_right(list(milestones), step)]
        if warmup_lr:
            scale = f32(warmup_lr[-1]) * scale / f32(base_lr)
        lr = f32(base_lr) * scale
        if warmup_steps and step < warmup_steps[-1]:
            lr = f32(np.interp(f32(step), xi, li))
        return float(lr)

    return schedule


class CMPSGD(torch.optim.Optimizer):
    """optax.chain(add_decayed_weights(weight_decay), sgd(schedule,
    momentum)): g' = g + weight_decay * p; t = g' + momentum * t;
    p += -schedule(k) * t at update k (from 0). The count sits in the
    parameter group, the trace in each parameter's state."""

    def __init__(self, params, schedule, momentum: float = 0.9,
                 weight_decay: float = 1e-4):
        super().__init__(list(params), dict(momentum=momentum,
                                            weight_decay=weight_decay, count=0))
        self.schedule = schedule
        for p in self.param_groups[0]["params"]:
            self.state[p]["trace"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        lr = float(np.float32(-self.schedule(group["count"])))
        for p in group["params"]:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            t = self.state[p]["trace"]
            t.copy_(g + group["weight_decay"] * p + group["momentum"] * t)
            p.add_(t * lr)
        group["count"] += 1


def make_cmp_optimizer(params, base_lr: float = 0.04, momentum: float = 0.9,
                       weight_decay: float = 1e-4,
                       milestones: Sequence[int] = (24000, 36000),
                       lr_mults: Sequence[float] = (0.1, 0.1)) -> CMPSGD:
    """SGD with the step schedule of the shipped CMP config
    (experiments/semiauto_annot/resnet50_vip+mpii_liteflow/config.yaml)."""
    return CMPSGD(params, step_lr_schedule(base_lr, milestones, lr_mults),
                  momentum=momentum, weight_decay=weight_decay)


def make_cmp_train_step(cmp, optimizer: torch.optim.Optimizer, nbins: int = 99,
                        fmax: float = 50.0):
    """step(batch) -> {"loss"}: the discrete loss on `cmp.logits`, its
    gradient into every parameter of `cmp` (BatchNorm statistics included,
    once `bn_stats_as_parameters` made them parameters), one optimizer
    step. batch: image [N, H, W, 3] (normalised), sparse / mask [N, H, W,
    2], target_flow [N, H, W, 2]."""

    def step(batch: dict) -> dict:
        optimizer.zero_grad(set_to_none=True)
        logits = cmp.logits(batch["image"], batch["sparse"], batch["mask"])
        loss = discrete_flow_loss(logits, batch["target_flow"], nbins, fmax)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step
