"""GMFlow / UniMatch flow training: the sequence loss, AdamW + one-cycle, the step.

Counterpart of mofa_tpu/models/gmflow/train.py (the reference's
Training/train_utils/unimatch/loss/flow_loss.py:4-37 and
main_flow.py:188-470):

- `flow_loss`: the gamma-weighted L1 over every prediction, masked by
  validity and |flow| < max_flow, with the EPE and the 1 / 3 / 5 px
  outlier rates of the last prediction;
- `cosine_onecycle_schedule`: optax's schedule written out (a cosine from
  peak / div_factor up to peak over the first pct_start of the steps, then
  down to peak / (div_factor * final_div_factor)); it is not PyTorch's
  OneCycleLR, whose phases differ. Where pct_start * steps is below one
  step, optax divides by the empty interval and returns NaN at every
  step; here the empty interval is skipped (ROADMAP Queue 3 item 10);
- `make_flow_optimizer`: optax's adamw (b1 0.9, b2 0.999, eps 1e-8, the
  decay scaled by the learning rate), with the one-cycle schedule read at
  the update count when `total_steps` is given;
- `make_flow_train_step`: the loss on `GMFlow(..., return_preds=True)`,
  one optimizer step.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def flow_loss(flow_preds, flow_gt: torch.Tensor, valid: torch.Tensor,
              gamma: float = 0.9, max_flow: float = 400.0):
    """preds and gt [B, H, W, 2], valid [B, H, W] -> (loss, metrics)."""
    gt = flow_gt.float()
    mag = torch.sqrt((gt ** 2).sum(-1))
    vf = ((valid >= 0.5) & (mag < max_flow)).float()[..., None]
    n = len(flow_preds)
    loss = 0.0
    for i, pred in enumerate(flow_preds):
        loss = loss + gamma ** (n - i - 1) * (vf * (pred.float() - gt).abs()).mean()
    epe = torch.sqrt(((flow_preds[-1].float() - gt) ** 2).sum(-1))
    v = vf[..., 0]
    denom = v.sum().clamp(min=1.0)
    metrics = {"epe": (epe * v).sum() / denom,
               "1px": ((epe > 1) * v).sum() / denom,
               "3px": ((epe > 3) * v).sum() / denom,
               "5px": ((epe > 5) * v).sum() / denom}
    return loss, metrics


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule as a function of the update count
    (module note: an interval of no steps is skipped, not divided by)."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs a positive transition_steps")
    bounds = [0, int(pct_start * transition_steps), int(transition_steps)]
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(count: int) -> float:
        for i in range(2):
            lo, hi = bounds[i], bounds[i + 1]
            if lo <= count < hi:
                pct = (count - lo) / (hi - lo)
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
        return float(values[-1])

    return schedule


class OneCycleAdamW(torch.optim.AdamW):
    """AdamW whose learning rate is `schedule(k)` at update k (from 0), as
    optax reads a schedule at its update count."""

    def __init__(self, params, schedule, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, lr=schedule(0), betas=(b1, b2), eps=eps,
                         weight_decay=weight_decay)
        self.schedule = schedule
        self.count = 0

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self.schedule(self.count)
        out = super().step(closure)
        self.count += 1
        return out

    def state_dict(self):
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


def make_flow_optimizer(params, lr: float = 4e-4, weight_decay: float = 1e-4,
                        total_steps: int | None = None) -> torch.optim.Optimizer:
    """AdamW (main_flow.py:209-210), with the one-cycle schedule (5% warmup,
    cosine anneal; main_flow.py:391-396) when total_steps is given."""
    if total_steps:
        sched = cosine_onecycle_schedule(total_steps, lr, pct_start=0.05)
        return OneCycleAdamW(params, sched, weight_decay=weight_decay)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def make_flow_train_step(model, optimizer: torch.optim.Optimizer, gamma: float = 0.9):
    """step(batch) -> metrics (loss, epe, 1px, 3px, 5px; detached). batch:
    img0 / img1 [B, H, W, 3] in [0, 255], flow [B, H, W, 2], valid [B, H, W]."""

    def step(batch: dict) -> dict:
        optimizer.zero_grad(set_to_none=True)
        _, preds = model(batch["img0"], batch["img1"], return_preds=True)
        loss, metrics = flow_loss(preds, batch["flow"], batch["valid"], gamma=gamma)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}

    return step
