"""Train state: AdamW with global-norm clipping, the freeze mask, EMA, the step.

Counterpart of mofa_tpu/train/state.py (the reference's torch AdamW,
`requires_grad_(False)` freezing and EMAModel; Training/train_stage1.py:
753-755, 835-843; stage 2's freeze set, train_stage2.py:949-956):

- AdamW at the train_stage1.sh defaults (lr 2e-5, weight decay 1e-2,
  b1 0.9, b2 0.999, eps 1e-8) over the trainable parameters, after
  clipping the gradients to a global norm of 1.0 as optax's
  `clip_by_global_norm` does (scaled by max_norm / norm when the norm is
  at least max_norm);
- the freeze mask: a parameter whose '.'-joined name matches one of the
  patterns (`re.search`) is frozen: no gradient, no update, no decay;
- EMA of the trainable parameters, e * d + p * (1 - d) after every
  update, decay 0.9999; and the step counter.

The memory-lean factored optimizer (`--use_8bit_adam`, optax adafactor in
the JAX package) is not ported (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import contextlib
import re

import torch

# stage-2 freeze set (Training/train_stage2.py:949-956)
STAGE2_FROZEN = (r"flow_encoder", r"controlnet_cond_embedding")


def freeze_mask(module: torch.nn.Module, frozen_patterns=()) -> dict:
    """Parameter name -> True where trainable (no pattern matches)."""
    return {name: not any(re.search(p, name) for p in frozen_patterns)
            for name, _ in module.named_parameters()}


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / norm where their global norm
    is at least max_norm (optax.clip_by_global_norm); returns the norm
    before clipping (fp32, on the grads' device)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class TrainState:
    """The trainable parameters of `model` (the adapter), their AdamW state
    and EMA, and the step. Frozen parameters are set to requires_grad
    False; the trainable ones to True."""

    def __init__(self, model: torch.nn.Module, lr: float = 2e-5,
                 weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, max_grad_norm: float = 1.0,
                 frozen_patterns=(), ema: bool = False,
                 ema_decay: float = 0.9999):
        mask = freeze_mask(model, frozen_patterns)
        self.model = model
        self.names, self.params = [], []
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
            if mask[name]:
                self.names.append(name)
                self.params.append(p)
        self.max_grad_norm = max_grad_norm
        self.ema_decay = ema_decay
        self.optimizer = torch.optim.AdamW(self.params, lr=lr, betas=(b1, b2),
                                           eps=eps, weight_decay=weight_decay)
        self.ema = ([p.detach().clone() for p in self.params] if ema else None)
        self.step = 0

    def apply_gradients(self) -> torch.Tensor:
        """Clip the accumulated `.grad`s, take one AdamW step, update the
        EMA, count the step; returns the gradient's global norm before
        clipping. The grads are cleared. A trainable parameter that autograd
        never reached (the cross-attention's q and k over one context
        token, whose softmax is 1, are skipped by the attention) takes a
        zero gradient, as in JAX's grads: AdamW still decays it."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = clip_by_global_norm_(grads, self.max_grad_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(self.ema, self.ema_decay)
                torch._foreach_add_(self.ema, self.params,
                                    alpha=1.0 - self.ema_decay)
        self.step += 1
        return norm

    @contextlib.contextmanager
    def ema_weights(self):
        """Inside, the adapter's trainable parameters hold the EMA (where
        the state keeps one): their storages are swapped, not copied, and
        swapped back on exit."""
        if self.ema is None:
            yield
            return
        for p, e in zip(self.params, self.ema):
            p.data, e.data = e.data, p.data
        try:
            yield
        finally:
            for p, e in zip(self.params, self.ema):
                p.data, e.data = e.data, p.data

    def export_state_dict(self) -> dict:
        """The adapter's full state dict with the EMA in place of the
        trainable parameters where there is one (what export writes)."""
        sd = {k: v.detach() for k, v in self.model.state_dict().items()}
        if self.ema is not None:
            sd.update(zip(self.names, self.ema))
        return sd

    def state_dict(self) -> dict:
        """Everything a bit-exact resume needs of the state."""
        return {"step": self.step,
                "params": {n: p.detach().clone() for n, p in
                           zip(self.names, self.params)},
                "optimizer": self.optimizer.state_dict(),
                "ema": None if self.ema is None else
                [e.clone() for e in self.ema]}

    def load_state_dict(self, sd: dict) -> None:
        if list(sd["params"]) != self.names:
            raise KeyError("checkpoint parameters differ from the adapter's "
                           "trainable ones")
        if (sd["ema"] is None) != (self.ema is None):
            raise ValueError("checkpoint and state disagree on EMA")
        with torch.no_grad():
            for p, v in zip(self.params, sd["params"].values()):
                p.copy_(v)
            if self.ema is not None:
                for e, v in zip(self.ema, sd["ema"]):
                    e.copy_(v)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
