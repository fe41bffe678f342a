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
  update, decay 0.9999; and the step counter;
- the memory-lean optimizer (`--use_8bit_adam`; `memory_lean=True`), the
  JAX package's `optax.adafactor(lr, multiply_by_parameter_scale=False,
  weight_decay_rate=weight_decay)` after the same clipping, written out as
  `FactoredRMS`: factored second moments, update clipping, the learning
  rate, then the weight decay, which, as in optax's chain, is not scaled
  by the learning rate (ROADMAP Queue 3 item 8).
"""

from __future__ import annotations

import contextlib
import re

import numpy as np
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


# optax.adafactor's defaults, which the JAX package keeps
FACTORED_DECAY_RATE = 0.8
FACTORED_EPS = 1e-30
MIN_DIM_SIZE_TO_FACTOR = 128
CLIPPING_THRESHOLD = 1.0


# torch weight axis -> Flax kernel axis, by rank: the inverse of the
# transposes that carry a Flax kernel into a torch weight (dense [I, O] ->
# [O, I], conv HWIO -> OIHW, DHWIO -> OIDHW)
_FLAX_AXIS = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def flax_shape(name: str, shape: tuple) -> tuple:
    """The shape the JAX package gives parameter `name`: a weight of rank 2
    or more is a Flax kernel, laid out as `_FLAX_AXIS` says; every other
    parameter keeps its shape."""
    if name.rsplit(".", 1)[-1] != "weight" or len(shape) not in _FLAX_AXIS:
        return tuple(shape)
    perm = _FLAX_AXIS[len(shape)]
    return tuple(shape[perm.index(a)] for a in range(len(shape)))


def factored_dims(name: str, shape: tuple):
    """optax's rule (`factorized._factored_dims`) on the Flax shape: the
    axes of the second-largest and the largest dimension, (d1, d0), where
    the second-largest is at least MIN_DIM_SIZE_TO_FACTOR, else None;
    returned as axes of the torch tensor."""
    fshape = flax_shape(name, shape)
    if len(fshape) < 2:
        return None
    order = np.argsort(fshape)
    if fshape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    if fshape == tuple(shape):
        return int(order[-2]), int(order[-1])
    perm = _FLAX_AXIS[len(shape)]
    return perm.index(int(order[-2])), perm.index(int(order[-1]))


class FactoredRMS(torch.optim.Optimizer):
    """optax's adafactor chain as the JAX package builds it, for gradients
    already clipped to their global norm: `scale_by_factored_rms` (decay
    1 - (k + 1)^-0.8 at update k, eps 1e-30, a factored estimate for a
    parameter with two dimensions of at least 128, the factored axes chosen
    on its Flax layout), `clip_by_block_rms(1.0)`, the learning rate, then
    `add_decayed_weights` (weight_decay * param, the learning rate not
    applied), and the step against the result. State a parameter: v_row and
    v_col (factored) or v; the update count sits in the parameter group."""

    def __init__(self, named_params, lr: float, weight_decay: float):
        named_params = list(named_params)
        self.dims = [factored_dims(n, tuple(p.shape)) for n, p in named_params]
        super().__init__([p for _, p in named_params],
                         dict(lr=lr, weight_decay=weight_decay, count=0))
        for p, dims in zip(self.param_groups[0]["params"], self.dims):
            st = self.state[p]
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                st["v_row"] = p.new_zeros(tuple(s for a, s in enumerate(p.shape) if a != d0))
                st["v_col"] = p.new_zeros(tuple(s for a, s in enumerate(p.shape) if a != d1))

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        t = np.float32(group["count"] + 1)
        decay = np.float32(1.0) - t ** np.float32(-FACTORED_DECAY_RATE)
        keep, take = float(decay), float(np.float32(1.0) - decay)
        lr, wd, eps = group["lr"], group["weight_decay"], FACTORED_EPS
        for p, dims in zip(group["params"], self.dims):
            g = p.grad
            st = self.state[p]
            g2 = g * g + eps
            if dims is None:
                st["v"].mul_(keep).add_(g2 * take)
                u = g * st["v"] ** -0.5
            else:
                d1, d0 = dims
                st["v_row"].mul_(keep).add_(g2.mean(dim=d0) * take)
                st["v_col"].mul_(keep).add_(g2.mean(dim=d1) * take)
                red = d1 - 1 if d1 > d0 else d1
                row = (st["v_row"] / st["v_row"].mean(dim=red, keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (st["v_col"] ** -0.5).unsqueeze(d1)
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / CLIPPING_THRESHOLD, min=1.0)
            p.sub_(u * lr + wd * p)
        group["count"] += 1


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the tensors an optimizer keeps for its parameters."""
    return sum(t.numel() * t.element_size() for st in optimizer.state.values()
               for t in st.values() if torch.is_tensor(t))


class TrainState:
    """The trainable parameters of `model` (the adapter), their optimizer
    state (AdamW, or `FactoredRMS` with `memory_lean`) and EMA, and the
    step. Frozen parameters are set to requires_grad False; the trainable
    ones to True."""

    def __init__(self, model: torch.nn.Module, lr: float = 2e-5,
                 weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, max_grad_norm: float = 1.0,
                 frozen_patterns=(), ema: bool = False,
                 ema_decay: float = 0.9999, memory_lean: bool = False):
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
        if memory_lean:
            self.optimizer = FactoredRMS(zip(self.names, self.params), lr=lr,
                                         weight_decay=weight_decay)
        else:
            self.optimizer = torch.optim.AdamW(self.params, lr=lr, betas=(b1, b2),
                                               eps=eps, weight_decay=weight_decay)
        self.ema = ([p.detach().clone() for p in self.params] if ema else None)
        self.step = 0

    def apply_gradients(self) -> torch.Tensor:
        """Clip the accumulated `.grad`s, take one optimizer step, update the
        EMA, count the step; returns the gradient's global norm before
        clipping. The grads are cleared. A trainable parameter that autograd
        never reached (the cross-attention's q and k over one context
        token, whose softmax is 1, are skipped by the attention) takes a
        zero gradient, as in JAX's grads: the optimizer still decays it."""
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
