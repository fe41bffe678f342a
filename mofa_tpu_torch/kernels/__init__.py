"""Hand-written Hopper kernels, each beside its plain version.

Every wrapper follows one rule: a tensor on the CPU takes the plain
PyTorch version; a CUDA tensor launches the CUDA kernel (and adds one to
that kernel's launch count) or raises. The only other way to the plain
version on a card is the explicit `plain_reference()` context, which the
composition check of `chip_smoke.py` and the tests enter; the main path
never does.

A kernel's output is written through ctypes and carries no `grad_fn`.
The four kernels of the training path (`flash_attention`,
`short_attention_tmajor`, `ln_geglu_ffn` with variant "plain", the
softsplat splat and its normalising pass) run inside a
`torch.autograd.Function` when grad is enabled on a CUDA tensor: the
kernel forward, and a backward in stock PyTorch on the JAX package's
math. The others have no backward yet (ROADMAP Queue 2): before a launch
their wrappers call `check_no_grad`, which raises where autograd would
need one. The plain versions on the CPU keep autograd.
"""

from __future__ import annotations

import contextlib

import torch

# one launch count per kernel (not per module: short_attention.py holds two
# kernels, conv_fused.py two, geglu_ffn.py five)
KERNELS = ("flash_attention", "short_attention_tmajor", "short_attention",
           "ln_geglu_ffn", "softsplat", "channel_sums", "gn_silu_conv3x3",
           "gn_silu_tconv3", "geglu_ffn", "ln_geglu_ffn_ilv",
           "ln_geglu_ffn_pipe", "ln_geglu_ffn_tanh")
_launches = dict.fromkeys(KERNELS, 0)
_shape_launches: dict = {}      # (kernel name, shape) -> launches, where a wrapper names it
_plain_depth = 0


@contextlib.contextmanager
def plain_reference():
    """Run every wrapper's plain PyTorch version, even on CUDA tensors."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def use_kernel(*tensors) -> bool:
    """True: launch the CUDA kernel. False: run the plain version.

    CPU tensors (or `plain_reference()`) take the plain version; CUDA
    tensors take the kernel; any other device raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} vs {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel or plain path for device {dev}")
    return _plain_depth == 0


def math_dtype(dtype) -> torch.dtype:
    """The dtype of a plain version's fp32 math (logits, statistics,
    sums): fp32, or float64 for float64 inputs, which a plain version
    never rounds down."""
    return torch.promote_types(dtype, torch.float32)


def check_no_grad(name: str, *tensors) -> None:
    """Raise RuntimeError if kernel `name` is about to run with grad enabled
    on an input that requires grad: its output would silently have no
    gradient. Called by each wrapper on its kernel route only."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet (ROADMAP Queue 2) "
            "and an input requires grad; run it under torch.no_grad(), or "
            "on CPU tensors, whose plain version keeps autograd")


def count_launch(name: str, shape: tuple | None = None) -> None:
    """Called by a wrapper right after it launched kernel `name`; `shape`,
    where given, also counts the launch under (name, shape)."""
    _launches[name] += 1
    if shape is not None:
        key = (name, tuple(shape))
        _shape_launches[key] = _shape_launches.get(key, 0) + 1


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return dict(_launches)


def launch_counts_by_shape(name: str) -> dict:
    """Shape -> launches of kernel `name` since the last reset, for the
    wrappers that pass their shape to `count_launch`."""
    return {shape: n for (k, shape), n in _shape_launches.items() if k == name}


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
    _shape_launches.clear()
