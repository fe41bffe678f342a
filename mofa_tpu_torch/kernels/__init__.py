"""Hand-written Hopper kernels, each beside its plain version.

Every wrapper follows one rule: a tensor on the CPU takes the plain
PyTorch version; a CUDA tensor launches the CUDA kernel (and adds one to
that kernel's launch count) or raises. The only other way to the plain
version on a card is the explicit `plain_reference()` context, which the
composition check of `chip_smoke.py` and the tests enter; the main path
never does.

A kernel's output is written through ctypes and carries no `grad_fn`.
Every entry point that the JAX package differentiates (a `jax.custom_vjp`
there) runs its kernel inside a `torch.autograd.Function` when grad is
enabled on a CUDA tensor that requires it: the kernel forward, and a
backward in stock PyTorch on the JAX rule's math, the VJP of the plain
version recomputed (`vjp_plain`; flash and the splat keep backward
functions of their own). `kernel_route` wraps a launch so. The port's own
stage entry points (the FFN's and the fused convs' stages), which have no
JAX counterpart, have no backward: before a launch they call
`check_no_grad`, which raises where autograd would need one. The plain
versions on the CPU keep autograd.
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


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_no_grad(name: str, *tensors) -> None:
    """Raise RuntimeError if stage entry point `name` is about to launch
    with grad enabled on an input that requires grad: its output would
    silently have no gradient. Called by the port's stage entry points on
    their kernel route only."""
    if _needs_grad(tensors):
        raise RuntimeError(
            f"{name}: a stage entry point of the port, with no counterpart in "
            "the JAX package, has no backward and an input requires grad; "
            "run it under torch.no_grad(), call the fused entry point, which "
            "has one, or use CPU tensors, whose plain version keeps autograd")


def vjp_plain(fn, inputs, cotangents) -> tuple:
    """The gradients of fn(*inputs) at `cotangents` (a tensor, or a tuple
    for a tuple output), fn a plain version recomputed under autograd: the
    stock backward of the kernels' autograd routes, as each JAX rule is
    jax.vjp of its reference. A None input gets None; an input that fn
    does not reach gets zeros."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        cots = cotangents if isinstance(cotangents, tuple) else (cotangents,)
        grads = iter(torch.autograd.grad(
            outs, [t for t in leaves if t is not None], cots,
            materialize_grads=True))
        return tuple(None if t is None else next(grads) for t in leaves)


class _KernelFunction(torch.autograd.Function):
    """launch(*inputs) forward, backward(*inputs, *output grads) backward."""

    @staticmethod
    def forward(ctx, launch, backward, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.backward_fn = backward
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.backward_fn(*ctx.saved_tensors, *grads))


def kernel_route(launch, backward, *inputs):
    """A wrapper's kernel route: launch(*inputs), the kernel (tensors or
    None); with grad enabled and an input that requires it, inside an
    autograd Function whose backward(*inputs, *output grads) returns a
    gradient (or None) for each input."""
    if _needs_grad(inputs):
        return _KernelFunction.apply(launch, backward, *inputs)
    return launch(*inputs)


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to 10
    mantissa bits, ties away from zero (half of the dropped ulp added to
    the magnitude's bit pattern, the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_plain(x: torch.Tensor) -> tuple:
    """(big, small) = (tf32(x), tf32(x - big)): the split of each operand
    of the fp32 routes' products (`split_tf32`, csrc/hopper.cuh), which
    take small * big + big * small + big * big."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)
