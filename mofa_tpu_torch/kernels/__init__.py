"""Hand-written Hopper kernels, each beside its plain version.

Every wrapper follows one rule: a tensor on the CPU takes the plain
PyTorch version; a CUDA tensor launches the CUDA kernel (and adds one to
that kernel's launch count) or raises. The only other way to the plain
version on a card is the explicit `plain_reference()` context, which the
composition check of `chip_smoke.py` and the tests enter; the main path
never does.
"""

from __future__ import annotations

import contextlib

# one launch count per kernel (not per module: short_attention.py holds two
# kernels, conv_fused.py two, geglu_ffn.py five)
KERNELS = ("flash_attention", "short_attention_tmajor", "short_attention",
           "ln_geglu_ffn", "softsplat", "channel_sums", "gn_silu_conv3x3",
           "gn_silu_tconv3", "geglu_ffn", "ln_geglu_ffn_ilv",
           "ln_geglu_ffn_pipe", "ln_geglu_ffn_tanh")
_launches = dict.fromkeys(KERNELS, 0)
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


def count_launch(name: str) -> None:
    """Called by a wrapper right after it launched kernel `name`."""
    _launches[name] += 1


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
