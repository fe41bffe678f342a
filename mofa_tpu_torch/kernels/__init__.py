"""Hand-written Hopper kernels of the main path, each beside its plain version.

Every wrapper follows one rule: a tensor on the CPU takes the plain
PyTorch version; a CUDA tensor launches the CUDA kernel (and adds one to
the module's `launches` count) or raises. The only other way to the plain
version on a card is the explicit `plain_reference()` context, which the
composition check of `chip_smoke.py` and the tests enter; the main path
never does.
"""

from __future__ import annotations

import contextlib

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


def _modules():
    from mofa_tpu_torch.kernels import (flash_attention, geglu_ffn,
                                        short_attention, softsplat)
    return {"flash_attention": flash_attention,
            "short_attention_tmajor": short_attention,
            "ln_geglu_ffn": geglu_ffn,
            "softsplat": softsplat}


def launch_counts() -> dict:
    """Kernel name -> launches since the last reset."""
    return {name: mod.launches for name, mod in _modules().items()}


def reset_launch_counts() -> None:
    for mod in _modules().values():
        mod.launches = 0
