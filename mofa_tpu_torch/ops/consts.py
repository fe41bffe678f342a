"""Constant tensors built on the host once and kept on their device.

A CPU tensor copied to a CUDA device without pinned memory makes PyTorch
synchronise the stream, so a model that builds its constants (resize
matrices, position embeddings, window masks) on every call stalls the host
until the device has drained its queue. `device_constant` builds each
constant once per (key, device, dtype) and keeps the device copy, so a
forward pass queues its work without waiting (the stage-2 input pipeline
dispatches the next batch's teacher while the host samples masks).
"""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def device_constant(key, make, device, dtype=None) -> torch.Tensor:
    """`make()` (a numpy array or a CPU tensor) as a tensor on `device` in
    `dtype` (its own where None), built and copied on the first call for
    `key` only. Callers must not write into the result."""
    full = (key, str(torch.device(device)), dtype)
    t = _CACHE.get(full)
    if t is None:
        value = make()
        t = torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) \
            else value
        t = _CACHE[full] = t.to(device=device, dtype=dtype or t.dtype)
    return t
