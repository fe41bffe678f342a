"""Training checkpoints and the adapter export.

Counterpart of mofa_tpu/train/checkpoint.py (HF Accelerate's save_state /
resume in the reference, Training/train_stage1.py:1000-1028, 1177-1208):

- `CheckpointManager` writes one `checkpoint-<step>.pt` (`torch.save`,
  read back with `weights_only=True`) every `save_interval_steps` steps,
  keeps the newest `max_to_keep`, and restores a step bit for bit: the
  trainable parameters, the optimizer's state (AdamW's moments and steps,
  or the factored optimizer's v_row / v_col / v and its update count), the
  EMA, and whatever the caller adds (the train app adds its generator's
  and its mask RandomState's states);
- `export_adapter` writes the adapter's state dict, with the EMA in place
  of the trained parameters where there is one, as .safetensors under the
  reference's names, which `apps/loaders.py::load_bundle` reads strictly;
  `import_adapter` reads such a file back into an adapter (strict).
"""

from __future__ import annotations

import os
import re

import torch

from mofa_tpu_torch.models.weights import load_safetensors, save_safetensors

ADAPTER_FILE = "diffusion_pytorch_model.safetensors"
_NAME = re.compile(r"checkpoint-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int | None = None,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}.pt")

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, extra: dict | None = None,
             force: bool = False) -> bool:
        """Write `state.state_dict()` and `extra` as checkpoint `step` if
        step is a multiple of the interval (or `force`); then drop the
        oldest beyond max_to_keep. Returns whether it wrote."""
        if not force and step % self.save_interval_steps:
            return False
        tmp = self.path(step) + ".tmp"
        torch.save({"state": state.state_dict(), "extra": extra or {}}, tmp)
        os.replace(tmp, self.path(step))
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return True

    def restore(self, state, step: int | None = None) -> dict:
        """Load checkpoint `step` (default: the latest) into `state`;
        returns the caller's `extra`."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self.path(step)):
            raise FileNotFoundError(f"no checkpoint {step} in {self.directory}")
        ckpt = torch.load(self.path(step), map_location="cpu", weights_only=True)
        state.load_state_dict(ckpt["state"])
        return ckpt["extra"]


def export_adapter(state, directory: str) -> str:
    """The adapter (EMA weights where the state keeps an EMA) as
    `<directory>/diffusion_pytorch_model.safetensors`; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, ADAPTER_FILE)
    save_safetensors({k: v.cpu() for k, v in state.export_state_dict().items()},
                     path)
    return path


def import_adapter(controlnet: torch.nn.Module, path: str) -> torch.nn.Module:
    """Fill `controlnet` from an exported .safetensors file (or a directory
    holding one), strictly; in place."""
    if os.path.isdir(path):
        path = os.path.join(path, ADAPTER_FILE)
    controlnet.load_state_dict(load_safetensors(path), strict=True)
    return controlnet
