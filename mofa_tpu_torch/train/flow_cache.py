"""Offline teacher-flow cache for training, bound to its teacher.

Counterpart of mofa_tpu/train/flow_cache.py. The GMFlow teacher is
deterministic per clip, so its flows can be computed once
(`train_app --precompute_flows`) and read back on every later visit of
the clip. Each clip's flows [T-1, h, w, 2] are one npz (fp16) under a
sha1 of the JAX package's key, "<videoid>:<start>:<stride>x<n_frames>:
<sample_size>" (`clip_key`).

The JAX cache's keys do not say which teacher filled it, so flows from
another teacher (random weights, another checkpoint or precision) would
be read silently (ROADMAP Queue 3 item 4). Here the cache directory holds
a manifest with the teacher's fingerprint (`teacher_fingerprint`: the
config, the precision, the inference size and a hash of every weight);
opening it with another fingerprint raises. `contains` tests for a clip
by its file and stored key, without decompressing the flows.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

MANIFEST = "manifest.json"


def clip_key(videoid: str, start: int, stride: int, n_frames: int,
             sample_size: int) -> str:
    return f"{videoid}:{start}:{stride}x{n_frames}:{sample_size}"


def teacher_fingerprint(model: torch.nn.Module, *context) -> str:
    """sha1 over `context` (config, precision, size: anything that changes
    the flows) and every parameter and buffer of `model`, by name."""
    h = hashlib.sha1(repr(context).encode())
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


class TeacherFlowCache:
    """npz-per-clip store of one teacher's flows [t-1, h, w, 2] (fp16)."""

    def __init__(self, root: str, fingerprint: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        manifest = os.path.join(root, MANIFEST)
        if os.path.exists(manifest):
            with open(manifest) as f:
                stored = json.load(f)["teacher"]
            if stored != fingerprint:
                raise ValueError(
                    f"flow cache {root} was filled by teacher {stored[:12]}..., "
                    f"not by this one ({fingerprint[:12]}...); use another "
                    "directory or empty this one")
        else:
            tmp = manifest + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"teacher": fingerprint}, f)
            os.replace(tmp, manifest)
        self.fingerprint = fingerprint

    def _path(self, key: str) -> str:
        h = hashlib.sha1(key.encode()).hexdigest()[:24]
        return os.path.join(self.root, f"{h}.npz")

    def contains(self, key: str) -> bool:
        path = self._path(key)
        if not os.path.exists(path):
            return False
        with np.load(path) as z:        # reads the key member only
            return str(z["key"]) == key

    def get(self, key: str) -> np.ndarray | None:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            if str(z["key"]) != key:    # a hash-prefix collision
                return None
            return z["flows"].astype(np.float32)

    def put(self, key: str, flows) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:       # a file object: np.savez adds no .npz
            np.savez_compressed(f, key=np.str_(key),
                                flows=np.asarray(flows, np.float16))
        os.replace(tmp, self._path(key))

    def get_batch(self, keys) -> np.ndarray | None:
        """Stacked flows [b, t-1, h, w, 2] if every key hits, else None."""
        hits = [self.get(str(k)) for k in np.atleast_1d(np.asarray(keys))]
        if any(h is None for h in hits):
            return None
        return np.stack(hits)

    def put_batch(self, keys, flows) -> None:
        for k, f in zip(np.atleast_1d(np.asarray(keys)), flows):
            self.put(str(k), f)

    def __len__(self) -> int:
        return sum(1 for f in os.listdir(self.root) if f.endswith(".npz"))
