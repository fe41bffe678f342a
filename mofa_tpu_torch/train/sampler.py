"""Deterministic iteration-based sampling and flow end-point error.

Counterpart of mofa_tpu/train/sampler.py:

- `GivenIterationSampler` (CMP's DistributedGivenIterationSampler,
  MOFA-Video-Traj/models/cmp/utils/distributed_utils.py:176-229): the
  whole index sequence for total_iter * batch_size samples, shuffled in
  whole-dataset rounds with a fixed seed, this rank's shard sliced out;
  a resume is `set_last_iter`.
- `flow_epe`: end-point error and the >1 / >3 / >5 px outlier rates (the
  UniMatch evaluation harness's metric).
"""

from __future__ import annotations

import numpy as np


class GivenIterationSampler:
    def __init__(self, dataset_len: int, total_iter: int, batch_size: int,
                 world_size: int = 1, rank: int = 0, last_iter: int = -1,
                 seed: int = 0):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world size {world_size}")
        self.dataset_len = dataset_len
        self.total_iter = total_iter
        self.batch_size = batch_size
        self.world_size = world_size
        self.rank = rank
        self.last_iter = last_iter
        self.total_size = total_iter * batch_size
        self.seed = seed
        self.indices = self._gen_indices()

    def _gen_indices(self) -> np.ndarray:
        np_rng = np.random.RandomState(self.seed)
        all_size = self.total_size * self.world_size
        indices = np.arange(self.dataset_len)[:all_size]
        num_repeat = (all_size - 1) // indices.shape[0] + 1
        indices = np.tile(indices, num_repeat)[:all_size]
        np_rng.shuffle(indices)
        beg = self.total_size * self.rank
        return indices[beg:beg + self.total_size]

    def set_last_iter(self, last_iter: int):
        self.last_iter = last_iter

    def __iter__(self):
        return iter(self.indices[(self.last_iter + 1) * self.batch_size:])

    def __len__(self):
        return self.total_size - (self.last_iter + 1) * self.batch_size


def flow_epe(pred: np.ndarray, gt: np.ndarray, valid=None) -> dict:
    """End-point error metrics over [..., H, W, 2] flows: mean EPE and the
    >1 / >3 / >5 px outlier rates."""
    err = np.sqrt(((pred - gt) ** 2).sum(-1))
    if valid is not None:
        err = err[valid > 0.5]
    return {"epe": float(err.mean()), "1px": float((err > 1).mean()),
            "3px": float((err > 3).mean()), "5px": float((err > 5).mean())}
