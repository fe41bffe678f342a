"""Training inputs: the teacher's dense flow (stage 1), sparse hints + CMP (stage 2).

Counterpart of mofa_tpu/train/inputs.py (the reference's
Training/train_stage1.py:113-143 and train_stage2.py:78-159):

- stage 1: the GMFlow teacher's dense flows are the control;
- stage 2: a mask is sampled on the host from each clip's last-frame
  dense flow with (grid, watershed) (`clip_sample_mask`), the masked flow
  and the mask go to the 384^2 CMP canvas (nearest, the flow scaled per
  component), CMP completes them without gradient in its own dtype (a
  bf16 CMP for --cmp_bf16, the result returned in fp32), and the dense
  flow is rescaled to the training size (`stage2_control_flow`);
- `Stage2InputPipeline` keeps a one-batch lookahead: the next batch's
  teacher is queued on the device before the host samples this batch's
  mask, this batch's flows come back through a pinned buffer and an event
  (so the host never waits on the next teacher), and cache backfill is
  written while the next teacher runs. Its batches equal the sequential
  path's: the mask draws come from the same RandomState in the same order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mofa_tpu_torch.models.cmp.model import cmp_preprocess
from mofa_tpu_torch.models.gmflow.model import get_optical_flows
from mofa_tpu_torch.ops.flow import rescale_flow
from mofa_tpu_torch.ops.resize import resize_nhwc
from mofa_tpu_torch.train.flow_sampler import clip_sample_mask

CMP_CANVAS = 384


def scale_flow_to(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The reference's F.interpolate default (nearest) with each component
    scaled by the size ratio (train_stage2.py:133-137)."""
    return rescale_flow(flow, height, width)


def make_stage1_batch(gmflow, pixel_values01: torch.Tensor,
                      inference_size=(384, 512),
                      pair_chunk: int | None = None) -> dict:
    """{pixel_values01, flows}: the clip and its frame 0 -> frame i GMFlow
    flows [B, T-1, H, W, 2], the pairs run `pair_chunk` at a time."""
    flows = get_optical_flows(gmflow, pixel_values01, inference_size=inference_size,
                              pair_chunk=pair_chunk)
    return {"pixel_values01": pixel_values01, "flows": flows}


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a CUDA device through pinned memory,
    without waiting for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@torch.no_grad()
def cmp_complete(cmp, px01: torch.Tensor, sparse: torch.Tensor, mask: torch.Tensor,
                 train_size: tuple):
    """The device half of stage 2 (mofa_tpu's `_stage2_cmp_jit`): px01 [b,
    t-1, h, w, 3] in (0, 1), sparse / mask [b, t-1, h, w, 2] -> dense flow
    [b, t-1, H, W, 2] fp32 at train_size. The inputs go to the 384^2 CMP
    canvas (nearest, the flow scaled per component), CMP runs in its
    parameters' dtype (bf16 for --cmp_bf16, as the JAX package's
    compute_dtype) and its output is rescaled to train_size."""
    b, tm1, h, w = sparse.shape[:4]
    if (h, w) != (CMP_CANVAS, CMP_CANVAS):
        px01 = resize_nhwc(px01, (CMP_CANVAS, CMP_CANVAS), method="nearest")
        sparse = rescale_flow(sparse, CMP_CANVAS, CMP_CANVAS)
        mask = resize_nhwc(mask, (CMP_CANVAS, CMP_CANVAS), method="nearest")
    dtype = next(cmp.parameters()).dtype
    flat = lambda x: x.reshape((b * tm1,) + x.shape[2:]).to(dtype)
    dense = cmp(cmp_preprocess(flat(px01)), flat(sparse), flat(mask))
    dense = dense.reshape((b, tm1) + dense.shape[1:]).float()
    return rescale_flow(dense, *train_size)


def stage2_control_flow(cmp, pixel_values01: torch.Tensor, flows: np.ndarray,
                        train_size: tuple, rng=None, times: dict | None = None,
                        sync: bool = False):
    """pixel_values01 [b, t, h, w, 3] in (0, 1) (a tensor, on the CMP's
    device); flows [b, t-1, h, w, 2] the dense teacher flow on the host.
    Returns (control flow [b, t-1, H, W, 2] fp32 on the device at
    train_size, mask [b, t-1, h, w, 2] numpy). With `times`, its mask_s
    (host sampling) and cmp_s (the CMP's dispatch, and its run when `sync`
    waits for the device) are set."""
    tm1 = flows.shape[1]
    t0 = time.perf_counter()
    mask = clip_sample_mask(flows, rng=rng)                  # [b, t-1, h, w, 2]
    sparse = flows * mask
    t1 = time.perf_counter()
    dev = pixel_values01.device
    dense = cmp_complete(cmp, pixel_values01[:, :tm1].float(), _to_device(sparse, dev),
                         _to_device(mask, dev), tuple(train_size))
    if times is not None:
        if sync and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.update(mask_s=t1 - t0, cmp_s=time.perf_counter() - t1)
    return dense, mask


def make_stage2_batch(cmp, pixel_values01: torch.Tensor, flows: np.ndarray,
                      rng=None) -> dict:
    """The stage-2 step's batch: the clip and its CMP-completed control
    flow at the clip's size."""
    h, w = pixel_values01.shape[2:4]
    dense, _ = stage2_control_flow(cmp, pixel_values01, flows, (h, w), rng=rng)
    return {"pixel_values01": pixel_values01, "flows": dense}


class HostFetch:
    """A device tensor's copy to the host, queued now: on a CUDA device
    into pinned memory with an event recorded after it, so `wait()` waits
    for this copy and the work queued before it, not for what is queued
    later."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class Stage2InputPipeline:
    """One-batch-lookahead stage-2 input synthesis (mofa_tpu's
    Stage2InputPipeline; the reference synthesises inline,
    train_stage2.py:1249-1268):

        queue teacher(0), its flows' copy
        for i: queue teacher(i+1) and its copy      # the device busy
               wait for flows(i) (its event only)
               write flows(i) to the cache           # overlapped
               mask(i) on the host                   # overlapped
               CMP(i) + the caller's step(i)         # queued after

    `teacher(px)` returns a clip's dense flows on the device (it must not
    wait on the device); with a `flow_cache`, clips that come as (keys, px)
    are read from it where it holds them (no teacher) and written back
    where it does not."""

    def __init__(self, teacher, cmp, train_size, rng=None, flow_cache=None):
        self.teacher, self.cmp = teacher, cmp
        self.train_size = tuple(train_size)
        self.rng = rng
        self.flow_cache = flow_cache
        self.times: dict = {}           # the last batch's mask_s (host) and cmp_s

    def _start(self, item):
        """(keys, px) or px -> (keys, px, the flows' HostFetch or None,
        the cached flows or None)."""
        keys, px = item if isinstance(item, tuple) else (None, item)
        cached = None
        if self.flow_cache is not None and keys is not None:
            cached = self.flow_cache.get_batch(keys)
        fetch = None if cached is not None else HostFetch(self.teacher(px))
        return keys, px, fetch, cached

    def run(self, clips, step_fn):
        """clips: an iterable of [b, t, h, w, 3] tensors in (0, 1) on the
        device, or of (clip keys, tensor) pairs. step_fn(batch) is the
        caller's step; yields its result a batch."""
        it = iter(clips)
        try:
            cur = self._start(next(it))
        except StopIteration:
            return
        while cur is not None:
            keys, px, fetch, cached = cur
            try:
                nxt = self._start(next(it))             # the device: teacher(i+1)
            except StopIteration:
                nxt = None
            flows = cached if cached is not None else fetch.wait()
            if cached is None and self.flow_cache is not None and keys is not None:
                self.flow_cache.put_batch(keys, flows)
            self.times = {}
            dense, _ = stage2_control_flow(self.cmp, px, flows, self.train_size,
                                           rng=self.rng, times=self.times)
            yield step_fn({"pixel_values01": px, "flows": dense})
            cur = nxt
