"""Training data: the WebVid-style clip dataset, a resumable batch stream,
and a host-thread prefetcher into pinned memory.

Counterpart of mofa_tpu/train/data.py (the reference's `WebVid10M`,
Training/train_utils/dataset.py:34-139): a CSV of (videoid, page_dir,
name) rows, a random clip of `sample_n_frames` frames at `sample_stride`,
resized to `sample_size`, values in [0, 1], layout [T, H, W, 3], decoded
with cv2 (as the JAX package does: no decord), retrying another video
when one fails to decode.

The JAX package streams batches from the dataset's one seeded
RandomState (order and clip starts alike). The train app reads
`ResumableBatches` instead: the order from `GivenIterationSampler` and
each clip's start from a RandomState seeded by (seed, the sample's
position), so the stream at batch n depends on nothing but n, and a
checkpoint that stores n resumes it exactly.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from mofa_tpu_torch.train.flow_cache import clip_key
from mofa_tpu_torch.train.sampler import GivenIterationSampler


def read_video_clip(path: str, start: int, n_frames: int, stride: int,
                    size: tuple[int, int]) -> np.ndarray:
    """Frames start, start + stride, ... -> [n, H, W, 3] float32 in [0, 1]."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    want = [start + i * stride for i in range(n_frames)]
    want_set, last = set(want), want[-1]
    frames, i = [], 0
    try:
        while i <= last:
            ok, frame = cap.read()
            if not ok:
                break
            if i in want_set:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                frames.append(cv2.resize(frame, (size[1], size[0]),
                                         interpolation=cv2.INTER_LINEAR))
            i += 1
    finally:
        cap.release()
    if len(frames) != n_frames:
        raise IOError(f"short video {path}: got {len(frames)}/{n_frames}")
    return np.stack(frames).astype(np.float32) / 255.0


def video_length(path: str) -> int:
    import cv2
    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


class WebVidDataset:
    """CSV-driven clip sampler with retry on a failed decode
    (dataset.py:77-110)."""

    def __init__(self, csv_path: str, video_folder: str,
                 sample_size: int = 384, sample_stride: int = 4,
                 sample_n_frames: int = 25, seed: int = 0):
        with open(csv_path, newline="") as f:
            self.rows = list(csv.DictReader(f))
        if not self.rows:
            raise ValueError(f"{csv_path} lists no videos")
        self.video_folder = video_folder
        self.sample_size = sample_size
        self.sample_stride = sample_stride
        self.sample_n_frames = sample_n_frames
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.rows)

    def _video_path(self, row) -> str:
        return os.path.join(self.video_folder, row.get("page_dir", ""),
                            f"{row['videoid']}.mp4")

    def _get_clip(self, index: int, rng: np.random.RandomState):
        row = self.rows[index]
        path = self._video_path(row)
        total = video_length(path)
        span = (self.sample_n_frames - 1) * self.sample_stride + 1
        if total < span:
            raise IOError(f"{path}: {total} < {span} frames")
        start = rng.randint(0, total - span + 1)
        clip = read_video_clip(path, start, self.sample_n_frames,
                               self.sample_stride,
                               (self.sample_size, self.sample_size))
        return clip, clip_key(row["videoid"], start, self.sample_stride,
                              self.sample_n_frames, self.sample_size)

    def item(self, index: int, rng: np.random.RandomState) -> dict:
        """The clip of row `index` (another row, drawn from `rng`, while a
        decode fails), with its flow-cache key."""
        while True:
            try:
                clip, key = self._get_clip(index, rng)
                return {"pixel_values01": clip, "clip_key": key}
            except IOError:
                index = rng.randint(0, len(self.rows))

    def __getitem__(self, index: int) -> dict:
        return self.item(index, self.rng)


def collate(items: list) -> dict:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class ResumableBatches:
    """Batches n = start, start + 1, ... < total_iter of `dataset`: the rows
    of `GivenIterationSampler` (seeded), each clip's start (and any retry)
    from RandomState((seed, sample position))."""

    def __init__(self, dataset: WebVidDataset, batch_size: int, total_iter: int,
                 seed: int, start: int = 0):
        self.dataset, self.batch_size, self.seed = dataset, batch_size, seed
        self.sampler = GivenIterationSampler(len(dataset), total_iter,
                                             batch_size, seed=seed,
                                             last_iter=start - 1)
        self.start = start

    def __iter__(self) -> Iterator[dict]:
        indices = iter(self.sampler)
        pos = self.start * self.batch_size
        for _ in range(len(self.sampler) // self.batch_size):
            items = []
            for _ in range(self.batch_size):
                rng = np.random.RandomState([self.seed, pos])
                items.append(self.dataset.item(int(next(indices)), rng))
                pos += 1
            yield collate(items)


class Prefetcher:
    """A host thread that runs `iterator` `depth` batches ahead, turning
    each array into a torch tensor in pinned memory when `pin` (string
    arrays, the clip keys, stay numpy); the consumer copies to the device.
    An exception in the thread is raised by the consumer's next()."""

    _END = object()

    def __init__(self, iterator, depth: int = 2, pin: bool = False):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._pin = pin
        self.thread = threading.Thread(target=self._worker, args=(iterator,),
                                       daemon=True)
        self.thread.start()

    def _convert(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if np.asarray(v).dtype.kind in "US":
                out[k] = v
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if self._pin else t
        return out

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, iterator):
        try:
            for batch in iterator:
                if not self._put(self._convert(batch)):
                    return
            self._put(self._END)
        except Exception as e:       # handed to the consumer, raised there
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self.q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        while True:                  # unblock a worker waiting on a full queue
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout)
