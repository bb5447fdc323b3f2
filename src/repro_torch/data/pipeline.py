"""Parallel Encoding-Decoding (E-D) pipeline, paper Fig. 1 (counterpart of
``repro.data.pipeline``; numpy on the host, as in the paper: the host
encodes, the device decodes).

While epoch *e* trains, a background thread shuffles, pre-processes (SBS +
per-class augmentation), encodes and "dumps" the batches of epoch *e+1*
into a bounded queue, double-buffering the host-side work as the paper's
flow chart describes.  On first use the loader blocks until the first
batches are dumped ("training will start after data is dumped for the
first time").

The loader is deterministic and *resumable*: its state is
(seed, epoch, batch_index), which a checkpoint persists so a preempted job
replays the data stream exactly.  For a given seed it yields the same
bytes as the JAX package's loader.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Mapping, Optional

import numpy as np

from repro_torch.core import encoding


@dataclasses.dataclass
class LoaderState:
    """Resumable position in the data stream (persisted in checkpoints)."""

    seed: int = 0
    epoch: int = 0
    batch: int = 0


class ParallelEncodedLoader:
    """Background-thread batch encoder with double buffering.

    Parameters
    ----------
    images, labels : full dataset (uint8 images NHWC, int labels)
    batch_size     : decoded batch size (images per step)
    codec          : 'u32' (deployed, bit-exact 4x) | 'base256' | 'none'
    class_weights  : optional SBS weights (paper Algorithm 2)
    preprocess     : optional per-class augmentation hooks {class: fn}
    prefetch       : queue depth in batches
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        codec: str = "u32",
        class_weights=None,
        preprocess: Optional[Mapping[int, Callable]] = None,
        prefetch: int = 4,
        state: LoaderState | None = None,
        drop_remainder: bool = True,
    ):
        if codec not in ("u32", "base256", "none"):
            raise ValueError(f"unknown codec {codec!r}")
        if codec == "u32" and batch_size % encoding.PACK:
            raise ValueError(
                f"batch_size must be a multiple of {encoding.PACK}")
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.codec = codec
        self.class_weights = class_weights
        self.preprocess = dict(preprocess or {})
        self.state = state or LoaderState()
        self.steps_per_epoch = len(images) // batch_size if drop_remainder \
            else -(-len(images) // batch_size)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # ---------------------------------------------------------- producer ---
    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.state.seed, epoch))
        if self.class_weights is not None:
            return np.concatenate([
                encoding.selective_batch_indices(
                    self.labels, self.class_weights, self.batch_size, rng)
                for _ in range(self.steps_per_epoch)])
        order = rng.permutation(len(self.images))
        return order[: self.steps_per_epoch * self.batch_size]

    def _encode(self, batch_imgs: np.ndarray):
        if self.codec == "none":
            return batch_imgs.astype(np.float32) / 255.0
        if self.codec == "u32":
            return np.asarray(encoding.pack_u8_to_u32(batch_imgs))
        # base256: split into float64 containers of <=6 images each
        n = batch_imgs.shape[0]
        cap = encoding.MAX_BASE256_F64
        return np.stack([encoding.encode_base256(batch_imgs[i: i + cap])
                         for i in range(0, n, cap)])

    def _producer(self):
        epoch, start_batch = self.state.epoch, self.state.batch
        while not self._stop.is_set():
            order = self._epoch_order(epoch)
            for b in range(start_batch, self.steps_per_epoch):
                idx = order[b * self.batch_size: (b + 1) * self.batch_size]
                imgs = self.images[idx]
                labs = self.labels[idx]
                for cls, fn in self.preprocess.items():
                    m = labs == cls
                    if m.any():
                        imgs = imgs.copy()
                        imgs[m] = fn(imgs[m])
                enc = self._encode(imgs)
                while not self._stop.is_set():
                    try:
                        self._q.put((epoch, b, enc, labs.copy()),
                                    timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            epoch, start_batch = epoch + 1, 0

    # ---------------------------------------------------------- consumer ---
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        epoch, b, enc, labs = self._q.get()
        self.state = LoaderState(self.state.seed, epoch, b + 1)
        if self.state.batch >= self.steps_per_epoch:
            self.state = LoaderState(self.state.seed, epoch + 1, 0)
        return enc, labs

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
