"""Threaded batch loader (counterpart of ``frn_tpu/data/loader.py``).

``BatchLoader`` is a copy of the JAX package's: a thread pool loads
samples (numpy work that releases the GIL), a producer thread
collates fixed-shape batches into a bounded queue. ``to_device`` takes the
place of ``device_prefetch``: it pins each host array and copies it to the
card without blocking the host.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from frn_tpu_torch.config import DatasetGeometry
from frn_tpu_torch.data.collate import collate_fixed


class BatchLoader:
    """Iterates fixed-shape batches from an indexable dataset.

    Args:
      dataset: supports __len__ and __getitem__ -> sample dict.
      geometry: static padding target.
      batch_size: fixed batch size; the trailing partial batch is padded and
        flagged via 'sample_mask' unless ``drop_last``.
      shuffle: reshuffle indices each epoch, from ``seed``.
      num_threads: sample-loading worker threads (0 = synchronous).
      transform: per-sample host augmentation (sample dict -> sample dict),
        applied as each sample is loaded, in the worker threads.
    """

    def __init__(
        self,
        dataset,
        geometry: DatasetGeometry,
        batch_size: int = 1,
        shuffle: bool = False,
        num_threads: int = 4,
        max_annots: int = 64,
        drop_last: bool = False,
        seed: int = 0,
        transform: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.geometry = geometry
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.max_annots = max_annots
        self.drop_last = drop_last
        self.transform = transform
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _load(self, i: int) -> Dict[str, np.ndarray]:
        s = self.dataset[int(i)]
        if self.transform is not None:
            s = self.transform(s)
        return s

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        return collate_fixed(samples, self.geometry, self.max_annots, self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        batches = [indices[i: i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        if self.num_threads <= 0:
            for b in batches:
                yield self._collate([self._load(i) for i in b])
            return

        # worker threads fill a bounded queue of collated batches
        out_q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def put_checking_stop(item) -> bool:
            # an abandoned consumer sets stop; never block forever on a full queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    # a rolling window of per-sample futures, so the workers
                    # never drain at batch boundaries
                    in_flight: collections.deque = collections.deque()
                    bi = 0
                    try:
                        while bi < len(batches) or in_flight:
                            while bi < len(batches) and len(in_flight) < 3:
                                in_flight.append([pool.submit(self._load, i) for i in batches[bi]])
                                bi += 1
                            if stop.is_set():
                                return
                            samples = [f.result() for f in in_flight.popleft()]
                            if not put_checking_stop(self._collate(samples)):
                                return
                    finally:
                        for fs in in_flight:
                            for f in fs:
                                f.cancel()
            except Exception as e:  # surfaced to the consumer, which raises it
                put_checking_stop(e)
            finally:
                put_checking_stop(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            th.join(timeout=10)


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Batch of numpy arrays or tensors -> tensors on ``device``. For the card
    each host array is pinned and copied with ``non_blocking``, so the host
    goes on while it travels; a tensor already there is passed through."""
    device = torch.device(device)
    out = {}
    for key, x in batch.items():
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
            if device.type == "cuda":
                x = x.pin_memory()
        out[key] = x.to(device, non_blocking=True)
    return out
