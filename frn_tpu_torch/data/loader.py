"""Threaded batch loader (counterpart of ``frn_tpu/data/loader.py``).

``BatchLoader`` is a copy of the JAX package's: a thread pool loads
samples (numpy work that releases the GIL), a producer thread
collates fixed-shape batches into a bounded queue; under data-parallel
training each rank loads only its shard of every global batch. ``to_device``
pins each host array and copies it to the card on the current stream without
blocking the host; ``device_prefetch`` keeps ``size`` batches in flight ahead
of their consumer, copied on a side stream, or split over a mesh's devices.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from frn_tpu_torch.config import DatasetGeometry
from frn_tpu_torch.data.collate import collate_fixed
from frn_tpu_torch.parallel.mesh import row_blocks


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
      shard: (rank, world size) under data-parallel training: every rank
        draws the same permutation and cuts the same global batches of
        ``batch_size``, and loads and collates only its rows of each,
        [rank * b, (rank + 1) * b) with b = batch_size / world size, so that
        every rank takes the same number of steps. Needs ``drop_last``.
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
        shard: Tuple[int, int] = (0, 1),
    ):
        size = shard[1]
        if size > 1 and not drop_last:
            raise ValueError("a sharded BatchLoader needs drop_last: every rank must take "
                             "the same number of steps")
        if batch_size % size:
            raise ValueError(f"batch_size {batch_size} does not divide over {size} ranks")
        self.dataset = dataset
        self.geometry = geometry
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.max_annots = max_annots
        self.drop_last = drop_last
        self.transform = transform
        self.shard = shard
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
        return collate_fixed(samples, self.geometry, self.max_annots,
                             self.batch_size // self.shard[1])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        batches = [indices[i: i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        rank, size = self.shard
        if size > 1:
            mine = row_blocks(self.batch_size, size)[rank]
            batches = [b[mine] for b in batches]

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


def device_prefetch(iterator, size: int = 2, device=None, mesh=None):
    """Overlap host batch production and the host-to-device copy with device
    compute: ``size`` batches are copied ahead of the one the consumer holds
    (counterpart of ``frn_tpu/data/loader.py::device_prefetch``).

    On the card each batch is pinned and copied on a side CUDA stream, and an
    event is recorded after its copies. Before a batch is yielded the
    consumer's current stream waits on that event, and each tensor is
    recorded on the consumer's stream (``record_stream``), so that the caching
    allocator does not hand its blocks back to the side stream while the
    consumer's kernels still read them. On the CPU it is ``to_device``, in
    the same order and the same number ahead. A batch is a dict of numpy
    arrays or tensors; ``device`` defaults to the card.

    With ``mesh`` (``parallel.make_mesh``; ``frn_tpu``'s ``sharding=``) each
    batch is split into the mesh's row blocks (``parallel.row_blocks``), each
    block copied to its device on that device's side stream, and yielded as
    ``shard_batch`` gives it: key -> list of blocks in mesh order.
    """
    if mesh is None:
        targets = [torch.device("cuda") if device is None else torch.device(device)]
    else:
        targets = list(mesh.devices)
    sides = {d: torch.cuda.Stream(d) for d in targets if d.type == "cuda"}
    buf = collections.deque()

    def put(batch):
        if mesh is None:
            parts = [batch]
        else:
            rows = {k: row_blocks(len(x), mesh.size) for k, x in batch.items()}
            parts = [{k: x[rows[k][i]] for k, x in batch.items()} for i in range(mesh.size)]
        placed = []
        for d, part in zip(targets, parts):
            if d.type != "cuda":
                placed.append((d, to_device(part, d), None))
                continue
            with torch.cuda.stream(sides[d]):
                out = {k: _copy_ahead(x, d) for k, x in part.items()}
                done = torch.cuda.Event()
                done.record(sides[d])
            placed.append((d, out, done))
        return placed

    def hand_over(placed):
        for d, out, done in placed:
            if done is not None:
                consumer = torch.cuda.current_stream(d)
                consumer.wait_event(done)
                for x in out.values():
                    x.record_stream(consumer)
        if mesh is None:
            return placed[0][1]
        return {k: [out[k] for _, out, _ in placed] for k in placed[0][1]}

    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield hand_over(out)


def _copy_ahead(x, device) -> torch.Tensor:
    """One array or tensor of a batch onto the card, from pinned memory, on
    the current (side) stream."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device.type == "cpu" and not x.is_pinned():
        x = x.pin_memory()
    return x.to(device, non_blocking=True)
