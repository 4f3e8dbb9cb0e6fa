"""Profiling and tracing hooks (counterpart of ``frn_tpu/utils/profiling.py``).

The reference has no profiling beyond wall-clock prints (train_dsec.py:26-31).
Here: a ``torch.profiler`` trace of CPU and CUDA activity as a context
manager, written as a Chrome/Perfetto trace file; a step timer on the host
clock that ends each step in a device sync (a one-element host fetch); and a
JSONL metrics logger whose records are those of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile CPU and (where there is a card) CUDA activity around the
    enclosed block; on exit write ``<log_dir>/<host>.<pid>.<ms>.pt.trace.json``
    (Chrome trace format, readable by Perfetto and TensorBoard)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
        prof.export_chrome_trace(os.path.join(log_dir, name))


def _first_tensor(tree: Any) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]  # the order of jax.tree_util's leaves
    if isinstance(tree, (list, tuple)):
        for item in tree:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def sync(tree: Any) -> None:
    """Barrier: fetch one element of the first tensor leaf of ``tree`` to the
    host, which waits for the work that produced it."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.numel():
        leaf.detach().reshape(-1)[:1].cpu()


class StepTimer:
    """Rolling per-step wall-clock stats (mean/p50/p90), each step ended by a
    device sync on its result."""

    def __init__(self, window: int = 200):
        self.window = window
        self.samples: list = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result_tree: Any = None) -> float:
        if result_tree is not None:
            sync(result_tree)
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p90_s": float(np.percentile(a, 90)),
            "steps_per_s": float(1.0 / a.mean()),
        }


class MetricsLogger:
    """Append-only JSONL metrics sink (the reference only has stdout prints).
    Every metric with ``__float__`` (a Python int, a tensor) is written as a
    float, as the JAX package writes it; ``step`` is written as given."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.time(), **{
            k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()
        }}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
