"""Start a process group in child processes of this one (``torchrun`` without a launcher).

``run_ranks(fn, n, args, device=...)`` starts ``n`` processes by ``spawn``
(never ``fork``: CUDA cannot be used in a forked child of a process that
initialized it, and the parent may hold threads), joins them into one group
through a ``file://`` store in a temporary directory (no TCP port to
collide with other runs on the host), runs ``fn(rank, *args)`` in each and
returns their results in rank order. The group and every join have a
timeout: a rank that fails, dies or hangs makes the call raise, and no child
outlives it.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from frn_tpu_torch.parallel.mesh import init_distributed


def _rank_main(fn, rank: int, world_size: int, init_method: str, device, backend,
               timeout_s: float, threads: Optional[int], args, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        if device is None:  # NCCL, one card a rank
            device = torch.device("cuda", rank)
        init_distributed(device, timeout_s=timeout_s, backend=backend,
                         init_method=init_method, rank=rank, world_size=world_size)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            torch.distributed.destroy_process_group()
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), device=None,
              backend: Optional[str] = None, timeout_s: float = 60.0,
              threads: Optional[int] = None) -> List:
    """``fn(rank, *args)`` on ``world_size`` ranks; returns their results.

    ``fn`` and ``args`` are pickled by reference, so ``fn`` is a module-level
    function and results are small. ``device=None``: rank r on ``cuda:r``
    with NCCL (``world_size`` cards); ``device='cpu'``: gloo on the CPU;
    another device: every rank on it (``backend`` 'gloo' on one card).
    ``timeout_s`` bounds each collective and the whole run; ``threads`` caps
    each rank's torch threads."""
    if device is None and world_size > torch.cuda.device_count():
        raise ValueError(f"{world_size} NCCL ranks need {world_size} cards, "
                         f"{torch.cuda.device_count()} visible; pass device='cpu' for gloo")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init_method, device, backend, timeout_s,
                                   threads, tuple(args), results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout_s
        try:
            # drain the queue before joining: a child blocks on exit until its
            # results are read
            while len(got) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in got and not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"ranks {dead} of {world_size} exited without a "
                                           f"result (exit codes {[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(got))} "
                                           f"of {world_size} gave no result in {timeout_s:g} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                got[rank] = value
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [got[r] for r in range(world_size)]
