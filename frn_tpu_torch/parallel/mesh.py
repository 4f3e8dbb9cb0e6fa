"""Data parallelism over several devices (counterpart of ``frn_tpu/parallel/mesh.py``).

``frn_tpu`` shards the batch over a ('data', 'model', 'pipe') mesh with the
parameters replicated, and XLA emits the gradient psum. The port splits the
same work two ways, one for each use:

  * **Evaluation and serving: per-device replicas in one process.** A
    ``Mesh`` names the devices; ``replicate`` makes one copy of a module on
    each, and ``shard_batch`` splits a batch into contiguous row blocks, block
    i for device i, as ``P('data')`` shards it. ``eval/detections.py`` and
    ``serve/engine.py`` run each replica on its block.
  * **Training: torch.distributed, one process per card.** ``init_distributed``
    joins the process group that ``torchrun`` describes (NCCL on
    ``cuda:LOCAL_RANK``; gloo on the CPU), and the train step averages the
    gradients of the ranks' shards with ``all_reduce_mean_``, one collective a
    micro-step.

'model' and 'pipe' stay at 1, as every caller of ``frn_tpu``'s mesh leaves
them: the port has no tensor or pipeline parallelism. ``frn_tpu``'s
``batch_sharding`` and ``replicated_sharding`` have no counterpart: the port's
callers pass the ``Mesh`` itself.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from frn_tpu_torch.device import resolve_device

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a data-parallel mesh, one replica each, in 'data' order.
    A device may repeat: several replicas then share it (the CPU tests, and
    two replicas on one card)."""

    devices: tuple

    axis_names = ("data", "model", "pipe")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1, "pipe": 1}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(data: Optional[int] = None, model: int = 1, pipe: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model', 'pipe') mesh; the data axis defaults to every
    device. ``devices=None`` means every visible card (it raises without one,
    as ``resolve_device`` does); else torch devices or their names, which may
    repeat one device (``[torch.device('cpu')] * 8``: eight replicas on the
    CPU). The checks are ``frn_tpu``'s; 'model' and 'pipe' other than 1 raise."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        if n % (model * pipe) != 0:
            raise AssertionError(f"{n} devices not divisible by {model * pipe}")
        data = n // (model * pipe)
    if data * model * pipe != n:
        raise AssertionError(f"mesh {data}x{model}x{pipe} != {n} devices")
    if model != 1 or pipe != 1:
        raise ValueError(f"mesh {data}x{model}x{pipe}: the port shards over 'data' only; "
                         "'model' and 'pipe' stay 1")
    return Mesh(tuple(devices))


def replicate(module: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One copy of ``module`` on each device of ``mesh``, in mesh order, with
    the same weights."""
    return [copy.deepcopy(module).to(d) for d in mesh.devices]


def row_blocks(rows: int, n: int) -> List[slice]:
    """The rows of each of ``n`` devices or ranks: [i * B / n, (i + 1) * B / n);
    raises unless n divides B."""
    if rows % n:
        raise ValueError(f"a batch of {rows} does not divide over the mesh data axis ({n})")
    b = rows // n
    return [slice(i * b, (i + 1) * b) for i in range(n)]


def shard_batch(batch: Dict, mesh: Mesh) -> Dict[str, List[torch.Tensor]]:
    """Every array or tensor of ``batch`` split along its leading dim into
    ``row_blocks``, block i on device i: key -> list of blocks. Host arrays go
    to a card from pinned memory, without blocking the host."""
    out = {}
    for key, x in batch.items():
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        blocks = []
        for d, rows in zip(mesh.devices, row_blocks(x.shape[0], mesh.size)):
            block = x[rows]
            if block.device.type == "cpu" and d.type == "cuda":
                block = block.contiguous().pin_memory()
            blocks.append(block.to(d, non_blocking=True))
        out[key] = blocks
    return out


# ------------------------------------------------------------ process groups


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the process group: rank ``rank`` of ``size``."""

    rank: int = 0
    size: int = 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def world() -> World:
    """The initialized process group's rank and size; rank 0 of 1 without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return World(torch.distributed.get_rank(), torch.distributed.get_world_size())
    return World()


def is_main() -> bool:
    """Whether this process is rank 0 (or alone)."""
    return world().is_main


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process as a rank."""
    return "WORLD_SIZE" in os.environ


def init_distributed(device=None, timeout_s: float = 1800.0, backend: Optional[str] = None,
                     init_method: str = "env://", rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Joins the process group; returns this rank's device.

    Rank, world size and local rank come from ``torchrun``'s ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` unless given. ``device=None`` is the
    card ``cuda:LOCAL_RANK`` with NCCL (it raises without a card);
    ``device='cpu'`` runs gloo on the CPU; ``backend='gloo'`` with a CUDA
    device all-reduces CUDA tensors through the host, which lets several ranks
    share one card (NCCL cannot). ``timeout_s`` bounds every collective, so a
    rank that never arrives fails the others instead of hanging them."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if device is None:
        resolve_device(None)
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    torch.distributed.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return device


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replaces each tensor by its mean over the ranks, in place: all of them
    flattened into one buffer and reduced in one collective. The sum is
    divided by a tensor holding the world size: CUDA divides by a Python
    scalar as a multiply by its rounded reciprocal, one ulp off a division
    where the size is not a power of two."""
    tensors = list(tensors)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce_mean_ takes tensors of one dtype, got {sorted(map(str, dtypes))}")
    buf = torch.cat([t.reshape(-1) for t in tensors])
    torch.distributed.all_reduce(buf)
    buf.div_(torch.tensor(torch.distributed.get_world_size(), dtype=buf.dtype, device=buf.device))
    offset = 0
    for t in tensors:
        t.copy_(buf[offset: offset + t.numel()].view_as(t))
        offset += t.numel()


def broadcast_value(value: float, device) -> float:
    """Rank 0's ``value`` on every rank (the others wait for it)."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    torch.distributed.broadcast(t, src=0)
    return t.item()
