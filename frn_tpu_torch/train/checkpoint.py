"""Checkpoints in the reference trainer's schema, with ``torch.save``.

Counterpart of ``frn_tpu/train/checkpoint.py`` (orbax there). One file per
epoch, ``<dir>/checkpoint_<epoch>.pt``, holding the reference's keys
{'model_state_dict', 'optimizer_state_dict', 'epoch'} plus the accumulation
state (running gradient sum, micro-step and optimizer-step counters, base lr)
so that a resumed run continues bit for bit, and the caller's metadata
(loss history, scheduler state, best mAP...). The newest ``max_to_keep``
files are kept.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

from frn_tpu_torch.train.loop import TrainState

_NAME = re.compile(r"checkpoint_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{epoch}.pt")

    def epochs(self) -> list:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory) if (m := _NAME.match(f)))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: TrainState, meta: Optional[Dict[str, Any]] = None) -> str:
        payload = {**(meta or {}), **state.state_dict(), "epoch": epoch}
        path = self.path(epoch)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.epochs()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, state: TrainState, epoch: Optional[int] = None) -> Dict[str, Any]:
        """Load a checkpoint (the latest by default) into ``state``; returns
        the whole payload, the epoch and the caller's metadata among it."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        # load on the host: the generator state in the metadata must stay a
        # CPU tensor, and the state's load_state_dict moves the rest
        payload = torch.load(self.path(epoch), map_location="cpu", weights_only=True)
        state.load_state_dict(payload)
        return payload
