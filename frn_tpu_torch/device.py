"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card. The CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def on_device(device: torch.device):
    """The context that makes ``device`` current, so that work enqueued for
    it goes on its own current stream (nothing for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
