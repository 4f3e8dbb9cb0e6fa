"""Host-side ReduceLROnPlateau with torch.optim.lr_scheduler's semantics.

A copy of ``frn_tpu/train/plateau.py``. The reference steps the scheduler once
per epoch on the mean epoch loss. torch defaults: mode 'min', factor 0.1,
patience 3, threshold 1e-4 (relative), cooldown 0, min_lr 0. A metric is an
improvement if metric < best * (1 - threshold); after ``patience``
non-improving epochs the lr is multiplied by ``factor``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    base_lr: float
    factor: float = 0.1
    patience: int = 3
    threshold: float = 1e-4
    min_lr: float = 0.0
    cooldown: int = 0

    lr: float = dataclasses.field(init=False)
    best: float = dataclasses.field(default=float("inf"), init=False)
    num_bad_epochs: int = dataclasses.field(default=0, init=False)
    cooldown_counter: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        self.lr = self.base_lr

    def step(self, metric: float) -> float:
        """Update with this epoch's metric; returns the (possibly reduced) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            if self.cooldown_counter > 0:
                self.cooldown_counter -= 1
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
        self.cooldown_counter = d["cooldown_counter"]
