"""Epoch-level trainer on one device (counterpart of ``frn_tpu/train/trainer.py``).

The reference scripts' control flow: a running-mean loss window, the
per-epoch plateau schedule on the mean epoch loss, periodic checkpoints, and
an optional periodic evaluation (``eval_fn(model, state) -> mAP`` every
``eval_every`` epochs) that saves the epoch's checkpoint, with ``best_map``
in its metadata, whenever the mAP beats the best so far; on top of the train
step. One device; the mesh, the metrics logger and the step timer of the JAX
trainer are not ported yet (``metrics_path`` raises).
"""

from __future__ import annotations

import collections
import math
import time
from typing import Callable, Dict, Optional

import torch

from frn_tpu_torch.config import NOT_PORTED, FrameworkConfig
from frn_tpu_torch.data.loader import BatchLoader
from frn_tpu_torch.train.checkpoint import CheckpointManager
from frn_tpu_torch.train.loop import create_train_state, make_train_step, set_learning_rate
from frn_tpu_torch.train.plateau import ReduceLROnPlateau


class Trainer:
    def __init__(
        self,
        config: FrameworkConfig,
        dataset,
        checkpoint_dir: Optional[str] = None,
        eval_fn: Optional[Callable] = None,  # (model, state) -> mAP float
        eval_every: int = 5,
        log_every: int = 50,
        seed: Optional[int] = None,
        metrics_path: Optional[str] = None,
        device=None,
        transform: Optional[Callable] = None,  # per-sample host augmentation
    ):
        if metrics_path is not None:
            raise NotImplementedError(f"Trainer(metrics_path=...): {NOT_PORTED}")
        self.config = config
        self.dataset = dataset
        self.transform = transform
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.log_every = log_every

        seed = config.train.seed if seed is None else seed
        self.state = create_train_state(config, seed=seed, device=device)
        self.step_fn = make_train_step(config)
        self.scheduler = ReduceLROnPlateau(
            base_lr=config.train.learning_rate,
            factor=config.train.plateau_factor,
            patience=config.train.plateau_patience,
        )
        self.loss_window = collections.deque(maxlen=100)
        self.epoch = 0
        self.best_map = -1.0
        self.generator = torch.Generator().manual_seed(seed + 1)  # modality dropout
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        self.history: list = []

    def resume(self) -> bool:
        """Restore the latest checkpoint if there is one."""
        if self.ckpt is None or self.ckpt.latest_epoch() is None:
            return False
        meta = self.ckpt.restore(self.state)
        self.epoch = int(meta.get("epoch", 0))
        self.best_map = float(meta.get("best_map", -1.0))
        self.history = list(meta.get("loss_history", []))
        if "scheduler" in meta:
            self.scheduler.load_state_dict(meta["scheduler"])
            set_learning_rate(self.state, self.scheduler.lr)
        if "generator" in meta:
            self.generator.set_state(meta["generator"])
        return True

    def _loader(self) -> BatchLoader:
        tc = self.config.train
        return BatchLoader(
            self.dataset, self.config.geometry, batch_size=tc.batch_size,
            shuffle=True, num_threads=8, max_annots=tc.max_annots_per_image,
            drop_last=True, seed=tc.seed + self.epoch, transform=self.transform,
        )

    def train_epoch(self) -> Dict[str, float]:
        t0 = time.perf_counter()
        # the step's metrics stay on the device until a log window ends, then
        # come over in one transfer (one host sync per window)
        pending = []
        loss_sum, loss_n, skipped, num_steps = 0.0, 0, 0.0, 0
        t_window = time.perf_counter()

        def drain():
            nonlocal pending, loss_sum, loss_n, skipped, num_steps
            if not pending:
                return None
            keys = ("loss", "cls_loss", "reg_loss", "skipped")
            host = torch.stack([torch.stack([m[k] for k in keys]) for m in pending]).tolist()
            pending = []
            for loss, _, _, skip in host:
                num_steps += 1
                skipped += skip
                if math.isfinite(loss):
                    loss_sum += loss
                    loss_n += 1
            return dict(zip(keys, host[-1]))

        for i, batch in enumerate(self._loader()):
            metrics = self.step_fn(self.state, batch, self.generator)
            pending.append(metrics)
            if self.log_every and (i + 1) % self.log_every == 0:
                last = drain()
                dt = (time.perf_counter() - t_window) / self.log_every
                t_window = time.perf_counter()
                self.loss_window.append(last["loss"])
                print(
                    f"epoch {self.epoch} iter {i + 1}: cls {last['cls_loss']:.5f} "
                    f"reg {last['reg_loss']:.5f} "
                    f"running {sum(self.loss_window) / len(self.loss_window):.5f} "
                    f"({dt * 1e3:.0f} ms/step)",
                    flush=True,
                )
        drain()
        return {
            "mean_loss": loss_sum / loss_n if loss_n else float("nan"),
            "skipped": skipped,
            "epoch_time_s": time.perf_counter() - t0,
            "num_steps": num_steps,
        }

    def fit(self, epochs: Optional[int] = None) -> list:
        epochs = epochs if epochs is not None else self.config.train.epochs
        tc = self.config.train
        while self.epoch < epochs:
            stats = self.train_epoch()
            self.epoch += 1
            self.history.append(stats["mean_loss"])
            lr = self.scheduler.step(stats["mean_loss"])
            set_learning_rate(self.state, lr)
            skipped = (f" skipped {int(stats['skipped'])}/{stats['num_steps']}"
                       if stats["skipped"] else "")
            print(f"epoch {self.epoch}/{epochs}: loss {stats['mean_loss']:.5f} lr {lr:.2e} "
                  f"({stats['epoch_time_s']:.1f}s){skipped}", flush=True)
            if self.eval_fn is not None and self.epoch % self.eval_every == 0:
                current_map = float(self.eval_fn(self.state.model, self.state))
                print(f"epoch {self.epoch}: mAP {current_map:.4f}", flush=True)
                if current_map > self.best_map:
                    self.best_map = current_map
                    if self.ckpt:
                        self._save()
            if self.ckpt and self.epoch % tc.checkpoint_every == 0:
                self._save()
        if self.ckpt:
            self._save()
        return self.history

    def _save(self) -> None:
        meta = {
            "loss_history": self.history,
            "scheduler": self.scheduler.state_dict(),
            "best_map": self.best_map,
            "variant": self.config.model.variant,
            "dataset": self.config.geometry.name,
            "generator": self.generator.get_state(),
        }
        self.ckpt.save(self.epoch, self.state, meta=meta)
