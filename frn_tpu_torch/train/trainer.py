"""Epoch-level trainer (counterpart of ``frn_tpu/train/trainer.py``).

The reference scripts' control flow: a running-mean loss window, the
per-epoch plateau schedule on the mean epoch loss, periodic checkpoints, and
an optional periodic evaluation (``eval_fn(model, state) -> mAP`` every
``eval_every`` epochs) that saves the epoch's checkpoint, with ``best_map``
in its metadata, whenever the mAP beats the best so far; on top of the train
step. Batches reach the step through ``device_prefetch`` (two ahead, copied
on a side stream on the card). At each log window the trainer prints a line
and writes a JSONL record to ``metrics_path`` (``utils/profiling``'s
``MetricsLogger``: step, epoch, losses, step time), as the JAX trainer does.

Data parallelism (``use_mesh``, as in JAX): under a process group of world n
> 1 (``parallel.init_distributed``, one process per card, as ``torchrun``
starts them) each rank loads its shard of every global batch of
``batch_size`` and the step averages the shards' gradients
(``train/loop.py``). ``batch_size`` must divide over the ranks: where
``frn_tpu`` falls back to one device, separate processes cannot, so it
raises. Every rank seeds the modality dropout alike and draws it once a step,
so the ranks blank RGB together, as JAX's one draw does. Rank 0 alone prints,
writes the checkpoints and the JSONL metrics and runs ``eval_fn``; it
broadcasts the mAP, and the others wait for it. ``resume`` loads the same
checkpoint on every rank. ``transform``'s draws come from each rank's own
objects (JAX draws them in one process, in thread order), so an augmented run
is reproducible in neither package across layouts.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Callable, Dict, Optional

import torch

from frn_tpu_torch.config import FrameworkConfig
from frn_tpu_torch.data.loader import BatchLoader, device_prefetch
from frn_tpu_torch.parallel.mesh import World, broadcast_value, world
from frn_tpu_torch.train.checkpoint import CheckpointManager
from frn_tpu_torch.train.loop import create_train_state, make_train_step, set_learning_rate
from frn_tpu_torch.train.plateau import ReduceLROnPlateau
from frn_tpu_torch.utils.profiling import MetricsLogger, StepTimer


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
        use_mesh: bool = True,
    ):
        self.world = world() if use_mesh else World()
        if config.train.batch_size % self.world.size:
            raise ValueError(f"batch_size {config.train.batch_size} does not divide over "
                             f"{self.world.size} ranks")
        self.config = config
        self.dataset = dataset
        self.transform = transform
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.log_every = log_every

        seed = config.train.seed if seed is None else seed
        self.state = create_train_state(config, seed=seed, device=device)
        self.step_fn = make_train_step(config, world=self.world)
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
        self.metrics = MetricsLogger(metrics_path if self.world.is_main else None)
        self.timer = StepTimer()

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
            shard=(self.world.rank, self.world.size),
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

        device = self.state.params[0].device
        for i, batch in enumerate(device_prefetch(iter(self._loader()), size=2, device=device)):
            metrics = self.step_fn(self.state, batch, self.generator)
            pending.append(metrics)
            if self.log_every and (i + 1) % self.log_every == 0:
                last = drain()
                dt = (time.perf_counter() - t_window) / self.log_every
                t_window = time.perf_counter()
                self.loss_window.append(last["loss"])
                self._print(
                    f"epoch {self.epoch} iter {i + 1}: cls {last['cls_loss']:.5f} "
                    f"reg {last['reg_loss']:.5f} "
                    f"running {sum(self.loss_window) / len(self.loss_window):.5f} "
                    f"({dt * 1e3:.0f} ms/step)")
                self.metrics.log(
                    int(self.state.step), epoch=self.epoch,
                    loss=last["loss"], cls_loss=last["cls_loss"],
                    reg_loss=last["reg_loss"], step_time_s=dt,
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
            self._print(f"epoch {self.epoch}/{epochs}: loss {stats['mean_loss']:.5f} lr {lr:.2e} "
                        f"({stats['epoch_time_s']:.1f}s){skipped}")
            if self.eval_fn is not None and self.epoch % self.eval_every == 0:
                current_map = self._evaluate()
                self._print(f"epoch {self.epoch}: mAP {current_map:.4f}")
                if current_map > self.best_map:
                    self.best_map = current_map
                    if self.ckpt:
                        self._save()
            if self.ckpt and self.epoch % tc.checkpoint_every == 0:
                self._save()
        if self.ckpt:
            self._save()
        return self.history

    def _print(self, line: str) -> None:
        if self.world.is_main:
            print(line, flush=True)

    def _evaluate(self) -> float:
        """``eval_fn``'s mAP, from rank 0 on every rank."""
        current_map = float(self.eval_fn(self.state.model, self.state)) if self.world.is_main else 0.0
        if self.world.size > 1:
            current_map = broadcast_value(current_map, self.state.params[0].device)
        return current_map

    def _save(self) -> None:
        """Rank 0 writes the epoch's checkpoint; the others wait until it is written."""
        if self.world.is_main:
            self._write_checkpoint()
        if self.world.size > 1:
            torch.distributed.barrier()

    def _write_checkpoint(self) -> None:
        meta = {
            "loss_history": self.history,
            "scheduler": self.scheduler.state_dict(),
            "best_map": self.best_map,
            "variant": self.config.model.variant,
            "dataset": self.config.geometry.name,
            "generator": self.generator.get_state(),
        }
        self.ckpt.save(self.epoch, self.state, meta=meta)
