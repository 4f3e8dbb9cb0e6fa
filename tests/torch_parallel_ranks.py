"""Rank functions of ``tests/test_torch_parallel_train.py``.

``parallel.launch.run_ranks`` spawns each rank as a fresh interpreter that
imports its function by module path, so they live here, in a module that
imports neither JAX nor the test files (which do). Each takes its rank, then
a directory of inputs written by the test (``init.pt``: the initial state
dict; ``batch.npz``: the global batch) and writes its large results there.
"""

import dataclasses
import json
import os

import numpy as np
import torch

from frn_tpu_torch import config as tconfig
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.models.detector import FRNDetector
from frn_tpu_torch.parallel.mesh import all_reduce_mean_, world
from frn_tpu_torch.train.loop import create_train_state, make_train_step
from frn_tpu_torch.train.trainer import Trainer

LR = 1e-4
MODEL_KW = dict(variant="fusion", depth=18, num_classes=3, feature_size=16, attention_chunk=64,
                modality_dropout=0.0)
TRAIN_KW = dict(batch_size=2, learning_rate=LR, accum_steps=2, max_annots_per_image=4)
TRAINER_SAMPLES = 4


def config() -> tconfig.FrameworkConfig:
    """``tests/test_torch_train_slice.py``'s: fusion depth 18, 32x48, global
    batch 2, accum_steps 2, no modality dropout."""
    geo = dataclasses.replace(tconfig.DSEC, height=32, width=48)
    return tconfig.FrameworkConfig(geometry=geo, model=tconfig.ModelConfig(**MODEL_KW),
                                   train=tconfig.TrainConfig(**TRAIN_KW))


def _state(root: str, cfg):
    model = FRNDetector(cfg)
    model.load_state_dict(torch.load(os.path.join(root, "init.pt"), weights_only=True))
    return create_train_state(cfg, model=model)


def _my_rows(root: str, rank: int) -> dict:
    """This rank's row block of the global batch."""
    size = world().size
    with np.load(os.path.join(root, "batch.npz")) as batch:
        b = batch["rgb"].shape[0] // size
        return {k: batch[k][rank * b: (rank + 1) * b] for k in ("rgb", "event", "annot")}


def two_micro_steps(rank: int, root: str, thresholds) -> dict:
    """Everything the data-parallel tests read, in one process group:

    * ``all_reduce_mean_`` over tensors of several shapes;
    * two micro-steps of the train step (the second the Adam step) on this
      rank's row: losses and metrics returned, the running gradient sum
      after the first and the parameters after the second written to
      ``rank<r>.pt``;
    * for each loss-skip threshold, one micro-step from the initial state:
      its 'skipped' metric and the norm of the gradient sum it left;
    * ``Trainer.fit(1)`` over ``TRAINER_SAMPLES`` seeded samples, with the
      checkpoint directory ``ckpt``, the JSONL path ``metrics_<r>.jsonl`` and
      an evaluation every epoch that counts its calls.
    """
    cfg = config()
    xs = [torch.full((3,), float(rank + 1)), torch.full((2, 2), 10.0 * (rank + 1))]
    all_reduce_mean_(xs)
    out = {"reduced": [x.tolist() for x in xs]}

    state = _state(root, cfg)
    step = make_train_step(cfg)
    rows = _my_rows(root, rank)
    metrics = []
    for i in range(2):
        m = step(state, rows, None)
        metrics.append({k: v.item() for k, v in m.items()})
        if i == 0:
            acc = {n: a.clone() for n, a in zip(state.names, state.acc_grads)}
    params = {n: p.detach().clone() for n, p in zip(state.names, state.params)}
    torch.save({"acc": acc, "params": params}, os.path.join(root, f"rank{rank}.pt"))
    out["metrics"] = metrics
    out["counters"] = (state.step, state.opt_steps, state.mini_step)

    out["skips"] = []
    for thr in thresholds:
        state = _state(root, cfg)
        m = make_train_step(cfg, loss_skip_threshold=thr)(state, rows, None)
        norm = torch.stack([a.norm() for a in state.acc_grads]).norm().item()
        out["skips"].append((m["skipped"].item(), m["loss"].item(), norm))

    calls = []

    def eval_fn(model, state):
        calls.append(state.step)
        return 0.25

    geo = cfg.geometry
    trainer = Trainer(cfg, box_samples(TRAINER_SAMPLES, geo, seed=5), seed=0, device="cpu",
                      checkpoint_dir=os.path.join(root, "ckpt"), eval_fn=eval_fn, eval_every=1,
                      log_every=1, metrics_path=os.path.join(root, f"metrics_{rank}.jsonl"))
    out["history"] = trainer.fit(1)
    out["best_map"], out["eval_calls"] = trainer.best_map, calls
    out["trainer_params"] = float(sum(p.double().sum().item() for p in trainer.state.params))
    return json.loads(json.dumps(out))
