"""Training step: Adam, clip of the running gradient sum, accumulation, safe steps.

Counterpart of ``frn_tpu/train/loop.py``, with the reference trainer's recipe:

  * every micro-step adds its gradient into a running sum and clips the SUM to
    ``grad_clip_norm`` (torch's ``clip_grad_norm_``: scale by
    min(1, max / (norm + 1e-6))); every ``accum_steps`` micro-steps Adam steps
    on the clipped sum and the sum is zeroed. With ``accum_steps`` 1 it is
    clip, then Adam. The effective gradient is clip(clip(g1) + g2), not the
    clip of a mean;
  * Adam with optax's defaults (beta 0.9, 0.999; eps 1e-8 outside the sqrt;
    bias correction), which ``torch.optim.Adam`` computes; the lr is the base
    lr (``set_learning_rate``, the plateau schedule) times the warmup
    multiplier min(1, (t + 1) / warmup_steps), t counting optimizer steps;
  * safe step: a micro-step whose loss is non-finite, or above
    ``loss_skip_threshold``, contributes zero gradients; it still counts toward
    the accumulation boundary and still goes through clip and Adam, as the JAX
    step does. The decision stays on the device (no host sync per step).

The step updates the state in place (the JAX step returns a new state) and
returns the step's metrics as device scalars. Under a process group of world
n > 1 (``parallel.init_distributed``) each rank computes the gradients of its
shard of the global batch, and one all-reduce replaces them and the loss
terms by their means over the ranks before the optimizer recipe: the loss is
a mean of per-image losses, so with equal shards the mean of the shards'
gradients is the global batch's, as in ``frn_tpu``'s one sharded step. The
safe-step decision and the metrics read the global loss, so every rank skips
or steps together. The input wire
(``TrainConfig.input_wire``) says what the batch holds: 'f32' normalized
floats; 'compact' uint8 RGB and int8 count voxels; 'events' uint8 RGB and raw
padded event streams, voxelized on the device. The compact and events
batches are normalized on the batch's device, outside autograd, before the
model call, with the host pipeline's arithmetic (dataloader.py:522-534,
dsec_data.py:461-462).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from frn_tpu_torch.config import FrameworkConfig
from frn_tpu_torch.data.loader import to_device
from frn_tpu_torch.models.detector import FRNDetector, detection_loss, image_anchors, init_detector
from frn_tpu_torch.ops.voxelize import wire_model_inputs
from frn_tpu_torch.parallel.mesh import World, all_reduce_mean_, world as current_world


@dataclasses.dataclass
class TrainState:
    model: FRNDetector
    optimizer: torch.optim.Adam
    names: List[str]  # the trainable parameters' state_dict names, in ``params`` order
    params: List[torch.nn.Parameter]
    acc_grads: List[torch.Tensor]  # running clipped gradient sum (empty if accum_steps == 1)
    base_lr: float
    mini_step: int = 0  # micro-steps since the last optimizer step
    step: int = 0  # micro-steps taken
    opt_steps: int = 0  # optimizer steps taken (the warmup counter)

    def state_dict(self) -> dict:
        return {
            "model_state_dict": self.model.state_dict(),
            "optimizer_state_dict": self.optimizer.state_dict(),
            "acc_grads": [a.clone() for a in self.acc_grads],
            "base_lr": self.base_lr,
            "mini_step": self.mini_step,
            "step": self.step,
            "opt_steps": self.opt_steps,
        }

    def load_state_dict(self, d: dict) -> None:
        self.model.load_state_dict(d["model_state_dict"])
        self.optimizer.load_state_dict(d["optimizer_state_dict"])
        with torch.no_grad():
            for a, saved in zip(self.acc_grads, d["acc_grads"], strict=True):
                a.copy_(saved)
        self.base_lr = float(d["base_lr"])
        self.mini_step, self.step, self.opt_steps = d["mini_step"], d["step"], d["opt_steps"]


def torch_clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / (global_norm + 1e-6)), as
    ``torch.nn.utils.clip_grad_norm_`` does; returns the global norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    scale = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    torch._foreach_mul_(list(grads), scale)
    return norm


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the base lr (the warmup multiplier applies on top of it)."""
    state.base_lr = float(lr)
    return state


def create_train_state(
    config: FrameworkConfig, seed: Optional[int] = None, device=None,
    model: Optional[FRNDetector] = None,
) -> TrainState:
    """A detector in training mode (``init_detector`` from ``seed``, or the
    given ``model``), Adam over its parameters and a zero gradient sum."""
    tc = config.train
    if model is None:
        model = init_detector(config, seed=tc.seed if seed is None else seed, device=device)
    model.train()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    optimizer = torch.optim.Adam(params, lr=tc.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    acc = [torch.zeros_like(p) for p in params] if tc.accum_steps > 1 else []
    return TrainState(model=model, optimizer=optimizer, names=[n for n, _ in named],
                      params=params, acc_grads=acc, base_lr=tc.learning_rate)


def _adam_step(state: TrainState, grads: List[torch.Tensor], warmup_steps: int) -> None:
    mult = min(1.0, (state.opt_steps + 1) / warmup_steps) if warmup_steps > 0 else 1.0
    for group in state.optimizer.param_groups:
        group["lr"] = state.base_lr * mult
    for p, g in zip(state.params, grads):
        p.grad = g
    state.optimizer.step()
    for p in state.params:
        p.grad = None
    state.opt_steps += 1


def apply_gradients(state: TrainState, grads: List[torch.Tensor], config: FrameworkConfig,
                    ok: Optional[torch.Tensor] = None) -> None:
    """One micro-step of the optimizer recipe on the micro-gradients ``grads``
    (in ``state.params`` order; overwritten). ``ok`` (a device bool) zeroes
    them when false: the safe step."""
    tc = config.train
    if ok is not None:
        grads = [torch.where(ok, g, 0.0) for g in grads]
    if tc.accum_steps > 1:
        torch._foreach_add_(state.acc_grads, grads)
        torch_clip_by_global_norm(state.acc_grads, tc.grad_clip_norm)
        state.mini_step += 1
        if state.mini_step == tc.accum_steps:
            _adam_step(state, state.acc_grads, tc.warmup_steps)
            torch._foreach_zero_(state.acc_grads)
            state.mini_step = 0
    else:
        torch_clip_by_global_norm(grads, tc.grad_clip_norm)
        _adam_step(state, grads, tc.warmup_steps)
    state.step += 1


def make_batch_inputs(config: FrameworkConfig) -> Callable[[Dict], tuple]:
    """The model's (rgb, event) f32 inputs from a batch of
    ``config.train.input_wire`` already on its device: on the 'compact' and
    'events' wires, uint8 RGB / 255 (then standardized iff
    ``input_rgb_standardize``); the event voxel from int8 counts ('compact')
    or from ``voxelize_events_batched`` ('events'), then the per-sample
    conditional tanh squash (``ops/voxelize.wire_model_inputs``)."""
    wire, geo = config.train.input_wire, config.geometry
    standardize = config.train.input_rgb_standardize
    keys = {"f32": ("rgb", "event"), "compact": ("rgb", "event"),
            "events": ("rgb", "event_x", "event_y", "event_t", "event_p", "event_n")}[wire]

    @torch.no_grad()
    def inputs(b: Dict) -> tuple:
        return wire_model_inputs(wire, geo, [b[k] for k in keys], standardize=standardize)

    return inputs


def make_train_step(
    config: FrameworkConfig, loss_skip_threshold: Optional[float] = None,
    world: Optional[World] = None,
) -> Callable[[TrainState, Dict, torch.Generator], Dict[str, torch.Tensor]]:
    """Build the train step ``(state, batch, generator) -> metrics``.

    ``batch`` holds 'rgb' (B, H, W, 3), 'event' (B, H, W, C) (on the events
    wire 'event_x', 'event_y', 'event_t', 'event_p' (B, capacity) and
    'event_n' (B,) in its place) and 'annot' (B, N, 5); ``generator`` draws
    the modality dropout. Metrics: 'loss',
    'cls_loss', 'reg_loss' and 'skipped' (1.0 when the micro-step's gradients
    were zeroed). ``loss_skip_threshold`` defaults to the config's; None skips
    only non-finite losses. ``world`` defaults to the initialized process
    group's (``parallel.world()``); with more than one rank, ``batch`` is this
    rank's shard and the gradients and metrics are averaged over the ranks.
    """
    threshold = (config.train.loss_skip_threshold if loss_skip_threshold is None
                 else loss_skip_threshold)
    data_parallel = (current_world() if world is None else world).size > 1
    anchors: Dict[torch.device, torch.Tensor] = {}
    inputs = make_batch_inputs(config)

    def train_step(state: TrainState, batch: Dict, generator: torch.Generator):
        device = state.params[0].device
        if device not in anchors:
            anchors[device] = image_anchors(config, device)
        b = to_device(batch, device)
        cls, reg = state.model(*inputs(b), train=True, generator=generator)
        cls_loss, reg_loss = detection_loss(cls, reg, b["annot"], config, anchors[device])
        loss = cls_loss + reg_loss
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(state.params, grads)]
        if data_parallel:
            terms = torch.stack([loss, cls_loss, reg_loss]).detach()
            all_reduce_mean_(grads + [terms])
            loss, cls_loss, reg_loss = terms.unbind()
        ok = torch.isfinite(loss)
        if threshold is not None:
            ok = ok & (loss < threshold)
        apply_gradients(state, grads, config, ok)
        return {"loss": loss.detach(), "cls_loss": cls_loss.detach(),
                "reg_loss": reg_loss.detach(), "skipped": (~ok).float()}

    return train_step
