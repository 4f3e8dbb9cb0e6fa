"""Entry points of the port: DSEC fusion inference and training, end to end.

Both build the DSEC 480x640 fusion detector (two ResNet-50 backbones, four
REFusion stages, FPN P2-P6, the shared heads) in bf16 with f32 parameters,
from seeded weights.

``entry()`` mirrors ``__graft_entry__.entry()`` of the JAX package: an
inference function (rgb, event) -> (scores, labels, boxes) with example inputs.
Keyword arguments are ``ModelConfig`` fields; they select the opt-in
inference path (the flags add no parameters, so the weights are the same):

    fn, (rgb, event) = entry(batch=16)   # on the card
    scores, labels, boxes = fn(rgb, event)
    fn, _ = entry(batch=16, stem_kernel=True, flash_exp_bf16=True)
    fn, _ = entry(batch=16, attention_quant="int8", fused_attention=True)

``train_entry()`` is the counterpart of the single-device train step of
``__graft_entry__.dryrun_multichip`` at full width: a ``Trainer`` with the
``TrainConfig`` defaults (Adam lr 1e-4, clip 0.1 on the running gradient sum,
accum_steps 2) over a seeded in-memory dataset, and an example batch.

    trainer, batch = train_entry(batch=8)   # on the card
    metrics = trainer.step_fn(trainer.state, batch, trainer.generator)
    trainer.fit(epochs=1)

``dryrun_multichip(n)`` is the counterpart of ``__graft_entry__``'s: one
data-parallel train step over ``n`` ranks at a tiny size.

    dryrun_multichip(4)                # NCCL, one card a rank (4 cards)
    dryrun_multichip(2, device="cpu")  # gloo, two CPU processes
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from frn_tpu_torch.config import DSEC, FrameworkConfig, ModelConfig, TrainConfig
from frn_tpu_torch.data.collate import collate_fixed
from frn_tpu_torch.data.loader import to_device
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.device import on_device, resolve_device
from frn_tpu_torch.models.detector import (
    FRNDetector,
    decode_detections,
    eval_output_for,
    image_anchors,
    init_detector,
)
from frn_tpu_torch.train.trainer import Trainer

# a dryrun rank's collectives, and the whole run, fail after this long
DRYRUN_TIMEOUT_S = 300.0


class InferenceFn:
    """Forward in the configured emission, then the configured decode and NMS."""

    def __init__(self, model: FRNDetector, config: FrameworkConfig):
        self.model = model
        self.config = config
        self.eval_output = eval_output_for(config)
        self.anchors = image_anchors(config, next(model.parameters()).device)
        self.device = self.anchors.device

    @torch.inference_mode()
    def __call__(self, rgb: torch.Tensor, event: torch.Tensor):
        return self.decode(*self.forward(rgb, event))

    @torch.inference_mode()
    def forward(self, rgb: torch.Tensor, event: torch.Tensor):
        """The model's (cls, reg) in the configured emission."""
        return self.model(rgb, event, eval_output=self.eval_output, train=False)

    @torch.inference_mode()
    def decode(self, cls: torch.Tensor, reg: torch.Tensor):
        """(scores, labels, boxes) of ``forward``'s outputs: the decode and NMS
        of ``EvalConfig.postprocess``."""
        return decode_detections(cls, reg, self.config, anchors=self.anchors)


def replica_detections(fns, parts, inputs) -> list:
    """Each replica's (scores, labels, boxes) of its part of a batch, each on
    its replica's device; ``inputs(fn, part)`` gives replica ``fn``'s model
    inputs. Every replica's forward is enqueued before any replica's decode
    and NMS (which reads the host), so no replica waits on another's."""
    outs = []
    for fn, part in zip(fns, parts):
        with on_device(fn.device):
            outs.append(fn.forward(*inputs(fn, part)))
    results = []
    for fn, out in zip(fns, outs):
        with on_device(fn.device):
            results.append(fn.decode(*out))
    return results


def dsec_fusion_config(**model_options) -> FrameworkConfig:
    """DSEC fusion ResNet-50 in bf16; ``model_options`` are further
    ``ModelConfig`` fields, which may override these (e.g. ``depth=18``)."""
    return FrameworkConfig(
        geometry=DSEC,
        model=ModelConfig(**{"variant": "fusion", "depth": 50, "num_classes": 3,
                             "compute_dtype": "bfloat16", **model_options}),
    )


def entry(device=None, batch: int = 1, seed: int = 0,
          **model_options) -> Tuple[InferenceFn, Tuple[torch.Tensor, torch.Tensor]]:
    """(fn, (rgb, event)): the DSEC fusion ResNet-50 bf16 inference function,
    with the ``ModelConfig`` fields ``model_options`` (e.g. ``stem_kernel``,
    ``flash_exp_bf16``, ``attention_quant``, ``fused_attention``), and seeded
    normal example inputs (B, 480, 640, 3) and (B, 480, 640, 5)."""
    device = resolve_device(device)
    cfg = dsec_fusion_config(**model_options)
    model = init_detector(cfg, seed=seed, device=device)
    geo = cfg.geometry
    gen = torch.Generator().manual_seed(seed + 1)
    rgb = torch.randn((batch, geo.height, geo.width, 3), generator=gen).to(device)
    event = torch.randn((batch, geo.height, geo.width, geo.event_channels), generator=gen).to(device)
    return InferenceFn(model, cfg), (rgb, event)


def train_entry(device=None, batch: int = 8, seed: int = 0, num_samples: int = 48,
                **model_options) -> Tuple[Trainer, Dict[str, torch.Tensor]]:
    """(trainer, example batch): the DSEC fusion ResNet-50 bf16 ``Trainer``,
    with the ``ModelConfig`` fields ``model_options`` (e.g. ``depth=18``), at
    batch ``batch`` over ``num_samples`` seeded samples with 1-3 boxes each
    (``data/synthetic.py``), and the first ``batch`` of them collated on the
    device ('rgb', 'event', 'annot', 'sample_mask')."""
    device = resolve_device(device)
    cfg = dataclasses.replace(dsec_fusion_config(**model_options),
                              train=TrainConfig(batch_size=batch, seed=seed))
    samples = box_samples(num_samples, cfg.geometry, seed=seed + 1)
    trainer = Trainer(cfg, samples, seed=seed, device=device)
    example = collate_fixed(samples[:batch], cfg.geometry, cfg.train.max_annots_per_image, batch)
    return trainer, to_device(example, device)


def _dryrun_config(n_devices: int) -> FrameworkConfig:
    """``__graft_entry__.dryrun_multichip``'s: DSEC cut to 32x32, fusion
    ResNet-18, feature size 16, global batch ``n_devices``, 2 annotations."""
    return FrameworkConfig(
        geometry=dataclasses.replace(DSEC, height=32, width=32),
        model=ModelConfig(variant="fusion", depth=18, num_classes=3, feature_size=16,
                          attention_chunk=64),
        train=TrainConfig(batch_size=n_devices, max_annots_per_image=2),
    )


def _dryrun_rank(rank: int, n_devices: int, device) -> float:
    """One rank of ``dryrun_multichip``: the train step on its row of the
    global batch; returns the all-reduced loss."""
    import numpy as np

    from frn_tpu_torch.train.loop import create_train_state, make_train_step

    cfg = _dryrun_config(n_devices)
    device = torch.device("cuda", rank) if device is None else torch.device(device)
    state = create_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg)
    rng = np.random.default_rng(0)
    h, w = cfg.geometry.height, cfg.geometry.width
    annots = np.full((n_devices, 2, 5), -1.0, np.float32)
    annots[:, 0] = [4, 4, 24, 24, 1]
    batch = {"event": rng.normal(0, 1, (n_devices, h, w, 5)).astype(np.float32),
             "rgb": rng.normal(0, 1, (n_devices, h, w, 3)).astype(np.float32),
             "annot": annots}
    mine = {k: v[rank: rank + 1] for k, v in batch.items()}
    metrics = step(state, mine, torch.Generator().manual_seed(1))
    return metrics["loss"].item()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full train step at a tiny size (``_dryrun_config``) over
    ``n_devices`` ranks, each taking its row of the global batch and the
    gradients all-reduced: NCCL with a card a rank (``device=None``; needs
    ``n_devices`` cards), gloo on the CPU (``device='cpu'``). The ranks are
    spawned and joined through a ``file://`` store (``parallel/launch.py``);
    a rank that fails or hangs makes the call raise. Prints
    ``dryrun_multichip(n): loss=... OK``."""
    import math

    from frn_tpu_torch.parallel.launch import run_ranks

    losses = run_ranks(_dryrun_rank, n_devices, args=(n_devices, device), device=device,
                       timeout_s=DRYRUN_TIMEOUT_S,
                       threads=1 if device is not None and torch.device(device).type == "cpu"
                       else None)
    loss = losses[0]
    if not (math.isfinite(loss) and all(x == loss for x in losses)):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' losses {losses}")
    print(f"dryrun_multichip({n_devices}): loss={loss:.5f} OK")
