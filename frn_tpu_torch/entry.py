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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from frn_tpu_torch.config import DSEC, FrameworkConfig, ModelConfig, TrainConfig
from frn_tpu_torch.data.collate import collate_fixed
from frn_tpu_torch.data.loader import to_device
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.device import resolve_device
from frn_tpu_torch.models.detector import (
    FRNDetector,
    decode_detections,
    eval_output_for,
    image_anchors,
    init_detector,
)
from frn_tpu_torch.train.trainer import Trainer


class InferenceFn:
    """Forward in the configured emission, then the pooled decode and NMS."""

    def __init__(self, model: FRNDetector, config: FrameworkConfig):
        self.model = model
        self.config = config
        self.eval_output = eval_output_for(config)
        self.anchors = image_anchors(config, next(model.parameters()).device)

    @torch.inference_mode()
    def __call__(self, rgb: torch.Tensor, event: torch.Tensor):
        cls, reg = self.model(rgb, event, eval_output=self.eval_output)
        return decode_detections(cls, reg, self.config, anchors=self.anchors)


def dsec_fusion_config(**model_options) -> FrameworkConfig:
    """DSEC fusion ResNet-50 in bf16; ``model_options`` are further
    ``ModelConfig`` fields."""
    return FrameworkConfig(
        geometry=DSEC,
        model=ModelConfig(variant="fusion", depth=50, num_classes=3, compute_dtype="bfloat16",
                          **model_options),
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


def train_entry(device=None, batch: int = 8, seed: int = 0,
                num_samples: int = 48) -> Tuple[Trainer, Dict[str, torch.Tensor]]:
    """(trainer, example batch): the DSEC fusion ResNet-50 bf16 ``Trainer`` at
    batch ``batch`` over ``num_samples`` seeded samples with 1-3 boxes each
    (``data/synthetic.py``), and the first ``batch`` of them collated on the
    device ('rgb', 'event', 'annot', 'sample_mask')."""
    device = resolve_device(device)
    cfg = dataclasses.replace(dsec_fusion_config(), train=TrainConfig(batch_size=batch, seed=seed))
    samples = box_samples(num_samples, cfg.geometry, seed=seed + 1)
    trainer = Trainer(cfg, samples, seed=seed, device=device)
    example = collate_fixed(samples[:batch], cfg.geometry, cfg.train.max_annots_per_image, batch)
    return trainer, to_device(example, device)
