"""Main-path entry point of the port: DSEC fusion inference, end to end.

``entry()`` mirrors ``__graft_entry__.entry()`` of the JAX package: it builds
the DSEC 480x640 fusion detector (two ResNet-50 backbones, four REFusion
stages, FPN P2-P6, the shared heads) in bf16 with f32 parameters, from seeded
weights, and returns an inference function (rgb, event) -> (scores, labels,
boxes) with example inputs.

    fn, (rgb, event) = entry(batch=16)   # on the card
    scores, labels, boxes = fn(rgb, event)
"""

from __future__ import annotations

from typing import Tuple

import torch

from frn_tpu_torch.config import DSEC, FrameworkConfig, ModelConfig
from frn_tpu_torch.device import resolve_device
from frn_tpu_torch.models.detector import (
    FRNDetector,
    decode_detections,
    eval_output_for,
    image_anchors,
    init_detector,
)


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


def dsec_fusion_config() -> FrameworkConfig:
    return FrameworkConfig(
        geometry=DSEC,
        model=ModelConfig(variant="fusion", depth=50, num_classes=3, compute_dtype="bfloat16"),
    )


def entry(device=None, batch: int = 1, seed: int = 0) -> Tuple[InferenceFn, Tuple[torch.Tensor, torch.Tensor]]:
    """(fn, (rgb, event)): the DSEC fusion ResNet-50 bf16 inference function and
    seeded normal example inputs (B, 480, 640, 3) and (B, 480, 640, 5)."""
    device = resolve_device(device)
    cfg = dsec_fusion_config()
    model = init_detector(cfg, seed=seed, device=device)
    geo = cfg.geometry
    gen = torch.Generator().manual_seed(seed + 1)
    rgb = torch.randn((batch, geo.height, geo.width, 3), generator=gen).to(device)
    event = torch.randn((batch, geo.height, geo.width, geo.event_channels), generator=gen).to(device)
    return InferenceFn(model, cfg), (rgb, event)
