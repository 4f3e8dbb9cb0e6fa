"""End-to-end detector (counterpart of ``frn_tpu/models/detector.py``).

Inputs are NHWC, as in the JAX package: rgb (B, H, W, 3) normalized and event
(B, H, W, 5) voxels. Inside, the model is NCHW with channels_last memory. The
outputs follow the JAX layouts for each ``eval_output``:

  'probs'              (B, A, K) f32 sigmoid, (B, A, 4) f32 deltas
  'logits'             (B, A, K), (B, A, 4) in the compute dtype
  'logits_chanlast'    (B, K, A), (B, A, 4)
  'logits_chanlast36'  (B, K, A), (B, HW, A_cell*4)  -- the default eval path

Parameter names are the reference's torch state_dict names (``conv1``,
``layer1_event.0.conv1``, ``fus.0.rgb_cross_attention.g``, ``fpn.P5_1``,
``classificationModel.output``...). In training (``train=True``, or the
module in training mode) the output is the 'probs' emission and a fusion model
blanks the whole RGB batch with probability ``modality_dropout``, drawn from a
``torch.Generator`` the caller passes (JAX draws from its 'modality' stream;
the two give different bits from one seed). The inference-only options of
``ModelConfig`` (``stem_kernel``, ``flash_exp_bf16``, ``attention_quant``) reach
the backbones and the fusion stages only when not training, as in the JAX
package; ``fused_attention`` applies in both. ``fused_heads`` runs both heads
as one chain of grouped convs (``models/heads.fused_dual_heads``) for the
'probs' emission, in training and for the 'dense' and 'pooled'
postprocesses; the logits emissions ignore it, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from frn_tpu_torch.config import FrameworkConfig
from frn_tpu_torch.core.anchors import anchors_tensor
from frn_tpu_torch.core.losses import focal_detection_loss
from frn_tpu_torch.core.boxes import clip_boxes, decode_boxes
from frn_tpu_torch.core.nms import batched_detection_postprocess, pooled_detection_postprocess
from frn_tpu_torch.device import resolve_device
from frn_tpu_torch.models.fpn import PyramidFeatures
from frn_tpu_torch.models.fusion import REFusion
from frn_tpu_torch.models.heads import (
    ClassificationHead,
    RegressionHead,
    apply_heads,
    fused_dual_heads,
)
from frn_tpu_torch.models.resnet import ResNetBackbone

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_HEAD_MODES = {  # eval_output -> (classification mode, regression mode)
    "probs": ("probs", "rows"),
    "logits": ("logits", "rows"),
    "logits_chanlast": ("logits_chanlast", "rows"),
    "logits_chanlast36": ("logits_chanlast", "flat36"),
}


def draw_modality_drop(generator: Optional[torch.Generator], p: float) -> bool:
    """Whether a training batch loses its RGB input: True with probability
    ``p``, drawn from a CPU ``generator`` (no device sync)."""
    if generator is None:
        raise ValueError("training with modality dropout needs a generator or drop")
    return bool(torch.rand((), generator=generator) < p)


class FRNDetector(nn.Module):
    def __init__(self, config: FrameworkConfig):
        super().__init__()
        self.config = config
        mc = config.model
        self.compute_dtype = _DTYPES[mc.compute_dtype]
        if mc.variant not in ("fusion", "rgb", "event"):
            raise ValueError(f"Unknown variant {mc.variant!r}")
        streams = {"fusion": (("rgb", 3, ""), ("event", config.geometry.event_channels, "_event")),
                   "rgb": (("rgb", 3, ""),),
                   "event": (("event", config.geometry.event_channels, ""),)}[mc.variant]
        # The backbones' stems and stages are registered on the detector itself,
        # under the reference's flat names; the backbone objects are plain
        # attributes that run them.
        self._backbones = {}
        for stream, in_ch, suffix in streams:
            bb = ResNetBackbone(in_ch, mc.block_layers, mc.bottleneck, suffix)
            for name, child in bb.named_children():
                self.add_module(name, child)
            self._backbones[stream] = bb
        stage_channels = bb.stage_channels
        if mc.variant == "fusion":
            self.fus = nn.ModuleList(REFusion(c, mc.attention_chunk, mc.fused_attention)
                                     for c in stage_channels)
            fpn_in = tuple(2 * c for c in stage_channels)  # concat of two directions
        else:
            fpn_in = stage_channels
        self.fpn = PyramidFeatures(fpn_in, mc.feature_size, config.geometry.fpn_upsample)
        num_anchors = config.anchors.num_anchors_per_cell
        self.classificationModel = ClassificationHead(
            mc.num_classes, num_anchors, mc.feature_size, mc.prior)
        self.regressionModel = RegressionHead(num_anchors, mc.feature_size)

    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX package's initializers, drawn from ``gen``."""
        for bb in self._backbones.values():
            bb.init_weights(gen)
        for fus in getattr(self, "fus", ()):
            fus.init_weights(gen)
        self.fpn.init_weights(gen)
        self.classificationModel.init_weights(gen)
        self.regressionModel.init_weights(gen)

    def forward(self, rgb: torch.Tensor, event: torch.Tensor, eval_output: str = "probs",
                train: Optional[bool] = None, generator: Optional[torch.Generator] = None,
                drop: Optional[bool] = None):
        """(classification, regression) in the ``eval_output`` emission.

        ``train`` (default: ``self.training``) selects the 'probs' emission and,
        for a fusion model with ``modality_dropout`` > 0, whole-batch RGB
        dropout: ``drop`` gives the decision, else it is drawn from
        ``generator`` with probability ``modality_dropout``.
        """
        train = self.training if train is None else train
        p_drop = self.config.model.modality_dropout
        if train:
            eval_output = "probs"
            if self.config.model.variant == "fusion" and p_drop > 0:
                if drop is None:
                    drop = draw_modality_drop(generator, p_drop)
                if drop:
                    rgb = torch.zeros_like(rgb)
        cls_mode, reg_mode = _HEAD_MODES[eval_output]
        dtype = self.compute_dtype
        mc = self.config.model
        # the inference-only kernels define no gradient: off in training
        stem_kernel = mc.stem_kernel and not train
        exp_bf16 = mc.flash_exp_bf16 and not train
        quant = None if train else mc.attention_quant
        # NHWC -> NCHW view with channels_last strides: no copy
        rgb = rgb.to(dtype).permute(0, 3, 1, 2)
        event = event.to(dtype).permute(0, 3, 1, 2)
        variant = mc.variant
        if variant == "fusion":
            rgb_feats = self._backbones["rgb"](rgb, stem_kernel)
            evt_feats = self._backbones["event"](event, stem_kernel)
            # (event, rgb) argument order, as the reference calls its fusion
            feats = tuple(f(e, r, exp_bf16, quant)
                          for f, e, r in zip(self.fus, evt_feats, rgb_feats))
        else:
            feats = self._backbones[variant](rgb if variant == "rgb" else event, stem_kernel)
        pyramid = self.fpn(feats)
        if mc.fused_heads and eval_output == "probs":
            cls, reg = fused_dual_heads(self.classificationModel, self.regressionModel, pyramid,
                                        mc.num_classes, self.config.anchors.num_anchors_per_cell,
                                        dtype)
        else:
            cls, reg = apply_heads(self.classificationModel, self.regressionModel, pyramid,
                                   cls_mode, reg_mode)
        if eval_output == "probs":
            return cls.float(), reg.float()
        return cls, reg


def eval_output_for(config: FrameworkConfig) -> str:
    """The model ``eval_output`` that matches ``EvalConfig.postprocess``."""
    out = {"pooled_logits": "logits", "pooled_chanlast": "logits_chanlast"}.get(
        config.eval.postprocess, "probs")
    if out == "logits_chanlast" and config.eval.reg_flat36:
        return "logits_chanlast36"
    return out


def image_anchors(config: FrameworkConfig, device=None) -> torch.Tensor:
    geo = config.geometry
    return anchors_tensor((geo.height, geo.width), config.anchors, resolve_device(device))


def detection_loss(
    classification: torch.Tensor,
    regression: torch.Tensor,
    annotations: torch.Tensor,
    config: FrameworkConfig,
    anchors: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls_loss, reg_loss) of the 'probs' emission against padded (B, N, 5)
    annotations, with the reference's focal loss."""
    if anchors is None:
        anchors = image_anchors(config, classification.device)
    return focal_detection_loss(classification, regression, anchors, annotations,
                                std=config.box_coder.std)


def decode_detections(
    classification: torch.Tensor,
    regression: torch.Tensor,
    config: FrameworkConfig,
    anchors: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode + clip + class-aware NMS -> (scores (B, M), labels (B, M) int32,
    boxes (B, M, 4)), M = max_detections: the pooled postprocesses decode the
    per-class score pool only, 'dense' decodes and clips every anchor first."""
    geo, ev = config.geometry, config.eval
    if anchors is None:
        anchors = image_anchors(config, classification.device)
    a = anchors.shape[0]
    anchor_dim = 2 if ev.postprocess == "pooled_chanlast" else 1
    if classification.shape[anchor_dim] != a:
        raise ValueError(
            f"classification shape {tuple(classification.shape)} does not put the "
            f"anchor dim ({a}) at axis {anchor_dim} as postprocess="
            f"{ev.postprocess!r} requires; call the model with "
            "eval_output=eval_output_for(config)"
        )
    reg_elems = regression.shape[1] * (regression.shape[2] // 4)
    if ev.reg_flat36 and ev.postprocess == "pooled_chanlast":
        if regression.shape[2] == 4 or reg_elems != a:
            raise ValueError(
                f"EvalConfig.reg_flat36 expects regression (B, HW, A*4) covering "
                f"{a} anchors, got {tuple(regression.shape)}; call the model with "
                "eval_output=eval_output_for(config)"
            )
    elif regression.shape[2] != 4 or regression.shape[1] != a:
        raise ValueError(
            f"regression shape {tuple(regression.shape)} does not match the "
            f"(B, {a}, 4) layout postprocess={ev.postprocess!r} requires"
        )
    pool = dict(score_threshold=ev.score_threshold, iou_threshold=ev.nms_iou,
                per_class_topk=ev.per_class_topk, max_detections=ev.max_detections)
    if ev.postprocess != "dense":
        return pooled_detection_postprocess(
            anchors, regression, classification, (geo.height, geo.width),
            std=config.box_coder.std,
            logits=ev.postprocess in ("pooled_logits", "pooled_chanlast"),
            class_major=ev.postprocess == "pooled_chanlast",
            **pool,
        )
    boxes = decode_boxes(anchors, regression.float(), std=config.box_coder.std)
    boxes = clip_boxes(boxes, (geo.height, geo.width))
    return batched_detection_postprocess(boxes, classification, **pool)


def init_detector(config: FrameworkConfig, seed: int = 0, device=None) -> FRNDetector:
    """A detector with the JAX package's initializers drawn from ``seed``, in
    eval mode, on ``device`` (None: the card), channels_last."""
    device = resolve_device(device)
    model = FRNDetector(config)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.init_weights(gen)
    return model.to(device=device, memory_format=torch.channels_last).eval()
