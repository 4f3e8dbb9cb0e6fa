"""Typed configuration tree for the PyTorch port.

A copy of the dataclasses of ``frn_tpu/config.py`` (the port imports nothing of
the JAX package). Field names, defaults and geometry constants are the same, so
one set of settings describes a model in both packages. One difference:
``attention_quant`` outside {None, 'int8_qk', 'int8'} and ``exact_pool``
outside {'two_stage', 'radix'} raise ``ValueError`` here (the JAX package finds
the first only when a kernel asserts).

``EvalConfig.approx_topk`` and ``exact_pool`` keep their fields and defaults;
the port computes one candidate pool for every setting of them, the
``jax.lax.top_k`` result, which ``approx_max_k`` gives off a TPU and both
exact pools give (``core/nms.py`` says where the radix select differs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """RetinaNet anchor grid: levels 2..6, 3 ratios x 3 scales = 9 per cell."""

    pyramid_levels: Tuple[int, ...] = (2, 3, 4, 5, 6)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    scales: Tuple[float, ...] = (1.0, 2.0 ** (1.0 / 3.0), 2.0 ** (2.0 / 3.0))

    @property
    def strides(self) -> Tuple[int, ...]:
        return tuple(2 ** lvl for lvl in self.pyramid_levels)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(2 ** (lvl + 2) for lvl in self.pyramid_levels)

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.ratios) * len(self.scales)


@dataclasses.dataclass(frozen=True)
class BoxCoderConfig:
    mean: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    std: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)


@dataclasses.dataclass(frozen=True)
class DatasetGeometry:
    """Per-benchmark geometry and normalization constants."""

    name: str  # 'dsec' | 'ddd17'
    height: int
    width: int
    num_classes: int
    class_names: Tuple[str, ...]
    rgb_mean: Tuple[float, float, float]
    rgb_std: Tuple[float, float, float]
    event_channels: int = 5
    # 'nearest2x' (DSEC) or 'bilinear_fixed' (DDD17's 346x260 is not divisible)
    fpn_upsample: str = "nearest2x"

    def level_shape(self, level: int) -> Tuple[int, int]:
        s = 2 ** level
        return (math.ceil(self.height / s), math.ceil(self.width / s))


DSEC = DatasetGeometry(
    name="dsec",
    height=480,
    width=640,
    num_classes=3,
    class_names=("person", "large_vehicle", "car"),
    rgb_mean=(0.485, 0.456, 0.406),
    rgb_std=(0.229, 0.224, 0.225),
    fpn_upsample="nearest2x",
)

DDD17 = DatasetGeometry(
    name="ddd17",
    height=260,
    width=346,
    num_classes=1,
    class_names=("car",),
    rgb_mean=(0.403, 0.403, 0.403),
    rgb_std=(0.295, 0.295, 0.295),
    fpn_upsample="bilinear_fixed",
)

DSEC_DET = dataclasses.replace(DSEC, num_classes=2, class_names=("car", "pedestrian"))


def geometry_for(name: str) -> DatasetGeometry:
    try:
        return {"dsec": DSEC, "ddd17": DDD17, "dsec_det": DSEC_DET}[name]
    except KeyError:
        raise ValueError(f"Unknown dataset geometry: {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    variant: str = "fusion"  # 'fusion' | 'rgb' | 'event'
    depth: int = 50  # 18 | 34 | 50
    num_classes: int = 3
    feature_size: int = 256
    prior: float = 0.01
    modality_dropout: float = 0.15
    # compute dtype of activations; params stay f32, attention softmax in f32
    compute_dtype: str = "float32"
    # query-block size of the dense attention route (memory bound, exact)
    attention_chunk: int = 1024
    # both heads' towers as one chain of grouped convs ('probs' emission:
    # training and the 'dense' / 'pooled' postprocesses; models/heads.py)
    fused_heads: bool = False
    # inference only (a training forward ignores them): the stem as one fused
    # conv + frozen BN + ReLU kernel (ops/stem.py); the flash forward with
    # bf16 softmax weights; int8 attention, 'int8_qk' (QK^T in int8) or
    # 'int8' (QK^T and PV in int8), which wins over flash_exp_bf16
    stem_kernel: bool = False
    flash_exp_bf16: bool = False
    attention_quant: Optional[str] = None
    # both cross-attention directions of a fusion stage in one attention call
    # over 2B (the same parameters; equal up to f32 summation order)
    fused_attention: bool = False

    def __post_init__(self):
        if self.attention_quant not in (None, "int8_qk", "int8"):
            raise ValueError(f"Unknown attention_quant {self.attention_quant!r}")

    @property
    def block_layers(self) -> Tuple[int, ...]:
        return {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}[self.depth]

    @property
    def bottleneck(self) -> bool:
        return self.depth >= 50


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    score_threshold: float = 0.05
    nms_iou: float = 0.5
    max_detections: int = 100
    per_class_topk: int = 400
    # the JAX package's pools: approx_max_k, or the exact_pool algorithm
    # ('two_stage' | 'radix') when False. The port computes one pool for all,
    # the jax.lax.top_k result (core/nms.py)
    approx_topk: bool = True
    exact_pool: str = "two_stage"
    # 'dense' (decode + clip every anchor, then NMS) | 'pooled' |
    # 'pooled_logits' | 'pooled_chanlast' (per-class score pool first)
    postprocess: str = "pooled_chanlast"
    reg_flat36: bool = True

    def __post_init__(self):
        if self.exact_pool not in ("two_stage", "radix"):
            raise ValueError(f"Unknown exact_pool {self.exact_pool!r}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 2
    learning_rate: float = 1e-4
    grad_clip_norm: float = 0.1
    accum_steps: int = 2
    epochs: int = 60
    plateau_patience: int = 3
    plateau_factor: float = 0.1
    checkpoint_every: int = 5
    max_annots_per_image: int = 64
    loss_skip_threshold: Optional[float] = None
    warmup_steps: int = 0
    seed: int = 0
    # host -> device batch format: 'f32' (host-normalized floats), 'compact'
    # (uint8 RGB + int8 count voxels, normalized on the device) or 'events'
    # (raw padded x/y/t/p streams, voxelized and normalized on the device)
    input_wire: str = "f32"
    input_rgb_standardize: bool = False

    def __post_init__(self):
        if self.input_wire not in ("f32", "compact", "events"):
            raise ValueError(f"unknown TrainConfig.input_wire {self.input_wire!r}")


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    geometry: DatasetGeometry = DSEC
    anchors: AnchorConfig = AnchorConfig()
    box_coder: BoxCoderConfig = BoxCoderConfig()
    model: ModelConfig = ModelConfig()
    eval: EvalConfig = EvalConfig()
    train: TrainConfig = TrainConfig()

    @staticmethod
    def for_dataset(name: str, variant: str = "fusion", **model_kw) -> "FrameworkConfig":
        geo = geometry_for(name)
        return FrameworkConfig(
            geometry=geo,
            model=ModelConfig(variant=variant, num_classes=geo.num_classes, **model_kw),
        )
