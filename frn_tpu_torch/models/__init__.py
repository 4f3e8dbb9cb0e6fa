from frn_tpu_torch.models.detector import (  # noqa: F401
    FRNDetector,
    decode_detections,
    eval_output_for,
    image_anchors,
    init_detector,
)
