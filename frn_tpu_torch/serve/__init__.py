from frn_tpu_torch.serve.engine import Detections, ServeOptions, ServingEngine
from frn_tpu_torch.serve.http import DetectionServer

__all__ = ["Detections", "ServeOptions", "ServingEngine", "DetectionServer"]
