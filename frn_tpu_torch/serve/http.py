"""Minimal stdlib HTTP front end over the ServingEngine.

Counterpart of ``frn_tpu/serve/http.py``: the same paths, status codes and
JSON. Protocol (stdlib-only on both sides):

  POST /infer     body = .npz bytes (np.savez / np.savez_compressed) with
                    'rgb'   (H, W, 3)  uint8 0..255, or float 0..1
                  and ONE of
                    'event' (H, W, C)  raw voxel grid (polarity counts), or
                    'x','y','t','p'    raw event stream arrays
                  optional scalar 'preprocessed': nonzero = arrays are already
                  normalized (standardized RGB + tanh voxel) and are fed as-is.
                  -> JSON {"detections": [{"box", "score", "class_id",
                     "class"}], "latency_ms", "batch_size"}
  GET /healthz    -> {"ok": true}
  GET /stats      -> engine.stats() JSON (latency percentiles, batch fill, rps)

Client example:
    buf = io.BytesIO(); np.savez(buf, rgb=rgb_u8, event=voxel)
    urllib.request.urlopen(Request(url + "/infer", data=buf.getvalue(),
                           method="POST")).read()

The reference has no server; its serving-equivalent path is the offline
detect_image loop (visulize_fusion.py:47-131). This front end exposes that
capability as a long-lived batched service.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from frn_tpu_torch.serve.engine import ServingEngine


def _prepare_inputs(engine: ServingEngine, arrays) -> Tuple[np.ndarray, np.ndarray]:
    """npz payload -> (rgb, event voxel) HWC in the engine's wire format."""
    from frn_tpu_torch.ops.voxelize import voxelize_events_np

    geo = engine.config.geometry
    # 'compact' and 'sparse' both want RAW inputs (uint8 RGB + count voxel);
    # normalization runs on device, and sparse additionally delta-encodes in
    # engine._to_wire
    compact = engine.options.wire_format in ("compact", "sparse")
    if "rgb" not in arrays:
        raise ValueError("payload must contain 'rgb'")
    rgb = np.asarray(arrays["rgb"])
    preprocessed = bool(np.any(arrays["preprocessed"])) if "preprocessed" in arrays else False
    if preprocessed and compact:
        raise ValueError(
            f"this server runs wire_format={engine.options.wire_format!r} (raw "
            "uint8 RGB + raw count voxel, normalized on device); pre-normalized "
            "payloads need a server started with wire_format='f32'"
        )

    if "event" in arrays:
        event = np.asarray(arrays["event"], np.float32)
        if event.ndim == 3 and event.shape[0] == geo.event_channels:
            event = np.transpose(event, (1, 2, 0))  # CHW npz (reference layout) -> HWC
    elif all(k in arrays for k in ("x", "y", "t", "p")):
        voxel = voxelize_events_np(
            arrays["x"], arrays["y"], arrays["t"], arrays["p"],
            num_bins=geo.event_channels, height=geo.height, width=geo.width,
        )
        event = np.transpose(voxel, (1, 2, 0))
        preprocessed = False  # raw events are never pre-normalized
    else:
        raise ValueError("payload must contain 'event' or raw 'x','y','t','p'")

    if rgb.dtype != np.uint8:
        rgb = np.asarray(rgb, np.float32)
        if rgb.max(initial=0.0) > 2.0:  # uint8-range float payload
            rgb = rgb / 255.0
    if compact:
        # engine._to_wire quantizes; the device program normalizes (engine.model_inputs)
        return rgb, event
    from frn_tpu_torch.data.transforms import normalize_rgb
    from frn_tpu_torch.ops.voxelize import normalize_event_voxel_np

    if not preprocessed:
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float32) / 255.0
        rgb = normalize_rgb(rgb, geo)
        event = normalize_event_voxel_np(event)  # elementwise + global max
    return rgb, event


def make_handler(engine: ServingEngine, timeout_s: float = 60.0):
    class Handler(BaseHTTPRequestHandler):
        # one engine for all handler threads; ThreadingHTTPServer gives us a
        # thread per connection, the engine batches across them
        protocol_version = "HTTP/1.1"

        def _send_json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True})
            elif self.path == "/stats":
                self._send_json(200, engine.stats())
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/infer":
                self._send_json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = np.load(io.BytesIO(self.rfile.read(length)), allow_pickle=False)
                if engine.options.wire_format == "events":
                    # raw-stream server: x/y/t/p go straight to the device
                    # voxelizer; voxel-grid payloads have no program to run
                    if not all(k in payload for k in ("x", "y", "t", "p")):
                        raise ValueError(
                            "this server runs wire_format='events'; send raw "
                            "'x','y','t','p' streams (voxel grids need a "
                            "'compact' or 'f32' server)"
                        )
                    if "rgb" not in payload:
                        raise ValueError("payload must contain 'rgb'")
                    det = engine.submit_events(
                        payload["x"], payload["y"], payload["t"], payload["p"],
                        payload["rgb"],
                    ).result(timeout=timeout_s)
                else:
                    rgb, event = _prepare_inputs(engine, payload)
                    det = engine.infer(rgb, event, timeout=timeout_s)
            except Exception as e:
                self._send_json(400, {"error": str(e)})
                return
            self._send_json(
                200,
                {
                    "detections": det.to_json(engine.config.geometry.class_names),
                    "latency_ms": round(det.latency_ms, 3),
                    "batch_size": det.batch_size,
                },
            )

    return Handler


class DetectionServer:
    """Threaded HTTP server wrapping a started ServingEngine."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1", port: int = 8000,
                 timeout_s: float = 60.0):
        self.engine = engine
        self.httpd = ThreadingHTTPServer((host, port), make_handler(engine, timeout_s))
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start_background(self) -> "DetectionServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
