"""Serving entry point of the port: a long-lived batched HTTP detection service.

Counterpart of ``frn_tpu/cli/serve.py``, with its flags plus ``--device``.
The reference has no server: its serving-equivalent path is the offline
detect_image loop (visulize_fusion.py:47-131), a batch-1 forward and a host
filter at score > 0.5. This entry point serves that detector with a ladder
of batch sizes, a bounded coalescing delay and a stdlib HTTP front end
(``frn_tpu_torch/serve/engine.py``, ``frn_tpu_torch/serve/http.py``):

    python -m frn_tpu_torch.cli.serve --checkpoint model.pth --port 8000   # on the card
    python -m frn_tpu_torch.cli.serve ... --device cpu                    # on the CPU
    curl -s -X POST --data-binary @frame.npz localhost:8000/infer

``--checkpoint`` takes a reference ``.pt``/``.pth`` file or a checkpoint
directory of the port's trainer; an orbax directory of ``frn_tpu`` raises
(converting one is ROADMAP A16). ``--data_parallel`` serves
replicas on every visible card, each batch split over them (every bucket a
multiple of the cards); with one card it serves from that card.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from frn_tpu_torch.cli.common import add_model_args, geometry_from_args


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve the FRN detector over HTTP (PyTorch port)")
    add_model_args(p)
    p.add_argument("--dataset_name", default="dsec", choices=["dsec", "ddd17"])
    p.add_argument("--num_classes", type=int, default=None,
                   help="override the dataset geometry's class count")
    p.add_argument("--event_type", default="voxel", choices=["voxel", "gray"])
    p.add_argument("--image_height", type=int, default=None)
    p.add_argument("--image_width", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help=".pt/.pth (a reference state dict) or a port checkpoint "
                   "directory; omit for a random-init smoke server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--buckets", default="1,2,4,8,16",
                   help="comma-separated batch-size ladder; every bucket is run "
                   "once at startup")
    p.add_argument("--max_delay_ms", type=float, default=2.0,
                   help="max batching-coalesce wait once >=1 request is queued "
                   "(0 = lowest latency, a few ms = higher throughput)")
    p.add_argument("--score_threshold", type=float, default=0.5,
                   help="serving score cut (reference visulize_fusion.py:105)")
    p.add_argument("--max_queue", type=int, default=256)
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="batches in flight on the device while earlier results "
                   "come back (1 = one batch at a time)")
    p.add_argument("--wire_format", default=None,
                   choices=["compact", "f32", "events"],
                   help="request tensor encoding: 'compact' = raw uint8 RGB + "
                   "int8 count voxel, normalized on the device (4x less input "
                   "bandwidth; default for voxel events); 'f32' = pre-normalized "
                   "eval-pipeline tensors (default for --event_type gray); "
                   "'events' = raw x/y/t/p streams, voxelized on the device "
                   "(clients never build grids)")
    p.add_argument("--event_capacity", type=int, default=65536,
                   help="'events' wire format: static event slots per request "
                   "(streams beyond it are truncated; a 50 ms DSEC window is "
                   "~25-50k events)")
    p.add_argument("--request_timeout_s", type=float, default=60.0)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running every bucket at startup")
    p.add_argument("--data_parallel", action="store_true",
                   help="serve replicas over all visible cards, each batch split "
                   "over them (every bucket a multiple of the cards); with one "
                   "card it serves from that card")
    return p


def build_engine(args):
    """(engine, config) from parsed args — separated from main() for tests."""
    from frn_tpu_torch.cli.common import FUSION_TO_VARIANT, load_checkpoint_into_model, setup_device
    from frn_tpu_torch.config import FrameworkConfig, ModelConfig
    from frn_tpu_torch.models.detector import init_detector
    from frn_tpu_torch.serve import ServeOptions, ServingEngine

    device = setup_device(args)
    mesh = None
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        from frn_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
    geo = geometry_from_args(args, args.num_classes)
    config = FrameworkConfig(
        geometry=geo,
        model=ModelConfig(
            variant=FUSION_TO_VARIANT[args.fusion],
            depth=args.depth,
            num_classes=geo.num_classes,
            compute_dtype=args.compute_dtype,
            feature_size=args.feature_size,
            attention_quant=args.attention_quant,
        ),
    )
    buckets = tuple(sorted({int(b) for b in args.buckets.split(",") if b.strip()}))
    wire = args.wire_format or ("f32" if geo.event_channels == 1 else "compact")
    options = ServeOptions(
        buckets=buckets,
        max_delay_ms=args.max_delay_ms,
        score_threshold=args.score_threshold,
        max_queue=args.max_queue,
        pipeline_depth=args.pipeline_depth,
        wire_format=wire,
        event_capacity=args.event_capacity,
    )

    model = init_detector(config, seed=0, device=device)
    if args.checkpoint is None:
        print("WARNING: no --checkpoint given; serving RANDOM-INIT weights")
    else:
        load_checkpoint_into_model(args, model)
    config = dataclasses.replace(
        config, eval=dataclasses.replace(config.eval, score_threshold=min(
            config.eval.score_threshold, args.score_threshold))
    )
    return ServingEngine(model, config, options, mesh=mesh), config


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    engine, config = build_engine(args)
    engine.start()
    if not args.no_warmup:
        print(f"warming up buckets {engine.options.buckets} "
              f"at {config.geometry.height}x{config.geometry.width} ...")
        engine.warmup()

    from frn_tpu_torch.serve import DetectionServer

    server = DetectionServer(
        engine, host=args.host, port=args.port, timeout_s=args.request_timeout_s
    )
    host, port = server.address
    print(f"serving on http://{host}:{port}  (POST /infer, GET /healthz, GET /stats)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        engine.stop()
        print("final stats:", engine.stats())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
