"""Raw DSEC-Det evaluation entry point of the port (counterpart of
``frn_tpu/cli/test_dsec_det.py``, which replaces the reference's
test_dsec_det.py).

    python -m frn_tpu_torch.cli.test_dsec_det --dataset_root DSEC_DET \\
        --checkpoint model.pth                                      # on the card
    ... --wire compact                 # uint8 RGB + int8 voxels, normalized on the card
    ... --device cpu                   # on the CPU

Evaluates a checkpoint (a ``.pt``/``.pth`` state dict, or a directory of the
port's checkpoints: its latest epoch) over raw DSEC-Det sequences (event h5
files: ``h5py``) with a configurable event representation
(--event_representation voxel|time_surface|event_count|binary) and event
time window (--dt ms), per the reference's flags (test_dsec_det.py:65-66);
prints fps and the COCO-style summary, and returns the mAP.
"""

from __future__ import annotations

import argparse
import json

from frn_tpu_torch.cli.common import (
    FUSION_TO_VARIANT,
    add_model_args,
    load_checkpoint_into_model,
    setup_device,
)
from frn_tpu_torch.config import DSEC_DET, FrameworkConfig, ModelConfig


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate on raw DSEC-Det data (PyTorch port)")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--split_yaml", default=None)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument(
        "--event_representation", default="voxel",
        choices=["voxel", "time_surface", "event_count", "binary"],
    )
    p.add_argument("--dt", type=int, default=50, help="event window in ms")
    p.add_argument(
        "--wire", default="f32", choices=["f32", "compact"],
        help="host->device batch format: 'compact' ships uint8 RGB + int8 raw "
        "count voxels and normalizes on the device (4x fewer input bytes; voxel "
        "representation only)",
    )
    add_model_args(p)
    return p


def eval_dataset(args):
    """The CLI's evaluation set: ``--split`` of ``--dataset_root`` on the
    chosen wire and representation."""
    from frn_tpu_torch.data.dsec_det import DSECDetDataset

    return DSECDetDataset(
        args.dataset_root, split=args.split, split_yaml=args.split_yaml, geometry=DSEC_DET,
        time_window_us=args.dt * 1000,
        event_representation=args.event_representation,
        compact_wire=args.wire == "compact",
    )


def build_config(args, dataset) -> FrameworkConfig:
    return FrameworkConfig(
        geometry=DSEC_DET,
        model=ModelConfig(
            variant=FUSION_TO_VARIANT[args.fusion], depth=args.depth,
            num_classes=dataset.num_classes(), compute_dtype=args.compute_dtype,
            feature_size=args.feature_size, attention_quant=args.attention_quant,
        ),
    )


def build_inference_fn(args, dataset, config, device):
    """The detector of ``config`` on ``device`` with ``--checkpoint`` loaded,
    as the inference function of ``--wire``."""
    from frn_tpu_torch.eval.detections import make_inference_fn
    from frn_tpu_torch.models.detector import init_detector

    model = init_detector(config, seed=0, device=device)
    load_checkpoint_into_model(args, model)
    return make_inference_fn(model, config, wire=args.wire, rgb_standardize=dataset.normalize_rgb)


def main(argv=None):
    """Evaluates; returns the mAP."""
    args = get_parser().parse_args(argv)
    device = setup_device(args)

    from frn_tpu_torch.eval.evaluator import evaluate_dataset

    dataset = eval_dataset(args)
    config = build_config(args, dataset)
    infer = build_inference_fn(args, dataset, config, device)
    res = evaluate_dataset(dataset, infer, config, batch_size=args.batch_size, verbose=True)
    print("fps", round(res.fps, 2))
    print(json.dumps({k: round(v, 4) for k, v in res.summary.items()}, indent=2))
    return res.summary["mAP"]


if __name__ == "__main__":
    main()
