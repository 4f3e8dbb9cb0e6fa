"""Offline detector-on-folder visualizer of the port (counterpart of
``frn_tpu/cli/visualize.py``, which replaces visulize_fusion.py).

Runs the detector over a CSV dataset and writes side-by-side RGB/event panels
with per-class colored boxes at score > 0.5:

    python -m frn_tpu_torch.cli.visualize --csv_test labels_test.csv \\
        --csv_classes labels_map.csv --root_img images --root_event events \\
        --checkpoint model.pth --output_dir panels           # on the card
    ... --device cpu                                        # on the CPU
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from frn_tpu_torch.cli.common import (
    add_dataset_args,
    add_model_args,
    build_config,
    build_csv_dataset,
    load_checkpoint_into_model,
    setup_device,
)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visualize detections (PyTorch port)")
    add_dataset_args(p, train=False)
    add_model_args(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output_dir", default="./visualizations")
    p.add_argument("--score_threshold", type=float, default=0.5)
    p.add_argument("--max_images", type=int, default=50)
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.csv_test is None:
        raise SystemExit("--csv_test is required")
    device = setup_device(args)

    dataset = build_csv_dataset(args, args.csv_test)
    config = build_config(args, dataset.num_classes(), 1)

    from frn_tpu_torch.eval.detections import make_inference_fn
    from frn_tpu_torch.models.detector import init_detector
    from frn_tpu_torch.utils.visualization import save_detection_panel

    model = init_detector(config, seed=0, device=device)
    load_checkpoint_into_model(args, model)
    infer = make_inference_fn(model, config)

    names = [dataset.label_to_name(i) for i in range(dataset.num_classes())]
    os.makedirs(args.output_dir, exist_ok=True)
    for i in range(min(len(dataset), args.max_images)):
        raw_rgb = dataset.load_rgb(i)  # un-normalized for display
        sample = dataset[i]
        scores, labels, boxes = (x[0].cpu().numpy() for x in infer(
            torch.from_numpy(sample["rgb"][None]).to(device),
            torch.from_numpy(sample["event"][None]).to(device),
        ))
        save_detection_panel(
            os.path.join(args.output_dir, f"{i:06d}.png"),
            raw_rgb, sample["event"], boxes, labels, scores,
            class_names=names, score_threshold=args.score_threshold,
        )
    print(f"wrote {min(len(dataset), args.max_images)} panels to {args.output_dir}")


if __name__ == "__main__":
    main()
