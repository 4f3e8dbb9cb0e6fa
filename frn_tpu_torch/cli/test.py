"""Evaluation entry point of the port (counterpart of ``frn_tpu/cli/test.py``).

Clean COCO-style mAP + fps, or the corruption-robustness sweep
(--eval_corruption with --corruption_group 0|1|2, severities 1..5), with the
JAX entry point's flags and artifacts:

    python -m frn_tpu_torch.cli.test --csv_test labels_test.csv \\
        --csv_classes labels_map.csv --root_img images --root_event events \\
        --checkpoint model.pth --save_detect_folder eval_out        # on the card
    ... --device cpu                                               # on the CPU

Eight of the on-the-fly corruptions need OpenCV (``ops/corruption.py``);
--corruption_root (pre-generated folders) needs none. --approx_topk and
--postprocess dense raise (not ported); --data_parallel over more than one
card raises (A14).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle

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
    p = argparse.ArgumentParser(description="Evaluate the FRN detector (PyTorch port)")
    add_dataset_args(p, train=False)
    add_model_args(p)
    p.add_argument("--checkpoint", required=True,
                   help=".pt/.pth (a reference state dict) or a port checkpoint directory")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--eval_corruption", action="store_true")
    p.add_argument("--corruption_group", type=int, default=0, choices=[0, 1, 2])
    p.add_argument(
        "--corruption_root", default=None,
        help="root of pre-generated corruption folders "
        "(<root>/<type>/severity_<s>/...), the reference's input path "
        "(test_dsec.py:133); omit to synthesize corruptions on the fly",
    )
    p.add_argument("--save_detect_folder", default="./eval_results")
    p.add_argument("--load_detection", action="store_true")
    p.add_argument(
        "--data_parallel", "--mesh_eval", action="store_true",
        help="shard eval batches over all devices (reference wraps eval in "
        "DataParallel, test_dsec.py:103-105): with one visible card it runs on "
        "that card; with more it raises (not ported yet, ROADMAP A14)",
    )
    p.add_argument(
        "--pr_curve_path", default=None,
        help="write per-class {label}_precision_recall.jpg PR curves at IoU 0.5 "
        "to this folder (csv_eval.py:418-429 save_path behavior); needs matplotlib",
    )
    p.add_argument(
        "--approx_topk", action="store_true",
        help="approximate per-class NMS candidate pool: not ported (raises); the "
        "exact pool is the default",
    )
    p.add_argument(
        "--exact_pool", default=None, choices=["two_stage", "radix"],
        help="exact candidate-pool algorithm (EvalConfig.exact_pool): both name the "
        "same exact top-k in the port. Default: config default.",
    )
    p.add_argument(
        "--postprocess", default=None,
        choices=["dense", "pooled", "pooled_logits", "pooled_chanlast"],
        help="eval postprocess pipeline shape (EvalConfig.postprocess): the pooled "
        "rungs decode only the per-class top-k pool; dense is not ported (raises). "
        "Default: config default.",
    )
    p.add_argument(
        "--max_detections", type=int, default=100,
        help="static per-image detection cap. The reference eval branch is "
        "UNCAPPED (model.py:326-364 returns every above-threshold post-NMS "
        "box); a static-shape pipeline needs a bound. 100 matches the COCO "
        "maxDets convention; raise (<= 3*per_class_topk) to tighten csv_eval-"
        "protocol parity when images yield >100 detections.",
    )
    p.add_argument(
        "--coco_protocol", action="store_true",
        help="additionally report the full pycocotools-protocol summary "
        "(AP/AP50/AP75/APs/m/l, AR@1/10/100) per coco_eval.py:6-84",
    )
    return p


def write_corruption_artifacts(results, class_names, folder) -> None:
    """Reference artifact layout: one {corruption}_ap.txt pickle per corruption,
    keyed by class name -> per-severity AP list (test_dsec.py:176-178), plus the
    combined corruption_aps.pkl."""
    for corruption, per_sev in results.items():
        per_class = {
            name: [per_sev[s][label] for s in sorted(per_sev)]
            for label, name in enumerate(class_names)
        }
        with open(os.path.join(folder, f"{corruption}_ap.txt"), "wb") as f:
            pickle.dump(per_class, f)
    with open(os.path.join(folder, "corruption_aps.pkl"), "wb") as f:
        pickle.dump(results, f)


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.csv_test is None:
        raise SystemExit("--csv_test is required for evaluation")
    device = setup_device(args)
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"--data_parallel over {torch.cuda.device_count()} cards is not ported yet "
            "(ROADMAP A14); make one card visible (CUDA_VISIBLE_DEVICES)")

    dataset = build_csv_dataset(args, args.csv_test)
    config = build_config(args, dataset.num_classes(), args.batch_size)
    # record runs use the exact candidate pool (the only one ported)
    config = dataclasses.replace(
        config,
        eval=dataclasses.replace(
            config.eval,
            approx_topk=args.approx_topk,
            max_detections=args.max_detections,
            **({"postprocess": args.postprocess} if args.postprocess is not None else {}),
            **({"exact_pool": args.exact_pool} if args.exact_pool is not None else {}),
        ),
    )

    from frn_tpu_torch.eval.detections import make_inference_fn
    from frn_tpu_torch.eval.evaluator import corruption_sweep, evaluate_dataset
    from frn_tpu_torch.models.detector import init_detector

    model = init_detector(config, seed=0, device=device)
    load_checkpoint_into_model(args, model)
    infer = make_inference_fn(model, config)

    os.makedirs(args.save_detect_folder, exist_ok=True)
    if args.eval_corruption:
        results = corruption_sweep(
            dataset, infer, config,
            corruption_group=args.corruption_group,
            batch_size=args.batch_size,
            save_root=args.save_detect_folder,
            corruption_root=args.corruption_root,
            verbose=True,
        )
        class_names = [dataset.label_to_name(i) for i in range(dataset.num_classes())]
        for corruption, per_sev in results.items():
            means = {s: round(float(np.mean(v)), 4) for s, v in per_sev.items()}
            print(f"{corruption}: {means}")
        write_corruption_artifacts(results, class_names, args.save_detect_folder)
    else:
        res = evaluate_dataset(
            dataset, infer, config, batch_size=args.batch_size,
            save_folder=args.save_detect_folder,
            load_cached=args.load_detection, verbose=True,
        )
        print("fps", round(res.fps, 2))
        print(json.dumps({k: round(v, 4) for k, v in res.summary.items()}, indent=2))
        with open(os.path.join(args.save_detect_folder, "evaluation_aps.pkl"), "wb") as f:
            pickle.dump(res.per_class_aps, f)
        if args.pr_curve_path:
            from frn_tpu_torch.eval.ap import load_detections, plot_pr_curves

            dets, annots = load_detections(args.save_detect_folder)
            paths = plot_pr_curves(
                dets, annots, dataset.num_classes(), args.pr_curve_path,
                dataset.label_to_name,
            )
            print("PR curves:", ", ".join(paths))
        if args.coco_protocol:
            from frn_tpu_torch.eval.coco_protocol import evaluate_coco

            evaluate_coco(dataset, infer, config, batch_size=args.batch_size)
    return 0


if __name__ == "__main__":
    main()
