"""Shared CLI plumbing of the port's entry points.

Counterpart of ``frn_tpu/cli/common.py``. Flag names mirror the reference
scripts (train_dsec.py:35-52, test_dsec.py:60-84) minus the hard-coded
absolute default paths: paths are required flags. One more flag, ``--device``:
the card by default (``device.resolve_device``), ``cpu`` on request.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import Iterator, Optional

import torch

from frn_tpu_torch.config import FrameworkConfig, ModelConfig, TrainConfig, geometry_for
from frn_tpu_torch.device import resolve_device
from frn_tpu_torch.parallel.mesh import init_distributed, launched

# a collective waits this long for a rank (rank 0's periodic evaluation
# included) before the group fails
TRAIN_COLLECTIVE_TIMEOUT_S = 1800.0

FUSION_TO_VARIANT = {"fpn_fusion": "fusion", "rgb": "rgb", "event": "event"}


def add_dataset_args(p: argparse.ArgumentParser, train: bool) -> None:
    p.add_argument("--dataset_name", default="dsec", choices=["dsec", "ddd17"])
    p.add_argument("--csv_classes", required=True, help="class list CSV (name,id)")
    if train:
        p.add_argument("--csv_train", required=True, help="training annotations CSV")
        p.add_argument("--csv_val", default=None, help="validation annotations CSV")
    p.add_argument("--csv_test", default=None, help="test annotations CSV")
    p.add_argument("--root_img", required=True, help="root dir of RGB images")
    p.add_argument("--root_event", required=True, help="root dir of event files")
    p.add_argument("--event_type", default="voxel", choices=["voxel", "gray"])
    p.add_argument(
        "--path_schema", default="event_keyed", choices=["event_keyed", "rgb_keyed"],
        help="CSV key layout: event-file keyed (dataloader.py) or RGB-path keyed "
        "(dataloader_rgb.py:113-126)",
    )
    # geometry overrides (off-benchmark resolutions, fast smoke runs)
    p.add_argument("--image_height", type=int, default=None)
    p.add_argument("--image_width", type=int, default=None)


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fusion", default="fpn_fusion", choices=list(FUSION_TO_VARIANT))
    p.add_argument("--depth", type=int, default=50, choices=[18, 34, 50])
    p.add_argument(
        "--compute_dtype", default="float32", choices=["float32", "bfloat16"],
        help="activation dtype. At float32 the entry point turns TF32 off for cuDNN's "
        "convolutions and for matmuls (torch.backends.cudnn.allow_tf32 and "
        "torch.backends.cuda.matmul.allow_tf32 = False), so that f32 means f32",
    )
    p.add_argument("--feature_size", type=int, default=256)
    p.add_argument(
        "--attention_quant", default=None, choices=["int8_qk", "int8"],
        help="int8 attention (inference only, bf16 compute): QK^T, or QK^T and PV, "
        "in int8 on the int8 flash kernel. Default off = the exact flash kernel.",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device to run on; default the CUDA card (the entry point raises "
        "without one), 'cpu' runs the plain PyTorch versions of the kernels",
    )


def setup_device(args) -> torch.device:
    """The run's device; at float32 compute, TF32 off for convolutions and
    matmuls (cuDNN runs f32 convolutions in TF32 by default)."""
    device = resolve_device(args.device)
    if args.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


@contextlib.contextmanager
def train_device(args) -> Iterator[torch.device]:
    """The train CLIs' device (``setup_device``). Started by ``torchrun
    --nproc_per_node N -m frn_tpu_torch.cli.train ...``, each process joins
    the process group for the run (NCCL on ``cuda:LOCAL_RANK``; gloo with
    ``--device cpu``) and trains data-parallel; started plainly, one device."""
    device = setup_device(args)
    if not launched():
        yield device
        return
    device = init_distributed(None if args.device is None else device,
                              timeout_s=TRAIN_COLLECTIVE_TIMEOUT_S)
    try:
        yield device
    finally:
        torch.distributed.destroy_process_group()


def geometry_from_args(args, num_classes: Optional[int] = None):
    geo = geometry_for(args.dataset_name)
    if num_classes is not None and num_classes != geo.num_classes:
        geo = dataclasses.replace(
            geo, num_classes=num_classes,
            class_names=tuple(str(i) for i in range(num_classes)),
        )
    if getattr(args, "event_type", "voxel") == "gray":
        # e2vid grayscale reconstructions are single-channel (dataloader.py:306-319)
        geo = dataclasses.replace(geo, event_channels=1)
    if getattr(args, "image_height", None) or getattr(args, "image_width", None):
        geo = dataclasses.replace(
            geo,
            height=args.image_height or geo.height,
            width=args.image_width or geo.width,
        )
    return geo


def build_config(args, num_classes: int, batch_size: int, epochs: Optional[int] = None
                 ) -> FrameworkConfig:
    geo = geometry_from_args(args, num_classes)
    return FrameworkConfig(
        geometry=geo,
        model=ModelConfig(
            variant=FUSION_TO_VARIANT[args.fusion],
            depth=args.depth,
            num_classes=num_classes,
            compute_dtype=args.compute_dtype,
            feature_size=getattr(args, "feature_size", 256),
            attention_quant=getattr(args, "attention_quant", None),
        ),
        train=TrainConfig(
            batch_size=batch_size,
            learning_rate=getattr(args, "lr", 1e-4),
            epochs=epochs or getattr(args, "epochs", 60),
            warmup_steps=getattr(args, "warmup_steps", 0),
            plateau_patience=getattr(args, "plateau_patience", 3),
        ),
    )


def build_csv_dataset(args, split_csv: str):
    from frn_tpu_torch.data.csv_dataset import CSVDetectionDataset

    return CSVDetectionDataset(
        geometry=geometry_from_args(args),
        annotations_csv=split_csv,
        class_map_csv=args.csv_classes,
        event_dir=args.root_event,
        img_dir=args.root_img,
        event_type=args.event_type,
        path_schema=getattr(args, "path_schema", "event_keyed"),
    )


def load_checkpoint_into_model(args, model) -> None:
    """Loads ``args.checkpoint`` into ``model`` with ``strict=True``: a
    reference ``.pt``/``.pth`` file, or a directory of the port's
    ``CheckpointManager`` (its latest epoch)."""
    from frn_tpu_torch.convert import load_reference_checkpoint

    path = args.checkpoint
    if os.path.isdir(path):
        from frn_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(path)
        epoch = mgr.latest_epoch()
        if epoch is None and any(name.isdigit() for name in os.listdir(path)):
            raise ValueError(
                f"{path} looks like an orbax checkpoint directory of frn_tpu (numbered "
                "step folders): the port reads .pt/.pth files and its own checkpoint "
                "directories (cli.convert_checkpoint writes one from a .pt); an orbax "
                "directory is not read, since reading it needs orbax")
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {path}")
        path = mgr.path(epoch)
    elif not path.endswith((".pt", ".pth")):
        raise ValueError(f"--checkpoint takes a .pt/.pth file or a checkpoint directory: {path}")
    load_reference_checkpoint(path, model)


def load_checkpoint_into_state(args, state) -> dict:
    """Loads ``args.checkpoint`` into a train state (``train/loop.py``), as
    ``frn_tpu``'s ``load_checkpoint_into_state`` does: a reference
    ``.pt``/``.pth`` file sets the model's weights (``strict=True``); a
    directory of the port's ``CheckpointManager`` (where ``frn_tpu`` takes an
    orbax directory) restores its latest epoch whole: weights, optimizer,
    gradient sum and counters. Returns that checkpoint's payload ({} for a
    file)."""
    if os.path.isdir(args.checkpoint):
        from frn_tpu_torch.train.checkpoint import CheckpointManager

        return CheckpointManager(args.checkpoint).restore(state)
    load_checkpoint_into_model(args, state.model)
    return {}


def make_eval_fn(config, test_dataset, batch_size: int = 8):
    """Periodic-eval callback for the Trainer: (model, state) -> mAP@[.5:.95]."""
    from frn_tpu_torch.eval.detections import make_inference_fn
    from frn_tpu_torch.eval.evaluator import evaluate_dataset

    # the wire follows the dataset: a compact-wire dataset fed to the f32
    # wire would report near-zero mAP (make_inference_fn's guard raises)
    wire = "compact" if getattr(test_dataset, "compact_wire", False) else "f32"
    rgb_standardize = bool(getattr(test_dataset, "normalize_rgb", False)) and wire == "compact"

    def eval_fn(model, state):
        infer = make_inference_fn(model, config, wire=wire, rgb_standardize=rgb_standardize)
        res = evaluate_dataset(test_dataset, infer, config, batch_size=batch_size)
        return res.summary["mAP"]

    return eval_fn
