"""Raw-DSEC training entry point of the port (counterpart of
``frn_tpu/cli/train_dsec_det_fast.py``, which replaces the reference's
train_dsec_det_fast.py).

    python -m frn_tpu_torch.cli.train_dsec_det_fast --dataset_root DSEC_DET   # on the card
    ... --wire events                  # raw event streams, voxelized on the card
    ... --debug_data                   # print 5 batches and exit
    ... --device cpu                   # on the CPU

Trains directly from DSEC-Det sequence directories (event h5 + tracks.npy,
which need ``h5py``), with the reference recipe: Adam lr 5e-5, grad clip 1.0,
an optimizer step every micro-batch, plateau factor 0.5, safe-step guards
(non-finite or loss > 50: zero gradients), and with --split_yaml (pyyaml) an
evaluation of the 'val' split every --eval_every epochs, keeping the best-mAP
checkpoint. At the default ``--compute_dtype float32`` TF32 is off and the
attention runs the f32 flash kernels on the card.
"""

from __future__ import annotations

import argparse

from frn_tpu_torch.cli.common import FUSION_TO_VARIANT, add_model_args, make_eval_fn, setup_device
from frn_tpu_torch.config import DSEC_DET, FrameworkConfig, ModelConfig, TrainConfig


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train on raw DSEC-Det data (PyTorch port)")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--split_yaml", default=None, help="sequence split config")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--time_window_us", type=int, default=1_000_000)
    p.add_argument("--checkpoint_dir", default="./checkpoints_dsec_det")
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--debug_data", action="store_true", help="inspect 5 batches and exit")
    p.add_argument(
        "--wire", default="f32", choices=["f32", "compact", "events"],
        help="host->device batch format: 'compact' ships uint8 RGB + int8 raw "
        "count voxels and normalizes on the device inside the train step (4x "
        "fewer input bytes, less host CPU per batch); 'events' ships the raw "
        "x/y/t/p streams and voxelizes on the device (no host voxelization: "
        "the loader's way out where host cores bound it)",
    )
    p.add_argument(
        "--event_capacity", type=int, default=65536,
        help="'events' wire: static event slots per sample (windows beyond "
        "capacity keep their first N events)",
    )
    add_model_args(p)
    return p


def train_dataset(args):
    """The CLI's training set: the 'train' split of ``--dataset_root`` on the
    chosen wire."""
    from frn_tpu_torch.data.dsec_det import DSECDetDataset

    return DSECDetDataset(
        args.dataset_root, split="train", split_yaml=args.split_yaml, geometry=DSEC_DET,
        time_window_us=args.time_window_us,
        compact_wire=args.wire == "compact",
        events_wire=args.wire == "events",
        event_capacity=args.event_capacity,
    )


def build_config(args, train_ds) -> FrameworkConfig:
    """The CLI's recipe over ``train_ds``."""
    return FrameworkConfig(
        geometry=DSEC_DET,
        model=ModelConfig(
            variant=FUSION_TO_VARIANT[args.fusion], depth=args.depth,
            num_classes=train_ds.num_classes(), compute_dtype=args.compute_dtype,
            feature_size=args.feature_size, attention_quant=args.attention_quant,
        ),
        train=TrainConfig(
            batch_size=args.batch_size, learning_rate=args.lr,
            grad_clip_norm=1.0, accum_steps=1, epochs=args.epochs,
            plateau_factor=0.5,
            loss_skip_threshold=50.0,  # fast-trainer guard (train_dsec_det_fast.py:256)
            input_wire=args.wire,
            input_rgb_standardize=train_ds.normalize_rgb,
        ),
    )


def print_debug_batches(args, train_ds, config) -> None:
    """The first 5 batches' event and RGB ranges and valid annotations."""
    from frn_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader(train_ds, config.geometry, batch_size=args.batch_size)
    for i, batch in enumerate(loader):
        if i >= 5:
            break
        rgb, ann = batch["rgb"], batch["annot"]
        if args.wire == "events":
            ev_desc = f"events n={batch['event_n'].tolist()} cap={batch['event_x'].shape[1]}"
        else:
            ev = batch["event"]
            ev_desc = f"event {ev.shape} [{ev.min():.3f},{ev.max():.3f}]"
        print(
            f"batch {i}: {ev_desc} "
            f"rgb {rgb.shape} [{rgb.min():.3f},{rgb.max():.3f}] "
            f"valid annots {(ann[..., 4] >= 0).sum()}"
        )


def main(argv=None):
    """Trains; returns the per-epoch mean loss history (0 after --debug_data)."""
    args = get_parser().parse_args(argv)
    device = setup_device(args)

    train_ds = train_dataset(args)
    config = build_config(args, train_ds)
    if args.debug_data:
        print_debug_batches(args, train_ds, config)
        return 0

    eval_fn = None
    if args.split_yaml:
        from frn_tpu_torch.data.dsec_det import DSECDetDataset

        val_ds = DSECDetDataset(
            args.dataset_root, split="val", split_yaml=args.split_yaml, geometry=DSEC_DET,
            time_window_us=args.time_window_us,
        )
        if len(val_ds):
            eval_fn = make_eval_fn(config, val_ds)

    from frn_tpu_torch.train.trainer import Trainer

    trainer = Trainer(
        config, train_ds, checkpoint_dir=args.checkpoint_dir,
        eval_fn=eval_fn, eval_every=args.eval_every, device=device,
    )
    if args.continue_training:
        trainer.resume()
    return trainer.fit(args.epochs)


if __name__ == "__main__":
    main()
