"""Training entry point of the port (counterpart of ``frn_tpu/cli/train.py``).

    python -m frn_tpu_torch.cli.train --dataset_name dsec --epochs 60 \\
        --csv_train labels_train.csv --csv_classes labels_map.csv \\
        --root_img images --root_event events                       # on the card
    python -m frn_tpu_torch.cli.train_dsec ...                        # DSEC defaults
    python -m frn_tpu_torch.cli.train_ddd17 ...                       # DDD17 defaults
    ... --device cpu                                                  # on the CPU
    torchrun --nproc_per_node 4 -m frn_tpu_torch.cli.train ...        # 4 cards, data-parallel

Recipe per the reference: Adam lr 1e-4, grad clip 0.1, optimizer step every 2
micro-batches, ReduceLROnPlateau(patience 3) on mean epoch loss, p=0.15 RGB
modality dropout in the fusion variant. At the default ``--compute_dtype
float32`` TF32 is off and the attention's flash kernels run at f32 on the
card (the forward with lse and both backward kernels). ``--checkpoint_every``
is parsed and, as in ``frn_tpu`` (whose ``build_config`` drops it), not
passed on: checkpoints are saved every ``TrainConfig.checkpoint_every`` (5)
epochs, at each new best mAP and at the end. ``--csv_test`` turns on the
periodic evaluation (mAP every ``--eval_every`` epochs, at f32 by default).
Under ``torchrun`` each process trains on its card, on its shard of every
batch of ``--batch_size`` (a multiple of the processes), and rank 0 alone
prints, evaluates and saves (``Trainer``); ``frn_tpu`` takes every device
without a launcher.
"""

from __future__ import annotations

import argparse

from frn_tpu_torch.cli.common import (
    add_dataset_args,
    add_model_args,
    build_config,
    build_csv_dataset,
    load_checkpoint_into_state,
    make_eval_fn,
    train_device,
)
from frn_tpu_torch.parallel.mesh import is_main


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the FRN detector on CSV labels (PyTorch port)")
    add_dataset_args(p, train=True)
    add_model_args(p)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--continue_training", action="store_true",
                   help="start from --checkpoint if given, else resume the latest checkpoint "
                   "of --checkpoint_dir")
    p.add_argument("--checkpoint", default=None,
                   help=".pt/.pth (a reference state dict: the weights) or a port checkpoint "
                   "directory (its latest epoch, optimizer included; frn_tpu takes an orbax "
                   "directory here) to load with --continue_training")
    p.add_argument("--checkpoint_dir", default="./checkpoints")
    p.add_argument("--checkpoint_every", type=int, default=5,
                   help="parsed and not passed on, as in frn_tpu: the trainer saves every "
                   "TrainConfig.checkpoint_every (5) epochs")
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps (recommended when training from scratch)")
    p.add_argument("--plateau_patience", type=int, default=3,
                   help="ReduceLROnPlateau patience in epochs (reference default 3)")
    p.add_argument("--augment", action="store_true",
                   help="random horizontal flip of both modalities + boxes "
                   "(the reference defines an Augmenter, dataloader.py:498-519, "
                   "but never wires it into a trainer; off by default to match)")
    return p


def main(argv=None) -> list:
    """Trains; returns the per-epoch mean loss history."""
    args = get_parser().parse_args(argv)
    with train_device(args) as device:
        return _train(args, device)


def _train(args, device) -> list:
    dataset = build_csv_dataset(args, args.csv_train)
    config = build_config(args, dataset.num_classes(), args.batch_size, args.epochs)

    test_dataset = build_csv_dataset(args, args.csv_test) if args.csv_test else None
    eval_fn = make_eval_fn(config, test_dataset) if test_dataset else None

    from frn_tpu_torch.train.trainer import Trainer

    transform = None
    if args.augment:
        from frn_tpu_torch.data.transforms import horizontal_flip

        # rng=None: a fresh OS-seeded generator per call, since the loader's
        # transforms run in threads and a shared numpy Generator is not
        # thread-safe (the reference Augmenter draws from np.random's state)
        transform = horizontal_flip

    trainer = Trainer(
        config, dataset,
        checkpoint_dir=args.checkpoint_dir,
        eval_fn=eval_fn,
        eval_every=args.eval_every,
        transform=transform,
        device=device,
    )
    if args.continue_training:
        if args.checkpoint:
            load_checkpoint_into_state(args, trainer.state)
        else:
            trainer.resume()

    history = trainer.fit(args.epochs)
    if is_main():
        print("final loss history:", [round(h, 4) for h in history[-5:]])
    return history


if __name__ == "__main__":
    main()
