"""Alias of frn_tpu_torch.cli.train with DDD17 defaults (reference train_ddd17.py:
batch 4, 200 epochs, checkpoint every 10, which the trainer does not take: see
``cli/train.py``)."""
from frn_tpu_torch.cli.train import get_parser, main as _main  # noqa: F401 (get_parser re-export)

DEFAULTS = [
    "--dataset_name", "ddd17", "--batch_size", "4", "--epochs", "200",
    "--checkpoint_every", "10",
]


def main(argv=None):
    # defaults first: argparse is last-wins, so explicit user args override
    import sys

    user = list(argv) if argv is not None else sys.argv[1:]
    return _main(DEFAULTS + user)


if __name__ == "__main__":
    main()
