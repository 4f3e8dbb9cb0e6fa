"""Alias of frn_tpu_torch.cli.train with DSEC defaults (reference train_dsec.py)."""
from frn_tpu_torch.cli.train import get_parser, main as _main  # noqa: F401 (get_parser re-export)

DEFAULTS = ["--dataset_name", "dsec"]


def main(argv=None):
    # defaults first: argparse is last-wins, so explicit user args override
    import sys

    user = list(argv) if argv is not None else sys.argv[1:]
    return _main(DEFAULTS + user)


if __name__ == "__main__":
    main()
