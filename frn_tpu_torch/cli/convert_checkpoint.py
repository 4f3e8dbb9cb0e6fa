"""Convert a reference PyTorch checkpoint into a checkpoint directory of the port
(counterpart of ``frn_tpu/cli/convert_checkpoint.py``, which writes orbax).

  python -m frn_tpu_torch.cli.convert_checkpoint --torch_checkpoint best.pt \\
      --output ./ckpt_converted --dataset_name dsec --fusion fpn_fusion

The state dict fills every weight of a fresh train state (a missing key or a
shape mismatch raises; unused keys are warned about), which is saved as
epoch 0 by ``train/checkpoint.CheckpointManager`` with the metadata
{"source": <the .pt path>}. ``cli.test --checkpoint <dir>`` and ``cli.train
--continue_training --checkpoint <dir>`` read the directory.
"""

from __future__ import annotations

import argparse

from frn_tpu_torch.cli.common import FUSION_TO_VARIANT
from frn_tpu_torch.config import FrameworkConfig, ModelConfig, geometry_for


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch_checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--dataset_name", default="dsec", choices=["dsec", "ddd17", "dsec_det"])
    p.add_argument("--fusion", default="fpn_fusion", choices=list(FUSION_TO_VARIANT))
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--device", default=None,
                   help="torch device of the train state; default the CUDA card, 'cpu' on request")
    args = p.parse_args(argv)

    from frn_tpu_torch.convert import load_reference_checkpoint
    from frn_tpu_torch.device import resolve_device
    from frn_tpu_torch.train.checkpoint import CheckpointManager
    from frn_tpu_torch.train.loop import create_train_state

    geo = geometry_for(args.dataset_name)
    config = FrameworkConfig(
        geometry=geo,
        model=ModelConfig(
            variant=FUSION_TO_VARIANT[args.fusion], depth=args.depth,
            num_classes=geo.num_classes,
        ),
    )
    state = create_train_state(config, seed=0, device=resolve_device(args.device))

    sd = load_reference_checkpoint(args.torch_checkpoint)
    targets = state.model.state_dict()
    missing = [k for k in targets if k not in sd]
    if missing:
        raise KeyError(f"torch checkpoint missing {len(missing)} keys, e.g. {missing[:5]}")
    unused = [k for k in sd if k not in targets]
    if unused:
        print(f"warning: {len(unused)} unused torch keys, e.g. {unused[:5]}")
    state.model.load_state_dict({k: sd[k] for k in targets}, strict=True)

    CheckpointManager(args.output).save(epoch=0, state=state,
                                        meta={"source": args.torch_checkpoint})
    print(f"wrote checkpoint to {args.output}")


if __name__ == "__main__":
    main()
