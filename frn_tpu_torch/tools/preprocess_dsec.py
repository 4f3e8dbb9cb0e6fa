"""Pre-voxelize DSEC event streams to .npz files for the CSV datasets.

Counterpart of ``tools/preprocess_dsec.py``: the CSV pipeline's ``voxel``
event type reads one ``arr_0`` (C, H, W) npz a frame, and this writes them
from raw DSEC sequence directories at the frame timestamps, over a window
that ends at each frame (1 s by default), through the native scatter kernel
and the tanh normalization. It takes the same flags and writes the same tree,
``<output>/<sequence>/left/%06d.npz``:

    python -m frn_tpu_torch.tools.preprocess_dsec --dataset_root /data/DSEC \
        --output /data/events --time_window_ms 1000

Host code only: it needs no card.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from frn_tpu_torch.data.dsec_det import SequenceDirectory, _discover_sequences
from frn_tpu_torch.ops.voxelize import normalize_event_voxel_np, voxelize_events_np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--time_window_ms", type=int, default=1000)
    p.add_argument("--num_bins", type=int, default=5)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    args = p.parse_args(argv)

    total = 0
    for sp in _discover_sequences(Path(args.dataset_root)):
        seq = SequenceDirectory(sp)
        if not len(seq.timestamps):
            continue
        out_dir = os.path.join(args.output, seq.name, "left")
        os.makedirs(out_dir, exist_ok=True)
        for i, ts in enumerate(seq.timestamps):
            ev = seq.events.window(int(ts) - args.time_window_ms * 1000, int(ts))
            voxel = voxelize_events_np(
                ev["x"].astype(np.int64), ev["y"].astype(np.int64), ev["t"], ev["p"],
                num_bins=args.num_bins, height=args.height, width=args.width,
            )
            np.savez_compressed(os.path.join(out_dir, f"{i:06d}.npz"), normalize_event_voxel_np(voxel))
            total += 1
        print(f"{seq.name}: {len(seq.timestamps)} frames")
    print(f"wrote {total} voxel files to {args.output}")


if __name__ == "__main__":
    main()
