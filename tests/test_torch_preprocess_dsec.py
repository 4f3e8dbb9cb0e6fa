"""The port's DSEC pre-voxelizer against ``tools/preprocess_dsec.py``.

Both tools run over the same raw DSEC fixture (one sequence of three frames
at 64x96, written by ``frn_tpu``'s fixture maker) with the same flags; they
must write the same file list, and every ``arr_0`` must be equal exactly.
The port's tool runs as a user runs it, ``python -m
frn_tpu_torch.tools.preprocess_dsec``.
"""

import dataclasses
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from frn_tpu.config import DSEC
from frn_tpu.data.synthetic import make_dsec_det_fixture

ROOT = Path(__file__).resolve().parents[1]


def _reference_main():
    spec = importlib.util.spec_from_file_location("_reference_preprocess_dsec",
                                                  ROOT / "tools" / "preprocess_dsec.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


@pytest.mark.parametrize("window_ms,num_bins", [(100, 5), (30, 3)])
def test_preprocess_dsec_writes_the_reference_tree(tmp_path, window_ms, num_bins):
    pytest.importorskip("h5py")
    raw = tmp_path / "raw"
    make_dsec_det_fixture(str(raw), num_sequences=1, frames_per_sequence=3,
                          geometry=dataclasses.replace(DSEC, height=64, width=96))
    flags = ["--dataset_root", str(raw), "--time_window_ms", str(window_ms),
             "--num_bins", str(num_bins), "--height", "64", "--width", "96"]
    _reference_main()(flags + ["--output", str(tmp_path / "want")])
    out = subprocess.run([sys.executable, "-m", "frn_tpu_torch.tools.preprocess_dsec", *flags,
                          "--output", str(tmp_path / "got")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    assert "wrote 3 voxel files" in out.stdout
    want = sorted(p.relative_to(tmp_path / "want") for p in (tmp_path / "want").rglob("*"))
    got = sorted(p.relative_to(tmp_path / "got") for p in (tmp_path / "got").rglob("*"))
    assert got == want and sum(p.suffix == ".npz" for p in got) == 3
    nonzero = 0
    for rel in want:
        if rel.suffix != ".npz":
            continue
        a, b = np.load(tmp_path / "want" / rel), np.load(tmp_path / "got" / rel)
        assert a.files == b.files == ["arr_0"]
        assert b["arr_0"].dtype == a["arr_0"].dtype and b["arr_0"].shape == (num_bins, 64, 96)
        np.testing.assert_array_equal(b["arr_0"], a["arr_0"], err_msg=str(rel))
        nonzero += int(np.abs(a["arr_0"]).sum() > 0)
    assert nonzero >= 2  # the windows hold events, so the arrays are not trivially equal
