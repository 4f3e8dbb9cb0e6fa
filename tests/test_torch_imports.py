"""The port stands alone: it imports neither JAX, flax nor the JAX package.

One check at run time (a fresh interpreter imports every module of
``frn_tpu_torch`` and then looks at ``sys.modules``) and one in the source (an
AST scan of every import statement of the package and of ``chip_smoke.py``).
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "frn_tpu")
SOURCES = sorted((ROOT / "frn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, json, pkgutil, sys
import frn_tpu_torch
names = ["frn_tpu_torch"]
for info in pkgutil.walk_packages(frn_tpu_torch.__path__, "frn_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print(json.dumps({{"imported": names, "forbidden_loaded": bad}}))
"""


def _is_forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["forbidden_loaded"] == []
    for name in ("frn_tpu_torch.entry", "frn_tpu_torch.ops.flash_attention",
                 "frn_tpu_torch.core.nms", "frn_tpu_torch.models.detector", "frn_tpu_torch.convert",
                 "frn_tpu_torch.data.image_io", "frn_tpu_torch.data.transforms",
                 "frn_tpu_torch.data.csv_dataset", "frn_tpu_torch.data.synthetic",
                 "frn_tpu_torch.ops.voxelize", "frn_tpu_torch.ops.corruption",
                 "frn_tpu_torch.eval.ap", "frn_tpu_torch.eval.coco_protocol",
                 "frn_tpu_torch.eval.detections", "frn_tpu_torch.eval.evaluator",
                 "frn_tpu_torch.cli.common", "frn_tpu_torch.cli.test",
                 "frn_tpu_torch.cli.test_dsec", "frn_tpu_torch.cli.test_ddd17",
                 "frn_tpu_torch.cli.train", "frn_tpu_torch.cli.train_dsec",
                 "frn_tpu_torch.cli.train_ddd17", "frn_tpu_torch.train.trainer",
                 "frn_tpu_torch.data.loader", "frn_tpu_torch.data.events",
                 "frn_tpu_torch.data.dsec_det", "frn_tpu_torch.cli.train_dsec_det_fast",
                 "frn_tpu_torch.cli.test_dsec_det"):
        assert name in result["imported"]


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_has_no_forbidden_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_forbidden_prefix_is_exact():
    # frn_tpu_torch itself is allowed; frn_tpu and its submodules are not
    assert not _is_forbidden("frn_tpu_torch.ops")
    assert _is_forbidden("frn_tpu.config") and _is_forbidden("jax.numpy") and _is_forbidden("flax")
