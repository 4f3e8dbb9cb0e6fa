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
                 "frn_tpu_torch.cli.test_dsec_det", "frn_tpu_torch.serve",
                 "frn_tpu_torch.serve.engine", "frn_tpu_torch.serve.http",
                 "frn_tpu_torch.cli.serve", "frn_tpu_torch.cli.visualize",
                 "frn_tpu_torch.utils.visualization", "frn_tpu_torch.utils.profiling",
                 "frn_tpu_torch.utils.native", "frn_tpu_torch.data.augment",
                 "frn_tpu_torch.data.extra_datasets", "frn_tpu_torch.cli.convert_checkpoint",
                 "frn_tpu_torch.parallel", "frn_tpu_torch.parallel.mesh",
                 "frn_tpu_torch.parallel.launch", "frn_tpu_torch.tools.preprocess_dsec"):
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


# the host data layer, the image reader, the trainer's instruments and the
# flash benchmark run on the card's machine whether or not it has OpenCV,
# import nothing of the repo's tools/ (the JAX package's harnesses), and
# build from the port's own copy of the native sources
NO_OPENCV = ("frn_tpu_torch/data/augment.py", "frn_tpu_torch/data/extra_datasets.py",
             "frn_tpu_torch/data/loader.py", "frn_tpu_torch/utils/native.py",
             "frn_tpu_torch/utils/profiling.py", "frn_tpu_torch/train/trainer.py",
             "frn_tpu_torch/cli/convert_checkpoint.py", "frn_tpu_torch/data/image_io.py",
             "frn_tpu_torch/tools/bench_flash.py")


@pytest.mark.parametrize("relpath", NO_OPENCV)
def test_data_layer_needs_no_opencv_and_no_native_dir(relpath):
    source = (ROOT / relpath).read_text()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert all(n.split(".")[0] not in ("cv2", "tools", *FORBIDDEN) for n in names), relpath
    assert '"native"' not in source or relpath == "frn_tpu_torch/utils/native.py"


def test_native_library_builds_from_the_ports_source():
    from frn_tpu_torch.utils import native

    assert native.SOURCE == ROOT / "frn_tpu_torch" / "native" / "voxelize.cpp"
    assert native.JPEG_SOURCE == ROOT / "frn_tpu_torch" / "native" / "jpeg.cpp"
    assert native.BUILD_DIR == ROOT / "frn_tpu_torch" / "_build"
    assert native.jpeg_library_path().parent == native.BUILD_DIR
    assert native.jpeg_library_path().name.startswith("libfrn_jpeg-")
