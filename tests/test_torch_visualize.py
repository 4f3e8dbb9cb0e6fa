"""The port's visualization helpers and visualize CLI against frn_tpu's.

The drawing helpers on seeded detections: the panels ``save_detection_panel``
writes are byte-equal PNG files (both draw with OpenCV). The CLI: both
packages' ``main`` on one ``make_csv_fixture`` set (DSEC 64x96) with one
seeded ``.pth`` (``test_torch_detector.seeded_variables``, reference names),
fusion depth 18, feature size 16, and the panels equal pixel for pixel (no
score lands near a rounding edge of its caption, no box edge near a pixel
edge). The JAX CLI runs with its default approximate candidate pool, which on
the CPU is the exact top-k, and its train-state initialization (a jitted init
with the optimizer, about 30 s here) is replaced by the variable tree's
shapes: its weights come from the ``.pth`` through its own loader.
"""

import builtins
import dataclasses

import cv2
import numpy as np
import pytest

import torch

from frn_tpu import config as jconfig
from frn_tpu.cli import visualize as jcli
from frn_tpu.models import detector as jdetector
from frn_tpu.utils import visualization as jviz
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import visualize as tcli
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.data.synthetic import make_csv_fixture
from frn_tpu_torch.utils import visualization as tviz
from test_torch_detector import seeded_variables

H, W = 64, 96


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def detections(seed, n=12):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, [W - 20, H - 20], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], 1).astype(np.float32)
    return boxes, rng.integers(0, 3, n).astype(np.int32), rng.uniform(0, 1, n).astype(np.float32)


def scene(seed):
    rng = np.random.default_rng(seed)
    rgb01 = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    voxel = rng.normal(0, 1, (H, W, 5)).astype(np.float32)
    return rgb01, voxel


@pytest.mark.parametrize("names, threshold", [(None, 0.5), (("person", "large_vehicle", "car"), 0.3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_save_detection_panel_is_byte_equal(tmp_path, seed, names, threshold):
    rgb01, voxel = scene(seed)
    boxes, labels, scores = detections(seed + 10)
    paths = [str(tmp_path / f"{pkg}" / "panel.png") for pkg in ("torch", "jax")]
    for viz, path in zip((tviz, jviz), paths):
        viz.save_detection_panel(path, rgb01, voxel, boxes, labels, scores, class_names=names,
                                 score_threshold=threshold)
    with open(paths[0], "rb") as got, open(paths[1], "rb") as want:
        assert got.read() == want.read()


def test_event_views_match_jax():
    rgb01, voxel = scene(3)
    np.testing.assert_array_equal(tviz.events_to_image(voxel), jviz.events_to_image(voxel))
    rng = np.random.default_rng(4)
    img = (rgb01 * 255).astype(np.uint8)
    x, y, p = rng.integers(0, W, 200), rng.integers(0, H, 200), rng.integers(0, 2, 200)
    np.testing.assert_array_equal(tviz.draw_events_on_image(img, x, y, p),
                                  jviz.draw_events_on_image(img, x, y, p))
    boxes, labels, scores = detections(5)
    np.testing.assert_array_equal(tviz.draw_detections(img.copy(), boxes, labels),
                                  jviz.draw_detections(img.copy(), boxes, labels))


def test_drawing_without_opencv_raises(monkeypatch):
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    rgb01, voxel = scene(6)
    np.testing.assert_array_equal(tviz.events_to_image(voxel), jviz.events_to_image(voxel))
    with pytest.raises(RuntimeError, match="cv2 required"):
        tviz.draw_detections((rgb01 * 255).astype(np.uint8), *detections(7))


def test_visualize_parser_matches_jax():
    argv = ["--csv_classes", "c.csv", "--root_img", "i", "--root_event", "e", "--checkpoint", "m.pth"]
    got = vars(tcli.get_parser().parse_args(argv))
    assert got.pop("device") is None
    assert got == vars(jcli.get_parser().parse_args(argv))


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("visualize")
    geo = dataclasses.replace(jconfig.DSEC, height=H, width=W)
    cfg = jconfig.FrameworkConfig(geometry=geo, model=jconfig.ModelConfig(
        variant="fusion", depth=18, feature_size=16, num_classes=3))
    state = state_dict_from_jax(seeded_variables(jdetector.FRNDetector(cfg), geo, seed=1))
    pth = str(root / "model.pth")
    torch.save({"model_state_dict": {"module." + k: v for k, v in state.items()}}, pth)
    fix = make_csv_fixture(str(root / "fix"), num_images=4, seed=2,
                           geometry=dataclasses.replace(tconfig.DSEC, height=H, width=W))
    argv = ["--csv_test", fix["annotations_csv"], "--csv_classes", fix["class_map_csv"],
            "--root_img", fix["img_dir"], "--root_event", fix["event_dir"],
            "--image_height", str(H), "--image_width", str(W), "--depth", "18",
            "--feature_size", "16", "--checkpoint", pth, "--score_threshold", "0.3",
            "--max_images", "3"]
    return root, argv


class _TemplateState:
    """What ``frn_tpu.cli.common.load_checkpoint_into_state`` needs of a train
    state: the variable tree and ``replace``."""

    def __init__(self, params, batch_stats):
        self.params, self.batch_stats = params, batch_stats

    def replace(self, **kw):
        return _TemplateState(**{**vars(self), **kw})


def test_visualize_cli_matches_jax(cli_inputs, capsys, monkeypatch):
    from frn_tpu.train import loop as jloop

    def template_state(config, key, batch_size):
        model = jdetector.FRNDetector(config)
        tree = seeded_variables(model, config.geometry, seed=0)
        return model, _TemplateState(tree["params"], tree["batch_stats"]), None

    monkeypatch.setattr(jloop, "create_train_state", template_state)
    root, argv = cli_inputs
    tcli.main(argv + ["--output_dir", str(root / "torch"), "--device", "cpu"])
    jcli.main(argv + ["--output_dir", str(root / "jax")])
    out = capsys.readouterr().out
    assert f"wrote 3 panels to {root / 'torch'}" in out and f"wrote 3 panels to {root / 'jax'}" in out
    colors = 0
    for i in range(3):
        got = cv2.imread(str(root / "torch" / f"{i:06d}.png"))
        want = cv2.imread(str(root / "jax" / f"{i:06d}.png"))
        assert got.shape == want.shape == (H, 2 * W, 3)
        np.testing.assert_array_equal(got, want)
        colors = max(colors, len(np.unique(got[:, W:].reshape(-1, 3), axis=0)))
    assert colors > 3  # boxes drawn over the event view's white, blue and red


def test_visualize_cli_needs_csv_test(cli_inputs):
    _, argv = cli_inputs
    argv = argv[2:]  # no --csv_test
    with pytest.raises(SystemExit, match="--csv_test is required"):
        tcli.main(argv + ["--device", "cpu"])
