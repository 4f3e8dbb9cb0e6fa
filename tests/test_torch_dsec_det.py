"""The port's raw DSEC-Det path against frn_tpu's, on the CPU: the fixture
writer, the h5 event reader, the dataset on every wire and representation,
the collate's events branch, the wires' device-side normalization, the
``--debug_data`` output of ``train_dsec_det_fast``, and both DSEC-Det CLIs
against the port's parts (``test_torch_dsec_det_train.py`` holds the
train step, ``test_torch_dsec_det_eval.py`` the evaluation CLI, against
frn_tpu's).

Geometry: DSEC-Det at 96x128 (the JAX tests' tiny geometry), a fixture of
2 sequences of 6 frames (10 samples). The CLIs take the DSEC-Det geometry
as a constant; the tests swap it for the tiny one (``monkeypatch``).

Tolerances: the fixture, the reader, the datasets, the collate and the
``--debug_data`` lines exactly. The device-side normalization of the
compact and events wires against the f32 wire's host normalization: RGB
exactly (the same f32 division and standardization), the voxel within 4 f32
ulps (atol 0, rtol 5e-7: torch's tanh against numpy's). The train CLI:
frn_tpu's compiles two programs at this size, which takes longer than a
test file may, so the port's CLI is held against the port's parts: its loss
history equals a ``Trainer`` of the recipe built by hand, bit for bit (the
same computation), and the three wires' histories agree within rtol 1e-5.
"""

import contextlib
import dataclasses
import functools
import io
import shutil
import sys
import threading

import numpy as np
import pytest

import torch

import frn_tpu.config as jconfig
import frn_tpu.data.dsec_det as jdsec
from frn_tpu.cli import train_dsec_det_fast as jtrain_cli
from frn_tpu.data import events as jevents
from frn_tpu.data.collate import collate_fixed as jcollate
from frn_tpu.data.synthetic import make_dsec_det_fixture as jmake_fixture
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import test_dsec_det as ttest_cli
from frn_tpu_torch.cli import train_dsec_det_fast as ttrain_cli
from frn_tpu_torch.data import dsec_det as tdsec
from frn_tpu_torch.data import events as tevents
from frn_tpu_torch.data import image_io
from frn_tpu_torch.data.collate import collate_fixed as tcollate
from frn_tpu_torch.data.loader import to_device
from frn_tpu_torch.data.synthetic import make_dsec_det_fixture as tmake_fixture
from frn_tpu_torch.train.loop import make_batch_inputs
from frn_tpu_torch.train.trainer import Trainer

H, W = 96, 128
JTINY = dataclasses.replace(jconfig.DSEC_DET, height=H, width=W)
TTINY = dataclasses.replace(tconfig.DSEC_DET, height=H, width=W)
SPLITS = {"train": ["synthetic_00"], "val": ["synthetic_01"]}
TANH_RTOL = 5e-7  # 4 f32 ulps


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """frn_tpu's fixture and the port's, from one seed; a copy of the port's
    with one object missing from one frame's tracks (an imperfect pair)."""
    base = tmp_path_factory.mktemp("dsec_det_port")
    jroot = jmake_fixture(str(base / "jax"), num_sequences=2, frames_per_sequence=6,
                          geometry=JTINY)
    troot = tmake_fixture(str(base / "port"), num_sequences=2, frames_per_sequence=6,
                          geometry=TTINY)
    broken = shutil.copytree(troot, base / "broken")
    tracks_path = broken / "synthetic_00/object_detections/left/tracks.npy"
    tracks = np.load(tracks_path)
    ts = np.unique(tracks["t"])[2]
    np.save(tracks_path, tracks[~((tracks["t"] == ts) & (tracks["track_id"] == 1))])
    return {"jax": jroot, "port": troot, "broken": str(broken), "base": base}


def _files(root):
    from pathlib import Path

    return sorted(p.relative_to(root) for p in Path(root).rglob("*") if p.is_file())


def test_fixture_equals_jax_file_by_file(roots):
    import cv2
    import h5py

    from pathlib import Path

    jroot, troot = Path(roots["jax"]), Path(roots["port"])
    files = _files(jroot)
    assert files == _files(troot) and len(files) == 2 * (6 + 3)
    for rel in files:
        a, b = jroot / rel, troot / rel
        if rel.suffix == ".png":
            np.testing.assert_array_equal(image_io.imread(str(b)), cv2.imread(str(a)))
        elif rel.suffix == ".h5":
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                for key in ("events/x", "events/y", "events/t", "events/p", "t_offset",
                            "ms_to_idx"):
                    assert fa[key].dtype == fb[key].dtype, key
                    np.testing.assert_array_equal(fb[key][()], fa[key][()])
        elif rel.suffix == ".npy":
            ja, tb = np.load(a), np.load(b)
            assert ja.dtype == tb.dtype
            np.testing.assert_array_equal(tb, ja)
        else:
            assert b.read_bytes() == a.read_bytes(), rel


def test_h5_reader_equals_jax(roots):
    path = f"{roots['port']}/synthetic_00/events/left/events_2x.h5"
    got, want = tevents.H5EventReader(path), jevents.H5EventReader(path)
    assert got.t_offset == want.t_offset
    for t0, t1 in ((9_900_000, 10_000_000), (9_000_000, 10_500_000), (10_012_345, 10_250_999),
                   (10_300_000, 10_200_000), (0, 1), (11_000_000, 12_000_000)):
        a, b = got.window(t0, t1), want.window(t0, t1)
        assert list(a) == list(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    # one file handle per thread
    handles = []
    th = threading.Thread(target=lambda: handles.append(got.file))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive() and handles and handles[0] is not got.file
    got.close()
    want.close()


def test_event_io_raises_only_when_built_without_h5py(tmp_path, monkeypatch):
    monkeypatch.setattr(tevents, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tevents.H5EventReader(str(tmp_path / "e.h5"))
    x = np.zeros(3, np.uint16)
    with pytest.raises(ImportError, match="h5py"):
        tevents.write_event_h5(str(tmp_path / "e.h5"), x, x, x.astype(np.int64), x)


def test_class_mapping_and_track_helpers_equal_jax(roots):
    remap = tdsec.compute_class_mapping(("car", "pedestrian"), tdsec.SOURCE_CLASSES,
                                        tdsec.CLASS_MAPPING)
    np.testing.assert_array_equal(remap, jdsec.compute_class_mapping(
        ("car", "pedestrian"), jdsec.SOURCE_CLASSES, jdsec.CLASS_MAPPING))
    tracks = np.load(f"{roots['port']}/synthetic_00/object_detections/left/tracks.npy")
    tracks["x"][0], tracks["w"][1] = -5.0, 400.0  # to crop
    for t in (tracks, tracks[:0]):
        np.testing.assert_array_equal(tdsec.crop_tracks_xywh(t, W, H),
                                      jdsec.crop_tracks_xywh(t, W, H))
    np.testing.assert_array_equal(tdsec.filter_small_boxes(tracks["w"], tracks["h"], 20, 30),
                                  jdsec.filter_small_boxes(tracks["w"], tracks["h"], 20, 30))
    det0, det1 = tracks[tracks["t"] == tracks["t"][0]], tracks[tracks["t"] == tracks["t"][-1]]
    for a, b in ((det0, det1), (det0[:1], det1), (det0[:0], det1)):
        np.testing.assert_array_equal(tdsec.interpolate_tracks(a, b, 10_030_000),
                                      jdsec.interpolate_tracks(a, b, 10_030_000))


# (name, root, constructor keywords): every wire, every representation, the
# split, size, perfect-track, num_us and standardization paths
DATASETS = {
    "f32": ("port", {}),
    "f32_window": ("port", {"time_window_us": 100_000}),
    "time_surface": ("port", {"event_representation": "time_surface"}),
    "event_count": ("port", {"event_representation": "event_count", "time_window_us": 150_000}),
    "binary": ("port", {"event_representation": "binary"}),
    "normalize_rgb": ("port", {"normalize_rgb": True}),
    "compact": ("port", {"compact_wire": True}),
    "events": ("port", {"events_wire": True, "event_capacity": 20_000}),
    "events_cut_at_half_a_window": ("port", {"events_wire": True, "event_capacity": 1_500}),
    "num_us": ("port", {"num_us": 40_000, "time_window_us": 50_000}),
    "split_config_val": ("port", {"split": "val", "split_config": SPLITS}),
    "min_size": ("port", {"min_bbox_height": 15.0, "min_bbox_diag": 30.0}),  # drops the pedestrians
    "only_perfect_tracks": ("broken", {"only_perfect_tracks": True}),
    "imperfect_tracks_kept": ("broken", {}),
}


def _assert_samples_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray) or isinstance(w, np.generic):
            assert np.asarray(g).dtype == np.asarray(w).dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert type(g) is type(w) and g == w, key


def _datasets(roots, name, **more):
    root, kw = DATASETS[name]
    kw = {**kw, **more}
    return (tdsec.DSECDetDataset(roots[root], geometry=TTINY, **kw),
            jdsec.DSECDetDataset(roots[root], geometry=JTINY, **kw))


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_samples_equal_jax(roots, name):
    got, want = _datasets(roots, name)
    assert len(got) == len(want) > 0
    assert [s.name for s in got.sequences] == [s.name for s in want.sequences]
    assert got._index == want._index
    for i in range(len(want)):
        _assert_samples_equal(got[i], want[i])
        np.testing.assert_array_equal(got.load_annotations(i), want.load_annotations(i))
    if name == "events_cut_at_half_a_window":
        full = tdsec.DSECDetDataset(roots["port"], geometry=TTINY, events_wire=True)
        n_full = int(full[0]["event_n"])
        assert n_full == 3_000 and int(got[0]["event_n"]) == 1_500
        np.testing.assert_array_equal(got[0]["event_x"], full[0]["event_x"][:1_500])
    if name == "only_perfect_tracks":
        assert len(got) < len(tdsec.DSECDetDataset(roots["broken"], geometry=TTINY))


def test_split_yaml_equals_jax(roots, tmp_path):
    import yaml

    path = tmp_path / "split.yaml"
    path.write_text(yaml.safe_dump(SPLITS))
    for split in ("train", "val", "test"):
        got = tdsec.DSECDetDataset(roots["port"], split=split, split_yaml=str(path), geometry=TTINY)
        want = jdsec.DSECDetDataset(roots["port"], split=split, split_yaml=str(path),
                                    geometry=JTINY)
        assert [s.name for s in got.sequences] == [s.name for s in want.sequences]
        assert got._index == want._index
    assert [s.name for s in got.sequences] == ["synthetic_00", "synthetic_01"]  # no 'test' key


def test_off_geometry_and_missing_images_equal_jax(roots, tmp_path):
    """An image off the geometry is resized (OpenCV, INTER_CUBIC); a missing
    one reads as zeros, as frn_tpu's does."""
    root = shutil.copytree(roots["port"], tmp_path / "fix")
    small_t = dataclasses.replace(TTINY, height=80, width=112)
    small_j = dataclasses.replace(JTINY, height=80, width=112)
    got = tdsec.DSECDetDataset(str(root), geometry=small_t, compact_wire=True)
    want = jdsec.DSECDetDataset(str(root), geometry=small_j, compact_wire=True)
    (root / "synthetic_00/images/left/rectified/000001.png").unlink()
    for i in (0, 1):
        _assert_samples_equal(got[i], want[i])
    assert got[1]["rgb"].shape == (80, 112, 3) and not got[1]["rgb"].any()


def test_helpers_name_the_package_they_need(roots, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        tdsec.DSECDetDataset(roots["port"], split_yaml=str(tmp_path / "s.yaml"), geometry=TTINY)
    monkeypatch.setitem(sys.modules, "cv2", None)
    ds = tdsec.DSECDetDataset(roots["port"], geometry=dataclasses.replace(TTINY, height=80))
    with pytest.raises(ImportError, match="OpenCV"):
        ds[0]


def test_wire_combinations_raise_as_jax(roots):
    for kw, match in (({"compact_wire": True, "events_wire": True}, "exclusive"),
                      ({"events_wire": True, "event_representation": "time_surface"}, "voxel"),
                      ({"compact_wire": True, "event_representation": "binary"}, "voxel")):
        for cls, geo in ((tdsec.DSECDetDataset, TTINY), (jdsec.DSECDetDataset, JTINY)):
            with pytest.raises(ValueError, match=match):
                cls(roots["port"], geometry=geo, **kw)


def test_collate_events_branch_equals_jax(roots):
    got_ds, _ = _datasets(roots, "events")
    samples = [got_ds[0], got_ds[3], got_ds[7]]
    got = tcollate(samples, TTINY, max_annots=8, batch_size=4)
    want = jcollate(samples, JTINY, max_annots=8, batch_size=4)
    _assert_samples_equal(got, want)
    assert "event" not in got and got["event_x"].shape == (4, 20_000)
    assert got["event_n"].tolist()[3] == 0 and got["sample_mask"].tolist() == [True] * 3 + [False]


def _train_config(wire: str, standardize: bool = False):
    return tconfig.FrameworkConfig(geometry=TTINY, train=tconfig.TrainConfig(
        input_wire=wire, input_rgb_standardize=standardize))


@pytest.mark.parametrize("wire", ["compact", "events"])
@pytest.mark.parametrize("standardize", [False, True])
def test_device_normalization_equals_the_f32_wire(roots, wire, standardize):
    """``make_batch_inputs`` of a compact or events batch against the f32
    wire's host-normalized batch of the same samples; the events wire's
    count grid also exactly against the compact wire's int8 counts."""
    kw = {"time_window_us": 200_000}
    f32 = tdsec.DSECDetDataset(roots["port"], geometry=TTINY, normalize_rgb=standardize, **kw)
    ds = tdsec.DSECDetDataset(roots["port"], geometry=TTINY, normalize_rgb=standardize,
                              compact_wire=wire == "compact", events_wire=wire == "events", **kw)
    idx = [0, 4, 9]
    batch = to_device(tcollate([ds[i] for i in idx], TTINY, 8, 4), "cpu")
    want = tcollate([f32[i] for i in idx], TTINY, 8, 4)
    rgb, event = make_batch_inputs(_train_config(wire, standardize))(batch)
    assert rgb.dtype == event.dtype == torch.float32
    # the pad row (index 3) is zeros on the wire, which standardization moves
    np.testing.assert_array_equal(rgb.numpy()[:3], want["rgb"][:3])
    np.testing.assert_allclose(event.numpy(), want["event"], atol=0, rtol=TANH_RTOL)
    assert np.abs(want["event"][:3]).max() > 0.5  # squashed samples are there
    if wire == "events":
        from frn_tpu_torch.ops.voxelize import voxelize_events_batched

        counts = voxelize_events_batched(batch["event_x"], batch["event_y"], batch["event_t"],
                                         batch["event_p"], batch["event_n"], 5, H, W)
        compact = tdsec.DSECDetDataset(roots["port"], geometry=TTINY, compact_wire=True, **kw)
        want_counts = tcollate([compact[i] for i in idx], TTINY, 8, 4)["event"]
        np.testing.assert_array_equal(counts.numpy(), want_counts.astype(np.float32))


def test_to_device_keeps_the_wire_dtypes(roots):
    ds, _ = _datasets(roots, "events")
    batch = to_device(tcollate([ds[0]], TTINY, 8, 2), "cpu")
    keys = ("event_x", "event_y", "event_t", "event_p", "event_n", "rgb")
    assert [batch[k].dtype for k in keys] == [torch.int16, torch.int16, torch.int32, torch.int8,
                                               torch.int32, torch.uint8]


@contextlib.contextmanager
def _tiny_clis(monkeypatch):
    """Both packages' DSEC-Det CLIs at the tiny geometry."""
    monkeypatch.setattr(jconfig, "DSEC_DET", JTINY)
    monkeypatch.setattr(jdsec, "DSECDetDataset",
                        functools.partial(jdsec.DSECDetDataset, geometry=JTINY))
    monkeypatch.setattr(ttrain_cli, "DSEC_DET", TTINY)
    monkeypatch.setattr(ttest_cli, "DSEC_DET", TTINY)
    yield


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


@pytest.mark.parametrize("wire", ["f32", "compact", "events"])
def test_debug_data_lines_equal_jax(roots, monkeypatch, wire):
    with _tiny_clis(monkeypatch):
        argv = ["--dataset_root", roots["port"], "--debug_data", "--batch_size", "3",
                "--wire", wire, "--time_window_us", "250000"]
        _, want = _printed(jtrain_cli.main, argv)
        rc, got = _printed(ttrain_cli.main, argv + ["--device", "cpu"])
    assert rc == 0 and got == want and len(got.splitlines()) == 4


@pytest.fixture(scope="module")
def cli_runs(roots, tmp_path_factory):
    """The port's train CLI at the tiny geometry, one epoch on each wire over
    the 'train' split of a split file (one sequence, 5 samples: 2 micro-steps
    of batch 2), depth 18, feature size 32; a Trainer of the recipe built by
    hand; and the events run continued for a second epoch."""
    out = tmp_path_factory.mktemp("train_cli")
    split = out / "split.yaml"
    split.write_text("train: [synthetic_00]\nval: [synthetic_01]\n")
    flags = ["--dataset_root", roots["port"], "--split_yaml", str(split), "--batch_size", "2",
             "--depth", "18", "--feature_size", "32", "--device", "cpu"]

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            return ttrain_cli.main(flags + list(argv)), buf.getvalue()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain_cli, "DSEC_DET", TTINY)
        runs = {wire: run("--epochs", "1", "--wire", wire, "--checkpoint_dir", str(out / wire))
                for wire in ("f32", "compact", "events")}
        resumed = run("--epochs", "2", "--wire", "events", "--checkpoint_dir", str(out / "events"),
                      "--continue_training")
    config = tconfig.FrameworkConfig(
        geometry=TTINY,
        model=tconfig.ModelConfig(variant="fusion", depth=18, num_classes=2, feature_size=32),
        train=tconfig.TrainConfig(batch_size=2, learning_rate=5e-5, grad_clip_norm=1.0,
                                  accum_steps=1, epochs=1, plateau_factor=0.5,
                                  loss_skip_threshold=50.0))
    ds = tdsec.DSECDetDataset(roots["port"], split="train",
                              split_config={"train": ["synthetic_00"]}, geometry=TTINY)
    with contextlib.redirect_stdout(io.StringIO()):
        by_hand = Trainer(config, ds, device="cpu").fit(1)
    return {"runs": runs, "by_hand": by_hand, "resumed": resumed, "dir": out}


def test_train_cli_equals_the_recipe_by_hand(cli_runs):
    history, printed = cli_runs["runs"]["f32"]
    assert len(history) == 1 and np.isfinite(history[0])
    assert history == cli_runs["by_hand"]
    assert "epoch 1/1: loss" in printed and "lr 5.00e-05" in printed
    assert (cli_runs["dir"] / "f32" / "checkpoint_1.pt").is_file()


def test_train_cli_wires_agree(cli_runs):
    want = cli_runs["runs"]["f32"][0]
    for wire in ("compact", "events"):
        np.testing.assert_allclose(cli_runs["runs"][wire][0], want, rtol=1e-5)


def test_train_cli_continues_from_its_directory(cli_runs):
    history, printed = cli_runs["resumed"]
    assert len(history) == 2 and history[0] == cli_runs["runs"]["events"][0][0]
    assert "epoch 2/2" in printed and "epoch 1/2" not in printed
    assert (cli_runs["dir"] / "events" / "checkpoint_2.pt").is_file()


def test_eval_cli_takes_the_trainer_directory(roots, cli_runs, monkeypatch):
    monkeypatch.setattr(ttest_cli, "DSEC_DET",
                        dataclasses.replace(tconfig.DSEC_DET, height=H, width=W))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m_ap = ttest_cli.main(["--dataset_root", roots["port"], "--checkpoint",
                               str(cli_runs["dir"] / "events"), "--depth", "18", "--feature_size",
                               "32", "--device", "cpu", "--batch_size", "4"])
    printed = buf.getvalue()
    assert 0.0 <= m_ap <= 1.0 and "fps" in printed and '"mAP"' in printed
