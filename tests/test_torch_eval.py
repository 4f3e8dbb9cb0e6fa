"""The port's host-side evaluation modules against frn_tpu's, bit for bit.

On seeded numpy data: the AP and COCO-protocol evaluators, the 15
corruptions at severities 1 and 5, the PNG reader and writer against OpenCV,
the CSV dataset and the synthetic fixture, the transforms, the host
voxelizer and the voxel normalization. Everything is compared for exact
equality except the torch voxel normalizations, whose tanh is torch's where
the JAX one is XLA's: those agree within 4 f32 ulps (atol 0, rtol 5e-7).
"""

import dataclasses
import os

import numpy as np
import pytest

import cv2
import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.data import csv_dataset as jcsv
from frn_tpu.data import synthetic as jsynthetic
from frn_tpu.data import transforms as jtransforms
from frn_tpu.eval import ap as jap
from frn_tpu.eval import coco_protocol as jcoco
from frn_tpu.ops import corruption as jcorruption
from frn_tpu.ops import voxelize as jvoxelize
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.data import csv_dataset as tcsv
from frn_tpu_torch.data import image_io
from frn_tpu_torch.data import synthetic as tsynthetic
from frn_tpu_torch.data import transforms as ttransforms
from frn_tpu_torch.eval import ap as tap
from frn_tpu_torch.eval import coco_protocol as tcoco
from frn_tpu_torch.ops import corruption as tcorruption
from frn_tpu_torch.ops import voxelize as tvoxelize

TINY_DSEC = (dataclasses.replace(jconfig.DSEC, height=48, width=80),
             dataclasses.replace(tconfig.DSEC, height=48, width=80))
TINY_DDD17 = (dataclasses.replace(jconfig.DDD17, height=52, width=70),
              dataclasses.replace(tconfig.DDD17, height=52, width=70))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_detections(seed, num_images=7, num_classes=3, with_empty=True):
    """Seeded per-image, per-class detections (score-sorted, as the device
    top-k emits them) and annotations, boxes that overlap often."""
    rng = np.random.default_rng(seed)
    dets, annots = [], []
    for i in range(num_images):
        d_img, a_img = [], []
        for c in range(num_classes):
            m = 0 if with_empty and (i + c) % 5 == 0 else int(rng.integers(1, 5))
            gt = rng.uniform(0, 60, (m, 2))
            gt = np.concatenate([gt, gt + rng.uniform(8, 40, (m, 2))], 1)
            n = int(rng.integers(0, 9))
            base = gt[rng.integers(0, m, n)] if m else rng.uniform(0, 80, (n, 4))
            boxes = base + rng.normal(0, 4, (n, 4))
            boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
            scores = np.sort(rng.uniform(0.05, 1, n))[::-1]
            d_img.append(np.concatenate([boxes, scores[:, None]], 1).astype(np.float32))
            a_img.append(gt.astype(np.float32))
        dets.append(d_img)
        annots.append(a_img)
    return dets, annots


# ------------------------------------------------------------ ap.py


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_average_precisions_match_jax(seed):
    dets, annots = random_detections(seed)
    taus = [0.3, 0.5, 0.75]
    assert tap.average_precisions(dets, annots, 3, taus) == jap.average_precisions(
        dets, annots, 3, taus)
    want = jap.evaluate_coco_map(dets, annots, 3)
    assert tap.evaluate_coco_map(dets, annots, 3) == want
    names = ["person", "large_vehicle", "car"]
    assert tap.summarize_coco(want, names) == jap.summarize_coco(want, names)
    assert tap.evaluate_voc(dets, annots, 3) == jap.evaluate_voc(dets, annots, 3)
    for label in range(3):
        for got, ref in zip(tap.precision_recall_curve(dets, annots, label),
                            jap.precision_recall_curve(dets, annots, label)):
            np.testing.assert_array_equal(got, ref)


def test_compute_ap_and_overlap_match_jax():
    rng = np.random.default_rng(3)
    recall = np.sort(rng.uniform(0, 1, 20))
    precision = rng.uniform(0, 1, 20)
    assert tap.compute_ap(recall, precision) == jap.compute_ap(recall, precision)
    a = rng.uniform(0, 50, (6, 4)); a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 50, (5, 4)); b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(tap.compute_overlap(a, b), jap.compute_overlap(a, b))


def test_detection_pickles_keep_the_jax_layout(tmp_path):
    dets, annots = random_detections(4)
    tap.save_detections(str(tmp_path / "t"), dets, annots)
    jap.save_detections(str(tmp_path / "j"), dets, annots)
    for name in ("detections.txt", "annotations.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    for got in (jap.load_detections(str(tmp_path / "t")), tap.load_detections(str(tmp_path / "j"))):
        for g, w in zip(got, (dets, annots)):
            assert len(g) == len(w) and all(
                x.dtype == y.dtype and np.array_equal(x, y)
                for gi, wi in zip(g, w) for x, y in zip(gi, wi))


def test_plot_pr_curves_names_match_jax(tmp_path):
    dets, annots = random_detections(5)
    names = ["person", "large_vehicle", "car"].__getitem__
    got = tap.plot_pr_curves(dets, annots, 3, str(tmp_path / "t"), names)
    want = jap.plot_pr_curves(dets, annots, 3, str(tmp_path / "j"), names)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert all(os.path.getsize(p) > 0 for p in got)


# ------------------------------------------------------------ coco_protocol.py


@pytest.mark.parametrize("seed", [6, 7])
def test_coco_protocol_matches_jax(seed):
    dets, annots = random_detections(seed, num_images=5)
    rng = np.random.default_rng(seed)
    crowd = [[rng.random(len(a)) < 0.2 for a in img] for img in annots]
    for kw in ({}, {"crowd": crowd}):
        got = tcoco.evaluate_coco_protocol(dets, annots, num_classes=3, **kw)
        want = jcoco.evaluate_coco_protocol(dets, annots, num_classes=3, **kw)
        np.testing.assert_array_equal(got.precision, want.precision)
        np.testing.assert_array_equal(got.recall, want.recall)
        assert got.stats == want.stats
        assert got.summary_lines() == want.summary_lines()


# ------------------------------------------------------------ corruption.py


def _scene(seed=8, h=40, w=56):
    """A float32 [0, 1] HWC image with flat boxes on noise, as the fixture draws."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 0.2, (h, w, 3))
    img[5:20, 8:30] = rng.uniform(0.5, 1, 3)
    img[22:37, 30:50] = rng.uniform(0.5, 1, 3)
    return img.astype(np.float32)


@pytest.mark.parametrize("severity", [1, 5])
@pytest.mark.parametrize("name", jcorruption.ALL_CORRUPTIONS)
def test_corruption_matches_jax(name, severity):
    img = _scene()
    got = tcorruption.corrupt(img, name, severity)
    want = jcorruption.corrupt(img, name, severity)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_corruption_tables_and_cv2_free_list():
    assert tcorruption.CORRUPTION_GROUPS == jcorruption.CORRUPTION_GROUPS
    assert tcorruption.SEVERITIES == jcorruption.SEVERITIES
    assert set(tcorruption.CV2_FREE_CORRUPTIONS) | {
        "defocus_blur", "motion_blur", "zoom_blur", "fog", "snow", "frost", "pixelate",
        "jpeg_compression"} == set(tcorruption.ALL_CORRUPTIONS)
    with pytest.raises(ValueError, match="Unknown corruption"):
        tcorruption.corrupt(_scene(), "rain", 1)
    with pytest.raises(ValueError, match="severity"):
        tcorruption.corrupt(_scene(), "fog", 6)


def test_corruptions_without_cv2(monkeypatch):
    # the seven numpy/scipy corruptions run with cv2 unimportable; the other
    # eight raise, naming it
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    img = _scene()
    for name in tcorruption.ALL_CORRUPTIONS:
        if name in tcorruption.CV2_FREE_CORRUPTIONS:
            np.testing.assert_array_equal(tcorruption.corrupt(img, name, 3),
                                          jcorruption.corrupt(img, name, 3))
        else:
            with pytest.raises(RuntimeError, match="OpenCV"):
                tcorruption.corrupt(img, name, 3)


# ------------------------------------------------------------ image_io.py

CV2_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP, "avg": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "all": cv2.IMWRITE_PNG_ALL_FILTERS}
IMAGE_SHAPES = {"gray": (23, 37), "bgr": (31, 45, 3), "bgra": (19, 26, 4)}


def _image(kind, seed=9):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, IMAGE_SHAPES[kind], dtype=np.uint8)
    if img.ndim == 3:
        img[:4] = img[:4, :, :1]  # gray pixels in a color image
    img[-5:] = 7  # a flat band
    return img


@pytest.mark.parametrize("kind", list(IMAGE_SHAPES))
@pytest.mark.parametrize("cv2_filter", list(CV2_FILTERS))
def test_imread_matches_cv2(tmp_path, kind, cv2_filter):
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, _image(kind), [cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[cv2_filter]])
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        want = cv2.imread(path, flag)
        got = image_io.imread(path, flag)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(IMAGE_SHAPES))
@pytest.mark.parametrize("filter_type", range(5))
def test_imwrite_is_read_back_by_cv2(tmp_path, kind, filter_type):
    path = str(tmp_path / "x.png")
    img = _image(kind)
    image_io.imwrite(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


def test_image_io_refuses_what_it_does_not_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "missing.png"))
    path = str(tmp_path / "x16.png")
    cv2.imwrite(path, np.arange(60, dtype=np.uint16).reshape(6, 10) * 1000)
    with pytest.raises(ValueError, match="8-bit"):
        image_io.imread(path)
    with pytest.raises(TypeError, match="uint8"):
        image_io.imwrite(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))


# ------------------------------------------------------------ fixture and dataset


def _fixtures(tmp_path, geos, seed=3, num_images=5):
    jgeo, tgeo = geos
    jfix = jsynthetic.make_csv_fixture(str(tmp_path / "jax"), geometry=jgeo,
                                       num_images=num_images, seed=seed)
    tfix = tsynthetic.make_csv_fixture(str(tmp_path / "port"), geometry=tgeo,
                                       num_images=num_images, seed=seed)
    return jfix, tfix


def _files(root, suffix):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(suffix))


@pytest.mark.parametrize("geos", [TINY_DSEC, TINY_DDD17], ids=["dsec", "ddd17"])
def test_fixture_matches_jax(tmp_path, geos):
    jfix, tfix = _fixtures(tmp_path, geos)
    for key in ("annotations_csv", "class_map_csv"):
        assert open(tfix[key]).read() == open(jfix[key]).read()
    for sub, suffix in (("img_dir", ".png"), ("event_dir", ".npz")):
        names = _files(jfix[sub], suffix)
        assert names and names == _files(tfix[sub], suffix)
        for name in names:
            a, b = os.path.join(jfix[sub], name), os.path.join(tfix[sub], name)
            if suffix == ".png":
                np.testing.assert_array_equal(cv2.imread(b, cv2.IMREAD_UNCHANGED),
                                              cv2.imread(a, cv2.IMREAD_UNCHANGED))
            else:
                np.testing.assert_array_equal(np.load(b)["arr_0"], np.load(a)["arr_0"])


def _write_gray_events(event_dir, seed=0):
    rng = np.random.default_rng(seed)
    for dirpath, _, files in os.walk(event_dir):
        for f in files:
            if f.endswith(".npz"):
                h, w = np.load(os.path.join(dirpath, f))["arr_0"].shape[1:]
                cv2.imwrite(os.path.join(dirpath, f.replace(".npz", ".png")),
                            rng.integers(0, 255, (h, w), np.uint8))


@pytest.mark.parametrize("case", ["dsec_voxel", "ddd17_voxel", "dsec_gray"])
def test_csv_dataset_matches_jax(tmp_path, case):
    geos = TINY_DDD17 if case.startswith("ddd17") else TINY_DSEC
    event_type = case.split("_")[1]
    jfix = jsynthetic.make_csv_fixture(str(tmp_path), geometry=geos[0], num_images=4, seed=5)
    if event_type == "gray":
        _write_gray_events(jfix["event_dir"])
    args = (jfix["annotations_csv"], jfix["class_map_csv"], jfix["event_dir"], jfix["img_dir"])
    jds = jcsv.CSVDetectionDataset(geos[0], *args, event_type=event_type)
    tds = tcsv.CSVDetectionDataset(geos[1], *args, event_type=event_type)
    assert len(tds) == len(jds) == 4 and tds.num_classes() == jds.num_classes()
    assert [tds.label_to_name(i) for i in range(tds.num_classes())] == [
        jds.label_to_name(i) for i in range(jds.num_classes())]
    for i in range(len(jds)):
        assert (tds.rgb_path(i), tds.event_path(i)) == (jds.rgb_path(i), jds.event_path(i))
        got, want = tds[i], jds[i]
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_csv_dataset_rgb_keyed_schema_matches_jax(tmp_path):
    jfix = jsynthetic.make_csv_fixture(str(tmp_path), geometry=TINY_DSEC[0], num_images=3, seed=6)
    # rows keyed by the RGB path under img_dir; events at <seq>/left/<frame>.npz
    rows = []
    for line in open(jfix["annotations_csv"]).read().splitlines():
        rel, rest = line.split(",", 1)
        seq, _, frame = rel.split("/")
        rows.append(f"{seq}/images/left/rectified/{frame.replace('.npz', '.png')},{rest}")
    csv_path = str(tmp_path / "rgb_keyed.csv")
    open(csv_path, "w").write("\n".join(rows) + "\n")
    args = (csv_path, jfix["class_map_csv"], jfix["event_dir"], jfix["img_dir"])
    jds = jcsv.CSVDetectionDataset(TINY_DSEC[0], *args, path_schema="rgb_keyed")
    tds = tcsv.CSVDetectionDataset(TINY_DSEC[1], *args, path_schema="rgb_keyed")
    for i in range(len(jds)):
        for key, want in jds[i].items():
            np.testing.assert_array_equal(tds[i][key], want)


def test_csv_label_errors_match_jax(tmp_path):
    classes = tmp_path / "classes.csv"
    classes.write_text("car,0\nperson,1\n")
    assert tcsv.load_class_map(str(classes)) == jcsv.load_class_map(str(classes))
    for body, match in (("a.npz,5,5,2,9,car\n", "invalid box"), ("a.npz,1,1,4,4,bus\n", "unknown class")):
        labels = tmp_path / "labels.csv"
        labels.write_text(body)
        for mod in (tcsv, jcsv):
            with pytest.raises(ValueError, match=match):
                mod.load_annotations_csv(str(labels), {"car": 0, "person": 1})
    classes.write_text("car,0\ncar,1\n")
    with pytest.raises(ValueError, match="duplicate"):
        tcsv.load_class_map(str(classes))


# ------------------------------------------------------------ transforms, voxels


def test_transforms_match_jax():
    rng = np.random.default_rng(10)
    jgeo, tgeo = TINY_DSEC
    img = rng.uniform(0, 1, (48, 80, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttransforms.normalize_rgb(img, tgeo),
                                  jtransforms.normalize_rgb(img, jgeo))
    off = rng.uniform(0, 1, (30, 50, 3)).astype(np.float32)  # off-geometry: cv2 resize
    for x in (img, off):
        got, want = ttransforms.resize_to_geometry(x, tgeo), jtransforms.resize_to_geometry(x, jgeo)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 1.0
    sample = {"rgb": img, "event": rng.normal(0, 1, (48, 80, 5)).astype(np.float32),
              "annot": np.array([[3, 4, 20, 30, 1]], np.float32)}
    got = ttransforms.horizontal_flip(sample, p=1.0, rng=np.random.default_rng(0))
    want = jtransforms.horizontal_flip(sample, p=1.0, rng=np.random.default_rng(0))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_voxelize_events_np_matches_jax():
    rng = np.random.default_rng(11)
    n = 3000
    x = rng.integers(0, 90, n)  # some past the width (80) and height (48)
    y = rng.integers(0, 55, n)
    t = np.sort(rng.integers(1_000_000, 1_050_000, n)).astype(np.int64)
    p = rng.integers(0, 2, n)
    got = tvoxelize.voxelize_events_np(x, y, t, p, 5, 48, 80)
    want = jvoxelize.voxelize_events_np(x, y, t, p, 5, 48, 80)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    empty = tvoxelize.voxelize_events_np(x[:0], y[:0], t[:0], p[:0], 5, 48, 80)
    np.testing.assert_array_equal(empty, np.zeros((5, 48, 80), np.float32))


@pytest.mark.parametrize("peak", [3.0, 40.0])
def test_voxel_normalization_matches_jax(peak):
    rng = np.random.default_rng(12)
    vox = rng.normal(0, 2, (3, 12, 20, 5)).astype(np.float32)
    vox[1] *= peak / np.abs(vox[1]).max()  # one busy sample (or none at peak 3)
    vox[0] *= 4.0 / np.abs(vox[0]).max()
    np.testing.assert_array_equal(tvoxelize.normalize_event_voxel_np(vox[1]),
                                  jvoxelize.normalize_event_voxel_np(vox[1]))
    tight = dict(atol=0, rtol=5e-7)  # torch's tanh against XLA's: 4 f32 ulps
    np.testing.assert_allclose(
        tvoxelize.normalize_event_voxel(torch.tensor(vox[1])).numpy(),
        np.asarray(jvoxelize.normalize_event_voxel(jnp.asarray(vox[1]))), **tight)
    got = tvoxelize.normalize_event_voxel_batched(torch.tensor(vox)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jvoxelize.normalize_event_voxel_batched(jnp.asarray(vox))), **tight)
    np.testing.assert_array_equal(got[0], vox[0])  # quiet samples untouched
