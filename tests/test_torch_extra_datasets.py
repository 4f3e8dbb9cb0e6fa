"""The port's secondary datasets against frn_tpu's, on the CPU.

Fixtures written by the test: PNG images (``data/image_io.imwrite``; the JAX
package reads them with OpenCV, the port with its own PNG reader, both in
BGR), a COCO instances JSON, an Open Images metadata table, and an NCaltech101
tree of event h5 files with their .bin boxes (skipped without h5py). Samples,
annotations, labels and the aspect-ratio groups are held exactly: the same
bytes decoded, the same voxelization (native in both, sums of +-1). JPEG
images (written by OpenCV and PIL: sequential and progressive, an EXIF
orientation) are read by the port's own decoder, pixel for pixel as
frn_tpu's ``cv2.imread`` reads them.
"""

import io
import json

import cv2
import numpy as np
import pytest

import frn_tpu.data.extra_datasets as jextra
from frn_tpu_torch.data import extra_datasets as textra
from frn_tpu_torch.data.image_io import imwrite

pytestmark = pytest.mark.skipif(jextra.cv2 is None, reason="frn_tpu reads images with OpenCV")


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _png(path, h, w, seed):
    imwrite(str(path), np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8))


def _jpeg(h, w, seed, variant):
    """JPEG bytes of a noisy gradient: 'baseline_420' and 'progressive_444'
    by OpenCV, 'exif_rotated' by PIL with EXIF orientation 6 (read as w x h)."""
    rng = np.random.default_rng(seed)
    img = np.clip(np.mgrid[:h, :w].sum(0)[:, :, None] * [3, 5, 7] % 256
                  + rng.normal(0, 15, (h, w, 3)), 0, 255).astype(np.uint8)
    if variant == "exif_rotated":
        from PIL import Image

        exif = Image.Exif()
        exif[0x0112] = 6
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, exif=exif.tobytes())
        return buf.getvalue()
    progressive = variant == "progressive_444"
    sampling = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444 if progressive else cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE,
                                         int(progressive), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
    return buf.tobytes()


@pytest.fixture
def coco(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    _png(img_dir / "a.png", 40, 60, 1)
    _png(img_dir / "b.png", 30, 50, 2)
    (img_dir / "c.jpg").write_bytes(_jpeg(27, 33, 3, "baseline_420"))
    data = {
        "images": [{"id": 7, "file_name": "a.png", "width": 60, "height": 40},
                   {"id": 3, "file_name": "b.png", "width": 50, "height": 30},
                   {"id": 9, "file_name": "c.jpg", "width": 33, "height": 27}],
        "categories": [{"id": 10, "name": "cat"}, {"id": 2, "name": "dog"},
                       {"id": 5, "name": "car"}],
        "annotations": [
            {"image_id": 7, "bbox": [5, 5, 20, 10], "category_id": 10, "iscrowd": 0},
            {"image_id": 7, "bbox": [0, 0, 10, 10], "category_id": 2, "iscrowd": 0},
            {"image_id": 7, "bbox": [1, 2, 30, 20], "category_id": 5, "iscrowd": 1},  # crowd
            {"image_id": 3, "bbox": [1, 1, 0.5, 8], "category_id": 2, "iscrowd": 0},  # degenerate
            {"image_id": 3, "bbox": [2.5, 3.25, 12, 9], "category_id": 5},
        ],
    }
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(data))
    return str(img_dir), str(path)


def test_coco_json_dataset_equals_jax(coco):
    got, want = textra.CocoJsonDataset(*coco), jextra.CocoJsonDataset(*coco)
    assert len(got) == len(want) == 3 and got.num_classes() == want.num_classes() == 3
    assert got.image_ids == want.image_ids
    assert [got.label_to_name(i) for i in range(3)] == [want.label_to_name(i) for i in range(3)]
    for i in range(3):
        np.testing.assert_array_equal(got.load_annotations(i), want.load_annotations(i))
    for i in range(3):  # two PNGs and a JPEG
        _assert_samples_equal(got[i], want[i])


@pytest.mark.parametrize("variant", ["baseline_420", "progressive_444", "exif_rotated"])
def test_coco_and_oid_over_jpeg_images_equal_jax(tmp_path, variant):
    """COCO's images are all JPEG, and OidDataset names every image <id>.jpg:
    both datasets over real JPEG bytes, sample for sample."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    sizes = {"p1": (45, 61), "p2": (30, 50)}
    for k, (name, (h, w)) in enumerate(sizes.items()):
        (img_dir / f"{name}.jpg").write_bytes(_jpeg(h, w, k, variant))
    turned = variant == "exif_rotated"
    coco = {"images": [{"id": k + 1, "file_name": f"{name}.jpg", "width": h if turned else w,
                        "height": w if turned else h} for k, (name, (h, w)) in enumerate(sizes.items())],
            "categories": [{"id": 4, "name": "car"}, {"id": 1, "name": "person"}],
            "annotations": [{"image_id": 1, "bbox": [3, 4, 20, 12], "category_id": 4, "iscrowd": 0},
                            {"image_id": 2, "bbox": [1.5, 2, 9, 17], "category_id": 1}]}
    ann_json = tmp_path / "instances.json"
    ann_json.write_text(json.dumps(coco))
    got, want = (m.CocoJsonDataset(str(img_dir), str(ann_json)) for m in (textra, jextra))
    assert len(got) == len(want) == 2
    for i in range(2):
        np.testing.assert_array_equal(got.load_annotations(i), want.load_annotations(i))
        _assert_samples_equal(got[i], want[i])

    meta = tmp_path / "meta"
    meta.mkdir()
    (meta / "class-descriptions-boxable.csv").write_text("/m/01,Person\n/m/02,Car\n")
    ann_csv = tmp_path / "ann.csv"
    ann_csv.write_text("ImageID,LabelName,XMin,XMax,YMin,YMax\n"
                       "p1,/m/01,0.1,0.5,0.2,0.8\np2,/m/02,0.25,0.75,0.1,0.35\n")
    got, want = (m.OidDataset(str(img_dir), str(meta), str(ann_csv)) for m in (textra, jextra))
    assert len(got) == len(want) == 2 and got.image_ids == want.image_ids
    for i in range(2):
        np.testing.assert_array_equal(got.load_annotations(i), want.load_annotations(i))
        _assert_samples_equal(got[i], want[i])


@pytest.fixture
def oid(tmp_path):
    meta = tmp_path / "meta"
    meta.mkdir()
    (meta / "class-descriptions-boxable.csv").write_text("/m/01,Person\n/m/02,\"Car's\"\n\n/m/03,Bus\n")
    (meta / "challenge-2018-class-descriptions-500.csv").write_text("/m/09,Tree\n/m/02,Car\n")
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    # the dataset names its images <id>.jpg; these hold PNG bytes, which both
    # readers decode by content
    _png(img_dir / "img1.jpg", 50, 100, 3)
    _png(img_dir / "img0.jpg", 20, 30, 4)
    ann = tmp_path / "ann.csv"
    ann.write_text("ImageID,LabelName,XMin,XMax,YMin,YMax\n"
                   "img1,/m/01,0.1,0.5,0.2,0.8\n"
                   "img1,/m/99,0.0,1.0,0.0,1.0\n"  # unknown label, skipped
                   "img0,/m/03,0.25,0.75,0.1,0.35\n"
                   "img1,/m/02,0.0,0.3,0.5,0.9\n")
    return str(img_dir), str(meta), str(ann)


@pytest.mark.parametrize("version", ["v4", "challenge2018"])
def test_oid_labels_and_annotations_equal_jax(oid, version):
    img_dir, meta, ann = oid
    assert textra.oid_get_labels(meta, version) == jextra.oid_get_labels(meta, version)
    _, cls_index = jextra.oid_get_labels(meta, version)
    assert (textra.oid_build_annotations(ann, cls_index, img_dir)
            == jextra.oid_build_annotations(ann, cls_index, img_dir))


def test_oid_dataset_equals_jax(oid):
    got, want = textra.OidDataset(*oid), jextra.OidDataset(*oid)
    assert len(got) == len(want) == 2 and got.image_ids == want.image_ids
    assert got.num_classes() == want.num_classes() == 3
    assert [got.label_to_name(i) for i in range(3)] == [want.label_to_name(i) for i in range(3)]
    for i in range(2):
        np.testing.assert_array_equal(got.load_annotations(i), want.load_annotations(i))
        _assert_samples_equal(got[i], want[i])


def _ncaltech(root, classes=("airplane", "car"), per_class=2):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(5)
    for cls in classes:
        d, a = root / "training" / cls, root / "annotations" / cls
        d.mkdir(parents=True)
        a.mkdir(parents=True)
        for i in range(per_class):
            n = int(rng.integers(800, 1500))
            with h5py.File(str(d / f"image_{i:04d}.h5"), "w") as f:
                g = f.create_group("events")
                g.create_dataset("x", data=rng.integers(0, 250, n).astype(np.uint16))
                g.create_dataset("y", data=rng.integers(0, 190, n).astype(np.uint16))
                g.create_dataset("t", data=np.sort(rng.integers(0, 2_000_000, n)))
                g.create_dataset("p", data=rng.integers(0, 2, n).astype(np.uint8))
            words = np.zeros(12, np.int16)
            words[2:10] = rng.integers(0, 150, 8)
            words.tofile(str(a / f"annotation_{i:04d}.bin"))
    return str(root)


@pytest.mark.parametrize("num_events", [600, 50_000])
def test_ncaltech101_equals_jax(tmp_path, num_events):
    """The last ``num_events`` events (fewer than a file holds, and more),
    some past the 240x180 frame, voxelized to (H, W, C)."""
    root = _ncaltech(tmp_path)
    got = textra.NCaltech101Dataset(root, num_events=num_events)
    want = jextra.NCaltech101Dataset(root, num_events=num_events)
    assert len(got) == len(want) == 4 and got.classes == want.classes
    assert [str(f) for f in got.files] == [str(f) for f in want.files]
    for i in range(len(want)):
        np.testing.assert_array_equal(got.load_annotations(i), want.load_annotations(i))
        s = got[i]
        _assert_samples_equal(s, want[i])
        assert s["event"].shape == (180, 240, 5) and np.abs(s["event"]).sum() > 0


def test_ncaltech101_needs_h5py(tmp_path, monkeypatch):
    monkeypatch.setattr(textra, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        textra.NCaltech101Dataset(str(tmp_path))


class _Ratios:
    def __init__(self, ratios):
        self.ratios = ratios

    def __len__(self):
        return len(self.ratios)

    def image_aspect_ratio(self, i):
        return self.ratios[i]


@pytest.mark.parametrize("batch_size", [2, 3, 4])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_group_by_aspect_ratio_equals_jax(batch_size, drop_last, shuffle):
    ds = _Ratios(list(np.random.default_rng(6).uniform(0.5, 2.0, 11)))
    kw = dict(batch_size=batch_size, drop_last=drop_last, shuffle_groups=shuffle, seed=7)
    got = textra.group_by_aspect_ratio(ds, **kw)
    assert got == jextra.group_by_aspect_ratio(ds, **kw)
    assert all(len(g) == batch_size for g in got)
