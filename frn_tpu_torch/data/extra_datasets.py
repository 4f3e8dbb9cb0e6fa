"""Secondary datasets from the reference inventory (counterpart of
``frn_tpu/data/extra_datasets.py``).

Host-side numpy:
  * NCaltech101 (ncaltech101_data.py) — event-classification/detection dataset:
    per-class directories of event h5 files, last-N-events window, one bbox per
    sample from companion .bin annotation files. The reference depends on the
    external `dagr` package; this version parses the files directly. Needs
    h5py.
  * COCO-style dataset (dataloader0.py CocoDataset) — parses instances JSON
    directly (no pycocotools), contiguous label remapping.
  * Open Images dataset helpers (oid_dataset.py get_labels /
    annotation-JSON generation, subset used by the reference).
  * Aspect-ratio batch grouping (dataloader.py AspectRatioBasedSampler; the
    reference defines it but comments it out of training).

Images are read by ``data/image_io.imread``: JPEG and PNG, in BGR, the pixels
``cv2.imread`` gives (EXIF orientation applied), a damaged file's too. Another
format raises ``ValueError``, where the JAX package reads it through OpenCV;
a file ``cv2.imread`` returns None for raises ``image_io.UnreadableImage``
(a ``ValueError``), where the JAX package fails on the None.
"""

from __future__ import annotations

import csv
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import h5py
except ImportError:  # NCaltech101Dataset raises when built
    h5py = None

from frn_tpu_torch.data.image_io import imread
from frn_tpu_torch.ops.voxelize import voxelize_events_np


class NCaltech101Dataset:
    """<root>/<split>/<class>/image_XXXX.h5 + <root>/annotations/<class>/annotation_XXXX.bin.

    Returns samples with the last `num_events` events voxelized to (H,W,C) and a
    single class bbox (annotation words 2..9 per the reference's parser:
    [x1, y1, x2-x1 (w), ..., y2-y1 (h)] -> converted to corners here).
    """

    HEIGHT, WIDTH = 180, 240

    def __init__(self, root: str, split: str = "training", num_events: int = 50000,
                 event_channels: int = 5):
        if h5py is None:
            raise ImportError("h5py required")
        self.load_dir = Path(root) / split
        self.classes = sorted(d.name for d in self.load_dir.glob("*") if d.is_dir())
        self.files = sorted(self.load_dir.rglob("*.h5"))
        self.num_events = num_events
        self.event_channels = event_channels

    def __len__(self):
        return len(self.files)

    def num_classes(self):
        return len(self.classes)

    def label_to_name(self, label: int) -> str:
        return self.classes[label]

    def _load_events(self, path: Path) -> Dict[str, np.ndarray]:
        with h5py.File(str(path), "r") as fh:
            ev = fh["events"]
            return {k: np.asarray(ev[k][-self.num_events :]) for k in "xytp"}

    def _load_bbox(self, path: Path, class_id: int) -> np.ndarray:
        rel = str(path.relative_to(self.load_dir))
        rel = rel.replace("image_", "annotation_").replace(".h5", ".bin")
        ann_file = self.load_dir.parent / "annotations" / rel
        words = np.fromfile(str(ann_file), dtype=np.int16)[2:10]
        x1, y1 = float(words[0]), float(words[1])
        w = float(words[2] - words[0])
        h = float(words[5] - words[1])
        return np.asarray([[x1, y1, x1 + w, y1 + h, class_id]], np.float32)

    def load_annotations(self, idx: int) -> np.ndarray:
        path = self.files[idx]
        class_id = self.classes.index(path.parent.name)
        return self._load_bbox(path, class_id)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path = self.files[idx]
        ev = self._load_events(path)
        voxel = voxelize_events_np(
            ev["x"].astype(np.int64), ev["y"].astype(np.int64),
            ev["t"].astype(np.int64), ev["p"],
            num_bins=self.event_channels, height=self.HEIGHT, width=self.WIDTH,
        )
        return {
            "event": np.transpose(voxel, (1, 2, 0)).astype(np.float32),
            "rgb": np.zeros((self.HEIGHT, self.WIDTH, 3), np.float32),
            "annot": self.load_annotations(idx),
        }


class CocoJsonDataset:
    """COCO instances-JSON detection dataset without pycocotools.

    Categories are remapped to contiguous labels sorted by original id, matching
    the reference's coco_label <-> label maps (dataloader0.py:58-76).
    """

    def __init__(self, img_dir: str, annotations_json: str):
        with open(annotations_json) as f:
            coco = json.load(f)
        self.img_dir = img_dir
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        self.label_names = [c["name"] for c in cats]
        self.coco_to_label = {c["id"]: i for i, c in enumerate(cats)}
        self.images = {im["id"]: im for im in coco["images"]}
        self.image_ids = sorted(self.images)
        self.anns_by_image: Dict[int, List[dict]] = {i: [] for i in self.image_ids}
        for a in coco.get("annotations", []):
            if a.get("iscrowd", 0):
                continue
            self.anns_by_image.setdefault(a["image_id"], []).append(a)

    def __len__(self):
        return len(self.image_ids)

    def num_classes(self):
        return len(self.label_names)

    def label_to_name(self, label: int) -> str:
        return self.label_names[label]

    def load_annotations(self, idx: int) -> np.ndarray:
        rows = []
        for a in self.anns_by_image[self.image_ids[idx]]:
            x, y, w, h = a["bbox"]
            if w < 1 or h < 1:
                continue
            rows.append([x, y, x + w, y + h, self.coco_to_label[a["category_id"]]])
        if not rows:
            return np.zeros((0, 5), np.float32)
        return np.asarray(rows, np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.images[self.image_ids[idx]]
        img = imread(os.path.join(self.img_dir, info["file_name"]))
        rgb = img.astype(np.float32) / 255.0
        return {
            "event": np.zeros((*rgb.shape[:2], 5), np.float32),
            "rgb": rgb,
            "annot": self.load_annotations(idx),
        }


def oid_get_labels(metadata_dir: str, version: str = "v4") -> Tuple[Dict[int, str], Dict[str, int]]:
    """Open Images class tables (oid_dataset.py get_labels, v4/challenge2018)."""
    csv_file = (
        "class-descriptions-boxable.csv"
        if version == "v4"
        else "challenge-2018-class-descriptions-500.csv"
    )
    id_to_labels: Dict[int, str] = {}
    cls_index: Dict[str, int] = {}
    with open(os.path.join(metadata_dir, csv_file)) as f:
        i = 0
        for row in csv.reader(f):
            if not row:
                continue
            label_id, description = row[0], row[1].replace('"', "").replace("'", "")
            id_to_labels[i] = description
            cls_index[label_id] = i
            i += 1
    return id_to_labels, cls_index


def oid_build_annotations(
    annotations_csv: str, cls_index: Dict[str, int], img_dir: str
) -> Dict[str, dict]:
    """OID bbox CSV -> {image_id: {w, h?, boxes: [...] normalized}} (subset of
    oid_dataset.py generate_images_annotations_json; image sizes resolved lazily)."""
    out: Dict[str, dict] = {}
    with open(annotations_csv) as f:
        reader = csv.DictReader(f)
        for row in reader:
            label = row["LabelName"]
            if label not in cls_index:
                continue
            img_id = row["ImageID"]
            entry = out.setdefault(img_id, {"boxes": []})
            entry["boxes"].append(
                {
                    "x1": float(row["XMin"]), "x2": float(row["XMax"]),
                    "y1": float(row["YMin"]), "y2": float(row["YMax"]),
                    "cls": cls_index[label],
                }
            )
    return out


class OidDataset:
    """Open Images detection dataset over the parsed annotation table."""

    def __init__(self, img_dir: str, metadata_dir: str, annotations_csv: str,
                 version: str = "v4"):
        self.img_dir = img_dir
        self.id_to_labels, cls_index = oid_get_labels(metadata_dir, version)
        self.annotations = oid_build_annotations(annotations_csv, cls_index, img_dir)
        self.image_ids = sorted(self.annotations)

    def __len__(self):
        return len(self.image_ids)

    def num_classes(self):
        return len(self.id_to_labels)

    def label_to_name(self, label: int) -> str:
        return self.id_to_labels[label]

    def _image_path(self, img_id: str) -> str:
        return os.path.join(self.img_dir, img_id + ".jpg")

    def load_annotations(self, idx: int) -> np.ndarray:
        img_id = self.image_ids[idx]
        img = imread(self._image_path(img_id))
        h, w = img.shape[:2]
        rows = [
            [b["x1"] * w, b["y1"] * h, b["x2"] * w, b["y2"] * h, b["cls"]]
            for b in self.annotations[img_id]["boxes"]
        ]
        return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = imread(self._image_path(self.image_ids[idx])).astype(np.float32) / 255.0
        return {
            "event": np.zeros((*img.shape[:2], 5), np.float32),
            "rgb": img,
            "annot": self.load_annotations(idx),
        }


def group_by_aspect_ratio(dataset, batch_size: int, drop_last: bool = False,
                          shuffle_groups: bool = True, seed: int = 0) -> List[List[int]]:
    """Batches of indices sorted by image aspect ratio (dataloader.py:559-584)."""
    order = sorted(
        range(len(dataset)), key=lambda i: dataset.image_aspect_ratio(i)
    )
    groups = [
        [order[x % len(order)] for x in range(i, i + batch_size)]
        for i in range(0, len(order), batch_size)
    ]
    if drop_last and groups and len(order) % batch_size:
        groups.pop()
    if shuffle_groups:
        np.random.default_rng(seed).shuffle(groups)
    return groups
