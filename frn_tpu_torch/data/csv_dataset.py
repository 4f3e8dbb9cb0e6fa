"""CSV-label datasets for the DSEC and PKU-DDD17-Car benchmarks.

Counterpart of ``frn_tpu/data/csv_dataset.py`` (the reference's
CSVDataset_event / CSVDataset_gray, dataloader.py:26-402), reading its JPEG
and PNG images with ``data/image_io.py`` (the pixels ``cv2.imread`` gives)
instead of OpenCV:
  * annotation CSV rows: img_file,x1,y1,x2,y2,class (empty coords = image with no
    annotations); class-map CSV rows: name,id
  * event channel: pre-voxelized .npz (key 'arr_0', (C,H,W)) for 'voxel', or a
    grayscale e2vid reconstruction image (PNG or JPEG) for 'gray'
  * RGB path schema differs per benchmark (dataloader.py:121-126):
      dsec : <img_dir>/<seq>/images/left/rectified/<frame>.png
      ddd17: <img_dir>/<rel path with .npz -> .png>
  * degenerate boxes (w or h < 1 px) are dropped (dataloader.py:150-153)

``path_schema="rgb_keyed"`` selects the CSVDataset_event_rgb variant instead
(dataloader_rgb.py:113-126): annotation rows are keyed by the RGB image's
relative path under img_dir, and the event file is derived as
<event_dir>/<first path component>/left/<frame>.npz.

Samples are numpy dicts in NHWC.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

import numpy as np

from frn_tpu_torch.config import DatasetGeometry, geometry_for
from frn_tpu_torch.data import image_io
from frn_tpu_torch.data.transforms import normalize_rgb, resize_to_geometry


def load_class_map(path: str) -> Dict[str, int]:
    classes: Dict[str, int] = {}
    with open(path, newline="") as f:
        for i, row in enumerate(csv.reader(f)):
            if not row:
                continue
            if len(row) != 2:
                raise ValueError(f"{path}:{i + 1}: expected 'class_name,class_id'")
            name, cid = row
            if name in classes:
                raise ValueError(f"{path}:{i + 1}: duplicate class {name!r}")
            classes[name] = int(cid)
    return classes


def load_annotations_csv(path: str, classes: Dict[str, int]) -> Dict[str, List[dict]]:
    result: Dict[str, List[dict]] = {}
    with open(path, newline="") as f:
        for i, row in enumerate(csv.reader(f)):
            if not row:
                continue
            img_file, x1, y1, x2, y2, cls = row[:6]
            result.setdefault(img_file, [])
            if (x1, y1, x2, y2, cls) == ("", "", "", "", ""):
                continue
            x1, y1, x2, y2 = int(x1), int(y1), int(x2), int(y2)
            if x2 <= x1 or y2 <= y1:
                raise ValueError(f"{path}:{i + 1}: invalid box {(x1, y1, x2, y2)}")
            if cls not in classes:
                raise ValueError(f"{path}:{i + 1}: unknown class {cls!r}")
            result[img_file].append(dict(x1=x1, y1=y1, x2=x2, y2=y2, cls=cls))
    return result


class CSVDetectionDataset:
    """Event-voxel (.npz) or gray-event (.png) + RGB (.png) dataset over CSV labels."""

    def __init__(
        self,
        geometry: DatasetGeometry | str,
        annotations_csv: str,
        class_map_csv: str,
        event_dir: str,
        img_dir: str,
        event_type: str = "voxel",  # 'voxel' | 'gray'
        normalize: bool = True,
        path_schema: str = "event_keyed",  # 'event_keyed' | 'rgb_keyed'
    ):
        if path_schema not in ("event_keyed", "rgb_keyed"):
            raise ValueError(f"unknown path_schema {path_schema!r}")
        self.path_schema = path_schema
        self.geometry = geometry_for(geometry) if isinstance(geometry, str) else geometry
        self.classes = load_class_map(class_map_csv)
        self.labels = {v: k for k, v in self.classes.items()}
        self.image_data = load_annotations_csv(annotations_csv, self.classes)
        self.image_names = list(self.image_data.keys())
        self.event_dir = event_dir
        self.img_dir = img_dir
        self.event_type = event_type
        self.normalize = normalize

    # --- the reference evaluator's surface (csv_eval.py uses these) ---
    def __len__(self) -> int:
        return len(self.image_names)

    def num_classes(self) -> int:
        return max(self.classes.values()) + 1

    def name_to_label(self, name: str) -> int:
        return self.classes[name]

    def label_to_name(self, label: int) -> str:
        return self.labels[label]

    def rgb_path(self, image_index: int) -> str:
        rel = self.image_names[image_index]
        if self.path_schema == "rgb_keyed":
            # CSV rows name the RGB file directly (dataloader_rgb.py:121)
            return os.path.join(self.img_dir, rel)
        if self.geometry.name == "dsec":
            parts = rel.split("/")
            return os.path.join(
                self.img_dir, parts[-3], "images/left/rectified",
                parts[-1].replace(".npz", ".png"),
            )
        return os.path.join(self.img_dir, rel.replace(".npz", ".png"))

    def event_path(self, image_index: int) -> str:
        rel = self.image_names[image_index]
        if self.path_schema == "rgb_keyed":
            # <event_dir>/<seq>/left/<frame>.npz derived from the RGB path
            # (dataloader_rgb.py:115-116: file[0] + '/left/' + basename)
            parts = rel.split("/")
            return os.path.join(
                self.event_dir, parts[0], "left", parts[-1].replace(".png", ".npz")
            )
        if self.event_type == "gray":
            rel = rel.replace(".npz", ".png")
        return os.path.join(self.event_dir, rel)

    def load_event(self, image_index: int) -> np.ndarray:
        """(H, W, C) float32 event representation."""
        path = self.event_path(image_index)
        if self.event_type == "voxel":
            arr = np.load(path)["arr_0"]  # (C, H, W)
            return np.transpose(arr, (1, 2, 0)).astype(np.float32)
        img = image_io.imread(path, image_io.IMREAD_GRAYSCALE)
        return (img[:, :, None].astype(np.float32)) / 255.0

    def load_rgb(self, image_index: int) -> np.ndarray:
        """(H, W, 3) float32 BGR in [0, 1], as the reference reads it; a file
        ``cv2.imread`` returns None for (missing, or damaged past what OpenCV
        reads) raises ``FileNotFoundError`` naming it, as the JAX dataset
        does."""
        path = self.rgb_path(image_index)
        try:
            img = image_io.imread(path)
        except image_io.UnreadableImage:
            raise FileNotFoundError(path) from None
        return img.astype(np.float32) / 255.0

    def load_annotations(self, image_index: int) -> np.ndarray:
        """(N, 5) [x1,y1,x2,y2,class]; degenerate boxes dropped."""
        rows = self.image_data[self.image_names[image_index]]
        out = []
        for a in rows:
            if (a["x2"] - a["x1"]) < 1 or (a["y2"] - a["y1"]) < 1:
                continue
            out.append([a["x1"], a["y1"], a["x2"], a["y2"], self.classes[a["cls"]]])
        if not out:
            return np.zeros((0, 5), dtype=np.float32)
        return np.asarray(out, dtype=np.float32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        event = self.load_event(idx)
        rgb = self.load_rgb(idx)
        rgb, _ = resize_to_geometry(rgb, self.geometry)
        if self.normalize:
            rgb = normalize_rgb(rgb, self.geometry)
        return {
            "event": event.astype(np.float32),
            "rgb": rgb.astype(np.float32),
            "annot": self.load_annotations(idx),
        }
