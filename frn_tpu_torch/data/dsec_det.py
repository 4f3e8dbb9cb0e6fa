"""Raw DSEC-Det dataset: sequence walking, tracks, event windows, voxelization.

Counterpart of ``frn_tpu/data/dsec_det.py``: the used subset of the external
``dsec-det`` library (directory layout, tracks) and the reference's own DSEC
dataset logic (dsec_data.py:150-522, dsec_utils.py): split-config filtering,
per-sequence track masks (class remap + min-size), consecutive valid-image
pairs, event windows voxelized to 5 bins, the conditional tanh
normalization, and box interpolation for sub-frame time windows.

Sequence layout on disk:
  <seq>/images/left/rectified/NNNNNN.png
  <seq>/images/timestamps.txt          (us; exposure_timestamps.txt also accepted)
  <seq>/events/left/events_2x.h5       (events.h5 accepted)
  <seq>/object_detections/left/tracks.npy   structured: t,x,y,w,h,class_id[,track_id]

Images are read by ``data/image_io.imread`` (BGR, as ``cv2.imread`` gives
them, and fed as BGR / 255 as the JAX dataset feeds them); OpenCV is needed
only to resize an image off the geometry, and pyyaml only for
``split_yaml``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from frn_tpu_torch.config import DSEC_DET, DatasetGeometry
from frn_tpu_torch.data import image_io
from frn_tpu_torch.data.events import H5EventReader
from frn_tpu_torch.data.transforms import normalize_rgb as _normalize_rgb
from frn_tpu_torch.ops.voxelize import event_representation_np, normalize_event_voxel_np

# source class vocabulary of DSEC-Det tracks (dsec-det lib), and the reference's
# remap onto 2 detector classes (dsec_data.py:151-152)
SOURCE_CLASSES = (
    "pedestrian", "rider", "car", "bus", "truck", "bicycle", "motorcycle", "train",
)
CLASS_MAPPING = dict(
    pedestrian="pedestrian", rider=None, car="car", bus="car", truck="car",
    bicycle=None, motorcycle=None, train=None,
)


def compute_class_mapping(
    classes: Sequence[str], all_classes: Sequence[str], mapping: Dict[str, Optional[str]]
) -> np.ndarray:
    """source class id -> target class id or -1 (dsec_utils.py compute_class_mapping)."""
    out = []
    for c in all_classes:
        mapped = mapping[c]
        out.append(classes.index(mapped) if mapped in classes else -1)
    return np.asarray(out)


def filter_small_boxes(w: np.ndarray, h: np.ndarray, min_height: float, min_diag: float):
    """(dsec_utils.py filter_small_bboxes): both w and h are compared to min_height."""
    diag = np.sqrt(w ** 2 + h ** 2)
    return (diag > min_diag) & (w > min_height) & (h > min_height)


def crop_tracks_xywh(tracks: np.ndarray, width: int, height: int) -> np.ndarray:
    """Clip xywh track boxes to [0, W-1] x [0, H-1] (dsec_utils.py crop_tracks)."""
    t = tracks.copy()
    x1 = np.clip(t["x"], 0, width - 1)
    x2 = np.clip(t["x"] + t["w"], 0, width - 1)
    y1 = np.clip(t["y"], 0, height - 1)
    y2 = np.clip(t["y"] + t["h"], 0, height - 1)
    t["x"], t["y"], t["w"], t["h"] = x1, y1, x2 - x1, y2 - y1
    return t


def interpolate_tracks(det0: np.ndarray, det1: np.ndarray, t: float) -> np.ndarray:
    """Linear track interpolation by track_id (dsec_data.py interpolate_tracks)."""
    if len(det0) == 0 or len(det0) != len(det1):
        return det1
    det0 = det0[np.argsort(det0["track_id"])]
    det1 = det1[np.argsort(det1["track_id"])]
    t0, t1 = det0["t"][0], det1["t"][0]
    r = (t - t0) / max(t1 - t0, 1)
    out = det0.copy()
    for k in "xywh":
        out[k] = det0[k] * (1 - r) + det1[k] * r
    return out


class SequenceDirectory:
    """One DSEC sequence on disk."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.name = self.root.name
        img_dir = self.root / "images/left/rectified"
        self.image_paths = sorted(img_dir.glob("*.png")) if img_dir.exists() else []
        self.timestamps = self._load_timestamps()
        self._tracks: Optional[np.ndarray] = None
        self._events: Optional[H5EventReader] = None

    def _load_timestamps(self) -> np.ndarray:
        for name in ("images/timestamps.txt", "images/left/exposure_timestamps.txt",
                     "images/exposure_timestamps.txt"):
            p = self.root / name
            if p.exists():
                rows = []
                for line in p.read_text().strip().splitlines():
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    rows.append(int(float(line.replace(",", " ").split()[-1])))
                return np.asarray(rows, dtype=np.int64)
        return np.zeros((0,), dtype=np.int64)

    @property
    def tracks(self) -> np.ndarray:
        if self._tracks is None:
            p = self.root / "object_detections/left/tracks.npy"
            self._tracks = np.load(p) if p.exists() else np.zeros((0,))
        return self._tracks

    @property
    def events(self) -> H5EventReader:
        if self._events is None:
            for name in ("events/left/events_2x.h5", "events/left/events.h5"):
                p = self.root / name
                if p.exists():
                    self._events = H5EventReader(str(p))
                    break
            else:
                raise FileNotFoundError(f"no event file under {self.root}/events/left")
        return self._events

    def __len__(self):
        return len(self.image_paths)


def _discover_sequences(root: Path) -> List[Path]:
    """Sequences directly under root, or under root/{train,test,val}."""
    seqs = []
    candidates = [root] + [root / s for s in ("train", "test", "val")]
    for base in candidates:
        if not base.is_dir():
            continue
        for d in sorted(base.iterdir()):
            if d.is_dir() and (d / "images").exists():
                seqs.append(d)
    return seqs


def _load_split_yaml(path: str) -> Dict[str, List[str]]:
    try:
        import yaml
    except ImportError:
        raise ImportError("pyyaml is required for split_yaml") from None
    with open(path) as f:
        return yaml.safe_load(f)


class DSECDetDataset:
    """Raw DSEC-Det detection dataset (reference DSEC class, dsec_data.py:150)."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        split_config: Optional[Dict[str, List[str]]] = None,
        split_yaml: Optional[str] = None,
        geometry: DatasetGeometry = DSEC_DET,
        classes: Tuple[str, ...] = ("car", "pedestrian"),
        time_window_us: int = 1_000_000,
        min_bbox_height: float = 0.0,
        min_bbox_diag: float = 0.0,
        num_us: int = -1,
        normalize_rgb: bool = False,  # the reference raw path feeds [0,1] RGB
        event_representation: str = "voxel",  # test_dsec_det.py:65
        only_perfect_tracks: bool = False,  # dsec_utils.py:123-148
        compact_wire: bool = False,
        events_wire: bool = False,
        event_capacity: int = 65536,
    ):
        """``compact_wire=True`` emits uint8 RGB [0..255] and int8 raw
        polarity-count voxels (clipped to +-127: exact through the tanh
        squash, which saturates to 1.0f long before 127), normalized on the
        device (``make_inference_fn(wire='compact')``, or
        ``TrainConfig.input_wire='compact'``): 4x fewer host -> device bytes.
        ``events_wire=True`` emits uint8 RGB and the window's raw events,
        padded to ``event_capacity`` slots (x, y int16, window-relative t
        int32, p int8 in {-1, 1}), voxelized on the device
        (``TrainConfig.input_wire='events'``). Both take the voxel
        representation only (the others are not integer counts)."""
        if compact_wire and event_representation != "voxel":
            raise ValueError(
                "compact_wire requires event_representation='voxel' "
                f"(got {event_representation!r}: not integer counts)"
            )
        if events_wire:
            if compact_wire:
                raise ValueError("events_wire and compact_wire are exclusive")
            if event_representation != "voxel":
                raise ValueError(
                    "events_wire requires event_representation='voxel': the "
                    "device voxelizer (ops/voxelize.voxelize_events) builds the "
                    "signed count voxel; other representations stay host-side"
                )
        self.compact_wire = compact_wire
        self.events_wire = events_wire
        self.event_capacity = int(event_capacity)
        self.geometry = geometry
        self.classes = classes
        self.time_window_us = time_window_us
        self.num_us = num_us
        self.normalize_rgb = normalize_rgb
        self.event_representation = event_representation
        self.width, self.height = geometry.width, geometry.height

        if split_config is None and split_yaml:
            split_config = _load_split_yaml(split_yaml)

        all_seqs = _discover_sequences(Path(root))
        if split_config and split in split_config:
            wanted = set(split_config[split])
            all_seqs = [s for s in all_seqs if s.name in wanted]
        self.sequences = [SequenceDirectory(s) for s in all_seqs]
        self.sequences = [s for s in self.sequences if len(s) and len(s.timestamps)]

        self.class_remap = compute_class_mapping(classes, SOURCE_CLASSES, CLASS_MAPPING)
        self._index: List[Tuple[int, int, int]] = []  # (seq_idx, img_i0, img_i1)
        self._track_masks: List[np.ndarray] = []
        self._build_index(min_bbox_height, min_bbox_diag, only_perfect_tracks)

    @staticmethod
    def _is_perfect_pair(tr0: np.ndarray, tr1: np.ndarray) -> bool:
        """Track continuity (dsec_utils.py is_invalid_track, inverted): the same
        track ids at both frames and per-track IoU >= 0.10."""
        if len(tr0) != len(tr1):
            return False
        tr0 = tr0[np.argsort(tr0["track_id"])]
        tr1 = tr1[np.argsort(tr1["track_id"])]
        if not (tr0["track_id"] == tr1["track_id"]).all():
            return False
        if len(tr0) == 0:
            return True
        x1a, y1a = tr0["x"], tr0["y"]
        x2a, y2a = x1a + tr0["w"], y1a + tr0["h"]
        x1b, y1b = tr1["x"], tr1["y"]
        x2b, y2b = x1b + tr1["w"], y1b + tr1["h"]
        iw = np.maximum(np.minimum(x2a, x2b) - np.maximum(x1a, x1b), 0)
        ih = np.maximum(np.minimum(y2a, y2b) - np.maximum(y1a, y1b), 0)
        inter = iw * ih
        union = tr0["w"] * tr0["h"] + tr1["w"] * tr1["h"] - inter + 1e-9
        return bool((inter / union).min() >= 0.10)

    def _build_index(self, min_h: float, min_diag: float, only_perfect: bool):
        """filter_tracks (dsec_utils.py:50-78): valid images -> consecutive pairs."""
        for si, seq in enumerate(self.sequences):
            tracks = seq.tracks
            if tracks.size == 0:
                self._track_masks.append(np.zeros(0, bool))
                continue
            cropped = crop_tracks_xywh(tracks, self.width, self.height)
            class_mask = self.class_remap[cropped["class_id"].astype(int)] > -1
            size_mask = filter_small_boxes(cropped["w"], cropped["h"], min_h, min_diag)
            final = class_mask & size_mask
            self._track_masks.append(final)

            valid_ts = np.unique(tracks["t"][final])
            valid_idx = np.nonzero(np.isin(seq.timestamps, valid_ts))[0]
            consecutive = valid_idx[:-1][np.diff(valid_idx) == 1]
            for i0 in consecutive:
                if only_perfect:
                    ts0 = int(seq.timestamps[i0])
                    ts1 = int(seq.timestamps[i0 + 1])
                    tr0 = tracks[final & (tracks["t"] == ts0)]
                    tr1 = tracks[final & (tracks["t"] == ts1)]
                    if not self._is_perfect_pair(tr0, tr1):
                        continue
                self._index.append((si, int(i0), int(i0) + 1))

    # ------------------------------------------------ eval-compatible surface
    def __len__(self) -> int:
        return len(self._index)

    def num_classes(self) -> int:
        return len(self.classes)

    def label_to_name(self, label: int) -> str:
        return self.classes[label]

    def _tracks_at(self, seq_idx: int, ts: int) -> np.ndarray:
        seq = self.sequences[seq_idx]
        mask = self._track_masks[seq_idx]
        return seq.tracks[mask & (seq.tracks["t"] == ts)]

    def _annotations(self, tr: np.ndarray) -> np.ndarray:
        if len(tr) == 0:
            return np.zeros((0, 5), np.float32)
        tr = crop_tracks_xywh(tr, self.width, self.height)
        cls = self.class_remap[tr["class_id"].astype(int)].astype(np.float32)
        ann = np.stack(
            [tr["x"], tr["y"], tr["x"] + tr["w"], tr["y"] + tr["h"], cls], axis=1
        ).astype(np.float32)
        # drop boxes that cropping made degenerate
        keep = (ann[:, 2] - ann[:, 0] >= 1) & (ann[:, 3] - ann[:, 1] >= 1)
        return ann[keep]

    def load_annotations(self, index: int) -> np.ndarray:
        si, i0, i1 = self._index[index]
        ts1 = int(self.sequences[si].timestamps[i1])
        det1 = self._tracks_at(si, ts1)
        if self.num_us >= 0:
            ts0 = int(self.sequences[si].timestamps[i0])
            det0 = self._tracks_at(si, ts0)
            det1 = interpolate_tracks(det0, det1, ts0 + self.num_us)
        return self._annotations(det1)

    def load_image_u8(self, seq: SequenceDirectory, idx: int) -> np.ndarray:
        """(H, W, 3) uint8 BGR; zeros for a missing file, as the JAX dataset
        gives when ``cv2.imread`` returns None. A file ``image_io`` cannot
        decode raises (it refuses some PNG kinds OpenCV reads, and zeros there
        would train on blank images unseen)."""
        try:
            img = image_io.imread(str(seq.image_paths[idx]))
        except FileNotFoundError:
            return np.zeros((self.height, self.width, 3), np.uint8)
        if img.shape[:2] != (self.height, self.width):
            try:
                import cv2
            except ImportError:
                raise ImportError(
                    f"OpenCV (cv2) is required to resize {img.shape[:2]} images to "
                    f"{(self.height, self.width)}") from None
            img = cv2.resize(img, (self.width, self.height), interpolation=cv2.INTER_CUBIC)
        return img

    def load_image(self, seq: SequenceDirectory, idx: int) -> np.ndarray:
        return self.load_image_u8(seq, idx).astype(np.float32) / 255.0

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        si, i0, i1 = self._index[index]
        seq = self.sequences[si]
        ts0 = int(seq.timestamps[i0])

        if self.compact_wire or self.events_wire:
            rgb = self.load_image_u8(seq, i0)  # /255 (+standardize) runs on the device
        else:
            rgb = self.load_image(seq, i0)
            if self.normalize_rgb:
                rgb = _normalize_rgb(rgb, self.geometry)

        t_end = ts0 if self.num_us < 0 else ts0 + self.num_us
        ev = seq.events.window(t_end - self.time_window_us, t_end)
        meta = {"annot": self.load_annotations(index), "sequence": seq.name,
                "timestamp": int(seq.timestamps[i1]), "image_index": i1}
        if self.events_wire:
            # the raw sensor stream, voxelized and squashed on the device; a
            # window beyond the capacity keeps its first event_capacity events
            # (pick a capacity >= the largest window for parity with the host
            # voxelizer)
            cap = self.event_capacity
            n = min(len(ev["t"]), cap)
            ex = np.zeros((cap,), np.int16)
            ey = np.zeros((cap,), np.int16)
            et = np.zeros((cap,), np.int32)
            ep = np.zeros((cap,), np.int8)
            if n:
                ex[:n] = ev["x"][:n].astype(np.int16)
                ey[:n] = ev["y"][:n].astype(np.int16)
                t64 = ev["t"][:n].astype(np.int64)
                et[:n] = (t64 - t64[0]).astype(np.int32)  # window-relative us
                ep[:n] = np.where(ev["p"][:n] > 0, 1, -1).astype(np.int8)
            return {"event_x": ex, "event_y": ey, "event_t": et, "event_p": ep,
                    "event_n": np.int32(n), "rgb": rgb, **meta}
        voxel = event_representation_np(
            ev["x"].astype(np.int64), ev["y"].astype(np.int64), ev["t"], ev["p"],
            kind=self.event_representation,
            num_bins=self.geometry.event_channels,
            height=self.height, width=self.width,
        )
        if self.compact_wire:
            # raw counts over the wire; the device applies the tanh squash
            voxel = np.clip(np.rint(voxel), -127, 127).astype(np.int8)
        elif self.event_representation == "voxel":
            voxel = normalize_event_voxel_np(voxel)
        else:
            voxel = voxel.astype(np.float32)
        return {"event": np.ascontiguousarray(np.transpose(voxel, (1, 2, 0))),
                "rgb": rgb if self.compact_wire else rgb.astype(np.float32), **meta}
