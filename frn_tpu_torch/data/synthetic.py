"""Synthetic detection data: seeded in-memory samples, and a CSV benchmark on disk.

``box_samples``: NHWC f32 images with 1-3 boxes each, for the training entry
point and its checks; every sample is made from ``(seed, index)`` with numpy,
so a run and its tests see the same data.

``make_csv_fixture``: the counterpart of ``frn_tpu/data/synthetic.py``'s: a
miniature benchmark (voxel .npz files, RGB pngs, CSV labels) in the DSEC or
DDD17 path schema, PNGs written by ``data/image_io.py``. From one seed it
gives the same pixels, voxels and CSV rows as the JAX package's.

``make_dsec_det_fixture``: the same for the raw DSEC-Det layout (sequence
directories with PNGs, timestamps, tracks and an event h5 file, which needs
``h5py``): from one seed the same files as the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from frn_tpu_torch.config import DSEC, DatasetGeometry
from frn_tpu_torch.data import image_io
from frn_tpu_torch.data.events import write_event_h5
from frn_tpu_torch.ops.voxelize import voxelize_events_np


def box_samples(num: int, geometry: DatasetGeometry, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """``num`` samples {'rgb' (H, W, 3), 'event' (H, W, C), 'annot' (k, 5)}:
    normal(0, 1) noise, k in 1..3 boxes of 1/6 to 1/2 of the image side with
    classes in range, brightened in both modalities."""
    h, w, c = geometry.height, geometry.width, geometry.event_channels
    out = []
    for i in range(num):
        rng = np.random.default_rng([seed, i])
        rgb = rng.standard_normal((h, w, 3), dtype=np.float32)
        event = rng.standard_normal((h, w, c), dtype=np.float32)
        k = int(rng.integers(1, 4))
        annot = np.zeros((k, 5), np.float32)
        for j in range(k):
            bw = int(rng.integers(w // 6, w // 2 + 1))
            bh = int(rng.integers(h // 6, h // 2 + 1))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            annot[j] = [x1, y1, x1 + bw, y1 + bh, rng.integers(0, geometry.num_classes)]
            rgb[y1:y1 + bh, x1:x1 + bw] += 1.0
            event[y1:y1 + bh, x1:x1 + bw] += 1.0
        out.append({"rgb": rgb, "event": event, "annot": annot})
    return out


def _draw_scene(rng, geo: DatasetGeometry, num_boxes: int):
    """Random bright rectangles on a dark background; returns (img u8 HWC, boxes)."""
    img = (rng.uniform(0, 40, (geo.height, geo.width, 3))).astype(np.uint8)
    boxes = []
    for _ in range(num_boxes):
        bw = int(rng.integers(24, max(32, geo.width // 4)))
        bh = int(rng.integers(24, max(32, geo.height // 4)))
        x1 = int(rng.integers(0, geo.width - bw))
        y1 = int(rng.integers(0, geo.height - bh))
        cls = int(rng.integers(0, geo.num_classes))
        color = [int(rng.integers(120, 255)) for _ in range(3)]
        img[y1: y1 + bh, x1: x1 + bw] = color
        boxes.append((x1, y1, x1 + bw, y1 + bh, cls))
    return img, boxes


def _events_for_boxes(rng, geo, boxes, n_events=4000, t0=1_000_000, dt=50_000):
    """Synthetic event stream: events cluster on box edges (moving-object proxy)."""
    xs, ys = [], []
    for (x1, y1, x2, y2, _) in boxes:
        k = n_events // max(len(boxes), 1)
        edge = rng.integers(0, 4, k)
        ex = rng.integers(x1, x2, k)
        ey = rng.integers(y1, y2, k)
        ex = np.where(edge == 0, x1, np.where(edge == 1, x2 - 1, ex))
        ey = np.where(edge == 2, y1, np.where(edge == 3, y2 - 1, ey))
        xs.append(ex)
        ys.append(ey)
    if not xs:
        xs, ys = [rng.integers(0, geo.width, n_events)], [rng.integers(0, geo.height, n_events)]
    x = np.concatenate(xs).astype(np.uint16)
    y = np.concatenate(ys).astype(np.uint16)
    t = np.sort(rng.integers(t0, t0 + dt, len(x))).astype(np.int64)
    p = rng.integers(0, 2, len(x)).astype(np.uint8)
    return x, y, t, p


def make_csv_fixture(
    root: str,
    geometry: DatasetGeometry = DSEC,
    num_images: int = 8,
    boxes_per_image: Tuple[int, int] = (1, 3),
    seed: int = 0,
    sequence: str = "synthetic_seq_00",
) -> dict:
    """Create a CSV-labels benchmark at ``root``. Returns a dict of its paths.

    Layout (DSEC schema):
      events/<seq>/left/<frame>.npz        pre-voxelized (C,H,W)
      images/<seq>/images/left/rectified/<frame>.png
      labels_{map,test}.csv
    DDD17 schema: events/<rel>.npz, images/<rel>.png with rel = <seq>/<frame>.
    """
    rng = np.random.default_rng(seed)
    geo = geometry
    event_dir = os.path.join(root, "events")
    img_dir = os.path.join(root, "images")
    os.makedirs(event_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    rows = []
    for i in range(num_images):
        frame = f"{i:06d}"
        img, boxes = _draw_scene(rng, geo, int(rng.integers(*boxes_per_image)))
        x, y, t, p = _events_for_boxes(rng, geo, boxes)
        voxel = voxelize_events_np(
            x.astype(np.int64), y.astype(np.int64), t, p,
            num_bins=geo.event_channels, height=geo.height, width=geo.width,
        )

        if geo.name == "dsec":
            rel = f"{sequence}/left/{frame}.npz"
            png = os.path.join(img_dir, sequence, "images/left/rectified", frame + ".png")
        else:
            rel = f"{sequence}/{frame}.npz"
            png = os.path.join(img_dir, sequence, frame + ".png")

        npz_path = os.path.join(event_dir, rel)
        os.makedirs(os.path.dirname(npz_path), exist_ok=True)
        os.makedirs(os.path.dirname(png), exist_ok=True)
        np.savez(npz_path, voxel.astype(np.float32))
        image_io.imwrite(png, img)

        if boxes:
            for (x1, y1, x2, y2, c) in boxes:
                rows.append(f"{rel},{x1},{y1},{x2},{y2},{geo.class_names[c]}")
        else:
            rows.append(f"{rel},,,,,")

    ann_csv = os.path.join(root, "labels_test.csv")
    with open(ann_csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    map_csv = os.path.join(root, "labels_map.csv")
    with open(map_csv, "w") as f:
        f.write("\n".join(f"{n},{i}" for i, n in enumerate(geo.class_names)) + "\n")

    return dict(
        root=root, annotations_csv=ann_csv, class_map_csv=map_csv,
        event_dir=event_dir, img_dir=img_dir,
    )


def make_dsec_det_fixture(
    root: str,
    num_sequences: int = 2,
    frames_per_sequence: int = 6,
    seed: int = 0,
    geometry: DatasetGeometry = DSEC,
) -> str:
    """Create a raw DSEC-Det-layout fixture at ``root``, one sequence
    ``synthetic_NN`` after another:
      <root>/<seq>/images/left/rectified/NNNNNN.png
      <root>/<seq>/images/timestamps.txt
      <root>/<seq>/events/left/events_2x.h5
      <root>/<seq>/object_detections/left/tracks.npy  (structured array)
    Two tracked objects (a car and a pedestrian) drift right by 4 px a
    frame, 100 ms apart; each frame's 100 ms before it hold 3,000 events on
    the boxes' edges.
    """
    rng = np.random.default_rng(seed)
    geo = geometry
    dtype = np.dtype(
        [
            ("t", "<i8"), ("x", "<f4"), ("y", "<f4"), ("w", "<f4"), ("h", "<f4"),
            ("class_id", "<u1"), ("class_confidence", "<f4"), ("track_id", "<i4"),
        ]
    )
    for s in range(num_sequences):
        seq = f"synthetic_{s:02d}"
        seq_dir = os.path.join(root, seq)
        img_dir = os.path.join(seq_dir, "images/left/rectified")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(os.path.join(seq_dir, "events/left"), exist_ok=True)
        os.makedirs(os.path.join(seq_dir, "object_detections/left"), exist_ok=True)

        t0 = 10_000_000
        dt = 100_000  # 100 ms between frames
        timestamps = [t0 + i * dt for i in range(frames_per_sequence)]

        track_rows = []
        all_x, all_y, all_t, all_p = [], [], [], []
        objs = []
        max_w = max(geo.width // 4, 24)
        max_h = max(geo.height // 4, 24)
        for k in range(2):
            bw = int(rng.integers(max_w // 2, max_w))
            bh = int(rng.integers(max_h // 2, max_h))
            x1 = int(rng.integers(0, max(geo.width - bw - frames_per_sequence * 4, 1)))
            y1 = int(rng.integers(0, max(geo.height - bh, 1)))
            # DSEC class ids of the tracks: 2 = car, 0 = pedestrian
            objs.append([x1, y1, bw, bh, 2 if k == 0 else 0])

        for i, ts in enumerate(timestamps):
            img = (rng.uniform(0, 40, (geo.height, geo.width, 3))).astype(np.uint8)
            boxes = []
            for tid, (x1, y1, bw, bh, cid) in enumerate(objs):
                x = x1 + 4 * i
                img[y1: y1 + bh, x: x + bw] = 200
                track_rows.append((ts, float(x), float(y1), float(bw), float(bh), cid, 1.0, tid))
                boxes.append((x, y1, x + bw, y1 + bh, 0))
            image_io.imwrite(os.path.join(img_dir, f"{i:06d}.png"), img)
            ex, ey, et, ep = _events_for_boxes(rng, geo, boxes, n_events=3000, t0=ts - dt, dt=dt)
            all_x.append(ex), all_y.append(ey), all_t.append(et), all_p.append(ep)

        with open(os.path.join(seq_dir, "images/timestamps.txt"), "w") as f:
            f.write("\n".join(str(t) for t in timestamps) + "\n")
        tracks = np.array(track_rows, dtype=dtype)
        np.save(os.path.join(seq_dir, "object_detections/left/tracks.npy"), tracks)
        write_event_h5(
            os.path.join(seq_dir, "events/left/events_2x.h5"),
            np.concatenate(all_x), np.concatenate(all_y),
            np.concatenate(all_t), np.concatenate(all_p),
            t_offset=t0 - dt,
        )
    return root
