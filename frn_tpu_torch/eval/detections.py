"""Batched detection extraction for evaluation.

Counterpart of ``frn_tpu/eval/detections.py``: one call per batch runs the
forward, the decode, the clip and the class-wise NMS on the device and
returns fixed-size top-k detections; the host only slices the valid rows and
buckets them per class, in place of the reference's per-image host loop
(_get_detections, csv_eval.py:66-131).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from frn_tpu_torch.config import FrameworkConfig
from frn_tpu_torch.data.loader import BatchLoader, device_prefetch
from frn_tpu_torch.entry import InferenceFn, replica_detections
from frn_tpu_torch.ops.voxelize import wire_model_inputs
from frn_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch

WIRES = ("f32", "compact")


class EvalInferenceFn(InferenceFn):
    """(rgb, event) -> (scores (B, M), labels (B, M), boxes (B, M, 4)) on the
    model's device, with the input wire's dtype guards and, on the 'compact'
    wire, the input normalization on the device."""

    def __init__(self, model, config: FrameworkConfig, wire: str = "f32",
                 rgb_standardize: bool = False):
        super().__init__(model, config)
        self.wire = wire
        self.rgb_standardize = rgb_standardize

    @torch.inference_mode()
    def __call__(self, rgb: torch.Tensor, event: torch.Tensor):
        return super().__call__(*self.inputs(rgb, event))

    @torch.inference_mode()
    def inputs(self, rgb: torch.Tensor, event: torch.Tensor):
        """The model's f32 (rgb, event) of a batch on the wire."""
        # a compact-wire batch fed to the f32 wire (or the reverse) would run
        # raw [0, 255] uint8 through the model, or divide [0, 1] floats by 255
        # again: both raise
        if self.wire == "compact":
            if rgb.dtype != torch.uint8 or event.dtype != torch.int8:
                raise TypeError(
                    f"wire='compact' expects uint8 RGB + int8 event voxels, got "
                    f"rgb={rgb.dtype} event={event.dtype}: pass a compact-wire "
                    "dataset or use wire='f32'")
            rgb, event = wire_model_inputs("compact", self.config.geometry, (rgb, event),
                                           standardize=self.rgb_standardize)
        elif not (rgb.is_floating_point() and event.is_floating_point()):
            raise TypeError(
                f"wire='f32' got integer inputs (rgb={rgb.dtype}, event={event.dtype}): "
                "this looks like a compact-wire dataset; pass wire='compact' to "
                "make_inference_fn")
        return rgb, event


class MeshInferenceFn:
    """Data-parallel evaluation over a ``Mesh``: one ``EvalInferenceFn`` per
    replica (its weights and anchors on its device). A batch is split into
    the mesh's row blocks (``shard_batch``); each replica runs the wire's
    decode, the forward, the decode and the NMS on its block, on its device
    (``entry.replica_detections``). The rows come back in batch order,
    gathered on the first device."""

    def __init__(self, model, config: FrameworkConfig, mesh: Mesh, wire: str,
                 rgb_standardize: bool):
        self.mesh = mesh
        self.config = config
        self.replicas = [EvalInferenceFn(m, config, wire, rgb_standardize)
                         for m in replicate(model, mesh)]
        self.device = mesh.devices[0]

    @torch.inference_mode()
    def __call__(self, rgb, event):
        """``rgb`` and ``event``: whole-batch tensors (any device; their batch
        must divide over the mesh), or ``shard_batch``'s lists of row blocks,
        block i on device i (``device_prefetch(mesh=...)`` gives those)."""
        if isinstance(rgb, torch.Tensor):
            blocks = shard_batch({"rgb": rgb, "event": event}, self.mesh)
            rgb, event = blocks["rgb"], blocks["event"]
        rows = replica_detections(self.replicas, zip(rgb, event),
                                  lambda fn, part: fn.inputs(*part))
        return tuple(torch.cat([r[k].to(self.device, non_blocking=True) for r in rows])
                     for k in range(3))


def make_inference_fn(
    model,
    config: FrameworkConfig,
    mesh=None,
    wire: str = "f32",
    rgb_standardize: bool = False,
    input_format: str = "default",
) -> EvalInferenceFn:
    """(rgb, event) -> (scores (B, M), labels (B, M) int32, boxes (B, M, 4)),
    on the device of ``model`` (built by ``init_detector``, its weights loaded).

    ``wire='compact'`` moves the input normalization onto the device: batches
    arrive as uint8 RGB [0..255] + int8 raw polarity-count voxels, and the
    device applies /255 (and the dataset standardization iff
    ``rgb_standardize``) and the per-sample conditional tanh voxel squash
    (dsec_data.py:461-462 semantics); int8 clipping at +-127 is exact through
    the tanh saturation. ``wire='f32'`` takes the dataset's normalized floats.

    With ``mesh`` (``parallel.make_mesh``) inference is data-parallel over
    the mesh's devices (``MeshInferenceFn``): one replica of the model on
    each, every batch split into row blocks; the batch must divide over the
    mesh (it raises ``ValueError`` otherwise). Each image's postprocess is
    independent of the others', so the detections are the single device's.

    Not ported: ``input_format='auto'`` raises: it lets XLA choose the
    arguments' memory layouts, a compiler feature with no PyTorch
    counterpart.
    """
    if wire not in WIRES:
        raise ValueError(f"unknown wire {wire!r}")
    if input_format not in ("default", "auto"):
        raise ValueError(f"unknown input_format {input_format!r}")
    if input_format == "auto":
        raise NotImplementedError(
            "input_format='auto' is an XLA argument-layout feature with no PyTorch counterpart")
    if mesh is not None:
        return MeshInferenceFn(model, config, mesh, wire, rgb_standardize)
    return EvalInferenceFn(model, config, wire, rgb_standardize)


def _rows_to_host(scores, labels, boxes) -> np.ndarray:
    """(B, M, 6) f32 [x1, y1, x2, y2, score, label] in one device -> host copy
    (the labels, small ints, are exact in f32)."""
    rows = torch.cat([boxes.float(), scores.float()[..., None], labels.float()[..., None]], dim=2)
    return rows.cpu().numpy()


def collect_detections(
    dataset,
    infer_fn: Callable,
    config: FrameworkConfig,
    batch_size: int = 8,
    num_threads: int = 8,
    max_detections: Optional[int] = None,
    verbose: bool = False,
) -> Tuple[List[List[np.ndarray]], float]:
    """Run the detector over a dataset.

    Returns (all_detections[image][class] -> (n,5) [x1,y1,x2,y2,score], elapsed_s).
    Detections are score-sorted (the device top-k emits descending order),
    matching the reference's per-image sort + top-100 (csv_eval.py:109-119).
    Batches are loaded by ``BatchLoader``'s threads and copied to
    ``infer_fn.device`` (the CPU if it has none) by ``device_prefetch``, two
    ahead, or split over ``infer_fn.mesh`` where it has one; each batch's
    count of real images stays on the host, and its detections come back in
    one host copy.
    """
    num_classes = dataset.num_classes()
    cap = max_detections or config.eval.max_detections
    thr = config.eval.score_threshold
    device = getattr(infer_fn, "device", torch.device("cpu"))
    mesh = getattr(infer_fn, "mesh", None)

    loader = BatchLoader(
        dataset, config.geometry, batch_size=batch_size, shuffle=False,
        num_threads=num_threads, max_annots=1,
    )

    all_detections: List[List[np.ndarray]] = [
        [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
        for _ in range(len(dataset))
    ]

    n_valid: collections.deque = collections.deque()  # per batch, in the loader's order

    def host_batches():
        for batch in loader:
            n_valid.append(int(batch["sample_mask"].sum()))
            yield {"rgb": batch["rgb"], "event": batch["event"]}

    t0 = time.perf_counter()
    index = 0
    for batch in device_prefetch(host_batches(), size=2, device=device, mesh=mesh):
        rows = _rows_to_host(*infer_fn(batch["rgb"], batch["event"]))
        for b in range(n_valid.popleft()):
            keep = rows[b, :, 4] > thr
            r = rows[b][keep][:cap]
            dets, labels = r[:, :5], r[:, 5]
            for c in range(num_classes):
                all_detections[index][c] = np.ascontiguousarray(dets[labels == c])
            index += 1
            if verbose and index % 100 == 0:
                print(f"{index}/{len(dataset)}", end="\r")
    elapsed = time.perf_counter() - t0
    return all_detections, elapsed


def collect_annotations(dataset) -> List[List[np.ndarray]]:
    """Ground truth per image per class (csv_eval.py _get_annotations)."""
    num_classes = dataset.num_classes()
    out = []
    for i in range(len(dataset)):
        ann = dataset.load_annotations(i)
        out.append([ann[ann[:, 4] == c, :4].copy() for c in range(num_classes)])
    return out
