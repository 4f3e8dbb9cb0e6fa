"""Serving engine: request batching over a ladder of batch sizes.

Counterpart of ``frn_tpu/serve/engine.py``. The reference's only serving path
is ``visulize_fusion.py:47-131`` (detect_image): one image, a batch-1
forward, a host filter at score > 0.5; no batching, no concurrency, no
latency accounting. This engine serves the same detector to many concurrent
clients:

  * **Batch buckets**: a ladder of batch sizes (default 1/2/4/8/16). A
    burst of k requests runs at the smallest bucket >= k, padded with zeros;
    the per-image postprocess (decode + class-wise NMS, ``core/nms.py``) is
    independent of the other images, so padding does not change a real
    request's detections (held on the CPU by ``tests/test_torch_serve.py``).
    ``warmup()`` runs every bucket once, so the kernels are built and
    cuDNN's algorithms chosen before the first request.
  * **Bounded batching delay**: the dispatcher coalesces requests for at
    most ``max_delay_ms`` (0 = take what is queued and go).
  * **One dispatcher thread, a completer thread**: the dispatcher stages a
    batch in pinned host memory, copies it to the card without blocking,
    enqueues the device program and a non-blocking copy of its (B, M, 6)
    result rows back into pinned memory, records a CUDA event and goes on to
    the next batch. A completer thread waits on that event alone (never on
    the whole stream, which would also wait for the batches queued after
    it), then thresholds each request's rows and resolves its future.
    ``pipeline_depth`` bounds the batches waiting for the completer. The
    overlap this allows is not reached yet: the NMS's greedy fixpoint
    (``core/nms.py``) reads a flag on the host every iteration, so the
    dispatcher waits out each batch's forward inside the device program and
    stages the next batch only after it (measured on the card: PERF.md, the
    serving findings).
  * **Wire formats** (``ServeOptions.wire_format``): what crosses the
    host -> device link per request; every format but 'f32' is normalized
    on the device.
  * **Host postprocess per request**: the serving score threshold
    (``visulize_fusion.py:105`` uses 0.5) and the detection cap.

Staging buffers: on the card each batch is written into one of
``pipeline_depth + 1`` slots of pinned host buffers (sized for the largest
bucket), in turn. A slot's copy to the card records an event, and the
dispatcher waits on that event before it writes into the slot again, so no
buffer is refilled while its copy is in flight.

Data parallelism (``mesh``, ``parallel.make_mesh``): one replica of the
model on each device of the mesh, and every batch split into the mesh's row
blocks (every bucket must divide over the mesh). A slot's row blocks are
copied each to its replica's card; each replica runs ``device_program``'s
work on its block; its rows come back by one non-blocking copy into pinned
memory with one CUDA event, and the completer waits on every replica's. The
dispatcher enqueues every replica's launches from its one thread.

Nothing falls back: a kernel that fails to build or launch, a fault on the
card, or an engine without the card raises, into every waiting future. The
engine runs on the device of the model's parameters; the CPU only when the
model was built there (``device='cpu'``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from frn_tpu_torch.config import DatasetGeometry, FrameworkConfig
from frn_tpu_torch.device import on_device
from frn_tpu_torch.entry import InferenceFn, replica_detections
from frn_tpu_torch.ops.voxelize import wire_model_inputs
from frn_tpu_torch.parallel.mesh import replicate, row_blocks

WIRE_FORMATS = ("f32", "compact", "events", "sparse")
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32}


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Serving knobs (orthogonal to EvalConfig, which defines record-run eval)."""

    # Batch-size ladder, ascending.
    buckets: Tuple[int, ...] = (1, 2, 4, 8, 16)
    # Max time the dispatcher waits to coalesce a batch once it holds >= 1
    # request. 0 = never wait (lowest latency); a few ms trades latency for
    # throughput under load.
    max_delay_ms: float = 2.0
    # Serving score threshold (reference: visulize_fusion.py:105 uses 0.5;
    # eval record runs use EvalConfig.score_threshold=0.05).
    score_threshold: float = 0.5
    # Cap on detections returned per request (None = EvalConfig.max_detections).
    max_detections: Optional[int] = None
    # Bound on queued requests; submit raises queue.Full beyond it so overload
    # fails fast instead of growing latency without bound.
    max_queue: int = 256
    # Batches dispatched and waiting for the completer before the dispatcher
    # blocks: the device computes batch k+1 while batch k's results come back.
    # 1 = one batch at a time.
    pipeline_depth: int = 2
    # Wire format of request tensors crossing the host->device link:
    #   'f32'     — pre-normalized float32 (standardized RGB + tanh voxel),
    #               exactly the eval pipeline's tensors. 9.8 MB/request at DSEC
    #               geometry.
    #   'compact' — uint8 RGB [0..255] + int8 raw polarity-count voxel; the
    #               normalization runs on the device (u8/255 then the
    #               dataset standardization; the per-sample tanh squash,
    #               which saturates to 1.0f long before the int8 clip at
    #               ±127 can differ from unclipped counts). 2.5 MB/request.
    #               Voxel-count events only (int8 rounding would destroy
    #               e2vid grayscale 'gray' inputs).
    #   'events'  — the raw sensor stream: uint8 RGB + x/y (int16), t (int32,
    #               window-relative), p (int8), padded to `event_capacity`;
    #               voxelization, the tanh squash and the RGB standardization
    #               all run on the device (~1.5 MB/request at 64k capacity).
    #               Requests come through submit_events.
    #   'sparse'  — delta-coded nonzero voxel cells (uint16 gap + int8 count,
    #               3 B/cell; ops/voxelize.sparse_cells_from_voxel_np), decoded
    #               on the device by a running sum and a scatter-add. Exact
    #               for any count magnitude (|count| > 127 splits across
    #               repeated cells); size it with cell_capacity.
    wire_format: str = "compact"
    # 'events' wire format: static per-request event slots; streams beyond
    # capacity are truncated to the window's FIRST `event_capacity` events
    # (counted in stats()['truncated_events']).
    event_capacity: int = 65536
    # 'sparse' wire format: static per-request cell slots; encodings beyond
    # capacity drop TRAILING cells (counted in stats()['truncated_cells']).
    cell_capacity: int = 24576


def wire_layout(geo: DatasetGeometry, options: ServeOptions) -> List[Tuple[tuple, np.dtype]]:
    """(per-request shape, dtype) of each array one request ships over the
    wire, RGB first (the events wire: RGB, x, y, t, p, num_valid; the sparse
    wire: RGB, deltas, counts)."""
    wire = options.wire_format
    rgb = ((geo.height, geo.width, 3), np.dtype(np.float32 if wire == "f32" else np.uint8))
    if wire == "events":
        cap = options.event_capacity
        return [rgb, ((cap,), np.dtype(np.int16)), ((cap,), np.dtype(np.int16)),
                ((cap,), np.dtype(np.int32)), ((cap,), np.dtype(np.int8)), ((), np.dtype(np.int32))]
    if wire == "sparse":
        cap = options.cell_capacity
        return [rgb, ((cap,), np.dtype(np.uint16)), ((cap,), np.dtype(np.int8))]
    event = (geo.height, geo.width, geo.event_channels)
    return [rgb, (event, np.dtype(np.float32 if wire == "f32" else np.int8))]


def wire_tensors(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Host wire arrays -> tensors on ``device`` (uint16 as the int16 of the
    same bits)."""
    return [torch.from_numpy(a.view(_signed(a.dtype))).to(device) for a in arrays]


def request_wire_bytes(geo: DatasetGeometry, options: ServeOptions) -> int:
    """Bytes one request moves host -> device on ``options.wire_format``."""
    return sum(int(np.prod(shape, dtype=np.int64)) * dt.itemsize
               for shape, dt in wire_layout(geo, options))


@dataclasses.dataclass
class Request:
    """One queued request, in its wire format."""

    rgb: np.ndarray
    event: object  # voxel (f32/compact), (deltas, counts) (sparse) or (x, y, t, p, n) (events)
    future: Future
    t_submit: float


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One dispatched batch, as ``ServingEngine.batch_records`` keeps it."""

    requests: Tuple[Request, ...]
    bucket: int
    t_dispatch: float  # time.perf_counter() when the dispatcher took the batch
    stage_ms: float  # the dispatcher's host ms to stage the batch on the device
    host_ms: float  # the dispatcher's host ms for the whole batch: staging,
    # launches and any wait on the device inside the device program


@dataclasses.dataclass(frozen=True)
class Detections:
    """Per-request result: valid rows only, score-descending."""

    scores: np.ndarray  # (n,) float32
    labels: np.ndarray  # (n,) int32
    boxes: np.ndarray  # (n, 4) float32 [x1, y1, x2, y2]
    latency_ms: float  # submit -> result, host wall clock
    batch_size: int  # bucket the request rode in

    def to_json(self, class_names: Sequence[str] = ()) -> List[Dict]:
        out = []
        for s, l, b in zip(self.scores, self.labels, self.boxes):
            d = {"score": float(s), "class_id": int(l), "box": [float(v) for v in b]}
            if class_names:
                d["class"] = class_names[int(l)]
            out.append(d)
        return out


class _Slot:
    """Pinned host buffers for one batch in flight, sized for the largest
    bucket, and the events of their last copies to the cards."""

    def __init__(self, layout, rows: int):
        self.tensors = [torch.empty((rows, *shape), dtype=_TORCH_DTYPES[_signed(dt)],
                                    pin_memory=True) for shape, dt in layout]
        self.arrays = [t.numpy().view(dt) for t, (_, dt) in zip(self.tensors, layout)]
        self.copied: List[torch.cuda.Event] = []


def _signed(dt: np.dtype) -> np.dtype:
    """uint16 travels as the int16 of the same bits (the device takes
    ``& 0xFFFF`` after widening)."""
    return np.dtype(np.int16) if dt == np.uint16 else dt


class ServingEngine:
    """Threaded request-batching inference engine over one model.

    Usage:
        engine = ServingEngine(model, config)    # model from init_detector
        engine.start(); engine.warmup()
        dets = engine.infer(rgb, event)          # sync
        fut = engine.submit(rgb, event)          # async -> Future[Detections]
        engine.stop()

    Also usable as a context manager (start/stop).
    """

    def __init__(
        self,
        model,
        config: FrameworkConfig,
        options: ServeOptions = ServeOptions(),
        mesh=None,
    ):
        """``model``: an ``FRNDetector`` with its weights loaded, on the device
        to serve from. ``mesh``: serve replicas of it, one on each device of
        the mesh, every batch split over them (each bucket a multiple of the
        mesh's size); per-image postprocess independence makes each
        request's detections the single device's."""
        if not options.buckets or list(options.buckets) != sorted(set(options.buckets)):
            raise ValueError(f"buckets must be ascending and unique: {options.buckets}")
        if mesh is not None:
            nd = mesh.shape["data"]
            bad = [b for b in options.buckets if b % nd]
            if bad:
                raise ValueError(
                    f"buckets {bad} not divisible by the mesh data axis ({nd})"
                )
        if options.wire_format not in WIRE_FORMATS:
            raise ValueError(f"unknown wire_format {options.wire_format!r}")
        if options.wire_format != "f32" and config.geometry.event_channels == 1:
            # 'gray' e2vid inputs are [0,1] floats, not polarity counts
            raise ValueError(
                f"wire_format={options.wire_format!r} requires voxel-count events"
            )
        self.config = config
        self.options = options
        self.mesh = mesh
        # one inference function a replica; the first is the engine's device
        self.replica_fns = [InferenceFn(m, config)
                            for m in (replicate(model, mesh) if mesh is not None else [model])]
        self.infer_fn = self.replica_fns[0]
        self.device = self.infer_fn.device
        self._layout = wire_layout(config.geometry, options)
        self._slots: List[_Slot] = []  # pinned staging on the card, made by start()
        self._next_slot = 0

        self._queue: "queue.Queue[Optional[Request]]" = queue.Queue(
            maxsize=options.max_queue
        )
        # dispatched batches awaiting the completer; bounds device memory to
        # pipeline_depth result sets
        self._inflight: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=max(1, options.pipeline_depth)
        )
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._stopping = threading.Event()

        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_padded_slots = 0
        self._n_truncated_events = 0
        self._n_truncated_cells = 0
        self._latencies_ms: "list[float]" = []  # bounded reservoir, newest-last
        self._t_start = None
        self._records: Optional[List[BatchRecord]] = None  # kept after record_batches()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stopping.clear()
        if self.device.type == "cuda" and not self._slots:
            # hundreds of MB of pinned memory at the f32 wire: allocated here,
            # not in the first request's latency
            self._slots = [_Slot(self._layout, self.options.buckets[-1])
                           for _ in range(max(1, self.options.pipeline_depth) + 1)]
        self._t_start = time.perf_counter()
        self._completer = threading.Thread(target=self._complete_loop, daemon=True)
        self._completer.start()
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        if self._thread is None:
            return
        self._stopping.set()
        # wake the dispatcher; if the queue is momentarily full the dispatcher
        # is draining it, so retry rather than block forever
        while self._thread.is_alive():
            try:
                self._queue.put(None, timeout=0.1)
                break
            except queue.Full:
                continue
        self._thread.join(timeout=timeout)
        self._thread = None
        if self._completer is not None:
            self._inflight.put(None)  # after dispatcher exit: nothing else enqueues
            self._completer.join(timeout=timeout)
            self._completer = None
        # fail any requests still queued after shutdown
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.future.set_exception(RuntimeError("engine stopped"))

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @torch.inference_mode()
    def model_inputs(self, *tensors: torch.Tensor):
        """A batch of wire tensors on the device -> the model's f32 (rgb,
        voxel), NHWC: the wire's decode and normalization, exactly the host
        pipeline's arithmetic (dataloader.py:522-534 RGB standardization,
        dsec_data.py:347-387 voxelization, :461-462 tanh squash;
        ``ops/voxelize.wire_model_inputs``, always standardizing)."""
        return wire_model_inputs(self.options.wire_format, self.config.geometry, tensors)

    @torch.inference_mode()
    def device_program(self, *tensors):
        """``model_inputs``, then the forward, the pooled decode and the NMS
        -> (scores, labels, boxes) of every row of the batch.

        Over a mesh each replica runs them on its row block, on its device
        (``entry.replica_detections``). ``tensors`` are then whole
        batches (on any device; the rows come back gathered in order on the
        engine's device) or lists of row blocks, block i on replica i's
        device (each output then a list of the replicas' blocks)."""
        if self.mesh is None:
            return self.infer_fn(*self.model_inputs(*tensors))
        blocked = isinstance(tensors[0], (list, tuple))
        if not blocked:
            tensors = self._blocks(tensors)
        results = replica_detections(self.replica_fns, zip(*tensors),
                                     lambda fn, part: self.model_inputs(*part))
        if blocked:
            return tuple(list(x) for x in zip(*results))
        return tuple(torch.cat([r[k].to(self.device) for r in results]) for k in range(3))

    def _blocks(self, tensors: Sequence[torch.Tensor], copy: bool = True) -> List[list]:
        """Whole-batch wire tensors as lists of the mesh's row blocks, each
        moved to its replica's device unless ``copy`` is false."""
        rows = row_blocks(tensors[0].shape[0], self.mesh.size)
        return [[t[r].to(fn.device, non_blocking=True) if copy else t[r]
                 for fn, r in zip(self.replica_fns, rows)] for t in tensors]

    def warmup(self) -> None:
        """Run every bucket once ahead of traffic (zero inputs made on the
        device): the kernels are built and cuDNN's algorithms chosen."""
        for b in self.options.buckets:
            arrays = [torch.zeros((b, *shape), dtype=_TORCH_DTYPES[_signed(dt)],
                                  device=self.device) for shape, dt in self._layout]
            scores, _, _ = self.device_program(*arrays)
            scores.cpu()  # waits for the batch

    # -- request API ---------------------------------------------------------

    def _to_wire(self, rgb: np.ndarray, event: np.ndarray):
        """Coerce one request's tensors to the engine's wire format.

        'f32': pre-normalized float32 pass-through (eval-pipeline tensors).
        'compact': RGB as uint8 0..255 (floats in [0,1] are u8-quantized —
        exact when the float came from a u8 image /255, the reference's own
        source, visulize_fusion.py:60); events as int8 raw polarity counts,
        clipped to ±127 (exact through tanh saturation, see ServeOptions).
        """
        if self.options.wire_format == "f32":
            return np.asarray(rgb, np.float32), np.asarray(event, np.float32)
        rgb = self._rgb_to_u8(rgb)
        if self.options.wire_format == "events":
            return rgb, event  # event is the (x, y, t, p, n) tuple, pre-packed
        if self.options.wire_format == "sparse":
            from frn_tpu_torch.ops.voxelize import sparse_cells_from_voxel_np

            # submit() takes the HWC count voxel; encode to delta cells here
            deltas, counts, _, dropped = sparse_cells_from_voxel_np(
                np.transpose(np.asarray(event, np.float32), (2, 0, 1)),
                self.options.cell_capacity,
            )
            if dropped:
                with self._lock:
                    self._n_truncated_cells += dropped
            return rgb, (deltas, counts)
        event = np.clip(np.rint(np.asarray(event, np.float32)), -127, 127).astype(
            np.int8
        )
        return rgb, event

    def _rgb_to_u8(self, rgb: np.ndarray) -> np.ndarray:
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.asarray(rgb, np.float32)
            if rgb.size and rgb.max() > 1.0 + 1e-6:
                raise ValueError(
                    f"{self.options.wire_format} wire format wants uint8 RGB "
                    f"(or floats in [0,1]); got float data with max {rgb.max():.3f}"
                )
            rgb = np.rint(rgb * 255.0).astype(np.uint8)
        return rgb

    def submit(self, rgb: np.ndarray, event: np.ndarray) -> "Future[Detections]":
        """Enqueue one image. Thread-safe. Raises queue.Full on overload.

        Expected tensors depend on ServeOptions.wire_format: 'compact' (default)
        takes RAW inputs — uint8 RGB and a raw polarity-count voxel grid —
        normalized on device; 'f32' takes pre-normalized eval-pipeline tensors;
        'events' servers take no voxel grids at all — use submit_events.
        """
        if self._thread is None:
            raise RuntimeError("engine not started")
        if self.options.wire_format == "events":
            raise ValueError(
                "wire_format='events' serves raw streams; use submit_events"
            )
        geo = self.config.geometry
        want_ev = (geo.height, geo.width, geo.event_channels)
        if np.shape(event) != want_ev:
            raise ValueError(f"event shape {np.shape(event)} != {want_ev}")
        rgb, event = self._to_wire(rgb, event)
        if rgb.shape != (geo.height, geo.width, 3):
            raise ValueError(f"rgb shape {rgb.shape} != {(geo.height, geo.width, 3)}")
        fut: Future = Future()
        self._queue.put_nowait(Request(rgb, event, fut, time.perf_counter()))
        return fut

    def submit_events(
        self,
        x: np.ndarray,
        y: np.ndarray,
        t: np.ndarray,
        p: np.ndarray,
        rgb: np.ndarray,
        normalize: bool = True,
    ) -> "Future[Detections]":
        """Full serving path: raw event stream + raw [0,1] RGB -> detections.

        On the 'events' wire the stream is packed and voxelized on the device
        (``voxelize_events_batched``); on the other wires it is voxelized on
        the host (``voxelize_events_np``) with the reference's nearest-bin
        semantics (dsec_data.py:347-387) and, on the 'f32' wire, normalized
        there too (tanh squash, dsec_data.py:461-462; RGB standardized with
        the dataset constants).
        """
        geo = self.config.geometry
        if self.options.wire_format == "events":
            if self._thread is None:
                raise RuntimeError("engine not started")
            x = np.asarray(x)
            y = np.asarray(y)
            t = np.asarray(t, np.int64)
            p = np.asarray(p)
            n = int(x.shape[0])
            cap = self.options.event_capacity
            if n > cap:
                # keep the window's first `cap` events; note: the truncated
                # window's time span shrinks to the kept prefix
                with self._lock:
                    self._n_truncated_events += n - cap
                x, y, t, p = x[:cap], y[:cap], t[:cap], p[:cap]
                n = cap
            ex = np.zeros(cap, np.int16)
            ey = np.zeros(cap, np.int16)
            et = np.zeros(cap, np.int32)
            ep = np.zeros(cap, np.int8)
            # clip before the int16 cast so out-of-sensor coordinates stay
            # invalid (the device voxelizer masks x/y outside the frame)
            # instead of wrapping back into range
            ex[:n] = np.clip(x, -1, geo.width)
            ey[:n] = np.clip(y, -1, geo.height)
            if n:
                et[:n] = t - t[0]  # window-relative: always fits int32
            ep[:n] = p[:n] > 0
            rgb = self._rgb_to_u8(rgb)
            if rgb.shape != (geo.height, geo.width, 3):
                raise ValueError(
                    f"rgb shape {rgb.shape} != {(geo.height, geo.width, 3)}"
                )
            fut: Future = Future()
            self._queue.put_nowait(
                Request(rgb, (ex, ey, et, ep, int(n)), fut, time.perf_counter())
            )
            return fut

        from frn_tpu_torch.ops.voxelize import voxelize_events_np

        voxel = voxelize_events_np(
            np.asarray(x), np.asarray(y), np.asarray(t), np.asarray(p),
            num_bins=geo.event_channels, height=geo.height, width=geo.width,
        )
        voxel = np.transpose(voxel, (1, 2, 0))
        if self.options.wire_format in ("compact", "sparse"):
            # raw counts + [0,1]/uint8 RGB go over the wire (sparse: as
            # delta-coded nonzero cells); the device program applies the
            # identical normalization (see model_inputs)
            return self.submit(rgb, voxel)
        from frn_tpu_torch.data.transforms import normalize_rgb
        from frn_tpu_torch.ops.voxelize import normalize_event_voxel_np

        voxel = normalize_event_voxel_np(voxel)  # elementwise + global max: layout-free
        if normalize:
            rgb = normalize_rgb(np.asarray(rgb), geo)
        return self.submit(rgb, voxel)

    def infer(self, rgb: np.ndarray, event: np.ndarray, timeout: Optional[float] = None) -> Detections:
        return self.submit(rgb, event).result(timeout=timeout)

    # -- dispatcher ----------------------------------------------------------

    def _take_batch(self) -> List[Request]:
        """Block for the first request, then coalesce up to max_delay_ms."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        max_bucket = self.options.buckets[-1]
        deadline = time.perf_counter() + self.options.max_delay_ms / 1e3
        while len(batch) < max_bucket:
            wait = deadline - time.perf_counter()
            try:
                item = self._queue.get(block=wait > 0, timeout=max(wait, 0) or None)
            except queue.Empty:
                break
            if item is None:  # stop sentinel: run what we have, loop exits next
                self._stopping.set()
                break
            batch.append(item)
        return batch

    def _dispatch_loop(self) -> None:
        """Enqueue device programs; never waits for a result (the completer's
        job: the device computes batch k+1 while batch k's rows come back)."""
        while not self._stopping.is_set():
            batch = self._take_batch()
            if not batch:
                break
            try:
                self._inflight.put(self._dispatch_batch(batch))
            except Exception as e:  # build, launch and input errors reach every waiter
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    @staticmethod
    def _fill(arrays: List[np.ndarray], batch: List[Request]) -> None:
        """Write each request of ``batch`` into its row of the wire arrays."""
        for i, req in enumerate(batch):
            arrays[0][i] = req.rgb
            parts = req.event if isinstance(req.event, tuple) else (req.event,)
            for a, part in zip(arrays[1:], parts):
                a[i] = part

    def wire_batch(self, batch: Sequence[Request], bucket: int) -> List[torch.Tensor]:
        """The wire tensors of ``batch``, padded with zero rows to ``bucket``,
        on the engine's device, copied from fresh host memory: the batch the
        dispatcher stages, for ``device_program`` outside the engine."""
        arrays = [np.zeros((bucket, *shape), dt) for shape, dt in self._layout]
        self._fill(arrays, batch)
        return wire_tensors(arrays, self.device)

    def _stage(self, batch: List[Request], bucket: int) -> list:
        """On the card: ``batch`` written into the next slot's pinned buffers,
        once that slot's previous copies have left them, and copied to the
        card without blocking (over a mesh, each replica's row block to its
        card: lists of blocks, as ``device_program`` takes them)."""
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        for event in slot.copied:
            event.synchronize()
        arrays = [a[:bucket] for a in slot.arrays]
        for a in arrays:
            a[len(batch):] = 0
        self._fill(arrays, batch)
        host = [t[:bucket] for t in slot.tensors]
        if self.mesh is None:
            tensors = [t.to(self.device, non_blocking=True) for t in host]
            slot.copied = [torch.cuda.Event()]
            slot.copied[0].record()
            return tensors
        views = self._blocks(host, copy=False)
        tensors, slot.copied = [[] for _ in host], []
        for i, fn in enumerate(self.replica_fns):
            with on_device(fn.device):
                for blocks, out in zip(views, tensors):
                    out.append(blocks[i].to(fn.device, non_blocking=True))
                slot.copied.append(torch.cuda.Event())
                slot.copied[-1].record()
        return tensors

    def _dispatch_batch(self, batch: List[Request]):
        t0 = time.perf_counter()
        n = len(batch)
        bucket = next(b for b in self.options.buckets if b >= n)
        if self.device.type == "cuda":
            tensors = self._stage(batch, bucket)
        else:
            tensors = self.wire_batch(batch, bucket)
            if self.mesh is not None:
                tensors = self._blocks(tensors)
        t_staged = time.perf_counter()
        out = self.device_program(*tensors)
        rows, done = [], []
        for scores, labels, boxes in (zip(*out) if self.mesh is not None else [out]):
            r = torch.cat([boxes.float(), scores.float()[..., None], labels.float()[..., None]], 2)
            if r.device.type == "cuda":  # one copy back and one event a replica
                with on_device(r.device):
                    host = torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                    host.copy_(r, non_blocking=True)
                    done.append(torch.cuda.Event())
                    done[-1].record()
                r = host
            rows.append(r)
        if self._records is not None:
            t_end = time.perf_counter()
            with self._lock:
                self._records.append(BatchRecord(tuple(batch), bucket, t0, (t_staged - t0) * 1e3,
                                                 (t_end - t0) * 1e3))
        return batch, bucket, rows, done

    def _complete_loop(self) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                return
            batch, bucket, rows, done = item
            try:
                for event in done:  # this batch's rows alone, not the batches after it
                    event.synchronize()
                self._complete_batch(batch, bucket, np.concatenate([r.numpy() for r in rows]))
            except Exception as e:  # device faults reach every waiter
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _complete_batch(self, batch: List[Request], bucket: int, rows: np.ndarray) -> None:
        """``rows`` (bucket, M, 6) f32 [x1, y1, x2, y2, score, label] on the host."""
        n = len(batch)
        scores = rows[..., 4]
        labels = rows[..., 5].astype(np.int32)  # small ints, exact in f32
        boxes = rows[..., :4]

        thr = self.options.score_threshold
        cap = self.options.max_detections or self.config.eval.max_detections
        t_done = time.perf_counter()
        for i, req in enumerate(batch):
            keep = scores[i] > thr
            lat_ms = (t_done - req.t_submit) * 1e3
            req.future.set_result(
                Detections(
                    scores=scores[i][keep][:cap],
                    labels=labels[i][keep][:cap],
                    boxes=boxes[i][keep][:cap],
                    latency_ms=lat_ms,
                    batch_size=bucket,
                )
            )
        with self._lock:
            self._n_requests += n
            self._n_batches += 1
            self._n_padded_slots += bucket - n
            self._latencies_ms.extend(
                (t_done - r.t_submit) * 1e3 for r in batch
            )
            if len(self._latencies_ms) > 4096:
                self._latencies_ms = self._latencies_ms[-2048:]

    # -- observability -------------------------------------------------------

    def record_batches(self) -> None:
        """Keep a ``BatchRecord`` of every batch dispatched from now on
        (dropping those kept so far). The records hold their requests' inputs:
        for measurement runs, not for a server left running."""
        with self._lock:
            self._records = []

    def batch_records(self) -> List[BatchRecord]:
        """The batches dispatched since ``record_batches``, oldest first."""
        with self._lock:
            return list(self._records or ())

    def stats(self) -> Dict[str, float]:
        with self._lock:
            lat = np.asarray(self._latencies_ms, np.float64)
            n_req, n_bat, pad = self._n_requests, self._n_batches, self._n_padded_slots
        elapsed = (
            time.perf_counter() - self._t_start if self._t_start is not None else 0.0
        )
        out = {
            "requests": n_req,
            "batches": n_bat,
            "queue_depth": self._queue.qsize(),
            "mean_batch_fill": (
                n_req / (n_req + pad) if n_req + pad else 0.0
            ),
            "throughput_rps": n_req / elapsed if elapsed > 0 else 0.0,
        }
        if self.options.wire_format == "events":
            with self._lock:
                out["truncated_events"] = self._n_truncated_events
        if self.options.wire_format == "sparse":
            with self._lock:
                out["truncated_cells"] = self._n_truncated_cells
        if lat.size:
            out.update(
                latency_ms_p50=float(np.percentile(lat, 50)),
                latency_ms_p90=float(np.percentile(lat, 90)),
                latency_ms_p99=float(np.percentile(lat, 99)),
                latency_ms_mean=float(lat.mean()),
            )
        return out
