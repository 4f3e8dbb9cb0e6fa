"""The port's serving engine, HTTP front end and serve CLI against frn_tpu's.

Case by case the counterpart of ``tests/test_serve.py``, at its scale (DSEC
64x96, fusion depth 18, feature size 32): the JAX detector's seeded
variables (``test_torch_detector.seeded_variables``: random head output
convs, so that detections exist) go to the port through
``state_dict_from_jax``, and both packages' ``ServingEngine`` serve the same
seeded numpy requests on the CPU, the JAX one with the exact candidate pool.

Tolerances, as ``tests/test_torch_detector.py`` sets them for detections at
f32: the same number of detections per request, identical labels, scores
within 1e-5 and boxes within 1e-3 px. Padding is exact: a request padded into
a larger bucket gets bit for bit the rows of the direct forward of the same
padded batch. The events wire voxelizes on the device in both packages
(``voxelize_events_batched`` against ``frn_tpu``'s ``voxelize_events``);
``submit_events`` on the other wires voxelizes on the host in both.
"""

import contextlib
import dataclasses
import io
import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import torch

from frn_tpu import config as jconfig
from frn_tpu.cli import serve as jcli
from frn_tpu.models import detector as jdetector
from frn_tpu.serve import DetectionServer as JServer
from frn_tpu.serve import ServeOptions as JOptions
from frn_tpu.serve import ServingEngine as JEngine
from frn_tpu.serve import http as jhttp
from frn_tpu_torch import build
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import serve as tcli
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.entry import InferenceFn
from frn_tpu_torch.models import detector as tdetector
from frn_tpu_torch.parallel import make_mesh
from frn_tpu_torch.serve import DetectionServer, ServeOptions, ServingEngine
from frn_tpu_torch.serve import http as thttp
from frn_tpu_torch.serve.engine import request_wire_bytes, wire_layout
from test_torch_detector import seeded_variables

H, W = 64, 96
THR = 0.3  # serving cut: seeded scores spread over (0, 1)
SCORE_ATOL, BOX_ATOL = 1e-5, 1e-3
WIRES = ("f32", "compact", "events", "sparse")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_configs():
    """``tests/test_serve.py``'s ``_small_cfg`` in both packages."""
    kw = dict(variant="fusion", depth=18, num_classes=3, feature_size=32, attention_chunk=128)
    jcfg = jconfig.FrameworkConfig(
        geometry=dataclasses.replace(jconfig.DSEC, height=H, width=W),
        model=jconfig.ModelConfig(**kw), eval=jconfig.EvalConfig(score_threshold=0.0,
                                                                  approx_topk=False))
    tcfg = tconfig.FrameworkConfig(
        geometry=dataclasses.replace(tconfig.DSEC, height=H, width=W),
        model=tconfig.ModelConfig(**kw), eval=tconfig.EvalConfig(score_threshold=0.0))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = small_configs()
    jmodel = jdetector.FRNDetector(jcfg)
    variables = seeded_variables(jmodel, jcfg.geometry, seed=1)
    tmodel = tdetector.init_detector(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables, tmodel=tmodel)


@contextlib.contextmanager
def both_engines(served, **options):
    """Both packages' engines on the same weights and options, started."""
    jeng = JEngine(served["jmodel"], served["variables"], served["jcfg"], JOptions(**options))
    teng = ServingEngine(served["tmodel"], served["tcfg"], ServeOptions(**options))
    with jeng, teng:
        yield jeng, teng


@pytest.fixture(scope="module")
def pairs(served):
    """wire -> both packages' engines, started once for the module, with one
    bucket of 4 (each JAX engine compiles each bucket it runs; the ladder is
    held in ``test_ladder_padding_is_exact``)."""
    made = {}
    with contextlib.ExitStack() as stack:
        def pair(wire):
            if wire not in made:
                made[wire] = stack.enter_context(both_engines(
                    served, buckets=(4,), max_delay_ms=300.0, score_threshold=THR,
                    wire_format=wire, event_capacity=4096, cell_capacity=8192))
            return made[wire]

        yield pair


def assert_same_detections(got, want):
    assert got.scores.shape == want.scores.shape
    assert got.scores.dtype == want.scores.dtype == np.float32
    assert got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.scores, want.scores, atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(got.boxes, want.boxes, atol=BOX_ATOL, rtol=0)


def rand_inputs(seed):
    """Pre-normalized f32 tensors (the 'f32' wire's requests)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (H, W, 3)).astype(np.float32),
            rng.normal(0, 1, (H, W, 5)).astype(np.float32))


def raw_inputs(seed, big=False):
    """uint8 camera frame + integer polarity-count voxel (raw client data);
    ``big`` puts counts past the compact wire's +-127 clip."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    counts = rng.poisson(1.5, (H, W, 5)) * np.where(rng.random((H, W, 5)) < 0.5, -1, 1)
    counts = counts.astype(np.float32)
    counts[0, 0, 0] = 9.0  # past the tanh threshold (max |v| > 5)
    if big:
        counts[7, 9, 0], counts[7, 9, 1] = 300.0, -301.0
    return rgb, counts


def raw_stream(seed, n=3000, t_base=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, W, n).astype(np.int64), rng.integers(0, H, n).astype(np.int64),
            t_base + np.sort(rng.integers(0, 50_000, n)).astype(np.int64),
            rng.integers(0, 2, n).astype(np.int64))


def wire_requests(wire, seed):
    """Three requests of a wire: (method name, args) each."""
    if wire == "f32":
        return [("submit", rand_inputs(seed + i)) for i in range(3)]
    if wire == "events":  # raw i64 us timestamps past int32: the window-relative rebase
        rng = np.random.default_rng(seed)
        return [("submit_events", (*raw_stream(seed + i, t_base=7_000_000_000),
                                   rng.integers(0, 256, (H, W, 3), dtype=np.uint8)))
                for i in range(3)]
    return [("submit", raw_inputs(seed + i, big=wire == "sparse")) for i in range(3)]


# ------------------------------------------------------------ the wires


@pytest.mark.parametrize("wire", WIRES)
def test_wire_matches_jax_engine(pairs, wire):
    """Three concurrent requests on each wire: each request's detections
    equal frn_tpu's engine's on the same inputs, and both coalesce the burst
    into one bucket of 4."""
    requests = wire_requests(wire, seed=10)
    jeng, teng = pairs(wire)
    want = [getattr(jeng, m)(*a) for m, a in requests]
    got = [getattr(teng, m)(*a) for m, a in requests]
    want = [f.result(timeout=300) for f in want]
    got = [f.result(timeout=300) for f in got]
    tstats, jstats = teng.stats(), jeng.stats()
    assert sum(len(d.scores) for d in want) > 0
    for g, w in zip(got, want):
        assert_same_detections(g, w)
        assert g.batch_size == w.batch_size == 4 and g.latency_ms > 0
    assert tstats.keys() == jstats.keys()
    for key in ("requests", "batches", "mean_batch_fill"):
        assert tstats[key] == jstats[key]


@pytest.mark.parametrize("wire", ["f32", "compact", "sparse"])
def test_submit_events_on_host_wires_matches_jax(pairs, wire):
    """A raw stream on a voxel wire is voxelized on the host in both packages
    (f32: normalized there too; RGB as [0, 1] floats from u8)."""
    x, y, t, p = raw_stream(21)
    rng = np.random.default_rng(22)
    rgb01 = (rng.integers(0, 256, (H, W, 3)) / 255.0).astype(np.float32)
    jeng, teng = pairs(wire)
    want = jeng.submit_events(x, y, t, p, rgb01).result(timeout=300)
    got = teng.submit_events(x, y, t, p, rgb01).result(timeout=300)
    assert len(want.scores) > 0
    assert_same_detections(got, want)


def test_ladder_padding_is_exact(served):
    """On the ladder (1, 2, 4) three concurrent requests ride one bucket of 4
    (one zero-padded row) and a lone one a bucket of 1. Each gets exactly the
    rows of the direct forward of its padded batch, and the detections of
    its own batch-1 forward within the f32 tolerance."""
    tcfg = served["tcfg"]
    inputs = [rand_inputs(60 + i) for i in range(4)]
    eng = ServingEngine(served["tmodel"], tcfg, ServeOptions(
        buckets=(1, 2, 4), max_delay_ms=300.0, score_threshold=THR, wire_format="f32"))
    with eng:
        burst = [eng.submit(*x) for x in inputs[:3]]
        dets = [f.result(timeout=300) for f in burst]
        dets.append(eng.infer(*inputs[3], timeout=300))
        stats = eng.stats()
    assert [d.batch_size for d in dets] == [4, 4, 4, 1]
    assert stats["requests"] == 4 and stats["batches"] == 2
    assert stats["mean_batch_fill"] == pytest.approx(0.8)
    fn = InferenceFn(served["tmodel"], tcfg)

    def direct(batch):
        rgb = np.zeros((len(batch) + (len(batch) == 3), H, W, 3), np.float32)
        event = np.zeros(rgb.shape[:3] + (5,), np.float32)
        for i, (r, e) in enumerate(batch):
            rgb[i], event[i] = r, e
        s, l, b = (x.numpy() for x in fn(torch.from_numpy(rgb), torch.from_numpy(event)))
        return [(s[i][s[i] > THR], l[i][s[i] > THR], b[i][s[i] > THR]) for i in range(len(batch))]

    padded = direct(inputs[:3]) + direct(inputs[3:])
    for det, (s, l, b), alone in zip(dets, padded, (direct([x])[0] for x in inputs)):
        assert len(s) > 0
        np.testing.assert_array_equal(det.scores, s)
        np.testing.assert_array_equal(det.labels, l)
        np.testing.assert_array_equal(det.boxes, b)
        np.testing.assert_array_equal(det.labels, alone[1])
        np.testing.assert_allclose(det.scores, alone[0], atol=SCORE_ATOL, rtol=0)
        np.testing.assert_allclose(det.boxes, alone[2], atol=BOX_ATOL, rtol=0)


@pytest.mark.parametrize("wire", WIRES)
def test_batch_records_rebuild_the_dispatched_batch(served, wire):
    """``record_batches`` keeps each batch dispatched after it (its requests
    in queue order, bucket and the dispatcher's host ms), and
    ``device_program`` of ``wire_batch`` of a record gives each of its
    requests bit for bit the detections it was served: the public pieces
    the on-card check of every request is built on."""
    eng = ServingEngine(served["tmodel"], served["tcfg"], ServeOptions(
        buckets=(1, 4), max_delay_ms=300.0, score_threshold=THR, wire_format=wire,
        event_capacity=4096, cell_capacity=8192))
    with eng:
        method, args = wire_requests(wire, seed=80)[0]
        getattr(eng, method)(*args).result(timeout=300)  # before recording: not kept
        eng.record_batches()
        futs = [getattr(eng, m)(*a) for m, a in wire_requests(wire, seed=70)]
        dets = [f.result(timeout=300) for f in futs]
        records = eng.batch_records()
    assert len(records) == 1
    rec = records[0]
    assert rec.bucket == 4 and [r.future for r in rec.requests] == futs
    assert 0 <= rec.stage_ms <= rec.host_ms
    scores, labels, boxes = (x.numpy() for x in eng.device_program(
        *eng.wire_batch(rec.requests, rec.bucket)))
    assert sum(len(d.scores) for d in dets) > 0
    for i, det in enumerate(dets):
        keep = scores[i] > THR
        np.testing.assert_array_equal(det.scores, scores[i][keep])
        np.testing.assert_array_equal(det.labels, labels[i][keep])
        np.testing.assert_array_equal(det.boxes, boxes[i][keep])


@pytest.mark.parametrize("wire", ["events", "sparse"])
def test_truncation_counters_match_jax(pairs, wire):
    """500 events past the events wire's 4,096 slots; a dense voxel's 30,720
    cells past the sparse wire's 8,192."""
    jeng, teng = pairs(wire)
    key = "truncated_events" if wire == "events" else "truncated_cells"
    before = teng.stats()[key]
    for eng in (jeng, teng):
        if wire == "events":
            fut = eng.submit_events(*raw_stream(32, n=4096 + 500), np.zeros((H, W, 3), np.uint8))
        else:
            fut = eng.submit(np.zeros((H, W, 3), np.uint8), np.ones((H, W, 5), np.float32))
        assert isinstance(fut.result(timeout=300).scores, np.ndarray)
    assert teng.stats()[key] == jeng.stats()[key] == before + (
        500 if wire == "events" else H * W * 5 - 8192)


# ------------------------------------------------------------ errors


@pytest.mark.parametrize("case", ["descending", "empty", "unknown_wire", "gray_compact"])
def test_options_validation_matches_jax(served, case):
    jcfg, tcfg = served["jcfg"], served["tcfg"]
    options = {"descending": dict(buckets=(4, 2, 1)), "empty": dict(buckets=()),
               "unknown_wire": dict(wire_format="png"),
               "gray_compact": dict(wire_format="compact")}[case]
    if case == "gray_compact":  # e2vid grayscale inputs are [0, 1] floats, not counts
        jcfg = dataclasses.replace(jcfg, geometry=dataclasses.replace(jcfg.geometry, event_channels=1))
        tcfg = dataclasses.replace(tcfg, geometry=dataclasses.replace(tcfg.geometry, event_channels=1))
    with pytest.raises(ValueError) as jerr:
        JEngine(served["jmodel"], served["variables"], jcfg, JOptions(**options))
    with pytest.raises(ValueError) as terr:
        ServingEngine(served["tmodel"], tcfg, ServeOptions(**options))
    assert str(terr.value) == str(jerr.value)


def test_mesh_is_not_ported(served):
    """Serving over a mesh of two CPU replicas: a lone request rides a bucket
    of 2, split over them; its detections are bit for bit the batch-1
    forward's of the same weights (replica 0's block is that request alone),
    and a burst of 3 fills a bucket of 4."""
    eng = ServingEngine(served["tmodel"], served["tcfg"],
                        ServeOptions(buckets=(2, 4), max_delay_ms=300.0, score_threshold=THR,
                                     wire_format="f32"),
                        mesh=make_mesh(devices=["cpu"] * 2))
    direct = InferenceFn(served["tmodel"], served["tcfg"])
    with eng:
        rgb, event = rand_inputs(30)
        det = eng.infer(rgb, event, timeout=300)
        burst = [eng.submit(*rand_inputs(31 + i)) for i in range(3)]
        burst = [f.result(timeout=300) for f in burst]
    s, l, b = (x[0].numpy() for x in direct(torch.from_numpy(rgb[None]), torch.from_numpy(event[None])))
    keep = s > THR
    assert det.batch_size == 2 and len(det.scores) > 0
    np.testing.assert_array_equal(det.scores, s[keep])
    np.testing.assert_array_equal(det.labels, l[keep])
    np.testing.assert_array_equal(det.boxes, b[keep])
    assert [d.batch_size for d in burst] == [4, 4, 4]


@pytest.mark.parametrize("wire, case", [("f32", "short_rgb"), ("f32", "short_event"),
                                        ("compact", "unscaled_floats"),
                                        ("events", "plain_submit")])
def test_bad_requests_raise_as_jax(served, wire, case):
    rgb, event = rand_inputs(4)
    if case == "short_rgb":
        rgb = rgb[:-2]
    elif case == "short_event":
        event = event[..., :-1]
    elif case == "plain_submit":
        rgb = np.zeros((H, W, 3), np.uint8)
    with both_engines(served, buckets=(1,), max_delay_ms=0.0, wire_format=wire) as (jeng, teng):
        with pytest.raises(ValueError) as jerr:
            jeng.submit(rgb, event)
        with pytest.raises(ValueError) as terr:
            teng.submit(rgb, event)
    assert str(terr.value) == str(jerr.value)


def test_engine_requires_start(served):
    eng = ServingEngine(served["tmodel"], served["tcfg"])
    with pytest.raises(RuntimeError, match="not started"):
        eng.submit(*raw_inputs(4))


def test_stop_fails_pending_requests(served):
    eng = ServingEngine(served["tmodel"], served["tcfg"], ServeOptions(
        buckets=(1,), max_delay_ms=0.0, score_threshold=THR, wire_format="f32"))
    # dispatcher already dead: stop() must fail queued futures, not hang them
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    eng._thread = t
    fut = eng.submit(*rand_inputs(9))
    eng.stop()
    with pytest.raises(RuntimeError, match="engine stopped"):
        fut.result(timeout=5)


def test_device_errors_reach_every_future(served, monkeypatch):
    """A device program that raises (a kernel that does not build or launch)
    fails every request of its batch; nothing falls back."""
    eng = ServingEngine(served["tmodel"], served["tcfg"], ServeOptions(
        buckets=(1, 2, 4), max_delay_ms=300.0, wire_format="f32"))

    def broken(*args):
        raise RuntimeError("kernel build failed: stub")

    monkeypatch.setattr(eng, "device_program", broken)
    with eng:
        futs = [eng.submit(*rand_inputs(40 + i)) for i in range(3)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="kernel build failed"):
                fut.result(timeout=60)


# ------------------------------------------------------------ wire layout


@pytest.mark.parametrize("wire", WIRES)
def test_wire_layout_matches_jax(served, wire):
    """Each wire ships frn_tpu's arrays (shapes and dtypes, RGB first); every
    non-f32 wire ships uint8 RGB (an f32 buffer would 4x the dominant
    payload)."""
    jeng = JEngine(served["jmodel"], served["variables"], served["jcfg"],
                   JOptions(buckets=(1,), wire_format=wire))
    layout = wire_layout(served["tcfg"].geometry, ServeOptions(wire_format=wire))
    event = jeng._empty_event_payload(3)
    want = [np.zeros((3, H, W, 3), jeng._wire_dtypes[0]),
            *(event if isinstance(event, tuple) else (event,))]
    assert layout == [(a.shape[1:], a.dtype) for a in want]
    assert (layout[0][1] == np.uint8) == (wire != "f32")


@pytest.mark.parametrize("wire, nbytes", [("f32", 9_830_400), ("compact", 2_457_600),
                                          ("events", 1_511_428), ("sparse", 995_328)])
def test_request_wire_bytes_at_dsec(wire, nbytes):
    assert request_wire_bytes(tconfig.DSEC, ServeOptions(wire_format=wire)) == nbytes


# ------------------------------------------------------------ HTTP


@pytest.fixture(scope="module")
def servers(pairs):
    """Both packages' f32 and events servers on loopback."""
    out = {}
    with contextlib.ExitStack() as stack:
        for wire in ("f32", "events"):
            jeng, teng = pairs(wire)
            for key, server in (("jax", JServer(jeng, port=0, timeout_s=300)),
                                ("torch", DetectionServer(teng, port=0, timeout_s=300))):
                out[key, wire] = server.start_background()
                stack.callback(server.shutdown)
        yield out


def post(server, payload=None, data=None, path="/infer", compressed=False):
    """(status, JSON body) of a POST of an npz ``payload`` or raw ``data``."""
    if payload is not None:
        buf = io.BytesIO()
        (np.savez_compressed if compressed else np.savez)(buf, **payload)
        data = buf.getvalue()
    host, port = server.address
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(server, path):
    host, port = server.address
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_payloads():
    rng = np.random.default_rng(6)
    rgb, event = rand_inputs(5)
    n = 500
    return {
        "preprocessed_voxel": dict(rgb=rgb, event=event, preprocessed=np.int32(1)),
        "uint8_rgb_chw_event": dict(rgb=rng.integers(0, 256, (H, W, 3), dtype=np.uint8),
                                    event=rng.normal(0, 3, (5, H, W)).astype(np.float32)),
        "raw_events": dict(rgb=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
                           x=rng.integers(0, W, n), y=rng.integers(0, H, n),
                           t=np.sort(rng.integers(0, 1000, n)), p=rng.integers(0, 2, n)),
    }


@pytest.mark.parametrize("name", list(http_payloads()))
def test_http_infer_matches_jax_server(servers, name):
    payload = http_payloads()[name]
    status, got = post(servers["torch", "f32"], payload, compressed=name == "uint8_rgb_chw_event")
    jstatus, want = post(servers["jax", "f32"], payload, compressed=name == "uint8_rgb_chw_event")
    assert status == jstatus == 200
    assert got["latency_ms"] > 0 and got["batch_size"] == 4
    assert len(got["detections"]) == len(want["detections"]) > 0
    for g, w in zip(got["detections"], want["detections"]):
        assert (g["class"], g["class_id"]) == (w["class"], w["class_id"])
        assert abs(g["score"] - w["score"]) <= SCORE_ATOL
        np.testing.assert_allclose(g["box"], w["box"], atol=BOX_ATOL, rtol=0)


def test_http_events_server_raw_stream(servers):
    x, y, t, p = raw_stream(33, n=800)
    rgb = np.random.default_rng(34).integers(0, 256, (H, W, 3), dtype=np.uint8)
    status, got = post(servers["torch", "events"], dict(rgb=rgb, x=x, y=y, t=t, p=p))
    jstatus, want = post(servers["jax", "events"], dict(rgb=rgb, x=x, y=y, t=t, p=p))
    assert status == jstatus == 200
    assert [d["class_id"] for d in got["detections"]] == [d["class_id"] for d in want["detections"]]


@pytest.mark.parametrize("wire, case", [("f32", "not_npz"), ("f32", "missing_event"),
                                        ("f32", "missing_rgb"), ("f32", "unknown_path"),
                                        ("events", "voxel_payload"), ("events", "missing_rgb")])
def test_http_errors_match_jax_server(servers, wire, case):
    rgb, event = rand_inputs(8)
    x, y, t, p = raw_stream(35, n=10)
    payload = {"not_npz": None, "missing_event": dict(rgb=rgb), "missing_rgb": dict(event=event),
               "unknown_path": dict(rgb=rgb, event=event),
               "voxel_payload": dict(rgb=np.zeros((H, W, 3), np.uint8),
                                     event=np.zeros((5, H, W), np.float32))}[case]
    if wire == "events" and case == "missing_rgb":
        payload = dict(x=x, y=y, t=t, p=p)
    kw = dict(data=b"not an npz") if payload is None else dict(payload=payload)
    path = "/predict" if case == "unknown_path" else "/infer"
    got = post(servers["torch", wire], path=path, **kw)
    want = post(servers["jax", wire], path=path, **kw)
    assert got == want
    assert got[0] == (404 if case == "unknown_path" else 400)


def test_http_healthz_stats_and_404(servers):
    server = servers["torch", "f32"]
    assert get(server, "/healthz") == (200, {"ok": True})
    status, stats = get(server, "/stats")
    _, jstats = get(servers["jax", "f32"], "/stats")
    assert status == 200 and stats.keys() == jstats.keys()
    assert get(server, "/nope") == get(servers["jax", "f32"], "/nope")


@pytest.mark.parametrize("wire", ["f32", "compact"])
def test_prepare_inputs_matches_jax(served, wire):
    jeng = JEngine(served["jmodel"], served["variables"], served["jcfg"],
                   JOptions(buckets=(1,), wire_format=wire))
    teng = ServingEngine(served["tmodel"], served["tcfg"], ServeOptions(buckets=(1,), wire_format=wire))
    rgb_u8, counts = raw_inputs(23)
    for payload in (dict(rgb=rgb_u8, event=counts),
                    dict(rgb=rgb_u8.astype(np.float32), event=np.transpose(counts, (2, 0, 1))),
                    dict(rgb=rgb_u8, **dict(zip("xytp", raw_stream(24, n=300))))):
        got = thttp._prepare_inputs(teng, payload)
        want = jhttp._prepare_inputs(jeng, payload)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if wire == "compact":  # no host normalization; pre-normalized payloads refused
        assert got[0].dtype == np.uint8
        with pytest.raises(ValueError, match="wire_format='f32'"):
            thttp._prepare_inputs(teng, dict(rgb=rgb_u8, event=counts, preprocessed=np.int32(1)))


# ------------------------------------------------------------ serve CLI


def test_serve_parser_defaults_match_jax():
    got = vars(tcli.get_parser().parse_args([]))
    want = vars(jcli.get_parser().parse_args([]))
    assert got.pop("device") is None
    assert got == want


@pytest.mark.parametrize("argv, torch_only", [
    (["--buckets", "2,1", "--score_threshold", "0.3"], []),
    (["--wire_format", "events", "--event_capacity", "1024", "--max_delay_ms", "0",
      "--compute_dtype", "bfloat16", "--attention_quant", "int8_qk", "--pipeline_depth", "1"], []),
    # --data_parallel with no card: serves from the one device, as frn_tpu
    # does on one device (the JAX tests see 8 virtual devices, so not there)
    (["--event_type", "gray", "--num_classes", "2", "--max_queue", "8"], ["--data_parallel"]),
])
def test_build_engine_matches_jax(argv, torch_only, monkeypatch):
    """cli/serve.py's plumbing -> the same options and configuration. The
    weights are not compared (both random-init), so frn_tpu's initialization
    (a jitted init of the train state, 20-40 s here) is replaced by an empty
    variable tree."""
    from frn_tpu.train import loop as jloop

    monkeypatch.setattr(jloop, "create_train_state", lambda config, key, batch_size: (
        jdetector.FRNDetector(config), types.SimpleNamespace(params={}, batch_stats={}), None))
    small = ["--image_height", "64", "--image_width", "96", "--depth", "18",
             "--feature_size", "32"]
    targv = small + argv + torch_only + ["--device", "cpu"]
    teng, tcfg = tcli.build_engine(tcli.get_parser().parse_args(targv))
    jeng, jcfg = jcli.build_engine(jcli.get_parser().parse_args(small + argv))
    assert dataclasses.asdict(teng.options) == dataclasses.asdict(jeng.options)
    assert dataclasses.asdict(tcfg.geometry) == dataclasses.asdict(jcfg.geometry)
    assert tcfg.eval.score_threshold == jcfg.eval.score_threshold <= teng.options.score_threshold
    for field in ("variant", "depth", "num_classes", "compute_dtype", "feature_size",
                  "attention_quant"):
        assert getattr(tcfg.model, field) == getattr(jcfg.model, field)
    assert teng.device == torch.device("cpu")


def test_build_engine_loads_checkpoints(served, tmp_path):
    """--checkpoint: a reference .pth loads strictly; an orbax directory of
    frn_tpu raises, naming convert_checkpoint (which writes the port's
    directory from a .pt)."""
    state = served["tmodel"].state_dict()
    pth = tmp_path / "model.pth"
    torch.save({"model_state_dict": {"module." + k: v for k, v in state.items()}}, pth)
    small = ["--image_height", "64", "--image_width", "96", "--depth", "18",
             "--feature_size", "32", "--device", "cpu"]
    eng, _ = tcli.build_engine(tcli.get_parser().parse_args(small + ["--checkpoint", str(pth)]))
    for k, v in eng.infer_fn.model.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    orbax = tmp_path / "orbax"
    (orbax / "3" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="convert_checkpoint"):
        tcli.build_engine(tcli.get_parser().parse_args(small + ["--checkpoint", str(orbax)]))


def test_serve_cli_main_answers_requests(served, monkeypatch):
    """``main`` warms every bucket up, serves, and on shutdown stops the
    engine; the server it builds answers /healthz and /infer."""
    started = {}
    real = tcli.build_engine

    def build_small(args):
        eng, cfg = real(args)
        started["engine"] = eng
        return eng, cfg

    class Server(DetectionServer):
        def serve_forever(self):
            self.start_background()
            started["health"] = get(self, "/healthz")
            started["infer"] = post(self, dict(zip(("rgb", "event"), raw_inputs(50))))
            raise KeyboardInterrupt

    monkeypatch.setattr(tcli, "build_engine", build_small)
    monkeypatch.setattr("frn_tpu_torch.serve.DetectionServer", Server)
    argv = ["--image_height", "64", "--image_width", "96", "--depth", "18", "--feature_size",
            "32", "--buckets", "1,2", "--port", "0", "--device", "cpu"]
    assert tcli.main(argv) == 0
    assert started["health"] == (200, {"ok": True})
    assert started["infer"][0] == 200 and started["infer"][1]["batch_size"] == 1
    assert started["engine"]._thread is None  # stopped


# ------------------------------------------------------------ build lock


def test_first_builds_from_two_threads_run_one_compiler(tmp_path, monkeypatch):
    """A serving engine's warm-up (caller's thread) and its dispatcher can
    reach a kernel's first use at once: ``build`` serializes them, so one
    compiler runs and both load its library."""
    log = tmp_path / "calls"
    stub = tmp_path / "nvcc"
    stub.write_text("#!/bin/sh\necho run >> %s\nsleep 0.5\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "echo lib > \"$2\"\n" % log)
    stub.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc", lambda: str(stub))
    out = []
    threads = [threading.Thread(target=lambda: out.append(build.build(["stem"])["stem"]))
               for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert log.read_text().count("run") == 1
    assert sorted(seconds == 0.0 for _, seconds, _ in out) == [False, True]
    assert out[0][0] == out[1][0] and out[0][0].read_text() == "lib\n"
