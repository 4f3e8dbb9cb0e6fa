"""Data parallelism over a mesh, against frn_tpu's: the mesh, data-parallel
evaluation and serving, the sharded loader and prefetch, and the dryrun.

frn_tpu's side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's mesh repeats the one CPU device (``make_mesh(devices=['cpu'] *
8)``), one replica of the model per entry. The detector is
``tests/test_mesh_eval.py``'s (DSEC 64x96, fusion depth 18, feature size 32)
with ``test_torch_detector.seeded_variables`` (random head output convs, so
that detections exist), carried over by ``state_dict_from_jax``; frn_tpu
decodes with the exact candidate pool.

Tolerances: the port's mesh against the port's single device, those of
``tests/test_mesh_eval.py`` and ``tests/test_serve.py``'s mesh test (labels
equal, scores within 1e-6, boxes within 1e-4 px: the replicas run batch 1
where the single device runs the whole batch, another summation order);
the port against frn_tpu, those of ``tests/test_torch_detector.py`` for
detections at f32 (labels equal, scores within 1e-5, boxes within 1e-3 px).
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from frn_tpu import config as jconfig
from frn_tpu.eval.detections import make_inference_fn as j_make_inference_fn
from frn_tpu.models import detector as jdetector
from frn_tpu.parallel.mesh import make_mesh as j_make_mesh
from frn_tpu.parallel.mesh import shard_batch as j_shard_batch
from frn_tpu.serve import ServeOptions as JOptions
from frn_tpu.serve import ServingEngine as JEngine
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import test as tcli_test
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.data.loader import BatchLoader, device_prefetch
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.entry import InferenceFn, dryrun_multichip
from frn_tpu_torch.eval.detections import collect_detections, make_inference_fn
from frn_tpu_torch.models import detector as tdetector
from frn_tpu_torch.parallel import make_mesh, replicate, shard_batch
from frn_tpu_torch.serve import ServeOptions, ServingEngine
from test_torch_detector import seeded_variables

H, W, N = 64, 96, 8
CPU8 = ["cpu"] * N
MESH_SCORE_ATOL, MESH_BOX_ATOL = 1e-6, 1e-4
JAX_SCORE_ATOL, JAX_BOX_ATOL = 1e-5, 1e-3
THR = 0.3  # serving cut: seeded scores spread over (0, 1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) == N, "virtual CPU mesh expected (see conftest)"
    kw = dict(variant="fusion", depth=18, num_classes=3, feature_size=32, attention_chunk=128)
    jcfg = jconfig.FrameworkConfig(
        geometry=dataclasses.replace(jconfig.DSEC, height=H, width=W),
        model=jconfig.ModelConfig(**kw), eval=jconfig.EvalConfig(approx_topk=False))
    tcfg = tconfig.FrameworkConfig(
        geometry=dataclasses.replace(tconfig.DSEC, height=H, width=W),
        model=tconfig.ModelConfig(**kw))
    jmodel = jdetector.FRNDetector(jcfg)
    variables = seeded_variables(jmodel, jcfg.geometry, seed=1)
    tmodel = tdetector.init_detector(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    rng = np.random.default_rng(0)
    rgb = rng.normal(0, 1, (N, H, W, 3)).astype(np.float32)
    event = rng.normal(0, 1, (N, H, W, 5)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables, tmodel=tmodel,
                rgb=rgb, event=event)


def assert_rows_close(got, want, score_atol, box_atol):
    """(scores, labels, boxes), batch-major; detections on every image."""
    gs, gl, gb = (np.asarray(x) for x in got)
    ws, wl, wb = (np.asarray(x) for x in want)
    assert gs.shape == ws.shape and (wl >= 0).any(axis=1).all()
    np.testing.assert_array_equal(gl, wl)
    valid = wl >= 0
    np.testing.assert_allclose(gs[valid], ws[valid], atol=score_atol, rtol=0)
    np.testing.assert_allclose(gb[valid], wb[valid], atol=box_atol, rtol=0)


# ------------------------------------------------------------ the mesh


def test_make_mesh_matches_jax():
    mesh, jmesh = make_mesh(devices=CPU8), j_make_mesh()
    assert mesh.shape == dict(jmesh.shape) and mesh.axis_names == jmesh.axis_names
    assert mesh.devices == (torch.device("cpu"),) * N
    assert make_mesh(data=N, devices=CPU8).shape == dict(j_make_mesh(data=N).shape)


@pytest.mark.parametrize("kw, port_error", [(dict(data=3), AssertionError),
                                            (dict(model=3), AssertionError),
                                            (dict(model=2), ValueError)])
def test_make_mesh_checks(kw, port_error):
    """frn_tpu's asserts, as exceptions that -O keeps; 'model' other than 1,
    which frn_tpu builds and never uses, raises in the port."""
    if port_error is AssertionError:
        with pytest.raises(AssertionError) as jerr:
            j_make_mesh(**kw)
    else:
        assert dict(j_make_mesh(**kw).shape)["model"] == 2
    with pytest.raises(port_error) as terr:
        make_mesh(devices=CPU8, **kw)
    if port_error is AssertionError:
        assert str(terr.value) == str(jerr.value)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default devices are usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


def test_shard_batch_matches_jax_row_blocks():
    jmesh = j_make_mesh()
    batch = {"x": np.arange(N * 6, dtype=np.float32).reshape(N, 2, 3),
             "m": np.arange(N) % 3 == 0}
    got = shard_batch(batch, make_mesh(devices=CPU8))
    want = j_shard_batch(batch, jmesh)
    order = {d: i for i, d in enumerate(jmesh.devices.flat)}
    for key in batch:
        shards = sorted(want[key].addressable_shards, key=lambda s: order[s.device])
        assert len(got[key]) == len(shards) == N
        for block, shard in zip(got[key], shards):
            np.testing.assert_array_equal(block.numpy(), np.asarray(shard.data))


@pytest.mark.parametrize("rows", [6, 12])
def test_shard_batch_indivisible_raises(rows):
    batch = {"x": np.zeros((rows, 2), np.float32)}
    with pytest.raises(ValueError):
        j_shard_batch(batch, j_make_mesh())
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(batch, make_mesh(devices=CPU8))


def test_replicate_copies_the_weights(setup):
    copies = replicate(setup["tmodel"], make_mesh(devices=["cpu"] * 3))
    want = setup["tmodel"].state_dict()
    assert len({id(c) for c in copies} | {id(setup["tmodel"])}) == 4
    for c in copies:
        got = c.state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) and got[k].data_ptr() != want[k].data_ptr()
                   for k in want if want[k].numel())


# ------------------------------------------------------------ evaluation


def test_mesh_inference_matches_jax_mesh_and_single_device(setup):
    s = setup
    want = j_make_inference_fn(s["jmodel"], s["variables"], s["jcfg"], mesh=j_make_mesh())(
        s["rgb"], s["event"])
    infer = make_inference_fn(s["tmodel"], s["tcfg"], mesh=make_mesh(devices=CPU8))
    rgb, event = torch.from_numpy(s["rgb"]), torch.from_numpy(s["event"])
    got = [x.numpy() for x in infer(rgb, event)]
    single = [x.numpy() for x in make_inference_fn(s["tmodel"], s["tcfg"])(rgb, event)]
    assert got[1].dtype == np.int32
    assert_rows_close(got, single, MESH_SCORE_ATOL, MESH_BOX_ATOL)
    assert_rows_close(got, [np.asarray(x) for x in want], JAX_SCORE_ATOL, JAX_BOX_ATOL)
    # each replica's rows are its own forward of its block, bit for bit
    for i in (0, N - 1):
        alone = infer.replicas[i](rgb[i: i + 1], event[i: i + 1])
        for g, a in zip(got, alone):
            np.testing.assert_array_equal(g[i: i + 1], a.numpy())


def test_mesh_inference_indivisible_batch_raises(setup):
    infer = make_inference_fn(setup["tmodel"], setup["tcfg"], mesh=make_mesh(devices=CPU8))
    with pytest.raises(ValueError, match="does not divide"):
        infer(torch.zeros((6, H, W, 3)), torch.zeros((6, H, W, 5)))
    with pytest.raises(NotImplementedError, match="XLA"):
        make_inference_fn(setup["tmodel"], setup["tcfg"], mesh=make_mesh(devices=CPU8),
                          input_format="auto")


class _Samples:
    """An in-memory dataset with the evaluation surface."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def num_classes(self):
        return 3


def test_collect_detections_over_a_mesh(setup):
    """10 images at batch 4 over a mesh of 2: the last batch holds 2 real
    images and 2 padded ones, whose rows are dropped by the host count."""
    ds = _Samples(box_samples(10, setup["tcfg"].geometry, seed=7))
    tcfg = setup["tcfg"]
    got, _ = collect_detections(ds, make_inference_fn(setup["tmodel"], tcfg,
                                                      mesh=make_mesh(devices=["cpu"] * 2)),
                                tcfg, batch_size=4, num_threads=2)
    want, _ = collect_detections(ds, make_inference_fn(setup["tmodel"], tcfg), tcfg,
                                 batch_size=4, num_threads=2)
    assert len(got) == len(want) == 10 and sum(len(c) for img in want for c in img) > 0
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert g.shape == w.shape
            np.testing.assert_allclose(g[:, 4], w[:, 4], atol=MESH_SCORE_ATOL, rtol=0)
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=MESH_BOX_ATOL, rtol=0)


@pytest.mark.parametrize("batch, cards, want", [(8, 2, 2), (8, 3, "exit"), (8, 1, None)])
def test_cli_data_parallel_mesh(monkeypatch, batch, cards, want):
    """``cli.test --data_parallel``: every visible card when there are
    several (the mesh stands in for them), a batch that does not divide
    exits as frn_tpu's does, one card runs alone."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tcli_test, "make_mesh", lambda: make_mesh(devices=["cpu"] * cards))
    args = tcli_test.get_parser().parse_args(
        ["--csv_classes", "c", "--root_img", "i", "--root_event", "e", "--checkpoint", "k",
         "--batch_size", str(batch), "--data_parallel"])
    if want == "exit":
        with pytest.raises(SystemExit, match="multiple of the data-axis size 3"):
            tcli_test.data_parallel_mesh(args, torch.device("cuda"))
        return
    mesh = tcli_test.data_parallel_mesh(args, torch.device("cuda"))
    assert (mesh and mesh.size) == want
    assert tcli_test.data_parallel_mesh(args, torch.device("cpu")) is None


# ------------------------------------------------------------ serving


def test_mesh_serving_matches_jax_mesh_and_single_device(setup):
    """``tests/test_serve.py``'s mesh test: one request in a bucket of 8 (1
    real row, 7 padded) split over 8 replicas; its detections equal the
    direct single-device forward's and frn_tpu's mesh engine's."""
    s = setup
    options = dict(buckets=(N,), max_delay_ms=0.0, score_threshold=THR, wire_format="f32")
    teng = ServingEngine(s["tmodel"], s["tcfg"], ServeOptions(**options),
                         mesh=make_mesh(devices=CPU8))
    jeng = JEngine(s["jmodel"], s["variables"], s["jcfg"], JOptions(**options), mesh=j_make_mesh())
    direct = InferenceFn(s["tmodel"], s["tcfg"])
    assert len(teng.replica_fns) == N
    with teng, jeng:
        for i in range(2):
            rgb, event = s["rgb"][i], s["event"][i]
            got = teng.infer(rgb, event, timeout=300)
            want = jeng.infer(rgb, event, timeout=600)
            padded = [np.zeros((N, *x.shape), np.float32) for x in (rgb, event)]
            padded[0][0], padded[1][0] = rgb, event
            ds, dl, db = (x[0].numpy() for x in direct(*map(torch.from_numpy, padded)))
            keep = ds > THR
            assert got.batch_size == want.batch_size == N and len(got.scores) > 0
            np.testing.assert_array_equal(got.labels, dl[keep])
            np.testing.assert_allclose(got.scores, ds[keep], atol=MESH_SCORE_ATOL, rtol=0)
            np.testing.assert_allclose(got.boxes, db[keep], atol=MESH_BOX_ATOL, rtol=0)
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_allclose(got.scores, want.scores, atol=JAX_SCORE_ATOL, rtol=0)
            np.testing.assert_allclose(got.boxes, want.boxes, atol=JAX_BOX_ATOL, rtol=0)
        tstats, jstats = teng.stats(), jeng.stats()
    assert tstats.keys() == jstats.keys()
    assert (tstats["requests"], tstats["batches"]) == (jstats["requests"], jstats["batches"]) == (2, 2)


def test_mesh_rejects_indivisible_buckets(setup):
    s = setup
    options = dict(buckets=(1, 2, 4), wire_format="f32")
    with pytest.raises(ValueError) as jerr:
        JEngine(s["jmodel"], s["variables"], s["jcfg"], JOptions(**options), mesh=j_make_mesh())
    with pytest.raises(ValueError) as terr:
        ServingEngine(s["tmodel"], s["tcfg"], ServeOptions(**options), mesh=make_mesh(devices=CPU8))
    assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------ loader, prefetch, dryrun


def test_device_prefetch_over_a_mesh():
    batches = [{"a": np.arange(12, dtype=np.float32).reshape(4, 3) + 100 * i,
                "b": np.arange(4) + i} for i in range(3)]
    mesh = make_mesh(devices=["cpu"] * 2)
    got = list(device_prefetch(iter(batches), size=2, mesh=mesh))
    assert len(got) == 3
    for g, want in zip(got, batches):
        for key in want:
            assert len(g[key]) == 2
            np.testing.assert_array_equal(torch.cat(g[key]).numpy(), want[key])
            np.testing.assert_array_equal(g[key][1].numpy(), want[key][2:])
    with pytest.raises(ValueError, match="does not divide"):
        list(device_prefetch(iter([{"a": np.zeros((3, 1))}]), mesh=mesh))


def test_batch_loader_shards_each_global_batch():
    """Every rank cuts the same permutation into the same global batches and
    collates its row block of each; together they are the unsharded batch."""
    geo = dataclasses.replace(tconfig.DSEC, height=32, width=32)
    samples = box_samples(11, geo, seed=2)

    def load(shard):
        return list(BatchLoader(samples, geo, batch_size=4, shuffle=True, num_threads=0,
                                max_annots=4, drop_last=True, seed=9, shard=shard))

    whole = load((0, 1))
    parts = [load((r, 2)) for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 2
    for b, (p0, p1) in enumerate(zip(*parts)):
        for key in whole[b]:
            assert p0[key].shape[0] == 2
            np.testing.assert_array_equal(np.concatenate([p0[key], p1[key]]), whole[b][key])
    with pytest.raises(ValueError, match="drop_last"):
        BatchLoader(samples, geo, batch_size=4, shard=(0, 2))
    with pytest.raises(ValueError, match="does not divide"):
        BatchLoader(samples, geo, batch_size=3, drop_last=True, shard=(0, 2))


def test_dryrun_multichip_2_on_cpu(capsys):
    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip(2): loss=") and out.rstrip().endswith("OK")
