"""The port's ``device_prefetch`` against frn_tpu's, and the evaluation loop
that it feeds, on the CPU.

On the CPU ``device_prefetch`` is ``to_device`` ahead of the consumer: the
same batches in the same order as frn_tpu's (exact), ``size`` batches ahead,
for any iterator length. ``collect_detections`` over it gives frn_tpu's rows
at the tolerances of ``tests/test_torch_eval_slice.py`` (scores 1e-5, boxes
1e-3 px: f32 in another summation order), at a batch of 1 (more batches than
the prefetch holds) and at a batch larger than the dataset (one ragged batch,
fewer than ``size``). The card's side stream is held by ``chip_smoke.py``
(phase 12: every prefetched batch equal to its host batch after the step).
"""

import dataclasses

import numpy as np
import pytest

import torch

from frn_tpu import config as jconfig
from frn_tpu.data import csv_dataset as jcsv
from frn_tpu.data.loader import device_prefetch as j_device_prefetch
from frn_tpu.data.synthetic import make_csv_fixture
from frn_tpu.eval import detections as jdetections
from frn_tpu.models import detector as jdetector
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.data import csv_dataset as tcsv
from frn_tpu_torch.data.loader import BatchLoader, device_prefetch, to_device
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.eval import detections as tdetections
from frn_tpu_torch.models import detector as tdetector
from test_torch_detector import seeded_variables

H, W = 64, 96


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"rgb": rng.normal(size=(2, 4, 6, 3)).astype(np.float32),
             "label": rng.integers(0, 9, (2, 3)).astype(np.int32),
             "mask": rng.random(2) > 0.5,
             "tensor": torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))}
            for _ in range(n)]


def _numpy(batches):
    """The same batches for frn_tpu, whose ``device_put`` takes no tensor."""
    return [{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in b.items()}
            for b in batches]


class _Counting:
    """An iterator over ``items`` that counts how many were taken."""

    def __init__(self, items):
        self.items, self.taken = list(items), 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.taken == len(self.items):
            raise StopIteration
        self.taken += 1
        return self.items[self.taken - 1]


def test_same_batches_in_the_same_order_as_jax():
    batches = _host_batches(5)
    want = list(j_device_prefetch(iter(_numpy(batches)), size=2))
    got = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == len(want) == 5
    for g, w, host in zip(got, want, batches):
        assert sorted(g) == sorted(w)
        for key in w:
            assert isinstance(g[key], torch.Tensor) and g[key].device.type == "cpu"
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
            assert g[key].numpy().dtype == np.asarray(host[key]).dtype
        want_moved = to_device(host, "cpu")
        for key in want_moved:
            assert torch.equal(g[key], want_moved[key])


@pytest.mark.parametrize("size", [1, 2, 3])
def test_stays_size_ahead_of_its_consumer(size):
    """When the consumer holds batch i, batches up to i + size have been
    taken from the iterator, as in frn_tpu's (held on the same counter)."""
    n = 6
    for prefetch, kw, batches in ((j_device_prefetch, {}, _numpy(_host_batches(n))),
                                  (device_prefetch, {"device": "cpu"}, _host_batches(n))):
        source = _Counting(batches)
        taken = []
        for i, _ in enumerate(prefetch(source, size=size, **kw)):
            taken.append(source.taken)
            assert source.taken == min(n, i + 1 + size)
        assert len(taken) == n


@pytest.mark.parametrize("n", [0, 1])
def test_an_iterator_shorter_than_size(n):
    batches = _host_batches(n)
    got = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == len(list(j_device_prefetch(iter(_numpy(batches)), size=2))) == n
    for g, host in zip(got, batches):
        np.testing.assert_array_equal(g["rgb"].numpy(), host["rgb"])


def test_feeds_the_batch_loader_in_order():
    geo = dataclasses.replace(tconfig.DSEC, height=32, width=48)
    samples = box_samples(5, geo, seed=1)
    loader = BatchLoader(samples, geo, batch_size=2, num_threads=2, max_annots=4)
    got = list(device_prefetch(iter(loader), size=2, device="cpu"))
    want = list(BatchLoader(samples, geo, batch_size=2, num_threads=0, max_annots=4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), w[key])


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("prefetch_eval")
    model_kw = dict(variant="fusion", depth=18, feature_size=16, num_classes=3)
    jgeo = dataclasses.replace(jconfig.DSEC, height=H, width=W)
    tgeo = dataclasses.replace(tconfig.DSEC, height=H, width=W)
    jcfg = jconfig.FrameworkConfig(geometry=jgeo, model=jconfig.ModelConfig(**model_kw),
                                   eval=jconfig.EvalConfig(approx_topk=False))
    tcfg = tconfig.FrameworkConfig(geometry=tgeo, model=tconfig.ModelConfig(**model_kw))
    jmodel = jdetector.FRNDetector(jcfg)
    variables = seeded_variables(jmodel, jgeo, seed=3)
    tmodel = tdetector.init_detector(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    fix = make_csv_fixture(str(root / "fix"), geometry=jgeo, num_images=5, seed=4)
    args = (fix["annotations_csv"], fix["class_map_csv"], fix["event_dir"], fix["img_dir"])
    return dict(jcfg=jcfg, tcfg=tcfg, jds=jcsv.CSVDetectionDataset(jgeo, *args),
                tds=tcsv.CSVDetectionDataset(tgeo, *args),
                jinfer=jdetections.make_inference_fn(jmodel, variables, jcfg),
                tinfer=tdetections.make_inference_fn(tmodel, tcfg))


@pytest.mark.parametrize("batch_size", [1, 8])
def test_collect_detections_over_the_prefetch_matches_jax(eval_setup, batch_size):
    s = eval_setup
    want, _ = jdetections.collect_detections(s["jds"], s["jinfer"], s["jcfg"],
                                             batch_size=batch_size)
    got, elapsed = tdetections.collect_detections(s["tds"], s["tinfer"], s["tcfg"],
                                                  batch_size=batch_size)
    assert elapsed > 0 and len(got) == len(want) == 5
    rows = 0
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert g.shape == w.shape and g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5, rtol=0)
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3, rtol=0)
            rows += len(w)
    assert rows > 0
