"""The port's profiling hooks and the trainer's JSONL metrics against frn_tpu's.

``MetricsLogger`` records and ``StepTimer.stats()`` are held exactly against
the JAX package's on the same inputs (``time`` excepted); ``trace`` writes a
Chrome trace on the CPU; and ``Trainer(metrics_path=...)`` at a tiny size
(depth 18, feature size 16, 32x48, modality dropout 0) writes the records of
``frn_tpu``'s ``Trainer`` over the same samples and starting weights: the
same steps, epochs, keys and JSON types, losses at rtol 1e-4 (the gate of
``tests/test_torch_train_slice.py``: f32 in another summation order).
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.train.trainer import Trainer as JTrainer
from frn_tpu.utils import profiling as jprofiling
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.train.trainer import Trainer
from frn_tpu_torch.utils import profiling as tprofiling

LOSS_RTOL = 1e-4
MODEL_KW = dict(variant="fusion", depth=18, num_classes=3, feature_size=16, attention_chunk=64,
                modality_dropout=0.0)
# one accumulation cycle of 4 micro-steps: every logged loss is computed
# before the epoch's one Adam step. After an Adam step the two packages'
# parameters may differ by up to 2 lr where a gradient's sign is rounding
# noise (tests/test_torch_train_slice.py holds that step), which moves a
# later loss by more than LOSS_RTOL
TRAIN_KW = dict(batch_size=2, learning_rate=1e-4, accum_steps=4, max_annots_per_image=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metrics_logger_records_equal_jax(tmp_path):
    jpath, tpath = str(tmp_path / "j" / "m.jsonl"), str(tmp_path / "t" / "m.jsonl")
    jlog, tlog = jprofiling.MetricsLogger(jpath), tprofiling.MetricsLogger(tpath)
    rng = np.random.default_rng(0)
    for step in (2, 4):
        loss = rng.normal(size=()).astype(np.float32)
        common = dict(epoch=step // 4, name="run", flag=True, dt=0.25 * step)
        jlog.log(step, loss=jnp.asarray(loss), count=np.int64(step), **common)
        tlog.log(step, loss=torch.from_numpy(loss), count=np.int64(step), **common)
    tprofiling.MetricsLogger(None).log(1, loss=1.0)  # no path: nothing written
    got, want = _records(tpath), _records(jpath)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert isinstance(g["time"], float)
        for key in w:
            assert type(g[key]) is type(w[key]), key
            if key != "time":
                assert g[key] == w[key], key
    assert isinstance(got[0]["epoch"], float) and isinstance(got[0]["step"], int)


def test_step_timer_stats_equal_jax():
    samples = list(np.random.default_rng(1).uniform(0.01, 0.2, 37))
    jt, tt = jprofiling.StepTimer(window=30), tprofiling.StepTimer(window=30)
    assert tt.stats() == jt.stats() == {}
    for s in samples:
        for t in (jt, tt):
            t.samples.append(s)
            if len(t.samples) > t.window:
                t.samples.pop(0)
    assert tt.stats() == jt.stats()
    assert sorted(tt.stats()) == ["mean_s", "p50_s", "p90_s", "steps_per_s"]
    # start/stop: the window rolls, and stop syncs on a tree of tensors
    timer = tprofiling.StepTimer(window=2)
    for _ in range(3):
        timer.start()
        dt = timer.stop({"b": [torch.ones(3)], "a": (1.0, torch.zeros(2, 2))})
        assert dt >= 0
    assert len(timer.samples) == 2


def test_sync_takes_the_first_tensor_leaf():
    assert tprofiling._first_tensor({"b": torch.ones(1), "a": [2.0, torch.zeros(3)]}).shape == (3,)
    assert tprofiling._first_tensor([1.0, "x"]) is None
    tprofiling.sync({"a": torch.empty(0), "b": None})  # nothing to fetch: no error
    tprofiling.sync(None)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprofiling.trace(log_dir):
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def _configs():
    jgeo = dataclasses.replace(jconfig.DSEC, height=32, width=48)
    tgeo = dataclasses.replace(tconfig.DSEC, height=32, width=48)
    return (jconfig.FrameworkConfig(geometry=jgeo, model=jconfig.ModelConfig(**MODEL_KW),
                                    train=jconfig.TrainConfig(**TRAIN_KW)),
            tconfig.FrameworkConfig(geometry=tgeo, model=tconfig.ModelConfig(**MODEL_KW),
                                    train=tconfig.TrainConfig(**TRAIN_KW)))


def test_trainer_metrics_jsonl_equals_jax(tmp_path, capsys):
    """Both trainers over the same 8 samples (4 micro-steps, shuffled by the
    same seed), from the same weights (the heads' zero output convs replaced
    by the same seeded draws, so the losses move), logging every 2."""
    jcfg, tcfg = _configs()
    samples = box_samples(8, tcfg.geometry, seed=5)
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")

    jtrainer = JTrainer(jcfg, samples, log_every=2, use_mesh=False, metrics_path=jpath)
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jtrainer.state.params))
    for head in ("classificationModel", "regressionModel"):
        kernel = params[head]["output"]["Conv_0"]["kernel"]
        params[head]["output"]["Conv_0"]["kernel"] = rng.normal(
            0, 0.1 / np.sqrt(np.prod(kernel.shape[:3])), kernel.shape).astype(np.float32)
    jtrainer.state = jtrainer.state.replace(params=params, opt_state=jtrainer.tx.init(params))
    weights = state_dict_from_jax({"params": params,
                                   "batch_stats": jax.device_get(jtrainer.state.batch_stats)})

    trainer = Trainer(tcfg, samples, log_every=2, device="cpu", metrics_path=tpath)
    trainer.state.model.load_state_dict(weights, strict=True)
    jtrainer.fit(1)
    trainer.fit(1)
    capsys.readouterr()

    got, want = _records(tpath), _records(jpath)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["step", "time", "epoch", "loss", "cls_loss", "reg_loss",
                                      "step_time_s"]
        assert {k: type(v) for k, v in g.items()} == {k: type(v) for k, v in w.items()}
        assert g["epoch"] == w["epoch"] == 0.0
        assert np.isfinite(w["loss"]) and g["step_time_s"] > 0
        np.testing.assert_allclose([g[k] for k in ("loss", "cls_loss", "reg_loss")],
                                   [w[k] for k in ("loss", "cls_loss", "reg_loss")],
                                   rtol=LOSS_RTOL)
    assert trainer.timer.window == jtrainer.timer.window
