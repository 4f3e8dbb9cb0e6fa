"""The port's ``test_dsec_det`` CLI against frn_tpu's, on the CPU.

Both CLIs evaluate one seeded ``.pth`` (depth 18 at the CLIs' feature size
256: frn_tpu's DSEC-Det CLIs take no feature size; random head output convs
and a zero classification bias, so that detections exist and some match
the boxes) over a fixture of 2 sequences of 6 frames at DSEC-Det 96x128
(the CLIs take the DSEC-Det geometry as a constant; the test swaps it for
the tiny one), on the 'f32' and 'compact' wires. Tolerance: per-class APs
(taken from each CLI's ``evaluate_dataset`` call) and the returned mAP
within 1e-9, as the CSV evaluation CLI's test holds them; the printed
summaries equal.
"""

import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest

import torch

import frn_tpu.config as jconfig
import frn_tpu.data.dsec_det as jdsec
import frn_tpu.eval as jeval
from frn_tpu.cli import test_dsec_det as jtest_cli
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import test_dsec_det as ttest_cli
from frn_tpu_torch.data.synthetic import make_dsec_det_fixture
from frn_tpu_torch.eval import evaluator as tevaluator
from frn_tpu_torch.models.detector import init_detector

H, W = 96, 128
JTINY = dataclasses.replace(jconfig.DSEC_DET, height=H, width=W)
TTINY = dataclasses.replace(tconfig.DSEC_DET, height=H, width=W)
AP_ATOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("dsec_det_eval")
    return {"port": make_dsec_det_fixture(str(base / "port"), num_sequences=2,
                                          frames_per_sequence=6, geometry=TTINY),
            "base": base}


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def eval_pth(roots):
    """Seeded weights of the CLI's default width (frn_tpu's DSEC-Det CLIs take
    no feature size) at depth 18, with random head output convs and a zero
    classification bias, so that detections exist and some match."""
    cfg = tconfig.FrameworkConfig(geometry=TTINY, model=tconfig.ModelConfig(depth=18,
                                                                            num_classes=2))
    model = init_detector(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for head in (model.classificationModel, model.regressionModel):
            w = head.output.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.tensor(rng.normal(0, 1 / np.sqrt(fan_in), w.shape).astype(np.float32)))
        model.classificationModel.output.bias.zero_()
    path = roots["base"] / "eval.pth"
    torch.save({"model_state_dict": {"module." + k: v for k, v in model.state_dict().items()}},
               path)
    return str(path)


@pytest.mark.parametrize("wire", ["f32", "compact"])
def test_eval_cli_equals_jax(roots, eval_pth, monkeypatch, wire):
    results = {}

    def recording(name, fn):
        def run(*args, **kwargs):
            results[name] = fn(*args, **kwargs)
            return results[name]
        return run

    monkeypatch.setattr(jeval, "evaluate_dataset", recording("jax", jeval.evaluate_dataset))
    monkeypatch.setattr(tevaluator, "evaluate_dataset",
                        recording("port", tevaluator.evaluate_dataset))
    argv = ["--dataset_root", roots["port"], "--checkpoint", eval_pth, "--depth", "18",
            "--wire", wire]
    monkeypatch.setattr(jconfig, "DSEC_DET", JTINY)
    monkeypatch.setattr(jdsec, "DSECDetDataset",
                        functools.partial(jdsec.DSECDetDataset, geometry=JTINY))
    monkeypatch.setattr(ttest_cli, "DSEC_DET", TTINY)
    want, want_text = _printed(jtest_cli.main, argv)
    got, got_text = _printed(ttest_cli.main, argv + ["--device", "cpu"])
    assert got > 0 and abs(got - want) <= AP_ATOL
    got_aps, want_aps = results["port"].per_class_aps, results["jax"].per_class_aps
    assert got_aps.keys() == want_aps.keys()
    for k in want_aps:
        np.testing.assert_allclose(got_aps[k], want_aps[k], atol=AP_ATOL, rtol=0)
    summary = got_text[got_text.index("{"):]
    assert summary == want_text[want_text.index("{"):]
