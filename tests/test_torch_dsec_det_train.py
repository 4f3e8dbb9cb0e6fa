"""Training on the raw DSEC-Det wires: the port's train step on the
'compact' and 'events' wires against frn_tpu's, and the port's three wires
against each other, on the CPU.

A tiny fusion detector (DSEC-Det 96x128, depth 18, feature size 32,
modality dropout 0: the packages draw it from different generators) with
seeded weights (``test_torch_detector.seeded_variables``, the
classification bias at the 0.01 prior and the output convs scaled down, so
that the loss is O(1), under the recipe's skip threshold of 50), the
DSEC-Det CLI's recipe (Adam lr 5e-5, clip 1.0, an optimizer step every
micro-step, loss_skip_threshold 50), two micro-steps on the fixture's
samples (100 ms windows) at batch 2.

Tolerances:
  * the port against frn_tpu on one wire: the losses of each micro-step
    rtol 1e-4 (f32, another summation order); the parameters after the first
    micro-step (one Adam step) as ``test_torch_train_slice.py`` holds them:
    every element within 2 lr (plus f32 rounding of the parameter), all but
    1e-3 of the elements within lr / 100, and the elements the step moved by
    lr / 2 or more the same in both packages;
  * the port's compact and events steps against its f32 step: losses rtol
    1e-5 and parameters atol 1e-5 after both micro-steps, as
    ``tests/test_events_wire.py`` holds frn_tpu's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.data.collate import collate_fixed as jcollate
from frn_tpu.data.dsec_det import DSECDetDataset as JDataset
from frn_tpu.models.detector import FRNDetector as JDetector
from frn_tpu.train import loop as jloop
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.data.collate import collate_fixed
from frn_tpu_torch.data.dsec_det import DSECDetDataset
from frn_tpu_torch.data.synthetic import make_dsec_det_fixture
from frn_tpu_torch.models.detector import FRNDetector
from frn_tpu_torch.train.loop import create_train_state, make_train_step
from test_torch_detector import seeded_variables

H, W = 96, 128
LR = 5e-5
CAP = 8192
MODEL_KW = dict(variant="fusion", depth=18, num_classes=2, feature_size=32, modality_dropout=0.0)
TRAIN_KW = dict(batch_size=2, learning_rate=LR, grad_clip_norm=1.0, accum_steps=1,
                plateau_factor=0.5, loss_skip_threshold=50.0, max_annots_per_image=8)
WIRES = ("f32", "compact", "events")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_dsec_det_fixture(str(tmp_path_factory.mktemp("dsec_det_train")),
                                 num_sequences=2, frames_per_sequence=6,
                                 geometry=dataclasses.replace(tconfig.DSEC_DET, height=H, width=W))


def _configs(wire):
    jgeo = dataclasses.replace(jconfig.DSEC_DET, height=H, width=W)
    tgeo = dataclasses.replace(tconfig.DSEC_DET, height=H, width=W)
    return (jconfig.FrameworkConfig(geometry=jgeo, model=jconfig.ModelConfig(**MODEL_KW),
                                    train=jconfig.TrainConfig(input_wire=wire, **TRAIN_KW)),
            tconfig.FrameworkConfig(geometry=tgeo, model=tconfig.ModelConfig(**MODEL_KW),
                                    train=tconfig.TrainConfig(input_wire=wire, **TRAIN_KW)))


def _batches(root, wire, dataset_cls, geo, collate):
    ds = dataset_cls(root, geometry=geo, time_window_us=100_000, compact_wire=wire == "compact",
                     events_wire=wire == "events", event_capacity=CAP)
    return [collate([ds[2 * i], ds[2 * i + 1]], geo, 8) for i in range(2)]


@pytest.fixture(scope="module")
def trajectories(root):
    """Each package's losses and parameters over two micro-steps per wire,
    from the same seeded weights (frn_tpu on the compact and events wires)."""
    jcfg, tcfg = _configs("f32")
    jmodel = JDetector(jcfg)
    variables = seeded_variables(jmodel, jcfg.geometry, seed=1)
    cls_out = variables["params"]["classificationModel"]["output"]["Conv_0"]
    reg_out = variables["params"]["regressionModel"]["output"]["Conv_0"]
    cls_out["bias"] = np.full_like(cls_out["bias"], -np.log((1 - 0.01) / 0.01))
    cls_out["kernel"] = cls_out["kernel"] * 0.1
    reg_out["kernel"] = reg_out["kernel"] * 0.1
    init = state_dict_from_jax(variables)
    out = {"init": init}
    for wire in ("compact", "events"):
        jcfg, _ = _configs(wire)
        tx = jloop.make_optimizer(jcfg)
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        state = jloop.TrainState(params=params,
                                 batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                    variables["batch_stats"]),
                                 opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        step = jloop.make_train_step(jmodel, tx, jcfg, donate=False)
        losses, after_first = [], None
        for batch in _batches(root, wire, JDataset, jcfg.geometry, jcollate):
            state, metrics = step(state, batch, jax.random.PRNGKey(7))
            losses.append(float(metrics["loss"]))
            if after_first is None:
                after_first = state_dict_from_jax({"params": jax.device_get(state.params)})
        out[("jax", wire)] = losses, after_first
    for wire in WIRES:
        _, tcfg = _configs(wire)
        model = FRNDetector(tcfg)
        model.load_state_dict(init, strict=True)
        state = create_train_state(tcfg, model=model)
        step = make_train_step(tcfg)
        losses, skipped, params = [], [], []
        for batch in _batches(root, wire, DSECDetDataset, tcfg.geometry, collate_fixed):
            metrics = step(state, batch, None)
            losses.append(metrics["loss"].item())
            skipped.append(metrics["skipped"].item())
            params.append({n: p.detach().clone() for n, p in zip(state.names, state.params)})
        out[("port", wire)] = losses, params, skipped
    return out


@pytest.mark.parametrize("wire", ["compact", "events"])
def test_wire_losses_equal_jax_each_micro_step(trajectories, wire):
    got, _, skipped = trajectories[("port", wire)]
    want, _ = trajectories[("jax", wire)]
    assert skipped == [0.0, 0.0] and all(np.isfinite(want)) and max(want) < 50
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("wire", ["compact", "events"])
def test_wire_params_after_the_first_step_equal_jax(trajectories, wire):
    got = trajectories[("port", wire)][1][0]
    want = trajectories[("jax", wire)][1]
    init = trajectories["init"]
    assert sorted(got) == sorted(want)
    diffs, moved_port, moved_jax = [], [], []
    for name, w in want.items():
        d = (got[name] - w).abs()
        assert d.max().item() <= 2 * LR * (1 + 1e-3) + 1e-6 * w.abs().max().item(), name
        diffs.append(d.flatten())
        moved_port.append((got[name] - init[name]).abs().flatten() >= 0.5 * LR)
        moved_jax.append((w - init[name]).abs().flatten() >= 0.5 * LR)
    d = torch.cat(diffs)
    assert (d > LR / 100).float().mean().item() <= 1e-3
    moved_port, moved_jax = torch.cat(moved_port), torch.cat(moved_jax)
    assert moved_jax.sum().item() > 1e6
    assert (moved_port != moved_jax).sum().item() <= 1e-3 * moved_jax.sum().item()


@pytest.mark.parametrize("wire", ["compact", "events"])
def test_port_wire_steps_equal_the_f32_step(trajectories, wire):
    got_losses, got_params, _ = trajectories[("port", wire)]
    want_losses, want_params, _ = trajectories[("port", "f32")]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    for name, w in want_params[-1].items():
        np.testing.assert_allclose(got_params[-1][name].numpy(), w.numpy(), atol=1e-5, err_msg=name)
