"""The training slice as a whole: the port's train step against frn_tpu's.

A tiny fusion detector (depth 18, feature size 16, 32x48 so that H != W,
modality dropout 0, f32, accum_steps 2) starts from frn_tpu's
``create_train_state`` parameters, carried over with ``state_dict_from_jax``.
The heads' output convs start at zero there, which leaves every other layer
without a gradient; both are replaced by the same seeded numpy draws, so that
the gradient reaches the backbones, the fusion and its attention.
Both packages take two micro-steps on the same seeded batch; the second is
the Adam step. The JAX step is compiled once for the file (module fixture).

Tolerances:
  * losses of each micro-step: rtol 1e-4 (f32, another summation order);
  * the first micro-step's gradients, as the running clipped sum both leave
    after it: max|diff| / max|ref| <= 1e-3 per tensor. The theta biases of
    the cross-attention blocks are the exception: a per-query constant added
    to every score leaves the softmax unchanged, so their gradients are zero
    in exact arithmetic and what both packages compute is f32 rounding noise;
    they are held at 1e-3 of the largest gradient of the model;
  * the parameters after the Adam step: the first Adam step moves an element
    by lr * g / (|g| + eps), about lr whatever the gradient's size, so the
    two packages can differ by up to 2 lr where a tiny gradient's sign is
    rounding noise. Every element is held within 2 lr (plus f32 rounding of
    the parameter), all but 1e-3 of the elements within lr / 100, and the
    elements the step moved by lr / 2 or more are the same in both packages.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.train.loop import create_train_state as j_create_train_state
from frn_tpu.train.loop import make_train_step as j_make_train_step
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.data.collate import collate_fixed
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.models.detector import FRNDetector
from frn_tpu_torch.train.loop import create_train_state, make_train_step

LR = 1e-4
MODEL_KW = dict(variant="fusion", depth=18, num_classes=3, feature_size=16, attention_chunk=64,
                modality_dropout=0.0)
TRAIN_KW = dict(batch_size=2, learning_rate=LR, accum_steps=2, max_annots_per_image=4)


def _configs():
    jgeo = dataclasses.replace(jconfig.DSEC, height=32, width=48)
    tgeo = dataclasses.replace(tconfig.DSEC, height=32, width=48)
    jcfg = jconfig.FrameworkConfig(geometry=jgeo, model=jconfig.ModelConfig(**MODEL_KW),
                                   train=jconfig.TrainConfig(**TRAIN_KW))
    tcfg = tconfig.FrameworkConfig(geometry=tgeo, model=tconfig.ModelConfig(**MODEL_KW),
                                   train=tconfig.TrainConfig(**TRAIN_KW))
    return jcfg, tcfg


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; torch's default of one
    intra-op thread per core in each of them oversubscribes the CPU, and these
    small shapes gain nothing from more than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree_to_torch(tree):
    return state_dict_from_jax({"params": jax.device_get(tree)})


@pytest.fixture(scope="module")
def trajectories():
    jcfg, tcfg = _configs()
    batch = collate_fixed(box_samples(2, tcfg.geometry, seed=3), tcfg.geometry, 4, 2)

    jmodel, jstate, tx = j_create_train_state(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jstate.params))
    for head in ("classificationModel", "regressionModel"):
        kernel = params[head]["output"]["Conv_0"]["kernel"]
        params[head]["output"]["Conv_0"]["kernel"] = rng.normal(
            0, 0.1 / np.sqrt(np.prod(kernel.shape[:3])), kernel.shape).astype(np.float32)
    jstate = jstate.replace(params=params, opt_state=tx.init(params))
    jstep = j_make_train_step(jmodel, tx, jcfg, donate=False)
    jbatch = {k: jnp.asarray(batch[k]) for k in ("rgb", "event", "annot")}
    init = {"params": jax.device_get(jstate.params),
            "batch_stats": jax.device_get(jstate.batch_stats)}
    j_losses, j_acc = [], None
    for i in range(2):
        jstate, metrics = jstep(jstate, jbatch, jax.random.PRNGKey(i + 1))
        j_losses.append(float(metrics["loss"]))
        if i == 0:
            j_acc = _tree_to_torch(jstate.opt_state.acc_grads)
    j_params = _tree_to_torch(jstate.params)

    model = FRNDetector(tcfg)
    model.load_state_dict(state_dict_from_jax(init), strict=True)
    state = create_train_state(tcfg, model=model)
    step = make_train_step(tcfg)
    t_losses, t_acc, skipped = [], None, []
    for i in range(2):
        metrics = step(state, batch, None)
        t_losses.append(metrics["loss"].item())
        skipped.append(metrics["skipped"].item())
        if i == 0:
            t_acc = {n: a.clone() for n, a in zip(state.names, state.acc_grads)}
    t_params = {n: p.detach().clone() for n, p in zip(state.names, state.params)}
    init_params = state_dict_from_jax(init)
    return {"losses": (t_losses, j_losses), "acc": (t_acc, j_acc),
            "params": (t_params, j_params, init_params), "skipped": skipped,
            "state": state}


def test_losses_match_each_micro_step(trajectories):
    got, want = trajectories["losses"]
    assert trajectories["skipped"] == [0.0, 0.0]
    assert all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_first_micro_step_gradients_match(trajectories):
    got, want = trajectories["acc"]
    assert sorted(got) == sorted(want)
    scale = max(w.abs().max().item() for w in want.values())
    assert scale > 0
    for name, w in want.items():
        ref = w.abs().max().item()
        if name.endswith("theta.bias"):  # zero in exact arithmetic: rounding noise
            ref = scale
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-3 * ref, (name, err, ref)


def test_params_after_the_adam_step_match(trajectories):
    got, want, init = trajectories["params"]
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
    # the step moved the same elements by about lr in both packages (at 32x48
    # most taps of stage 4's 3x3 kernels see only padding and get no gradient)
    moved_port, moved_jax = torch.cat(moved_port), torch.cat(moved_jax)
    assert moved_jax.sum().item() > 1e6
    assert (moved_port != moved_jax).sum().item() <= 1e-3 * moved_jax.sum().item()
    state = trajectories["state"]
    assert (state.step, state.opt_steps, state.mini_step) == (2, 1, 0)
