"""Data-parallel training: two gloo ranks against one process and frn_tpu's mesh.

At ``tests/test_torch_train_slice.py``'s scale (fusion depth 18, feature size
16, 32x48, f32, accum_steps 2, no modality dropout) and from its initial
state (frn_tpu's ``create_train_state`` with seeded head output convs,
carried over by ``state_dict_from_jax``), on one seeded global batch of 2:

  * frn_tpu's train step on a 2-device mesh (``jax.devices()[:2]``, params
    replicated, the batch sharded over 'data');
  * the port's train step in one process, on the whole batch;
  * the port's train step in two gloo ranks (``parallel.launch.run_ranks``,
    one CPU process each), each on its row, the gradients all-reduced.

Each takes two micro-steps (the second the Adam step). Tolerances are
``test_torch_train_slice.py``'s one-step comparison's, which its docstring
derives: losses rtol 1e-4; the first micro-step's gradient sum 1e-3 of each
tensor's largest value (the theta biases 1e-3 of the model's largest
gradient); the parameters after the Adam step within 2 lr, all but 1e-3 of
the elements within lr / 100. The two ranks end bit for bit equal.

The same process group also runs the loss-skip threshold between the shard
losses and the global one, and ``Trainer.fit`` with rank 0 alone writing the
checkpoint and the JSONL, against the single process's.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu.parallel.mesh import make_mesh as j_make_mesh
from frn_tpu.parallel.mesh import replicate as j_replicate
from frn_tpu.parallel.mesh import shard_batch as j_shard_batch
from frn_tpu.train.loop import create_train_state as j_create_train_state
from frn_tpu.train.loop import make_train_step as j_make_train_step
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.data.collate import collate_fixed
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.models.detector import FRNDetector, detection_loss
from frn_tpu_torch.parallel.launch import run_ranks
from frn_tpu_torch.train.loop import create_train_state, make_train_step
from frn_tpu_torch.train.trainer import Trainer
from test_torch_train_slice import _configs, _tree_to_torch
from torch_parallel_ranks import LR, TRAINER_SAMPLES, two_micro_steps

# a rank's collectives, and the whole two-rank run, fail after this long
RANKS_TIMEOUT_S = 240.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shard_losses(model, batch, tcfg):
    """Each row's loss alone at the initial weights (the loss a rank of a
    2-rank run sees before the all-reduce)."""
    out = []
    with torch.no_grad():
        for i in range(2):
            row = {k: torch.from_numpy(batch[k][i: i + 1]) for k in ("rgb", "event", "annot")}
            cls, reg = model(row["rgb"], row["event"], train=True, drop=False)
            out.append(sum(detection_loss(cls, reg, row["annot"], tcfg)).item())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp"))
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
    init = state_dict_from_jax({"params": jax.device_get(jstate.params),
                                "batch_stats": jax.device_get(jstate.batch_stats)})
    torch.save(init, os.path.join(root, "init.pt"))
    np.savez(os.path.join(root, "batch.npz"), **{k: batch[k] for k in ("rgb", "event", "annot")})

    # frn_tpu on a 2-device mesh
    mesh = j_make_mesh(devices=jax.devices()[:2])
    jstep = j_make_train_step(jmodel, tx, jcfg, donate=False)
    jstate = j_replicate(jstate, mesh)
    jbatch = j_shard_batch({k: jnp.asarray(batch[k]) for k in ("rgb", "event", "annot")}, mesh)
    j_losses = []
    for i in range(2):
        jstate, metrics = jstep(jstate, jbatch, jax.random.PRNGKey(i + 1))
        j_losses.append(float(metrics["loss"]))
        if i == 0:
            j_acc = _tree_to_torch(jstate.opt_state.acc_grads)
    jax_run = {"losses": j_losses, "acc": j_acc, "params": _tree_to_torch(jstate.params)}

    # the port in one process
    model = FRNDetector(tcfg)
    model.load_state_dict(init, strict=True)
    shard_losses = _shard_losses(model, batch, tcfg)
    state = create_train_state(tcfg, model=model)
    step = make_train_step(tcfg)
    single = {"metrics": []}
    for i in range(2):
        m = step(state, batch, None)
        single["metrics"].append({k: v.item() for k, v in m.items()})
        if i == 0:
            single["acc"] = {n: a.clone() for n, a in zip(state.names, state.acc_grads)}
    single["params"] = {n: p.detach().clone() for n, p in zip(state.names, state.params)}

    # the port in two gloo ranks; thresholds: between the mean and the
    # larger shard loss (one shard alone would skip, the global loss steps),
    # and between the smaller and the mean (one alone would step, the global
    # loss skips)
    lo, hi = sorted(shard_losses)
    mean = (lo + hi) / 2
    thresholds = [(mean + hi) / 2, (lo + mean) / 2]
    ranks = run_ranks(two_micro_steps, 2, args=(root, thresholds), device="cpu",
                      timeout_s=RANKS_TIMEOUT_S, threads=1)
    saved = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=True) for r in range(2)]

    # the trainer in one process, for the checkpoint the ranks' rank 0 wrote
    trainer = Trainer(tcfg, box_samples(TRAINER_SAMPLES, tcfg.geometry, seed=5), seed=0,
                      device="cpu", checkpoint_dir=os.path.join(root, "ckpt_single"),
                      eval_fn=lambda model, state: 0.25, eval_every=1, log_every=1,
                      metrics_path=os.path.join(root, "metrics_single.jsonl"))
    single["history"] = trainer.fit(1)
    return {"root": root, "jax": jax_run, "single": single, "ranks": ranks, "saved": saved,
            "init": init, "thresholds": thresholds, "shard_losses": shard_losses}


def _assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    scale = max(w.abs().max().item() for w in want.values())
    assert scale > 0
    for name, w in want.items():
        ref = scale if name.endswith("theta.bias") else w.abs().max().item()
        err = (got[name] - w).abs().max().item()
        assert err <= 1e-3 * ref, (name, err, ref)


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want)
    diffs = []
    for name, w in want.items():
        d = (got[name] - w).abs()
        assert d.max().item() <= 2 * LR * (1 + 1e-3) + 1e-6 * w.abs().max().item(), name
        diffs.append(d.flatten())
    assert (torch.cat(diffs) > LR / 100).float().mean().item() <= 1e-3


def test_all_reduce_mean_over_two_ranks(runs):
    for reduced in (r["reduced"] for r in runs["ranks"]):
        assert reduced == [[1.5] * 3, [[15.0, 15.0], [15.0, 15.0]]]


@pytest.mark.parametrize("ref", ["single", "jax"])
def test_losses_match_each_micro_step(runs, ref):
    """Every rank reports the global loss: the mean of its shards'."""
    want = ([m["loss"] for m in runs["single"]["metrics"]] if ref == "single"
            else runs["jax"]["losses"])
    for rank in runs["ranks"]:
        got = [m["loss"] for m in rank["metrics"]]
        assert [m["skipped"] for m in rank["metrics"]] == [0.0, 0.0]
        np.testing.assert_allclose(got, want, rtol=1e-4)
    if ref == "single":
        for key in ("cls_loss", "reg_loss"):
            np.testing.assert_allclose([m[key] for m in runs["ranks"][0]["metrics"]],
                                       [m[key] for m in runs["single"]["metrics"]], rtol=1e-4)


@pytest.mark.parametrize("ref", ["single", "jax"])
def test_first_micro_step_gradients_match(runs, ref):
    _assert_grads_close(runs["saved"][0]["acc"], runs[ref]["acc"])


@pytest.mark.parametrize("ref", ["single", "jax"])
def test_params_after_the_adam_step_match(runs, ref):
    _assert_params_close(runs["saved"][0]["params"], runs[ref]["params"])
    assert all(tuple(r["counters"]) == (2, 1, 0) for r in runs["ranks"])


def test_the_two_ranks_hold_the_same_state(runs):
    a, b = runs["saved"]
    for key in ("acc", "params"):
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)


@pytest.mark.parametrize("case", ["step", "skip"])
def test_loss_skip_reads_the_global_loss(runs, case):
    """Threshold between the global loss and one shard's: both ranks step
    (where that shard alone would skip) or both skip (where it alone would
    step), and a skipped micro-step leaves no gradient."""
    i = {"step": 0, "skip": 1}[case]
    thr, (lo, hi) = runs["thresholds"][i], sorted(runs["shard_losses"])
    assert (lo < thr < (lo + hi) / 2) if case == "skip" else ((lo + hi) / 2 < thr < hi)
    results = [r["skips"][i] for r in runs["ranks"]]
    skipped, losses, norms = zip(*results)
    assert skipped == ((1.0, 1.0) if case == "skip" else (0.0, 0.0))
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], (lo + hi) / 2, rtol=1e-4)
    assert all((n == 0.0) == (case == "skip") for n in norms)


def test_rank_0_alone_writes_the_checkpoint_and_the_jsonl(runs):
    root, ranks = runs["root"], runs["ranks"]
    assert os.path.exists(os.path.join(root, "metrics_0.jsonl"))
    assert not os.path.exists(os.path.join(root, "metrics_1.jsonl"))
    got = [json.loads(line) for line in open(os.path.join(root, "metrics_0.jsonl"))]
    want = [json.loads(line) for line in open(os.path.join(root, "metrics_single.jsonl"))]
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want], rtol=1e-4)
    # rank 0 alone evaluated; both ranks hold its mAP
    assert [len(r["eval_calls"]) for r in ranks] == [1, 0]
    assert [r["best_map"] for r in ranks] == [0.25, 0.25]
    assert ranks[0]["trainer_params"] == ranks[1]["trainer_params"]
    np.testing.assert_allclose(ranks[0]["history"], runs["single"]["history"], rtol=1e-4)

    got = torch.load(os.path.join(root, "ckpt", "checkpoint_1.pt"), weights_only=True)
    want = torch.load(os.path.join(root, "ckpt_single", "checkpoint_1.pt"), weights_only=True)
    assert sorted(got) == sorted(want)
    assert (got["epoch"], got["best_map"], got["step"], got["opt_steps"]) == (
        want["epoch"], want["best_map"], want["step"], want["opt_steps"])
    np.testing.assert_allclose(got["loss_history"], want["loss_history"], rtol=1e-4)
    names = [n for n in want["model_state_dict"] if n in runs["single"]["params"]]
    _assert_params_close({n: got["model_state_dict"][n] for n in names},
                         {n: want["model_state_dict"][n] for n in names})
