"""The postprocess options of the port against frn_tpu's, on the CPU.

The top-k of the candidate pool (``exact_topk``, ``exact_topk_two_stage``)
against ``lax.top_k`` and against frn_tpu's three pools (``approx_max_k``,
the two-stage top-k, the radix select), all of which the port's one pool
stands for; the dense postprocess (``class_aware_nms``,
``batched_detection_postprocess``, ``decode_detections(postprocess='dense')``)
and the pooled rungs against frn_tpu under each of its pool settings; and
``cli.test --postprocess dense --approx_topk``. Inputs are seeded numpy
arrays fed to both packages at f32.

Tolerances: the top-k algorithms, the pools and the dense NMS bit for bit
(values, indices, labels, boxes). Where a package decodes deltas (``exp``)
or takes a sigmoid, torch's and XLA's may differ in the last ulp: the pooled
rungs as ``test_torch_nms.py`` (labels equal, scores within 1e-6 where the
pool is of logits, else bit for bit, boxes within 1e-4 px);
``decode_detections(postprocess='dense')`` scores and labels bit for bit,
boxes within 1e-3 px, as ``test_torch_detector.py``. The
CLIs as ``test_torch_eval_slice.py``: detections' scores within 1e-5, boxes
within 1e-3 px, per-class APs within 1e-9.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.cli import test as jcli
from frn_tpu.core import anchors as janchors
from frn_tpu.core import boxes as jboxes
from frn_tpu.core import nms as jnms
from frn_tpu.data.synthetic import make_csv_fixture
from frn_tpu.models import detector as jdetector
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import test as tcli
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.core import nms as tnms
from frn_tpu_torch.models import detector as tdetector
from test_torch_detector import seeded_variables

RNG = np.random.default_rng(41)
H, W = 64, 96
TORCH_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x):
    """A float array's bit pattern (bf16 widened to f32 exactly)."""
    x = np.asarray(x.float() if isinstance(x, torch.Tensor) else x)
    return x.astype(np.float32).view(np.int32)


def _topk_cases():
    """(rows (R, A) f32, k): ties, signed zeros at the k-th value, k near A;
    the '_two_stage' cases with 64 * k < A."""
    rng = np.random.default_rng(3)
    coarse = (rng.integers(-3, 4, (3, 5000)) * 0.5).astype(np.float32)
    signed = np.zeros((2, 3000), np.float32)
    signed[:, ::3] = -0.0
    signed[:, 7::50] = rng.uniform(0.1, 1.0, (2, 60))
    signed[:, 11::97] = -rng.uniform(0.1, 1.0, (2, 31))
    pool = np.where(rng.random((2, 9000)) < 0.95, 0.0, rng.random((2, 9000))).astype(np.float32)
    normal = rng.normal(0, 1, (2, 4096)).astype(np.float32)
    # wide enough for both stages of the two-stage top-k (64 * k < A)
    wide = np.zeros((2, 20000), np.float32)
    wide[:, ::3] = -0.0
    wide[:, 7::300] = rng.uniform(0.1, 1.0, (2, 67))
    wide[:, 11::97] = -rng.uniform(0.1, 1.0, (2, 207))
    return {"ties": (coarse, 400), "signed_zeros": (signed, 100), "thresholded": (pool, 400),
            "k_near_a": (normal[:, :401], 400), "k_is_a": (normal[:, :400], 400),
            "small_k": (normal, 7), "ties_two_stage": (coarse, 7),
            "signed_zeros_two_stage": (wide, 80)}


TOPK_CASES = _topk_cases()


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
@pytest.mark.parametrize("case", list(TOPK_CASES))
@pytest.mark.parametrize("algorithm", ["exact_topk", "two_stage", "radix"])
def test_topk_algorithms_match_jax(algorithm, case, dtype):
    """The port's top-k against frn_tpu's algorithm of the same setting
    (``exact_topk``: ``lax.top_k``; 'two_stage' and 'radix', the
    ``exact_pool`` values: the port's pool, ``exact_topk_two_stage``, for
    both), values bit for bit and indices equal; and always equal to
    ``lax.top_k`` itself. frn_tpu's radix select differs from it, and so from
    the port, only where -0.0 and +0.0 straddle the k-th value (it ranks them
    equal before its last sort): equal values there, other signs and
    indices."""
    s, k = TOPK_CASES[case]
    jdt, tdt = TORCH_DTYPES[dtype]
    js, ts = jnp.asarray(s).astype(jdt), torch.tensor(s).to(tdt)
    jfn, tfn = {"exact_topk": (jax.lax.top_k, tnms.exact_topk),
                "two_stage": (jnms.exact_topk_two_stage, tnms.exact_topk_two_stage),
                "radix": (jnms.radix_select_topk, tnms.exact_topk_two_stage)}[algorithm]
    want_v, want_i = jax.vmap(lambda x: jfn(x, k))(js)
    got_v, got_i = tfn(ts, k)
    assert got_v.dtype == tdt and got_v.shape == got_i.shape == (s.shape[0], k)
    if algorithm == "radix" and case.startswith("signed_zeros"):
        np.testing.assert_array_equal(got_v.float().numpy(), np.asarray(want_v, np.float32))
        assert not np.array_equal(got_i.numpy(), np.asarray(want_i))
    else:
        np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    top_v, top_i = jax.vmap(lambda x: jax.lax.top_k(x, k))(js)
    np.testing.assert_array_equal(_bits(got_v), _bits(top_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(top_i))


@pytest.mark.parametrize("num_blocks", [1, 8, 64, 256])
def test_two_stage_nonnegative_key_matches_jax(num_blocks):
    """The int32-bitcast key of nonnegative f32 scores, at several block counts
    (1 and 256 at k 40 over 9,000 take a single top-k)."""
    s, _ = TOPK_CASES["thresholded"]
    want_v, want_i = jax.vmap(lambda x: jnms.exact_topk_two_stage(
        x, 40, num_blocks=num_blocks, nonnegative=True))(jnp.asarray(s))
    got_v, got_i = tnms.exact_topk_two_stage(torch.tensor(s), 40, num_blocks=num_blocks,
                                             nonnegative=True)
    assert got_v.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("case", ["ties", "signed_zeros", "thresholded", "k_near_a", "small_k"])
def test_approx_pool_is_lax_top_k_off_the_tpu(case):
    """``approx_max_k`` on the CPU (XLA's sort-and-slice fallback) equals
    ``lax.top_k`` at f32, ties and signed zeros included: the port's pool,
    ``exact_topk_two_stage``, gives it bit for bit."""
    s, k = TOPK_CASES[case]
    want_v, want_i = jax.vmap(lambda x: jax.lax.approx_max_k(x, k, recall_target=0.99))(
        jnp.asarray(s))
    got_v, got_i = tnms.exact_topk_two_stage(torch.tensor(s), k)
    np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


# ------------------------------------------------------------ the dense postprocess


def _dense_inputs(batch=3, num_classes=3):
    """Decoded, clipped boxes (B, A, 4) of the 64x96 anchors and (B, A, K)
    probabilities: exact score ties across anchors, a class with nothing
    above the threshold in image 0, and image 2 all below it."""
    anchors = janchors.anchors_for_shape((H, W))
    a = anchors.shape[0]
    deltas = RNG.normal(0, 1, (batch, a, 4)).astype(np.float32)
    boxes = np.asarray(jboxes.clip_boxes(jboxes.decode_boxes(jnp.asarray(anchors),
                                                             jnp.asarray(deltas)), (H, W)))
    probs = (1.0 / (1.0 + np.exp(-RNG.normal(-2.0, 2.0, (batch, a, num_classes))))).astype(np.float32)
    probs[0, :60] = probs[0, 60:120]  # ties across anchors
    probs[0, 200:260, 1] = 0.75  # a run of equal scores in one class
    probs[0, :, 2] *= 0.04  # nothing above 0.05 in class 2 of image 0
    probs[-1] *= 0.04  # image 2: nothing above the threshold
    return anchors, deltas, boxes, probs


# frn_tpu's pool settings (approx_topk, exact_pool); the port's one pool
# stands for each
DENSE_POOLS = [(True, "two_stage"), (False, "two_stage"), (False, "radix")]


@pytest.mark.parametrize("approx_topk,exact_pool", DENSE_POOLS,
                         ids=["approx", "two_stage", "radix"])
def test_batched_detection_postprocess_matches_jax(approx_topk, exact_pool):
    _, _, boxes, probs = _dense_inputs()
    kw = dict(score_threshold=0.05, iou_threshold=0.5, per_class_topk=200, max_detections=100)
    want = jax.jit(lambda b, s: jnms.batched_detection_postprocess(
        b, s, approx_topk=approx_topk, exact_pool=exact_pool, **kw))(
        jnp.asarray(boxes), jnp.asarray(probs))
    got = tnms.batched_detection_postprocess(torch.tensor(boxes), torch.tensor(probs), **kw)
    assert got[1].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    labels = got[1].numpy()
    assert (labels[0] >= 0).sum() > 0 and 2 not in labels[0]
    assert (labels[2] == -1).all() and (got[0][2] == 0).all()


@pytest.mark.parametrize("approx_topk", [True, False])
def test_class_aware_nms_matches_jax(approx_topk):
    """One image, a pool of 300 over 4,608 anchors, a detection cap above the
    K * T pool (the padded tail: score 0, label -1)."""
    _, _, boxes, probs = _dense_inputs(batch=1)
    kw = dict(score_threshold=0.05, iou_threshold=0.5, per_class_topk=300, max_detections=1000)
    want = jnms.class_aware_nms(jnp.asarray(boxes[0]), jnp.asarray(probs[0]),
                                approx_topk=approx_topk, **kw)
    got = tnms.class_aware_nms(torch.tensor(boxes[0]), torch.tensor(probs[0]), **kw)
    assert got[0].shape == (1000,) and got[2].shape == (1000, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1][900:] == -1).all() and (got[0][900:] == 0).all()


@pytest.mark.parametrize("approx_topk,exact_pool", DENSE_POOLS,
                         ids=["approx", "two_stage", "radix"])
def test_pooled_postprocess_pools_match_jax(approx_topk, exact_pool):
    """The pooled rungs, pooled_chanlast on logits (with the logit-space
    sentinel) and pooled on probabilities, against frn_tpu with each pool."""
    anchors, deltas, _, probs = _dense_inputs()
    logits = np.log(probs) - np.log1p(-probs)
    for scores, logit, class_major in ((probs, False, False),
                                       (np.ascontiguousarray(logits.transpose(0, 2, 1)), True,
                                        True)):
        kw = dict(score_threshold=0.05, iou_threshold=0.5, per_class_topk=200,
                  max_detections=100, logits=logit, class_major=class_major)
        want = jax.jit(lambda d, s: jnms.pooled_detection_postprocess(
            jnp.asarray(anchors), d, s, (H, W), approx_topk=approx_topk, exact_pool=exact_pool,
            **kw))(jnp.asarray(deltas), jnp.asarray(scores))
        got = tnms.pooled_detection_postprocess(torch.tensor(anchors), torch.tensor(deltas),
                                                torch.tensor(scores), (H, W), **kw)
        # the sigmoid of the logit pool runs in each package: an ulp apart
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                                   atol=1e-6 if logit else 0)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=0)


# ------------------------------------------------------------ decode_detections


@pytest.fixture(scope="module")
def probs_outputs():
    """frn_tpu's tiny DSEC fusion detector (64x96, depth 18) on seeded inputs:
    its 'probs' emission, which both packages' dense decode then takes."""
    model_kw = dict(variant="fusion", depth=18, feature_size=16, attention_chunk=64,
                    num_classes=3)
    jgeo = dataclasses.replace(jconfig.DSEC, height=H, width=W)
    jcfg = jconfig.FrameworkConfig(geometry=jgeo, model=jconfig.ModelConfig(**model_kw))
    jmodel = jdetector.FRNDetector(jcfg)
    variables = seeded_variables(jmodel, jgeo, seed=1)
    rng = np.random.default_rng(2)
    rgb = rng.normal(0, 1, (2, H, W, 3)).astype(np.float32)
    event = rng.normal(0, 1, (2, H, W, 5)).astype(np.float32)
    cls, reg = jmodel.apply(variables, jnp.asarray(rgb), jnp.asarray(event), train=False)
    return model_kw, np.asarray(cls), np.asarray(reg)


@pytest.mark.parametrize("approx_topk,exact_pool", DENSE_POOLS,
                         ids=["approx", "two_stage", "radix"])
def test_decode_detections_dense_matches_jax(probs_outputs, approx_topk, exact_pool):
    model_kw, cls, reg = probs_outputs
    ev = dict(postprocess="dense", approx_topk=approx_topk, exact_pool=exact_pool)
    jcfg = jconfig.FrameworkConfig(
        geometry=dataclasses.replace(jconfig.DSEC, height=H, width=W),
        model=jconfig.ModelConfig(**model_kw), eval=jconfig.EvalConfig(**ev))
    tcfg = tconfig.FrameworkConfig(
        geometry=dataclasses.replace(tconfig.DSEC, height=H, width=W),
        model=tconfig.ModelConfig(**model_kw), eval=tconfig.EvalConfig(**ev))
    assert tdetector.eval_output_for(tcfg) == jdetector.eval_output_for(jcfg) == "probs"
    want = jax.jit(lambda c, r: jdetector.decode_detections(c, r, jcfg))(cls, reg)
    got = tdetector.decode_detections(torch.tensor(cls), torch.tensor(reg), tcfg,
                                      anchors=torch.tensor(np.asarray(jdetector.image_anchors(jcfg))))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3, rtol=0)
    assert (got[1].numpy() >= 0).sum() > 0
    # the port's pooled rung on the same outputs gives the same detections
    pooled = tdetector.decode_detections(torch.tensor(cls), torch.tensor(reg), dataclasses.replace(
        tcfg, eval=dataclasses.replace(tcfg.eval, postprocess="pooled")))
    for g, p in zip(got, pooled):
        torch.testing.assert_close(g, p, atol=0, rtol=0)


def test_eval_config_defaults_and_options_match_jax():
    assert tconfig.EvalConfig().approx_topk is jconfig.EvalConfig().approx_topk is True
    ev = tconfig.EvalConfig(approx_topk=True, postprocess="dense", exact_pool="radix")
    assert (ev.approx_topk, ev.postprocess, ev.exact_pool) == (True, "dense", "radix")
    with pytest.raises(ValueError, match="exact_pool"):
        tconfig.EvalConfig(exact_pool="bitonic")


# ------------------------------------------------------------ both CLIs


def test_both_eval_clis_agree_dense_approx(tmp_path, capsys):
    """``cli.test --postprocess dense --approx_topk`` of both packages on one
    tiny fixture and the same seeded weights."""
    model_kw = dict(variant="fusion", depth=18, feature_size=16, num_classes=3)
    jgeo = dataclasses.replace(jconfig.DSEC, height=H, width=W)
    jmodel = jdetector.FRNDetector(jconfig.FrameworkConfig(
        geometry=jgeo, model=jconfig.ModelConfig(**model_kw)))
    state = state_dict_from_jax(seeded_variables(jmodel, jgeo, seed=1))
    pth = str(tmp_path / "model.pth")
    torch.save({"model_state_dict": state, "epoch": 1}, pth)
    fix = make_csv_fixture(str(tmp_path / "fix"), geometry=jgeo, num_images=4, seed=2)
    flags = ["--csv_classes", fix["class_map_csv"], "--root_img", fix["img_dir"],
             "--root_event", fix["event_dir"], "--csv_test", fix["annotations_csv"],
             "--image_height", str(H), "--image_width", str(W), "--depth", "18",
             "--feature_size", "16", "--checkpoint", pth, "--batch_size", "2",
             "--postprocess", "dense", "--approx_topk"]
    out = {}
    for name, main, more in (("jax", jcli.main, ()), ("port", tcli.main, ("--device", "cpu"))):
        folder = str(tmp_path / name)
        assert main(flags + ["--save_detect_folder", folder, *more]) == 0
        printed = capsys.readouterr().out
        summary = json.loads(printed[printed.index("{"):printed.rindex("}") + 1])
        with open(os.path.join(folder, "evaluation_aps.pkl"), "rb") as f:
            aps = pickle.load(f)
        with open(os.path.join(folder, "detections.txt"), "rb") as f:
            dets = pickle.load(f)
        out[name] = summary, aps, dets
    (j_summary, j_aps, j_dets), (t_summary, t_aps, t_dets) = out["jax"], out["port"]
    n = 0
    for g_img, w_img in zip(t_dets, j_dets):
        for g, w in zip(g_img, w_img):
            assert g.shape == w.shape
            np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5, rtol=0)
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3, rtol=0)
            n += len(g)
    assert n > 0 and len(t_dets) == len(j_dets) == 4
    assert t_aps.keys() == j_aps.keys()
    for k in j_aps:
        np.testing.assert_allclose(t_aps[k], j_aps[k], atol=1e-9, rtol=0)
    assert t_summary.keys() == j_summary.keys()
    for key in j_summary:
        assert abs(t_summary[key] - j_summary[key]) <= 1e-4  # printed rounded to 4 places
