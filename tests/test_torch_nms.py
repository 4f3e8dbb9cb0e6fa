"""The port's pooled decode and NMS against the JAX package's exact pool, on the CPU.

Inputs are seeded numpy arrays fed to both. The JAX side runs with
``approx_topk=False`` (its two-stage exact pool), the port with its one
pool (the ``lax.top_k`` result); the port's pool is held against each of
frn_tpu's in ``test_torch_postprocess_options.py``.
Labels and valid-slot counts must be identical, scores agree within 1e-6 and
boxes within 1e-4 px (f32 decode in another operation order).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu.core import anchors as janchors
from frn_tpu.core import nms as jnms
from frn_tpu_torch.core import nms as tnms

RNG = np.random.default_rng(23)
LO = np.float32(-3.4e38)


def _tie_cases():
    ties = np.array([0.5, 0.0, 0.5, 0.0, 0.9, 0.5, 0.0, 0.9], np.float32)
    zeros = np.zeros(37, np.float32)
    zeros[[3, 20, 30]] = [0.2, 0.7, 0.2]
    sentinel = np.full(50, LO, np.float32)
    sentinel[[5, 7, 40, 41]] = [1.5, -2.0, 1.5, 3.0]
    coarse = RNG.integers(-3, 4, size=(3, 600)).astype(np.float32)  # many ties per row
    return {"ties": (ties, 6), "zeros": (zeros, 10), "sentinels": (sentinel, 12),
            "coarse_rows": (coarse, 400)}


@pytest.mark.parametrize("case", list(_tie_cases()))
def test_exact_topk_matches_lax_top_k_with_ties(case):
    s, k = _tie_cases()[case]
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(s), k)
    got_vals, got_idx = tnms.exact_topk(torch.tensor(s), k)
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(want_vals))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_greedy_nms_mask_matches():
    # clustered boxes so suppression chains are several links deep
    t = 120
    centers = RNG.uniform(10, 60, size=(t, 2))
    sizes = RNG.uniform(5, 20, size=(t, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=1).astype(np.float32)
    scores = np.sort(RNG.uniform(0, 1, t).astype(np.float32))[::-1].copy()
    scores[-15:] = 0.0  # padding slots are never kept
    want = jnms.greedy_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5)
    got = tnms.greedy_nms_mask(torch.tensor(boxes), torch.tensor(scores), 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < t - 15


def _postprocess_inputs(shape, num_classes, class_major, logits, flat36, batch=2):
    anchors = janchors.anchors_for_shape(shape)
    a = anchors.shape[0]
    if logits:
        scores = RNG.normal(-2.0, 2.0, size=(batch, a, num_classes)).astype(np.float32)
        scores[0, :50] = scores[0, 50:100]  # exact score ties across anchors
    else:
        scores = (1.0 / (1.0 + np.exp(-RNG.normal(-2.0, 2.0, size=(batch, a, num_classes))))).astype(np.float32)
        scores[-1] *= 0.04  # the last image has nothing above the 0.05 threshold
    if class_major:
        scores = np.ascontiguousarray(scores.transpose(0, 2, 1))
    deltas = RNG.normal(0, 1, size=(batch, a, 4)).astype(np.float32)
    if flat36:
        deltas = deltas.reshape(batch, a // 9, 36)
    return anchors, deltas, scores


@pytest.mark.parametrize(
    "class_major,logits,flat36,shape,num_classes",
    [(True, True, True, (64, 96), 3),     # the default pooled_chanlast + reg_flat36
     (True, True, True, (52, 70), 1),     # DDD17-like, one class
     (False, True, False, (64, 96), 3),   # pooled_logits
     (False, False, False, (64, 96), 3)],  # pooled (probabilities)
    ids=["chanlast36", "chanlast36_ddd17", "logits_rows", "probs_rows"],
)
def test_pooled_detection_postprocess_matches(class_major, logits, flat36, shape, num_classes):
    anchors, deltas, scores = _postprocess_inputs(shape, num_classes, class_major, logits, flat36)
    kw = dict(score_threshold=0.05, iou_threshold=0.5, per_class_topk=400, max_detections=100,
              logits=logits, class_major=class_major)
    want = jnms.pooled_detection_postprocess(
        jnp.asarray(anchors), jnp.asarray(deltas), jnp.asarray(scores), shape,
        approx_topk=False, **kw)
    got = tnms.pooled_detection_postprocess(
        torch.tensor(anchors), torch.tensor(deltas), torch.tensor(scores), shape, **kw)
    w_scores, w_labels, w_boxes = (np.asarray(x) for x in want)
    g_scores, g_labels, g_boxes = (x.numpy() for x in got)
    assert g_labels.dtype == np.int32 and g_scores.shape == (2, 100) and g_boxes.shape == (2, 100, 4)
    np.testing.assert_array_equal(g_labels, w_labels)
    assert int((g_labels >= 0).sum()) == int((w_labels >= 0).sum()) > 0
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=1e-6)
    np.testing.assert_allclose(g_boxes, w_boxes, rtol=0, atol=1e-4)


def test_postprocess_pads_when_pool_is_small():
    # K*T < max_detections: the output is padded with score 0, label -1
    anchors, deltas, scores = _postprocess_inputs((64, 96), 1, True, True, True, batch=1)
    kw = dict(per_class_topk=20, max_detections=50, logits=True, class_major=True)
    want = jnms.pooled_detection_postprocess(
        jnp.asarray(anchors), jnp.asarray(deltas), jnp.asarray(scores), (64, 96),
        approx_topk=False, **kw)
    got = tnms.pooled_detection_postprocess(
        torch.tensor(anchors), torch.tensor(deltas), torch.tensor(scores), (64, 96), **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy()[:, 20:] == -1).all() and (got[0].numpy()[:, 20:] == 0).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-4)
