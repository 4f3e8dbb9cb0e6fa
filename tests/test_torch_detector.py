"""The whole slice: the port's detector + pooled decode + NMS against frn_tpu's.

The JAX detector's variables are seeded numpy draws (``seeded_variables``),
with random head output convs so that detections exist. The weights go to the
port through ``state_dict_from_jax``; both run at f32 on the CPU on the same
seeded numpy inputs, the JAX side with the exact candidate pool.

Tolerances: raw logits and deltas rtol 1e-4, atol 1e-4 * max|ref| (f32 with
another summation order); detections: the same valid-slot count, identical
labels, scores within 1e-5 and boxes within 1e-3 px.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.models import detector as jdetector
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.entry import InferenceFn, dsec_fusion_config, entry
from frn_tpu_torch.models import detector as tdetector

CASES = {
    "dsec_r18": ("dsec", 64, 96, 18, "fusion"),
    "ddd17_r18": ("ddd17", 52, 70, 18, "fusion"),
    "dsec_r50": ("dsec", 64, 96, 50, "fusion"),
    "dsec_r18_rgb": ("dsec", 64, 96, 18, "rgb"),
    "ddd17_r18_event": ("ddd17", 52, 70, 18, "event"),
}


def configs(geometry, height, width, depth, variant="fusion"):
    """The same tiny configuration in both packages."""
    model_kw = dict(variant=variant, depth=depth, feature_size=32, attention_chunk=64)
    jgeo = dataclasses.replace(jconfig.geometry_for(geometry), height=height, width=width)
    tgeo = dataclasses.replace(tconfig.geometry_for(geometry), height=height, width=width)
    jcfg = jconfig.FrameworkConfig(
        geometry=jgeo, model=jconfig.ModelConfig(num_classes=jgeo.num_classes, **model_kw),
        eval=jconfig.EvalConfig(approx_topk=False))
    tcfg = tconfig.FrameworkConfig(
        geometry=tgeo, model=tconfig.ModelConfig(num_classes=tgeo.num_classes, **model_kw))
    return jcfg, tcfg


def seeded_variables(jmodel, geo, seed):
    """The JAX detector's variable tree (shapes from ``jax.eval_shape`` of its
    init) filled with seeded numpy values.

    The stock init is not used: with identity BN its residual stream doubles
    its variance at every block, and at depth 50 the logits reach ~2e4, where
    a test compares saturated sigmoids. Here the kernels are fan-in scaled
    (He gain in the backbones and head towers), the frozen-BN statistics are
    non-trivial, each residual branch's last BN scale is cut to a fifth, and
    both heads' output convs are random (zero at init, which scores every
    anchor at the 0.01 prior, under the 0.05 threshold), so that detections
    exist. Logits come out O(1)-O(10).
    """
    rgb = jnp.zeros((1, geo.height, geo.width, 3))
    event = jnp.zeros((1, geo.height, geo.width, geo.event_channels))
    shapes = jax.eval_shape(
        lambda r: jmodel.init({"params": r, "modality": r}, rgb, event, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [p.key for p in path if p.key != "Conv_0"]
        top, owner, leaf_name, shape = names[1], names[-2], names[-1], leaf.shape
        block = names[2] if len(names) > 3 else ""
        if leaf_name == "kernel":
            if owner == "output":
                gain = 1.0 if top == "classificationModel" else 0.1
            elif top.endswith(("backbone", "Model")):
                gain = np.sqrt(2.0)
            else:
                gain = 0.5 if owner.startswith("conv0") else 1.0
            x = rng.normal(0, gain / np.sqrt(np.prod(shape[:-1])), shape)
        elif leaf_name == "scale":
            stages = shapes["params"][top].get(block, {}) if block.startswith("layer") else {}
            last_bn = owner == ("bn3" if "bn3" in stages else "bn2") and bool(stages)
            x = rng.uniform(0.5, 1.5, shape) * (0.2 if last_bn else 1.0)
        elif leaf_name == "var":
            x = rng.uniform(0.5, 2.0, shape)
        elif leaf_name == "bias" and owner == "output" and top == "classificationModel":
            x = rng.normal(-1.0, 1.0, shape)
        else:  # conv/BN bias, BN mean
            x = rng.normal(0, 0.1, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    """Both packages' raw outputs and detections on one seeded batch of 2."""
    jcfg, tcfg = configs(*CASES[request.param])
    jmodel = jdetector.FRNDetector(jcfg)
    variables = seeded_variables(jmodel, jcfg.geometry, seed=1)
    tmodel = tdetector.FRNDetector(tcfg)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmodel.eval()
    geo = jcfg.geometry
    rng = np.random.default_rng(2)
    rgb = rng.normal(0, 1, (2, geo.height, geo.width, 3)).astype(np.float32)
    event = rng.normal(0, 1, (2, geo.height, geo.width, geo.event_channels)).astype(np.float32)

    eval_output = jdetector.eval_output_for(jcfg)
    assert tdetector.eval_output_for(tcfg) == eval_output == "logits_chanlast36"
    jfwd = jax.jit(jmodel.apply, static_argnames=("train", "eval_output"))
    jraw = jfwd(variables, jnp.asarray(rgb), jnp.asarray(event), train=False, eval_output=eval_output)
    jdet = jax.jit(lambda c, r: jdetector.decode_detections(c, r, jcfg))(*jraw)
    jprobs = jfwd(variables, jnp.asarray(rgb), jnp.asarray(event), train=False)
    with torch.no_grad():
        traw = tmodel(torch.tensor(rgb), torch.tensor(event), eval_output=eval_output)
        tdet = tdetector.decode_detections(*traw, tcfg)
        tprobs = tmodel(torch.tensor(rgb), torch.tensor(event))
    as_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return {"jax": (as_np(jraw), as_np(jdet), as_np(jprobs)),
            "port": (as_np(traw), as_np(tdet), as_np(tprobs)),
            "probs_dtypes": (tprobs[0].dtype, tprobs[1].dtype)}


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_raw_outputs_match(both):
    (want_cls, want_reg), _, _ = both["jax"]
    (got_cls, got_reg), _, _ = both["port"]
    assert got_cls.shape == want_cls.shape and got_reg.shape == want_reg.shape
    assert_close(got_cls, want_cls)
    assert_close(got_reg, want_reg)


def test_detections_match(both):
    _, (w_scores, w_labels, w_boxes), _ = both["jax"]
    _, (g_scores, g_labels, g_boxes), _ = both["port"]
    assert g_labels.dtype == np.int32
    assert int((g_labels >= 0).sum()) == int((w_labels >= 0).sum()) > 0
    np.testing.assert_array_equal(g_labels, w_labels)
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(g_boxes, w_boxes, rtol=0, atol=1e-3)


def test_probs_emission_matches(both):
    # the reference contract: f32 sigmoid scores (B, A, K) and f32 rows (B, A, 4)
    _, _, (want_cls, want_reg) = both["jax"]
    _, _, (got_cls, got_reg) = both["port"]
    assert both["probs_dtypes"] == (torch.float32, torch.float32)
    assert_close(got_cls, want_cls)
    assert_close(got_reg, want_reg)


def test_decode_rejects_mismatched_layout():
    _, tcfg = configs(*CASES["dsec_r18"])
    a = tdetector.image_anchors(tcfg, "cpu").shape[0]
    with pytest.raises(ValueError, match="anchor dim"):
        tdetector.decode_detections(torch.zeros(1, a, 3), torch.zeros(1, a // 9, 36), tcfg)
    with pytest.raises(ValueError, match="reg_flat36"):
        tdetector.decode_detections(torch.zeros(1, 3, a), torch.zeros(1, a, 4), tcfg)


def test_entry_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdetector.init_detector(configs(*CASES["dsec_r18"])[1])


def test_entry_builds_on_cpu_when_asked():
    # the full DSEC ResNet-50 model is built on the CPU but not run there
    fn, (rgb, event) = entry(device="cpu", batch=1)
    assert {p.device.type for p in fn.model.parameters()} == {"cpu"}
    assert {p.dtype for p in fn.model.parameters()} == {torch.float32}
    assert fn.model.compute_dtype == torch.bfloat16 and fn.anchors.shape == (230220, 4)
    assert rgb.shape == (1, 480, 640, 3) and event.shape == (1, 480, 640, 5)
    assert rgb.device.type == event.device.type == "cpu"


def test_inference_fn_runs_on_cpu():
    _, tcfg = configs(*CASES["dsec_r18"])
    fn = InferenceFn(tdetector.init_detector(tcfg, seed=0, device="cpu"), tcfg)
    rgb, event = torch.randn(2, 64, 96, 3), torch.randn(2, 64, 96, 5)
    scores, labels, boxes = fn(rgb, event)
    m = tcfg.eval.max_detections
    assert scores.shape == labels.shape == (2, m) and boxes.shape == (2, m, 4)
    assert labels.dtype == torch.int32
    assert torch.isfinite(scores).all() and torch.isfinite(boxes).all()


def test_entry_default_is_the_dsec_fusion_r50_bf16_model():
    cfg = tconfig.FrameworkConfig(geometry=tconfig.DSEC, model=tconfig.ModelConfig(
        variant="fusion", depth=50, num_classes=3, compute_dtype="bfloat16"))
    assert dsec_fusion_config() == cfg
    assert cfg.model.feature_size == 256
