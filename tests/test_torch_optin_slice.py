"""The opt-in inference path of the port against frn_tpu's, on the CPU.

``ModelConfig.stem_kernel``, ``flash_exp_bf16``, ``attention_quant`` and
``fused_attention``. Off the TPU the JAX detector takes its conv stem and the
dense attention whatever the flags, and so does the port off the card (the
stem's plain version, which folds the frozen BN, and the dense route): these
tests check the wiring, the BN fold and the fused dual attention, at f32.

Tolerances: modules and the detector rtol 1e-4, atol 1e-4 * max|ref| (f32 in
another summation order), detections as in ``test_torch_detector.py``; the
fused attention against the unfused one in the same package atol 1e-5 *
max|ref|, rtol 1e-5 (f32 reassociation, as ``tests/test_models.py`` pins it),
their gradients atol 5e-4 rtol 1e-4 (the JAX test's); a training forward
with every flag against one without, loss rtol 1e-5 and gradients rtol 1e-4,
atol 1e-4 * the largest gradient.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu.models import detector as jdetector
from frn_tpu.models import fusion as jfusion
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.entry import dsec_fusion_config, entry
from frn_tpu_torch.models import detector as tdetector
from frn_tpu_torch.models import fusion as tfusion
from frn_tpu_torch.models import resnet as tresnet
from test_torch_detector import configs, seeded_variables
from test_torch_modules import assert_close, nchw, port_state, random_variables, to_nhwc

RNG = np.random.default_rng(23)
ALL_FLAGS = dict(stem_kernel=True, flash_exp_bf16=True, attention_quant="int8",
                 fused_attention=True)
SLICE_CASES = {
    "stem_bf16exp_fused": dict(stem_kernel=True, flash_exp_bf16=True, fused_attention=True),
    "int8_fused": dict(attention_quant="int8", fused_attention=True),
}


def _with_flags(cfg, **flags):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **flags))


def _tiny(**flags):
    """TINY_DSEC (64x96, depth 18) in both packages, with ``flags``."""
    jcfg, tcfg = configs("dsec", 64, 96, 18)
    return _with_flags(jcfg, **flags), _with_flags(tcfg, **flags)


# ------------------------------------------------------------ fused dual attention


def _refusion_inputs():
    a = RNG.normal(0, 1, (2, 6, 10, 64)).astype(np.float32)
    b = RNG.normal(0, 1, (2, 6, 10, 64)).astype(np.float32)
    jmod = jfusion.REFusion(channels=64, chunk=16)
    variables = random_variables(jmod, jnp.asarray(a), jnp.asarray(b), seed=5)
    return a, b, variables


def _port_refusion(variables, fused):
    mod = tfusion.REFusion(64, chunk=16, fused_attention=fused)
    mod.load_state_dict(port_state(variables, "fus_0", "fus.0."), strict=True)
    return mod


def test_fused_refusion_matches_jax_and_the_unfused_port():
    a, b, variables = _refusion_inputs()
    want = jfusion.REFusion(channels=64, chunk=16, fused_attention=True).apply(
        variables, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = _port_refusion(variables, True)(nchw(a), nchw(b))
        unfused = _port_refusion(variables, False)(nchw(a), nchw(b))
    assert got.shape == (2, 128, 6, 10)
    assert_close(to_nhwc(got), want)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=1e-5,
                               atol=1e-5 * float(unfused.abs().max()))


def test_fused_refusion_gradients_match_the_unfused():
    a, b, variables = _refusion_inputs()
    grads = []
    for fused in (True, False):
        mod = _port_refusion(variables, fused)
        loss = (mod(nchw(a), nchw(b)) ** 2).sum()
        grads.append(dict(zip((n for n, _ in mod.named_parameters()),
                              torch.autograd.grad(loss, list(mod.parameters())))))
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        np.testing.assert_allclose(grads[0][name].numpy(), grads[1][name].numpy(), atol=5e-4,
                                   rtol=1e-4, err_msg=name)


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module", params=list(SLICE_CASES))
def slice_outputs(request):
    """Both detectors with the case's flags on one seeded batch of 2: raw
    outputs, detections, and how often the port ran its stem op."""
    jcfg, tcfg = _tiny(**SLICE_CASES[request.param])
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
    jraw = jax.jit(jmodel.apply, static_argnames=("train", "eval_output"))(
        variables, jnp.asarray(rgb), jnp.asarray(event), train=False, eval_output=eval_output)
    jdet = jax.jit(lambda c, r: jdetector.decode_detections(c, r, jcfg))(*jraw)

    stem_calls = []
    stem_fn = tresnet.stem_conv_bn_relu
    tresnet.stem_conv_bn_relu = lambda *args: stem_calls.append(1) or stem_fn(*args)
    try:
        with torch.no_grad():
            traw = tmodel(torch.tensor(rgb), torch.tensor(event), eval_output=eval_output)
    finally:
        tresnet.stem_conv_bn_relu = stem_fn
    tdet = tdetector.decode_detections(*traw, tcfg)
    as_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return {"case": request.param, "jax": (as_np(jraw), as_np(jdet)),
            "port": (as_np(traw), as_np(tdet)), "stem_calls": len(stem_calls)}


def test_slice_raw_outputs_match(slice_outputs):
    (want_cls, want_reg), _ = slice_outputs["jax"]
    (got_cls, got_reg), _ = slice_outputs["port"]
    assert got_cls.shape == want_cls.shape and got_reg.shape == want_reg.shape
    assert_close(got_cls, want_cls)
    assert_close(got_reg, want_reg)
    # the stem option runs the fused stem op once per backbone
    want_stem = 2 if SLICE_CASES[slice_outputs["case"]].get("stem_kernel") else 0
    assert slice_outputs["stem_calls"] == want_stem


def test_slice_detections_match(slice_outputs):
    _, (w_scores, w_labels, w_boxes) = slice_outputs["jax"]
    _, (g_scores, g_labels, g_boxes) = slice_outputs["port"]
    assert int((g_labels >= 0).sum()) == int((w_labels >= 0).sum()) > 0
    np.testing.assert_array_equal(g_labels, w_labels)
    np.testing.assert_allclose(g_scores, w_scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(g_boxes, w_boxes, rtol=0, atol=1e-3)


# ------------------------------------------------------------ training and wiring


def _tiny_port_pair():
    """The tiny port detector with every opt-in flag, and without, sharing
    seeded weights."""
    jcfg, tcfg = _tiny()
    variables = seeded_variables(jdetector.FRNDetector(jcfg), jcfg.geometry, seed=3)
    models = []
    for cfg in (_with_flags(tcfg, **ALL_FLAGS), tcfg):
        model = tdetector.FRNDetector(cfg)
        model.load_state_dict(state_dict_from_jax(variables), strict=True)
        models.append(model)
    return models


def test_flags_add_no_parameters():
    flagged, plain = _tiny_port_pair()
    assert flagged.state_dict().keys() == plain.state_dict().keys()
    for key, value in plain.state_dict().items():
        torch.testing.assert_close(flagged.state_dict()[key], value, atol=0, rtol=0)


def test_training_forward_ignores_the_inference_flags(monkeypatch):
    # loss and gradients of a training forward with every flag set equal those
    # without (fused_attention applies in training too, as in the JAX package:
    # the same function up to f32 summation order)
    flagged, plain = _tiny_port_pair()
    rng = np.random.default_rng(4)
    rgb = torch.tensor(rng.normal(0, 1, (2, 64, 96, 3)).astype(np.float32))
    event = torch.tensor(rng.normal(0, 1, (2, 64, 96, 5)).astype(np.float32))
    annot = torch.tensor([[[5.0, 6.0, 40.0, 30.0, 0.0], [50.0, 10.0, 90.0, 60.0, 2.0]],
                          [[10.0, 20.0, 30.0, 50.0, 1.0], [-1.0, -1.0, -1.0, -1.0, -1.0]]])
    seen = []
    attention = tfusion.nonlocal_attention
    monkeypatch.setattr(tfusion, "nonlocal_attention",
                        lambda *a, **kw: seen.append((kw["exp_bf16"], kw["quant"])) or attention(*a, **kw))
    monkeypatch.setattr(tresnet, "stem_conv_bn_relu",
                        lambda *a: pytest.fail("the stem op ran in a training forward"))
    results = []
    for model in (flagged, plain):
        model.train()
        cls, reg = model(rgb, event, train=True, drop=False)
        loss = sum(tdetector.detection_loss(cls, reg, annot, model.config))
        results.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    assert seen and set(seen) == {(False, None)}
    (loss_f, grads_f), (loss_p, grads_p) = results
    torch.testing.assert_close(loss_f, loss_p, rtol=1e-5, atol=0)
    # atol against the largest gradient: some (the cross-attention theta
    # biases) are zero in exact arithmetic and rounding noise in both
    scale = max(float(g.abs().max()) for g in grads_p)
    for gf, gp in zip(grads_f, grads_p):
        torch.testing.assert_close(gf, gp, rtol=1e-4, atol=1e-4 * scale)


def test_eval_forward_passes_the_flags_down(monkeypatch):
    flagged, _ = _tiny_port_pair()
    seen, stems = [], []
    attention, stem_fn = tfusion.nonlocal_attention, tresnet.stem_conv_bn_relu
    monkeypatch.setattr(tfusion, "nonlocal_attention",
                        lambda *a, **kw: seen.append((kw["exp_bf16"], kw["quant"])) or attention(*a, **kw))
    monkeypatch.setattr(tresnet, "stem_conv_bn_relu", lambda *a: stems.append(1) or stem_fn(*a))
    flagged.eval()
    with torch.no_grad():
        flagged(torch.zeros(1, 64, 96, 3), torch.zeros(1, 64, 96, 5))
    # fused: one attention call per fusion stage, over both directions
    assert seen == [(True, "int8")] * 4 and len(stems) == 2


def test_odd_input_takes_the_conv_stem(monkeypatch):
    monkeypatch.setattr(tresnet, "stem_conv_bn_relu",
                        lambda *a: pytest.fail("the stem op ran on an odd input"))
    bb = tresnet.ResNetBackbone(3, (2, 2, 2, 2), False)
    with torch.no_grad():
        feats = bb(torch.zeros(1, 3, 33, 48), stem_kernel=True)
    assert feats[0].shape == (1, 64, 9, 12)


def test_entry_takes_model_config_fields():
    cfg = dsec_fusion_config(**ALL_FLAGS)
    assert cfg.model == dataclasses.replace(dsec_fusion_config().model, **ALL_FLAGS)
    with pytest.raises(TypeError):
        dsec_fusion_config(no_such_option=True)
    assert dsec_fusion_config(fused_heads=True).model.fused_heads  # ported: no longer raises
    fn, (rgb, event) = entry(device="cpu", batch=1, attention_quant="int8_qk", stem_kernel=True)
    assert fn.config.model.attention_quant == "int8_qk" and fn.config.model.stem_kernel
    assert all(f.fused_attention is False for f in fn.model.fus)
    assert rgb.shape == (1, 480, 640, 3) and event.shape == (1, 480, 640, 5)
    assert isinstance(fn.config.model, tconfig.ModelConfig)
