"""The heads' options of the port against frn_tpu's, f32 on the CPU.

``fused_dual_heads`` (``ModelConfig.fused_heads``) and the
``FRN_DISABLE_FLASH`` route decision. Both packages take the same seeded
numpy inputs and weights (``state_dict_from_jax``).

Tolerances:
  * the fused heads against frn_tpu's and against the port's unfused heads:
    atol 5e-6 on the probabilities, 1e-5 on the deltas, the bounds of
    ``tests/test_models.py``'s fused-heads test (grouped convs sum in
    another order); their gradients atol 1e-3, rtol 1e-4, that test's;
  * the detector with fused heads against frn_tpu's: rtol 1e-4, atol 1e-4 *
    max|ref| ('probs' emission, as ``test_torch_detector.py``); a training
    loss rtol 1e-4 and its gradients 1e-3 of each tensor's max|ref| (the
    theta biases, zero in exact arithmetic, 1e-3 of the model's largest),
    as ``test_torch_train_slice.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.models import detector as jdetector
from frn_tpu.models import heads as jheads
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.data.collate import collate_fixed
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.models import detector as tdetector
from frn_tpu_torch.models import heads as theads
from frn_tpu_torch.ops import attention
from test_torch_detector import seeded_variables
from test_torch_modules import nchw, port_state

RNG = np.random.default_rng(31)
FUSED_CLS_ATOL, FUSED_REG_ATOL = 5e-6, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_head_variables(module, x, seed=0):
    """Every leaf of the head's variables N(0, 0.1^2): a nonzero output conv."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), dict(shapes))


def _heads(num_classes, feature_size=32, seed=0):
    """Both packages' heads on the same random weights: (JAX modules and
    variables, port heads). Every leaf N(0, 0.1^2), the draws of
    ``tests/test_models.py``'s fused-heads test, the output convs included."""
    x = jnp.zeros((1, 8, 8, feature_size))
    jcls = jheads.ClassificationHead(num_classes=num_classes, num_anchors=9,
                                     feature_size=feature_size, prior=0.01)
    jreg = jheads.RegressionHead(num_anchors=9, feature_size=feature_size)
    vcls = _random_head_variables(jcls, x, seed=seed)
    vreg = _random_head_variables(jreg, x, seed=seed + 1)
    tcls = theads.ClassificationHead(num_classes, 9, feature_size)
    treg = theads.RegressionHead(9, feature_size)
    tcls.load_state_dict(port_state(vcls, "classificationModel", "classificationModel."))
    treg.load_state_dict(port_state(vreg, "regressionModel", "regressionModel."))
    return (jcls, vcls, jreg, vreg), (tcls, treg)


def _features(shapes, channels=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, h, w, channels)).astype(np.float32) for h, w in shapes]


# ------------------------------------------------------------ fused dual heads


@pytest.mark.parametrize("num_classes", [3, 1, 5], ids=["k3_cls_padded", "k1_cls_padded",
                                                        "k5_reg_padded"])
def test_fused_dual_heads_match_jax(num_classes):
    (jcls, vcls, jreg, vreg), (tcls, treg) = _heads(num_classes)
    feats = _features([(30, 40), (15, 20), (8, 10)], seed=num_classes)
    want_cls, want_reg = jheads.fused_dual_heads(
        vcls["params"], vreg["params"], [jnp.asarray(f) for f in feats], num_classes, 9)
    with torch.no_grad():
        got_cls, got_reg = theads.fused_dual_heads(tcls, treg, [nchw(f) for f in feats],
                                                   num_classes, 9)
        unfused_cls, unfused_reg = theads.apply_heads(tcls, treg, [nchw(f) for f in feats])
    assert got_cls.dtype == torch.float32 and got_cls.shape == want_cls.shape
    assert got_reg.shape == want_reg.shape == unfused_reg.shape
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=FUSED_CLS_ATOL, rtol=0)
    np.testing.assert_allclose(got_reg.numpy(), np.asarray(want_reg), atol=FUSED_REG_ATOL, rtol=0)
    np.testing.assert_allclose(got_cls.numpy(), unfused_cls.numpy(), atol=FUSED_CLS_ATOL, rtol=0)
    np.testing.assert_allclose(got_reg.numpy(), unfused_reg.numpy(), atol=FUSED_REG_ATOL, rtol=0)


@pytest.mark.parametrize("num_classes", [3, 5])
def test_fused_dual_heads_gradients_match(num_classes):
    """Autograd reaches both towers' parameters through the fused heads: their
    gradients against the port's unfused heads and against jax.grad of
    frn_tpu's fused heads."""
    (jcls, vcls, jreg, vreg), (tcls, treg) = _heads(num_classes, seed=7)
    feats = _features([(12, 16), (6, 8)], seed=8)
    jf = [jnp.asarray(f) for f in feats]

    def j_loss(params):
        c, r = jheads.fused_dual_heads(params[0], params[1], jf, num_classes, 9)
        return jnp.sum(c) + jnp.sum(jnp.abs(r))

    j_cls_g, j_reg_g = jax.grad(j_loss)((vcls["params"], vreg["params"]))
    want = state_dict_from_jax({"params": jax.device_get(
        {"classificationModel": j_cls_g, "regressionModel": j_reg_g})})

    def t_grads(fused):
        params = [p for h in (tcls, treg) for p in h.parameters()]
        tf = [nchw(f) for f in feats]
        c, r = (theads.fused_dual_heads(tcls, treg, tf, num_classes, 9) if fused
                else theads.apply_heads(tcls, treg, tf))
        grads = torch.autograd.grad(c.sum() + r.abs().sum(), params)
        names = [f"classificationModel.{n}" for n, _ in tcls.named_parameters()] + [
            f"regressionModel.{n}" for n, _ in treg.named_parameters()]
        return dict(zip(names, grads))

    fused, unfused = t_grads(True), t_grads(False)
    assert sorted(fused) == sorted(want)
    for name, w in want.items():
        assert fused[name].abs().max() > 0, name
        np.testing.assert_allclose(fused[name].numpy(), w.numpy(), atol=1e-3, rtol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(fused[name].numpy(), unfused[name].numpy(), atol=1e-3,
                                   rtol=1e-4, err_msg=name)


def test_fused_dual_heads_cast_to_the_compute_dtype():
    (_, vcls, _, vreg), (tcls, treg) = _heads(3, seed=11)
    feats = [nchw(f) for f in _features([(6, 8), (3, 4)], seed=12)]
    with torch.no_grad():
        cls, reg = theads.fused_dual_heads(tcls, treg, feats, 3, 9, dtype=torch.bfloat16)
        want_cls, want_reg = theads.apply_heads(tcls, treg, [f.bfloat16() for f in feats])
    assert cls.dtype == torch.float32 and reg.dtype == torch.bfloat16
    # bf16 convs in another grouping: a bf16 ulp of the pre-sigmoid logits
    np.testing.assert_allclose(cls.numpy(), want_cls.numpy(), atol=2e-2, rtol=0)
    np.testing.assert_allclose(reg.float().numpy(), want_reg.float().numpy(), atol=2e-2, rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in tcls.parameters())


# ------------------------------------------------------------ the detector


def _detector_configs(**model_kw):
    kw = dict(variant="fusion", depth=18, num_classes=3, feature_size=16, attention_chunk=64,
              modality_dropout=0.0, fused_heads=True, **model_kw)
    jgeo = dataclasses.replace(jconfig.DSEC, height=32, width=48)
    tgeo = dataclasses.replace(tconfig.DSEC, height=32, width=48)
    return (jconfig.FrameworkConfig(geometry=jgeo, model=jconfig.ModelConfig(**kw)),
            tconfig.FrameworkConfig(geometry=tgeo, model=tconfig.ModelConfig(**kw)))


@pytest.fixture(scope="module")
def fused_detectors():
    jcfg, tcfg = _detector_configs()
    jmodel = jdetector.FRNDetector(jcfg)
    variables = seeded_variables(jmodel, jcfg.geometry, seed=3)
    tmodel = tdetector.FRNDetector(tcfg)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmodel.eval()
    batch = collate_fixed(box_samples(2, tcfg.geometry, seed=5), tcfg.geometry, 4, 2)
    return jcfg, tcfg, jmodel, variables, tmodel, batch


def test_detector_fused_heads_probs_match_jax(fused_detectors):
    jcfg, tcfg, jmodel, variables, tmodel, batch = fused_detectors
    want = jmodel.apply(variables, jnp.asarray(batch["rgb"]), jnp.asarray(batch["event"]),
                        train=False)
    unfused = tdetector.FRNDetector(dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, fused_heads=False)))
    unfused.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        got = tmodel(torch.tensor(batch["rgb"]), torch.tensor(batch["event"]))
        plain = unfused.eval()(torch.tensor(batch["rgb"]), torch.tensor(batch["event"]))
        # the logits emissions ignore fused_heads, as in frn_tpu
        logits = tmodel(torch.tensor(batch["rgb"]), torch.tensor(batch["event"]),
                        eval_output="logits_chanlast36")
        plain_logits = unfused(torch.tensor(batch["rgb"]), torch.tensor(batch["event"]),
                               eval_output="logits_chanlast36")
    for g, p, w in zip(got, plain, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=1e-4, atol=1e-4 * np.abs(w).max())
    for g, p in zip(logits, plain_logits):
        torch.testing.assert_close(g, p, atol=0, rtol=0)


def test_detector_fused_heads_training_loss_and_gradients_match_jax(fused_detectors):
    jcfg, tcfg, jmodel, variables, tmodel, batch = fused_detectors
    rgb, event, annot = (jnp.asarray(batch[k]) for k in ("rgb", "event", "annot"))

    def j_loss(params):
        cls, reg = jmodel.apply({**variables, "params": params}, rgb, event, train=True)
        return sum(jdetector.detection_loss(cls, reg, annot, jcfg))

    j_value, j_grads = jax.value_and_grad(j_loss)(variables["params"])
    want = state_dict_from_jax({"params": jax.device_get(j_grads)})
    names = [n for n, _ in tmodel.named_parameters()]
    cls, reg = tmodel(torch.tensor(batch["rgb"]), torch.tensor(batch["event"]), train=True,
                      drop=False)
    loss = sum(tdetector.detection_loss(cls, reg, torch.tensor(batch["annot"]), tcfg))
    grads = dict(zip(names, torch.autograd.grad(loss, list(tmodel.parameters()))))
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=1e-4)
    scale = max(w.abs().max().item() for n, w in want.items() if n in grads)
    assert scale > 0
    for name, g in grads.items():
        w = want[name]
        ref = scale if name.endswith("theta.bias") else w.abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= 1e-3 * ref, (name, err, ref)
    assert grads["classificationModel.conv1.weight"].abs().max() > 0
    assert grads["regressionModel.conv4.weight"].abs().max() > 0


# ------------------------------------------------------------ FRN_DISABLE_FLASH


@pytest.mark.parametrize("value,raises", [(None, False), ("", False), ("0", True), ("1", True)],
                         ids=["unset", "empty", "zero", "one"])
def test_disable_flash_route_decision(monkeypatch, value, raises):
    """Any non-empty FRN_DISABLE_FLASH, "0" included (frn_tpu tests ``not
    os.environ.get(...)``), makes a call that the kernels would take raise:
    the port has no dense route on the card. It is read on every call, and
    the dense route's own cases do not look at it."""
    monkeypatch.delenv("FRN_DISABLE_FLASH", raising=False)
    assert attention.flash_route(True, attention.FLASH_MIN_TOKENS, 32)
    if value is not None:
        monkeypatch.setenv("FRN_DISABLE_FLASH", value)
    for hw, d in ((attention.FLASH_MIN_TOKENS, 32), (19200, 64)):
        if raises:
            with pytest.raises(RuntimeError, match="FRN_DISABLE_FLASH"):
                attention.flash_route(True, hw, d)
        else:
            assert attention.flash_route(True, hw, d)
    # a CPU tensor, a short sequence or a wide head takes the dense route
    # whatever the variable says
    assert not attention.flash_route(False, 19200, 32)
    assert not attention.flash_route(True, attention.FLASH_MIN_TOKENS - 1, 32)
    assert not attention.flash_route(True, 19200, 128)
    monkeypatch.delenv("FRN_DISABLE_FLASH", raising=False)
    assert attention.flash_route(True, 19200, 32)
