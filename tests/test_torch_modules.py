"""Each module of the port against its frn_tpu counterpart, f32 on the CPU.

Both sides take the same numpy inputs and the same seeded weights: the flax
variable tree (shapes from ``jax.eval_shape``) is filled with numpy draws and
carried to the port by ``state_dict_from_jax``. Tolerance: rtol 1e-4 and atol
1e-4 * max|ref| (f32 with a different summation order).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu.config import DDD17 as JDDD17, DSEC as JDSEC, AnchorConfig as JAnchorConfig
from frn_tpu.core import anchors as janchors
from frn_tpu.core import boxes as jboxes
from frn_tpu.models import fusion as jfusion
from frn_tpu.models.fpn import PyramidFeatures as JPyramid
from frn_tpu.models.heads import ClassificationHead as JCls, RegressionHead as JReg, apply_heads as japply
from frn_tpu.models.resnet import ResNetBackbone as JResNet
from frn_tpu.ops.attention import nonlocal_attention as jnonlocal, reference_view_to_nhwc

from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.core import anchors as tanchors
from frn_tpu_torch.core import boxes as tboxes
from frn_tpu_torch.models import fusion as tfusion
from frn_tpu_torch.models.fpn import PyramidFeatures
from frn_tpu_torch.models.heads import ClassificationHead, RegressionHead, apply_heads
from frn_tpu_torch.models.resnet import ResNetBackbone
from frn_tpu_torch.ops.attention import nonlocal_attention, reference_view_to_nchw

RNG = np.random.default_rng(7)


def random_variables(module, *inputs, seed=0, **kwargs):
    """The module's flax variables with seeded numpy values: fan-in scaled
    kernels, small biases, and non-trivial frozen-BN statistics."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            x = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "scale":
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "var":
            x = rng.uniform(0.5, 2.0, shape)
        else:  # conv/BN bias, BN mean
            x = rng.normal(0.0, 0.1, shape)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def port_state(variables, flax_head, prefix=""):
    """state_dict_from_jax of a sub-tree placed under ``flax_head``, with the
    torch name ``prefix`` stripped."""
    sd = state_dict_from_jax({col: {flax_head: tree} for col, tree in variables.items()})
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def nchw(x):
    return torch.tensor(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize(
    "layers,bottleneck,in_ch,flax_head,suffix",
    [((2, 2, 2, 2), False, 3, "rgb_backbone", ""), ((3, 4, 6, 3), True, 5, "event_backbone", "_event")],
    ids=["resnet18_rgb", "resnet50_event"],
)
def test_resnet_stages_match(layers, bottleneck, in_ch, flax_head, suffix):
    x = RNG.normal(0, 1, (2, 64, 96, in_ch)).astype(np.float32)
    jmod = JResNet(layers=layers, bottleneck=bottleneck)
    variables = random_variables(jmod, jnp.asarray(x), seed=1)
    want = jmod.apply(variables, jnp.asarray(x))
    tmod = ResNetBackbone(in_ch, layers, bottleneck, suffix)
    tmod.load_state_dict(port_state(variables, flax_head), strict=True)
    with torch.no_grad():
        got = tmod(nchw(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert_close(to_nhwc(g), w)


def test_adain_matches():
    content = RNG.normal(1, 2, (2, 5, 7, 6)).astype(np.float32)
    style = RNG.normal(-1, 3, (2, 5, 7, 6)).astype(np.float32)
    want = jfusion.adain(jnp.asarray(content), jnp.asarray(style))
    got = tfusion.adain(nchw(content), nchw(style))
    assert_close(to_nhwc(got), want)


@pytest.mark.parametrize("chunk", [1024, 16])
def test_nonlocal_attention_matches(chunk):
    # HW = 60 tokens: dense at chunk 1024, four ragged query blocks at 16
    g, th, ph = (RNG.normal(0, 1, (2, 60, 8)).astype(np.float32) for _ in range(3))
    want = jnonlocal(jnp.asarray(g), jnp.asarray(th), jnp.asarray(ph), chunk=chunk)
    got = nonlocal_attention(torch.tensor(g), torch.tensor(th), torch.tensor(ph), chunk=chunk)
    assert_close(got.numpy(), want)


def test_reference_view_matches():
    # H != W and C8 not in {H, W}: a permute in place of the view would differ
    y = RNG.normal(0, 1, (2, 6 * 10, 8)).astype(np.float32)
    want = reference_view_to_nhwc(jnp.asarray(y), 6, 10)
    got = reference_view_to_nchw(torch.tensor(y), 6, 10)
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(want))


def test_cross_attention_block_matches():
    x0 = RNG.normal(0, 1, (2, 6, 10, 64)).astype(np.float32)
    x1 = RNG.normal(0, 1, (2, 6, 10, 64)).astype(np.float32)
    jmod = jfusion.CrossAttentionBlock(in_channels=64, chunk=16)
    variables = random_variables(jmod, jnp.asarray(x0), jnp.asarray(x1), seed=2)
    want = jmod.apply(variables, jnp.asarray(x0), jnp.asarray(x1))
    tmod = tfusion.CrossAttentionBlock(64, chunk=16)
    tmod.load_state_dict(port_state({c: {"blk": t} for c, t in variables.items()}, "fus_0",
                                    "fus.0.blk."), strict=True)
    with torch.no_grad():
        got = tmod(nchw(x0), nchw(x1))
    assert_close(to_nhwc(got), want)


def test_refusion_matches():
    a = RNG.normal(0, 1, (2, 6, 10, 64)).astype(np.float32)
    b = RNG.normal(0, 1, (2, 6, 10, 64)).astype(np.float32)
    jmod = jfusion.REFusion(channels=64, chunk=16)
    variables = random_variables(jmod, jnp.asarray(a), jnp.asarray(b), seed=3)
    want = jmod.apply(variables, jnp.asarray(a), jnp.asarray(b))
    tmod = tfusion.REFusion(64, chunk=16)
    tmod.load_state_dict(port_state(variables, "fus_0", "fus.0."), strict=True)
    with torch.no_grad():
        got = tmod(nchw(a), nchw(b))
    assert got.shape == (2, 128, 6, 10)
    assert_close(to_nhwc(got), want)


@pytest.mark.parametrize("geo", [(64, 96, "nearest2x"), (52, 70, "bilinear_fixed")],
                         ids=["dsec_nearest", "ddd17_bilinear"])
def test_fpn_matches(geo):
    h, w, mode = geo
    chans = (16, 24, 32, 40)
    feats = [RNG.normal(0, 1, (2, -(-h // s), -(-w // s), c)).astype(np.float32)
             for s, c in zip((4, 8, 16, 32), chans)]
    jmod = JPyramid(feature_size=32, upsample=mode)
    variables = random_variables(jmod, [jnp.asarray(f) for f in feats], seed=4)
    want = jmod.apply(variables, [jnp.asarray(f) for f in feats])
    tmod = PyramidFeatures(chans, 32, mode)
    tmod.load_state_dict(port_state(variables, "fpn", "fpn."), strict=True)
    with torch.no_grad():
        got = tmod([nchw(f) for f in feats])
    assert len(got) == 5
    for g, wnt in zip(got, want):
        assert_close(to_nhwc(g), wnt)


@pytest.mark.parametrize("cls_mode,reg_mode", [("logits_chanlast", "flat36"), ("probs", "rows"),
                                               ("logits", "rows")])
def test_heads_emission_layouts_match(cls_mode, reg_mode):
    feats = [RNG.normal(0, 1, (2, h, w, 32)).astype(np.float32) for h, w in ((5, 7), (3, 4))]
    jcls, jreg = JCls(num_classes=3, num_anchors=9, feature_size=32), JReg(num_anchors=9, feature_size=32)
    vcls = random_variables(jcls, jnp.asarray(feats[0]), seed=5)
    vreg = random_variables(jreg, jnp.asarray(feats[0]), seed=6)
    jf = [jnp.asarray(f) for f in feats]
    want_cls = japply(jcls.bind(vcls), jreg.bind(vreg), jf, cls_mode=cls_mode, reg_mode=reg_mode)[0] \
        if cls_mode != "probs" else jnp.concatenate([jcls.apply(vcls, f) for f in jf], axis=1)
    want_reg = jnp.concatenate([jreg.apply(vreg, f, mode=reg_mode) for f in jf], axis=1)
    tcls, treg = ClassificationHead(3, 9, 32), RegressionHead(9, 32)
    tcls.load_state_dict(port_state(vcls, "classificationModel", "classificationModel."), strict=True)
    treg.load_state_dict(port_state(vreg, "regressionModel", "regressionModel."), strict=True)
    with torch.no_grad():
        got_cls, got_reg = apply_heads(tcls, treg, [nchw(f) for f in feats], cls_mode, reg_mode)
    assert got_cls.shape == want_cls.shape and got_reg.shape == want_reg.shape
    assert_close(got_cls.numpy(), want_cls)
    assert_close(got_reg.numpy(), want_reg)


@pytest.mark.parametrize("shape,count", [((480, 640), 230220), ((260, 346), 68490), ((64, 96), None),
                                         ((52, 70), None)])
def test_anchors_match(shape, count):
    got = tanchors.anchors_for_shape(shape, tconfig.AnchorConfig())
    want = janchors.anchors_for_shape(shape, JAnchorConfig())
    np.testing.assert_array_equal(got, want)
    assert tanchors.num_anchors_for_shape(shape) == len(got)
    if count is not None:
        assert len(got) == count


def test_geometry_constants_match():
    for t, j in ((tconfig.DSEC, JDSEC), (tconfig.DDD17, JDDD17)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_box_ops_match():
    anchors = janchors.anchors_for_shape((64, 96))[::7]
    deltas = RNG.normal(0, 1, anchors.shape).astype(np.float32)
    want = jboxes.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas))
    got = tboxes.decode_boxes(torch.tensor(anchors), torch.tensor(deltas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
    want_clip = jboxes.clip_boxes(want, (64, 96))
    got_clip = tboxes.clip_boxes(got, (64, 96))
    np.testing.assert_allclose(got_clip.numpy(), np.asarray(want_clip), rtol=1e-6, atol=1e-4)
    a, b = got_clip[:40], got_clip[30:90]
    np.testing.assert_allclose(tboxes.pairwise_iou(a, b).numpy(),
                               np.asarray(jboxes.pairwise_iou(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))),
                               rtol=1e-5, atol=1e-6)
