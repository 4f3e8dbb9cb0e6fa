"""The weight bridge and the port's parameter names, against frn_tpu.

Every flax leaf of the JAX detector maps to one parameter or buffer of the
port's detector and the reverse, under the reference's torch state_dict name
that ``frn_tpu.convert.torch_import.torch_key_for`` gives, with the shape the
layout change implies. The port's initializers draw from the same
distributions as the JAX package's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.convert.torch_import import convert_state_dict, torch_key_for
from frn_tpu.models import layers as jlayers
from frn_tpu.models.detector import FRNDetector as JDetector
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.models.detector import FRNDetector, init_detector


def _configs(variant, depth):
    kw = dict(variant=variant, depth=depth, num_classes=3, feature_size=32)
    jgeo = dataclasses.replace(jconfig.DSEC, height=64, width=96)
    tgeo = dataclasses.replace(tconfig.DSEC, height=64, width=96)
    return (jconfig.FrameworkConfig(geometry=jgeo, model=jconfig.ModelConfig(**kw)),
            tconfig.FrameworkConfig(geometry=tgeo, model=tconfig.ModelConfig(**kw)))


def _jax_shapes(jcfg):
    geo = jcfg.geometry
    rgb = jnp.zeros((1, geo.height, geo.width, 3))
    event = jnp.zeros((1, geo.height, geo.width, geo.event_channels))
    model = JDetector(jcfg)
    shapes = jax.eval_shape(
        lambda r: model.init({"params": r, "modality": r}, rgb, event, train=False),
        jax.random.PRNGKey(0))
    return {col: tree for col, tree in shapes.items()}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("variant,depth", [("fusion", 18), ("fusion", 50), ("rgb", 50), ("event", 18)])
def test_every_leaf_maps_both_ways(variant, depth):
    jcfg, tcfg = _configs(variant, depth)
    shapes = _jax_shapes(jcfg)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros)
    port = FRNDetector(tcfg).state_dict()
    assert set(sd) == set(port)
    n_leaves = 0
    for collection in ("params", "batch_stats"):
        for path, leaf in _flat(shapes[collection]):
            n_leaves += 1
            name = torch_key_for(path, collection, variant)
            assert name in sd, (path, name)
            want = tuple(leaf.shape)
            if path[-1] == "kernel":  # (kh, kw, in, out) -> (out, in, kh, kw)
                want = (want[3], want[2], want[0], want[1])
            assert tuple(port[name].shape) == want == tuple(sd[name].shape), name
    assert n_leaves == len(sd)


def test_reference_names():
    _, tcfg = _configs("fusion", 50)
    names = set(FRNDetector(tcfg).state_dict())
    for name in ("conv1.weight", "bn1.running_var", "layer1.0.conv1.weight",
                 "layer1.0.downsample.0.weight", "layer1.0.downsample.1.weight",
                 "conv1_event.weight", "bn1_event.bias", "layer1_event.0.conv3.weight",
                 "layer4_event.2.bn3.running_mean", "fus.0.conv0_rgb.weight",
                 "fus.0.rgb_cross_attention.g.weight", "fus.3.event_cross_attention.W.bias",
                 "fpn.P5_1.weight", "fpn.P6.weight", "classificationModel.output.weight",
                 "regressionModel.conv4.bias"):
        assert name in names, name


def test_round_trip_through_the_jax_importer():
    # port state_dict -> frn_tpu's own torch importer -> state_dict_from_jax: identity
    jcfg, tcfg = _configs("fusion", 18)
    model = init_detector(tcfg, seed=3, device="cpu")
    with torch.no_grad():
        for buf in model.buffers():
            buf.copy_(torch.rand(buf.shape) + 0.5)
    port_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), _jax_shapes(jcfg))
    variables = convert_state_dict(port_sd, template, variant="fusion", strict=True)
    assert variables["_unused_torch_keys"] == [] and variables["_missing_template_keys"] == []
    back = state_dict_from_jax({c: variables[c] for c in ("params", "batch_stats")})
    assert set(back) == set(port_sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), port_sd[k], err_msg=k)


def test_init_matches_the_jax_initializers():
    # per conv, the spread of the port's draw against the JAX init of that shape
    _, tcfg = _configs("fusion", 18)
    model = init_detector(tcfg, seed=0, device="cpu")
    sd = model.state_dict()
    key = jax.random.PRNGKey(0)

    def jax_std(init, torch_shape):
        out_ch, in_ch, kh, kw = torch_shape
        return float(np.asarray(init(key, (kh, kw, in_ch, out_ch))).std())

    checks = {
        "layer2.0.conv2.weight": jlayers.torch_conv_init(3, 128),
        "fpn.P3_2.weight": jlayers.torch_conv_init(3, 32),
        "fus.1.conv0_evt.weight": jlayers.torch_default_conv_init(),
        "fus.2.event_cross_attention.theta.weight": jlayers.c2_xavier_init(),
    }
    for name, init in checks.items():
        got = float(sd[name].std())
        want = jax_std(init, tuple(sd[name].shape))
        assert abs(got - want) < 0.1 * want, (name, got, want)
    bound = 1.0 / np.sqrt(sd["fus.1.conv0_evt.weight"].shape[1])
    assert 0 < float(sd["fus.1.conv0_evt.bias"].abs().max()) <= bound
    assert float(sd["fus.1.rgb_cross_attention.g.bias"].abs().max()) == 0.0
    assert float(sd["classificationModel.output.weight"].abs().max()) == 0.0
    torch.testing.assert_close(sd["classificationModel.output.bias"],
                               torch.full((27,), -float(np.log(99.0))))
    assert float(sd["regressionModel.output.weight"].abs().max()) == 0.0
    assert float(sd["layer1.0.bn1.weight"].min()) == 1.0 and float(sd["bn1.running_var"].min()) == 1.0
