"""The port's ImageNet initialization and checkpoint conversion, on the CPU.

``imagenet_backbone_init`` against ``frn_tpu.convert.torch_import``'s on a
torchvision-named ResNet-18 state dict built here (the RGB stem and stages
under torchvision's names, BatchNorm's ``num_batches_tracked`` and ``fc.*``;
nothing is downloaded), from the same starting weights: the same report
lists and the same weights after it, exactly (through
``convert.state_dict_from_jax``). A shape mismatch raises in both, and so
does the 'event' variant's 5-channel conv1. ``cli.convert_checkpoint`` turns
a ``.pt`` into the port's checkpoint directory, which ``cli/common`` loads
into a model and into a train state with the ``.pt``'s weights, bit for bit.
"""

import argparse
import dataclasses
import re

import numpy as np
import pytest

import torch

from frn_tpu import config as jconfig
from frn_tpu.convert.torch_import import imagenet_backbone_init as j_imagenet_backbone_init
from frn_tpu.models import detector as jdetector
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import common as tcommon
from frn_tpu_torch.cli import convert_checkpoint
from frn_tpu_torch.convert import imagenet_backbone_init, state_dict_from_jax
from frn_tpu_torch.models.detector import init_detector
from frn_tpu_torch.train.checkpoint import CheckpointManager
from frn_tpu_torch.train.loop import create_train_state
from test_torch_detector import seeded_variables

H, W = 64, 96
_RGB_BACKBONE = re.compile(r"^(conv1|bn1|layer[1-4])\.")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(variant):
    kw = dict(variant=variant, depth=18, feature_size=16, num_classes=3)
    return (jconfig.FrameworkConfig(geometry=dataclasses.replace(jconfig.DSEC, height=H, width=W),
                                    model=jconfig.ModelConfig(**kw)),
            tconfig.FrameworkConfig(geometry=dataclasses.replace(tconfig.DSEC, height=H, width=W),
                                    model=tconfig.ModelConfig(**kw)))


def torchvision_resnet18_sd(seed=0):
    """A torchvision ``resnet18().state_dict()``'s names and shapes with seeded
    values: its stem and stages are the RGB backbone's names in the port
    (``conv1``, ``bn1``, ``layer1``..``layer4``), plus ``num_batches_tracked``
    per BatchNorm and the classifier ``fc``."""
    _, tcfg = _configs("rgb")
    rng = np.random.default_rng(seed)
    sd = {}
    for name, value in init_detector(tcfg, seed=0, device="cpu").state_dict().items():
        if _RGB_BACKBONE.match(name):
            sd[name] = torch.from_numpy(rng.normal(size=tuple(value.shape)).astype(np.float32))
            if name.endswith("running_var"):
                sd[name] = sd[name].abs() + 0.5
                sd[name[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(100)
    sd["fc.weight"] = torch.from_numpy(rng.normal(size=(1000, 512)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.mark.parametrize("variant", ["fusion", "rgb"])
def test_imagenet_backbone_init_equals_jax(variant):
    jcfg, tcfg = _configs(variant)
    variables = seeded_variables(jdetector.FRNDetector(jcfg), jcfg.geometry, seed=1)
    model = init_detector(tcfg, seed=0, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    sd = torchvision_resnet18_sd()

    report = imagenet_backbone_init(sd, model)
    want_vars, want = j_imagenet_backbone_init({k: v.numpy() for k, v in sd.items()},
                                               variables, variant)
    assert sorted(report) == sorted(want) == ["filled", "ignored", "left_at_init"]
    assert report["filled"] == want["filled"]
    assert sorted(report["left_at_init"]) == sorted(want["left_at_init"])
    assert report["ignored"] == want["ignored"] == ["fc.weight", "fc.bias"]
    assert len(report["filled"]) == len([k for k in sd if "num_batches_tracked" not in k
                                         and not k.startswith("fc.")])
    if variant == "fusion":
        assert any(k.startswith("layer1_event.") for k in report["left_at_init"])
    wanted = state_dict_from_jax(want_vars)
    got = model.state_dict()
    assert sorted(got) == sorted(wanted)
    for name, value in wanted.items():
        assert torch.equal(got[name], value), name
    for name in report["filled"]:
        assert torch.equal(got[name], sd[name]), name


def test_a_shape_mismatch_raises_as_in_jax():
    jcfg, tcfg = _configs("fusion")
    variables = seeded_variables(jdetector.FRNDetector(jcfg), jcfg.geometry, seed=2)
    model = init_detector(tcfg, seed=0, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = torchvision_resnet18_sd()
    sd["layer2.0.conv1.weight"] = torch.zeros(128, 64, 5, 5)
    with pytest.raises(ValueError, match="layer2.0.conv1.weight"):
        imagenet_backbone_init(sd, model)
    with pytest.raises(ValueError, match="layer2.0.conv1.weight"):
        j_imagenet_backbone_init({k: v.numpy() for k, v in sd.items()}, variables, "fusion")
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_the_event_variant_cannot_take_imagenet_weights():
    """Its single backbone has torchvision's names with a 5-channel conv1."""
    jcfg, tcfg = _configs("event")
    variables = seeded_variables(jdetector.FRNDetector(jcfg), jcfg.geometry, seed=3)
    sd = torchvision_resnet18_sd()
    with pytest.raises(ValueError, match="conv1.weight"):
        imagenet_backbone_init(sd, init_detector(tcfg, seed=0, device="cpu"))
    with pytest.raises(ValueError, match="conv1.weight"):
        j_imagenet_backbone_init({k: v.numpy() for k, v in sd.items()}, variables, "event")


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A reference-style .pt of a seeded depth-18 fusion detector (DSEC
    geometry; DataParallel's ``module.`` prefix, num_batches_tracked and one
    unknown key) converted by the CLI on the CPU."""
    root = tmp_path_factory.mktemp("convert")
    cfg = tconfig.FrameworkConfig(geometry=tconfig.DSEC, model=tconfig.ModelConfig(depth=18))
    weights = init_detector(cfg, seed=4, device="cpu").state_dict()
    rng = np.random.default_rng(5)
    weights = {k: torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32))
               for k, v in weights.items()}
    sd = {"module." + k: v for k, v in weights.items()}
    sd["module.bn1.num_batches_tracked"] = torch.tensor(7)
    sd["module.extra.weight"] = torch.ones(3)
    pt = str(root / "best.pt")
    torch.save({"model_state_dict": sd, "epoch": 12}, pt)
    out = str(root / "ckpt")
    return cfg, weights, pt, out


def test_convert_checkpoint_writes_the_ports_directory(converted, capsys):
    cfg, weights, pt, out = converted
    convert_checkpoint.main(["--torch_checkpoint", pt, "--output", out, "--dataset_name", "dsec",
                             "--fusion", "fpn_fusion", "--depth", "18", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "warning: 1 unused torch keys, e.g. ['extra.weight']" in printed
    assert f"wrote checkpoint to {out}" in printed
    mgr = CheckpointManager(out)
    assert mgr.epochs() == [0]
    payload = torch.load(mgr.path(0), map_location="cpu", weights_only=True)
    assert payload["source"] == pt and payload["epoch"] == 0

    args = argparse.Namespace(checkpoint=out)
    model = init_detector(cfg, seed=0, device="cpu")
    tcommon.load_checkpoint_into_model(args, model)
    for name, value in model.state_dict().items():
        assert torch.equal(value, weights[name]), name
    state = create_train_state(cfg, seed=1, device="cpu")
    assert tcommon.load_checkpoint_into_state(args, state)["source"] == pt
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, weights[name]), name


def test_convert_checkpoint_refuses_a_missing_key_or_shape(converted, tmp_path):
    cfg, weights, _, _ = converted
    flags = ["--dataset_name", "dsec", "--depth", "18", "--device", "cpu"]
    partial = {k: v for k, v in weights.items() if not k.startswith("fpn.")}
    torch.save(partial, tmp_path / "partial.pt")
    with pytest.raises(KeyError, match="missing"):
        convert_checkpoint.main(["--torch_checkpoint", str(tmp_path / "partial.pt"),
                                 "--output", str(tmp_path / "a")] + flags)
    wrong = dict(weights, **{"conv1.weight": torch.zeros(64, 3, 5, 5)})
    torch.save(wrong, tmp_path / "wrong.pt")
    with pytest.raises(RuntimeError, match="conv1.weight"):
        convert_checkpoint.main(["--torch_checkpoint", str(tmp_path / "wrong.pt"),
                                 "--output", str(tmp_path / "b")] + flags)
