"""The port's train CLI (``frn_tpu_torch.cli.train`` and its aliases) and the
loader's transform hook against frn_tpu's, on the CPU.

Both CLIs train a tiny RGB detector (``--fusion rgb``: no modality dropout,
which the two packages draw from different generators; the fusion step is
held by ``test_torch_train_slice.py``) at depth 18, feature size 16, 32x48,
f32, batch 2, over a fixture of 8 images that ``frn_tpu``'s
``make_csv_fixture`` writes: 4 micro-steps and 2 optimizer steps an epoch,
two epochs. Both start from one seeded ``.pth`` through ``--continue_training
--checkpoint``; its heads' output convs are seeded numpy draws (zero at
init, which would leave every other layer without a gradient). The JAX CLI
runs once for the file (module fixture).

Tolerance: the loss histories (each epoch's mean loss, over micro-steps
after 0 to 3 optimizer steps) within rtol 1e-5: f32 in both, with another
summation order, and after Adam steps, whose first moves an element by about
lr whatever its gradient's size, so a gradient that is rounding noise in both
packages can move its element by lr in different directions. The two
histories came out 1.9e-7 apart (relative) on the CPU.
"""

import dataclasses

import numpy as np
import pytest

import torch

from frn_tpu import config as jconfig
from frn_tpu.cli import train as jtrain
from frn_tpu.data import loader as jloader
from frn_tpu.data.synthetic import make_csv_fixture
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import common as tcommon
from frn_tpu_torch.cli import train as ttrain
from frn_tpu_torch.data import loader as tloader
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.data.transforms import horizontal_flip
from frn_tpu_torch.models.detector import init_detector
from frn_tpu_torch.train.checkpoint import CheckpointManager

H, W = 32, 48
HISTORY_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once; torch's default of one
    intra-op thread per core in each of them oversubscribes the CPU, and these
    small shapes gain nothing from more than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """The fixture, the seeded .pth, and the JAX CLI's loss history."""
    root = tmp_path_factory.mktemp("train_cli")
    fix = make_csv_fixture(str(root / "fix"), geometry=dataclasses.replace(
        jconfig.DSEC, height=H, width=W), num_images=8, seed=5)
    cfg = tconfig.FrameworkConfig(
        geometry=dataclasses.replace(tconfig.DSEC, height=H, width=W),
        model=tconfig.ModelConfig(variant="rgb", depth=18, feature_size=16, num_classes=3))
    model = init_detector(cfg, seed=6, device="cpu")
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for head in (model.classificationModel, model.regressionModel):
            w = head.output.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.tensor(rng.normal(0, 0.1 / np.sqrt(fan_in), w.shape).astype(np.float32)))
    pth = str(root / "start.pth")
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, pth)
    setup = {"root": root, "fix": fix, "pth": pth}
    setup["jax_history"] = jtrain.main(_flags(setup, "jax"))
    return setup


def _flags(s, name, *more):
    fix = s["fix"]
    return ["--csv_train", fix["annotations_csv"], "--csv_classes", fix["class_map_csv"],
            "--root_img", fix["img_dir"], "--root_event", fix["event_dir"],
            "--image_height", str(H), "--image_width", str(W), "--fusion", "rgb", "--depth", "18",
            "--feature_size", "16", "--compute_dtype", "float32", "--batch_size", "2",
            "--epochs", "2", "--continue_training", "--checkpoint", s["pth"],
            "--checkpoint_dir", str(s["root"] / f"ckpt_{name}"), *more]


def test_train_clis_agree(cli_setup):
    got = ttrain.main(_flags(cli_setup, "port", "--device", "cpu"))
    want = cli_setup["jax_history"]
    assert len(got) == len(want) == 2 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=HISTORY_RTOL, atol=0)
    assert CheckpointManager(str(cli_setup["root"] / "ckpt_port")).epochs() == [2]


def test_continue_training_resumes_the_checkpoint_dir(cli_setup, tmp_path):
    # --continue_training without --checkpoint resumes the latest checkpoint of
    # --checkpoint_dir (Trainer.resume); a checkpoint directory given as
    # --checkpoint is restored whole into the train state
    s = cli_setup
    base = [f for f in _flags(s, "unused", "--device", "cpu") if f not in ("--continue_training",)]
    base = base[:base.index("--checkpoint")] + base[base.index("--checkpoint") + 2:]
    ckdir = str(tmp_path / "ck")
    first = ttrain.main(base + ["--epochs", "1", "--checkpoint_dir", ckdir])
    resumed = ttrain.main(base + ["--epochs", "2", "--checkpoint_dir", ckdir, "--continue_training"])
    assert len(first) == 1 and len(resumed) == 2 and resumed[0] == first[0]
    mgr = CheckpointManager(ckdir)
    assert mgr.epochs() == [1, 2]
    # the directory as --checkpoint: its latest epoch's weights and optimizer
    args = ttrain.get_parser().parse_args(base + ["--checkpoint", ckdir])
    from frn_tpu_torch.train.loop import create_train_state

    config = tcommon.build_config(args, 3, 2)
    state = create_train_state(config, seed=1, device="cpu")
    payload = tcommon.load_checkpoint_into_state(args, state)
    saved = torch.load(mgr.path(2), map_location="cpu", weights_only=True)
    assert payload["epoch"] == 2 and state.opt_steps == saved["opt_steps"] == 4
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, saved["model_state_dict"][name])


def test_augment_runs_with_periodic_evaluation(cli_setup, tmp_path, capsys):
    s = cli_setup
    history = ttrain.main(_flags(s, "augment", "--device", "cpu", "--epochs", "1", "--augment",
                                 "--csv_test", s["fix"]["annotations_csv"], "--eval_every", "1",
                                 "--checkpoint_dir", str(tmp_path / "ck")))
    assert len(history) == 1 and np.isfinite(history[0])
    assert "epoch 1: mAP" in capsys.readouterr().out
    saved = torch.load(CheckpointManager(str(tmp_path / "ck")).path(1), map_location="cpu",
                       weights_only=True)
    assert 0.0 <= saved["best_map"] <= 1.0


@pytest.mark.parametrize("module_name,want", [
    ("train_dsec", {"dataset_name": "dsec", "batch_size": 2, "epochs": 60, "checkpoint_every": 5}),
    ("train_ddd17", {"dataset_name": "ddd17", "batch_size": 4, "epochs": 200,
                     "checkpoint_every": 10}),
])
def test_train_alias_injects_defaults(monkeypatch, module_name, want):
    import importlib

    mod = importlib.import_module(f"frn_tpu_torch.cli.{module_name}")
    jmod = importlib.import_module(f"frn_tpu.cli.{module_name}")
    assert mod.DEFAULTS == jmod.DEFAULTS
    captured = {}
    monkeypatch.setattr(mod, "_main", lambda argv=None: captured.setdefault(
        "args", mod.get_parser().parse_args(argv)))
    base = ["--csv_train", "t.csv", "--csv_classes", "c.csv", "--root_img", "i", "--root_event", "e"]
    mod.main(base)
    args = captured.pop("args")
    assert {k: getattr(args, k) for k in want} == want
    mod.main(base + ["--batch_size", "3"])  # an explicit flag wins
    assert captured["args"].batch_size == 3


def test_checkpoint_every_is_not_passed_on():
    # as in frn_tpu, whose build_config drops it: the trainer keeps
    # TrainConfig's 5 whatever --checkpoint_every says (ROADMAP Queue C)
    argv = ["--csv_train", "t", "--csv_classes", "c", "--root_img", "i", "--root_event", "e",
            "--checkpoint_every", "10"]
    from frn_tpu.cli import common as jcommon

    targs, jargs = ttrain.get_parser().parse_args(argv), jtrain.get_parser().parse_args(argv)
    assert targs.checkpoint_every == jargs.checkpoint_every == 10
    assert (tcommon.build_config(targs, 3, 2).train.checkpoint_every
            == jcommon.build_config(jargs, 3, 2).train.checkpoint_every == 5)


def test_train_cli_needs_the_card_unless_told_cpu(cli_setup):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(_flags(cli_setup, "nocard"))


@pytest.mark.parametrize("num_threads", [0, 2])
def test_batch_loader_transform_matches_jax(num_threads):
    # a deterministic transform (p=1: every sample flipped) applied per sample
    # as each is loaded, in the workers: the same batches in both packages
    geo = dataclasses.replace(tconfig.DSEC, height=H, width=W)
    jgeo = dataclasses.replace(jconfig.DSEC, height=H, width=W)
    samples = box_samples(5, geo, seed=8)

    def flip(sample):
        return horizontal_flip(sample, p=1.0)

    kw = dict(batch_size=2, shuffle=True, num_threads=num_threads, max_annots=4, seed=9,
              transform=flip)
    got = list(tloader.BatchLoader(samples, geo, **kw))
    want = list(jloader.BatchLoader(samples, jgeo, **kw))
    plain = list(tloader.BatchLoader(samples, geo, **{**kw, "transform": None}))
    assert len(got) == len(want) == 3
    for g, w, p in zip(got, want, plain):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])
        np.testing.assert_array_equal(g["rgb"], p["rgb"][:, :, ::-1])
