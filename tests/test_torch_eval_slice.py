"""The evaluation slice of the port against frn_tpu's, on the CPU.

One tiny DSEC fusion detector (depth 18, feature size 16, 64x96) with the
seeded weights of ``test_torch_detector.seeded_variables`` (random head
output convs, so that detections exist), loaded into both packages
(``state_dict_from_jax``, or a ``.pth`` the test writes), on a fixture that
``frn_tpu``'s ``make_csv_fixture`` writes.

Tolerances: detections as in ``test_torch_detector.py`` (the same number per
image and class, identical labels, scores within 1e-5, boxes within 1e-3
px); per-class APs within 1e-9, which is exact agreement up to the summation
order of the precision envelope: where the detections agree, the matching
and the ranking are the same.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from frn_tpu import config as jconfig
from frn_tpu.cli import test as jcli
from frn_tpu.data import csv_dataset as jcsv
from frn_tpu.data.synthetic import make_csv_fixture
from frn_tpu.eval import detections as jdetections
from frn_tpu.eval import evaluator as jevaluator
from frn_tpu.models import detector as jdetector
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.cli import common as tcommon
from frn_tpu_torch.cli import test as tcli
from frn_tpu_torch.convert import load_reference_checkpoint, state_dict_from_jax
from frn_tpu_torch.data import csv_dataset as tcsv
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.eval import detections as tdetections
from frn_tpu_torch.eval import evaluator as tevaluator
from frn_tpu_torch.models import detector as tdetector
from frn_tpu_torch.parallel import make_mesh
from frn_tpu_torch.train.checkpoint import CheckpointManager
from frn_tpu_torch.train.trainer import Trainer
from test_torch_detector import seeded_variables

H, W = 64, 96
AP_ATOL = 1e-9


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Several test processes share the CPU: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_configs():
    model_kw = dict(variant="fusion", depth=18, feature_size=16, num_classes=3)
    jgeo = dataclasses.replace(jconfig.DSEC, height=H, width=W)
    tgeo = dataclasses.replace(tconfig.DSEC, height=H, width=W)
    return (jconfig.FrameworkConfig(geometry=jgeo, model=jconfig.ModelConfig(**model_kw),
                                    eval=jconfig.EvalConfig(approx_topk=False)),
            tconfig.FrameworkConfig(geometry=tgeo, model=tconfig.ModelConfig(**model_kw)))


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """Both models on the same weights, the fixture, a .pth of the weights
    (reference names under DataParallel's ``module.``), and both packages'
    datasets over the fixture."""
    root = tmp_path_factory.mktemp("eval_slice")
    jcfg, tcfg = tiny_configs()
    jmodel = jdetector.FRNDetector(jcfg)
    variables = seeded_variables(jmodel, jcfg.geometry, seed=1)
    state = state_dict_from_jax(variables)
    tmodel = tdetector.init_detector(tcfg, device="cpu")
    tmodel.load_state_dict(state, strict=True)
    pth = str(root / "model.pth")
    torch.save({"model_state_dict": {"module." + k: v for k, v in state.items()}, "epoch": 3}, pth)
    fix = make_csv_fixture(str(root / "fix"), geometry=jcfg.geometry, num_images=6, seed=2)
    args = (fix["annotations_csv"], fix["class_map_csv"], fix["event_dir"], fix["img_dir"])
    return dict(jcfg=jcfg, tcfg=tcfg, jmodel=jmodel, variables=variables, tmodel=tmodel, pth=pth,
                fix=fix, root=root, jds=jcsv.CSVDetectionDataset(jcfg.geometry, *args),
                tds=tcsv.CSVDetectionDataset(tcfg.geometry, *args),
                jinfer=jdetections.make_inference_fn(jmodel, variables, jcfg),
                tinfer=tdetections.make_inference_fn(tmodel, tcfg))


def assert_detections_close(got, want):
    """(scores, labels, boxes) of both packages, batch-major."""
    gs, gl, gb = (np.asarray(x) for x in got)
    ws, wl, wb = (np.asarray(x) for x in want)
    for i in range(ws.shape[0]):
        valid = wl[i] >= 0
        assert valid.sum() > 0 and ((gl[i] >= 0) == valid).all()
        np.testing.assert_array_equal(gl[i][valid], wl[i][valid])
        np.testing.assert_allclose(gs[i][valid], ws[i][valid], atol=1e-5, rtol=0)
        np.testing.assert_allclose(gb[i][valid], wb[i][valid], atol=1e-3, rtol=0)


def assert_per_image_detections_close(got, want):
    """all_detections[image][class] (n, 5) of both packages."""
    assert len(got) == len(want)
    for g_img, w_img in zip(got, want):
        for g, w in zip(g_img, w_img):
            assert g.shape == w.shape and g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5, rtol=0)
            np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3, rtol=0)


def assert_aps_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=AP_ATOL, rtol=0)


# ------------------------------------------------------------ make_inference_fn


@pytest.mark.parametrize("wire", ["f32", "compact"])
def test_make_inference_fn_matches_jax(slice_setup, wire):
    s = slice_setup
    rng = np.random.default_rng(4)
    if wire == "f32":
        rgb = rng.normal(0, 1, (2, H, W, 3)).astype(np.float32)
        event = rng.normal(0, 1, (2, H, W, 5)).astype(np.float32)
        jinfer, tinfer = s["jinfer"], s["tinfer"]
    else:  # uint8 RGB, int8 voxels: one sample over the tanh threshold, one not
        rgb = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
        event = rng.integers(-4, 5, (2, H, W, 5)).astype(np.int8)
        event[0, 5:9, 10:20] = 60
        jinfer = jdetections.make_inference_fn(s["jmodel"], s["variables"], s["jcfg"],
                                               wire="compact", rgb_standardize=True)
        tinfer = tdetections.make_inference_fn(s["tmodel"], s["tcfg"], wire="compact",
                                               rgb_standardize=True)
    want = jinfer(jnp.asarray(rgb), jnp.asarray(event))
    got = tinfer(torch.from_numpy(rgb), torch.from_numpy(event))
    assert got[1].dtype == torch.int32 and got[0].shape == (2, s["tcfg"].eval.max_detections)
    assert_detections_close([g.numpy() for g in got], want)


def test_make_inference_fn_guards_match_jax(slice_setup):
    s = slice_setup
    f32 = torch.zeros((1, H, W, 3)), torch.zeros((1, H, W, 5))
    compact = torch.zeros((1, H, W, 3), dtype=torch.uint8), torch.zeros((1, H, W, 5), dtype=torch.int8)
    with pytest.raises(TypeError, match="wire='f32' got integer inputs"):
        s["tinfer"](*compact)
    infer = tdetections.make_inference_fn(s["tmodel"], s["tcfg"], wire="compact")
    with pytest.raises(TypeError, match="wire='compact' expects uint8"):
        infer(*f32)
    with pytest.raises(ValueError, match="unknown wire"):
        tdetections.make_inference_fn(s["tmodel"], s["tcfg"], wire="events")
    # over a mesh the batch must divide: 1 image over 3 replicas raises
    mesh_infer = tdetections.make_inference_fn(s["tmodel"], s["tcfg"],
                                               mesh=make_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="does not divide over the mesh data axis"):
        mesh_infer(*f32)
    with pytest.raises(NotImplementedError, match="XLA"):
        tdetections.make_inference_fn(s["tmodel"], s["tcfg"], input_format="auto")


def test_collect_detections_and_annotations_match_jax(slice_setup):
    s = slice_setup
    want, _ = jdetections.collect_detections(s["jds"], s["jinfer"], s["jcfg"], batch_size=4)
    got, elapsed = tdetections.collect_detections(s["tds"], s["tinfer"], s["tcfg"], batch_size=4)
    assert elapsed > 0
    assert_per_image_detections_close(got, want)
    for g_img, w_img in zip(tdetections.collect_annotations(s["tds"]),
                            jdetections.collect_annotations(s["jds"])):
        for g, w in zip(g_img, w_img):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ both CLIs


def _cli_flags(s, *more):
    fix = s["fix"]
    return ["--csv_classes", fix["class_map_csv"], "--root_img", fix["img_dir"],
            "--root_event", fix["event_dir"], "--csv_test", fix["annotations_csv"],
            "--image_height", str(H), "--image_width", str(W), "--depth", "18",
            "--feature_size", "16", "--checkpoint", s["pth"], "--batch_size", "4", *more]


def test_both_eval_clis_agree(slice_setup, capsys):
    s = slice_setup
    out = {}
    for name, main, more in (("jax", jcli.main, ()), ("port", tcli.main, ("--device", "cpu"))):
        folder = str(s["root"] / f"cli_{name}")
        assert main(_cli_flags(s, "--save_detect_folder", folder, *more)) == 0
        printed = capsys.readouterr().out
        assert "fps" in printed
        summary = json.loads(printed[printed.index("{"):printed.rindex("}") + 1])
        with open(os.path.join(folder, "evaluation_aps.pkl"), "rb") as f:
            aps = pickle.load(f)
        with open(os.path.join(folder, "detections.txt"), "rb") as f:
            dets = pickle.load(f)
        out[name] = summary, aps, dets
    (j_summary, j_aps, j_dets), (t_summary, t_aps, t_dets) = out["jax"], out["port"]
    assert_per_image_detections_close(t_dets, j_dets)
    assert_aps_close(t_aps, j_aps)
    assert t_summary.keys() == j_summary.keys() and t_summary["mAP"] > 0
    for key in j_summary:
        assert abs(t_summary[key] - j_summary[key]) <= 1e-4  # printed rounded to 4 places


def test_port_cli_cache_coco_protocol_and_pr_curves(slice_setup, capsys, tmp_path):
    s = slice_setup
    folder = str(tmp_path / "eval")
    tcli.main(_cli_flags(s, "--save_detect_folder", folder, "--device", "cpu", "--data_parallel",
                         "--coco_protocol", "--pr_curve_path", str(tmp_path / "pr")))
    first = capsys.readouterr().out
    assert "Average Precision" in first and "PR curves:" in first
    assert sorted(os.listdir(tmp_path / "pr")) == sorted(
        f"{n}_precision_recall.jpg" for n in ("person", "large_vehicle", "car"))
    with open(os.path.join(folder, "evaluation_aps.pkl"), "rb") as f:
        aps = pickle.load(f)
    # --load_detection rescores the cached pickles, with no inference
    tcli.main(_cli_flags(s, "--save_detect_folder", folder, "--device", "cpu", "--load_detection"))
    assert "fps 0.0" in capsys.readouterr().out
    with open(os.path.join(folder, "evaluation_aps.pkl"), "rb") as f:
        assert pickle.load(f) == aps


def test_port_ddd17_alias_runs(tmp_path, capsys):
    geo = dataclasses.replace(tconfig.DDD17, height=52, width=70)
    fix = make_csv_fixture(str(tmp_path / "fix"), geometry=dataclasses.replace(
        jconfig.DDD17, height=52, width=70), num_images=3, seed=7)
    model = tdetector.init_detector(tconfig.FrameworkConfig(geometry=geo, model=tconfig.ModelConfig(
        depth=18, feature_size=16, num_classes=1)), device="cpu")
    pth = str(tmp_path / "ddd17.pth")
    torch.save(model.state_dict(), pth)
    from frn_tpu_torch.cli import test_ddd17

    test_ddd17.main(["--csv_classes", fix["class_map_csv"], "--root_img", fix["img_dir"],
                     "--root_event", fix["event_dir"], "--csv_test", fix["annotations_csv"],
                     "--image_height", "52", "--image_width", "70", "--depth", "18",
                     "--feature_size", "16", "--checkpoint", pth, "--batch_size", "2",
                     "--save_detect_folder", str(tmp_path / "eval"), "--device", "cpu"])
    printed = capsys.readouterr().out
    summary = json.loads(printed[printed.index("{"):printed.rindex("}") + 1])
    assert set(summary) == {"mAP", "mAP50", "mAP75", "AP_car"}


@pytest.mark.parametrize("module_name", ["test_dsec", "test_ddd17"])
def test_port_cli_alias_injects_defaults(monkeypatch, module_name):
    import importlib

    mod = importlib.import_module(f"frn_tpu_torch.cli.{module_name}")
    captured = {}
    monkeypatch.setattr(mod, "_main", lambda argv=None: captured.setdefault(
        "args", mod.get_parser().parse_args(argv)))
    base = ["--csv_classes", "c.csv", "--root_img", "i", "--root_event", "e", "--checkpoint", "ck"]
    mod.main(base)
    assert captured.pop("args").dataset_name == module_name.split("_")[1]
    mod.main(base + ["--dataset_name", "dsec"])  # an explicit flag wins
    assert captured["args"].dataset_name == "dsec"


@pytest.mark.parametrize("flags,error", [(("--approx_topk",), "approx_topk"),
                                         (("--postprocess", "dense"), "dense")])
def test_port_cli_unported_options_raise(slice_setup, tmp_path, capsys, flags, error):
    """The two options that raised before they were ported (``error`` names
    each) now run: the port's CLI with each against frn_tpu's CLI with it."""
    s = slice_setup
    dets = {}
    for name, main, more in (("jax", jcli.main, ()), ("port", tcli.main, ("--device", "cpu"))):
        folder = str(tmp_path / name)
        assert main(_cli_flags(s, "--save_detect_folder", folder, *more, *flags)) == 0
        assert "fps" in capsys.readouterr().out
        with open(os.path.join(folder, "evaluation_aps.pkl"), "rb") as f:
            aps = pickle.load(f)
        with open(os.path.join(folder, "detections.txt"), "rb") as f:
            dets[name] = pickle.load(f), aps
    assert_per_image_detections_close(dets["port"][0], dets["jax"][0])
    assert_aps_close(dets["port"][1], dets["jax"][1])


def test_port_cli_needs_the_card_unless_told_cpu(slice_setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(_cli_flags(slice_setup, "--save_detect_folder", str(tmp_path)))


# ------------------------------------------------------------ corruption protocol


def test_corruption_sweep_matches_jax(slice_setup, tmp_path):
    s = slice_setup
    kw = dict(corruptions=["gaussian_noise", "pixelate"], severities=(1, 5), batch_size=4)
    want = jevaluator.corruption_sweep(s["jds"], s["jinfer"], s["jcfg"],
                                       save_root=str(tmp_path / "j"), **kw)
    got = tevaluator.corruption_sweep(s["tds"], s["tinfer"], s["tcfg"],
                                      save_root=str(tmp_path / "t"), **kw)
    assert got.keys() == want.keys()
    for corruption in want:
        assert got[corruption].keys() == want[corruption].keys() == {1, 5}
        for sev in (1, 5):
            np.testing.assert_allclose(got[corruption][sev], want[corruption][sev], atol=AP_ATOL,
                                       rtol=0)
    # the reference's artifact layout, written by both CLIs' helper
    names = ["person", "large_vehicle", "car"]
    tcli.write_corruption_artifacts(got, names, str(tmp_path / "t"))
    jcli.write_corruption_artifacts(want, names, str(tmp_path / "j"))
    for corruption in want:
        with open(tmp_path / "t" / f"{corruption}_ap.txt", "rb") as f:
            t_art = pickle.load(f)
        with open(tmp_path / "j" / f"{corruption}_ap.txt", "rb") as f:
            j_art = pickle.load(f)
        assert t_art.keys() == j_art.keys()
        for name in names:
            np.testing.assert_allclose(t_art[name], j_art[name], atol=AP_ATOL, rtol=0)


def test_corrupted_dataset_samples_match_jax(slice_setup):
    s = slice_setup
    jds = jevaluator.CorruptedDataset(s["jds"], "glass_blur", 2)
    tds = tevaluator.CorruptedDataset(s["tds"], "glass_blur", 2)
    for i in (0, 5):
        for key, want in jds[i].items():
            np.testing.assert_array_equal(tds[i][key], want)


def test_folder_protocol_matches_jax(slice_setup, tmp_path):
    s = slice_setup
    # a pre-generated tree <root>/<type>/severity_<s>/ holding the clean images
    import shutil

    for sev in (1, 2):
        shutil.copytree(s["fix"]["img_dir"], tmp_path / "tree" / "contrast" / f"severity_{sev}")
    kw = dict(corruptions=["contrast"], severities=(1, 2), batch_size=4,
              corruption_root=str(tmp_path / "tree"))
    want = jevaluator.corruption_sweep(s["jds"], s["jinfer"], s["jcfg"], **kw)
    got = tevaluator.corruption_sweep(s["tds"], s["tinfer"], s["tcfg"], **kw)
    clean = tevaluator.evaluate_dataset(s["tds"], s["tinfer"], s["tcfg"], batch_size=4)
    for sev in (1, 2):
        np.testing.assert_allclose(got["contrast"][sev], want["contrast"][sev], atol=AP_ATOL, rtol=0)
        np.testing.assert_allclose(got["contrast"][sev],
                                   [np.mean(clean.per_class_aps[c]) for c in range(3)], atol=0, rtol=0)
    with pytest.raises(FileNotFoundError, match="corruption folder missing"):
        tevaluator.corrupted_folder_dataset(s["tds"], str(tmp_path / "tree"), "fog", 1)


# ------------------------------------------------------------ trainer, checkpoints


def test_trainer_periodic_eval_keeps_the_best_checkpoint(slice_setup, tmp_path):
    s = slice_setup
    tcfg = dataclasses.replace(s["tcfg"], train=tconfig.TrainConfig(
        batch_size=2, max_annots_per_image=4, checkpoint_every=10))
    real_eval = tcommon.make_eval_fn(tcfg, s["tds"], batch_size=4)
    maps, calls = iter([0.25, 0.125, 0.5]), []

    def eval_fn(model, state):
        calls.append(real_eval(model, state))  # the real evaluation runs in the loop
        return next(maps)

    trainer = Trainer(tcfg, box_samples(2, tcfg.geometry, seed=3), checkpoint_dir=str(tmp_path),
                      eval_fn=eval_fn, eval_every=1, log_every=0, device="cpu")
    trainer.fit(epochs=3)
    assert len(calls) == 3 and all(0.0 <= m <= 1.0 for m in calls)
    assert trainer.best_map == 0.5
    mgr = CheckpointManager(str(tmp_path))
    # new bests at epochs 1 and 3 are saved; epoch 2 is not; the end of fit saves epoch 3
    assert mgr.epochs() == [1, 3]
    best1 = torch.load(mgr.path(1), map_location="cpu", weights_only=True)
    assert best1["best_map"] == 0.25 and best1["epoch"] == 1
    resumed = Trainer(tcfg, box_samples(2, tcfg.geometry, seed=3), checkpoint_dir=str(tmp_path),
                      device="cpu")
    assert resumed.resume() and resumed.best_map == 0.5 and resumed.epoch == 3


def test_trainer_eval_every_skips_epochs(slice_setup):
    s = slice_setup
    tcfg = dataclasses.replace(s["tcfg"], train=tconfig.TrainConfig(batch_size=2,
                                                                    max_annots_per_image=4))
    epochs = []
    trainer = Trainer(tcfg, box_samples(2, tcfg.geometry, seed=4), log_every=0, device="cpu",
                      eval_every=2, eval_fn=lambda model, state: epochs.append(trainer.epoch) or 0.0)
    trainer.fit(epochs=3)
    assert epochs == [2]


@pytest.mark.parametrize("layout", ["raw", "raw_module", "wrapped", "wrapped_module"])
def test_load_reference_checkpoint(slice_setup, tmp_path, layout):
    s = slice_setup
    state = s["tmodel"].state_dict()
    sd = {("module." + k if layout.endswith("module") else k): v.clone() for k, v in state.items()}
    sd[("module." if layout.endswith("module") else "") + "bn1.num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "ck.pth")
    torch.save({"model_state_dict": sd, "epoch": 2} if layout.startswith("wrapped") else sd, path)
    model = tdetector.init_detector(s["tcfg"], seed=9, device="cpu")
    got = load_reference_checkpoint(path, model)
    assert got.keys() == state.keys()
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k])
    del sd[next(k for k in sd if k.endswith("fpn.P5_1.weight"))]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_checkpoint(path, model)


def test_inference_fn_runs_the_inference_forward_in_training_mode(slice_setup):
    # a Trainer's model is in training mode when its periodic evaluation runs:
    # InferenceFn must still take the inference forward (the eval emission,
    # no modality dropout), as it does for a model in eval mode
    s = slice_setup
    rng = np.random.default_rng(5)
    rgb = torch.tensor(rng.normal(0, 1, (2, H, W, 3)).astype(np.float32))
    event = torch.tensor(rng.normal(0, 1, (2, H, W, 5)).astype(np.float32))
    want = s["tinfer"](rgb, event)
    s["tmodel"].train()
    try:
        got = s["tinfer"](rgb, event)
    finally:
        s["tmodel"].eval()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,off", [("float32", True), ("bfloat16", False)])
def test_cli_turns_tf32_off_at_float32(monkeypatch, dtype, off):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    args = tcli.get_parser().parse_args(["--csv_classes", "c", "--root_img", "i", "--root_event",
                                         "e", "--checkpoint", "k", "--compute_dtype", dtype,
                                         "--device", "cpu"])
    assert tcommon.setup_device(args) == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is not off
    assert torch.backends.cuda.matmul.allow_tf32 is not off
