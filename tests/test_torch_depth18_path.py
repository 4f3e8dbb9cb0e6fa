"""The depth-18 and -34 path: the fusion ResNet-18 detector's stages 1 and 2
take the flash kernels at head dims 8 and 16 (stage widths 64 and 128, head
dim C / 8), and phase 15 of ``chip_smoke.py`` checks, times and counts them
on the card.

On the CPU: the R18 detector's routing to the f32 forward at d 8 and 16 (the
kernel's entry point recorded, not run); its plain route (the flash
wrapper's plain version at stage 1) against frn_tpu's detector at f32, at
the port's detector tolerances (rtol 1e-4, atol 1e-4 * max|ref|: f32 in
another summation order); phase 15's launch shapes, block counts, bounds
and expected launches; and its kernel checks and timings rehearsed on the
CPU at tiny shapes with the plain versions.
"""

import re
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from frn_tpu.models import detector as jdetector
from frn_tpu_torch.convert import state_dict_from_jax
from frn_tpu_torch.entry import dsec_fusion_config
from frn_tpu_torch.models import detector as tdetector
from frn_tpu_torch.ops import attention
from frn_tpu_torch.ops import flash_attention as fa
from test_torch_detector import assert_close, configs, seeded_variables

H100_SMS = 132


def _as_if_on_the_card(monkeypatch):
    """The attention's route decided as for a CUDA tensor (HW >= 4096 and a
    head dim under 128 take the flash wrappers), the tensors left on the CPU."""
    monkeypatch.setattr(attention, "_kernel_route",
                        lambda g: attention.flash_route(True, g.shape[1], g.shape[2]))


def test_depth_18_and_34_configs_give_head_dims_8_and_16():
    for depth in (18, 34):
        cfg = dsec_fusion_config(depth=depth)
        assert cfg.model.depth == depth and cfg.model.compute_dtype == "bfloat16"
        model = tdetector.FRNDetector(cfg)
        heads = [f.rgb_cross_attention.phi.weight.shape[0] for f in model.fus[:2]]
        assert heads == [8, 16]  # stage widths 64 and 128, head dim C / 8
    assert dsec_fusion_config().model.depth == 50


def test_r18_detector_routes_stages_1_and_2_to_the_small_f32_kernel(monkeypatch):
    # at 512x512, stage 1 has 16,384 tokens at d 8 and stage 2 4,096 at d 16:
    # both directions of both stages reach the f32 forward's entry point,
    # which picks the small kernel there; stages 3 and 4 stay dense
    _as_if_on_the_card(monkeypatch)
    calls = []
    monkeypatch.setattr(fa, "_on_kernel_device", lambda q: True)
    monkeypatch.setattr(fa, "_f32_library", lambda: types.SimpleNamespace(frn_flash_fwd_f32="f32"))
    monkeypatch.setattr(fa, "_launch", lambda fn, q, *args: calls.append(
        (fn, args[4] is None, tuple(args[-3:]))))
    _, tcfg = configs("dsec", 512, 512, 18)
    model = tdetector.init_detector(tcfg, seed=0, device="cpu")
    rgb, event = torch.randn(1, 512, 512, 3), torch.randn(1, 512, 512, 5)
    before = fa.flash_fwd_f32_launches
    with torch.no_grad():
        model(rgb, event, eval_output=tdetector.eval_output_for(tcfg))
    shapes = sorted(args for _, _, args in calls)
    assert shapes == [(1, 4096, 16)] * 2 + [(1, 16384, 8)] * 2
    assert all(fn == "f32" and no_lse for fn, no_lse, _ in calls)
    assert fa.flash_fwd_f32_launches - before == 4
    assert {fa.f32_launch_plan(*s)["kernel"] for s in shapes} == {"flash_fwd_f32_small"}


@pytest.fixture(scope="module")
def r18_outputs():
    """frn_tpu's and the port's R18 detector at 256x256 (stage 1: 4,096
    tokens at d 8, the smallest stage on the kernel route) on one seeded
    batch of 2 at f32, the port with the attention routed as on the card
    (its flash wrapper's plain version on the CPU); the flash wrapper's
    calls recorded."""
    jcfg, tcfg = configs("dsec", 256, 256, 18)
    jmodel = jdetector.FRNDetector(jcfg)
    variables = seeded_variables(jmodel, jcfg.geometry, seed=1)
    tmodel = tdetector.FRNDetector(tcfg)
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    tmodel.eval()
    rng = np.random.default_rng(2)
    rgb = rng.normal(0, 1, (2, 256, 256, 3)).astype(np.float32)
    event = rng.normal(0, 1, (2, 256, 256, 5)).astype(np.float32)
    eval_output = jdetector.eval_output_for(jcfg)
    jraw = jax.jit(jmodel.apply, static_argnames=("train", "eval_output"))(
        variables, jnp.asarray(rgb), jnp.asarray(event), train=False, eval_output=eval_output)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _as_if_on_the_card(mp)
        wrapper = attention.flash_attention
        mp.setattr(attention, "flash_attention",
                   lambda q, k, v: calls.append(tuple(q.shape)) or wrapper(q, k, v))
        with torch.no_grad():
            traw = tmodel(torch.tensor(rgb), torch.tensor(event), eval_output=eval_output)
    return [np.asarray(x) for x in jraw], [x.numpy() for x in traw], calls


def test_r18_plain_route_takes_the_flash_wrapper_at_stage_1(r18_outputs):
    *_, calls = r18_outputs
    assert calls == [(2, 4096, 8)] * 2


@pytest.mark.parametrize("which", [0, 1], ids=["logits", "deltas"])
def test_r18_plain_route_matches_frn_tpu_at_f32(r18_outputs, which):
    want, got, _ = r18_outputs
    assert got[which].shape == want[which].shape
    assert_close(got[which], want[which])


# ------------------------------------------------------------ phase 15's plan

# (B, N, d, launches per inference batch or micro-step) of every timed
# launch: B1, B3, B4 int8_qk at the inference batch 16 (B4 int8 once over
# 2B); B1-lse, B2a, B2b at the bf16 micro-step's batch 8; B1 at f32 at the
# eval batch 8; the f32 training kernels at the train CLIs' batches 2 and
# (DDD17) 4; DDD17's launches timed on their own (count 0)
PLAN = {
    "flash_fwd": [(16, 19200, 8, 2), (16, 4800, 16, 2)],
    "flash_fwd_bf16exp": [(16, 19200, 8, 2), (16, 4800, 16, 2)],
    "flash_int8_qk": [(16, 19200, 8, 2), (16, 4800, 16, 2)],
    "flash_int8": [(32, 19200, 8, 1), (32, 4800, 16, 1)],
    "flash_fwd_lse": [(8, 19200, 8, 2), (8, 4800, 16, 2)],
    "flash_bwd_dq": [(8, 19200, 8, 2), (8, 4800, 16, 2)],
    "flash_bwd_dkv": [(8, 19200, 8, 2), (8, 4800, 16, 2)],
    "flash_fwd_f32": [(8, 19200, 8, 2), (8, 4800, 16, 2), (8, 5655, 8, 0)],
    "flash_fwd_lse_f32": [(2, 19200, 8, 2), (2, 4800, 16, 2), (4, 5655, 8, 0)],
    "flash_bwd_dq_f32": [(2, 19200, 8, 2), (2, 4800, 16, 2), (4, 5655, 8, 0)],
    "flash_bwd_dkv_f32": [(2, 19200, 8, 2), (2, 4800, 16, 2), (4, 5655, 8, 0)],
}
# the f32 forward's bounds, ms: 4 B N^2 d flops at 67 TFLOP/s
F32_FORWARD_BOUNDS = {(8, 19200, 8): 1.408, (8, 4800, 16): 0.176, (8, 5655, 8): 0.122,
                      (2, 19200, 8): 0.352, (2, 4800, 16): 0.044}


def test_phase_15_times_the_eleven_instances_at_the_paths_batches():
    assert chip_smoke.depth18_launch_shapes() == PLAN


@pytest.mark.parametrize("shape", sorted(F32_FORWARD_BOUNDS))
def test_f32_forward_bounds(shape):
    kind = "flash_fwd_f32" if shape[0] == 8 else "flash_fwd_lse_f32"
    assert _bound_ms(kind, *shape) == pytest.approx(F32_FORWARD_BOUNDS[shape], abs=1e-3)
    t_bytes, t_ops = chip_smoke.f32_bound(*shape, kind)
    assert t_ops > 10 * t_bytes  # the flops bound it


def _bound_ms(kind: str, b: int, n: int, d: int) -> float:
    return max(chip_smoke.depth18_bound(kind, b, n, d)) * 1e3


def _per_step(kind: str) -> float:
    return sum(count * _bound_ms(kind, b, n, d) for b, n, d, count in PLAN[kind])


def test_bounds_per_batch_and_micro_step():
    # the f32 forward: 3.169 ms per DSEC eval batch, 0.792 per f32
    # micro-step; the bf16 forward at batch 16, bound by its B N^2
    # exponentials: 1.512 and 0.0945 ms a launch, 3.213 a batch
    assert _per_step("flash_fwd_f32") == pytest.approx(3.169, abs=1e-3)
    assert _per_step("flash_fwd_lse_f32") == pytest.approx(0.792, abs=1e-3)
    assert _bound_ms("flash_fwd", 16, 19200, 8) == pytest.approx(1.512, abs=1e-3)
    assert _bound_ms("flash_fwd", 16, 4800, 16) == pytest.approx(0.0945, abs=1e-4)
    assert _per_step("flash_fwd") == pytest.approx(3.213, abs=1e-3)
    t_bytes, t_ops = chip_smoke.kernel_bound("flash_fwd", 16, 19200, 8)
    assert t_ops == pytest.approx(16 * 19200 ** 2 / chip_smoke.EXP_PER_S)


@pytest.mark.parametrize("kind", sorted(PLAN))
def test_every_timed_launch_fills_the_card(kind):
    for b, n, d, _ in PLAN[kind]:
        blocks = chip_smoke.depth18_blocks(kind, b, n, d)
        assert blocks >= H100_SMS or kind.startswith("flash_bwd") and kind.endswith("_f32")
    if kind in ("flash_fwd_f32", "flash_fwd_lse_f32"):
        assert [chip_smoke.depth18_blocks(kind, b, n, d) for b, n, d, _ in PLAN[kind]] == (
            [2400, 600, 712] if kind == "flash_fwd_f32" else [600, 150, 356])


def test_phase_15_expects_the_paths_launches():
    # 3 default batches at depth 18 and one at depth 34; one batch of each
    # opt-in configuration; cli.test over 24 images at batch 8 (DSEC 4 a
    # batch, DDD17 2); one f32 train-CLI and one bf16 micro-step
    assert chip_smoke.depth18_path_launches() == {
        "flash_fwd": 16, "flash_fwd_bf16exp": 4, "flash_int8_qk": 4, "flash_int8": 2,
        "flash_fwd_lse": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4, "flash_fwd_f32": 18,
        "flash_fwd_lse_f32": 4, "flash_bwd_dq_f32": 4, "flash_bwd_dkv_f32": 4}


def test_phase_15_kernel_checks_and_timings_rehearsed_on_the_cpu(monkeypatch, capsys):
    # the kernel part of phase 15 at tiny shapes: this revision's wrappers
    # (their plain versions here) against the plain versions, and each row of
    # the kernels line with every key, its blocks and SDPA's backend
    _gen, _randn = torch.Generator, torch.randn
    monkeypatch.setattr(torch, "Generator", lambda device=None: _gen())
    monkeypatch.setattr(torch, "randn", lambda *a, device=None, **k: _randn(*a, **k))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps, warmup=2, windows=1: (1.0, fn()))
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, names, reps=10: fn() and 0.25)
    monkeypatch.setattr(fa, "_int8_library", lambda: None)
    monkeypatch.setattr(chip_smoke, "other_int8", lambda lib, q, inputs, mode: torch.empty_like(q))
    monkeypatch.setattr(chip_smoke, "DEPTH18_FLASH_SHAPES", ((131, 8), (70, 16)))
    monkeypatch.setattr(chip_smoke, "DEPTH18_DDD17_SHAPE", (77, 8))
    for name in ("MAIN_BATCH", "TRAIN_BATCH", "EVAL_BATCH"):
        monkeypatch.setattr(chip_smoke, name, 2)
    rows = chip_smoke.phase_depth18_kernels()
    out = capsys.readouterr().out
    assert sorted(rows) == sorted(kind + "_d8_16" for kind in PLAN)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    for name, row in rows.items():
        assert keys <= set(row) and row["name"] == name and row["route"] == "cuda"
        assert all("blocks" in s and "sdpa_backend" in s for s in row["per_shape"])
    assert [s["count"] for s in rows["flash_fwd_f32_d8_16"]["per_shape"]] == [2, 2, 0]
    assert rows["flash_fwd_f32_d8_16"]["ms"] == 4.0  # the DSEC launches of one eval batch
    assert rows["flash_int8_d8_16"]["library_ms"] is None
    # the B4 rows time the wrapper: the kernel alone and the pre-pass's
    # device time beside it
    for kind in ("flash_int8_qk_d8_16", "flash_int8_d8_16"):
        assert [s["prepass_device_ms"] for s in rows[kind]["per_shape"]] == [0.25, 0.25]
        assert [s["kernel_ms"] for s in rows[kind]["per_shape"]] == [1.0, 1.0]
        assert rows[kind]["prepass_device_ms"] == (1.0 if kind == "flash_int8_qk_d8_16" else 0.5)
    assert rows["flash_int8_d8_16"]["per_shape"][0]["B"] == 4  # 2B under fused attention
    # 2 x 70 key rows in the small dK/dV kernel's 32-row blocks at d 16
    assert re.search(r'flash_bwd_dkv_f32_d8_16 timing \{"B": 2, "N": 70, "d": 16, "blocks": 6,',
                     out)
    assert " 0 outside " in out and " outside " not in out.replace(" 0 outside ", "")
