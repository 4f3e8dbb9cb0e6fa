"""The port's training modules against the JAX package's, on the CPU.

Box encoding and the focal loss (values and gradients), the optimizer recipe
on fixed gradient vectors (clip of the running sum, accumulation, Adam,
warmup, set_learning_rate), the safe step, the plateau schedule, the batch
collation, checkpoints that resume to the same next step, the modality
dropout, the trainer and the training entry point. Inputs are seeded numpy
draws handed to both packages.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from frn_tpu import config as jconfig
from frn_tpu.core.boxes import encode_boxes as j_encode_boxes
from frn_tpu.core.losses import focal_detection_loss as j_focal_loss
from frn_tpu.data.collate import collate_fixed as j_collate
from frn_tpu.train.loop import make_optimizer as j_make_optimizer
from frn_tpu.train.loop import set_learning_rate as j_set_learning_rate
from frn_tpu.train.plateau import ReduceLROnPlateau as JPlateau
from frn_tpu_torch import config as tconfig
from frn_tpu_torch.core.anchors import anchors_tensor
from frn_tpu_torch.core.boxes import encode_boxes, pairwise_iou
from frn_tpu_torch.core.losses import focal_detection_loss
from frn_tpu_torch.data.collate import collate_fixed
from frn_tpu_torch.data.loader import BatchLoader, to_device
from frn_tpu_torch.data.synthetic import box_samples
from frn_tpu_torch.entry import train_entry
from frn_tpu_torch.models.detector import draw_modality_drop, init_detector
from frn_tpu_torch.train.checkpoint import CheckpointManager
from frn_tpu_torch.train.loop import (
    apply_gradients,
    create_train_state,
    make_train_step,
    set_learning_rate,
    torch_clip_by_global_norm,
)
from frn_tpu_torch.train.plateau import ReduceLROnPlateau
from frn_tpu_torch.train.trainer import Trainer

TINY = dataclasses.replace(tconfig.DSEC, height=32, width=48)


def tiny_config(accum=1, dropout=0.0, **train_kw):
    return tconfig.FrameworkConfig(
        geometry=TINY,
        model=tconfig.ModelConfig(variant="fusion", depth=18, feature_size=16,
                                  attention_chunk=64, modality_dropout=dropout),
        train=tconfig.TrainConfig(batch_size=2, accum_steps=accum, max_annots_per_image=4,
                                  **train_kw),
    )


def tiny_batch(seed=0, n=2):
    return collate_fixed(box_samples(n, TINY, seed=seed), TINY, 4, n)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's default of one
    intra-op thread per core in each of them oversubscribes the CPU, and these
    small shapes gain nothing from more than one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ boxes and loss


def test_encode_boxes_matches_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 200, (50, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 80, (50, 2))], 1).astype(np.float32)
    xy = rng.uniform(0, 200, (50, 2))
    gt = np.concatenate([xy, xy + rng.uniform(0, 60, (50, 2))], 1).astype(np.float32)
    gt[:5, 2:] = gt[:5, :2] + 0.25  # below min_size: clamped before the log
    want = np.asarray(j_encode_boxes(jnp.asarray(anchors), jnp.asarray(gt)))
    got = encode_boxes(torch.tensor(anchors), torch.tensor(gt), std=(0.1, 0.1, 0.2, 0.2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _loss_inputs():
    """Anchors of the tiny geometry and three images: two boxes plus a padded
    row that overlaps anchors (class -1), no annotation at all, and a box with
    an anchor in the 0.4-0.5 ignore band and a duplicate of different class
    (the first of equal IoUs is assigned, as jnp.argmax does)."""
    anchors = anchors_tensor((TINY.height, TINY.width), tconfig.AnchorConfig(), torch.device("cpu"))
    a = anchors.numpy()
    annot = np.full((3, 4, 5), -1.0, np.float32)
    annot[0, 0] = [2, 3, 20, 25, 1]
    annot[0, 1] = [20, 5, 46, 30, 2]
    annot[0, 2] = [2, 3, 20, 25, -1]
    i = 100
    w = a[i, 2] - a[i, 0]
    shift = w * 0.55 / 1.45 * 0.98  # IoU with anchor i just above 0.45
    annot[2, 0] = [a[i, 0] + shift, a[i, 1], a[i, 2] + shift, a[i, 3], 2]
    annot[2, 1] = [4, 4, 28, 28, 0]
    annot[2, 2] = [4, 4, 28, 28, 2]
    rng = np.random.default_rng(1)
    cls = rng.uniform(0.0, 1.0, (3, a.shape[0], 3)).astype(np.float32)
    reg = rng.normal(0, 1, (3, a.shape[0], 4)).astype(np.float32)
    return anchors, annot, cls, reg


def test_loss_inputs_reach_every_branch():
    anchors, annot, _, _ = _loss_inputs()
    iou = pairwise_iou(anchors, torch.tensor(annot[2, :3, :4])).max(dim=1).values
    assert ((iou >= 0.4) & (iou < 0.5)).any() and (iou >= 0.5).any()
    assert (annot[1, :, 4] < 0).all() and annot[0, 2, 4] < 0


def test_focal_loss_matches_jax():
    anchors, annot, cls, reg = _loss_inputs()
    want = j_focal_loss(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors.numpy()),
                        jnp.asarray(annot))
    got = focal_detection_loss(torch.tensor(cls), torch.tensor(reg), anchors, torch.tensor(annot))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)


def test_focal_loss_per_image_branches_match_jax():
    # each image alone: the empty one is the all-background branch (reg 0)
    anchors, annot, cls, reg = _loss_inputs()
    for b in range(3):
        sl = slice(b, b + 1)
        want = j_focal_loss(jnp.asarray(cls[sl]), jnp.asarray(reg[sl]),
                            jnp.asarray(anchors.numpy()), jnp.asarray(annot[sl]))
        got = focal_detection_loss(torch.tensor(cls[sl]), torch.tensor(reg[sl]), anchors,
                                   torch.tensor(annot[sl]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.item(), float(w), rtol=1e-5, atol=1e-7)
        if b == 1:
            assert got[1].item() == 0.0 and got[0].item() > 0.0


def test_focal_loss_gradients_match_jax():
    anchors, annot, cls, reg = _loss_inputs()

    def j_total(c, r):
        cl, rl = j_focal_loss(c, r, jnp.asarray(anchors.numpy()), jnp.asarray(annot))
        return cl + rl

    want = jax.grad(j_total, argnums=(0, 1))(jnp.asarray(cls), jnp.asarray(reg))
    c, r = torch.tensor(cls, requires_grad=True), torch.tensor(reg, requires_grad=True)
    sum(focal_detection_loss(c, r, anchors, torch.tensor(annot))).backward()
    for g, w in zip((c.grad, r.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6 * np.abs(w).max())


# ------------------------------------------------------------ optimizer recipe


class _Vector(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))


GRAD_SCALES = (1.0, 0.5, 0.004, 2.0, 0.003, 0.002, 1.5, 0.8, 3.0, 0.001)


def _fixed_grads(n=37, seed=42):
    # gradient norms straddle the 0.1 clip threshold so both clip branches run
    rng = np.random.default_rng(seed)
    w0 = rng.normal(0, 1, n).astype(np.float32)
    return w0, [(rng.normal(0, 1, n) * s).astype(np.float32) for s in GRAD_SCALES]


def _both_optimizers(accum, warmup, set_lr_at=None, lr2=3e-5):
    """Final weights of the JAX optimizer (make_optimizer) and the port's
    apply_gradients over the same fixed gradient vectors."""
    w0, grads = _fixed_grads()
    jcfg = jconfig.FrameworkConfig(train=jconfig.TrainConfig(
        learning_rate=1e-4, accum_steps=accum, warmup_steps=warmup))
    tcfg = tconfig.FrameworkConfig(train=tconfig.TrainConfig(
        learning_rate=1e-4, accum_steps=accum, warmup_steps=warmup))
    tx = j_make_optimizer(jcfg)
    w_j = jnp.asarray(w0)
    opt_state = tx.init(w_j)
    state = create_train_state(tcfg, model=_Vector(w0.copy()))
    for i, g in enumerate(grads):
        if i == set_lr_at:
            opt_state = j_set_learning_rate(opt_state, lr2)
            set_learning_rate(state, lr2)
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, w_j)
        w_j = optax.apply_updates(w_j, updates)
        apply_gradients(state, [torch.tensor(g)], tcfg)
    return np.asarray(w_j), state.params[0].detach().numpy(), state, w0


@pytest.mark.parametrize("accum,warmup", [(2, 0), (1, 0), (2, 3), (1, 4)])
def test_optimizer_recipe_matches_jax_on_fixed_gradients(accum, warmup):
    want, got, state, w0 = _both_optimizers(accum, warmup)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    assert state.opt_steps == len(GRAD_SCALES) // accum and state.step == len(GRAD_SCALES)
    assert np.abs(got - w0).max() > 1e-5


@pytest.mark.parametrize("accum", [1, 2])
def test_set_learning_rate_matches_jax(accum):
    want, got, state, _ = _both_optimizers(accum, 0, set_lr_at=4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    assert state.base_lr == 3e-5
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(3e-5)


def test_warmup_multiplier_counts_optimizer_steps():
    w0, grads = _fixed_grads()
    cfg = tconfig.FrameworkConfig(train=tconfig.TrainConfig(accum_steps=2, warmup_steps=4))
    state = create_train_state(cfg, model=_Vector(w0.copy()))
    lrs = []
    for g in grads[:6]:
        apply_gradients(state, [torch.tensor(g)], cfg)
        lrs.append(state.optimizer.param_groups[0]["lr"])
    # micro-steps 2, 4, 6 are optimizer steps t = 0, 1, 2: lr * (t + 1) / 4
    assert lrs[1::2] == pytest.approx([0.25e-4, 0.5e-4, 0.75e-4])


def test_clip_by_global_norm_scales_by_torch_rule():
    rng = np.random.default_rng(3)
    gs = [torch.tensor(rng.normal(0, 1, s).astype(np.float32)) for s in ((3, 4), (7,))]
    norm = float(np.sqrt(sum((g.numpy() ** 2).sum() for g in gs)))
    want = [g.numpy() * min(1.0, 0.1 / (norm + 1e-6)) for g in gs]
    got_norm = torch_clip_by_global_norm(gs, 0.1)
    assert got_norm.item() == pytest.approx(norm, rel=1e-6)
    for g, w in zip(gs, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
    small = [torch.full((4,), 1e-3)]
    torch_clip_by_global_norm(small, 0.1)  # under the threshold: unchanged
    assert torch.equal(small[0], torch.full((4,), 1e-3))


def test_skipped_micro_step_still_counts_toward_the_boundary():
    w0, grads = _fixed_grads()
    cfg = tconfig.FrameworkConfig(train=tconfig.TrainConfig(accum_steps=2))
    state = create_train_state(cfg, model=_Vector(w0.copy()))
    apply_gradients(state, [torch.tensor(grads[0])], cfg, ok=torch.tensor(False))
    assert state.mini_step == 1 and torch.count_nonzero(state.acc_grads[0]) == 0
    apply_gradients(state, [torch.tensor(grads[1])], cfg, ok=torch.tensor(True))
    assert state.mini_step == 0 and state.opt_steps == 1


# ------------------------------------------------------------ the train step


def test_safe_step_skips_nan_batch():
    cfg = tiny_config()
    state = create_train_state(cfg, seed=0, device="cpu")
    before = [p.detach().clone() for p in state.params]
    bad = tiny_batch()
    bad["event"][0, 0, 0, 0] = np.nan
    metrics = make_train_step(cfg)(state, bad, torch.Generator().manual_seed(0))
    assert metrics["skipped"].item() == 1.0 and not np.isfinite(metrics["loss"].item())
    for a, b in zip(before, state.params):
        assert torch.equal(a, b)
    assert state.step == 1 and state.opt_steps == 1


def test_loss_threshold_skips_and_is_optional():
    cfg = tiny_config()
    batch = tiny_batch()
    for threshold, skipped in ((1e-3, 1.0), (None, 0.0)):
        state = create_train_state(cfg, seed=0, device="cpu")
        metrics = make_train_step(cfg, loss_skip_threshold=threshold)(
            state, batch, torch.Generator().manual_seed(0))
        assert metrics["skipped"].item() == skipped


def test_accumulation_applies_every_k():
    cfg = tiny_config(accum=2)
    state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg)
    batch = tiny_batch()
    p0 = [p.detach().clone() for p in state.params]
    step(state, batch, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(p0, state.params))
    assert any(torch.count_nonzero(a) for a in state.acc_grads)
    step(state, batch, torch.Generator().manual_seed(0))
    assert any(not torch.equal(a, b) for a, b in zip(p0, state.params))
    assert all(torch.count_nonzero(a) == 0 for a in state.acc_grads)


def test_loss_decreases_on_fixed_batch():
    # the default lr 1e-4; at 1e-3 the stock initializers' activations make
    # single Adam steps overshoot (the loss can jump a hundredfold)
    cfg = tiny_config()
    state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg)
    batch = tiny_batch(seed=3)
    losses = [step(state, batch, None)["loss"].item() for _ in range(5)]
    assert losses[-1] < losses[0] * 0.8, losses


# ------------------------------------------------------------ modality dropout


def test_modality_dropout_rate():
    gen = torch.Generator().manual_seed(11)
    rate = np.mean([draw_modality_drop(gen, 0.15) for _ in range(4000)])
    assert abs(rate - 0.15) <= 0.03


def test_dropped_batch_has_all_zero_rgb():
    cfg = tiny_config(dropout=0.15)
    model = init_detector(cfg, seed=0, device="cpu").train()
    seen = []
    hook = model.conv1.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    batch = {k: torch.tensor(v) for k, v in tiny_batch().items()}
    try:
        with torch.no_grad():
            model(batch["rgb"], batch["event"], drop=True)
            model(batch["rgb"], batch["event"], drop=False)
            # a generator that drops on its first draw: the same decision inside
            seed = next(s for s in range(100) if draw_modality_drop(
                torch.Generator().manual_seed(s), 0.15))
            model(batch["rgb"], batch["event"], generator=torch.Generator().manual_seed(seed))
            model.eval()
            model(batch["rgb"], batch["event"], drop=True)  # eval mode: no dropout
    finally:
        hook.remove()
    assert [bool((x == 0).all()) for x in seen] == [True, False, True, False]
    with pytest.raises(ValueError, match="generator"):
        model.train()(batch["rgb"], batch["event"])


# ------------------------------------------------------------ plateau, collate


def test_plateau_matches_jax():
    metrics = [1.0, 1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.8999999, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6]
    ours, ref = ReduceLROnPlateau(base_lr=1e-4), JPlateau(base_lr=1e-4)
    assert [ours.step(m) for m in metrics] == [ref.step(m) for m in metrics]
    assert ours.state_dict() == ref.state_dict() and ours.lr < 1e-4
    again = ReduceLROnPlateau(base_lr=1.0)
    again.load_state_dict(ours.state_dict())
    assert again.state_dict() == ours.state_dict()


def test_collate_fixed_matches_jax():
    rng = np.random.default_rng(5)
    samples = []
    for h, w, k in ((32, 48, 2), (30, 40, 0), (32, 45, 6)):  # smaller images, > max annots
        samples.append({"rgb": rng.normal(0, 1, (h, w, 3)).astype(np.float32),
                        "event": rng.normal(0, 1, (h, w, 5)).astype(np.float32),
                        "annot": rng.uniform(0, 30, (k, 5)).astype(np.float32)})
    jgeo = dataclasses.replace(jconfig.DSEC, height=32, width=48)
    want = j_collate(samples, jgeo, max_annots=4, batch_size=4)
    got = collate_fixed(samples, TINY, max_annots=4, batch_size=4)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype


def test_collate_events_wire_raises():
    """Events-wire samples of different capacities do not stack (the events
    branch itself is held against frn_tpu's in test_torch_dsec_det.py)."""
    def sample(cap):
        return {"event_x": np.zeros(cap, np.int16), "event_y": np.zeros(cap, np.int16),
                "event_t": np.zeros(cap, np.int32), "event_p": np.zeros(cap, np.int8),
                "event_n": np.int32(0), "rgb": np.zeros((32, 48, 3), np.uint8),
                "annot": np.zeros((0, 5), np.float32)}
    assert collate_fixed([sample(4), sample(4)], TINY)["event_x"].shape == (2, 4)
    with pytest.raises(ValueError):
        collate_fixed([sample(4), sample(6)], TINY)


def test_unported_train_options_raise():
    for wire in ("f32", "compact", "events"):
        assert tconfig.TrainConfig(input_wire=wire).input_wire == wire
    with pytest.raises(ValueError):
        tconfig.TrainConfig(input_wire="png")


def test_batch_loader_shuffles_by_seed_and_drops_last():
    samples = box_samples(7, TINY, seed=2)
    for threads in (0, 2):
        loader = BatchLoader(samples, TINY, batch_size=2, shuffle=True, num_threads=threads,
                             max_annots=4, drop_last=True, seed=9)
        batches = list(loader)
        assert len(batches) == len(loader) == 3
        assert all(b["sample_mask"].all() and b["rgb"].shape == (2, 32, 48, 3) for b in batches)
    order = np.random.default_rng(9).permutation(7)
    np.testing.assert_array_equal(batches[0]["rgb"][1], samples[order[1]]["rgb"])
    moved = to_device(batches[0], "cpu")
    assert moved["annot"].dtype == torch.float32 and moved["sample_mask"].dtype == torch.bool


# ------------------------------------------------------------ checkpoints, trainer


def test_checkpoint_resumes_to_the_same_next_step(tmp_path):
    cfg = tiny_config(accum=2, dropout=0.15)
    step = make_train_step(cfg)
    batch = tiny_batch()
    state = create_train_state(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for _ in range(3):  # one optimizer step, then a half-full gradient sum
        step(state, batch, gen)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, state, meta={"loss_history": [2.0], "generator": gen.get_state()})

    other = create_train_state(cfg, seed=5, device="cpu")
    meta = mgr.restore(other)
    assert meta["epoch"] == 7 and meta["loss_history"] == [2.0] and mgr.latest_epoch() == 7
    assert (other.mini_step, other.step, other.opt_steps) == (1, 3, 1)
    gen2 = torch.Generator().manual_seed(0)
    gen2.set_state(meta["generator"])
    m1, m2 = step(state, batch, gen), step(other, batch, gen2)
    assert m1["loss"].item() == m2["loss"].item()
    for a, b in zip(state.params, other.params):
        assert torch.equal(a, b)
    assert other.opt_steps == 2


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    cfg = tiny_config()
    state = create_train_state(cfg, seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for epoch in (1, 2, 3):
        mgr.save(epoch, state)
    assert mgr.epochs() == [2, 3]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_trainer_fit_and_resume(tmp_path):
    cfg = dataclasses.replace(tiny_config(accum=2, dropout=0.15),
                              train=dataclasses.replace(tiny_config().train, accum_steps=2,
                                                        checkpoint_every=1))
    samples = box_samples(6, TINY, seed=6)
    trainer = Trainer(cfg, samples, checkpoint_dir=str(tmp_path), device="cpu", log_every=1)
    history = trainer.fit(epochs=1)
    assert len(history) == 1 and np.isfinite(history[0])
    assert (trainer.state.step, trainer.state.opt_steps, trainer.state.mini_step) == (3, 1, 1)

    resumed = Trainer(cfg, samples, checkpoint_dir=str(tmp_path), device="cpu", seed=3)
    assert resumed.resume() and resumed.epoch == 1 and resumed.history == history
    assert resumed.scheduler.state_dict() == trainer.scheduler.state_dict()
    batch = to_device(collate_fixed(samples[:2], TINY, 4, 2), "cpu")
    trainer.step_fn(trainer.state, batch, trainer.generator)
    resumed.step_fn(resumed.state, batch, resumed.generator)
    for a, b in zip(trainer.state.params, resumed.state.params):
        assert torch.equal(a, b)


def test_train_entry_builds_on_cpu_when_asked():
    # the full DSEC ResNet-50 bf16 trainer is built on the CPU but not run there
    trainer, batch = train_entry(device="cpu", batch=2, num_samples=3)
    cfg = trainer.config
    assert (cfg.model.depth, cfg.model.compute_dtype, cfg.model.feature_size) == (50, "bfloat16", 256)
    assert (cfg.train.batch_size, cfg.train.accum_steps, cfg.train.learning_rate,
            cfg.train.grad_clip_norm) == (2, 2, 1e-4, 0.1)
    assert trainer.state.model.training and len(trainer.dataset) == 3
    assert {p.dtype for p in trainer.state.params} == {torch.float32}
    assert batch["rgb"].shape == (2, 480, 640, 3) and batch["event"].shape == (2, 480, 640, 5)
    assert batch["annot"].shape == (2, 64, 5)
    n_boxes = (batch["annot"][..., 4] >= 0).sum(dim=1)
    assert ((n_boxes >= 1) & (n_boxes <= 3)).all()


def test_train_entry_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_entry(batch=1, num_samples=1)
