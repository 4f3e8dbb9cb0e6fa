#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``frn_tpu_torch``).

    python3 chip_smoke.py          # one CUDA card; exits non-zero on any failure
    python3 chip_smoke.py --other-source OLD/csrc/flash_attention.cu \
                          --other-source OLD/csrc/flash_attention_bwd.cu \
                          --other-source OLD/csrc/flash_attention_int8.cu \
                          --other-source OLD/csrc/stem.cu \
                          --other-source OLD/csrc/flash_attention_f32.cu \
                          --other-source OLD/csrc/flash_attention_bwd_f32.cu
                                   # the same, and another revision's kernels timed beside

Phases:
  1. environment and build: the card's name and power limit, then every CUDA
     kernel of the port built from ``frn_tpu_torch/csrc`` (one nvcc each, in
     parallel), with each kernel instance's registers and spills (the
     path's wgmma instances of the forward, the backward, the int8 forward
     and the stem, and the f32 forward's, dQ and dK/dV kernels'
     register-blocked instances at d 32 and 64 and their first designs at d
     8 and 16, must each be there, and may not spill);
  2. each kernel against its plain PyTorch version on the card, at the shapes
     of its path (the forward; the forward with lse and the dQ and dK/dV
     backward kernels, ragged N and head dims 8 and 16 included, and the
     kernels' block edges: N 40 at every head dim, 128, 129 and 4,800; the
     forward's lse also in its mean gap, MEAN_LSE_ATOL; the f32 forward at
     the same shapes; the f32 training kernels, B1-lse, B2a and B2b at f32,
     at the f32 train path's shapes, d 8 and 16, the block edges, and with
     lse < -88 at ragged N), then
     timed (CUDA events) at its path's batch beside its bound and a one-call
     PyTorch yardstick (``library_ms``, never used by the port), the timed
     runs' outputs held against each other (the f32 forward at the eval
     batch, SDPA at f32 beside it; the f32 training kernels per DSEC
     micro-step at the train CLI's batch 2, SDPA at f32 and its autograd
     backward beside them, each launch's block count, and DDD17 at batch 4);
     with ``--other-source``, each
     other revision's forward entry points (B1, B1 with lse, B3) or backward
     entry points (B2a dQ, B2b dK/dV) or f32 forward (B1 and B1-lse at f32,
     at every launch of the eval and f32 train paths, with each launch's
     block count) or f32 backward (B2a and B2b at f32, at every launch of
     the f32 train path, with each launch's block count) built by the same
     flags and timed in turns with this revision's at the path's shapes and
     batches;
  3. the inference path, through ``frn_tpu_torch.entry.entry()``: DSEC
     480x640 fusion inference, two ResNet-50 backbones, bf16, batch 16,
     forward + pooled decode + NMS. Launch counts are zeroed just before the
     timed batches and read just after. The outputs are checked: finite, of
     the expected shapes, with detections; the logits agree with the same
     model run with the plain attention; then the device time of each layer
     of the path (CUDA events between layers), and a torch.profiler pass over
     one batch for the device-busy share and the costliest kernels; last, a
     small f32 model on the card agrees with the same model on the CPU;
  4. the training path, through ``frn_tpu_torch.entry.train_entry()``: the
     same detector at batch 8 with Adam and accum_steps 2. ``Trainer.fit``
     over 48 seeded samples with launch counts zeroed just before and read
     just after (4 forward-with-lse, 4 dQ and 4 dK/dV launches per
     micro-step), finite losses, params still after each first micro-step
     and moved after each second; timed micro-steps with img/s and peak
     memory; the batch's gradients against the plain attention; a
     checkpoint saved and resumed on the card; a profiler pass; a small f32
     train step on the card against the CPU;
  5. the opt-in inference kernels (the bf16-exp forward, the int8 forward in
     both modes, the fused stem) against their plain versions at the same
     check shapes (the stem at C 3 and 5, DSEC and DDD17 sizes, a tiny image
     and a ragged last 64-pixel tile), and the
     int8 forward's quantization pre-pass kernel bitwise against its plain
     version there, then timed at the opt-in path's batches beside their
     bounds, their plain versions and a PyTorch yardstick; with
     ``--other-source``, another revision's int8 forward (after the torch
     pre-pass, as its wrapper ran it) timed in turns with this revision's,
     whole and kernel alone, and another revision's stem timed in turns with
     this revision's at the opt-in batch; run before phase 3, and phase 3
     asserts that the default path launches none of them;
  6. the opt-in inference path through ``entry(..., **ModelConfig fields)``
     at batch 16 in three configurations: stem kernel + bf16-exp; int8_qk;
     int8 + fused attention. Each: ms per batch and img/s over 5 batches,
     launch counts zeroed just before and read just after, finite
     detections, the stem's output on the batch's own inputs against its
     plain version, logits and deltas against the same model with the
     attention kernels swapped for their plain versions, and (printed, not
     gated) against the model with every kernel swapped and against the
     default path's, beside a witness of what the stem's one-ulp differences
     alone do to the all-plain model; a torch.profiler pass over one batch;
  7. one JSON line listing the kernels, then the last line
     {"ok": true, "device": {...}};
  8. the evaluation path, ``python -m frn_tpu_torch.cli.test`` (its
     ``main``) on fixtures written by the port's ``make_csv_fixture`` with
     seeded ``.pth`` weights, fusion ResNet-50 at full width: DSEC at bf16,
     DSEC at the CLI's default f32 and DDD17 (``test_ddd17``, f32). Each:
     launch counts zeroed just before and read just after (bf16: B1 4 per
     batch; f32: the f32 forward 4 per DSEC and 2 per DDD17 batch, nothing
     else), summary and APs finite in [0, 1], img/s end to end (the CLI's,
     and the loop's again warm), device ms of forward + decode + NMS per
     batch and the warm eval loop's idle share. At
     DSEC f32 also: ``collect_detections``' rows against the inference
     function's output on the same batch, the logits against the plain
     attention, and the corruption sweep over the seven OpenCV-free
     corruptions at severities 1 and 5. Then the folder protocol through
     the CLI (--corruption_root over a tree the phase writes) and a small
     f32 evaluation on the card against the CPU. Phase 4 then evaluates
     in ``Trainer.fit`` (``eval_fn``) and checks the best-mAP checkpoint;
  9. the f32 training path, ``python -m frn_tpu_torch.cli.train`` (its
     ``main``) at the CLI's default f32, fusion ResNet-50 at full width from
     the seeded ``.pth`` files of phase 8: DSEC at batch 2, one epoch over 24
     fixture images with the periodic evaluation (--csv_test, --eval_every
     1), then ``train_ddd17`` at batch 4. Each: launch counts zeroed just
     before and read just after (B1-lse, B2a and B2b at f32 4 times per DSEC
     and 2 per DDD17 micro-step; B1 at f32 4 per eval batch; nothing
     else), finite losses, the (best-mAP) checkpoint written. Then, on the
     trainer the CLI builds, one micro-step's gradients at the checkpoint's
     weights against the plain attention, per tensor and over all
     parameters (F32_GRAD_REL_TOL, F32_GRAD_NORM_TOL), beside a witness of
     what one ulp of the attention's outputs does to them; then DSEC f32
     micro-steps at batch 2 timed (host clock and CUDA events; img/s, peak
     memory) and a profiler pass for the device-busy time and idle share;
 10. the raw DSEC-Det path at the DSEC-Det CLIs' defaults (480x640, fusion
     ResNet-50, feature size 256, f32) on a fixture of 3 sequences of 6
     frames written by the port's ``make_dsec_det_fixture``, through the
     CLIs' own helpers (``train_dsec_det_fast``: its dataset and recipe,
     then ``Trainer.fit``; ``test_dsec_det``: its dataset, config and
     inference function, then ``evaluate_dataset``). The card's machine has
     no h5py, so each sequence reads its events from memory
     (``_ArrayEvents``, the h5 reader's window semantics) instead of the h5
     file; the h5 reader and the two CLIs' ``main`` are held on the CPU by
     the tests. The three wires on every sample (the events wire's device
     voxel equal to the host count grid, the squashed grids within
     WIRE_TANH_RTOL of the f32 wire's, h2d bytes and the voxelization's
     device ms per batch); one epoch at batch 4 on each wire (launch counts
     zeroed just before and read just after: B1-lse, B2a and B2b at f32 4
     times a micro-step, nothing else; finite losses, skipped micro-steps
     counted, the checkpoint written; img/s, the loader's host ms per batch,
     warm epochs' idle share); the events batch's loss and gradients
     against the f32 batch's at the events trainer's initial weights
     (WIRE_LOSS_RTOL, the phase-9 gate, a one-ulp witness; printed again
     after its epochs); the events run's checkpoint evaluated on the f32 and compact
     wires at batch 8 (B1 at f32 4 times a batch, nothing else; the summary
     in [0, 1], fps, idle share) and the two wires' logits on one batch
     within EVAL_F32_REL_TOL.

Phases run in the order 1, 2, 5, 3, 6, 8, 4, 9, 10, 7. Phase 9 alone:
``python3 -c "import chip_smoke as c, tempfile, pathlib; c.phase_environment();
r = {k: {} for k in c.TRAIN_F32_KERNELS}; d = pathlib.Path(tempfile.mkdtemp());
c.phase_train_f32(r, c.write_eval_inputs(d), d)"``. Phase 10 alone (about a
minute of a call after the build): ``python3 -c "import chip_smoke as c,
tempfile, pathlib; c.phase_environment(); r = {k: {'launches': 0} for k in
c.TRAIN_F32_KERNELS + ('flash_fwd_f32',)};
c.phase_dsec_det(r, pathlib.Path(tempfile.mkdtemp()))"``.
"""

import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet) and the special-function-unit exp rate
# (FlashAttention-3 paper, H100 SXM5): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over their unit's rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
EXP_PER_S = 3.9e12
# FP32 on the CUDA cores (H100 SXM data sheet: 67 TFLOPS), the f32 forward's rate
F32_FLOP_PER_S = 67e12

# kernel vs plain on bf16 outputs: both round p to bf16 before PV, but their
# exps and f32 sums differ in the last bits, so a p can land one bf16 ulp
# apart, and the output itself is rounded to bf16 (relative step 2^-8)
FLASH_ATOL, FLASH_RTOL = 2e-2, 2e-2
# the f32 forward vs its plain version (f32 outputs): the same recurrence with
# p unrounded, but ex2.approx against exp2 (2 ulps of p), the scores' FMA
# order over d against the matmul's, and sums over up to 19,200 keys in
# another order; the kernel's 32-key tile at d 64 against the plain 64 changes
# only the rounding. On an H100 the largest difference was 1.2e-5, at N 19,200
FLASH_F32_ATOL, FLASH_F32_RTOL = 2e-5, 1e-4
# B1-lse at f32 vs its plain version: lse = m + log(l) in both, m from scores
# whose FMA order over d differs from the matmul's by a few ulps of |s| (up to
# about 30 at these inputs), l summed in another order
LSE_F32_ATOL = 1e-4
# B2a and B2b at f32 vs their plain versions (f32 outputs), atol a share of
# each output's max |value|: P = ex2(fma(s, log2 e, -lse log2 e)) against
# exp(s - lse), the scores' few-ulp differences (above) carried into P, and
# sums over up to 19,200 keys or queries in another order
BWD_F32_ATOL, BWD_F32_RTOL = 1e-4, 1e-3
# main path with the kernel vs with the plain attention, as max|diff| over
# max|ref| of the bf16 logits and deltas: the attention outputs' one-ulp
# differences pass through the W conv, AdaIN, the FPN and the heads' five
# convs, each rounding to bf16 (relative step 2^-8)
MAIN_REL_TOL = 5e-2
MAIN_BATCH, MAIN_TIMED = 16, 5
# lse of the kernel vs the plain version (f32): __expf against exp and another
# summation order move the log of the denominator by about 1e-5
LSE_ATOL = 1e-3
# mean |lse gap| of B1-lse (B1's instances) against the plain version. Both sum
# the bf16-rounded p into the denominator, as frn_tpu's ones lane does, from
# the same scores and exp2 argument: what is left (ex2.approx against exp2,
# summation order) came to 1e-7 to 2.4e-7 on an H100. Summing the f32 p, as
# the port did before, leaves each row's denominator off by the sum of its
# p's rounding errors: 1.1e-4 to 3.5e-4 there
MEAN_LSE_ATOL = 2e-5
# backward kernels vs plain versions on bf16 outputs: both round P and dS to
# bf16 before their products, but a P or dS can land one bf16 ulp apart
# (__expf against exp), and such differences add up over the N keys or
# queries of a row; atol is a share of the output's max |value|
BWD_ATOL, BWD_RTOL = 1e-2, 2e-2
# the paths' shapes (DSEC stages 1 and 2, DDD17's ragged N) and more ragged N,
# head dims 8 and 16 included
PATH_CHECK_SHAPES = ((2, 19200, 32), (2, 4800, 64), (2, 5655, 32), (2, 131, 32), (2, 517, 64),
                     (2, 4800, 16), (2, 5655, 8))
# the block edges of the forward and the backward kernels (64-row tiles,
# blocks of 64 or 128 rows): one partial tile with a wholly idle half block
# (N 40 < 64 of a 128-row block) at every head dim, the path's half-idle last
# 128-row block (N 4,800 = 37.5 x 128), an exact fit and one ragged row past it
FWD_EDGE_SHAPES = ((2, 40, 8), (2, 40, 16), (2, 40, 32), (2, 40, 64), (2, 4800, 64), (2, 128, 32),
                   (2, 129, 32))
# the forward, its bf16-exp variant and both backward kernels are held to
# their plain versions at both
BWD_CHECK_SHAPES = PATH_CHECK_SHAPES + tuple(
    s for s in FWD_EDGE_SHAPES if s not in PATH_CHECK_SHAPES)
# the f32 training kernels (B1-lse, B2a, B2b at f32): the f32 train path's
# shapes (DSEC stages 1 and 2 at batch 2, DDD17 at batch 4 and N 5,655,
# ragged), one shape at each of d 8 and 16, and the block edges (N 40 at
# every head dim: 64-row blocks at d 64, 128 below; ragged N past whole tiles)
F32_TRAIN_CHECK_SHAPES = ((2, 19200, 32), (2, 4800, 64), (4, 5655, 32), (2, 4800, 16),
                          (2, 5655, 8), (2, 40, 8), (2, 40, 16), (2, 40, 32), (2, 40, 64),
                          (2, 131, 32), (2, 517, 64), (2, 129, 16))
# and, with the scores shifted far below zero (lse < -88, where a key past N
# that were not masked would give P = exp(-lse) = inf), at ragged N. There
# column 0 of q and k is 11 and -11 (the rest N(0, 0.5^2)): column 0 of dQ
# (dK) sums terms of size 11 |dS| that cancel to about 0 in exact arithmetic
# (a row of dS sums to 0), so either version's value there is rounding noise
# of those terms, and the gradients are held at F32_TRAP_ATOL of their max
# |value| (the largest gap on an H100 was 1.2e-4 of it, dQ at N 517, d 64)
F32_LSE_TRAP_SHAPES = ((2, 131, 16), (4, 5655, 32), (2, 517, 64))
F32_TRAP_ATOL = 1e-3
# the training step is launch-bound on the host, so its time varies with the
# host's load: ten timed micro-steps, and the median beside the mean
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_TIMED = 8, 48, 10
# training gradients with the kernels vs with the plain attention, as the
# global norm of the difference over that of the reference: the attention
# outputs' and gradients' one-ulp bf16 differences pass through every layer
# of the backward pass, each rounding to bf16 (relative step 2^-8)
TRAIN_GRAD_REL_TOL = 5e-2
# timing shapes (N, d): DSEC stages 1 and 2, two directions each per forward
FLASH_SHAPES = ((19200, 32), (4800, 64))
# DDD17's one flash stage (stage 1, ragged), two directions per forward
DDD17_FLASH_SHAPE = (5655, 32)
# the evaluation CLI's default batch
EVAL_BATCH = 8
# the train CLI's batches (cli/train.py, cli/train_ddd17.py)
F32_TRAIN_BATCH, DDD17_TRAIN_BATCH = 2, 4
KERNEL_SOURCES = {
    "flash_fwd": ("frn_tpu_torch/csrc/flash_attention.cu", "frn_tpu/ops/flash_attention.py:39"),
    "flash_fwd_f32": ("frn_tpu_torch/csrc/flash_attention_f32.cu", "frn_tpu/ops/flash_attention.py:39"),
    "flash_fwd_lse": ("frn_tpu_torch/csrc/flash_attention.cu", "frn_tpu/ops/flash_attention.py:39"),
    "flash_fwd_lse_f32": ("frn_tpu_torch/csrc/flash_attention_f32.cu",
                          "frn_tpu/ops/flash_attention.py:39"),
    "flash_bwd_dq_f32": ("frn_tpu_torch/csrc/flash_attention_bwd_f32.cu",
                         "frn_tpu/ops/flash_attention.py:275"),
    "flash_bwd_dkv_f32": ("frn_tpu_torch/csrc/flash_attention_bwd_f32.cu",
                          "frn_tpu/ops/flash_attention.py:300"),
    "flash_bwd_dq": ("frn_tpu_torch/csrc/flash_attention_bwd.cu", "frn_tpu/ops/flash_attention.py:275"),
    "flash_bwd_dkv": ("frn_tpu_torch/csrc/flash_attention_bwd.cu", "frn_tpu/ops/flash_attention.py:300"),
    "flash_fwd_bf16exp": ("frn_tpu_torch/csrc/flash_attention.cu", "frn_tpu/ops/flash_attention.py:101"),
    "flash_int8_qk": ("frn_tpu_torch/csrc/flash_attention_int8.cu", "frn_tpu/ops/flash_attention.py:656"),
    "flash_int8": ("frn_tpu_torch/csrc/flash_attention_int8.cu", "frn_tpu/ops/flash_attention.py:656"),
    # the int8 forward's quantization pre-pass (the JAX wrapper's `quantize`,
    # no Pallas kernel of its own)
    "int8_qk_prepass": ("frn_tpu_torch/csrc/flash_attention_int8.cu",
                        "frn_tpu/ops/flash_attention.py:728"),
    "int8_prepass": ("frn_tpu_torch/csrc/flash_attention_int8.cu",
                     "frn_tpu/ops/flash_attention.py:728"),
    "stem": ("frn_tpu_torch/csrc/stem.cu", "frn_tpu/ops/stem.py:71"),
}
TRAIN_KERNELS = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_F32_KERNELS = ("flash_fwd_lse_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
# the path's wgmma instances of each source, as (kernel, its first template
# arguments): the forward at d 32 and 64, with and without exp_bf16; the dQ
# and dK/dV kernels at d 32 and 64; the int8 forward at d 32 and 64 in modes
# int8_qk (0) and int8 (1); the stem at C 3 and 5; and the f32 kernels (CUDA
# cores): the forward's, the dQ and the dK/dV kernels' register-blocked
# kernels at d 32 and 64 and their first designs at d 8 and 16 (the f32 train
# CLI takes them at depths 18 and 34). Phase 1 fails unless each is in the
# compiler's log once, unspilled
PATH_INSTANCES = {
    "flash_attention": [("flash_fwd_wgmma", d, e) for d in (32, 64) for e in (0, 1)],
    "flash_attention_bwd": [(kernel, d) for kernel in ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
                            for d in (32, 64)],
    "flash_attention_int8": [("flash_int8_wgmma", d, f) for d in (32, 64) for f in (0, 1)],
    "stem": [("stem_wgmma", c) for c in (3, 5)],
    "flash_attention_f32": [("flash_fwd_f32", 8), ("flash_fwd_f32", 16),
                            ("flash_fwd_f32_tiled", 32), ("flash_fwd_f32_tiled", 64)],
    "flash_attention_bwd_f32": [(f"flash_bwd_{part}_f32{tiled}", d) for part in ("dq", "dkv")
                                for d, tiled in ((8, ""), (16, ""), (32, "_tiled"), (64, "_tiled"))],
}
OPTIN_KERNELS = ("flash_fwd_bf16exp", "flash_int8_qk", "flash_int8", "int8_qk_prepass",
                 "int8_prepass", "stem")
# the work of one launch: bytes per element of a (B, N, d) tensor and per
# (B, N) row (each input read once, each output written once: bf16 Q, K, V,
# dO, O, dQ, dK, dV; f32 lse and D), and bf16 matrix flops and int8 matrix
# ops per B*N^2*d. The int8 rows are the wrapper's function: bf16 Q, K, V in
# (its quantization pre-pass included), bf16 O out
KERNEL_WORK = {"flash_fwd": (8, 0, 4, 0), "flash_fwd_lse": (8, 4, 4, 0),
               "flash_bwd_dq": (10, 8, 6, 0), "flash_bwd_dkv": (12, 8, 8, 0),
               "flash_fwd_bf16exp": (8, 0, 4, 0), "flash_int8_qk": (8, 0, 2, 2),
               "flash_int8": (8, 0, 0, 4)}
# the opt-in path (phase 6): configuration, ModelConfig fields, launches per
# batch of each kernel (every other kernel of the port: none)
OPTIN_CONFIGS = (
    ("stem kernel + bf16-exp", {"stem_kernel": True, "flash_exp_bf16": True},
     {"stem": 2, "flash_fwd_bf16exp": 4}),
    ("int8_qk", {"attention_quant": "int8_qk"}, {"flash_int8_qk": 4, "int8_qk_prepass": 4}),
    ("int8 + fused attention", {"attention_quant": "int8", "fused_attention": True},
     {"flash_int8": 2, "int8_prepass": 2}),
)
# stem kernel vs plain (bf16 out): both sum f32 products, in another order,
# and round once, so an output can land one bf16 ulp (relative 2^-8 to
# 2^-7) apart
STEM_ATOL, STEM_RTOL = 1e-2, 1e-2
# a stem launch takes about 0.1 ms, and single timings of 10 or 50 of them
# moved by up to 80% between two turns of one source: each stem timing is the
# median of 9 timings of 10 launches
STEM_WINDOWS = 9
# the stem at DSEC and DDD17 sizes, B 2, C 3 (RGB) and 5 (event voxels); a
# tiny image (3 output rows, W/2 = 5: one ragged tile), and W/2 = 131 (a
# ragged third 64-pixel tile) over 3 images of 17 output rows
STEM_CHECK_SHAPES = ((2, 480, 640, 3), (2, 480, 640, 5), (2, 260, 346, 3), (2, 260, 346, 5),
                     (1, 6, 10, 3), (3, 34, 262, 5))


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2, windows: int = 1):
    """(ms per call of ``fn`` over ``reps`` calls after ``warmup``, the last
    call's result); with ``windows`` > 1, the median of that many such
    timings."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), out


def device_ms(fn, kernel_names, reps: int = 10) -> float:
    """Device time per call of ``fn`` summed over the kernels whose names
    contain one of ``kernel_names``, by torch.profiler over ``reps`` calls
    after one warm-up: a kernel whose launches are shorter than the host's
    time to enqueue them shows its own time here, not the host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and any(k in ev.key for k in kernel_names))
    return total / 1e3 / reps


def _shape_text(shape) -> str:
    keys = "B N d" if len(shape) == 3 else "B H W C"
    return " ".join(f"{k}={v}" for k, v in zip(keys.split(), shape))


def check_close(kind: str, name: str, got, want, atol: float, rtol: float, shape, errs: dict) -> None:
    """Fails unless ``got`` (a kernel's output) is finite and within atol +
    rtol * |want| of ``want`` (its plain version's) everywhere; records the
    largest error of ``kind`` in ``errs``. ``shape``: (B, N, d) or (B, H, W, C)."""
    at = _shape_text(shape)
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    print(f"{kind} {name} vs plain {at}: max_abs_err {err.max().item():.3e} "
          f"(max|ref| {want.float().abs().max().item():.3e}), {int(bad.sum())} outside "
          f"atol {atol:.3e} rtol {rtol}", flush=True)
    if not torch.isfinite(got.float()).all() or bad.any():
        fail(f"{kind} ({name}) disagrees with its plain version at {at}")
    errs[kind] = max(errs.get(kind, 0.0), err.max().item())


def check_mean_lse(kind: str, lse, lse_ref, shape) -> None:
    """Fails unless B1-lse's mean |lse gap| to the plain version is within
    MEAN_LSE_ATOL (the denominator's check: see MEAN_LSE_ATOL)."""
    gap = (lse - lse_ref).abs().mean().item()
    print(f"{kind} lse vs plain {_shape_text(shape)}: mean |gap| {gap:.3e} (at most "
          f"{MEAN_LSE_ATOL:.1e})", flush=True)
    if not gap <= MEAN_LSE_ATOL:
        fail(f"{kind}: mean |lse gap| {gap:.3e} to the plain version at {_shape_text(shape)}")


def check_backward(shape, dq, dkv, dq_ref, dkv_ref, errs: dict) -> None:
    """The dQ and dK/dV kernels' outputs against their plain versions': atol
    a share of each output's max |value|."""
    for kind, name, got, want in (("flash_bwd_dq", "dq", dq, dq_ref),
                                  ("flash_bwd_dkv", "dk", dkv[0], dkv_ref[0]),
                                  ("flash_bwd_dkv", "dv", dkv[1], dkv_ref[1])):
        check_close(kind, name, got, want, BWD_ATOL * want.float().abs().max().item(), BWD_RTOL,
                    shape, errs)


def kernel_bound(kind: str, b: int, n: int, d: int):
    """(bytes time, operations time) of one launch, in seconds: its bytes over
    the memory rate; the larger of its matrix operations over the tensor
    cores' rates (bf16 and int8 terms added) and its B*N^2 exponentials over
    the exp rate. The bound is the larger of the two."""
    elems, rows, flops, int8_ops = KERNEL_WORK[kind]
    mma = (flops / BF16_FLOP_PER_S + int8_ops / INT8_OP_PER_S) * b * n * n * d
    return ((elems * b * n * d + rows * b * n) / HBM_BYTES_PER_S, max(mma, b * n * n / EXP_PER_S))


# the work of one f32 launch: bytes per element of a (B, N, d) tensor and
# per (B, N) row (each input read once, each output written once: f32 Q, K,
# V, dO, O, dQ, dK, dV; f32 lse and D), and f32 flops per B*N^2*d (the
# forward's two products; the dQ kernel's three; the dK/dV kernel's four)
F32_WORK = {"flash_fwd_f32": (16, 0, 4), "flash_fwd_lse_f32": (16, 4, 4),
            "flash_bwd_dq_f32": (20, 8, 6), "flash_bwd_dkv_f32": (24, 8, 8)}


def f32_bound(b: int, n: int, d: int, kind: str = "flash_fwd_f32"):
    """(bytes time, operations time) of one f32 launch of ``kind``: its
    bytes (F32_WORK) over the memory rate, its flops at the CUDA cores' f32
    rate."""
    elems, rows, flops = F32_WORK[kind]
    return ((elems * b * n * d + rows * b * n) / HBM_BYTES_PER_S,
            flops * b * n * n * d / F32_FLOP_PER_S)


def prepass_bound(mode: str, b: int, n: int, d: int):
    """(bytes time, operations time) of one int8 pre-pass: bf16 q, k (and in
    mode 'int8' v) read once; int8 qi, ki (and V^T, padded to whole 64-key
    tiles) and the f32 scales written once. Its operations are not counted
    (a max and a multiply per element, far under the bytes)."""
    n_pad = -(-n // 64) * 64
    if mode == "int8_qk":
        nbytes = 2 * (2 + 1) * b * n * d + 4 * b
    else:
        nbytes = 3 * 2 * b * n * d + 2 * b * n * d + b * d * n_pad + 2 * 4 * b
    return nbytes / HBM_BYTES_PER_S, 0.0


def check_prepass(label: str, got, want, shape) -> None:
    """The pre-pass kernel's outputs (qi, ki, V as the kernel takes it, c, sv)
    bitwise against ``int8_kernel_inputs``'s."""
    for name, g, w in zip(("qi", "ki", "v", "c", "sv"), got, want):
        same = (g is None and w is None) or (
            g is not None and w is not None and g.dtype == w.dtype and g.shape == w.shape
            and torch.equal(g, w))
        if not same:
            fail(f"{label} {name} differs from int8_kernel_inputs at {_shape_text(shape)}")
    print(f"{label} vs int8_kernel_inputs {_shape_text(shape)}: qi, ki, V, c, sv bitwise equal",
          flush=True)


def stem_bound(b: int, h: int, w: int, c: int):
    """(bytes time, operations time) of one stem launch: bf16 x, weights and
    output, f32 scale and bias, each once; 2 * 49 * C flops per output at the
    bf16 rate (its inputs are bf16)."""
    outputs = b * (h // 2) * (w // 2) * 64
    nbytes = 2 * b * h * w * c + 2 * 49 * c * 64 + 2 * 4 * 64 + 2 * outputs
    return nbytes / HBM_BYTES_PER_S, 2 * 49 * c * outputs / BF16_FLOP_PER_S


class KernelTimes:
    """One kernel's timings at its path's shapes, summed over its launches
    per forward or micro-step (``count`` at each shape: two directions at
    each flash shape), with the bound of that sum, as a row of the kernels
    line."""

    def __init__(self, kind: str):
        self.kind, self.per_shape, self.launches_per = kind, [], 0
        self.totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
        self.t_bytes = self.t_ops = 0.0

    def add(self, shape: dict, bound, kernel, plain, library_ms, count: int = 2, extra=None,
            windows: int = 1):
        """Times ``kernel`` (10 calls; the median of ``windows`` such timings)
        and ``plain``; returns their last outputs. ``bound``: (bytes time,
        operations time) of one launch; ``library_ms`` None where no PyTorch
        call computes the same function; ``extra``: more times (ms) of this
        shape, summed like the others."""
        t_bytes, t_ops = bound
        ms, out = cuda_ms(kernel, reps=10, windows=windows)
        plain_ms, plain_out = cuda_ms(plain, reps=2, warmup=1)
        row = {**shape, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               **(extra or {}), "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "count": count}
        print(f"{self.kind} timing {json.dumps(row)}", flush=True)
        self.per_shape.append(row)
        for key in ("ms", "plain_ms", "library_ms", *(extra or {})):
            total = self.totals.get(key, 0.0)
            self.totals[key] = None if total is None or row[key] is None else total + count * row[key]
        self.launches_per += count
        self.t_bytes += count * t_bytes
        self.t_ops += count * t_ops
        return out, plain_out

    def row(self, max_abs_err: float, per: str) -> dict:
        bound_ms = max(self.t_bytes, self.t_ops) * 1e3
        bound_by = "bytes" if self.t_bytes >= self.t_ops else "operations"
        others = ", ".join(f"{k} {v:.3f} ms" if v is not None else f"{k} none"
                           for k, v in self.totals.items() if k != "ms")
        print(f"{self.kind} per {per} ({self.launches_per} launches): kernel "
              f"{self.totals['ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), {others}",
              flush=True)
        source, replaces = KERNEL_SOURCES[self.kind]
        return {"name": self.kind, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": max_abs_err, **self.totals,
                "bound_ms": bound_ms, "bound_by": bound_by, "per_shape": self.per_shape}


def card_name_and_power_limit() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip()


def phase_environment():
    print(card_name_and_power_limit(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    # every phase compares f32 work on the card with the CPU or a plain
    # version at f32 tolerances, so no phase may run its products in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul off, cudnn off", flush=True)

    from frn_tpu_torch import build

    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {len(built)} kernel sources", flush=True)
    for name, (path, seconds, log) in built.items():
        print(f"  {name}: {seconds:.1f} s -> {path.name}", flush=True)
        if name not in PATH_INSTANCES:
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    {line.strip()}", flush=True)
            continue
        for line in log.splitlines():  # warnings, and ptxas's notes of serialized wgmma
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"    {line.strip()}", flush=True)
        check_path_instances(name, log)



def check_path_instances(name: str, log: str) -> None:
    """Prints every kernel instance of ``name``'s compiler log with its
    registers and spills; fails unless each of PATH_INSTANCES[name] is there
    exactly once and none of them spills."""
    found = {key: [] for key in PATH_INSTANCES[name]}
    for (kernel, *targs), (regs, stores, loads) in kernel_instances(log).items():
        label = f"{kernel}<{', '.join(map(str, targs))}>"
        print(f"    {label}: {regs} registers, {stores} bytes spill stores, {loads} bytes spill "
              f"loads", flush=True)
        for key in found:
            if (kernel, *targs[:len(key) - 1]) == key:
                found[key].append((label, stores + loads))
    missing = [key for key, hits in found.items() if len(hits) != 1]
    if missing:
        fail(f"the compiler's log of {name} has not one path instance of {missing}")
    spilled = [label for hits in found.values() for label, spill in hits if spill]
    if spilled:
        fail(f"the path's instances spill registers: {spilled}")


def kernel_instances(log: str) -> dict:
    """{(kernel, template arguments...): (registers, spill store bytes, spill
    load bytes)} of every flash or stem kernel instance in an nvcc -Xptxas -v log
    (template arguments from the mangled name: ints, and bools as 0 or 1)."""
    import re

    out, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv|int8)_(?:mma|wgmma)"
                          r"|flash_(?:fwd|bwd_dq|bwd_dkv)_f32(?:_tiled)?|stem_wgmma)"
                          r"I((?:L[ib]\d+E)+)E", entry.group(1))
            current = None if m is None else (
                m.group(1), *(int(x) for x in re.findall(r"L[ib](\d+)E", m.group(2))))
            if current is not None:
                out[current] = [0, 0, 0]
        elif current is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                out[current][1:] = [int(spill.group(1)), int(spill.group(2))]
            if regs:
                out[current][0] = int(regs.group(1))
    return {key: tuple(v) for key, v in out.items()}


def phase_flash_kernel():
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, n, d):
        return [torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3)]

    errs = {}
    for shape in BWD_CHECK_SHAPES:
        q, k, v = qkv(*shape)
        check_close("flash_fwd", "o", fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v),
                    FLASH_ATOL, FLASH_RTOL, shape, errs)

    # per main-path forward at batch 16, and the outputs of the timed runs
    # held against each other at that batch
    times = KernelTimes("flash_fwd")
    for n, d in FLASH_SHAPES:
        q, k, v = qkv(MAIN_BATCH, n, d)
        q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
        lib_ms, _ = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), reps=10)
        out, ref = times.add({"B": MAIN_BATCH, "N": n, "d": d},
                             kernel_bound("flash_fwd", MAIN_BATCH, n, d),
                             lambda: fa.flash_attention(q, k, v),
                             lambda: fa.flash_attention_plain(q, k, v), lib_ms)
        check_close("flash_fwd", "o", out, ref, FLASH_ATOL, FLASH_RTOL, q.shape, errs)
    return times.row(errs["flash_fwd"], "forward")


def phase_flash_f32():
    """The f32 forward (B1 at f32, the evaluation path's default) against its
    plain version at every check shape (BWD_CHECK_SHAPES: the paths' shapes,
    ragged N, d 8 and 16, the block edges), then timed at the eval batch
    EVAL_BATCH per DSEC eval batch (two launches at each of FLASH_SHAPES)
    beside its bound and SDPA at f32; DDD17's stage 1 (N 5,655, two launches)
    timed and printed beside it."""
    import torch.nn.functional as F

    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)

    def qkv(b, n, d):
        return [torch.randn((b, n, d), generator=gen, device="cuda") for _ in range(3)]

    errs = {}
    for shape in BWD_CHECK_SHAPES:
        q, k, v = qkv(*shape)
        check_close("flash_fwd_f32", "o", fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v),
                    FLASH_F32_ATOL, FLASH_F32_RTOL, shape, errs)

    times = KernelTimes("flash_fwd_f32")
    for n, d in FLASH_SHAPES:
        q, k, v = qkv(EVAL_BATCH, n, d)
        q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
        lib_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), reps=10)
        out, ref = times.add({"B": EVAL_BATCH, "N": n, "d": d,
                              "blocks": fa.f32_launch_plan(EVAL_BATCH, n, d)["blocks"]},
                             f32_bound(EVAL_BATCH, n, d),
                             lambda: fa.flash_attention(q, k, v),
                             lambda: fa.flash_attention_plain(q, k, v), lib_ms)
        check_close("flash_fwd_f32", "o", out, ref, FLASH_F32_ATOL, FLASH_F32_RTOL, q.shape, errs)
        del out, ref
    q, k, v = qkv(EVAL_BATCH, *DDD17_FLASH_SHAPE)
    q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
    ms, out = cuda_ms(lambda: fa.flash_attention(q, k, v), reps=10)
    lib_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), reps=10)
    check_close("flash_fwd_f32", "o", out, fa.flash_attention_plain(q, k, v), FLASH_F32_ATOL,
                FLASH_F32_RTOL, q.shape, errs)
    bound = max(f32_bound(EVAL_BATCH, *DDD17_FLASH_SHAPE)) * 1e3
    blocks = fa.f32_launch_plan(EVAL_BATCH, *DDD17_FLASH_SHAPE)["blocks"]
    print(f"flash_fwd_f32 per DDD17 eval batch (B {EVAL_BATCH}, N {DDD17_FLASH_SHAPE[0]}, d "
          f"{DDD17_FLASH_SHAPE[1]}, 2 launches of {blocks} blocks): kernel {2 * ms:.3f} ms, "
          f"bound {2 * bound:.3f} ms, "
          f"SDPA f32 {2 * lib_ms:.3f} ms", flush=True)
    return times.row(errs["flash_fwd_f32"], "DSEC eval batch")


def phase_flash_backward():
    """The forward with lse and both backward kernels against their plain
    versions at every listed shape (the paths' shapes and the kernels' block
    edges, ragged N and d 8 and 16 included), then each timed at batch
    TRAIN_BATCH at the training path's two shapes, where the timed runs'
    outputs are held against each other too."""
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(b, n, d):
        return torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)

    errs = {}
    for shape in BWD_CHECK_SHAPES:
        q, k, v, do = (randn(*shape) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, return_lse=True)
        check_close("flash_fwd_lse", "o", o, o_ref, FLASH_ATOL, FLASH_RTOL, shape, errs)
        check_close("flash_fwd_lse", "lse", lse, lse_ref, LSE_ATOL, 0.0, shape, errs)
        check_mean_lse("flash_fwd_lse", lse, lse_ref, shape)
        # both backward versions get the same lse and D, from the plain forward
        delta = fa.attention_delta(o_ref, do)
        check_backward(shape, fa.flash_bwd_dq(q, k, v, do, lse_ref, delta),
                       fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta),
                       fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta),
                       fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta), errs)

    # per training micro-step at batch TRAIN_BATCH; the library yardstick is
    # SDPA's forward, and its autograd backward (dQ, dK and dV together)
    times = {kind: KernelTimes(kind) for kind in TRAIN_KERNELS}
    for n, d in FLASH_SHAPES:
        q, k, v, do = (randn(TRAIN_BATCH, n, d) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        delta = fa.attention_delta(o, do)
        q4, k4, v4, do4 = (x.unsqueeze(1).detach().requires_grad_() for x in (q, k, v, do))
        with torch.enable_grad():
            lib_out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        lib_fwd_ms, _ = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), reps=10)
        lib_bwd_ms, _ = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (q4, k4, v4), do4, retain_graph=True), reps=10)
        del lib_out
        shape = {"B": TRAIN_BATCH, "N": n, "d": d}
        (o_k, lse_k), (o_p, lse_p) = times["flash_fwd_lse"].add(
            shape, kernel_bound("flash_fwd_lse", TRAIN_BATCH, n, d),
            lambda: fa.flash_attention(q, k, v, return_lse=True),
            lambda: fa.flash_attention_plain(q, k, v, return_lse=True), lib_fwd_ms)
        check_close("flash_fwd_lse", "o", o_k, o_p, FLASH_ATOL, FLASH_RTOL, q.shape, errs)
        check_close("flash_fwd_lse", "lse", lse_k, lse_p, LSE_ATOL, 0.0, q.shape, errs)
        check_mean_lse("flash_fwd_lse", lse_k, lse_p, q.shape)
        del o_k, o_p, lse_k, lse_p
        dq, dq_ref = times["flash_bwd_dq"].add(
            shape, kernel_bound("flash_bwd_dq", TRAIN_BATCH, n, d),
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta), lib_bwd_ms)
        dkv, dkv_ref = times["flash_bwd_dkv"].add(
            shape, kernel_bound("flash_bwd_dkv", TRAIN_BATCH, n, d),
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta), lib_bwd_ms)
        check_backward(q.shape, dq, dkv, dq_ref, dkv_ref, errs)
    out = {kind: t.row(errs[kind], "micro-step") for kind, t in times.items()}
    total = sum(r["bound_ms"] for r in out.values())
    print(f"flash bound per training micro-step (forward with lse + both backward kernels, "
          f"4 launches each): {total:.3f} ms", flush=True)
    return out


def _shift_scores(q, k):
    """q, k scaled by 0.5 with s = q k^T moved far below zero (column 0: 11
    and -11, so s = -121 + O(1)): lse < -88, where exp(-lse) overflows."""
    q, k = q * 0.5, k * 0.5
    q[..., 0], k[..., 0] = 11.0, -11.0
    return q, k


def phase_flash_train_f32():
    """The f32 training kernels (B1-lse, B2a, B2b at f32) against their plain
    versions at every F32_TRAIN_CHECK_SHAPES shape and, with lse < -88, at
    F32_LSE_TRAP_SHAPES; then each timed (CUDA events) per DSEC micro-step at
    the train CLI's batch 2 (two launches at each of FLASH_SHAPES) beside its
    bound, its plain version and SDPA at f32 (its forward for B1-lse, its
    autograd backward for B2), with each launch's block count; DDD17's stage
    1 (B 4, N 5,655) timed and printed beside it (blocks: ``f32_launch_plan``,
    ``f32_bwd_launch_plan``)."""
    import torch.nn.functional as F

    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(20)

    def randn(b, n, d):
        return torch.randn((b, n, d), generator=gen, device="cuda")

    def check_all(label, shape, q, k, v, do, errs, bwd_atol=BWD_F32_ATOL):
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, return_lse=True)
        check_close("flash_fwd_lse_f32", f"o{label}", o, o_ref, FLASH_F32_ATOL, FLASH_F32_RTOL, shape,
                    errs)
        check_close("flash_fwd_lse_f32", f"lse{label}", lse, lse_ref, LSE_F32_ATOL, 0.0, shape, errs)
        # both backward versions get the same lse and D, from the plain forward
        delta = fa.attention_delta(o_ref, do)
        for kind, name, got, want in (
                ("flash_bwd_dq_f32", "dq", fa.flash_bwd_dq(q, k, v, do, lse_ref, delta),
                 fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta)),
                *zip(("flash_bwd_dkv_f32",) * 2, ("dk", "dv"),
                     fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta),
                     fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta))):
            check_close(kind, f"{name}{label}", got, want,
                        bwd_atol * want.abs().max().item(), BWD_F32_RTOL, shape, errs)
        return lse_ref

    errs = {}
    for shape in F32_TRAIN_CHECK_SHAPES:
        check_all("", shape, *(randn(*shape) for _ in range(4)), errs)
    for shape in F32_LSE_TRAP_SHAPES:
        q, k = _shift_scores(randn(*shape), randn(*shape))
        lse = check_all(" (lse < -88)", shape, q, k, randn(*shape), randn(*shape), errs,
                        F32_TRAP_ATOL)
        if not lse.max().item() < -88:
            fail(f"the shifted scores left lse at {lse.max().item():.1f} at {_shape_text(shape)}")

    # per DSEC micro-step at the train CLI's batch
    b = F32_TRAIN_BATCH
    times = {kind: KernelTimes(kind) for kind in TRAIN_F32_KERNELS}
    for n, d in FLASH_SHAPES:
        q, k, v, do = (randn(b, n, d) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        delta = fa.attention_delta(o, do)
        q4, k4, v4, do4 = (x.unsqueeze(1).detach().requires_grad_() for x in (q, k, v, do))
        with torch.enable_grad():
            lib_out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        lib_fwd_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0),
                                reps=10)
        lib_bwd_ms, _ = cuda_ms(lambda: torch.autograd.grad(lib_out, (q4, k4, v4), do4,
                                                            retain_graph=True), reps=10)
        del lib_out
        fwd_shape = {"B": b, "N": n, "d": d, "blocks": fa.f32_launch_plan(b, n, d)["blocks"]}
        dq_shape, dkv_shape = ({"B": b, "N": n, "d": d,
                                "blocks": fa.f32_bwd_launch_plan(b, n, d, kind)["blocks"]}
                               for kind in ("dq", "dkv"))
        (o_k, lse_k), (o_p, lse_p) = times["flash_fwd_lse_f32"].add(
            fwd_shape, f32_bound(b, n, d, "flash_fwd_lse_f32"),
            lambda: fa.flash_attention(q, k, v, return_lse=True),
            lambda: fa.flash_attention_plain(q, k, v, return_lse=True), lib_fwd_ms)
        check_close("flash_fwd_lse_f32", "o", o_k, o_p, FLASH_F32_ATOL, FLASH_F32_RTOL, q.shape, errs)
        check_close("flash_fwd_lse_f32", "lse", lse_k, lse_p, LSE_F32_ATOL, 0.0, q.shape, errs)
        del o_k, o_p, lse_k, lse_p
        dq, dq_ref = times["flash_bwd_dq_f32"].add(
            dq_shape, f32_bound(b, n, d, "flash_bwd_dq_f32"),
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta), lib_bwd_ms)
        dkv, dkv_ref = times["flash_bwd_dkv_f32"].add(
            dkv_shape, f32_bound(b, n, d, "flash_bwd_dkv_f32"),
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta), lib_bwd_ms)
        for kind, name, got, want in (("flash_bwd_dq_f32", "dq", dq, dq_ref),
                                      ("flash_bwd_dkv_f32", "dk", dkv[0], dkv_ref[0]),
                                      ("flash_bwd_dkv_f32", "dv", dkv[1], dkv_ref[1])):
            check_close(kind, name, got, want, BWD_F32_ATOL * want.abs().max().item(),
                        BWD_F32_RTOL, q.shape, errs)
        del dq, dq_ref, dkv, dkv_ref

    # DDD17's one flash stage at the train_ddd17 CLI's batch, per launch
    b, (n, d) = DDD17_TRAIN_BATCH, DDD17_FLASH_SHAPE
    q, k, v, do = (randn(b, n, d) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    delta = fa.attention_delta(o, do)
    q4, k4, v4, do4 = (x.unsqueeze(1).detach().requires_grad_() for x in (q, k, v, do))
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
    lib = {"flash_fwd_lse_f32": cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, scale=1.0), reps=10)[0]}
    lib["flash_bwd_dq_f32"] = lib["flash_bwd_dkv_f32"] = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (q4, k4, v4), do4, retain_graph=True), reps=10)[0]
    calls = {"flash_fwd_lse_f32": lambda: fa.flash_attention(q, k, v, return_lse=True),
             "flash_bwd_dq_f32": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
             "flash_bwd_dkv_f32": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta)}
    for kind, call in calls.items():
        ms, _ = cuda_ms(call, reps=10)
        blocks = (fa.f32_launch_plan(b, n, d)["blocks"] if kind == "flash_fwd_lse_f32"
                  else fa.f32_bwd_launch_plan(b, n, d, kind.split("_")[2])["blocks"])
        print(f"{kind} per launch at DDD17 (B {b}, N {n}, d {d}, {blocks} blocks): kernel "
              f"{ms:.3f} ms, bound {max(f32_bound(b, n, d, kind)) * 1e3:.3f} ms, SDPA f32 "
              f"{'forward' if kind == 'flash_fwd_lse_f32' else 'backward'} {lib[kind]:.3f} ms",
              flush=True)
    del lib_out
    out = {kind: t.row(errs[kind], "DSEC f32 micro-step") for kind, t in times.items()}
    total = sum(r["bound_ms"] for r in out.values())
    print(f"f32 flash bound per DSEC f32 training micro-step (B {F32_TRAIN_BATCH}; the forward with "
          f"lse and both backward kernels, 4 launches each): {total:.3f} ms", flush=True)
    return out


def build_others(sources):
    """Builds other revisions' ``flash_attention.cu``,
    ``flash_attention_bwd.cu``, ``flash_attention_int8.cu``, ``stem.cu``,
    ``flash_attention_f32.cu`` or ``flash_attention_bwd_f32.cu``
    (told apart by file name, each with the headers beside it) by the port's
    nvcc flags into
    the build directory, in parallel; returns {source: the loaded library,
    its entry points bound as this revision's wrappers bind them}."""
    import ctypes

    from frn_tpu_torch import build
    from frn_tpu_torch.ops import flash_attention as fa
    from frn_tpu_torch.ops import stem

    binders = {"flash_attention.cu": fa.bind_forward, "flash_attention_bwd.cu": fa.bind_backward,
               "flash_attention_int8.cu": fa.bind_int8, "stem.cu": stem.bind_stem,
               "flash_attention_f32.cu": fa.bind_f32,
               "flash_attention_bwd_f32.cu": lambda lib: fa.bind_backward(lib, "f32")}
    for src in sources:
        if Path(src).name not in binders:
            fail(f"--other-source takes a flash_attention.cu, flash_attention_bwd.cu, "
                 f"flash_attention_int8.cu, stem.cu, flash_attention_f32.cu or "
                 f"flash_attention_bwd_f32.cu, not {src}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for i, src in enumerate(sources):
        out = build.BUILD_DIR / f"other{i}_{Path(src).stem}.so"
        procs[src] = (out, subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    logs = {src: proc.communicate(timeout=900)[0] for src, (_, proc) in procs.items()}
    libs = {}
    for src, (out, proc) in procs.items():
        if proc.returncode != 0:
            fail(f"{src} did not build:\n{logs[src]}")
        for (kernel, *targs), (regs, stores, loads) in kernel_instances(logs[src]).items():
            print(f"  {src}: {kernel}<{', '.join(map(str, targs))}>: {regs} registers, "
                  f"{stores} bytes spill stores, {loads} bytes spill loads", flush=True)
        for line in logs[src].splitlines():  # ptxas's notes of serialized wgmma
            if "Performance Loss" in line:
                print(f"  {src}: {line.strip()}", flush=True)
        libs[src] = binders[Path(src).name](ctypes.CDLL(str(out)))
    print(f"other revisions built in {time.perf_counter() - t0:.1f} s: {list(sources)}", flush=True)
    return libs


def other_forward(lib, q, k, v, exp_bf16: bool = False, return_lse: bool = False):
    """The forward of a ``build_others`` library, called as its wrapper
    calls it (the f32 forward's for f32 q): o, or (o, lse). Uncounted: it
    serves the A/B, never a path."""
    from frn_tpu_torch.ops import flash_attention as fa

    b, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device) if return_lse else None
    if exp_bf16:
        fa._launch(lib.frn_flash_fwd_bf16exp_bf16, q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   o.data_ptr(), b, n, d)
    else:
        fn = lib.frn_flash_fwd_f32 if q.dtype == torch.float32 else lib.frn_flash_fwd_bf16
        fa._launch(fn, q, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   None if lse is None else lse.data_ptr(), b, n, d)
    return (o, lse) if return_lse else o


def other_backward(lib, kind: str, q, k, v, do, lse, delta):
    """dQ (kind 'flash_bwd_dq' or 'flash_bwd_dq_f32') or (dK, dV) of a
    ``build_others`` backward library, called as this revision's wrappers call
    it (its f32 entry points for f32 q). Uncounted, as ``other_forward``."""
    from frn_tpu_torch.ops import flash_attention as fa

    b, n, d = q.shape
    dtype = "f32" if q.dtype == torch.float32 else "bf16"
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    if kind.startswith("flash_bwd_dq"):
        dq = torch.empty_like(q)
        fa._launch(getattr(lib, f"frn_flash_bwd_dq_{dtype}"), q, *ins, dq.data_ptr(), b, n, d)
        return dq
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa._launch(getattr(lib, f"frn_flash_bwd_dkv_{dtype}"), q, *ins, dk.data_ptr(), dv.data_ptr(),
               b, n, d)
    return dk, dv


def other_int8(lib, q, inputs, mode: str):
    """The int8 kernel of a ``build_others`` library (or of this revision's)
    on the inputs ``int8_kernel_inputs`` gives, called as the wrappers call
    it. Uncounted, as ``other_forward``."""
    from frn_tpu_torch.ops import flash_attention as fa

    qi, ki, vk, scale, v_scale = inputs
    b, n, d = q.shape
    full = mode == "int8"
    o = torch.empty_like(q)
    fa._launch(lib.frn_flash_int8, q, qi.data_ptr(), ki.data_ptr(), vk.data_ptr(), scale.data_ptr(),
               None if v_scale is None else v_scale.data_ptr(), o.data_ptr(), b, n,
               vk.shape[2] if full else n, d, int(full))
    return o


def other_stem(src, lib, x, w, scale, bias):
    """The stem of a ``build_others`` library built from ``src``, called as
    its wrapper calls it: torch's (F, C, 7, 7) weights, or (7, 7, C, F) where
    its source says so (the revisions before the implicit GEMM). Uncounted,
    as ``other_forward``."""
    from frn_tpu_torch.ops import flash_attention as fa
    from frn_tpu_torch.ops import stem

    b, c, h, wd = x.shape
    hwcf = "w: bf16 (7, 7, C, 64)" in Path(src).read_text()
    wk = w.permute(2, 3, 1, 0).contiguous() if hwcf else w.contiguous()
    out = torch.empty((b, h // 2, wd // 2, stem.STEM_FILTERS), dtype=x.dtype, device=x.device)
    fa._launch(lib.frn_stem_conv_bn_relu, x, x.permute(0, 2, 3, 1).data_ptr(), wk.data_ptr(),
               scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, wd, c)
    return out.permute(0, 3, 1, 2)


def time_in_turns(kind: str, shape: dict, runs: dict, check, per_step: dict,
                  count: int = 2, windows: int = 1) -> None:
    """Times ``runs`` ({source or 'this': fn}) in turns: the others, this
    revision, this revision, the others reversed, 10 calls each (CUDA events;
    the median of ``windows`` such timings); ``check(label, out)`` holds each
    timed output against the plain
    version. Prints the row and adds ``count`` launches' mean (two: one per
    direction) to ``per_step[kind, name]``."""
    others = [name for name in runs if name != "this"]
    turns = {name: [] for name in runs}
    for name in others + ["this", "this"] + others[::-1]:
        ms, out = cuda_ms(runs[name], reps=10, windows=windows)
        turns[name].append(ms)
        check(f"{kind} {'this revision' if name == 'this' else name}", out)
        del out
    row = {"kind": kind, **shape, **{name: statistics.mean(ts) for name, ts in turns.items()},
           "turns": turns}
    print(f"revisions timing {json.dumps(row)}", flush=True)
    for name, ts in turns.items():
        ms, launches = per_step.get((kind, name), (0.0, 0))
        per_step[kind, name] = (ms + count * statistics.mean(ts), launches + count)


def print_per_step(per_step: dict) -> None:
    for (kind, name), (ms, launches) in per_step.items():
        per = "micro-step" if kind.split()[0] in TRAIN_KERNELS + TRAIN_F32_KERNELS else "batch"
        print(f"revisions: {kind} {'this revision' if name == 'this' else name}: {ms:.3f} ms per "
              f"{per} ({launches} launches)", flush=True)


def phase_other_forwards(others: dict) -> None:
    """This revision's forward entry points (B1, B1 with lse, B3) timed in
    turns with other revisions' (``build_others``) at the path's shapes and
    batches (B1 and B3 at MAIN_BATCH, B1-lse at TRAIN_BATCH). Each timed
    output is held against the plain version, B1-lse's lse only for this
    revision: of every revision's, the largest and the mean |lse gap| and
    the share of bf16 outputs that differ at all are printed (a revision
    that sums the f32 p into the denominator shows here)."""
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    kinds = {"flash_fwd": (False, False, MAIN_BATCH), "flash_fwd_lse": (False, True, TRAIN_BATCH),
             "flash_fwd_bf16exp": (True, False, MAIN_BATCH)}
    errs, per_step = {}, {}
    for kind, (exp_bf16, with_lse, batch) in kinds.items():
        for n, d in FLASH_SHAPES:
            q, k, v = (torch.randn((batch, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            if exp_bf16:
                this = lambda: fa.flash_attention_bf16exp(q, k, v)
                want = fa.flash_attention_bf16exp_plain(q, k, v)
            else:
                this = lambda: fa.flash_attention(q, k, v, return_lse=with_lse)
                want = fa.flash_attention_plain(q, k, v, return_lse=with_lse)
            runs = {src: (lambda lib=lib: other_forward(lib, q, k, v, exp_bf16, with_lse))
                    for src, lib in others.items()}
            runs["this"] = this

            def check(label, out):
                o = out[0] if with_lse else out
                check_close(label, "o", o, want[0] if with_lse else want, FLASH_ATOL, FLASH_RTOL,
                            q.shape, errs)
                if not with_lse:
                    return
                gap = (out[1] - want[1]).abs()
                share = (out[0] != want[0]).float().mean().item()
                print(f"denominator {label} {_shape_text(q.shape)}: lse max |gap| "
                      f"{gap.max().item():.3e} ({int((gap > LSE_ATOL).sum())} rows over "
                      f"{LSE_ATOL:.0e}), mean |gap| {gap.mean().item():.3e}; {share:.4%} of "
                      f"the bf16 outputs differ from the plain version", flush=True)
                if label.endswith("this revision"):  # another revision's lse is reported
                    check_close(label, "lse", out[1], want[1], LSE_ATOL, 0.0, q.shape, errs)
                    check_mean_lse(label, out[1], want[1], q.shape)

            time_in_turns(kind, {"B": batch, "N": n, "d": d}, runs, check, per_step)
    print_per_step(per_step)


def _other_backwards_in_turns(others: dict, launches, dtype, atol: float, rtol: float,
                              seed: int) -> None:
    """This revision's dQ and dK/dV entry points timed in turns with other
    revisions' (``build_others``) at ``launches`` [(label suffix, B, N, d)],
    on the same inputs, lse and D; each timed output of every revision held
    against the plain versions (atol a share of each output's max |value|).
    f32 rows carry this revision's block count (``f32_bwd_launch_plan``)."""
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = dtype == torch.float32
    errs, per_step = {}, {}
    for suffix, b, n, d in launches:
        q, k, v, do = (torch.randn((b, n, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta)
        dq_ref, dkv_ref = fa.flash_bwd_dq_plain(*args), fa.flash_bwd_dkv_plain(*args)
        for part, this in (("dq", fa.flash_bwd_dq), ("dkv", fa.flash_bwd_dkv)):
            kind = f"flash_bwd_{part}" + ("_f32" if f32 else "")
            runs = {src: (lambda lib=lib, kind=kind: other_backward(lib, kind, *args))
                    for src, lib in others.items()}
            runs["this"] = lambda this=this: this(*args)

            def check(label, out, part=part):
                pairs = ((("dq", out, dq_ref),) if part == "dq" else
                         (("dk", out[0], dkv_ref[0]), ("dv", out[1], dkv_ref[1])))
                for name, got, want in pairs:
                    check_close(label, name, got, want, atol * want.float().abs().max().item(),
                                rtol, q.shape, errs)

            shape = {"B": b, "N": n, "d": d}
            if f32:
                shape["blocks"] = fa.f32_bwd_launch_plan(b, n, d, part)["blocks"]
            time_in_turns(kind + suffix, shape, runs, check, per_step)
        del q, k, v, do, o, lse, delta, dq_ref, dkv_ref
    print_per_step(per_step)


def phase_other_backwards(others: dict) -> None:
    """This revision's dQ and dK/dV entry points (B2a, B2b) timed in turns
    with other revisions' at the training path's shapes and batch
    (FLASH_SHAPES, TRAIN_BATCH), held against the plain versions as in
    phase 2."""
    _other_backwards_in_turns(others, [("", TRAIN_BATCH, n, d) for n, d in FLASH_SHAPES],
                              torch.bfloat16, BWD_ATOL, BWD_RTOL, seed=7)


def phase_other_f32_forward(others: dict) -> None:
    """This revision's f32 forward (B1 and B1-lse at f32) timed in turns with
    other revisions' (``build_others``) at every launch of its paths: without
    lse at the eval batch (DSEC stages 1 and 2, DDD17's stage 1), with lse at
    the train CLIs' batches (DSEC at F32_TRAIN_BATCH, DDD17 at
    DDD17_TRAIN_BATCH). Each timed output, o and lse, of every revision is
    held against the plain version at the f32 tolerances; each row carries
    this revision's block count (``f32_launch_plan``)."""
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    launches = [("flash_fwd_f32", EVAL_BATCH, n, d, False) for n, d in FLASH_SHAPES]
    launches.append(("flash_fwd_f32 DDD17", EVAL_BATCH, *DDD17_FLASH_SHAPE, False))
    launches += [("flash_fwd_lse_f32", F32_TRAIN_BATCH, n, d, True) for n, d in FLASH_SHAPES]
    launches.append(("flash_fwd_lse_f32 DDD17", DDD17_TRAIN_BATCH, *DDD17_FLASH_SHAPE, True))
    errs, per_step = {}, {}
    for kind, b, n, d, with_lse in launches:
        q, k, v = (torch.randn((b, n, d), generator=gen, device="cuda") for _ in range(3))
        want = fa.flash_attention_plain(q, k, v, return_lse=with_lse)
        runs = {src: (lambda lib=lib: other_forward(lib, q, k, v, return_lse=with_lse))
                for src, lib in others.items()}
        runs["this"] = lambda: fa.flash_attention(q, k, v, return_lse=with_lse)

        def check(label, out):
            if not with_lse:
                check_close(label, "o", out, want, FLASH_F32_ATOL, FLASH_F32_RTOL, q.shape, errs)
                return
            check_close(label, "o", out[0], want[0], FLASH_F32_ATOL, FLASH_F32_RTOL, q.shape, errs)
            check_close(label, "lse", out[1], want[1], LSE_F32_ATOL, 0.0, q.shape, errs)

        shape = {"B": b, "N": n, "d": d, "blocks": fa.f32_launch_plan(b, n, d)["blocks"]}
        time_in_turns(kind, shape, runs, check, per_step)
        del q, k, v, want
    print_per_step(per_step)


def phase_other_f32_backward(others: dict) -> None:
    """This revision's f32 backward kernels (B2a and B2b at f32) timed in turns
    with other revisions' at every launch of the f32 train path: DSEC stages
    1 and 2 at F32_TRAIN_BATCH, DDD17's stage 1 at DDD17_TRAIN_BATCH, held
    against the plain versions at the f32 tolerances, each row with this
    revision's block count. B2b's rows are the control where only the dQ
    kernel changed."""
    launches = [("", F32_TRAIN_BATCH, n, d) for n, d in FLASH_SHAPES]
    launches.append((" DDD17", DDD17_TRAIN_BATCH, *DDD17_FLASH_SHAPE))
    _other_backwards_in_turns(others, launches, torch.float32, BWD_F32_ATOL, BWD_F32_RTOL,
                              seed=12)


def phase_other_int8(others: dict) -> None:
    """This revision's int8 forward timed in turns with other revisions'
    (``build_others``) in both modes at the opt-in path's shapes and batches
    (int8_qk at MAIN_BATCH, two launches per shape; int8 at 2 MAIN_BATCH, one):
    whole, as each revision's wrapper ran it (another revision after the
    torch pre-pass, ``int8_kernel_inputs``; this one after its pre-pass
    kernel), and the kernel alone on the same quantized inputs. Each timed
    output is held against the plain version."""
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(8)
    errs, per_step = {}, {}
    for mode in fa.INT8_MODES:
        batch, count = (2 * MAIN_BATCH, 1) if mode == "int8" else (MAIN_BATCH, 2)
        for n, d in FLASH_SHAPES:
            q, k, v = (torch.randn((batch, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            want = fa.flash_attention_int8_plain(q, k, v, mode)
            inputs = fa.int8_kernel_inputs(q, k, v, mode)

            def check(label, out):
                check_close(label, "o", out, want, FLASH_ATOL, FLASH_RTOL, q.shape, errs)

            shape = {"B": batch, "N": n, "d": d}
            runs = {src: (lambda lib=lib: other_int8(lib, q, fa.int8_kernel_inputs(q, k, v, mode),
                                                     mode))
                    for src, lib in others.items()}
            runs["this"] = lambda: fa.flash_attention_int8(q, k, v, mode)
            time_in_turns(f"flash_{mode}", shape, runs, check, per_step, count)
            runs = {src: (lambda lib=lib: other_int8(lib, q, inputs, mode))
                    for src, lib in others.items()}
            runs["this"] = lambda: other_int8(fa._int8_library(), q, inputs, mode)
            time_in_turns(f"flash_{mode} kernel alone", shape, runs, check, per_step, count)
            del want, inputs
    print_per_step(per_step)


def stem_inputs(gen, b, h, w, c):
    """Seeded stem inputs on the card: channels_last bf16 x (B, C, H, W), bf16
    weights (64, C, 7, 7) at unit gain, f32 scale in [0.5, 1.5) and bias."""
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((64, c, 7, 7), generator=gen, device="cuda") / (49 * c) ** 0.5)
    scale = torch.rand((64,), generator=gen, device="cuda") + 0.5
    bias = torch.randn((64,), generator=gen, device="cuda") * 0.2
    return x.permute(0, 3, 1, 2), wt.to(torch.bfloat16), scale, bias


def phase_other_stem(others: dict) -> None:
    """This revision's stem timed in turns with other revisions'
    (``build_others``) at the opt-in batch (MAIN_BATCH, 480x640, C 3 and 5,
    one launch each per batch), on the same inputs; each timed output is held
    against the plain version."""
    from frn_tpu_torch.ops import stem

    gen = torch.Generator(device="cuda").manual_seed(9)
    errs, per_step, device = {}, {}, {}
    for c in stem.STEM_CHANNELS:
        shape = (MAIN_BATCH, 480, 640, c)
        args = stem_inputs(gen, *shape)
        want = stem.stem_conv_bn_relu_plain(*args)
        runs = {src: (lambda src=src, lib=lib: other_stem(src, lib, *args))
                for src, lib in others.items()}
        runs["this"] = lambda: stem.stem_conv_bn_relu(*args)

        def check(label, out):
            check_close(label, "out", out, want, STEM_ATOL, STEM_RTOL, shape, errs)

        time_in_turns("stem", dict(zip(("B", "H", "W", "C"), shape)), runs, check, per_step, 1,
                      windows=STEM_WINDOWS)
        # the kernels' own time: a launch is about as short as its enqueue
        dev = {name: device_ms(run, ("stem_",)) for name, run in runs.items()}
        print(f"revisions device ms stem C {c}: {json.dumps(dev)}", flush=True)
        for name, ms in dev.items():
            device[name] = device.get(name, 0.0) + ms
        del want, args
    print_per_step(per_step)
    for name, ms in device.items():
        print(f"revisions: stem {'this revision' if name == 'this' else name}: {ms:.4f} ms device "
              f"time per batch (2 launches)", flush=True)


def _random_head_outputs(model, seed: int) -> None:
    """Seeded random head output convs (stock init scores every anchor at the
    0.01 prior, under the 0.05 threshold, and NMS would have nothing to do)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for head, w_scale, b_std in ((model.classificationModel, 1.0, 1.0),
                                     (model.regressionModel, 0.01, 0.1)):
            w = head.output.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen) * (w_scale / fan_in ** 0.5))
            head.output.bias.copy_(torch.randn(head.output.bias.shape, generator=gen) * b_std)


def phase_optin_kernels() -> dict:
    """The bf16-exp forward, the int8 forward in both modes and the stem
    against their plain versions: the flash forwards at BWD_CHECK_SHAPES
    (with the int8 pre-pass kernel held bitwise to ``int8_kernel_inputs``),
    the stem at STEM_CHECK_SHAPES. Then each timed at the opt-in path's batch
    and shapes (the int8 mode under fused attention at 2B), the timed runs'
    outputs held against each other; the pre-pass is timed on its own beside
    its bytes bound and its plain version."""
    import torch.nn.functional as F

    from frn_tpu_torch.ops import flash_attention as fa
    from frn_tpu_torch.ops import stem

    gen = torch.Generator(device="cuda").manual_seed(4)

    def qkv(b, n, d):
        return [torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3)]

    flash = {"flash_fwd_bf16exp": (fa.flash_attention_bf16exp, fa.flash_attention_bf16exp_plain),
             "flash_int8_qk": (lambda q, k, v: fa.flash_attention_int8(q, k, v, "int8_qk"),
                               lambda q, k, v: fa.flash_attention_int8_plain(q, k, v, "int8_qk")),
             "flash_int8": (lambda q, k, v: fa.flash_attention_int8(q, k, v, "int8"),
                            lambda q, k, v: fa.flash_attention_int8_plain(q, k, v, "int8"))}
    errs = {}
    for shape in BWD_CHECK_SHAPES:
        q, k, v = qkv(*shape)
        for kind, (kernel, plain) in flash.items():
            check_close(kind, "o", kernel(q, k, v), plain(q, k, v), FLASH_ATOL, FLASH_RTOL,
                        shape, errs)
        for mode in fa.INT8_MODES:
            check_prepass(f"{mode}_prepass", fa.int8_prepass(q, k, v, mode),
                          fa.int8_kernel_inputs(q, k, v, mode), shape)

    for shape in STEM_CHECK_SHAPES:
        args = stem_inputs(gen, *shape)
        check_close("stem", "out", stem.stem_conv_bn_relu(*args), stem.stem_conv_bn_relu_plain(*args),
                    STEM_ATOL, STEM_RTOL, shape, errs)

    rows = {}
    # the flash kernels per opt-in forward: two directions at each shape, at
    # batch 16, or one launch over 2B under fused attention (the int8 mode).
    # The int8 rows time the wrapper (pre-pass and kernel); the pre-pass gets
    # rows of its own, its plain version being the torch pre-pass
    for kind, (kernel, plain) in flash.items():
        times = KernelTimes(kind)
        batch, count = (2 * MAIN_BATCH, 1) if kind == "flash_int8" else (MAIN_BATCH, 2)
        mode = kind[len("flash_"):]
        prep = KernelTimes(f"{mode}_prepass") if kind != "flash_fwd_bf16exp" else None
        for n, d in FLASH_SHAPES:
            q, k, v = qkv(batch, n, d)
            q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
            sdpa_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0),
                                 reps=10)
            shape = {"B": batch, "N": n, "d": d}
            if prep is None:
                library_ms, extra = sdpa_ms, None
            else:  # no PyTorch call computes the quantized function: SDPA in bf16 beside it
                # the pre-pass's launches are shorter than their enqueue on
                # the host: its device time is read by the profiler too
                dev_ms = device_ms(lambda: fa.int8_prepass(q, k, v, mode),
                                   ("int8_absmax_partial", "int8_quantize"))
                got, want = prep.add(shape, prepass_bound(mode, batch, n, d),
                                     lambda: fa.int8_prepass(q, k, v, mode),
                                     lambda: fa.int8_kernel_inputs(q, k, v, mode), None,
                                     count=count, extra={"device_ms": dev_ms})
                check_prepass(f"{mode}_prepass", got, want, q.shape)
                library_ms = None
                extra = {"sdpa_bf16_ms": sdpa_ms, "prepass_ms": prep.per_shape[-1]["ms"],
                         "prepass_device_ms": dev_ms}
                del got, want
            out, ref = times.add(shape, kernel_bound(kind, batch, n, d),
                                 lambda: kernel(q, k, v), lambda: plain(q, k, v), library_ms,
                                 count=count, extra=extra)
            check_close(kind, "o", out, ref, FLASH_ATOL, FLASH_RTOL, q.shape, errs)
        rows[kind] = times.row(errs[kind], "opt-in forward")
        if prep is not None:
            rows[prep.kind] = prep.row(0.0, "opt-in forward")

    # the stem per opt-in batch: the RGB and the event stem at batch 16; the
    # yardstick is cuDNN's channels_last bf16 conv with the affine folded in
    times = KernelTimes("stem")
    for c in (3, 5):
        shape = (MAIN_BATCH, 480, 640, c)
        x, wt, scale, bias = stem_inputs(gen, *shape)
        w_fold = (wt.float() * scale[:, None, None, None]).to(torch.bfloat16)
        b_fold = bias.to(torch.bfloat16)
        library_ms, _ = cuda_ms(lambda: torch.relu(F.conv2d(x, w_fold, b_fold, stride=2, padding=3)),
                                reps=10, windows=STEM_WINDOWS)
        # the kernel's own time beside the wrapper's: a launch is about as
        # short as its enqueue on the host
        dev_ms = device_ms(lambda: stem.stem_conv_bn_relu(x, wt, scale, bias), ("stem_wgmma",))
        out, ref = times.add(dict(zip(("B", "H", "W", "C"), shape)), stem_bound(*shape),
                             lambda: stem.stem_conv_bn_relu(x, wt, scale, bias),
                             lambda: stem.stem_conv_bn_relu_plain(x, wt, scale, bias), library_ms,
                             count=1, extra={"device_ms": dev_ms}, windows=STEM_WINDOWS)
        check_close("stem", "out", out, ref, STEM_ATOL, STEM_RTOL, shape, errs)
    rows["stem"] = times.row(errs["stem"], "opt-in batch")
    return rows


def _swap_in_plain_kernels(stem_fn=None):
    """Replaces each opt-in attention kernel wrapper with its plain version
    where the model looks it up, and the stem with ``stem_fn`` if given;
    returns the function that puts them back."""
    from frn_tpu_torch.models import resnet
    from frn_tpu_torch.ops import attention
    from frn_tpu_torch.ops import flash_attention as fa

    saved = [(attention, "flash_attention_bf16exp", fa.flash_attention_bf16exp_plain),
             (attention, "flash_attention_int8", fa.flash_attention_int8_plain)]
    if stem_fn is not None:
        saved.append((resnet, "stem_conv_bn_relu", stem_fn))
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
    for mod, name, plain in saved:
        setattr(mod, name, plain)

    def restore():
        for mod, name, fn in originals:
            setattr(mod, name, fn)

    return restore


def _ulp_perturbed_plain_stem(share: float, seed: int):
    """The plain stem with one bf16 ulp added to or taken from a seeded
    ``share`` (at least one) of its positive outputs: the size of the
    differences the kernel's output shows against it."""
    from frn_tpu_torch.ops.stem import stem_conv_bn_relu_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def perturbed(x, w, scale, bias):
        y = stem_conv_bn_relu_plain(x, w, scale, bias)
        bits = y.flatten().view(torch.int16).clone()
        pos = torch.nonzero(bits > 0).squeeze(1)
        count = max(1, round(share * bits.numel()))
        pick = pos[torch.randperm(pos.numel(), generator=gen, device=pos.device)[:count]]
        step = torch.randint(0, 2, (pick.numel(),), generator=gen, device=pos.device) * 2 - 1
        bits[pick] += step.to(torch.int16)
        out = torch.empty_like(y)
        out.copy_(bits.view(torch.bfloat16).view(y.shape))
        return out

    return perturbed


def _record_stem():
    """Wraps the stem where the model looks it up so that each call records
    its inputs and output; returns (the record, the function that restores
    the stem)."""
    from frn_tpu_torch.models import resnet

    kernel, calls = resnet.stem_conv_bn_relu, []

    def recorded(x, w, scale, bias):
        y = kernel(x, w, scale, bias)
        calls.append((x, w, scale, bias, y))
        return y

    resnet.stem_conv_bn_relu = recorded

    def restore():
        resnet.stem_conv_bn_relu = kernel

    return calls, restore


def phase_optin_path(kernel_rows, default_ms: float, default_out) -> None:
    """The opt-in inference path through ``entry(device="cuda", batch=16,
    **fields)`` in each of OPTIN_CONFIGS: the same seeded weights and inputs
    as the default path (the flags add no parameters). Launch counts over
    the timed batches, a profiler pass, the outputs' checks."""
    from frn_tpu_torch.entry import entry
    from frn_tpu_torch.ops.stem import stem_conv_bn_relu_plain

    totals = dict.fromkeys(OPTIN_KERNELS, 0)
    for label, options, per_batch in OPTIN_CONFIGS:
        fn, (rgb, event) = entry(device="cuda", batch=MAIN_BATCH, **options)
        _random_head_outputs(fn.model, seed=1)
        k = fn.config.model.num_classes
        out = fn(rgb, event)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        times = []
        for _ in range(MAIN_TIMED):
            t0 = time.perf_counter()
            out = fn(rgb, event)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        ms = sum(times) / len(times)
        print(f"opt-in path ({label}, {json.dumps(options)}): DSEC 480x640 fusion R50 bf16 batch "
              f"{MAIN_BATCH}: {ms:.2f} ms/batch (runs {', '.join(f'{t:.2f}' for t in times)}), "
              f"{MAIN_BATCH * 1e3 / ms:.1f} img/s (default path {default_ms:.2f} ms, "
              f"{MAIN_BATCH * 1e3 / default_ms:.1f} img/s), peak memory {peak / 2**30:.2f} GiB; "
              f"launches {json.dumps(counts)}", flush=True)
        want = {**dict.fromkeys(_COUNTERS, 0), **{kind: n * MAIN_TIMED for kind, n in per_batch.items()}}
        if counts != want:
            fail(f"opt-in path ({label}) launched {counts}, expected {want}")
        for kind in per_batch:
            totals[kind] += counts[kind]
        profile_pass(f"opt-in profile ({label}): one batch of {MAIN_BATCH}", lambda: fn(rgb, event),
                     ms, n_ops=8, n_kernels=8)

        scores, labels, boxes = out
        m = fn.config.eval.max_detections
        if (scores.shape, labels.shape, boxes.shape) != ((MAIN_BATCH, m), (MAIN_BATCH, m),
                                                         (MAIN_BATCH, m, 4)):
            fail(f"opt-in path ({label}) output shapes {scores.shape} {labels.shape} {boxes.shape}")
        if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
            fail(f"opt-in path ({label}): non-finite detections")
        valid = labels >= 0
        if int(valid.sum()) == 0 or int(labels.max()) >= k:
            fail(f"opt-in path ({label}): {int(valid.sum())} detections, labels up to "
                 f"{int(labels.max())}")

        # The stem kernel on the batch's own stem inputs against its plain
        # version, element by element; then the same model and batch with the
        # attention kernels swapped for their plain versions, the stem's
        # output shared, gated; and with every kernel swapped, printed: the
        # stem's one-ulp differences alone move the logits past MAIN_REL_TOL
        # (the two ResNet-50s, at random weights, carry them to the end),
        # which the witness shows: the all-plain model with the plain stem's
        # output moved by one ulp at as many positions as the kernel's
        # differs, at two seeds, against the all-plain model
        with torch.inference_mode():
            stem_calls, restore = _record_stem()
            try:
                got = fn.model(rgb, event, eval_output=fn.eval_output)
            finally:
                restore()
            differ, total = 0, 0
            for x, wt, scale, bias, y in stem_calls:
                y_ref = stem_conv_bn_relu_plain(x, wt, scale, bias)
                check_close("stem", "out", y, y_ref, STEM_ATOL, STEM_RTOL,
                            tuple(x.permute(0, 2, 3, 1).shape), {})
                differ, total = differ + int((y != y_ref).sum()), total + y.numel()
                del y_ref
            del stem_calls
            outs = []
            for stem_fn in (None, stem_conv_bn_relu_plain):
                restore = _swap_in_plain_kernels(stem_fn)
                try:
                    outs.append(fn.model(rgb, event, eval_output=fn.eval_output))
                finally:
                    restore()
            if total:
                share = differ / total
                print(f"opt-in path ({label}) stem: {differ} of {total} outputs ({share:.4%}) "
                      f"differ from the plain version", flush=True)
                for seed in (1, 2):
                    restore = _swap_in_plain_kernels(_ulp_perturbed_plain_stem(share, seed))
                    try:
                        moved = fn.model(rgb, event, eval_output=fn.eval_output)
                    finally:
                        restore()
                    rel = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                           for a, b in zip(moved, outs[1])]
                    print(f"opt-in path ({label}) witness: the all-plain model with the plain "
                          f"stem moved one ulp at {share:.4%} of its outputs (seed {seed}): "
                          f"logits {rel[0]:.3e}, deltas {rel[1]:.3e} max|diff|/max|ref| against "
                          f"the all-plain model", flush=True)
                    del moved
        want_out, all_plain = outs
        for name, g, w, a, d in zip(("logits", "deltas"), got, want_out, all_plain, default_out):
            rel, every, off = (((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                               for r in (w, a, d))
            print(f"opt-in path ({label}) {name}: kernels vs plain attention max|diff|/max|ref| = "
                  f"{rel:.3e}; printed, not gated: vs every kernel plain {every:.3e}, vs the "
                  f"default path {off:.3e}", flush=True)
            if not rel <= MAIN_REL_TOL:
                fail(f"opt-in path ({label}) {name} disagree with the plain versions ({rel:.3e})")
        del fn, rgb, event, out, got, outs, want_out, all_plain
    for kind in OPTIN_KERNELS:
        kernel_rows[kind]["launches"] = totals[kind]


def phase_main_path(kernel_rows):
    from frn_tpu_torch.entry import entry
    from frn_tpu_torch.ops import attention
    from frn_tpu_torch.ops import flash_attention as fa

    fn, (rgb, event) = entry(device="cuda", batch=MAIN_BATCH)
    _random_head_outputs(fn.model, seed=1)
    k = fn.config.model.num_classes

    out = fn(rgb, event)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times = []
    for _ in range(MAIN_TIMED):
        t0 = time.perf_counter()
        out = fn(rgb, event)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    launches = counts.pop("flash_fwd")
    peak = torch.cuda.max_memory_allocated()
    ms = sum(times) / len(times)
    print(f"main path: DSEC 480x640 fusion R50 bf16 batch {MAIN_BATCH}, forward + decode + NMS: "
          f"{ms:.2f} ms/batch (runs {', '.join(f'{t:.2f}' for t in times)}), "
          f"{MAIN_BATCH * 1e3 / ms:.1f} img/s, peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"main path launches: flash_fwd {launches} over {MAIN_TIMED} batches", flush=True)
    if launches != 4 * MAIN_TIMED or any(counts.values()):
        fail(f"flash_fwd launched {launches} times over {MAIN_TIMED} forwards, expected 4 each "
             f"and no other kernel ({counts})")
    kernel_rows["flash_fwd"]["launches"] = launches

    scores, labels, boxes = out
    m = fn.config.eval.max_detections
    if (scores.shape, labels.shape, boxes.shape) != ((MAIN_BATCH, m), (MAIN_BATCH, m), (MAIN_BATCH, m, 4)):
        fail(f"output shapes {scores.shape} {labels.shape} {boxes.shape}")
    if not (torch.isfinite(scores).all() and torch.isfinite(boxes).all()):
        fail("non-finite detections")
    valid = labels >= 0
    if int(valid.sum()) == 0 or int(labels.max()) >= k:
        fail(f"{int(valid.sum())} detections, labels up to {int(labels.max())}")
    print(f"detections: {int(valid.sum())} valid slots over {MAIN_BATCH} images", flush=True)

    # the same model and batch with the plain attention in place of the kernel
    with torch.inference_mode():
        got = fn.model(rgb, event, eval_output=fn.eval_output)
        kernel_fn = attention.flash_attention
        attention.flash_attention = fa.flash_attention_plain
        try:
            want = fn.model(rgb, event, eval_output=fn.eval_output)
        finally:
            attention.flash_attention = kernel_fn
    for name, g, w in zip(("logits", "deltas"), got, want):
        rel = ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
        print(f"main path {name}, kernel vs plain attention: max|diff|/max|ref| = {rel:.3e}", flush=True)
        if not rel <= MAIN_REL_TOL:
            fail(f"main-path {name} disagree with the plain attention run ({rel:.3e})")
    return fn, rgb, event, ms, got


def phase_breakdown(fn, rgb, event, reps: int = 3) -> dict:
    """Device time of each layer of the main path at batch 16 (CUDA events
    between the layers of one forward + decode, averaged over ``reps`` runs),
    beside the host-clock time of the same runs."""
    from frn_tpu_torch.models.detector import decode_detections
    from frn_tpu_torch.models.heads import apply_heads

    model = fn.model
    cls_mode, reg_mode = "logits_chanlast", "flat36"
    names = ["rgb_backbone", "event_backbone", "fusion_1", "fusion_2", "fusion_3",
             "fusion_4", "fpn", "heads", "decode_nms"]
    totals = dict.fromkeys(names, 0.0)
    wall = 0.0
    with torch.inference_mode():
        for rep in range(reps + 1):  # the first run is a warm-up
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            marks[0].record()
            r = model._backbones["rgb"](rgb.to(model.compute_dtype).permute(0, 3, 1, 2))
            marks[1].record()
            e = model._backbones["event"](event.to(model.compute_dtype).permute(0, 3, 1, 2))
            marks[2].record()
            feats = []
            for i, fus in enumerate(model.fus):
                feats.append(fus(e[i], r[i]))
                marks[3 + i].record()
            pyramid = model.fpn(feats)
            marks[7].record()
            cls, reg = apply_heads(model.classificationModel, model.regressionModel, pyramid,
                                   cls_mode, reg_mode)
            marks[8].record()
            decode_detections(cls, reg, fn.config, anchors=fn.anchors)
            marks[9].record()
            torch.cuda.synchronize()
            del r, e, feats, pyramid, cls, reg  # hold no more memory than a plain forward
            if rep == 0:
                continue
            wall += (time.perf_counter() - t0) * 1e3
            for i, name in enumerate(names):
                totals[name] += marks[i].elapsed_time(marks[i + 1])
    out = {name: ms / reps for name, ms in totals.items()}
    out["sum_of_layers"] = sum(out.values())
    out["host_wall"] = wall / reps
    print(f"main path layers, device ms per batch of {MAIN_BATCH} (CUDA events): "
          f"{json.dumps(out)}", flush=True)
    return out


def profile_pass(label: str, run_once, wall_ms: float, n_ops: int, n_kernels: int,
                 n_host_ops: int = 0) -> None:
    """torch.profiler over one call of ``run_once`` (after one profiled
    warm-up call): the device-busy time summed over kernels, the idle share of
    the unprofiled wall time ``wall_ms`` of one call, and the costliest
    operators (by the device time of the kernels they launched) and kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []  # the active cycle's events, taken before the profiler clears them
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(p.key_averages())) as prof:
        for _ in range(2):
            run_once()
            torch.cuda.synchronize()
            prof.step()
    kernels, ops = [], []
    for ev in traced:
        ms = ev.self_device_time_total / 1e3
        # a user annotation (the step's own span, Optimizer.step) is a range
        # on the device timeline, not a kernel: counted, it would count twice
        if ms > 0 and not (getattr(ev, "is_user_annotation", False)
                           or ev.key.startswith(("ProfilerStep", "Optimizer."))):
            (kernels if ev.device_type == DeviceType.CUDA else ops).append((ms, ev.count, ev.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    idle = 1 - busy / wall_ms if busy else float("nan")
    print(f"{label}: {len(kernels)} kernels ({sum(k[1] for k in kernels)} launches), device busy "
          f"{busy:.3f} ms; idle share of the unprofiled {wall_ms:.3f} ms {idle:.3f}", flush=True)
    print("  operators by the device time of the kernels they launched:", flush=True)
    for ms, count, key in ops[:n_ops]:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}", flush=True)
    print("  kernels:", flush=True)
    for ms, count, key in kernels[:n_kernels]:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}", flush=True)
    if n_host_ops:
        host = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key) for ev in traced
                       if ev.device_type != DeviceType.CUDA), reverse=True)
        print("  host operators by self CPU time:", flush=True)
        for ms, count, key in host[:n_host_ops]:
            print(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}", flush=True)


def phase_small_reference():
    """A small f32 fusion model on the card against the same model on the CPU."""
    from frn_tpu_torch import config as c
    from frn_tpu_torch.models.detector import decode_detections, eval_output_for, init_detector

    geo = dataclasses.replace(c.DSEC, height=64, width=96)
    cfg = c.FrameworkConfig(geometry=geo, model=c.ModelConfig(
        variant="fusion", depth=18, num_classes=3, feature_size=32, attention_chunk=64))
    cpu = init_detector(cfg, seed=3, device="cpu")
    _random_head_outputs(cpu, seed=4)
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(5)
    rgb = torch.randn((2, 64, 96, 3), generator=gen)
    event = torch.randn((2, 64, 96, 5), generator=gen)
    eo = eval_output_for(cfg)
    with torch.inference_mode():
        want = cpu(rgb, event, eval_output=eo)
        got = gpu(rgb.cuda(), event.cuda(), eval_output=eo)
        det_want = decode_detections(*want, cfg)
        det_got = decode_detections(*got, cfg)
    for name, g, w in zip(("logits", "deltas"), got, want):
        err = (g.cpu() - w).abs().max().item()
        scale = w.abs().max().item()
        print(f"small f32 model, card vs CPU {name}: max_abs_err {err:.3e} (max|ref| {scale:.3e})", flush=True)
        if not err <= 1e-3 * scale:
            fail(f"small f32 model {name} disagree between card and CPU")
    n_got, n_want = int((det_got[1] >= 0).sum()), int((det_want[1] >= 0).sum())
    print(f"small f32 model detections: card {n_got}, CPU {n_want}", flush=True)
    if n_got != n_want or n_want == 0:
        fail("small f32 model detection counts differ between card and CPU")


# ------------------------------------------------------------ evaluation

# the evaluation path (phase 8): three batches of EVAL_BATCH per clean run;
# the corruption runs take one batch each
EVAL_IMAGES, EVAL_SWEEP_IMAGES = 24, 8
EVAL_SEVERITIES = (1, 5)
# the CLI's configurations: label, CLI entry (module), flags, launches per
# batch of each kernel (every other kernel of the port: none)
EVAL_CONFIGS = (
    ("DSEC bf16", "test", "dsec", ["--compute_dtype", "bfloat16"], {"flash_fwd": 4}),
    ("DSEC f32", "test", "dsec", [], {"flash_fwd_f32": 4}),
    ("DDD17 f32 (test_ddd17)", "test_ddd17", "ddd17", [], {"flash_fwd_f32": 2}),
)
# f32 logits with the f32 kernel vs with its plain version, max|diff| over
# max|ref|: the attention outputs differ by about 1e-5 relative (FLASH_F32_*),
# and every later layer computes in f32
EVAL_F32_REL_TOL = 1e-3
# the small f32 evaluation on the card vs on the CPU (256x320, depth 18:
# stage 1 has 5,120 tokens at head dim 8, so the card runs the f32 forward
# there and the CPU the dense route): the same detections (scores within
# 1e-4, boxes within 1e-2 px: f32 sums in another order) and per-class APs
# within 1e-3 (a rank flip of two near-equal scores)
SMALL_EVAL_HW = (256, 320)
SMALL_EVAL_SCORE_ATOL, SMALL_EVAL_BOX_ATOL, SMALL_EVAL_AP_ATOL = 1e-4, 1e-2, 1e-3


class _FirstImages:
    """The first ``count`` images of a CSV dataset, with its evaluation surface."""

    def __init__(self, dataset, count: int):
        self.dataset, self.count = dataset, count

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        return self.dataset[i]

    def __getattr__(self, name):  # num_classes, label_to_name, load_annotations
        return getattr(self.dataset, name)


def write_eval_inputs(root: Path) -> dict:
    """The evaluation phase's inputs under ``root``: a DSEC and a DDD17
    fixture of EVAL_IMAGES images, a DSEC one of EVAL_SWEEP_IMAGES for the
    corruption runs and the trainer, a small one (SMALL_EVAL_HW) for the
    card-vs-CPU check (``make_csv_fixture``, PNGs by ``data/image_io.py``),
    and ``.pth`` files of seeded weights with random head output convs (so
    that NMS has work): the DSEC and DDD17 fusion ResNet-50s and a small
    depth-18 model."""
    from frn_tpu_torch import config as c
    from frn_tpu_torch.data.synthetic import make_csv_fixture
    from frn_tpu_torch.models.detector import init_detector

    t0 = time.perf_counter()
    small = dataclasses.replace(c.DSEC, height=SMALL_EVAL_HW[0], width=SMALL_EVAL_HW[1])
    out = {"dsec": make_csv_fixture(str(root / "dsec"), c.DSEC, EVAL_IMAGES, seed=11),
           "ddd17": make_csv_fixture(str(root / "ddd17"), c.DDD17, EVAL_IMAGES, seed=12),
           "dsec_small": make_csv_fixture(str(root / "dsec_small"), c.DSEC, EVAL_SWEEP_IMAGES,
                                          seed=13),
           "small": make_csv_fixture(str(root / "small"), small, 6, seed=14)}
    models = {"dsec": (c.DSEC, {}), "ddd17": (c.DDD17, {}),
              "small": (small, {"depth": 18, "feature_size": 16})}
    for name, (geo, kw) in models.items():
        cfg = c.FrameworkConfig(geometry=geo, model=c.ModelConfig(
            variant="fusion", num_classes=geo.num_classes, **{"depth": 50, **kw}))
        model = init_detector(cfg, seed=15, device="cpu")
        _random_head_outputs(model, seed=16)
        out[f"{name}_pth"] = str(root / f"{name}.pth")
        torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, out[f"{name}_pth"])
        del model
    print(f"evaluation inputs: fixtures of {EVAL_IMAGES} DSEC, {EVAL_IMAGES} DDD17, "
          f"{EVAL_SWEEP_IMAGES} DSEC and 6 small images, three .pth files, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _cli_flags(inputs: dict, dataset: str, folder: str, *more) -> list:
    fix = inputs[dataset]
    return ["--csv_classes", fix["class_map_csv"], "--root_img", fix["img_dir"],
            "--root_event", fix["event_dir"], "--csv_test", fix["annotations_csv"],
            "--checkpoint", inputs[dataset.split("_")[0] + "_pth"], "--batch_size", str(EVAL_BATCH),
            "--save_detect_folder", folder, *more]


def run_cli(label: str, module: str, argv: list):
    """``frn_tpu_torch.cli.<module>.main(argv)`` on the card with the launch
    counts zeroed just before and read just after; its printout is echoed.
    Returns (what main returned, printout, counts, seconds)."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(f"frn_tpu_torch.cli.{module}").main
    buf = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    text = buf.getvalue()
    print(f"--- {label}: python -m frn_tpu_torch.cli.{module} ... ({seconds:.1f} s)\n"
          f"{text.strip()}\n--- launches {json.dumps(counts)}", flush=True)
    return result, text, counts, seconds


def run_eval_cli(label: str, module: str, argv: list):
    """``run_cli`` of an evaluation CLI, which must return 0; returns
    (printout, counts, seconds)."""
    rc, text, counts, seconds = run_cli(label, module, argv)
    if rc != 0:
        fail(f"evaluation CLI ({label}) returned {rc}")
    return text, counts, seconds


def check_eval_summary(label: str, text: str, folder: str):
    """(fps, summary): the CLI's printed fps and mAP summary, and its
    evaluation_aps.pkl, all finite and the APs in [0, 1]."""
    import pickle
    import re

    fps = re.search(r"^fps ([0-9.]+)$", text, re.M)
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    with open(Path(folder) / "evaluation_aps.pkl", "rb") as f:
        aps = [a for per_class in pickle.load(f).values() for a in per_class]
    values = list(summary.values()) + aps
    if fps is None or not float(fps.group(1)) > 0:
        fail(f"evaluation ({label}): no fps in the printout")
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
        fail(f"evaluation ({label}): summary or APs outside [0, 1]: {summary}")
    return float(fps.group(1)), summary


def eval_model(inputs: dict, dataset: str, *flags):
    """(args, dataset, config, infer) of the CLI's flags, built by the
    CLI's own helpers, on the card: the function the CLI evaluates with."""
    from frn_tpu_torch.cli import common, test
    from frn_tpu_torch.eval.detections import make_inference_fn
    from frn_tpu_torch.models.detector import init_detector

    args = test.get_parser().parse_args(
        ["--dataset_name", dataset.split("_")[0]] + _cli_flags(inputs, dataset, "unused", *flags))
    device = common.setup_device(args)
    ds = common.build_csv_dataset(args, args.csv_test)
    config = common.build_config(args, ds.num_classes(), args.batch_size)
    model = init_detector(config, seed=0, device=device)
    common.load_checkpoint_into_model(args, model)
    return args, ds, config, make_inference_fn(model, config)


def first_batch(dataset, config):
    """The first EVAL_BATCH images, collated as ``collect_detections``
    collates them, on the card."""
    from frn_tpu_torch.data.collate import collate_fixed
    from frn_tpu_torch.data.loader import to_device

    batch = collate_fixed([dataset[i] for i in range(EVAL_BATCH)], config.geometry, 1, EVAL_BATCH)
    batch = to_device({"rgb": batch["rgb"], "event": batch["event"]}, "cuda")
    return batch["rgb"], batch["event"]


def check_rows_match_inference(dataset, config, infer) -> None:
    """``collect_detections``' per-image, per-class rows against the
    inference function's output on the same collated batch, exactly."""
    import numpy as np

    from frn_tpu_torch.eval.detections import collect_detections

    rgb, event = first_batch(dataset, config)
    scores, labels, boxes = (x.cpu().numpy() for x in infer(rgb, event))
    dets, _ = collect_detections(_FirstImages(dataset, EVAL_BATCH), infer, config,
                                 batch_size=EVAL_BATCH)
    compared = 0
    for b in range(EVAL_BATCH):
        keep = scores[b] > config.eval.score_threshold
        rows = np.concatenate([boxes[b][keep], scores[b][keep][:, None]], 1).astype(np.float32)
        for cls in range(dataset.num_classes()):
            want = rows[labels[b][keep] == cls]
            if not np.array_equal(dets[b][cls], want):
                fail(f"collect_detections image {b} class {cls}: {dets[b][cls].shape} rows differ "
                     f"from the inference function's {want.shape}")
            compared += len(want)
    print(f"collect_detections rows equal the inference function's output on the same batch: "
          f"{compared} detections over {EVAL_BATCH} images", flush=True)
    if compared == 0:
        fail("collect_detections: no detections to compare")


def check_f32_logits(model, config, rgb, event, eval_output) -> None:
    """The f32 model's logits and deltas with the f32 kernel against the same
    model with the plain attention, on the card."""
    from frn_tpu_torch.ops import attention
    from frn_tpu_torch.ops import flash_attention as fa

    with torch.inference_mode():
        got = model(rgb, event, eval_output=eval_output, train=False)
        kernel_fn = attention.flash_attention
        attention.flash_attention = fa.flash_attention_plain
        try:
            want = model(rgb, event, eval_output=eval_output, train=False)
        finally:
            attention.flash_attention = kernel_fn
    for name, g, w in zip(("logits", "deltas"), got, want):
        rel = ((g - w).abs().max() / w.abs().max()).item()
        print(f"evaluation DSEC f32 {name}, f32 kernel vs plain attention (batch {EVAL_BATCH}): "
              f"max|diff|/max|ref| = {rel:.3e} (at most {EVAL_F32_REL_TOL:.0e})", flush=True)
        if not (g.dtype == torch.float32 and rel <= EVAL_F32_REL_TOL):
            fail(f"evaluation DSEC f32 {name} disagree with the plain attention ({rel:.3e})")


def check_small_eval_card_vs_cpu(inputs: dict, root: Path) -> None:
    """The small f32 model evaluated by the CLI on the card (the f32 forward
    twice, at stage 1) and on the CPU (the dense route): the same detections
    and per-class APs, within SMALL_EVAL_*."""
    import pickle

    import numpy as np

    small = ["--image_height", str(SMALL_EVAL_HW[0]), "--image_width", str(SMALL_EVAL_HW[1]),
             "--depth", "18", "--feature_size", "16"]
    got = {}
    for device in ("cuda", "cpu"):
        folder = str(root / f"small_{device}")
        argv = _cli_flags(inputs, "small", folder, *small, "--device", device)
        text, counts, _ = run_eval_cli(f"small f32 on {device}", "test", argv)
        check_eval_summary(f"small f32 on {device}", text, folder)
        want = {**dict.fromkeys(_COUNTERS, 0), "flash_fwd_f32": 2 if device == "cuda" else 0}
        if counts != want:
            fail(f"small f32 evaluation on {device} launched {counts}, expected {want}")
        with open(Path(folder) / "detections.txt", "rb") as f:
            dets = pickle.load(f)
        with open(Path(folder) / "evaluation_aps.pkl", "rb") as f:
            got[device] = dets, pickle.load(f)
    (d_card, ap_card), (d_cpu, ap_cpu) = got["cuda"], got["cpu"]
    n, score_err, box_err = 0, 0.0, 0.0
    for img_card, img_cpu in zip(d_card, d_cpu):
        for a, b in zip(img_card, img_cpu):
            if a.shape != b.shape:
                fail(f"small f32 evaluation: {a.shape} detections on the card, {b.shape} on the CPU")
            if len(a):
                n += len(a)
                score_err = max(score_err, float(np.abs(a[:, 4] - b[:, 4]).max()))
                box_err = max(box_err, float(np.abs(a[:, :4] - b[:, :4]).max()))
    ap_err = max(abs(x - y) for k in ap_cpu for x, y in zip(ap_card[k], ap_cpu[k]))
    print(f"small f32 evaluation, card vs CPU: {n} detections, max |score diff| {score_err:.3e}, "
          f"max |box diff| {box_err:.3e} px, max |AP diff| {ap_err:.3e}", flush=True)
    if not (n > 0 and score_err <= SMALL_EVAL_SCORE_ATOL and box_err <= SMALL_EVAL_BOX_ATOL
            and ap_err <= SMALL_EVAL_AP_ATOL):
        fail("small f32 evaluation disagrees between the card and the CPU")


def write_corruption_tree(inputs: dict, root: Path, group: int) -> Path:
    """A pre-generated corruption tree <root>/<type>/severity_<s>/ for the
    corruption group ``group`` over the small DSEC fixture's images, each
    corrupted by ``ops/corruption.py``; a type that needs OpenCV, where it
    is absent, gets the clean images (said so)."""
    import shutil

    import numpy as np

    from frn_tpu_torch.data import image_io
    from frn_tpu_torch.ops.corruption import CORRUPTION_GROUPS, SEVERITIES, corrupt

    t0 = time.perf_counter()
    src = Path(inputs["dsec_small"]["img_dir"])
    pngs = sorted(src.rglob("*.png"))
    for corruption in CORRUPTION_GROUPS[group]:
        for sev in SEVERITIES:
            for png in pngs:
                dst = root / corruption / f"severity_{sev}" / png.relative_to(src)
                dst.parent.mkdir(parents=True, exist_ok=True)
                img = image_io.imread(str(png)).astype(np.float32) / 255.0
                try:
                    img = corrupt(img, corruption, sev)
                except RuntimeError as e:  # OpenCV absent
                    if sev == 1 and png == pngs[0]:
                        print(f"corruption tree: {corruption} holds clean images ({e})", flush=True)
                    shutil.copyfile(png, dst)
                    continue
                image_io.imwrite(str(dst), (np.clip(img, 0, 1) * 255).round().astype(np.uint8),
                                 level=1)
    print(f"corruption tree of group {group} ({len(pngs)} images x {len(SEVERITIES)} severities) "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    return root


def phase_evaluation(kernel_rows, inputs: dict, root: Path) -> None:
    """The evaluation path through ``python -m frn_tpu_torch.cli.test`` on
    the card, full width (fusion ResNet-50, feature size 256): DSEC at bf16
    and at the CLI's default f32, and DDD17 (``test_ddd17``, f32), each with
    its launches counted per batch, its summary and APs checked and its
    img/s, device ms per batch and idle share printed; then the corruption
    sweep over the seven OpenCV-free corruptions at EVAL_SEVERITIES
    (``corruption_sweep``), the folder protocol through the CLI
    (--corruption_root), and the small f32 evaluation on the card against
    the CPU."""
    import pickle

    from frn_tpu_torch.cli.test import write_corruption_artifacts
    from frn_tpu_torch.data.csv_dataset import CSVDetectionDataset
    from frn_tpu_torch.eval.detections import collect_detections
    from frn_tpu_torch.eval.evaluator import corruption_sweep
    from frn_tpu_torch.ops.corruption import CORRUPTION_GROUPS, CV2_FREE_CORRUPTIONS, SEVERITIES

    print(f"evaluation on {card_name_and_power_limit()}", flush=True)
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    f32_launches = 0
    for label, module, dataset, flags, per_batch in EVAL_CONFIGS:
        folder = str(root / f"eval_{label.split()[0]}_{label.split()[1]}")
        text, counts, seconds = run_eval_cli(label, module, _cli_flags(inputs, dataset, folder, *flags))
        want = {**dict.fromkeys(_COUNTERS, 0), **{k: n * batches for k, n in per_batch.items()}}
        if counts != want:
            fail(f"evaluation ({label}) launched {counts}, expected {want}")
        f32_launches += counts["flash_fwd_f32"]
        fps, summary = check_eval_summary(label, text, folder)

        # the same function the CLI evaluated with: the eval loop again, warm
        # (the CLI's fps includes its first batch), and its first batch alone
        _, ds, config, infer = eval_model(inputs, dataset, *flags)
        _, warm_s = collect_detections(ds, infer, config, batch_size=EVAL_BATCH)
        rgb, event = first_batch(ds, config)
        dev_ms, _ = cuda_ms(lambda: infer(rgb, event), reps=5, warmup=1)
        loop_ms = 1e3 * warm_s / batches
        print(f"evaluation ({label}): {fps:.2f} img/s end to end by the CLI ({EVAL_IMAGES} images, "
              f"batch {EVAL_BATCH}: loading, transfer, forward, decode, NMS, host copy; first batch "
              f"included), {EVAL_IMAGES / warm_s:.2f} img/s over the loop again warm ({loop_ms:.2f} "
              f"ms per batch); forward + decode + NMS {dev_ms:.2f} ms per batch (CUDA events), "
              f"{EVAL_BATCH * 1e3 / dev_ms:.1f} img/s; mAP {summary['mAP']:.4f}", flush=True)
        profile_pass(f"evaluation profile ({label}): one batch of {EVAL_BATCH}, idle share of the "
                     f"warm eval loop's ms per batch", lambda: infer(rgb, event), loop_ms, n_ops=8,
                     n_kernels=8)
        if label == "DSEC f32":
            check_rows_match_inference(ds, config, infer)
            check_f32_logits(infer.model, config, rgb, event, infer.eval_output)
            small = inputs["dsec_small"]
            sweep_ds = CSVDetectionDataset(config.geometry, small["annotations_csv"],
                                           small["class_map_csv"], small["event_dir"],
                                           small["img_dir"])
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            results = corruption_sweep(sweep_ds, infer, config, corruptions=CV2_FREE_CORRUPTIONS,
                                       severities=EVAL_SEVERITIES, batch_size=EVAL_BATCH,
                                       save_root=str(root / "sweep"))
            counts = _counts()
            runs = len(CV2_FREE_CORRUPTIONS) * len(EVAL_SEVERITIES)
            print(f"corruption sweep (DSEC f32, {EVAL_SWEEP_IMAGES} images): "
                  f"{len(CV2_FREE_CORRUPTIONS)} OpenCV-free corruptions x severities "
                  f"{EVAL_SEVERITIES} in {time.perf_counter() - t0:.1f} s; launches "
                  f"{json.dumps(counts)}", flush=True)
            for corruption, per_sev in results.items():
                print(f"  {corruption}: " + ", ".join(
                    f"s{sev} mAP {sum(v) / len(v):.4f}" for sev, v in per_sev.items()), flush=True)
            values = [a for per_sev in results.values() for v in per_sev.values() for a in v]
            if (sorted(results) != sorted(CV2_FREE_CORRUPTIONS)
                    or any(sorted(v) != list(EVAL_SEVERITIES) for v in results.values())
                    or not all(math.isfinite(a) and 0 <= a <= 1 for a in values)
                    or counts["flash_fwd_f32"] != 4 * runs):
                fail(f"corruption sweep: results {results}, launches {counts}")
            write_corruption_artifacts(results, [ds.label_to_name(i) for i in range(3)],
                                       str(root / "sweep"))
        del infer, rgb, event
        torch.cuda.empty_cache()
    kernel_rows["flash_fwd_f32"]["launches"] = f32_launches

    # the folder protocol through the CLI, at bf16 over the small fixture
    tree = write_corruption_tree(inputs, root / "corruptions", group=0)
    folder = str(root / "eval_folder")
    text, counts, _ = run_eval_cli(
        "folder protocol, DSEC bf16", "test",
        _cli_flags(inputs, "dsec_small", folder, "--compute_dtype", "bfloat16", "--eval_corruption",
                   "--corruption_group", "0", "--corruption_root", str(tree)))
    with open(Path(folder) / "corruption_aps.pkl", "rb") as f:
        results = pickle.load(f)
    runs = len(CORRUPTION_GROUPS[0]) * len(SEVERITIES)
    values = [a for per_sev in results.values() for v in per_sev.values() for a in v]
    if (sorted(results) != sorted(CORRUPTION_GROUPS[0])
            or not all((Path(folder) / f"{c}_ap.txt").is_file() for c in results)
            or not all(math.isfinite(a) and 0 <= a <= 1 for a in values)
            or counts != {**dict.fromkeys(_COUNTERS, 0), "flash_fwd": 4 * runs}):
        fail(f"folder protocol: results {results}, launches {counts}")
    print(f"folder protocol: {runs} evaluations, artifacts {sorted(p.name for p in Path(folder).iterdir() if p.suffix in ('.txt', '.pkl'))}", flush=True)
    check_small_eval_card_vs_cpu(inputs, root)


def _batch_grads(state, config, batch):
    """Loss and parameter gradients of one batch, RGB kept (no dropout), with
    no change to the train state."""
    from frn_tpu_torch.models.detector import detection_loss

    cls, reg = state.model(batch["rgb"], batch["event"], train=True, drop=False)
    loss = sum(detection_loss(cls, reg, batch["annot"], config))
    return loss.detach(), torch.autograd.grad(loss, state.params)


# each kernel's launch counter: (module, attribute)
_COUNTERS = {"flash_fwd": ("flash_attention", "flash_fwd_launches"),
             "flash_fwd_f32": ("flash_attention", "flash_fwd_f32_launches"),
             "flash_fwd_lse": ("flash_attention", "flash_fwd_lse_launches"),
             "flash_bwd_dq": ("flash_attention", "flash_bwd_dq_launches"),
             "flash_bwd_dkv": ("flash_attention", "flash_bwd_dkv_launches"),
             "flash_fwd_lse_f32": ("flash_attention", "flash_fwd_lse_f32_launches"),
             "flash_bwd_dq_f32": ("flash_attention", "flash_bwd_dq_f32_launches"),
             "flash_bwd_dkv_f32": ("flash_attention", "flash_bwd_dkv_f32_launches"),
             "flash_fwd_bf16exp": ("flash_attention", "flash_fwd_bf16exp_launches"),
             "flash_int8_qk": ("flash_attention", "flash_int8_qk_launches"),
             "flash_int8": ("flash_attention", "flash_int8_launches"),
             "int8_qk_prepass": ("flash_attention", "int8_qk_prepass_launches"),
             "int8_prepass": ("flash_attention", "int8_prepass_launches"),
             "stem": ("stem", "stem_launches")}


def _counter_modules():
    from frn_tpu_torch.ops import flash_attention, stem
    return {"flash_attention": flash_attention, "stem": stem}


def _reset_counts() -> None:
    mods = _counter_modules()
    for module, attr in _COUNTERS.values():
        setattr(mods[module], attr, 0)


def _counts() -> dict:
    mods = _counter_modules()
    return {kind: getattr(mods[module], attr) for kind, (module, attr) in _COUNTERS.items()}


def phase_training(kernel_rows, inputs: dict, root: Path) -> None:
    """The training path through ``frn_tpu_torch.entry.train_entry``: DSEC
    480x640 fusion R50 bf16 at batch TRAIN_BATCH, Adam, accum_steps 2.
    ``Trainer.fit`` over 48 seeded samples (6 micro-steps, 3 optimizer steps)
    with its periodic evaluation after the epoch (``cli.common.make_eval_fn``
    over the small DSEC fixture of ``inputs``) and a checkpoint directory
    under ``root``, launch counts zeroed just before and read just after;
    the best-mAP checkpoint must be written. Then timed micro-steps, the
    batch's gradients against the plain attention, a checkpoint round trip,
    a profile pass, and a small f32 train step on the card against the CPU."""
    from frn_tpu_torch.cli.common import make_eval_fn
    from frn_tpu_torch.data.csv_dataset import CSVDetectionDataset
    from frn_tpu_torch.entry import train_entry
    from frn_tpu_torch.ops import flash_attention as fa
    from frn_tpu_torch.train.checkpoint import CheckpointManager

    trainer, batch = train_entry(device="cuda", batch=TRAIN_BATCH, num_samples=TRAIN_SAMPLES)
    state, cfg = trainer.state, trainer.config
    steps = TRAIN_SAMPLES // TRAIN_BATCH
    fix = inputs["dsec_small"]
    eval_ds = CSVDetectionDataset(cfg.geometry, fix["annotations_csv"], fix["class_map_csv"],
                                  fix["event_dir"], fix["img_dir"])
    trainer.eval_fn, trainer.eval_every = make_eval_fn(cfg, eval_ds, EVAL_BATCH), 1
    trainer.ckpt = CheckpointManager(str(root / "train_checkpoints"))

    # fit, watching every micro-step: its metrics and how far the params moved
    record = []
    step_fn = trainer.step_fn

    def watched(st, b, gen):
        before = [p.detach().clone() for p in st.params]
        metrics = step_fn(st, b, gen)
        moved = torch.stack([(p.detach() - q).abs().max() for p, q in zip(st.params, before)]).max()
        record.append((metrics, moved))
        return metrics

    trainer.step_fn = watched
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    trainer.fit(epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _counts()
    trainer.step_fn = step_fn
    print(f"training: Trainer.fit(epochs=1), {len(record)} micro-steps of batch {TRAIN_BATCH} and "
          f"an evaluation of {len(eval_ds)} images in {fit_s:.2f} s; flash launches "
          f"{json.dumps(counts)}", flush=True)
    eval_batches = -(-len(eval_ds) // EVAL_BATCH)
    want = {**dict.fromkeys(_COUNTERS, 0), "flash_fwd_lse": 4 * steps,
            "flash_bwd_dq": 4 * steps, "flash_bwd_dkv": 4 * steps, "flash_fwd": 4 * eval_batches}
    if len(record) != steps or counts != want:
        fail(f"fit ran {len(record)} micro-steps with launches {counts}, expected {steps} and {want}")
    best = trainer.ckpt.path(1)
    saved = torch.load(best, map_location="cpu", weights_only=True)
    print(f"training: periodic evaluation mAP {trainer.best_map:.4f}; best checkpoint "
          f"{Path(best).name} with best_map {saved.get('best_map')}", flush=True)
    if not (0.0 <= trainer.best_map <= 1.0 and saved.get("best_map") == trainer.best_map
            and saved["epoch"] == 1):
        fail(f"the trainer's periodic evaluation wrote no best checkpoint ({trainer.best_map})")
    trainer.ckpt, trainer.eval_fn = None, None
    del saved
    for i, (metrics, moved) in enumerate(record):
        loss, moved = metrics["loss"].item(), moved.item()
        print(f"  micro-step {i + 1}: loss {loss:.5f} (cls {metrics['cls_loss'].item():.5f} reg "
              f"{metrics['reg_loss'].item():.5f}), skipped {metrics['skipped'].item():.0f}, "
              f"max |param change| {moved:.3e}", flush=True)
        boundary = (i + 1) % cfg.train.accum_steps == 0
        if not math.isfinite(loss) or metrics["skipped"].item() != 0:
            fail(f"micro-step {i + 1}: loss {loss}")
        if boundary != (moved > 0):
            fail(f"micro-step {i + 1}: params {'unchanged' if boundary else 'moved'} "
                 f"against the accumulation boundary")
    for key in TRAIN_KERNELS:
        kernel_rows[key]["launches"] = counts[key]

    # timed micro-steps on the example batch
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times = []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step_fn(state, batch, trainer.generator)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    ms, median = statistics.mean(times), statistics.median(times)
    print(f"training path: DSEC 480x640 fusion R50 bf16 batch {TRAIN_BATCH}: {ms:.2f} ms per "
          f"micro-step, median {median:.2f} (runs {', '.join(f'{t:.2f}' for t in times)}), "
          f"{TRAIN_BATCH * 1e3 / ms:.1f} img/s (median {TRAIN_BATCH * 1e3 / median:.1f}), "
          f"peak memory {peak / 2**30:.2f} GiB; flash launches {json.dumps(counts)}", flush=True)
    if counts != {k: v // steps * TRAIN_TIMED for k, v in want.items()}:
        fail(f"timed micro-steps launched {counts}")

    # the same batch's gradients with the plain attention in place of the kernels
    loss_k, grads_k = _batch_grads(state, cfg, batch)
    # FlashAttentionFn looks both functions up when it runs
    kernel_fns = fa.flash_attention, fa.flash_attention_backward
    fa.flash_attention, fa.flash_attention_backward = (fa.flash_attention_plain,
                                                       fa.flash_attention_backward_plain)
    try:
        loss_p, grads_p = _batch_grads(state, cfg, batch)
    finally:
        fa.flash_attention, fa.flash_attention_backward = kernel_fns
    num = torch.stack([(a.float() - b.float()).norm() for a, b in zip(grads_k, grads_p)]).norm()
    den = torch.stack([b.float().norm() for b in grads_p]).norm()
    rel = (num / den).item()
    worst = max((((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item(), name)
                for a, b, name in zip(grads_k, grads_p, state.names))
    print(f"training gradients, kernels vs plain attention (batch {TRAIN_BATCH}): loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f}; |g_kernel - g_plain| / |g_plain| over all params {rel:.3e}; "
          f"worst tensor max|diff|/max|ref| {worst[0]:.3e} ({worst[1]})", flush=True)
    if not rel <= TRAIN_GRAD_REL_TOL:
        fail(f"training gradients disagree with the plain attention run ({rel:.3e})")
    del grads_k, grads_p
    check_resume(trainer, batch)
    # one accumulation cycle: its micro-steps, one of them with the Adam step
    cycle = cfg.train.accum_steps

    def one_cycle():
        for _ in range(cycle):
            trainer.step_fn(state, batch, trainer.generator)

    profile_pass(f"training profile: one accumulation cycle, {cycle} micro-steps of batch "
                 f"{TRAIN_BATCH}", one_cycle, cycle * median, n_ops=20, n_kernels=15)
    phase_small_train_reference()


def check_resume(trainer, batch) -> None:
    """A checkpoint round trip on the card: save, take one accumulation cycle
    (the params move), then ``Trainer.resume`` must bring back the params, the
    gradient sum, the counters and the dropout generator's state."""
    from frn_tpu_torch.train.checkpoint import CheckpointManager

    state = trainer.state
    with tempfile.TemporaryDirectory() as tmp:
        trainer.ckpt = CheckpointManager(tmp)
        trainer._save()
        saved = [t.detach().clone() for t in (*state.params, *state.acc_grads)]
        counters = (state.step, state.opt_steps, state.mini_step)
        gen_state = trainer.generator.get_state()
        for _ in range(trainer.config.train.accum_steps):
            trainer.step_fn(state, batch, trainer.generator)
        moved = max((p.detach() - q).abs().max().item() for p, q in zip(state.params, saved))
        if not trainer.resume():
            fail("Trainer.resume found no checkpoint")
        trainer.ckpt = None
    now = [t.detach() for t in (*state.params, *state.acc_grads)]
    back = max((a - b).abs().max().item() for a, b in zip(now, saved))
    print(f"checkpoint round trip on the card: params moved {moved:.3e} after save, "
          f"max |restored - saved| {back:.3e}", flush=True)
    if not (moved > 0 and back == 0 and (state.step, state.opt_steps, state.mini_step) == counters
            and torch.equal(trainer.generator.get_state(), gen_state)):
        fail("Trainer.resume on the card did not restore the saved state")


def phase_small_train_reference() -> None:
    """A small f32 fusion model: one micro-step on the card against the same
    micro-step on the CPU (loss, and the running gradient sum it leaves)."""
    from frn_tpu_torch import config as c
    from frn_tpu_torch.data.collate import collate_fixed
    from frn_tpu_torch.data.synthetic import box_samples
    from frn_tpu_torch.models.detector import init_detector
    from frn_tpu_torch.train.loop import create_train_state, make_train_step

    geo = dataclasses.replace(c.DSEC, height=64, width=96)
    cfg = c.FrameworkConfig(geometry=geo, model=c.ModelConfig(
        variant="fusion", depth=18, num_classes=3, feature_size=32, attention_chunk=64),
        train=c.TrainConfig(batch_size=2, max_annots_per_image=4))
    cpu_model = init_detector(cfg, seed=6, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = collate_fixed(box_samples(2, geo, seed=7), geo, 4, 2)
    step = make_train_step(cfg)
    results = []
    for model in (cpu_model, gpu_model):
        state = create_train_state(cfg, model=model)
        metrics = step(state, batch, torch.Generator().manual_seed(8))
        results.append((metrics["loss"].item(), [a.cpu() for a in state.acc_grads]))
    (loss_cpu, acc_cpu), (loss_gpu, acc_gpu) = results
    worst = max(((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
                for g, w in zip(acc_gpu, acc_cpu))
    print(f"small f32 train step, card vs CPU: loss {loss_gpu:.6f} vs {loss_cpu:.6f}; "
          f"gradient sum, worst tensor max|diff|/max|ref| {worst:.3e}", flush=True)
    if not (abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu) and worst <= 1e-3):
        fail("small f32 train step disagrees between card and CPU")


# the f32 training path (phase 9): each train CLI run, its fixture, the
# flags beyond the common ones and launches per micro-step of each f32
# training kernel; DSEC's run also evaluates (B1 at f32, 4 per eval batch)
F32_TRAIN_RUNS = (("DSEC f32", "train", "dsec", F32_TRAIN_BATCH, 4),
                  ("DDD17 f32 (train_ddd17)", "train_ddd17", "ddd17", DDD17_TRAIN_BATCH, 2))
F32_TRAIN_TIMED = 5
# the f32 micro-step's gradients at the checkpoint's weights with the
# kernels vs with the plain attention, per tensor, as max|diff| over the
# tensor's max|ref|, and over all parameters, as the global norm of the
# difference over that of the reference. The attention outputs differ by a
# few ulps (FLASH_F32_*, BWD_F32_*) and every other layer computes in f32,
# but at these seeded weights (losses near 4e4) a tensor's gradient can be
# a sum that cancels to a small share of its terms: a witness, the plain
# attention with each output moved by one ulp up or down, moved the worst
# tensor's gradient by 2.34e-2 of its largest element and all of them by
# 2.6e-3 in norm, where the kernels moved them by 8.7e-3 to 9.3e-3 and by
# 2.78e-4, and the kernels run twice by 1e-4 to 4.7e-4 and 8e-7 (four runs,
# NVIDIA H100 80GB HBM3, 700.00 W). A per-tensor gate of 1e-4 is under the
# witness's effect, so the per-tensor gate is 3e-2 (the witness's worst,
# rounded up) and the global gate 2e-3 (under the witness's: the kernels
# may move the gradients less than one ulp of the attention does). Phase 9
# prints the witness beside them. The theta biases of the cross-attention
# are the exception: a per-query constant added to every score leaves the
# softmax unchanged, so their gradients are zero in exact arithmetic and
# what either run computes is rounding noise; they are held at
# F32_GRAD_REL_TOL of the model's largest gradient instead
F32_GRAD_REL_TOL, F32_GRAD_NORM_TOL = 3e-2, 2e-3


def _train_cli_flags(inputs: dict, dataset: str, root: Path, batch: int, *more) -> list:
    fix = inputs[dataset]
    return ["--csv_train", fix["annotations_csv"], "--csv_classes", fix["class_map_csv"],
            "--root_img", fix["img_dir"], "--root_event", fix["event_dir"],
            "--compute_dtype", "float32", "--batch_size", str(batch), "--epochs", "1",
            "--continue_training", "--checkpoint", inputs[f"{dataset}_pth"],
            "--checkpoint_dir", str(root / f"train_{dataset}"), *more]


def phase_train_f32(kernel_rows, inputs: dict, root: Path) -> None:
    """The f32 training path through ``python -m frn_tpu_torch.cli.train`` (its
    ``main``) on the card, full width (fusion ResNet-50, feature size 256,
    --compute_dtype float32), from the seeded ``.pth`` files of
    ``write_eval_inputs``: DSEC at batch 2 over EVAL_IMAGES images, one epoch,
    with the periodic evaluation (--csv_test over the small DSEC fixture,
    --eval_every 1); then ``train_ddd17`` (batch 4) over the DDD17 fixture.
    Each run with the launch counts zeroed just before and read just after,
    its losses finite (no micro-step skipped) and its checkpoint written (at
    DSEC the best-mAP one). Then, on the trainer the CLI builds, one
    micro-step's gradients at the checkpoint's weights against the plain
    attention, timed DSEC f32 micro-steps and a profiler pass."""
    from frn_tpu_torch.cli import common, train
    from frn_tpu_torch.data.collate import collate_fixed
    from frn_tpu_torch.data.loader import to_device
    from frn_tpu_torch.ops import flash_attention as fa
    from frn_tpu_torch.train.checkpoint import CheckpointManager
    from frn_tpu_torch.train.trainer import Trainer

    print(f"f32 training on {card_name_and_power_limit()}", flush=True)
    small = inputs["dsec_small"]
    launches = dict.fromkeys(TRAIN_F32_KERNELS, 0)
    for label, module, dataset, batch, per_step in F32_TRAIN_RUNS:
        more = (["--csv_test", small["annotations_csv"], "--eval_every", "1"]
                if dataset == "dsec" else [])
        history, text, counts, seconds = run_cli(
            f"train CLI, {label}, batch {batch}", module,
            _train_cli_flags(inputs, dataset, root, batch, *more))
        steps = EVAL_IMAGES // batch
        eval_batches = -(-EVAL_SWEEP_IMAGES // EVAL_BATCH) if more else 0
        want = {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_F32_KERNELS, per_step * steps),
                "flash_fwd_f32": 4 * eval_batches}
        if counts != want:
            fail(f"train CLI ({label}) launched {counts}, expected {want}")
        if not (len(history) == 1 and math.isfinite(history[0])) or "skipped" in text:
            fail(f"train CLI ({label}): loss history {history}, a micro-step skipped or not finite")
        saved = torch.load(CheckpointManager(str(root / f"train_{dataset}")).path(1),
                           map_location="cpu", weights_only=True)
        if saved["epoch"] != 1 or (more and not (0.0 <= saved["best_map"] <= 1.0
                                                and "epoch 1: mAP" in text)):
            fail(f"train CLI ({label}) wrote no (best-mAP) checkpoint of epoch 1")
        print(f"train CLI ({label}): {steps} micro-steps of batch {batch}"
              f"{f' and an evaluation of {EVAL_SWEEP_IMAGES} images' if more else ''} in "
              f"{seconds:.1f} s (model build and loading included); mean loss {history[0]:.5f}; "
              f"checkpoint_1.pt with best_map {saved['best_map']}", flush=True)
        for key in TRAIN_F32_KERNELS:
            launches[key] += counts[key]
        del saved
    for key in TRAIN_F32_KERNELS:
        kernel_rows[key]["launches"] = launches[key]

    # the trainer the CLI builds, on the fixture's first batch
    args = train.get_parser().parse_args(_train_cli_flags(inputs, "dsec", root, F32_TRAIN_BATCH))
    device = common.setup_device(args)
    ds = common.build_csv_dataset(args, args.csv_train)
    cfg = common.build_config(args, ds.num_classes(), args.batch_size, args.epochs)
    trainer = Trainer(cfg, ds, device=device)
    common.load_checkpoint_into_state(args, trainer.state)
    state, b = trainer.state, F32_TRAIN_BATCH
    batch = to_device(collate_fixed([ds[i] for i in range(b)], cfg.geometry,
                                    cfg.train.max_annots_per_image, b), device)
    # one micro-step's gradients at the checkpoint's weights (before any
    # step, so that every run compares at the same state): the kernels, the
    # kernels again (the run to run spread of the other layers), the plain
    # attention, and a witness of what f32 rounding of the attention alone
    # does: the plain attention with each of its outputs moved by one ulp,
    # up or down (seeded)
    gen = torch.Generator(device=device).manual_seed(21)

    def plain_one_ulp(q, k, v, return_lse=False):
        o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
        up = torch.randint(0, 2, o.shape, generator=gen, device=o.device).bool()
        o = torch.nextafter(o, torch.where(up, math.inf, -math.inf))
        return (o, lse) if return_lse else o

    grads = {"kernels": _batch_grads(state, cfg, batch)[1],
             "kernels again": _batch_grads(state, cfg, batch)[1]}
    kernel_fns = fa.flash_attention, fa.flash_attention_backward
    try:
        for label, fwd in (("plain", fa.flash_attention_plain), ("plain, one ulp", plain_one_ulp)):
            fa.flash_attention, fa.flash_attention_backward = fwd, fa.flash_attention_backward_plain
            grads[label] = _batch_grads(state, cfg, batch)[1]
    finally:
        fa.flash_attention, fa.flash_attention_backward = kernel_fns
    worst = {}
    for label, ref in (("kernels", "plain"), ("kernels again", "kernels"),
                       ("plain, one ulp", "plain")):
        worst[label] = _worst_grad_gap(state.names, grads[label], grads[ref])
        (gap, name), bias_gap, norm_gap = worst[label]
        print(f"f32 training gradients (batch {b}, one micro-step), {label} vs {ref}: worst tensor "
              f"max|diff|/max|ref| {gap:.3e} ({name}); theta biases max|diff| over the largest "
              f"gradient {bias_gap:.3e}; |diff|/|ref| over all params {norm_gap:.3e}", flush=True)
    (gap, name), bias_gap, norm_gap = worst["kernels"]
    print(f"f32 training gradients, kernels vs plain attention: gates {F32_GRAD_REL_TOL:.0e} per "
          f"tensor, {F32_GRAD_NORM_TOL:.0e} over all params", flush=True)
    if not (gap <= F32_GRAD_REL_TOL and bias_gap <= F32_GRAD_REL_TOL
            and norm_gap <= F32_GRAD_NORM_TOL):
        fail(f"f32 training gradients disagree with the plain attention ({gap:.3e} at {name}, "
             f"theta biases {bias_gap:.3e}, over all params {norm_gap:.3e})")
    del grads

    # timed micro-steps
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    host, dev = [], []
    for _ in range(F32_TRAIN_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        trainer.step_fn(state, batch, trainer.generator)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    ms, median = statistics.mean(host), statistics.median(host)
    print(f"f32 training path: DSEC 480x640 fusion R50 f32 batch {b}: {ms:.2f} ms per micro-step "
          f"(host clock), median {median:.2f} (runs {', '.join(f'{t:.2f}' for t in host)}); CUDA "
          f"events {statistics.mean(dev):.2f} ms, median {statistics.median(dev):.2f}; "
          f"{b * 1e3 / ms:.2f} img/s (median {b * 1e3 / median:.2f}), peak memory "
          f"{peak / 2**30:.2f} GiB; flash launches {json.dumps(counts)}", flush=True)
    if counts != {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_F32_KERNELS,
                                                                  4 * F32_TRAIN_TIMED)}:
        fail(f"timed f32 micro-steps launched {counts}")
    cycle = cfg.train.accum_steps

    def one_cycle():
        for _ in range(cycle):
            trainer.step_fn(state, batch, trainer.generator)

    profile_pass(f"f32 training profile: one accumulation cycle, {cycle} micro-steps of batch {b}",
                 one_cycle, cycle * median, n_ops=12, n_kernels=12)


def _worst_grad_gap(names, got, want):
    """((the largest per-tensor max|got - want| / max|want|, its tensor), the
    theta biases' largest max|got - want| over the largest |want| of the model
    (their gradients are zero in exact arithmetic), the global norm of the
    difference over that of ``want``)."""
    largest = max(w.abs().max().item() for w in want)
    worst, bias = (0.0, ""), 0.0
    for name, g, w in zip(names, got, want):
        scale, diff = w.abs().max().item(), (g - w).abs().max().item()
        if name.endswith("theta.bias"):
            bias = max(bias, diff / largest)
        else:
            worst = max(worst, (diff / scale if scale else (math.inf if diff else 0.0), name))
    norm = (torch.stack([(g - w).norm() for g, w in zip(got, want)]).norm()
            / torch.stack([w.norm() for w in want]).norm()).item()
    return worst, bias, norm


# ------------------------------------------------------------ raw DSEC-Det

# the raw DSEC-Det path (phase 10): a fixture of 3 sequences of 6 frames
# (15 samples) at 480x640; the train CLI's batch (3 micro-steps an epoch,
# drop_last) and the eval CLI's (2 batches, the second ragged)
DSEC_DET_SEQUENCES, DSEC_DET_FRAMES = 3, 6
DSEC_DET_TRAIN_BATCH = 4
DSEC_DET_WIRES = ("f32", "compact", "events")
# the compact and events wires' squash runs on the card (CUDA's tanhf), the
# f32 wire's in numpy on the host: 4 f32 ulps apart at most, as the CPU tests
# hold torch's tanh against numpy's and XLA's
WIRE_TANH_RTOL = 5e-7
# the events and f32 batches' losses (the same inputs up to those ulps)
WIRE_LOSS_RTOL = 1e-4
# warm epochs timed after each wire's first (3 micro-steps each)
DSEC_DET_WARM_EPOCHS = 2


class _ArrayEvents:
    """An in-memory event source with ``H5EventReader.window``'s semantics
    (the ms_to_idx table that ``write_event_h5`` writes, looked up as the
    reader looks it up): the card's machine has no h5py, so phase 10 keeps
    the fixture's event arrays in memory and hands each sequence one of
    these in place of its h5 reader. Everything else of the dataset runs."""

    def __init__(self, x, y, t_abs_us, p, t_offset=None):
        import numpy as np

        order = np.argsort(t_abs_us, kind="stable")
        self.x, self.y, self.p = x[order], y[order], p[order]
        t_abs_us = t_abs_us[order]
        self.t_offset = int(t_abs_us[0]) if t_offset is None else int(t_offset)
        self.t_rel = t_abs_us.astype(np.int64) - self.t_offset
        num_ms = int(self.t_rel[-1] / 1e3) + 2
        self.ms_to_idx = np.searchsorted(self.t_rel, np.arange(num_ms, dtype=np.int64) * 1000)

    def _ms_index(self, t_abs_us: int) -> int:
        ms = int((t_abs_us - self.t_offset) / 1e3)
        return int(self.ms_to_idx[max(0, min(ms, len(self.ms_to_idx) - 1))])

    def window(self, t0_us: int, t1_us: int) -> dict:
        i0, i1 = sorted((max(self._ms_index(t0_us), 0), max(self._ms_index(t1_us), 0)))
        return {"x": self.x[i0:i1], "y": self.y[i0:i1], "t": self.t_rel[i0:i1] + self.t_offset,
                "p": self.p[i0:i1]}


def write_dsec_det_inputs(root: Path):
    """The raw DSEC-Det fixture under ``root`` (the port's
    ``make_dsec_det_fixture``: PNGs, timestamps, tracks), its event arrays
    kept in memory instead of an h5 file: (fixture root, {sequence: source})."""
    from unittest import mock

    from frn_tpu_torch.config import DSEC_DET
    from frn_tpu_torch.data import synthetic

    streams = {}

    def keep(path, x, y, t_abs_us, p, t_offset=None):
        streams[Path(path).parents[2].name] = _ArrayEvents(x, y, t_abs_us, p, t_offset)

    t0 = time.perf_counter()
    with mock.patch.object(synthetic, "write_event_h5", keep):
        fixture = synthetic.make_dsec_det_fixture(
            str(root / "dsec_det"), num_sequences=DSEC_DET_SEQUENCES,
            frames_per_sequence=DSEC_DET_FRAMES, seed=17, geometry=DSEC_DET)
    print(f"raw DSEC-Det fixture: {DSEC_DET_SEQUENCES} sequences of {DSEC_DET_FRAMES} frames at "
          f"{DSEC_DET.height}x{DSEC_DET.width} in {time.perf_counter() - t0:.1f} s", flush=True)
    return fixture, streams


def _with_streams(dataset, streams):
    for seq in dataset.sequences:
        seq._events = streams[seq.name]
    return dataset


def _wire_batches(datasets, batch: int):
    """Each wire's samples in order, collated into batches of ``batch`` (the
    last one padded, as a loader without drop_last pads it)."""
    from frn_tpu_torch.data.collate import collate_fixed

    return {wire: [collate_fixed([ds[i] for i in range(j, min(j + batch, len(ds)))],
                                 ds.geometry, 64, batch) for j in range(0, len(ds), batch)]
            for wire, ds in datasets.items()}


def _collate_first(dataset, batch: int):
    """The first ``batch`` samples of ``dataset``, collated."""
    from frn_tpu_torch.data.collate import collate_fixed

    return collate_fixed([dataset[i] for i in range(batch)], dataset.geometry, 64, batch)


def _ulps(got, want) -> float:
    """The largest |got - want| in f32 ulps of |want| (a zero counts as
    the smallest normal's ulp)."""
    import numpy as np

    scale = np.spacing(np.maximum(np.abs(want), np.finfo(np.float32).tiny).astype(np.float32))
    return float((np.abs(got.astype(np.float64) - want) / scale).max())


def check_wires(datasets, streams) -> dict:
    """The three wires on every sample: the events wire's device voxel
    (``voxelize_events_batched`` on the card) against the host voxelizer's
    count grid of the same window, exactly; the compact wire's int8 counts
    against it, exactly; both wires' squashed grids on the card (the train
    step's ``make_batch_inputs``) against the f32 wire's host-squashed sample
    within WIRE_TANH_RTOL, and their RGB exactly. Prints each wire's h2d
    bytes per batch and the voxelization's device ms per batch. Returns
    {wire: bytes per batch}."""
    import numpy as np

    from frn_tpu_torch.config import FrameworkConfig, TrainConfig
    from frn_tpu_torch.data.loader import to_device
    from frn_tpu_torch.ops.voxelize import voxelize_events_batched, voxelize_events_np
    from frn_tpu_torch.train.loop import make_batch_inputs

    f32 = datasets["f32"]
    geo = f32.geometry
    b = DSEC_DET_TRAIN_BATCH
    batches = _wire_batches(datasets, b)
    # the host voxelizer's count grid of each sample's window, from the source
    counts = []
    for si, i0, _ in f32._index:
        ts0 = int(f32.sequences[si].timestamps[i0])
        ev = streams[f32.sequences[si].name].window(ts0 - f32.time_window_us, ts0)
        counts.append(np.transpose(voxelize_events_np(
            ev["x"].astype(np.int64), ev["y"].astype(np.int64), ev["t"], ev["p"],
            geo.event_channels, geo.height, geo.width), (1, 2, 0)))
    pad = -len(counts) % b  # the last batch's pad rows hold no events
    counts = np.concatenate([np.stack(counts), np.zeros((pad,) + counts[0].shape, np.float32)])
    n_events = [int(datasets["events"][i]["event_n"]) for i in range(len(f32))]
    if max(n_events) >= datasets["events"].event_capacity:
        fail(f"raw DSEC-Det: a window fills the events wire's capacity ({max(n_events)})")
    for i in range(len(f32)):
        compact = datasets["compact"][i]["event"]
        if not np.array_equal(compact, np.clip(np.rint(counts[i]), -127, 127).astype(np.int8)):
            fail(f"raw DSEC-Det: the compact wire's counts of sample {i} differ from the host's")
    nbytes, gaps, vox_ms = {}, {"compact": 0.0, "events": 0.0}, 0.0
    for k, f32_batch in enumerate(batches["f32"]):
        for wire in DSEC_DET_WIRES:
            batch = batches[wire][k]
            nbytes[wire] = sum(a.nbytes for a in batch.values())
            if wire == "f32":
                continue
            dev = to_device(batch, "cuda")
            if wire == "events":
                def vox():
                    return voxelize_events_batched(
                        dev["event_x"], dev["event_y"], dev["event_t"], dev["event_p"],
                        dev["event_n"], geo.event_channels, geo.height, geo.width)
                ms, grid = cuda_ms(vox, reps=20)
                vox_ms += ms / len(batches["f32"])
                if not np.array_equal(grid.cpu().numpy(), counts[k * b:(k + 1) * b]):
                    fail(f"raw DSEC-Det: the device voxel of batch {k} differs from the host's")
            config = FrameworkConfig(geometry=geo, train=TrainConfig(input_wire=wire))
            rgb, event = (x.cpu().numpy() for x in make_batch_inputs(config)(dev))
            if not np.array_equal(rgb, f32_batch["rgb"]):
                fail(f"raw DSEC-Det: the {wire} wire's RGB of batch {k} differs from the f32 wire's")
            if not np.allclose(event, f32_batch["event"], rtol=WIRE_TANH_RTOL, atol=0):
                fail(f"raw DSEC-Det: the {wire} wire's squashed voxel of batch {k} is "
                     f"{_ulps(event, f32_batch['event']):.1f} ulps off the f32 wire's")
            gaps[wire] = max(gaps[wire], _ulps(event, f32_batch["event"]))
    print(f"raw DSEC-Det wires, {len(f32)} samples ({min(n_events)} to {max(n_events)} events a "
          f"window): the events wire's device voxel equals the host count grid exactly, the "
          f"compact wire's int8 counts too; squashed on the card vs the f32 wire's host squash: "
          f"compact {gaps['compact']:.1f} ulps, events {gaps['events']:.1f} ulps (at most "
          f"{WIRE_TANH_RTOL:.0e} relative); RGB exact", flush=True)
    print(f"raw DSEC-Det wires, h2d bytes per batch of {b}: "
          + ", ".join(f"{w} {nbytes[w]}" for w in DSEC_DET_WIRES)
          + f"; device voxelization {vox_ms:.4f} ms per batch of {b} (CUDA events) on "
          f"{card_name_and_power_limit()}", flush=True)
    return nbytes


def _loader_ms(dataset, batch: int) -> float:
    """Host ms per batch of the train loader's work (load, voxelize on the
    f32 and compact wires, collate), on one thread."""
    from frn_tpu_torch.data.loader import BatchLoader

    loader = BatchLoader(dataset, dataset.geometry, batch_size=batch, num_threads=0,
                         drop_last=True)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) * 1e3 / n


def _wire_grads(state, config, batch):
    """Loss and gradients of one micro-step on ``batch`` of the config's wire
    (its inputs made on the card as the train step makes them)."""
    from frn_tpu_torch.data.loader import to_device
    from frn_tpu_torch.train.loop import make_batch_inputs

    b = to_device(batch, "cuda")
    rgb, event = make_batch_inputs(config)(b)
    return _batch_grads(state, config, {"rgb": rgb, "event": event, "annot": b["annot"]})


def check_wire_grads(trainer, datasets, when: str, gate: bool) -> None:
    """One micro-step's loss and gradients of ``trainer`` (the events wire's)
    on the first batch through the events batch and through the f32 batch of
    the same samples, beside the f32 batch again (the run to run spread) and
    a witness: the f32 batch with its voxel moved one ulp up or down
    (seeded). With ``gate``, the losses within WIRE_LOSS_RTOL and the
    gradients within the phase-9 gate (F32_GRAD_REL_TOL, F32_GRAD_NORM_TOL)."""
    state, config = trainer.state, trainer.config
    f32_config = dataclasses.replace(config, train=dataclasses.replace(config.train,
                                                                       input_wire="f32"))
    f32_batch = _collate_first(datasets["f32"], DSEC_DET_TRAIN_BATCH)
    loss_ev, g_ev = _wire_grads(state, config, _collate_first(datasets["events"],
                                                            DSEC_DET_TRAIN_BATCH))
    loss_f32, g_f32 = _wire_grads(state, f32_config, f32_batch)
    _, g_again = _wire_grads(state, f32_config, f32_batch)
    gen = torch.Generator().manual_seed(23)
    ulp = dict(f32_batch)
    ev = torch.from_numpy(ulp["event"])
    up = torch.randint(0, 2, ev.shape, generator=gen).bool()
    ulp["event"] = torch.nextafter(ev, torch.where(up, math.inf, -math.inf)).numpy()
    _, g_ulp = _wire_grads(state, f32_config, ulp)
    print(f"raw DSEC-Det micro-step {when} (batch {DSEC_DET_TRAIN_BATCH}), events wire vs f32 "
          f"wire: loss {loss_ev.item():.6f} vs {loss_f32.item():.6f}", flush=True)
    worst = {}
    for label, got in (("events", g_ev), ("f32 again", g_again), ("f32, one ulp", g_ulp)):
        worst[label] = _worst_grad_gap(state.names, got, g_f32)
        (gap, name), bias_gap, norm_gap = worst[label]
        print(f"raw DSEC-Det gradients {when}, {label} vs f32: worst tensor max|diff|/max|ref| "
              f"{gap:.3e} ({name}); theta biases {bias_gap:.3e}; over all params {norm_gap:.3e}",
              flush=True)
    if not gate:
        return
    (gap, name), bias_gap, norm_gap = worst["events"]
    print(f"raw DSEC-Det gradients {when}, events vs f32: gates {F32_GRAD_REL_TOL:.0e} per "
          f"tensor, {F32_GRAD_NORM_TOL:.0e} over all params; losses within {WIRE_LOSS_RTOL:.0e}",
          flush=True)
    if not abs(loss_ev.item() - loss_f32.item()) <= WIRE_LOSS_RTOL * abs(loss_f32.item()):
        fail(f"raw DSEC-Det: the events and f32 batches' losses disagree {when}")
    if not (gap <= F32_GRAD_REL_TOL and bias_gap <= F32_GRAD_REL_TOL
            and norm_gap <= F32_GRAD_NORM_TOL):
        fail(f"raw DSEC-Det: the events batch's gradients disagree with the f32 batch's {when} "
             f"({gap:.3e} at {name}, theta biases {bias_gap:.3e}, over all params {norm_gap:.3e})")


def phase_dsec_det(kernel_rows, root: Path) -> None:
    """The raw DSEC-Det path on the card at full width (DSEC-Det 480x640,
    fusion ResNet-50, feature size 256, f32: the CLIs' defaults), through the
    two CLIs' own helpers (``train_dsec_det_fast``: ``train_dataset``,
    ``build_config``, then ``Trainer.fit`` as its ``main`` runs it;
    ``test_dsec_det``: ``eval_dataset``, ``build_config``,
    ``build_inference_fn``, then ``evaluate_dataset``), each dataset's
    sequences reading their events from memory (``_ArrayEvents``: no h5py
    there). The wires checked on every sample (``check_wires``); one epoch
    on each wire at batch 4, launch counts zeroed just before and read just
    after (B1-lse, B2a and B2b at f32 4 times a micro-step, nothing else),
    losses finite, skipped micro-steps counted, the checkpoint written, img/s
    and the loader's host ms per batch, warm epochs' idle share; the events
    batch's loss and gradients against the f32 batch's on the same samples
    at the events trainer's initial weights (``check_wire_grads``: the
    phase-9 gate, beside a one-ulp witness; printed again after the epochs,
    where the losses are far above the skip threshold); then the
    evaluation of the events run's checkpoint on the f32 and compact wires
    at batch 8 (B1 at f32 4 times a batch, nothing else; the summary in
    [0, 1]; fps and idle share) and the two wires' logits on one batch."""
    import contextlib
    import io
    import re

    from frn_tpu_torch.cli import common
    from frn_tpu_torch.cli import test_dsec_det as eval_cli
    from frn_tpu_torch.cli import train_dsec_det_fast as train_cli
    from frn_tpu_torch.data.loader import to_device
    from frn_tpu_torch.eval.detections import collect_detections
    from frn_tpu_torch.eval.evaluator import evaluate_dataset
    from frn_tpu_torch.train.checkpoint import CheckpointManager
    from frn_tpu_torch.train.trainer import Trainer

    print(f"raw DSEC-Det path on {card_name_and_power_limit()}", flush=True)
    started = time.perf_counter()

    def mark(what):
        print(f"[phase 10 at {time.perf_counter() - started:.1f} s] {what}", flush=True)

    fixture, streams = write_dsec_det_inputs(root)

    def train_args(wire):
        return train_cli.get_parser().parse_args(
            ["--dataset_root", fixture, "--wire", wire, "--epochs", "1", "--checkpoint_dir",
             str(root / f"dsec_det_{wire}")])

    datasets = {w: _with_streams(train_cli.train_dataset(train_args(w)), streams)
                for w in DSEC_DET_WIRES}
    if len(datasets["f32"]) != DSEC_DET_SEQUENCES * (DSEC_DET_FRAMES - 1):
        fail(f"raw DSEC-Det: {len(datasets['f32'])} samples")
    nbytes = check_wires(datasets, streams)
    mark("wires checked")

    b = DSEC_DET_TRAIN_BATCH
    steps = len(datasets["f32"]) // b
    want = {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_F32_KERNELS, 4 * steps)}
    trainer = None
    for wire in DSEC_DET_WIRES:
        del trainer
        torch.cuda.empty_cache()
        args = train_args(wire)
        device = common.setup_device(args)
        ds = datasets[wire]
        config = train_cli.build_config(args, ds)
        trainer = Trainer(config, ds, checkpoint_dir=args.checkpoint_dir,
                          eval_every=args.eval_every, device=device)
        mark(f"{wire}: trainer built")
        if wire == "events":
            check_wire_grads(trainer, datasets, "at the initial weights", gate=True)
        buf = io.StringIO()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            history = trainer.fit(args.epochs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        text = buf.getvalue()
        skipped = re.search(r"skipped (\d+)/", text)
        skipped = int(skipped.group(1)) if skipped else 0
        print(f"--- train_dsec_det_fast --wire {wire} (Trainer.fit, {seconds:.1f} s)\n"
              f"{text.strip()}\n--- launches {json.dumps(counts)}", flush=True)
        if counts != want:
            fail(f"raw DSEC-Det training ({wire}) launched {counts}, expected {want}")
        if not (len(history) == 1 and math.isfinite(history[0])):
            fail(f"raw DSEC-Det training ({wire}): loss history {history}")
        if not Path(CheckpointManager(args.checkpoint_dir).path(1)).is_file():
            fail(f"raw DSEC-Det training ({wire}) wrote no checkpoint of epoch 1")
        for key in TRAIN_F32_KERNELS:
            kernel_rows[key]["launches"] += counts[key]
        mark(f"{wire}: one epoch trained")
        # the loop again warm (DSEC_DET_WARM_EPOCHS more epochs: the median
        # epoch's ms per micro-step), the step alone on a batch already on
        # the card, the loader's host work alone, and a profiled warm epoch
        epoch_ms = []
        with contextlib.redirect_stdout(io.StringIO()):
            for _ in range(DSEC_DET_WARM_EPOCHS):
                warm = trainer.train_epoch()
                epoch_ms.append(warm["epoch_time_s"] * 1e3)
        step_ms = statistics.median(epoch_ms) / steps
        dev = to_device(_collate_first(ds, b), device)
        alone = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.step_fn(trainer.state, dev, trainer.generator)
            torch.cuda.synchronize()
            alone.append((time.perf_counter() - t1) * 1e3)
        host_ms = _loader_ms(ds, b)
        print(f"raw DSEC-Det training ({wire}): {steps} micro-steps of batch {b}, mean loss "
              f"{history[0]:.5f}, skipped micro-steps {skipped}/{steps} (loss > 50 or not "
              f"finite); {steps * b / seconds:.2f} img/s over the first epoch (model build "
              f"excluded); warm, {DSEC_DET_WARM_EPOCHS} epochs: {b * 1e3 / step_ms:.2f} img/s, "
              f"{step_ms:.2f} ms per micro-step (median epoch; epochs "
              f"{', '.join(f'{t:.1f}' for t in epoch_ms)} ms); the step alone on a batch on the "
              f"card {statistics.median(alone):.2f} ms (host clock, median of 3); loader "
              f"{host_ms:.2f} ms of host work per batch on one thread; h2d {nbytes[wire]} bytes "
              f"per batch", flush=True)

        mark(f"{wire}: timed")
        profile_pass(f"raw DSEC-Det training profile ({wire}): one micro-step of batch {b}, idle "
                     f"share of the warm epochs' ms per micro-step",
                     lambda: trainer.step_fn(trainer.state, dev, trainer.generator), step_ms,
                     n_ops=4, n_kernels=4, n_host_ops=6)
        del dev
        mark(f"{wire}: profiled")

    # the same micro-step on the events trainer after its epochs, printed
    # only: the losses there are far above the skip threshold
    check_wire_grads(trainer, datasets, "after the epochs", gate=False)
    del trainer
    torch.cuda.empty_cache()
    mark("gradients compared")

    # evaluation of the events run's checkpoint on both eval wires
    logits, f32_launches = {}, 0
    for wire in ("f32", "compact"):
        args = eval_cli.get_parser().parse_args(
            ["--dataset_root", fixture, "--checkpoint", str(root / "dsec_det_events"),
             "--wire", wire])
        device = common.setup_device(args)
        ds = _with_streams(eval_cli.eval_dataset(args), streams)
        config = eval_cli.build_config(args, ds)
        infer = eval_cli.build_inference_fn(args, ds, config, device)
        torch.cuda.synchronize()
        _reset_counts()
        res = evaluate_dataset(ds, infer, config, batch_size=args.batch_size)
        torch.cuda.synchronize()
        counts = _counts()
        n_batches = -(-len(ds) // args.batch_size)
        if counts != {**dict.fromkeys(_COUNTERS, 0), "flash_fwd_f32": 4 * n_batches}:
            fail(f"raw DSEC-Det evaluation ({wire}) launched {counts}")
        f32_launches += counts["flash_fwd_f32"]
        values = list(res.summary.values()) + [a for v in res.per_class_aps.values() for a in v]
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values):
            fail(f"raw DSEC-Det evaluation ({wire}): summary {res.summary}")
        _, warm_s = collect_detections(ds, infer, config, batch_size=args.batch_size)
        loop_ms = warm_s * 1e3 / n_batches
        rgb, event = first_batch(ds, config)
        print(f"raw DSEC-Det evaluation (test_dsec_det --wire {wire}): {len(ds)} images in "
              f"{n_batches} batches of {args.batch_size}: fps {res.fps:.2f} (the CLI's), "
              f"{len(ds) / warm_s:.2f} img/s warm ({loop_ms:.2f} ms per batch); mAP "
              f"{res.summary['mAP']:.4f}; launches {json.dumps(counts)}", flush=True)
        profile_pass(f"raw DSEC-Det evaluation profile ({wire}): one batch of {args.batch_size}, "
                     f"idle share of the warm loop's ms per batch", lambda: infer(rgb, event),
                     loop_ms, n_ops=6, n_kernels=6)
        with torch.inference_mode():
            if wire == "compact":
                from frn_tpu_torch.ops.voxelize import normalize_event_voxel_batched

                rgb, event = rgb.float() / 255.0, normalize_event_voxel_batched(event.float())
            logits[wire] = infer.model(rgb, event, eval_output=infer.eval_output, train=False)[0]
        del infer, rgb, event
        torch.cuda.empty_cache()
        mark(f"evaluated on the {wire} wire")
    rel = ((logits["compact"] - logits["f32"]).abs().max() / logits["f32"].abs().max()).item()
    print(f"raw DSEC-Det evaluation logits, compact vs f32 wire (batch of {EVAL_BATCH}): "
          f"max|diff|/max|ref| {rel:.3e} (at most {EVAL_F32_REL_TOL:.0e})", flush=True)
    if not rel <= EVAL_F32_REL_TOL:
        fail(f"raw DSEC-Det evaluation: the wires' logits disagree ({rel:.3e})")
    kernel_rows["flash_fwd_f32"]["launches"] += f32_launches


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke test of frn_tpu_torch.")
    parser.add_argument("--other-source", metavar="CU_SOURCE", action="append", default=[],
                        help="another revision's csrc/flash_attention.cu, "
                             "csrc/flash_attention_bwd.cu, csrc/flash_attention_int8.cu, "
                             "csrc/stem.cu, csrc/flash_attention_f32.cu or "
                             "csrc/flash_attention_bwd_f32.cu (its headers beside "
                             "it), built and its entry points "
                             "timed in turns with this revision's; repeatable")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    started = time.perf_counter()
    phase_environment()
    others = build_others(args.other_source) if args.other_source else {}
    rows = {"flash_fwd": phase_flash_kernel(), "flash_fwd_f32": phase_flash_f32(),
            **phase_flash_backward(), **phase_flash_train_f32()}
    by_name = {name: {src: lib for src, lib in others.items() if Path(src).name == name}
               for name in ("flash_attention.cu", "flash_attention_bwd.cu", "flash_attention_int8.cu",
                            "stem.cu", "flash_attention_f32.cu", "flash_attention_bwd_f32.cu")}
    if by_name["flash_attention.cu"]:
        phase_other_forwards(by_name["flash_attention.cu"])
    if by_name["flash_attention_bwd.cu"]:
        phase_other_backwards(by_name["flash_attention_bwd.cu"])
    if by_name["flash_attention_f32.cu"]:
        phase_other_f32_forward(by_name["flash_attention_f32.cu"])
    if by_name["flash_attention_bwd_f32.cu"]:
        phase_other_f32_backward(by_name["flash_attention_bwd_f32.cu"])
    rows.update(phase_optin_kernels())
    if by_name["flash_attention_int8.cu"]:
        phase_other_int8(by_name["flash_attention_int8.cu"])
    if by_name["stem.cu"]:
        phase_other_stem(by_name["stem.cu"])
    fn, rgb, event, main_ms, main_out = phase_main_path(rows)
    phase_breakdown(fn, rgb, event)
    profile_pass(f"profile: one inference batch of {MAIN_BATCH}", lambda: fn(rgb, event), main_ms,
                 n_ops=15, n_kernels=12)
    phase_small_reference()
    del fn, rgb, event
    phase_optin_path(rows, main_ms, main_out)
    del main_out
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        inputs = write_eval_inputs(root)
        phase_evaluation(rows, inputs, root)
        phase_training(rows, inputs, root)
        phase_train_f32(rows, inputs, root)
        phase_dsec_det(rows, root)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
