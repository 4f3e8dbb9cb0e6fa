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
     path's wgmma instances of the forward (B1, B3 and the exponential-free
     B6), the backward, the int8 forward
     and the stem, the backward's ring dK/dV kernel and the int8 forward's
     ring kernel (both modes) at d 8 and 16, and the
     f32 forward's register-blocked instances at every head dim
     (``flash_fwd_f32_tiled`` at d 32 and 64, ``flash_fwd_f32_small`` at d 8
     and 16), the dQ and dK/dV kernels' at d 32 and 64, and at d 8 and 16
     their small ones (``flash_bwd_dq_f32_small``,
     ``flash_bwd_dkv_f32_small``), must each be there, and may not spill);
  2. each kernel against its plain PyTorch version on the card, at the shapes
     of its path (the forward; the forward with lse and the dQ and dK/dV
     backward kernels, ragged N and head dims 8 and 16 included, and the
     kernels' block edges: N 40 at every head dim, 128, 129 and 4,800; the
     forward's lse also in its mean gap, MEAN_LSE_ATOL; the f32 forward at
     the same shapes; the f32 training kernels, B1-lse, B2a and B2b at f32,
     at the f32 train path's shapes, d 8 and 16, the block edges, and with
     lse < -88 at ragged N; the exponential-free forward B6, the
     counterpart of ``tools/bench_flash.py``'s kernel, at the forward's
     shapes at d 32 and 64, its output and each row's m + l), then
     timed (CUDA events) at its path's batch beside its bound and a one-call
     PyTorch yardstick (``library_ms``, never used by the port), the timed
     runs' outputs held against each other (the f32 forward at the eval
     batch, SDPA at f32 beside it; the f32 training kernels per DSEC
     micro-step at the train CLI's batch 2, SDPA at f32 and its autograd
     backward beside them, each launch's block count, and DDD17 at batch 4);
     B6 through its path, ``frn_tpu_torch.tools.bench_flash`` at DSEC
     stages 1 and 2 (B 8, N 19,200, d 32; B 16, N 4,800, d 64): B1's ms,
     B6's, their difference as the exponentials' ms, share and rate, and
     the materialized Q K^T, each beside its bound, launch counts zeroed
     just before and read just after;
     with ``--other-source``, each
     other revision's forward entry points (B1, B1 with lse, B3) or backward
     entry points (B2a dQ, B2b dK/dV; at depth 50's and depth 18's shapes)
     or f32 forward (B1 and B1-lse at f32,
     at every launch of the eval and f32 train paths, with each launch's
     block count) or f32 backward (B2a and B2b at f32, at every launch of
     the f32 train paths, depth 50's and depth 18's, with each launch's
     block count) built by the same
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
     check shapes (the int8 forward also at N 129 at d 16, a ragged row past
     whole blocks, and at an odd N at d 8; the stem at C 3 and 5, DSEC and DDD17 sizes, a
     tiny image and a ragged last 64-pixel tile), and the
     int8 forward's quantization pre-pass kernel bitwise against its plain
     version there, then timed at the opt-in path's batches beside their
     bounds, their plain versions and a PyTorch yardstick; with
     ``--other-source``, another revision's int8 forward (after the torch
     pre-pass, as its wrapper ran it) timed in turns with this revision's,
     whole and kernel alone, at depth 50's and depth 18's launches, and
     another revision's stem timed in turns with
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
     f32 evaluation on the card against the CPU. Before the folder protocol,
     JPEG images: the DSEC fixture's frames re-encoded by the card
     machine's OpenCV (quality 90, 4:2:0, one in three progressive; the
     phase fails, naming it, if cv2 does not import there), the port's
     ``image_io.imread`` equal to that ``cv2.imread`` on every file under
     both flags, the host ms per 480x640 image of both, and ``cli.test``
     DSEC bf16 over the JPEG tree and over a PNG twin of cv2's decodes (B1
     4 times a batch, nothing else; the detections and summaries equal),
     three of whose frames are damaged as cv2.imread still reads them (a
     JPEG cut in its scan, one with a changed byte, a PNG with a bad tEXt
     CRC); the damage sweep (``check_damage_sweep``: JPEGs and PNGs up to
     480x640 cut, changed at seeded bytes and given a bad ancillary CRC,
     each read equal to cv2.imread's or None on both sides). Then the seven
     formats OpenCV decodes with its own code (BMP, PBM/PGM/PPM, PAM, PFM,
     Sun raster, Radiance HDR, GIF) and TIFF (libtiff): the format sweep
     (``check_format_sweep``: every variant of the CPU tests, whole, cut
     and changed at seeded bytes, each read equal to cv2.imread's, None or
     an error on both sides, apart from the variants in
     ``FORMATS_LEFT_OUT``), and ``cli.test`` DSEC bf16 over a tree of
     480x640 frames spread over BMP 24-bit, BMP 32-bit, P6 PPM, PAM RGB,
     Sun raster 24-bit, TIFF LZW strips and TIFF Deflate tiles and over its
     PNG twin (``check_format_evaluation``: every frame equal to
     cv2.imread's under both flags, B1 4 times a batch, the detections and
     summaries equal; the host ms of both readers per BMP, PPM and TIFF
     frame, in turns).
     Phase 4 then evaluates
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
     the tests. One frame damaged and restored: zeros where cv2.imread
     returns None, cv2's partial frame where it reads one
     (``check_damaged_dsec_det_frames``). The three wires on every sample (the events wire's device
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

 11. serving at full width (DSEC 480x640, fusion ResNet-50, feature size 256,
     3 classes, phase 8's seeded DSEC ``.pth``): ``cli/serve.build_engine``
     at the serve CLI's defaults (f32, the compact wire, buckets 1-16, every
     bucket warmed up) behind ``DetectionServer`` on loopback (/healthz,
     /stats, a malformed /infer answered 400, then its traffic over HTTP);
     then engines over one bf16 model on the f32, events and sparse wires,
     and one int8_qk engine on the compact wire. Each engine: SERVE_SINGLE
     requests from one client at max_delay_ms 0, then SERVE_CLIENTS
     closed-loop clients for a ramp-up and a SERVE_BURST_S window, launch
     counts zeroed just before and read just after (B1 at f32, B1, or B4 and
     its pre-pass 4 times a batch, nothing else), every future resolved; h2d
     bytes per request, latency p50/p90/p99 of both, requests/s and
     mean_batch_fill of the window, peak memory; each request's detections
     equal, bit for bit, to the direct forward of its padded batch (the
     engine's own ``batch_records``, rebuilt by ``wire_batch`` and run by
     ``device_program``); SERVE_BATCH1_CHECKS requests' logits and deltas
     against their batch-1 forward beside a one-ulp witness; on the events
     and sparse wires the device count grids equal the host's (the sparse
     one with cells at +-300, past int8), the squashed grids within
     WIRE_TANH_RTOL, RGB exact; one dispatch at bucket 1 and at the largest
     broken down (the dispatcher's staging; wire decode, forward, decode +
     NMS by the host clock and CUDA events); a profiled burst of
     SERVE_PROFILE_ROUNDS rounds for the idle share.
 12. the trainer's instruments and the host data layer at full width (DSEC
     480x640, fusion ResNet-50, f32, phase 8's fixture and seeded ``.pth``):
     the native host library built from ``frn_tpu_torch/native`` and loaded
     (a failed build fails with g++'s message), its scatter equal to numpy's
     bincount on NATIVE_EVENTS events, its subsampler equal to the Python
     fallback, its tanh squash within NATIVE_TANH_ULPS of numpy's, host ms of
     both voxelizations; ``cli.convert_checkpoint`` of the ``.pth`` into the
     port's directory, loaded bit for bit; from it ``Trainer(metrics_path=...,
     log_every=2).fit(1)`` at the train CLI's batch 2 over
     INSTRUMENT_IMAGES images, launch counts zeroed just before and read just
     after (B1-lse, B2a and B2b at f32 4 times a micro-step, nothing else),
     finite losses, frn_tpu's JSONL keys and types, every batch that the
     side-stream prefetch hands the step equal to the loader's host batch
     (compared after the step, on the consumer's stream), the first
     micro-step's loss equal to the same state's on a ``to_device`` batch;
     ``profiling.trace`` over TRACED_STEPS micro-steps naming the three f32
     training kernels, ``StepTimer.stats()`` beside CUDA events;
     ``collect_detections`` through the prefetch against the current
     stream's loop at DSEC f32, batch 8 (detections bit for bit; B1 at f32 4
     times a batch, nothing else), both loops warm in turns with img/s and
     idle share beside phase 8's (printed, not gated);
     ``default_augmentations`` on a DSEC-sized raw event sample with its RGB
     image, which imports no OpenCV (events in the frame, the image finite).
 13. data parallelism on the one card, at full width (DSEC 480x640, fusion
     ResNet-50, phase 8's fixture and seeded ``.pth``): the train CLI (f32,
     batch 2, 2 micro-steps) under ``torch.distributed.run --nproc_per_node
     1`` (NCCL at world size 1) and twice plainly (its backend nccl, its
     first micro-step's loss bit-equal to a plain run's, its parameters
     within PARALLEL_SPREAD_FACTOR of the plain runs' spread; B1-lse, B2a and
     B2b at f32 4 times a micro-step); two gloo ranks sharing cuda:0
     (``parallel.launch.run_ranks``), each the CLI's step on its row of the
     global batch of 2 (each rank's launches, the all-reduced loss against
     one process's batch-2 loss, the all-reduced gradients against the
     mean of the rows' gradients under the phase-9 gate and against batch 2
     beside a one-ulp witness; one all-reduce of the gradients timed);
     evaluation over PARALLEL_REPLICAS replicas on cuda:0, DSEC bf16 at
     batch 8 (each replica's rows bit-equal to the single device's forward
     + decode + NMS of its block; against the whole batch beside a one-ulp
     witness; the eval loop in turns with one model's, img/s and the host's
     enqueue ms a batch, B1 4 times a batch a replica); serving, a bf16
     engine on the compact wire over the replicas and over one model
     (every request bit-equal to its replica's forward of its row block;
     requests/s, p50/p99 and the dispatcher's host ms a batch of both).
 14. the last model and postprocess options at full width (fusion ResNet-50,
     feature size 256, phase 8's seeded ``.pth`` files and fixtures): the
     fused heads (``ModelConfig.fused_heads``) against the unfused heads at
     the same weights, at inference with the 'pooled' postprocess (DSEC bf16
     at batch 16: B1 4 a batch; DDD17 f32 at batch 8, the cls-padding case: B1
     at f32 2 a batch; nothing else; ms a batch and detections of both, no
     detection slot differing, the gap of the probabilities and the deltas
     under twice the one-ulp witness of the pyramid through the unfused
     heads) and in one f32 micro-step of the train CLI's trainer at batch 2
     (the loss within WIRE_LOSS_RTOL, the gradients under the phase-9 gate
     beside a one-ulp witness; B1-lse, B2a and B2b at f32 4 each); on that
     batch's head outputs at bf16 and f32, as the random weights give them
     (logits up to 1e4: the probabilities tie at 1.0) and tempered (the
     logits scaled by a power of two into [-8, 8]), the postprocess rungs
     (dense equal to pooled bit for bit; the logit rungs' differing
     detections against dense printed) and the pool's top-k (two_stage equal
     to the sort bit for bit on the (B*K, 230,220) tables and a tied table),
     with the device ms of each and of each rung's decode + NMS;
     ``FRN_DISABLE_FLASH=1`` set inside the phase (a forward raises before
     any launch) and removed (B1 4 times); ``cli.test --postprocess dense
     --approx_topk`` on phase 8's DSEC fixture at bf16 (B1 4 a batch,
     nothing else; the summary beside phase 8's).
 15. the depth-18 and -34 paths at full width (DSEC 480x640, fusion,
     feature size 256, seeded random weights), whose stages 1 and 2 run the
     flash kernels at d 8 and 16 (N 19,200 and 4,800; DDD17 N 5,655 at d 8):
     the eleven d 8 and 16 instances (B1, B1-lse, B3, B2a, B2b, B4 in both
     modes; B1, B1-lse, B2a, B2b at f32) against their plain versions at the
     paths' N and d at batch 2, then timed at the paths' batches beside
     their bounds, blocks per launch, plain versions and SDPA at scale 1.0
     (with the backend it took; B4's rows the kernel alone and the
     pre-pass's device time beside the wrapper's), as rows
     ``<kind>_d8_16`` of the kernels
     line; bf16 inference at batch 16 through ``entry(depth=18)`` (the
     logits against the plain attention), the three opt-in configurations
     and depth 34; ``cli.test --depth 18`` at f32 (DSEC, and DDD17 through
     ``test_ddd17``); one f32 micro-step of ``cli.train --depth 18`` at batch
     2 and one bf16 micro-step of ``train_entry(depth=18)`` at batch 8. Each
     run with the launch counts zeroed just before and read just after, its
     outputs or loss finite; each row's launches summed over them.

The script fails at its start if ``FRN_DISABLE_FLASH`` is in the
environment (the port raises on every flash path then). Phases run
in the order 1, 2, 5, 3, 6, 8, 4, 9, 10, 11, 12, 13, 14, 15, 7. Phase 15 alone:
``python3 -c "import chip_smoke as c, tempfile, pathlib; c.phase_environment();
d = pathlib.Path(tempfile.mkdtemp()); c.phase_depth18({}, c.write_eval_inputs(d), d)"``.
Phase 14 alone:
``python3 -c "import chip_smoke as c, tempfile, pathlib; c.phase_environment();
r = {k: {'launches': 0} for k in c._COUNTERS}; d = pathlib.Path(tempfile.mkdtemp());
c.phase_options(r, c.write_eval_inputs(d), d)"``; another revision's
``core/nms.py`` against this one on the main path's decode + NMS:
``phase_postprocess_against`` (not run by ``main``). Phase 13
alone (81.5 s of a 123.8 s call after the build and the fixtures): ``python3
-c "import chip_smoke as c, tempfile, pathlib; c.phase_environment(); r =
{k: {'launches': 0} for k in c._COUNTERS}; d = pathlib.Path(tempfile.mkdtemp());
c.phase_parallel(r, c.write_eval_inputs(d), d)"``. Phase 12 alone
(31.3 s of a 63.3 s call after the build and the fixtures): ``python3 -c "import chip_smoke as c, tempfile, pathlib;
c.phase_environment(); r = {k: {'launches': 0} for k in c._COUNTERS}; d =
pathlib.Path(tempfile.mkdtemp()); c.phase_instruments(r, c.write_eval_inputs(d), d)"``.
Phase 11 alone
(about three minutes of a call after the build): ``python3 -c "import
chip_smoke as c, tempfile, pathlib; c.phase_environment(); r = {k:
{'launches': 0} for k in c._COUNTERS};
c.phase_serving(r, c.write_eval_inputs(pathlib.Path(tempfile.mkdtemp())))"``.
The serving engine's ``pipeline_depth`` 1 against 2 (not run by ``main``;
about a minute): the same with ``i = c.write_eval_inputs(...);
c.phase_serving_pipeline(i)``.
Phase 9 alone:
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
import os
import statistics
import struct
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
# the exponential-free forward (B6) vs its plain version on bf16 outputs
# (below 0.1 at these inputs): the same bf16 p from scores that may differ in
# their last bits, f32 sums in another order, the output rounded to bf16, so
# an output can land a bf16 step apart: atol two bf16 steps (2^-7) of the
# largest |output|, rtol 2^-7; and each row's m + l (about 25 here) to the
# scores' last bits and f32 summation order over up to 19,200 keys
NOEXP_STEP = 2.0 ** -7
NOEXP_ML_ATOL, NOEXP_ML_RTOL = 1e-3, 1e-5
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
# the int8 forward (and its pre-pass) is held to its plain version there and,
# for the ring kernel at d 8 and 16, at a ragged row past whole blocks (N 129
# at d 16) and at an odd N at d 8 (K rows of 8 bytes that start 8-byte
# aligned in odd batches)
INT8_CHECK_SHAPES = BWD_CHECK_SHAPES + ((2, 129, 16), (2, 131, 8))
# the f32 training kernels (B1-lse, B2a, B2b at f32): the f32 train path's
# shapes (DSEC stages 1 and 2 at batch 2, DDD17 at batch 4 and N 5,655,
# ragged), one shape at each of d 8 and 16, and the block edges (N 40 at
# every head dim: 64-row blocks at d 64, 128 below; ragged N past whole
# tiles; one and two rows past whole blocks of the d 8/16 dQ and dK/dV
# kernels: 64 query or key rows a block at d 8, 32 at d 16)
F32_TRAIN_CHECK_SHAPES = ((2, 19200, 32), (2, 4800, 64), (4, 5655, 32), (2, 4800, 16),
                          (2, 5655, 8), (2, 40, 8), (2, 40, 16), (2, 40, 32), (2, 40, 64),
                          (2, 131, 32), (2, 517, 64), (2, 129, 16), (2, 65, 8), (2, 129, 8),
                          (2, 33, 16), (2, 65, 16))
# and, with the scores shifted far below zero (lse < -88, where a key past N
# that were not masked would give P = exp(-lse) = inf), at ragged N. There
# column 0 of q and k is 11 and -11 (the rest N(0, 0.5^2)): column 0 of dQ
# (dK) sums terms of size 11 |dS| that cancel to about 0 in exact arithmetic
# (a row of dS sums to 0), so either version's value there is rounding noise
# of those terms, and the gradients are held at F32_TRAP_ATOL of their max
# |value| (the largest gap on an H100 was 1.2e-4 of it, dQ at N 517, d 64)
F32_LSE_TRAP_SHAPES = ((2, 131, 16), (4, 5655, 32), (2, 517, 64), (2, 131, 8))
F32_TRAP_ATOL = 1e-3
# the bf16 backward kernels at d 8 and 16 with the scores shifted far below
# zero (``_shift_scores``: lse < -88), at ragged N (3 keys in the last tile at
# N 131, 23 at N 5,655): the select on the ragged tile is what keeps dQ
# finite there. Held at phase 2's gate (BWD_ATOL, BWD_RTOL)
BWD_LSE_TRAP_SHAPES = ((2, 131, 16), (2, 5655, 8))
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
# the same stages of the depth-18 and -34 detectors (stage widths 64 and 128,
# head dim C / 8)
DEPTH18_FLASH_SHAPES = ((19200, 8), (4800, 16))
DEPTH18_DDD17_SHAPE = (5655, 8)
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
    # tools/bench_flash.py's exponential-free kernel (_kernel_noexp)
    "flash_fwd_noexp": ("frn_tpu_torch/csrc/flash_attention.cu", "tools/bench_flash.py:23"),
}
TRAIN_KERNELS = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
TRAIN_F32_KERNELS = ("flash_fwd_lse_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
# the path's wgmma instances of each source, as (kernel, its first template
# arguments): the forward at d 32 and 64 in its three modes (B1 0, the
# bf16-exp B3 1, the exponential-free B6 2); the dQ
# and dK/dV kernels at d 32 and 64, and the ring dQ and dK/dV kernels at d 8
# and 16 (the depth-18 and -34 training path); the int8 forward at d 32 and 64 and its
# ring kernel at d 8 and 16, in modes int8_qk (0) and int8 (1) (the ring
# kernel: the depth-18 and -34 opt-in paths); the stem at C 3 and 5; and the
# f32 kernels (CUDA
# cores): the forward's register-blocked kernels at every head dim (its small
# one at d 8 and 16), the dQ and the dK/dV kernels' register-blocked kernels
# at d 32 and 64, and at d 8 and 16 (the f32 paths take them at depths 18
# and 34) their small ones.
# Phase 1 fails unless each is in the compiler's log once, unspilled
PATH_INSTANCES = {
    "flash_attention": [("flash_fwd_wgmma", d, mode) for d in (32, 64) for mode in (0, 1, 2)],
    "flash_attention_bwd": [(kernel, d) for kernel in ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
                            for d in (32, 64)] + [(kernel, d) for kernel in (
                                "flash_bwd_dq_ring", "flash_bwd_dkv_ring") for d in (8, 16)],
    "flash_attention_int8": [(kernel, d, f) for kernel, dims in (("flash_int8_wgmma", (32, 64)),
                                                                 ("flash_int8_ring", (8, 16)))
                             for d in dims for f in (0, 1)],
    "stem": [("stem_wgmma", c) for c in (3, 5)],
    "flash_attention_f32": [("flash_fwd_f32_small", 8), ("flash_fwd_f32_small", 16),
                            ("flash_fwd_f32_tiled", 32), ("flash_fwd_f32_tiled", 64)],
    "flash_attention_bwd_f32": [(f"flash_bwd_{part}_f32{'_small' if d < 32 else '_tiled'}", d)
                                for part in ("dq", "dkv") for d in (8, 16, 32, 64)],
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
    line, named ``name`` (default ``kind``)."""

    def __init__(self, kind: str, name: str = ""):
        self.kind, self.name, self.per_shape, self.launches_per = kind, name or kind, [], 0
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
        print(f"{self.name} timing {json.dumps(row)}", flush=True)
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
        print(f"{self.name} per {per} ({self.launches_per} launches): kernel "
              f"{self.totals['ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), {others}",
              flush=True)
        source, replaces = KERNEL_SOURCES[self.kind]
        return {"name": self.name, "route": "cuda", "source": source, "replaces": replaces,
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
                          r"|flash_(?:bwd_dq|bwd_dkv|int8)_ring"
                          r"|flash_(?:fwd|bwd_dq|bwd_dkv)_f32(?:_tiled|_small)?|stem_wgmma)"
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


def phase_flash_noexp():
    """The exponential-free forward (B6, a measuring kernel) against its plain
    version at the forward's check shapes at d 32 and 64 (its output and each
    row's m + l), then its path: ``frn_tpu_torch.tools.bench_flash`` at the
    DSEC stages 1 and 2 (B 8 at N 19,200, d 32; B 16 at N 4,800, d 64),
    which times it beside B1, Q K^T and their bounds, with the launch counts
    zeroed just before and read just after (B6 and B1 only). Returns B6's row
    of the kernels line (its launches: that run's), with its plain version's
    times at both shapes."""
    from frn_tpu_torch.ops import flash_attention as fa
    from frn_tpu_torch.tools import bench_flash

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, n, d):
        return [torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3)]

    errs = {}
    for shape in [s for s in BWD_CHECK_SHAPES if s[2] in fa.NOEXP_HEAD_DIMS]:
        q, k, v = qkv(*shape)
        o, ml = fa.flash_attention_noexp(q, k, v, return_ml=True)
        o_ref, ml_ref = fa.flash_attention_noexp_plain(q, k, v, return_ml=True)
        check_close("flash_fwd_noexp", "o", o, o_ref, NOEXP_STEP * o_ref.float().abs().max().item(),
                    NOEXP_STEP, shape, errs)
        check_close("flash_fwd_noexp_ml", "m + l", ml, ml_ref, NOEXP_ML_ATOL, NOEXP_ML_RTOL, shape,
                    errs)

    print(f"tools/bench_flash counterpart on {card_name_and_power_limit()}: python -m "
          f"frn_tpu_torch.tools.bench_flash", flush=True)
    torch.cuda.synchronize()
    _reset_counts()
    results = []
    for b, n, d in bench_flash.SHAPES:
        r = bench_flash.measure(b, n, d)
        print(bench_flash.report(r), flush=True)
        print(f"bench_flash {json.dumps(r)}", flush=True)
        results.append(r)
    torch.cuda.synchronize()
    counts = _counts()
    launches = counts.pop("flash_fwd_noexp")
    others = {k: v for k, v in counts.items() if v and k != "flash_fwd"}
    if not launches or not counts["flash_fwd"] or others:
        fail(f"bench_flash launched B6 {launches} and B1 {counts['flash_fwd']} times, and {others}")

    times = KernelTimes("flash_fwd_noexp")
    for r in results:
        b, n, d = r["B"], r["N"], r["d"]
        q, k, v = qkv(b, n, d)
        by, pr = r["bytes_bound_ms"] * 1e-3, r["products_bound_ms"] * 1e-3
        out, ref = times.add({"B": b, "N": n, "d": d}, (by, pr),
                             lambda: fa.flash_attention_noexp(q, k, v),
                             lambda: fa.flash_attention_noexp_plain(q, k, v), None, count=1,
                             extra={"b1_ms": r["b1_ms"], "exp_ms": r["exp_ms"]})
        check_close("flash_fwd_noexp", "o", out, ref, NOEXP_STEP * ref.float().abs().max().item(),
                    NOEXP_STEP, q.shape, errs)
        del q, k, v, out, ref
    row = times.row(errs["flash_fwd_noexp"], "bench_flash run (stages 1 and 2)")
    row["launches"] = launches
    return row


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
    edges, ragged N and d 8 and 16 included) and the backward kernels, with
    lse < -88, at BWD_LSE_TRAP_SHAPES; then each timed at batch TRAIN_BATCH at
    the training path's two shapes, where the timed runs' outputs are held
    against each other too."""
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
    for shape in BWD_LSE_TRAP_SHAPES:
        q, k = _shift_scores(randn(*shape), randn(*shape))
        v, do = randn(*shape), randn(*shape)
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, return_lse=True)
        if not lse_ref.max().item() < -88:
            fail(f"the shifted scores left lse at {lse_ref.max().item():.1f} at {_shape_text(shape)}")
        print(f"lse < -88 at {_shape_text(shape)}:", flush=True)
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
                              seed: int, checks=()) -> None:
    """This revision's dQ and dK/dV entry points timed in turns with other
    revisions' (``build_others``) at ``launches`` [(label suffix, B, N, d)],
    on the same inputs, lse and D; each timed output of every revision held
    against the plain versions (atol a share of each output's max |value|),
    and so are every revision's outputs at ``checks`` [(B, N, d)], untimed.
    f32 rows carry this revision's block count (``f32_bwd_launch_plan``),
    bf16 rows at d 8 and 16 the d 8/16 kernels' (``depth18_blocks``)."""
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    f32 = dtype == torch.float32
    errs, per_step = {}, {}
    for suffix, b, n, d in [(None, *shape) for shape in checks] + list(launches):
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

            if suffix is None:  # a check shape: held against the plain versions, untimed
                for name, run in runs.items():
                    check(f"{kind} {'this revision' if name == 'this' else name}", run())
                continue
            shape = {"B": b, "N": n, "d": d}
            if f32:
                shape["blocks"] = fa.f32_bwd_launch_plan(b, n, d, part)["blocks"]
            elif d in (8, 16):
                shape["blocks"] = depth18_blocks(kind, b, n, d)
            time_in_turns(kind + suffix, shape, runs, check, per_step)
        del q, k, v, do, o, lse, delta, dq_ref, dkv_ref
    print_per_step(per_step)


def phase_other_backwards(others: dict) -> None:
    """This revision's dQ and dK/dV entry points (B2a, B2b) timed in turns
    with other revisions' at the bf16 training paths' shapes and batch: depth
    50's (FLASH_SHAPES) and depth 18's (DEPTH18_FLASH_SHAPES, rows " R18"),
    at TRAIN_BATCH, held against the plain versions as in phase 2; before
    them every revision's outputs at the ragged DEPTH18_DDD17_SHAPE (batch
    DEPTH18_CHECK_BATCH) against the plain versions."""
    launches = [("", TRAIN_BATCH, n, d) for n, d in FLASH_SHAPES]
    launches += [(" R18", TRAIN_BATCH, n, d) for n, d in DEPTH18_FLASH_SHAPES]
    _other_backwards_in_turns(others, launches, torch.bfloat16, BWD_ATOL, BWD_RTOL, seed=7,
                              checks=[(DEPTH18_CHECK_BATCH, *DEPTH18_DDD17_SHAPE)])


def phase_other_f32_forward(others: dict) -> None:
    """This revision's f32 forward (B1 and B1-lse at f32) timed in turns with
    other revisions' (``build_others``) at every launch of its paths, at
    depth 50 (d 32 and 64) and at depths 18 and 34 (d 8 and 16): without lse
    at the eval batch (DSEC stages 1 and 2, DDD17's stage 1), with lse at the
    train CLIs' batches (DSEC at F32_TRAIN_BATCH, DDD17 at
    DDD17_TRAIN_BATCH). Each timed output, o and lse, of every revision is
    held against the plain version at the f32 tolerances; each row carries
    this revision's block count (``f32_launch_plan``)."""
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    launches = []
    for depth, shapes, ddd17 in (("", FLASH_SHAPES, DDD17_FLASH_SHAPE),
                                 (" R18", DEPTH18_FLASH_SHAPES, DEPTH18_DDD17_SHAPE)):
        launches += [(f"flash_fwd_f32{depth}", EVAL_BATCH, n, d, False) for n, d in shapes]
        launches.append((f"flash_fwd_f32{depth} DDD17", EVAL_BATCH, *ddd17, False))
        launches += [(f"flash_fwd_lse_f32{depth}", F32_TRAIN_BATCH, n, d, True) for n, d in shapes]
        launches.append((f"flash_fwd_lse_f32{depth} DDD17", DDD17_TRAIN_BATCH, *ddd17, True))
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


# ragged shapes at which every revision's f32 backward at d 8 and 16 is held
# against the plain versions before the A/B: DDD17's N (23 key rows past
# whole 64-row blocks and 23 queries past whole tiles) at d 8, and at d 16 5
# key rows past whole 32-row blocks and 5 queries past whole tiles
F32_BWD_AB_CHECKS = ((2, 5655, 8), (2, 517, 16))


def phase_other_f32_backward(others: dict) -> None:
    """This revision's f32 backward kernels (B2a and B2b at f32) timed in turns
    with other revisions' at every launch of the f32 train paths: depth 50's
    (DSEC stages 1 and 2 at FLASH_SHAPES and F32_TRAIN_BATCH, DDD17's stage 1
    at DDD17_TRAIN_BATCH) and depth 18's (the same at DEPTH18_FLASH_SHAPES
    and DEPTH18_DDD17_SHAPE, rows " R18"), held against the plain versions
    at the f32 tolerances, each row with this revision's block count; before
    them every revision's outputs at F32_BWD_AB_CHECKS against the plain
    versions. The other kernel's rows are the control where only one
    changed."""
    launches = []
    for depth, shapes, ddd17 in (("", FLASH_SHAPES, DDD17_FLASH_SHAPE),
                                 (" R18", DEPTH18_FLASH_SHAPES, DEPTH18_DDD17_SHAPE)):
        launches += [(depth, F32_TRAIN_BATCH, n, d) for n, d in shapes]
        launches.append((f"{depth} DDD17", DDD17_TRAIN_BATCH, *ddd17))
    _other_backwards_in_turns(others, launches, torch.float32, BWD_F32_ATOL, BWD_F32_RTOL,
                              seed=12, checks=F32_BWD_AB_CHECKS)


def phase_other_int8(others: dict) -> None:
    """This revision's int8 forward timed in turns with other revisions'
    (``build_others``) in both modes at the opt-in paths' shapes and batches
    (int8_qk at MAIN_BATCH, two launches per shape; int8 at 2 MAIN_BATCH, one),
    depth 50's (FLASH_SHAPES) and depth 18's (DEPTH18_FLASH_SHAPES, rows
    " R18" with this revision's blocks): whole, as each revision's wrapper
    ran it (another revision after the torch pre-pass,
    ``int8_kernel_inputs``; this one after its pre-pass kernel), and the
    kernel alone on the same quantized inputs. Each timed output is held
    against the plain version."""
    from frn_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(8)
    errs, per_step = {}, {}
    launches = [("", n, d) for n, d in FLASH_SHAPES] + [(" R18", n, d)
                                                        for n, d in DEPTH18_FLASH_SHAPES]
    for mode in fa.INT8_MODES:
        batch, count = (2 * MAIN_BATCH, 1) if mode == "int8" else (MAIN_BATCH, 2)
        for suffix, n, d in launches:
            q, k, v = (torch.randn((batch, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            want = fa.flash_attention_int8_plain(q, k, v, mode)
            inputs = fa.int8_kernel_inputs(q, k, v, mode)

            def check(label, out):
                check_close(label, "o", out, want, FLASH_ATOL, FLASH_RTOL, q.shape, errs)

            shape = {"B": batch, "N": n, "d": d}
            if suffix:
                shape["blocks"] = depth18_blocks(f"flash_{mode}", batch, n, d)
            runs = {src: (lambda lib=lib: other_int8(lib, q, fa.int8_kernel_inputs(q, k, v, mode),
                                                     mode))
                    for src, lib in others.items()}
            runs["this"] = lambda: fa.flash_attention_int8(q, k, v, mode)
            time_in_turns(f"flash_{mode}{suffix}", shape, runs, check, per_step, count)
            runs = {src: (lambda lib=lib: other_int8(lib, q, inputs, mode))
                    for src, lib in others.items()}
            runs["this"] = lambda: other_int8(fa._int8_library(), q, inputs, mode)
            time_in_turns(f"flash_{mode}{suffix} kernel alone", shape, runs, check, per_step,
                          count)
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
    against their plain versions: the flash forwards at BWD_CHECK_SHAPES (the
    int8 forward, with its pre-pass kernel held bitwise to
    ``int8_kernel_inputs``, at INT8_CHECK_SHAPES),
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
    for shape in INT8_CHECK_SHAPES:
        q, k, v = qkv(*shape)
        for kind, (kernel, plain) in flash.items():
            if kind.startswith("flash_int8") or shape in BWD_CHECK_SHAPES:
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
                 n_host_ops: int = 0) -> float:
    """torch.profiler over one call of ``run_once`` (after one profiled
    warm-up call): the device-busy time summed over kernels, the idle share of
    the unprofiled wall time ``wall_ms`` of one call (returned), and the
    costliest operators (by the device time of the kernels they launched) and
    kernels."""
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
    return idle


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
# phase 8's warm eval loops, by configuration: (img/s, idle share), printed
# again by phase 12 beside its own; and its summaries, printed again by phase 14
EVAL_WARM_LOOPS: dict = {}
EVAL_SUMMARIES: dict = {}
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


# phase 8's JPEG tree: the DSEC fixture's RGB frames re-encoded by the card
# machine's OpenCV at quality JPEG_QUALITY, 4:2:0, every JPEG_PROGRESSIVE_EVERY-th
# progressive (named as the CSV schema names frames, <frame>.png: both readers
# go by content); its PNG twin holds cv2.imread's decodes of those files
JPEG_QUALITY, JPEG_PROGRESSIVE_EVERY = 90, 3
JPEG_DECODE_REPS = 10
# frames of that tree damaged in place, each one that cv2.imread still reads:
# a JPEG cut in its scan, a JPEG with a byte of its scan changed, and the
# PNG frame itself with a bad CRC in a tEXt chunk (libpng drops the chunk)
JPEG_DAMAGED_FRAMES = {1: "cut", 4: "byte", 7: "png_ancillary_crc"}
# the damage sweep: every file cut at DAMAGE_CUTS lengths spread over it and
# changed at DAMAGE_CHANGES seeded bytes (half in its headers, half in its
# coded data), a PNG also given a tEXt chunk with a bad CRC
DAMAGE_CUTS, DAMAGE_CHANGES = 32, 32
# (file kind, damage) pairs on which this machine's OpenCV and the one the
# CPU tests run against disagree; the port follows the tests' OpenCV, and
# each pair left out here is named in ROADMAP's Queue C with its reason
DAMAGE_LEFT_OUT: dict = {}


def _png_bytes(samples, depth: int, color: int, palette=None, interlace: bool = False,
               extra: bytes = b"") -> bytes:
    """A PNG of (h, w, c) samples whose rows take the five filters in turn:
    the palette and Adam7 files that cv2.imencode does not write."""
    import zlib

    import numpy as np

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    samples = samples[:, :, None] if samples.ndim == 2 else samples
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)

    def rows(sub):
        flat = sub.reshape(len(sub), -1).astype(np.uint8)
        if depth < 8:
            per = 8 // depth
            flat = np.concatenate([flat, np.zeros((len(sub), -flat.shape[1] % per), np.uint8)], 1)
            flat = (flat.reshape(len(sub), -1, per).astype(np.int32)
                    << ((8 - depth) - depth * np.arange(per))).sum(2).astype(np.uint8)
        out, prev = [], np.zeros(flat.shape[1], np.int32)
        for r, x in enumerate(flat.astype(np.int32)):
            a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
            cc = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            pa, pb, pc = np.abs(prev - cc), np.abs(a - cc), np.abs(a + prev - 2 * cc)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, cc))
            pred = (0, a, prev, (a + prev) >> 1, paeth)[r % 5]
            out.append(bytes([r % 5]) + ((x - pred) & 255).astype(np.uint8).tobytes())
            prev = x
        return b"".join(out)

    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                  (0, 1, 1, 2))
        raw = b"".join(rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in passes
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = rows(samples)
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                              int(interlace))) + extra
    if palette is not None:
        data += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return data + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _with_bad_text_chunk(png: bytes) -> bytes:
    """png with a tEXt chunk whose CRC is wrong, just before its first IDAT."""
    import zlib

    body = b"Comment\0damaged"
    text = (struct.pack(">I", len(body)) + b"tEXt" + body
            + struct.pack(">I", zlib.crc32(b"tEXt" + body) ^ 0x5A))
    at = png.index(b"IDAT") - 4
    return png[:at] + text + png[at:]


def _coded_data_start(data: bytes) -> int:
    """Where a file's coded data starts: a JPEG's first scan, a PNG's IDAT."""
    if data.startswith(b"\x89PNG"):
        return data.index(b"IDAT") + 4
    sos = data.index(b"\xff\xda")
    return sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]


def _png_length_tops(data: bytes) -> set:
    """The top byte of each PNG chunk's length: changed, it declares a chunk
    of up to 4 GiB, which OpenCV allocates before it finds the file short."""
    tops, pos = set(), 8
    while data.startswith(b"\x89PNG") and pos + 8 <= len(data):
        tops.add(pos)
        pos += 12 + struct.unpack(">I", data[pos:pos + 4])[0]
    return tops


def check_damage_sweep(root: Path) -> None:
    """``image_io.imread`` against this machine's ``cv2.imread`` under both
    flags on damaged files: JPEGs that its ``cv2.imencode`` writes (31x45 and
    480x640: baseline 4:2:0, progressive, restart interval 2, gray) and PNGs
    (480x640 8-bit RGB by ``cv2.imencode``; 4-bit palette and 8-bit Adam7
    RGB by ``_png_bytes``), each cut at DAMAGE_CUTS lengths, changed at
    DAMAGE_CHANGES seeded bytes and (PNG) given a tEXt chunk with a bad CRC.
    Each read must equal cv2's bit for bit, or both sides give None (the
    port's ``UnreadableImage``). Mismatches are gathered by (file kind,
    damage) and fail the phase, apart from the pairs in DAMAGE_LEFT_OUT."""
    import cv2
    import numpy as np

    from frn_tpu_torch.data import image_io

    rng = np.random.default_rng(26)

    def scene(h, w, seed):
        y, x = np.mgrid[:h, :w]
        img = np.stack([(x * 3 + y) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1)
        noise = np.random.default_rng(seed).normal(0, 20, img.shape)
        return np.clip(img + noise, 0, 255).astype(np.uint8)

    files = {}
    for h, w in ((31, 45), (480, 640)):
        img = scene(h, w, h)
        for kind, params in (("baseline", []), ("progressive", [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
                             ("restart 2", [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]), ("gray", None)):
            ok, buf = cv2.imencode(".jpg", img[:, :, 1] if params is None else img,
                                   [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY, *(params or [])])
            if not ok:
                fail(f"cv2.imencode of the damage sweep's {kind} JPEG")
            files[f"JPEG {kind} {h}x{w}"] = buf.tobytes()
    big = scene(480, 640, 5)
    files["PNG 8-bit 480x640"] = cv2.imencode(".png", big)[1].tobytes()
    files["PNG palette 120x160"] = _png_bytes(rng.integers(0, 16, (120, 160)), 4, 3,
                                              palette=rng.integers(0, 256, (16, 3)))
    files["PNG Adam7 240x320"] = _png_bytes(big[::2, ::2, ::-1], 8, 2, interlace=True)

    path = root / "damaged.bin"
    agree = {"image": 0, "none": 0}
    mismatches: dict = {}
    t0 = time.perf_counter()
    for name, data in files.items():
        kind = name.rsplit(" ", 1)[0]
        start, tops = _coded_data_start(data), _png_length_tops(data)
        cases = [("cut", data[:int(n)]) for n in np.linspace(2, len(data) - 1, DAMAGE_CUTS)]
        for i in range(DAMAGE_CHANGES):
            pos = None
            while pos is None or pos in tops:
                pos = int(rng.integers(0, start)) if i % 2 else int(rng.integers(start, len(data)))
            changed = bytearray(data)
            changed[pos] = (changed[pos] + int(rng.integers(1, 256))) % 256
            cases.append(("byte", bytes(changed)))
        if data.startswith(b"\x89PNG"):
            cases.append(("ancillary CRC", _with_bad_text_chunk(data)))
        for damage, bad in cases:
            if (kind, damage) in DAMAGE_LEFT_OUT:
                continue
            path.write_bytes(bad)
            for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
                want = cv2.imread(str(path), flag)
                try:
                    got = image_io.imread(str(path), flag)
                except image_io.UnreadableImage:
                    got = None
                except ValueError as e:
                    got = f"ValueError: {e}"
                if want is None and got is None:
                    agree["none"] += 1
                elif (want is not None and isinstance(got, np.ndarray) and got.shape == want.shape
                      and np.array_equal(got, want)):
                    agree["image"] += 1
                else:
                    what = ("cv2 None" if want is None else "cv2 image") + ", port " + (
                        "None" if got is None else got if isinstance(got, str) else "a different image")
                    mismatches.setdefault((kind, damage), []).append(f"flag {flag}: {what}")
    reads = agree["image"] + agree["none"] + sum(len(v) for v in mismatches.values())
    print(f"damage sweep: {agree['image'] + agree['none']} of {reads} reads of {len(files)} files "
          f"({DAMAGE_CUTS} cuts, {DAMAGE_CHANGES} changed bytes, PNG a bad ancillary CRC; both flags) "
          f"agree with OpenCV {cv2.__version__}'s cv2.imread: {agree['image']} images equal, "
          f"{agree['none']} None on both sides; left out {sorted(DAMAGE_LEFT_OUT) or 'nothing'}; "
          f"{time.perf_counter() - t0:.1f} s on the host of {card_name_and_power_limit()}", flush=True)
    for (kind, damage), what in sorted(mismatches.items()):
        print(f"damage sweep mismatch: {kind}, {damage}: {len(what)} reads, e.g. {what[0]}", flush=True)
    if mismatches:
        fail(f"image_io.imread differs from cv2.imread on the damage sweep: {sorted(mismatches)}")


def write_jpeg_trees(inputs: dict, root: Path):
    """The DSEC fixture's JPEG tree and its PNG twin under ``root`` (images
    only; events, labels and the checkpoint stay the fixture's), the frames
    of JPEG_DAMAGED_FRAMES damaged in place as cv2.imread still reads them.
    Returns (the sound JPEG files, the damaged files, the eval inputs over
    the JPEG tree, over the twin)."""
    from frn_tpu_torch.data import image_io

    try:
        import cv2
    except ImportError as e:
        fail(f"evaluation over JPEG: OpenCV (cv2) does not import on the card's machine ({e}); "
             "the JPEG tree is written and held against cv2.imread there")
    import numpy as np

    src = Path(inputs["dsec"]["img_dir"])
    jpeg_dir, twin_dir = root / "dsec_jpeg", root / "dsec_twin"
    files, damaged = [], []
    rng = np.random.default_rng(8)
    for i, png in enumerate(sorted(src.rglob("*.png"))):
        rel = png.relative_to(src)
        progressive = int(i % JPEG_PROGRESSIVE_EVERY == 0)
        ok, buf = cv2.imencode(".jpg", cv2.imread(str(png)), [
            cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        if not ok:
            fail(f"cv2.imencode of {png}")
        for d in (jpeg_dir, twin_dir):
            (d / rel).parent.mkdir(parents=True, exist_ok=True)
        data, damage = buf.tobytes(), JPEG_DAMAGED_FRAMES.get(i)
        start = _coded_data_start(data)
        for _ in range(16):  # a damage that cv2.imread reads
            if damage == "cut":
                bad = data[:int(rng.integers(start + (len(data) - start) // 4, len(data) - 2))]
            elif damage == "byte":
                bad = bytearray(data)
                pos = int(rng.integers(start, len(data) - 2))
                bad[pos] = (bad[pos] + int(rng.integers(1, 256))) % 256
                bad = bytes(bad)
            elif damage == "png_ancillary_crc":
                bad = _with_bad_text_chunk(png.read_bytes())
            else:
                bad = data
            (jpeg_dir / rel).write_bytes(bad)
            if cv2.imread(str(jpeg_dir / rel)) is not None:
                break
        else:
            fail(f"evaluation over JPEG: no {damage} damage of {png.name} that cv2.imread reads")
        image_io.imwrite(str(twin_dir / rel), cv2.imread(str(jpeg_dir / rel)), level=1)
        (damaged if damage else files).append(jpeg_dir / rel)
    over = {name: {**inputs, "dsec": {**inputs["dsec"], "img_dir": str(d)}}
            for name, d in (("jpeg", jpeg_dir), ("twin", twin_dir))}
    return files, damaged, over["jpeg"], over["twin"]


def check_jpeg_sweep(root: Path) -> None:
    """``image_io.imread`` against the card machine's ``cv2.imread`` under
    both flags on JPEGs that machine's ``cv2.imencode`` writes: 8 sizes (1x1
    to 480x640) x qualities 5, 50, 90, 100 x samplings 4:2:0, 4:2:2, 4:4:4,
    4:4:0, 4:1:1 x sequential or progressive; restart intervals 1, 2, 7;
    gray; noise at qualities 1 and 100. Fails on any mismatch, naming its
    kind, so that a sampling where that OpenCV and the tests' disagree shows."""
    import itertools

    import cv2
    import numpy as np

    from frn_tpu_torch.data import image_io

    def scene(h, w, seed):
        rng = np.random.default_rng(seed)
        y, x = np.mgrid[:h, :w]
        img = np.stack([(x * 3 + y) % 256, (x * y) % 256, 128 + 100 * np.sin(x / 5.0 + y / 7.0)], -1)
        return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)

    cases = []
    for (h, w), q, sampling, prog in itertools.product(
            ((1, 1), (2, 3), (5, 2), (9, 17), (16, 16), (31, 45), (64, 96), (480, 640)),
            (5, 50, 90, 100), ("420", "422", "444", "440", "411"), (0, 1)):
        cases.append((f"{h}x{w} q {q} sampling {sampling}" + (" progressive" if prog else ""),
                      scene(h, w, h * w + q),
                      [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]))
    for interval, prog in itertools.product((1, 2, 7), (0, 1)):
        cases.append((f"restart interval {interval}" + (" progressive" if prog else ""),
                      scene(64, 96, interval), [cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                                                cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                                                cv2.IMWRITE_JPEG_OPTIMIZE, 1]))
    noise = np.random.default_rng(1).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    for prog in (0, 1):
        cases.append((f"gray{' progressive' if prog else ''}", scene(64, 96, 3)[:, :, 0],
                      [cv2.IMWRITE_JPEG_PROGRESSIVE, prog]))
        for q in (1, 100):
            cases.append((f"noise q {q}{' progressive' if prog else ''}", noise,
                          [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE, prog]))
    t0 = time.perf_counter()
    path = root / "sweep.jpg"
    for kind, img, params in cases:
        ok, buf = cv2.imencode(".jpg", img, params)
        if not ok:
            fail(f"cv2.imencode of the JPEG sweep's {kind}")
        path.write_bytes(buf.tobytes())
        for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
            want, got = cv2.imread(str(path), flag), image_io.imread(str(path), flag)
            if want is None or got.shape != want.shape or not np.array_equal(got, want):
                fail(f"image_io.imread differs from cv2.imread on the JPEG sweep's {kind} (flag {flag})")
    print(f"JPEG sweep: image_io.imread equals OpenCV {cv2.__version__}'s cv2.imread on "
          f"{2 * len(cases)} reads ({len(cases)} files: 8 sizes x 4 qualities x 5 samplings x "
          f"sequential or progressive, restarts, gray, noise; both flags) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def time_other_jpeg(other: str, frames: int = 12, reps: int = 10) -> None:
    """Another revision's JPEG decoder (its ``native/jpeg.cpp``, built by
    g++ with the port's flags) against this one, in turns file by file, on
    480x640 frames that this machine's ``cv2.imencode`` writes at quality
    JPEG_QUALITY (every third progressive): each decoder's median ms a frame
    and the per-file ratio's median and quartiles, with the host's card
    named. Both outputs must be equal on every frame. Needs no card:

        python3 -c "import chip_smoke as c; c.time_other_jpeg('<copy>/frn_tpu_torch/native/jpeg.cpp')"
    """
    import ctypes

    import cv2
    import numpy as np

    from frn_tpu_torch.utils import native

    out_dir = Path(tempfile.mkdtemp())
    lib_path = out_dir / "libother_jpeg.so"
    subprocess.run(["g++", *native.GXX_FLAGS, "-o", str(lib_path), other], check=True)
    libs = {"this": native.jpeg_lib(), "other": ctypes.CDLL(str(lib_path))}
    for lib in libs.values():
        lib.frn_jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int]
        lib.frn_jpeg_decode.restype = ctypes.c_int
    rng = np.random.default_rng(12)
    y, x = np.mgrid[:480, :640]
    files = []
    for i in range(frames):
        img = np.stack([(x * 3 + y + 17 * i) % 256, (x * y // (i + 1)) % 256,
                        128 + 100 * np.sin(x / (5.0 + i) + y / 7.0)], -1)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY,
                                             cv2.IMWRITE_JPEG_PROGRESSIVE, int(i % 3 == 0)])
        files.append(np.frombuffer(buf.tobytes(), np.uint8))
    err = ctypes.create_string_buffer(256)
    outs = {name: np.empty((480, 640, 3), np.uint8) for name in libs}
    times = {name: [] for name in libs}
    ratios = []
    for rep in range(reps):
        for i, data in enumerate(files):
            ms = {}
            for name in (("this", "other") if (rep + i) % 2 else ("other", "this")):
                t0 = time.perf_counter()
                rc = libs[name].frn_jpeg_decode(data.ctypes.data, data.size, 0, outs[name].ctypes.data,
                                                err, len(err))
                ms[name] = (time.perf_counter() - t0) * 1e3
                times[name].append(ms[name])
                if rc != 0:
                    fail(f"the {name} JPEG decoder refused a sound frame: {err.value!r}")
            if not np.array_equal(outs["this"], outs["other"]):
                fail(f"the other JPEG decoder ({other}) decodes frame {i} otherwise than this one")
            ratios.append(ms["this"] / ms["other"])
    quartiles = statistics.quantiles(ratios, n=4)
    print(f"JPEG decoders in turns, 480x640 BGR, host of {card_name_and_power_limit()}, {reps} x "
          f"{frames} frames: this revision median {statistics.median(times['this']):.3f} ms, "
          f"{other} {statistics.median(times['other']):.3f} ms; this / other per file median "
          f"{statistics.median(ratios):.3f} (quartiles {quartiles[0]:.3f}-{quartiles[2]:.3f}); "
          "outputs equal", flush=True)


def compare_eval_with_twin(name: str, over: dict, over_twin: dict, root: Path) -> None:
    """``cli.test`` DSEC bf16 over a tree of frames (``over``) and over its
    PNG twin: B1 4 times a batch and nothing else in each run, and equal
    detections and summaries."""
    import pickle

    import numpy as np

    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    runs = []
    for label, inputs, suffix in ((name, over, ""), ("its PNG twin", over_twin, "_twin")):
        folder = str(root / f"eval_dsec_bf16_{name.split()[-1].lower()}{suffix}")
        label = f"DSEC bf16 over {label}"
        text, counts, _ = run_eval_cli(label, "test", _cli_flags(inputs, "dsec", folder, "--compute_dtype",
                                                                  "bfloat16"))
        if counts != {**dict.fromkeys(_COUNTERS, 0), "flash_fwd": 4 * batches}:
            fail(f"evaluation ({label}) launched {counts}, expected B1 {4 * batches} times")
        fps, summary = check_eval_summary(label, text, folder)
        with open(Path(folder) / "detections.txt", "rb") as f:
            runs.append((fps, summary, pickle.load(f)))
    (fps_t, sum_t, det_t), (fps_p, sum_p, det_p) = runs
    same = len(det_t) == len(det_p) and all(
        len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        for a, b in zip(det_t, det_p))
    n_det = sum(len(x) for per_image in det_t for x in per_image)
    print(f"evaluation DSEC bf16 over {name} vs its PNG twin: B1 {4 * batches} launches each, "
          f"{n_det} detections, equal: {same}; summaries equal: {sum_t == sum_p}; {fps_t:.2f} img/s over "
          f"{name}, {fps_p:.2f} over PNG (the CLI's, first batch included)", flush=True)
    if not (same and sum_t == sum_p):
        fail(f"evaluation over {name} differs from the same frames' PNG twin")


def check_jpeg_evaluation(inputs: dict, root: Path) -> None:
    """The port's JPEG decoder on the card's machine: ``image_io.imread``
    equal to that machine's ``cv2.imread`` on every file of the JPEG tree
    (its damaged frames included) under both flags; the JPEG sweep and the
    damage sweep; the host ms of both per sound 480x640 image; then
    ``cli.test`` DSEC bf16 over the JPEG tree and over its PNG twin (B1 4
    times a batch, nothing else), whose detections and summaries must be
    equal, and the CLI's eval loop again warm over each, in turns (JPEG,
    PNG, PNG, JPEG)."""
    import cv2
    import numpy as np

    from frn_tpu_torch.data import image_io

    t0 = time.perf_counter()
    files, damaged, over_jpeg, over_twin = write_jpeg_trees(inputs, root)
    print(f"evaluation over JPEG: {len(files) + len(damaged)} DSEC frames re-encoded by OpenCV "
          f"{cv2.__version__} (quality {JPEG_QUALITY}, 4:2:0, one in {JPEG_PROGRESSIVE_EVERY} "
          f"progressive), {len(damaged)} of them damaged as cv2.imread still reads them "
          f"({', '.join(JPEG_DAMAGED_FRAMES.values())}), and their PNG twin written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for path in files + damaged:
        for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
            want, got = cv2.imread(str(path), flag), image_io.imread(str(path), flag)
            if want is None or got.shape != want.shape or not np.array_equal(got, want):
                fail(f"image_io.imread differs from cv2.imread on {path.name} (flag {flag})")
    print(f"image_io.imread equals cv2.imread on all {len(files) + len(damaged)} files of the JPEG "
          f"tree, the damaged ones included, under IMREAD_COLOR and IMREAD_GRAYSCALE", flush=True)
    check_jpeg_sweep(root)
    check_damage_sweep(root)
    # in turns file by file, the first reader alternating, so that the host's
    # drift falls on both: the median of each reader's ms and of their ratio
    reads = (("port", image_io.imread), ("cv2.imread", cv2.imread))
    for _, read in reads:
        read(str(files[0]))
    times = {name: [] for name, _ in reads}
    ratios = []
    for rep in range(JPEG_DECODE_REPS):
        for i, path in enumerate(files):
            ms = {}
            for name, read in reads[::-1] if (rep + i) % 2 else reads:
                t0 = time.perf_counter()
                read(str(path))
                ms[name] = (time.perf_counter() - t0) * 1e3
                times[name].append(ms[name])
            ratios.append(ms["port"] / ms["cv2.imread"])
    port_ms, cv2_ms = (statistics.median(times[name]) for name, _ in reads)
    quartiles = statistics.quantiles(ratios, n=4)
    print(f"JPEG decode, 480x640 BGR, host of {card_name_and_power_limit()}, in turns file by file "
          f"over {JPEG_DECODE_REPS} x {len(files)} files: port median {port_ms:.3f} ms per image "
          f"({1e3 / port_ms:.1f} img/s), cv2.imread {cv2_ms:.3f} ms ({1e3 / cv2_ms:.1f} img/s); "
          f"port / cv2 per file median {statistics.median(ratios):.3f} (quartiles "
          f"{quartiles[0]:.3f}-{quartiles[2]:.3f})", flush=True)

    compare_eval_with_twin("JPEG", over_jpeg, over_twin, root)

    from frn_tpu_torch.eval.detections import collect_detections

    loops = {"JPEG": [], "PNG twin": []}
    built = {name: eval_model(over, "dsec", "--compute_dtype", "bfloat16")
             for name, over in (("JPEG", over_jpeg), ("PNG twin", over_twin))}
    for name in ("JPEG", "PNG twin", "PNG twin", "JPEG"):
        _, ds, config, infer = built[name]
        _, warm_s = collect_detections(ds, infer, config, batch_size=EVAL_BATCH)
        loops[name].append(EVAL_IMAGES / warm_s)
    print("evaluation DSEC bf16, the eval loop warm in turns (JPEG, PNG, PNG, JPEG): "
          + "; ".join(f"{name} {', '.join(f'{v:.2f}' for v in vals)} img/s"
                      for name, vals in loops.items()), flush=True)
    del built
    torch.cuda.empty_cache()


# phase 8's format sweep: every variant of tests/test_torch_image_formats.py
# and tests/test_torch_image_tiff.py (built by tests/torch_image_variants.py:
# BMP, PBM/PGM/PPM, PAM, PFM, Sun raster, Radiance HDR, GIF, TIFF), each cut
# at FORMAT_EACH lengths and changed at FORMAT_EACH seeded bytes, and their
# damaged files at FORMAT_CUTS lengths and FORMAT_CHANGES seeded bytes, as
# the CPU tests cut and change them (4 of each of some 450 variants keeps
# the whole script well inside its time limit)
FORMAT_EACH, FORMAT_CUTS, FORMAT_CHANGES = 4, 32, 100
# variants on which this machine's OpenCV and the one the CPU tests run
# against (5.0.0) read otherwise, with the reason: their reads, whole, cut and
# changed, are left out; the port follows the tests' OpenCV, and each is named
# in ROADMAP's Queue C
FORMATS_LEFT_OUT = {
    "pam_grayscale_depth_3": "OpenCV 4.13 reads a PAM whose tuple type does not fit its depth "
                             "(GRAYSCALE at depth 3); OpenCV 5.0 returns None",
    "pam_rgb_depth_4": "OpenCV 4.13 reads a PAM whose tuple type does not fit its depth (RGB at "
                       "depth 4); OpenCV 5.0 returns None",
}
# the format evaluation's DSEC tree: its frames spread over these lossless
# colour kinds in turn
FORMAT_TREE_KINDS = ("BMP 24-bit", "BMP 32-bit", "PPM P6", "PAM RGB", "Sun raster 24-bit",
                     "TIFF LZW strips", "TIFF Deflate tiles")
# the kinds whose reads are timed in turns with cv2.imread's
FORMAT_TIMED_KINDS = ("BMP 24-bit", "PPM P6", "TIFF LZW strips", "TIFF Deflate tiles")
FORMAT_DECODE_REPS = 10


def _image_variants():
    """``tests/torch_image_variants.py``, loaded by its path: it imports
    numpy, OpenCV, PIL where installed and the port's ``image_io``, nothing
    of JAX."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_image_variants", Path(__file__).resolve().parent / "tests" / "torch_image_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_format_sweep(root: Path) -> None:
    """``image_io.imread`` against this machine's ``cv2.imread`` under both
    flags on every variant of the CPU tests of the seven formats OpenCV
    decodes with its own code and of TIFF, whole, cut and changed at seeded
    bytes (FORMAT_EACH times each, FORMAT_CUTS and FORMAT_CHANGES times the
    CPU tests' damaged files): equal arrays, None on both sides (the port's
    ``UnreadableImage``) or cv2.error against a plain ``ValueError``; a PAM
    that OpenCV reads into uninitialized memory under a flag is refused by
    the port there. Mismatches are gathered by (variant, damage) and fail
    the phase; the variants in FORMATS_LEFT_OUT are not read. Prints this
    OpenCV's Media I/O lines for the eight codecs. Needs no card:

        python3 -c "import chip_smoke as c, tempfile, pathlib; c.check_format_sweep(pathlib.Path(tempfile.mkdtemp()))"
    """
    import cv2
    import numpy as np

    from frn_tpu_torch.data import image_io

    lines = [" ".join(line.split()) for line in cv2.getBuildInformation().splitlines()
             if line.strip().split(":")[0] in ("GIF", "HDR", "SUNRASTER", "PXM", "PFM", "TIFF")]
    print(f"format sweep: OpenCV {cv2.__version__} Media I/O (BMP is always built in): "
          + "; ".join(lines), flush=True)
    variants_module = _image_variants()
    variants = {**variants_module.variants(), **variants_module.tiff_variants(),
                **variants_module.tiff_damaged()}
    damaged = variants_module.DAMAGED + variants_module.TIFF_DAMAGED
    logging = getattr(getattr(cv2, "utils", None), "logging", None)
    if logging is not None:  # OpenCV logs each refused read; the counts below say it all
        level = logging.getLogLevel()
        logging.setLogLevel(logging.LOG_LEVEL_SILENT)
    rng = np.random.default_rng(27)
    cases = []
    for name, data in sorted(variants.items()):
        cuts, changes = (FORMAT_CUTS, FORMAT_CHANGES) if name in damaged else (FORMAT_EACH, FORMAT_EACH)
        cases.append((name, "whole", data))
        cases += [(name, "cut", data[:int(n)]) for n in np.linspace(0, len(data) - 1, cuts)]
        for _ in range(changes):
            changed = bytearray(data)
            pos = int(rng.integers(0, len(data)))
            changed[pos] = (changed[pos] + int(rng.integers(1, 256))) % 256
            cases.append((name, "byte", bytes(changed)))
    path = root / "format.bin"
    agree = {"image": 0, "none": 0, "error": 0, "undefined": 0}
    mismatches: dict = {}
    t0 = time.perf_counter()
    for name, damage, data in cases:
        if name in FORMATS_LEFT_OUT:
            continue
        path.write_bytes(data)
        for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
            want = variants_module.read_outcome(cv2.imread, path, flag)
            got = variants_module.read_outcome(image_io.imread, path, flag)
            if got[0] == "undefined" and want[0] == "image":
                agree["undefined"] += 1
            elif want[0] == got[0] and (want[0] != "image" or (
                    got[1].shape == want[1].shape and np.array_equal(got[1], want[1]))):
                agree[want[0]] += 1
            else:
                what = f"flag {flag}: cv2 {want[0]}, port {got[0] if got[0] != want[0] else 'another image'}"
                mismatches.setdefault((name, damage), []).append(what)
    if logging is not None:
        logging.setLogLevel(level)
    reads = sum(agree.values()) + sum(len(v) for v in mismatches.values())
    print(f"format sweep: {sum(agree.values())} of {reads} reads of {len(variants)} variants, "
          f"{FORMAT_EACH} cuts and {FORMAT_EACH} changed bytes of each ({FORMAT_CUTS} and "
          f"{FORMAT_CHANGES} of the CPU tests' {len(damaged)} damaged files; both "
          f"flags) agree with OpenCV {cv2.__version__}'s cv2.imread: {agree['image']} images "
          f"equal, {agree['none']} None on both sides, {agree['error']} errors on both sides, "
          f"{agree['undefined']} uninitialized PAM reads refused; left out "
          f"{sorted(FORMATS_LEFT_OUT) or 'nothing'}; {time.perf_counter() - t0:.1f} s on the host of "
          f"{card_name_and_power_limit()}", flush=True)
    for (name, damage), what in sorted(mismatches.items()):
        print(f"format sweep mismatch: {name}, {damage}: {len(what)} reads, e.g. {what[0]}", flush=True)
    if mismatches:
        fail(f"image_io.imread differs from cv2.imread on the format sweep: {sorted(mismatches)}")


def write_format_trees(inputs: dict, root: Path):
    """The DSEC fixture's frames (480x640) rewritten in turn as the kinds of
    FORMAT_TREE_KINDS (under the fixture's PNG names: both readers go by
    content) and their PNG twin of cv2.imread's decodes under ``root``.
    Returns (the files, their kinds, the eval inputs over the tree, over the
    twin)."""
    import cv2
    import numpy as np

    from frn_tpu_torch.data import image_io

    variants = _image_variants()
    src = Path(inputs["dsec"]["img_dir"])
    tree_dir, twin_dir = root / "dsec_formats", root / "dsec_formats_twin"
    files, kinds = [], []
    for i, png in enumerate(sorted(src.rglob("*.png"))):
        rel, kind = png.relative_to(src), FORMAT_TREE_KINDS[i % len(FORMAT_TREE_KINDS)]
        img = cv2.imread(str(png))
        if kind == "BMP 32-bit":
            bgra = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=2)
            data = variants.bmp(img.shape[1], img.shape[0], 32, variants.bmp_rows(bgra[::-1], 32))
        elif kind == "TIFF LZW strips":
            data = variants.tiff(img[:, :, ::-1], 2, compression=5, rows=8, predictor=2)
        elif kind == "TIFF Deflate tiles":
            data = variants.tiff(img[:, :, ::-1], 2, compression=8, tile=(64, 64), order=">")
        else:
            ext = {"BMP 24-bit": ".bmp", "PPM P6": ".ppm", "PAM RGB": ".pam", "Sun raster 24-bit": ".ras"}
            ok, buf = cv2.imencode(ext[kind], img)
            if not ok:
                fail(f"evaluation over the formats: cv2.imencode of {png.name} as {kind}")
            data = buf.tobytes()
        for d in (tree_dir, twin_dir):
            (d / rel).parent.mkdir(parents=True, exist_ok=True)
        (tree_dir / rel).write_bytes(data)
        image_io.imwrite(str(twin_dir / rel), cv2.imread(str(tree_dir / rel)), level=1)
        files.append(tree_dir / rel)
        kinds.append(kind)
    over = {name: {**inputs, "dsec": {**inputs["dsec"], "img_dir": str(d)}}
            for name, d in (("tree", tree_dir), ("twin", twin_dir))}
    return files, kinds, over["tree"], over["twin"]


def check_format_evaluation(inputs: dict, root: Path) -> None:
    """The port's readers of OpenCV's own formats and TIFF on the card's
    machine: ``image_io.imread`` equal to that machine's ``cv2.imread`` on
    every frame of a DSEC tree at full width whose frames are spread over
    FORMAT_TREE_KINDS, under both flags; the host ms of both readers per
    480x640 frame of FORMAT_TIMED_KINDS, in turns file by file; then
    ``cli.test`` DSEC bf16 over the tree and over its PNG twin (B1 4 times a
    batch, nothing else), whose detections and summaries must be equal.
    Alone, after the build:

        python3 -c "import chip_smoke as c, tempfile, pathlib; c.phase_environment(); d = pathlib.Path(tempfile.mkdtemp()); c.check_format_evaluation(c.write_eval_inputs(d), d)"
    """
    import cv2
    import numpy as np

    from frn_tpu_torch.data import image_io

    t0 = time.perf_counter()
    files, kinds, over_tree, over_twin = write_format_trees(inputs, root)
    for path in files:
        for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
            want, got = cv2.imread(str(path), flag), image_io.imread(str(path), flag)
            if want is None or got.shape != want.shape or not np.array_equal(got, want):
                fail(f"image_io.imread differs from cv2.imread on {path.name} (flag {flag})")
    print(f"evaluation over the formats: {len(files)} DSEC frames at 480x640 rewritten as "
          f"{', '.join(f'{kinds.count(k)} {k}' for k in FORMAT_TREE_KINDS)} and their PNG twin in "
          f"{time.perf_counter() - t0:.1f} s; image_io.imread equals OpenCV {cv2.__version__}'s "
          "cv2.imread on every frame under IMREAD_COLOR and IMREAD_GRAYSCALE", flush=True)
    reads = (("port", image_io.imread), ("cv2.imread", cv2.imread))
    for kind in FORMAT_TIMED_KINDS:
        chosen = [p for p, k in zip(files, kinds) if k == kind]
        times = {name: [] for name, _ in reads}
        for rep in range(FORMAT_DECODE_REPS):
            for i, path in enumerate(chosen):
                for name, read in reads[::-1] if (rep + i) % 2 else reads:
                    t1 = time.perf_counter()
                    read(str(path))
                    times[name].append((time.perf_counter() - t1) * 1e3)
        port_ms, cv2_ms = (statistics.median(times[name]) for name, _ in reads)
        print(f"{kind} read, 480x640 BGR, host of {card_name_and_power_limit()}, in turns file by file "
              f"over {FORMAT_DECODE_REPS} x {len(chosen)} files: port median {port_ms:.3f} ms, "
              f"cv2.imread {cv2_ms:.3f} ms", flush=True)

    compare_eval_with_twin("the format tree", over_tree, over_twin, root)


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
        EVAL_SUMMARIES[label] = summary

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
        idle = profile_pass(f"evaluation profile ({label}): one batch of {EVAL_BATCH}, idle share "
                            f"of the warm eval loop's ms per batch", lambda: infer(rgb, event),
                            loop_ms, n_ops=8, n_kernels=8)
        EVAL_WARM_LOOPS[label] = (EVAL_IMAGES / warm_s, idle)
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
    check_jpeg_evaluation(inputs, root)
    check_format_sweep(root)
    check_format_evaluation(inputs, root)

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
             "stem": ("stem", "stem_launches"),
             "flash_fwd_noexp": ("flash_attention", "flash_fwd_noexp_launches")}


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


def check_damaged_dsec_det_frames(dataset) -> None:
    """One frame of the fixture damaged in place, then restored: cut short
    as a PNG, which this machine's cv2.imread returns None for, the loader's
    frame must be zeros at the geometry, as ``frn_tpu``'s dataset gives
    there; cut in its scan as a JPEG, which cv2.imread reads in part, the
    loader's frame must be cv2's."""
    import cv2
    import numpy as np

    seq = dataset.sequences[0]
    path = seq.image_paths[1]
    sound = path.read_bytes()
    try:
        path.write_bytes(sound[:len(sound) // 2])
        got = dataset.load_image_u8(seq, 1)
        if cv2.imread(str(path)) is not None:
            fail("raw DSEC-Det: cv2.imread reads a PNG frame cut at half")
        if got.shape != (dataset.height, dataset.width, 3) or got.any():
            fail(f"raw DSEC-Det: a frame cv2.imread returns None for loads as {got.shape}, not zeros")
        ok, buf = cv2.imencode(".jpg", cv2.imdecode(np.frombuffer(sound, np.uint8), cv2.IMREAD_COLOR),
                               [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY])
        data = buf.tobytes()
        path.write_bytes(data[:(_coded_data_start(data) + len(data)) // 2])
        want, got = cv2.imread(str(path)), dataset.load_image_u8(seq, 1)
        if want is None or got.shape != want.shape or not np.array_equal(got, want):
            fail("raw DSEC-Det: a JPEG frame cut in its scan loads otherwise than cv2.imread reads it")
        print(f"raw DSEC-Det: a frame cut short loads as zeros where OpenCV {cv2.__version__}'s "
              f"cv2.imread returns None, and as cv2's partial frame where it reads one "
              f"({int((want == 128).all(2).sum())} grey pixels)", flush=True)
    finally:
        path.write_bytes(sound)


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
    check_damaged_dsec_det_frames(datasets["f32"])
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


# phase 11: serving. The serve CLI's defaults: buckets 1-16, f32 compute, the
# compact wire, every bucket warmed up. One client sends SERVE_SINGLE
# requests one after another at max_delay_ms 0 (its engine's latency alone;
# its p99 over 100 samples). A burst is SERVE_CLIENTS closed-loop clients
# sending for SERVE_RAMP_S + SERVE_BURST_S seconds at the engine's
# max_delay_ms: requests/s, latency percentiles and batch fill are taken over
# the SERVE_BURST_S window after the SERVE_RAMP_S ramp-up (requests completed
# and batches dispatched in it); the requests in flight when the clients stop
# (the tail) are left out. The idle share is that of a profiled burst of
# SERVE_PROFILE_ROUNDS rounds of SERVE_CLIENTS requests. Requests are drawn in
# turn from a pool of SERVE_POOL seeded DSEC frames: a uint8 RGB image and a
# window of SERVE_EVENTS events spread uniformly over the frame and its 50 ms
# (a 50 ms DSEC window holds 25,000-50,000, clustered on edges), on every
# wire. The sparse engine takes cell_capacity SERVE_SPARSE_CELLS: such a
# window has at most SERVE_EVENTS nonzero cells, and the +-300 cells split
# into 3 each
SERVE_SINGLE, SERVE_CLIENTS, SERVE_POOL = 100, 16, 16
SERVE_RAMP_S, SERVE_BURST_S, SERVE_PROFILE_ROUNDS = 1.0, 8.0, 4
SERVE_EVENTS, SERVE_SPARSE_CELLS = 30_000, 32_768
# the bf16 engines' wires (the CLI's engine serves the compact wire at f32)
SERVE_BF16_WIRES = ("f32", "events", "sparse")
# requests of each engine held against their batch-1 forward: the logits and
# deltas of a request in its padded bucket against the same request alone,
# max|diff| over max|ref|, at f32 within EVAL_F32_REL_TOL; at bf16 within
# MAIN_REL_TOL or twice the one-ulp witness (the batch-1 forward with a
# random half of its inputs one bf16 ulp up), whichever is larger: another
# batch size may take another cuDNN algorithm, a change of rounding, and at
# random weights one bf16 ulp of the stem alone moves the logits by 8e-2
# (phase 6)
SERVE_BATCH1_CHECKS = 2
# the pipeline_depth A/B (``phase_serving_pipeline``, not in ``main``): the
# depths in turns, each a fresh engine over one bf16 model on this wire
SERVE_PIPELINE_TURNS, SERVE_PIPELINE_WIRE = (2, 1, 1, 2), "f32"


def _serve_pool(geo, wire: str, seed: int) -> list:
    """SERVE_POOL seeded requests of ``wire`` at the geometry's full size, each
    (engine method, its arguments): 'compact' and 'sparse' the raw uint8
    frame and count voxel (sparse: one cell at +300 and one at -301 in every
    other request, past int8); 'f32' the host-normalized tensors; 'events' the
    raw stream and the frame."""
    import numpy as np

    from frn_tpu_torch.data.transforms import normalize_rgb
    from frn_tpu_torch.ops.voxelize import normalize_event_voxel_np, voxelize_events_np

    rng = np.random.default_rng(seed)
    pool = []
    for i in range(SERVE_POOL):
        rgb = rng.integers(0, 256, (geo.height, geo.width, 3), dtype=np.uint8)
        x = rng.integers(0, geo.width, SERVE_EVENTS)
        y = rng.integers(0, geo.height, SERVE_EVENTS)
        t = 1_700_000_000_000 + np.sort(rng.integers(0, 50_000, SERVE_EVENTS))  # raw us timestamps
        p = rng.integers(0, 2, SERVE_EVENTS)
        if wire == "events":
            pool.append(("submit_events", (x, y, t, p, rgb)))
            continue
        voxel = np.transpose(voxelize_events_np(x, y, t, p, geo.event_channels, geo.height,
                                                geo.width), (1, 2, 0))
        if wire == "sparse" and i % 2 == 0:
            voxel[7, 9, 0], voxel[7, 9, 1] = 300.0, -301.0
        if wire == "f32":
            rgb = normalize_rgb(rgb.astype(np.float32) / 255.0, geo)
            voxel = normalize_event_voxel_np(voxel)
        pool.append(("submit", (rgb, voxel)))
    return pool


def _drive_clients(send, pool: list, clients: int, rounds: int):
    """``clients`` threads, each sending ``rounds`` requests one after another
    (``send(request)`` returns its latency in ms); returns (latencies, wall
    seconds). Fails on any error."""
    import threading

    lat, errors, lock = [], [], threading.Lock()

    def client(c):
        for k in range(rounds):
            try:
                ms = send(pool[(c * rounds + k) % len(pool)])
            except Exception as e:  # every future must resolve with a result
                with lock:
                    errors.append(repr(e))
                return
            with lock:
                lat.append(ms)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        fail(f"serving: {len(errors)} of {clients * rounds} requests failed: {errors[:3]}")
    return lat, wall


def _drive_window(send, pool: list, clients: int, ramp_s: float = SERVE_RAMP_S,
                  burst_s: float = SERVE_BURST_S):
    """``clients`` closed-loop threads sending for ``ramp_s`` + ``burst_s``
    seconds; returns (the latencies of the requests completed in the window
    after the ramp-up, (window start, window end) on the perf_counter clock,
    requests sent in all). Fails on any error."""
    import threading

    done, errors, lock = [], [], threading.Lock()
    t_lo = time.perf_counter() + ramp_s
    t_hi = t_lo + burst_s

    def client(c):
        k = c
        while time.perf_counter() < t_hi:
            try:
                ms = send(pool[k % len(pool)])
            except Exception as e:  # every future must resolve with a result
                with lock:
                    errors.append(repr(e))
                return
            with lock:
                done.append((time.perf_counter(), ms))
            k += clients

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors or any(th.is_alive() for th in threads):
        fail(f"serving: {len(errors)} of the burst's requests failed: {errors[:3]}")
    return [ms for t, ms in done if t_lo <= t <= t_hi], (t_lo, t_hi), len(done)


def _percentiles(lat) -> str:
    import numpy as np

    q = np.percentile(np.asarray(lat, np.float64), [50, 90, 99])
    return f"p50 {q[0]:.2f} p90 {q[1]:.2f} p99 {q[2]:.2f} ms over {len(lat)} requests"


def check_served_exact(label: str, engine, records) -> int:
    """Each request of each recorded batch against the direct forward of the
    same padded batch (``engine.wire_batch``, ``engine.device_program`` and
    the host threshold and cap): scores, labels and boxes equal bit for bit.
    Returns the requests checked."""
    import numpy as np

    thr = engine.options.score_threshold
    cap = engine.options.max_detections or engine.config.eval.max_detections
    checked = 0
    for rec in records:
        scores, labels, boxes = (x.cpu().numpy() for x in engine.device_program(
            *engine.wire_batch(rec.requests, rec.bucket)))
        for i, req in enumerate(rec.requests):
            det = req.future.result(timeout=0)
            keep = scores[i] > thr
            want = (scores[i][keep][:cap], labels[i][keep][:cap], boxes[i][keep][:cap])
            if not (det.batch_size == rec.bucket and all(
                    np.array_equal(g, w) for g, w in zip((det.scores, det.labels, det.boxes), want))):
                fail(f"serving ({label}): a request in a bucket of {rec.bucket} differs from the "
                     f"direct forward of its padded batch")
            checked += 1
    return checked


def check_served_batch1(label: str, engine, records, bf16: bool) -> None:
    """SERVE_BATCH1_CHECKS requests that rode a bucket > 1: their logits and
    deltas in the padded bucket against their batch-1 forward (the gate in
    the comment at SERVE_BATCH1_CHECKS), beside the one-ulp witness; the
    detections' agreement printed."""
    model, eval_output = engine.infer_fn.model, engine.infer_fn.eval_output
    done = 0
    for rec in records:
        if rec.bucket == 1 or done == SERVE_BATCH1_CHECKS:
            continue
        with torch.inference_mode():
            rgb, voxel = engine.model_inputs(*engine.wire_batch(rec.requests, rec.bucket))
            padded = model(rgb, voxel, eval_output=eval_output, train=False)
            alone = model(rgb[:1], voxel[:1], eval_output=eval_output, train=False)
            dt = torch.bfloat16 if bf16 else torch.float32
            gen = torch.Generator(device=rgb.device).manual_seed(done)
            x = rgb[:1].to(dt)
            up = torch.nextafter(x, torch.full_like(x, math.inf))
            half = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
            nudged = torch.where(half, up, x).float()
            witness = model(nudged, voxel[:1], eval_output=eval_output, train=False)
        rel = max(((p[:1] - a).abs().max() / a.abs().max()).item() for p, a in zip(padded, alone))
        wit = max(((w - a).abs().max() / a.abs().max()).item() for w, a in zip(witness, alone))
        gate = max(MAIN_REL_TOL, 2 * wit) if bf16 else EVAL_F32_REL_TOL
        det = rec.requests[0].future.result(timeout=0)
        s1, l1, _ = (v[0].cpu().numpy() for v in engine.infer_fn(rgb[:1], voxel[:1]))
        keep = s1 > engine.options.score_threshold
        same = len(det.scores) == int(keep.sum()) and bool((det.labels == l1[keep]).all())
        gap = float(abs(det.scores - s1[keep]).max()) if same and len(det.scores) else float("nan")
        print(f"serving ({label}): a request in a bucket of {rec.bucket} vs alone: logits and "
              f"deltas max|diff|/max|ref| {rel:.3e} (at most {gate:.1e}; one-ulp witness "
              f"{wit:.3e}); detections {len(det.scores)} vs {int(keep.sum())}, labels "
              f"{'equal' if same else 'differ'}, scores within {gap:.3e}", flush=True)
        if not rel <= gate:
            fail(f"serving ({label}): a request's outputs in a bucket of {rec.bucket} are "
                 f"{rel:.3e} off its batch-1 forward")
        done += 1
    if done < SERVE_BATCH1_CHECKS:
        fail(f"serving ({label}): only {done} batches rode a bucket > 1")


def check_served_wire(label: str, engine, records, pool: list) -> None:
    """The events and sparse wires on the card: the fullest recorded batch's
    device count grid (``voxelize_events_batched``; ``voxel_from_sparse`` of
    the uint16 deltas' bits) equal to the host's grid of each request,
    exactly: the host voxelizer's of its raw stream (events), the voxel it
    encoded, with its +-300 cells past int8 (sparse); the squashed grid the
    model takes within WIRE_TANH_RTOL of the host squash, the standardized
    RGB exact. A request's pool entry is found by its RGB array, which the
    engine keeps as given (uint8)."""
    import numpy as np

    from frn_tpu_torch.data.transforms import normalize_rgb
    from frn_tpu_torch.ops.voxelize import (normalize_event_voxel_np, voxel_from_sparse,
                                            voxelize_events_batched, voxelize_events_np)

    geo = engine.config.geometry
    events = engine.options.wire_format == "events"
    source = {id(a[-1] if events else a[0]): a for _, a in pool}
    rec = max(records, key=lambda r: len(r.requests))
    tensors = engine.wire_batch(rec.requests, rec.bucket)
    with torch.inference_mode():
        if events:
            grid = voxelize_events_batched(*tensors[1:], num_bins=geo.event_channels,
                                           height=geo.height, width=geo.width)
        else:
            grid = torch.stack([voxel_from_sparse(d.int() & 0xFFFF, c, geo.event_channels,
                                                  geo.height, geo.width).permute(1, 2, 0)
                                for d, c in zip(*tensors[1:])])
        rgb, voxel = (x.cpu().numpy() for x in engine.model_inputs(*tensors))
    grid, big = grid.cpu().numpy(), 0.0
    for i, req in enumerate(rec.requests):
        a = source[id(req.rgb)]
        if events:
            host = np.transpose(voxelize_events_np(*a[:4], geo.event_channels, geo.height,
                                                   geo.width), (1, 2, 0))
        else:
            host = a[1]
        big = max(big, float(np.abs(host).max()))
        if not np.array_equal(grid[i], host):
            fail(f"serving ({label}): the device count grid of request {i} differs from the host's")
        if not np.allclose(voxel[i], normalize_event_voxel_np(host), rtol=WIRE_TANH_RTOL, atol=0):
            fail(f"serving ({label}): the squashed grid of request {i} is "
                 f"{_ulps(voxel[i], normalize_event_voxel_np(host)):.1f} ulps off the host's")
        if not np.array_equal(rgb[i], normalize_rgb(req.rgb.astype(np.float32) / 255.0, geo)):
            fail(f"serving ({label}): the standardized RGB of request {i} differs from the host's")
    print(f"serving ({label}): the device count grids of a batch of {len(rec.requests)} (bucket "
          f"{rec.bucket}) equal the host's exactly (largest |count| {big:.0f}); squashed within "
          f"{WIRE_TANH_RTOL:.0e}, RGB exact", flush=True)


def _serve_sender(engine, pool: list, http=None):
    """(send, requests): ``send(request)`` submits one request and returns its
    latency in ms, submit to result; over HTTP (``http`` = (server, npz
    bodies)) the client's wall time of its POST /infer."""
    if http is not None:
        return (lambda body: _http_infer(http[0], body)), http[1]
    return (lambda req: getattr(engine, req[0])(*req[1]).result(timeout=120).latency_ms), pool


def serve_wire(label: str, engine, pool: list, kernel_rows, want_per_batch: dict,
               http=None) -> dict:
    """One engine's traffic on the card, after its warm-up: SERVE_SINGLE
    requests from one client at max_delay_ms 0, then a burst window (both
    over HTTP through ``http`` = (server, npz bodies) when given), launch
    counts zeroed just before and read just after (``want_per_batch``
    launches a batch, nothing else), every future resolved; then the checks
    (each request against the direct forward of its padded batch; batch-1
    forwards; the wire's device decode), the breakdown and a profiled burst
    for the idle share. Returns the printed numbers."""
    import collections
    import dataclasses as dc

    import numpy as np

    from frn_tpu_torch.serve.engine import request_wire_bytes

    nbytes = request_wire_bytes(engine.config.geometry, engine.options)
    send, requests = _serve_sender(engine, pool, http)
    engine.record_batches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    delay = engine.options.max_delay_ms
    engine.options = dc.replace(engine.options, max_delay_ms=0.0)
    single, _ = _drive_clients(send, requests, 1, SERVE_SINGLE)
    engine.options = dc.replace(engine.options, max_delay_ms=delay)
    n_single = len(engine.batch_records())
    burst, (t_lo, t_hi), sent = _drive_window(send, requests, SERVE_CLIENTS)
    torch.cuda.synchronize()
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    records = engine.batch_records()
    want = {**dict.fromkeys(_COUNTERS, 0),
            **{k: v * len(records) for k, v in want_per_batch.items()}}
    if counts != want:
        fail(f"serving ({label}) launched {counts} over {len(records)} batches, expected {want}")
    for k in want_per_batch:
        kernel_rows[k]["launches"] += counts[k]
    window = [r for r in records[n_single:] if t_lo <= r.t_dispatch <= t_hi]
    fill = sum(len(r.requests) for r in window) / sum(r.bucket for r in window)
    sizes = dict(sorted(collections.Counter(len(r.requests) for r in window).items()))
    host_ms = [float(np.median([r.host_ms for r in part])) for part in (records[:n_single], window)]
    rps = len(burst) / SERVE_BURST_S
    print(f"serving ({label}) on {card_name_and_power_limit()}: h2d {nbytes} bytes per request; "
          f"one client, max_delay_ms 0: {_percentiles(single)}; burst of {SERVE_CLIENTS} clients "
          f"(max_delay_ms {delay:g}{', over HTTP' if http else ''}), the {SERVE_BURST_S:g} s after "
          f"a {SERVE_RAMP_S:g} s ramp-up: {_percentiles(burst)}, {rps:.2f} requests/s, "
          f"{len(window)} batches (requests: batches {sizes}), mean_batch_fill {fill:.3f} "
          f"({sent} burst requests in all); the dispatcher's host ms per batch, median: "
          f"{host_ms[0]:.2f} (one client), {host_ms[1]:.2f} (burst); peak memory {peak:.2f} GiB; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    checked = check_served_exact(label, engine, records)
    print(f"serving ({label}): {checked} requests in {len(records)} batches equal the direct "
          f"forward of their padded batch bit for bit", flush=True)
    check_served_batch1(label, engine, records, engine.config.model.compute_dtype == "bfloat16")
    if engine.options.wire_format in ("events", "sparse"):
        check_served_wire(label, engine, records, pool)
    serve_breakdown(label, engine, records)
    _, round_wall = _drive_clients(send, requests, SERVE_CLIENTS, SERVE_PROFILE_ROUNDS)
    idle = profile_pass(
        f"serving profile ({label}): a burst of {SERVE_CLIENTS} clients x {SERVE_PROFILE_ROUNDS}, "
        f"idle share of its unprofiled {round_wall * 1e3:.1f} ms",
        lambda: _drive_clients(send, requests, SERVE_CLIENTS, SERVE_PROFILE_ROUNDS),
        round_wall * 1e3, n_ops=4, n_kernels=6)
    stats = engine.stats()
    if "truncated_cells" in stats and stats["truncated_cells"]:
        fail(f"serving ({label}): {stats['truncated_cells']} cells truncated")
    if "truncated_events" in stats and stats["truncated_events"]:
        fail(f"serving ({label}): {stats['truncated_events']} events truncated")
    p_single = np.percentile(single, [50, 99])
    p_burst = np.percentile(burst, [50, 99])
    return {"bytes": nbytes, "single_p50": p_single[0], "single_p99": p_single[1],
            "burst_p50": p_burst[0], "burst_p99": p_burst[1], "rps": rps, "fill": fill,
            "idle": idle, "peak_gib": peak}


def serve_breakdown(label: str, engine, records) -> None:
    """Where one dispatch's time goes, on a recorded batch at bucket 1 and at
    its largest bucket: staging by the dispatcher's own host clock (its
    median over the recorded batches of that bucket); then, rerun from the
    batch's wire tensors with the dispatcher idle, ``model_inputs``, the
    forward and the pooled decode + NMS (whose greedy fixpoint reads a flag
    on the host every iteration), each by the host clock and by CUDA events
    on the card, median of 3."""
    from frn_tpu_torch.models.detector import decode_detections

    fn = engine.infer_fn
    by_bucket = {}
    for rec in records:
        by_bucket.setdefault(rec.bucket, []).append(rec)
    for bucket in sorted({1, max(by_bucket)} & set(by_bucket)):
        rec = by_bucket[bucket][0]
        stage = statistics.median(r.stage_ms for r in by_bucket[bucket])
        tensors = engine.wire_batch(rec.requests, bucket)
        host, dev = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            marks, events = [time.perf_counter()], [torch.cuda.Event(enable_timing=True)]
            events[0].record()

            def mark():
                marks.append(time.perf_counter())
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()

            with torch.inference_mode():
                rgb, voxel = engine.model_inputs(*tensors)
                mark()
                cls, reg = fn.model(rgb, voxel, eval_output=fn.eval_output, train=False)
                mark()
                decode_detections(cls, reg, fn.config, anchors=fn.anchors)
                mark()
            torch.cuda.synchronize()
            host.append([(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
            dev.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
        host = [statistics.median(x) for x in zip(*host)]
        dev = [statistics.median(x) for x in zip(*dev)]
        steps = ("wire decode", "forward", "decode + NMS")
        print(f"serving breakdown ({label}), {len(rec.requests)} requests in a bucket of {bucket}: "
              f"staging {stage:.2f} host ms (the dispatcher's, median of "
              f"{len(by_bucket[bucket])}); host ms / device ms: "
              + ", ".join(f"{n} {h:.2f} / {d:.2f}" for n, h, d in zip(steps, host, dev)),
              flush=True)


def _http_infer(server, body: bytes) -> float:
    """POST one npz body to /infer; its client-side latency in ms."""
    import urllib.request

    host, port = server.address
    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://{host}:{port}/infer", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        out = json.loads(resp.read())
    ms = (time.perf_counter() - t0) * 1e3
    if resp.status != 200 or not isinstance(out.get("detections"), list):
        fail(f"serving over HTTP: status {resp.status}, {str(out)[:200]}")
    return ms


def _http_checks(server) -> None:
    """/healthz, /stats and a malformed /infer (400) on the CLI's server."""
    import urllib.error
    import urllib.request

    host, port = server.address
    with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as r:
        if json.loads(r.read()) != {"ok": True}:
            fail("serving over HTTP: /healthz")
    with urllib.request.urlopen(f"http://{host}:{port}/stats", timeout=30) as r:
        if "mean_batch_fill" not in json.loads(r.read()):
            fail("serving over HTTP: /stats")
    req = urllib.request.Request(f"http://{host}:{port}/infer", data=b"not an npz", method="POST")
    try:
        urllib.request.urlopen(req, timeout=30)
        fail("serving over HTTP: a malformed /infer was answered")
    except urllib.error.HTTPError as e:
        if e.code != 400:
            fail(f"serving over HTTP: a malformed /infer gave {e.code}, not 400")


def _serve_model(inputs: dict, **model_kw):
    """Fusion ResNet-50 at DSEC's full width with phase 8's seeded ``.pth``,
    on the card; (model, config)."""
    from frn_tpu_torch.config import DSEC, FrameworkConfig, ModelConfig
    from frn_tpu_torch.convert import load_reference_checkpoint
    from frn_tpu_torch.models.detector import init_detector

    cfg = FrameworkConfig(geometry=DSEC, model=ModelConfig(
        variant="fusion", depth=50, num_classes=3, **model_kw))
    model = init_detector(cfg, seed=0)
    load_reference_checkpoint(inputs["dsec_pth"], model)
    return model, cfg


def _wire_options(wire: str, **kw):
    """ServeOptions of ``wire``: the sparse wire with SERVE_SPARSE_CELLS cells."""
    from frn_tpu_torch.serve import ServeOptions

    if wire == "sparse":
        kw["cell_capacity"] = SERVE_SPARSE_CELLS
    return ServeOptions(wire_format=wire, **kw)


def phase_serving(kernel_rows, inputs: dict) -> None:
    """Serving at full width (DSEC 480x640, fusion ResNet-50, feature size
    256, 3 classes, the seeded DSEC ``.pth`` of phase 8). Through the CLI:
    ``cli/serve.build_engine`` at its defaults (f32, the compact wire,
    buckets 1-16), every bucket warmed up, behind ``DetectionServer`` on
    loopback: /healthz, /stats, a malformed /infer (400), then its traffic
    (``serve_wire``) over HTTP (B1 at f32 4 times a batch). Then engines over
    one bf16 model on the f32, events and sparse wires (B1 4 times a batch),
    and one ``--attention_quant int8_qk`` engine on the compact wire (B4 and
    its pre-pass 4 times a batch)."""
    import io

    import numpy as np

    from frn_tpu_torch.cli import serve as serve_cli
    from frn_tpu_torch.config import DSEC
    from frn_tpu_torch.serve import DetectionServer, ServingEngine

    print(f"serving on {card_name_and_power_limit()}", flush=True)
    started = time.perf_counter()

    def mark(what):
        print(f"[phase 11 at {time.perf_counter() - started:.1f} s] {what}", flush=True)

    args = serve_cli.get_parser().parse_args(["--checkpoint", inputs["dsec_pth"], "--port", "0"])
    engine, config = serve_cli.build_engine(args)
    if (engine.options.wire_format, config.model.compute_dtype, engine.options.buckets) != (
            "compact", "float32", (1, 2, 4, 8, 16)):
        fail(f"serving: the CLI's defaults are {engine.options}, {config.model.compute_dtype}")
    engine.start()
    t0 = time.perf_counter()
    engine.warmup()
    mark(f"the CLI's engine warmed up, buckets {engine.options.buckets} "
         f"({time.perf_counter() - t0:.1f} s)")
    server = DetectionServer(engine, port=0, timeout_s=120).start_background()
    results = {}
    try:
        _http_checks(server)
        pool = _serve_pool(DSEC, "compact", seed=41)
        payloads = []
        for _, (rgb, voxel) in pool:
            buf = io.BytesIO()
            np.savez(buf, rgb=rgb, event=voxel.astype(np.int8))
            payloads.append(buf.getvalue())
        results["compact f32 (CLI)"] = serve_wire("compact wire, f32, the serve CLI", engine, pool,
                                                  kernel_rows, {"flash_fwd_f32": 4},
                                                  http=(server, payloads))
    finally:
        server.shutdown()
        engine.stop()
    del engine, server
    torch.cuda.empty_cache()
    mark("the CLI's engine served")

    model, cfg = _serve_model(inputs, compute_dtype="bfloat16")
    for wire in SERVE_BF16_WIRES:
        eng = ServingEngine(model, cfg, _wire_options(wire))
        with eng:
            eng.warmup()
            results[f"{wire} bf16"] = serve_wire(f"{wire} wire, bf16", eng,
                                                 _serve_pool(DSEC, wire, seed=42), kernel_rows,
                                                 {"flash_fwd": 4})
        mark(f"the {wire} wire served at bf16")
    del model, eng
    model, cfg = _serve_model(inputs, compute_dtype="bfloat16", attention_quant="int8_qk")
    with ServingEngine(model, cfg, _wire_options("compact")) as eng:
        eng.warmup()
        results["compact bf16 int8_qk"] = serve_wire(
            "compact wire, bf16, int8_qk", eng, _serve_pool(DSEC, "compact", seed=43), kernel_rows,
            {"flash_int8_qk": 4, "int8_qk_prepass": 4})
    del model, eng
    torch.cuda.empty_cache()
    mark("the int8_qk engine served")
    print("serving summary: " + json.dumps({k: {m: round(float(v), 3) for m, v in r.items()}
                                            for k, r in results.items()}), flush=True)


def phase_serving_pipeline(inputs: dict) -> None:
    """``pipeline_depth`` 1 against 2 on the card: one bf16 model, engines on
    SERVE_PIPELINE_WIRE in turns SERVE_PIPELINE_TURNS (a fresh engine each,
    warmed up), each a burst window as phase 11's (``_drive_window``);
    requests/s and latency per turn and the median per depth. Not run by
    ``main``: a measurement of the completer's overlap, which the NMS's host
    reads hold back (the module docstring gives its command)."""
    import numpy as np

    from frn_tpu_torch.config import DSEC
    from frn_tpu_torch.serve import ServingEngine

    model, cfg = _serve_model(inputs, compute_dtype="bfloat16")
    pool = _serve_pool(DSEC, SERVE_PIPELINE_WIRE, seed=44)
    by_depth = {}
    for depth in SERVE_PIPELINE_TURNS:
        with ServingEngine(model, cfg, _wire_options(SERVE_PIPELINE_WIRE,
                                                     pipeline_depth=depth)) as eng:
            eng.warmup()
            eng.record_batches()
            send, requests = _serve_sender(eng, pool)
            burst, (t_lo, t_hi), _ = _drive_window(send, requests, SERVE_CLIENTS)
            window = [r for r in eng.batch_records() if t_lo <= r.t_dispatch <= t_hi]
        rps = len(burst) / SERVE_BURST_S
        fill = sum(len(r.requests) for r in window) / sum(r.bucket for r in window)
        host_ms = float(np.median([r.host_ms for r in window]))
        by_depth.setdefault(depth, []).append(rps)
        print(f"serving pipeline ({SERVE_PIPELINE_WIRE} wire, bf16) on "
              f"{card_name_and_power_limit()}: pipeline_depth {depth}: {rps:.2f} requests/s, "
              f"{_percentiles(burst)}, {len(window)} batches, fill {fill:.3f}, the dispatcher's "
              f"host ms per batch, median {host_ms:.2f}", flush=True)
    print("serving pipeline summary, requests/s by pipeline_depth: " + json.dumps(
        {d: {"turns": [round(v, 3) for v in r], "median": round(statistics.median(r), 3)}
         for d, r in sorted(by_depth.items())}), flush=True)
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------ the trainer's instruments

# phase 12: about a DSEC window of events for the native voxelizer (5 bins,
# 480x640), a zoom-out's worth for the subsampler, the trainer's images (4
# micro-steps at the train CLI's batch 2, logged every 2), the traced
# micro-steps, the eval loop's turns (prefetched and current stream, in
# turns P C C P) and the augmented samples
NATIVE_EVENTS, SUBSAMPLE_EVENTS = 1_000_000, 20_000
INSTRUMENT_IMAGES, INSTRUMENT_LOG_EVERY, TRACED_STEPS = 8, 2, 2
PREFETCH_TURNS = ("prefetch", "current stream", "current stream", "prefetch")
# the eval loop's turns run over phase 8's 24 images (3 batches, where
# filling the prefetch is a third of the loop) and over this many (the 24
# cycled), nearer a steady state
PREFETCH_LONG_IMAGES = 64
AUGMENT_SAMPLES = 4
# frn_tpu's JSONL record of a log window: its keys in order and their JSON
# types (every metric goes through float(), the step stays an int)
METRICS_KEYS = ("step", "time", "epoch", "loss", "cls_loss", "reg_loss", "step_time_s")
# the native tanh squash (tanhf of v * (1 / 5) in C++) against numpy's
# tanh(v / 5): f32 ulps apart at most
NATIVE_TANH_ULPS = 4
# the f32 training kernels as the trace names them (B1-lse at f32 is the f32
# forward's tiled kernel with its lse output)
TRACE_KERNELS = ("flash_fwd_f32_tiled", "flash_bwd_dq_f32_tiled", "flash_bwd_dkv_f32_tiled")


def _host_ms(fn, reps: int = 5):
    """(median host ms of ``reps`` calls, the last call's result)."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def check_native_library():
    """The native host library built from the port's own source and loaded
    (a failed build fails the phase with g++'s message); its scatter against
    numpy's bincount through ``voxelize_events_np`` on NATIVE_EVENTS events,
    its subsampler against the Python fallback on SUBSAMPLE_EVENTS, exactly;
    its tanh squash against numpy's within NATIVE_TANH_ULPS. Returns the
    events (x, y, t, p) for the augmentations."""
    from unittest import mock

    import numpy as np

    from frn_tpu_torch.data import augment
    from frn_tpu_torch.ops import voxelize
    from frn_tpu_torch.utils import native

    t0 = time.perf_counter()
    path = native.build()
    lib = native.get_lib()
    if lib is None:
        fail(f"native library {path} built but did not load")
    print(f"native library: {path.relative_to(Path(__file__).resolve().parent)} "
          f"({time.perf_counter() - t0:.2f} s to build or find, and load)", flush=True)
    rng = np.random.default_rng(31)
    x = rng.integers(0, 640, NATIVE_EVENTS).astype(np.uint16)
    y = rng.integers(0, 480, NATIVE_EVENTS).astype(np.uint16)
    t = np.sort(rng.integers(0, 50_000, NATIVE_EVENTS)).astype(np.int64)
    p = rng.integers(0, 2, NATIVE_EVENTS).astype(np.int8)

    def vox():
        return voxelize.voxelize_events_np(x, y, t, p, 5, 480, 640)

    native_ms, got = _host_ms(vox)
    with mock.patch.object(voxelize, "native_voxelize", lambda *a, **k: None):
        numpy_ms, want = _host_ms(vox)
    if not np.array_equal(got, want) or not np.abs(got).sum():
        fail("native voxelization differs from numpy's bincount")
    print(f"native voxelization on {card_name_and_power_limit()}'s host: {NATIVE_EVENTS:,} events, "
          f"5x480x640: native {native_ms:.2f} ms, numpy bincount {numpy_ms:.2f} ms (medians of 5, "
          f"voxelize_events_np whole), grids equal", flush=True)

    pos = np.stack([rng.uniform(0, 639, SUBSAMPLE_EVENTS),
                    rng.uniform(0, 479, SUBSAMPLE_EVENTS)], 1).astype(np.float32)
    pol = rng.choice([-1.0, 1.0], SUBSAMPLE_EVENTS).astype(np.float32)
    sub_ms, (npos, nmask) = _host_ms(lambda: native.native_event_subsample(pos, pol, 480, 640), 3)
    t0 = time.perf_counter()
    ppos, pmask = augment._subsample_python(pos, pol, 480, 640)
    py_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(nmask, pmask) and np.array_equal(npos, ppos) and 0 < nmask.sum()):
        fail("native event subsampling differs from the Python fallback")
    print(f"native event subsampling: {SUBSAMPLE_EVENTS:,} events, {int(nmask.sum()):,} kept, equal "
          f"to the Python fallback; native {sub_ms:.2f} ms, Python {py_ms:.1f} ms", flush=True)

    grid = (want * 3).astype(np.float32)  # past the threshold, so the squash applies
    squashed = native.native_tanh_normalize(grid.copy())
    ulps = _ulps(squashed, voxelize.normalize_event_voxel_np(grid))
    print(f"native tanh squash against numpy's: at most {ulps:.1f} f32 ulps (gate "
          f"{NATIVE_TANH_ULPS})", flush=True)
    if not ulps <= NATIVE_TANH_ULPS:
        fail(f"native tanh squash differs from numpy's by {ulps} ulps")
    return x, y, t, p


class _Cycled(_FirstImages):
    """``count`` images that cycle through ``dataset``'s."""

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def _collect_on_current_stream(dataset, infer, config):
    """``collect_detections``' loop as it ran before the prefetch: each batch
    copied by ``to_device`` on the current stream, then run."""
    import numpy as np

    from frn_tpu_torch.data.loader import BatchLoader, to_device
    from frn_tpu_torch.eval.detections import _rows_to_host

    loader = BatchLoader(dataset, config.geometry, batch_size=EVAL_BATCH, shuffle=False,
                         num_threads=8, max_annots=1)
    out, t0 = [], time.perf_counter()
    for batch in loader:
        n_valid = int(batch["sample_mask"].sum())
        b = to_device({"rgb": batch["rgb"], "event": batch["event"]}, infer.device)
        rows = _rows_to_host(*infer(b["rgb"], b["event"]))
        for i in range(n_valid):
            r = rows[i][rows[i, :, 4] > config.eval.score_threshold][:config.eval.max_detections]
            out.append([np.ascontiguousarray(r[r[:, 5] == c, :5])
                        for c in range(dataset.num_classes())])
    return out, time.perf_counter() - t0


def check_prefetched_eval(kernel_rows, inputs: dict) -> None:
    """``collect_detections`` (prefetched) at the eval CLI's DSEC f32 setup
    against the same loop on the current stream: detections bit for bit, B1
    at f32 4 times a batch and nothing else; then both loops warm in turns
    PREFETCH_TURNS over the dataset and over PREFETCH_LONG_IMAGES, img/s and
    idle share (one profiled batch's device-busy ms over the loop's ms per
    batch) beside phase 8's."""
    import numpy as np

    from frn_tpu_torch.eval.detections import collect_detections

    _, ds, config, infer = eval_model(inputs, "dsec")
    batches = -(-len(ds) // EVAL_BATCH)
    torch.cuda.synchronize()
    _reset_counts()
    got, _ = collect_detections(ds, infer, config, batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    counts = _counts()
    want = {**dict.fromkeys(_COUNTERS, 0), "flash_fwd_f32": 4 * batches}
    if counts != want:
        fail(f"prefetched evaluation launched {counts}, expected {want}")
    kernel_rows["flash_fwd_f32"]["launches"] += counts["flash_fwd_f32"]
    ref, _ = _collect_on_current_stream(ds, infer, config)
    rows = sum(len(d) for per_image in ref for d in per_image)
    if not rows or len(got) != len(ref) or not all(
            np.array_equal(g, r) for gi, ri in zip(got, ref) for g, r in zip(gi, ri)):
        fail("prefetched collect_detections differs from the current stream's loop")
    print(f"prefetched evaluation (DSEC f32, {len(ds)} images, batch {EVAL_BATCH}): {rows} "
          f"detections equal bit for bit to the current stream's loop; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}", flush=True)

    rgb, event = first_batch(ds, config)
    busy = None
    for images in (len(ds), PREFETCH_LONG_IMAGES):
        loop_ds = _Cycled(ds, images)
        warm = {}
        for turn in PREFETCH_TURNS:
            if turn == "prefetch":
                _, seconds = collect_detections(loop_ds, infer, config, batch_size=EVAL_BATCH)
            else:
                _, seconds = _collect_on_current_stream(loop_ds, infer, config)
            warm.setdefault(turn, []).append(seconds)
        loop_ms = {turn: 1e3 * statistics.mean(v) / -(-images // EVAL_BATCH)
                   for turn, v in warm.items()}
        if busy is None:  # one profiled batch: the device-busy ms of every loop
            idle = profile_pass(
                f"prefetched evaluation profile: one batch of {EVAL_BATCH}, idle share of the "
                f"prefetched warm loop's ms per batch", lambda: infer(rgb, event),
                loop_ms["prefetch"], n_ops=3, n_kernels=3)
            busy = (1 - idle) * loop_ms["prefetch"]
        for turn in ("prefetch", "current stream"):
            print(f"warm DSEC f32 eval loop of {images} images on {card_name_and_power_limit()}, "
                  f"{turn}: {images / statistics.mean(warm[turn]):.2f} img/s (turns "
                  f"{', '.join(f'{images / v:.2f}' for v in warm[turn])}), {loop_ms[turn]:.2f} ms "
                  f"per batch, idle share {1 - busy / loop_ms[turn]:.3f} (device busy {busy:.3f} ms "
                  f"per batch)", flush=True)
    if "DSEC f32" in EVAL_WARM_LOOPS:
        img_s, phase8_idle = EVAL_WARM_LOOPS["DSEC f32"]
        print(f"  phase 8 (cli.test's loop of {len(ds)} images, prefetched): {img_s:.2f} img/s, "
              f"idle share {phase8_idle:.3f}", flush=True)
    del infer, rgb, event
    torch.cuda.empty_cache()


def phase_instruments(kernel_rows, inputs: dict, root: Path) -> None:
    """Phase 12: the trainer's instruments and the host data layer at full
    width (DSEC 480x640, fusion ResNet-50, f32) on phase 8's fixture and
    seeded ``.pth``: the native host library; ``cli.convert_checkpoint``
    into the port's directory (bit for bit the ``.pth``'s weights); from
    it ``Trainer(metrics_path=..., log_every=2).fit(1)`` at the train CLI's
    batch 2 over INSTRUMENT_IMAGES images (launches counted; finite losses;
    frn_tpu's JSONL keys and types; every prefetched batch equal to the
    loader's host batch after its step, on the consumer's stream; the first
    micro-step's loss equal to the same state's on a ``to_device`` batch);
    ``profiling.trace`` around TRACED_STEPS micro-steps (the trace names the
    three f32 training kernels; ``StepTimer`` beside CUDA events); the
    prefetched evaluation against the current stream's; and
    ``default_augmentations`` on a DSEC-sized raw event sample."""
    import collections

    import numpy as np

    from frn_tpu_torch.cli import common, convert_checkpoint, train
    from frn_tpu_torch.data.augment import default_augmentations
    from frn_tpu_torch.data.loader import to_device
    from frn_tpu_torch.train.checkpoint import CheckpointManager
    from frn_tpu_torch.train.trainer import Trainer
    from frn_tpu_torch.utils import profiling

    started = time.perf_counter()
    print(f"the trainer's instruments and the host data layer on {card_name_and_power_limit()}",
          flush=True)
    x, y, t, p = check_native_library()

    # convert phase 8's seeded .pth into the port's checkpoint directory
    converted = str(root / "converted")
    t0 = time.perf_counter()
    convert_checkpoint.main(["--torch_checkpoint", inputs["dsec_pth"], "--output", converted,
                             "--dataset_name", "dsec", "--fusion", "fpn_fusion", "--depth", "50"])
    pth = torch.load(inputs["dsec_pth"], map_location="cpu", weights_only=True)["model_state_dict"]
    saved = torch.load(CheckpointManager(converted).path(0), map_location="cpu", weights_only=True)
    if saved["source"] != inputs["dsec_pth"] or saved["epoch"] != 0:
        fail(f"convert_checkpoint wrote source {saved['source']}, epoch {saved['epoch']}")
    args = train.get_parser().parse_args(_train_cli_flags(inputs, "dsec", root, F32_TRAIN_BATCH))
    args.checkpoint = converted  # cli.train --continue_training --checkpoint <dir>
    device = common.setup_device(args)
    ds = _FirstImages(common.build_csv_dataset(args, args.csv_train), INSTRUMENT_IMAGES)
    cfg = common.build_config(args, ds.num_classes(), args.batch_size, args.epochs)
    metrics_path = str(root / "instruments" / "metrics.jsonl")
    trainer = Trainer(cfg, ds, device=device, metrics_path=metrics_path,
                      log_every=INSTRUMENT_LOG_EVERY)
    common.load_checkpoint_into_state(args, trainer.state)
    weights = trainer.state.model.state_dict()
    if sorted(weights) != sorted(pth) or not all(torch.equal(weights[k].cpu(), pth[k]) for k in pth):
        fail("the weights loaded from convert_checkpoint's directory differ from the .pth's")
    print(f"convert_checkpoint: {len(pth)} tensors of {inputs['dsec_pth']} into {converted}, "
          f"loaded into the trainer bit for bit ({time.perf_counter() - t0:.1f} s)", flush=True)

    # fit, with each prefetched batch held against the loader's host batch
    # after its step (on the consumer's stream) and each micro-step's loss kept
    host_batches, seen, losses = collections.deque(), [], []
    loader_fn, step_fn = trainer._loader, trainer.step_fn

    def tee_loader():
        for b in loader_fn():
            host_batches.append({k: v.copy() for k, v in b.items()})
            yield b

    def checked_step(state, batch, generator):
        out = step_fn(state, batch, generator)
        host = host_batches.popleft()
        seen.append(host)
        for key, want in host.items():
            got = batch[key]
            if not (got.device.type == device.type and torch.equal(got.cpu(), torch.from_numpy(want))):
                fail(f"prefetched batch {len(losses)} '{key}' differs from the loader's host batch")
        losses.append(out["loss"])
        return out

    generator_state = trainer.generator.get_state()
    trainer._loader, trainer.step_fn = tee_loader, checked_step
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    history = trainer.fit(1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = _counts()
    trainer._loader, trainer.step_fn = loader_fn, step_fn
    steps = INSTRUMENT_IMAGES // F32_TRAIN_BATCH
    want = {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_F32_KERNELS, 4 * steps)}
    if counts != want:
        fail(f"Trainer.fit (prefetched) launched {counts}, expected {want}")
    for key in TRAIN_F32_KERNELS:
        kernel_rows[key]["launches"] += counts[key]
    losses = [v.item() for v in losses]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses + history):
        fail(f"Trainer.fit: micro-step losses {losses}, history {history}")
    with open(metrics_path) as f:
        records = [json.loads(line) for line in f]
    types = [[type(r[k]).__name__ for k in METRICS_KEYS] for r in records]
    if ([tuple(r) for r in records] != [METRICS_KEYS] * (steps // INSTRUMENT_LOG_EVERY)
            or [r["step"] for r in records] != list(range(2, steps + 1, 2))
            or any(ty != ["int"] + ["float"] * 6 for ty in types)
            or any(r["epoch"] != 0.0 or r["loss"] != losses[r["step"] - 1] for r in records)):
        fail(f"metrics JSONL records {records}")
    print(f"Trainer(metrics_path=..., log_every={INSTRUMENT_LOG_EVERY}).fit(1), prefetched: {steps} "
          f"micro-steps of batch {F32_TRAIN_BATCH} in {fit_s:.1f} s, losses "
          f"{', '.join(f'{v:.3f}' for v in losses)}; every prefetched batch equal to its host batch; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})}; JSONL: {records}",
          flush=True)

    # the first micro-step again, from the same state on a to_device batch
    common.load_checkpoint_into_state(args, trainer.state)
    trainer.generator.set_state(generator_state)
    batch = to_device(seen[0], device)
    again = trainer.step_fn(trainer.state, batch, trainer.generator)["loss"].item()
    print(f"first micro-step's loss, prefetched {losses[0]!r}, to_device {again!r}", flush=True)
    if again != losses[0]:
        fail("the prefetched first micro-step's loss differs from the to_device one's")

    # a trace of TRACED_STEPS micro-steps, timed by StepTimer and CUDA events
    trace_dir = root / "instruments" / "trace"
    timer, events = profiling.StepTimer(), []
    torch.cuda.synchronize()
    with profiling.trace(str(trace_dir)):
        for _ in range(TRACED_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            timer.start()
            start.record()
            out = trainer.step_fn(trainer.state, batch, trainer.generator)
            end.record()
            timer.stop(out)
            events.append((start, end))
        torch.cuda.synchronize()
    files = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        fail(f"profiling.trace wrote {files}")
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    missing = [k for k in TRACE_KERNELS if not any(k in n for n in names)]
    if missing:
        fail(f"the trace names no {missing}: {sorted(names)[:20]}")
    event_ms = [s.elapsed_time(e) for s, e in events]
    print(f"profiling.trace over {TRACED_STEPS} micro-steps: {files[0].name}, "
          f"{files[0].stat().st_size / 2**20:.1f} MiB, {len(names)} kernel names, "
          f"{', '.join(TRACE_KERNELS)} among them; StepTimer.stats() {json.dumps(timer.stats())}; "
          f"CUDA events {', '.join(f'{ms:.2f}' for ms in event_ms)} ms (under the profiler)",
          flush=True)
    del trainer, batch, out, weights, pth, saved
    torch.cuda.empty_cache()

    check_prefetched_eval(kernel_rows, inputs)

    # the augmentations on a DSEC-sized raw event sample (they import no OpenCV)
    rgb = ds[0]["rgb"]  # the dataset's f32 image, as the loader hands a transform
    sample = {"x": x.astype(np.int64), "y": y.astype(np.int64), "t": t, "p": p, "rgb": rgb,
              "annot": np.asarray([[100, 120, 300, 260, 0], [400, 50, 600, 200, 1]], np.float32)}
    augment = default_augmentations(480, 640, seed=33)
    for i in range(AUGMENT_SAMPLES):
        t0 = time.perf_counter()
        out = augment(dict(sample))
        ms = (time.perf_counter() - t0) * 1e3
        inside = ((out["x"] >= 0) & (out["x"] < 640) & (out["y"] >= 0) & (out["y"] < 480)).all()
        if not (inside and out["rgb"].shape == rgb.shape and np.isfinite(out["rgb"]).all()):
            fail(f"augmented sample {i}: events outside the frame or the image not finite")
        print(f"default_augmentations sample {i}: {len(out['x']):,} of {len(x):,} events kept, "
              f"{len(out['annot'])} boxes, {ms:.1f} ms on the host", flush=True)
    try:  # the augmentations import no OpenCV (tests/test_torch_imports.py); is it here?
        import cv2
        opencv = f"OpenCV {cv2.__version__} is installed, unused by the augmentations"
    except ImportError:
        opencv = "no OpenCV on this machine"
    print(f"default_augmentations: {opencv}", flush=True)
    print(f"phase 12 (the trainer's instruments and the host data layer) on "
          f"{card_name_and_power_limit()}: {time.perf_counter() - started:.1f} s", flush=True)


# ------------------------------------------------------------ data parallelism (phase 13)

# phase 13 runs on the one card: replicas of the model on cuda:0 for
# evaluation and serving, and ranks sharing it for training. One card cannot
# show scaling; it shows that the split, the replicas, the launcher and the
# reduction are right
PARALLEL_REPLICAS = 2
# the data-parallel serving engine (bf16, the compact wire): lone requests at
# max_delay_ms 0, then closed-loop clients for a ramp-up and a window
PARALLEL_BUCKETS = (2, 4, 8, 16)
PARALLEL_SINGLE, PARALLEL_CLIENTS, PARALLEL_RAMP_S, PARALLEL_BURST_S = 20, 8, 1.0, 2.0
# the eval loops in turns, replicas against one model: "mesh" or "single"
PARALLEL_EVAL_TURNS = ("single", "mesh", "mesh", "single")
# the launcher's train runs: the train CLI at f32 batch 2 over the first
# PARALLEL_TRAIN_IMAGES images of phase 8's DSEC fixture, 2 micro-steps (the
# second ends the accumulation cycle: no Adam step between them, so both
# micro-steps' losses are forward passes at the checkpoint's weights)
PARALLEL_TRAIN_IMAGES = 4
# the launched run's parameters after its Adam step against a plain run's,
# max|diff| over all tensors, at most this many times the spread of two plain
# runs (cuDNN's f32 weight gradients are not bit-reproducible, and the first
# Adam step moves an element by about lr whatever its gradient's size, so a
# tiny gradient whose sign is rounding noise moves it by up to 2 lr)
PARALLEL_SPREAD_FACTOR = 4.0
# the two gloo ranks' all-reduced loss against one process's batch-2 loss:
# f32 sums in another order, and the batch-1 convolutions may take other
# cuDNN algorithms than batch 2's
PARALLEL_LOSS_RTOL = 1e-4
# each child process of the phase (it builds and loads the full-width model),
# and each collective of the gloo ranks, fails after this long
PARALLEL_CHILD_TIMEOUT_S = 300
# the probe a child process runs (``train_probe``), from the repo root
_TRAIN_PROBE = "import chip_smoke; chip_smoke.train_probe()"


def train_probe() -> None:
    """The body of the phase's train-CLI child processes: ``cli.train.main``
    on ``sys.argv[2:]``, recording each micro-step's loss, the process
    group's backend and world size, and the launch counts of the run; writes
    them to ``sys.argv[1] + '.json'`` and the parameters after the run to
    ``sys.argv[1] + '.pt'``. Started by ``torch.distributed.run`` (torchrun)
    or plainly."""
    from frn_tpu_torch.cli import train
    from frn_tpu_torch.train import trainer

    out, argv = sys.argv[1], sys.argv[2:]
    record = {"losses": []}
    build_step = trainer.make_train_step

    def recording_step(*args, **kwargs):
        step = build_step(*args, **kwargs)

        def run(state, batch, generator):
            metrics = step(state, batch, generator)
            dist = torch.distributed
            record.update(losses=record["losses"] + [metrics["loss"].item()], state=state,
                          backend=dist.get_backend() if dist.is_initialized() else None,
                          world=dist.get_world_size() if dist.is_initialized() else 1)
            return metrics

        return run

    trainer.make_train_step = recording_step
    _reset_counts()
    train.main(argv)
    if torch.cuda.is_available():  # the run's kernels have ended (on the CPU: a rehearsal)
        torch.cuda.synchronize()
    state = record.pop("state")
    record["launches"] = _counts()
    torch.save({n: p.detach().cpu() for n, p in zip(state.names, state.params)}, out + ".pt")
    with open(out + ".json", "w") as f:
        json.dump(record, f)


def _start_train_probe(label: str, argv: list, out: Path, launcher: bool):
    """Starts ``train_probe`` in a child process, under torchrun with one
    process (NCCL at world size 1) or plainly; (label, process, log path)."""
    log = out.with_suffix(".log")
    cmd = [sys.executable, "-c", _TRAIN_PROBE, str(out), *argv]
    if launcher:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "--no-python", *cmd]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=str(Path(__file__).resolve().parent))
    return label, proc, log


def _finish_train_probe(label: str, proc, log: Path, out: Path):
    """Waits for a ``train_probe`` child (killed past PARALLEL_CHILD_TIMEOUT_S);
    (its record, its parameters). Fails if it failed."""
    try:
        rc = proc.wait(timeout=PARALLEL_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at the time limit"
    if rc != 0:
        fail(f"data-parallel training ({label}) exited {rc}:\n{log.read_text()[-4000:]}")
    with open(str(out) + ".json") as f:
        record = json.load(f)
    return record, torch.load(str(out) + ".pt", weights_only=True)


def _parallel_train_setup(pth: str, fixture: dict, device):
    """The train CLI's f32 batch-2 configuration over ``fixture``: (config,
    its model on ``device`` with ``pth``'s weights, the first global batch
    as host arrays), built by the CLI's helpers."""
    from frn_tpu_torch.cli import common, train
    from frn_tpu_torch.data.collate import collate_fixed
    from frn_tpu_torch.models.detector import init_detector

    args = train.get_parser().parse_args(_train_cli_flags(
        {"dsec": fixture, "dsec_pth": pth}, "dsec", Path("unused"), F32_TRAIN_BATCH))
    common.setup_device(args)
    ds = common.build_csv_dataset(args, args.csv_train)
    cfg = common.build_config(args, ds.num_classes(), args.batch_size, args.epochs)
    model = init_detector(cfg, seed=0, device=device)
    common.load_checkpoint_into_model(args, model)
    b = F32_TRAIN_BATCH
    batch = collate_fixed([ds[i] for i in range(b)], cfg.geometry, cfg.train.max_annots_per_image, b)
    return cfg, model, {k: batch[k] for k in ("rgb", "event", "annot")}


def _first_step_acc(cfg, model, batch, seed: int = 1):
    """One micro-step of the train step from ``model``'s weights (the
    process group's, if one is initialized): (its metrics, the running
    gradient sum it leaves, the state)."""
    from frn_tpu_torch.train.loop import create_train_state, make_train_step

    state = create_train_state(cfg, model=model)
    metrics = make_train_step(cfg)(state, batch, torch.Generator().manual_seed(seed))
    return metrics, state.acc_grads, state


def _row_mean_acc(state, cfg, batch, seed: int = 1) -> list:
    """What the all-reduce should leave after one micro-step: each row's
    gradients alone (batch 1, as each rank computes them; the modality
    dropout drawn from the step's seeded generator), their mean, clipped as
    the step clips its running sum."""
    from frn_tpu_torch.data.loader import to_device
    from frn_tpu_torch.models.detector import detection_loss, draw_modality_drop
    from frn_tpu_torch.train.loop import torch_clip_by_global_norm

    drop = draw_modality_drop(torch.Generator().manual_seed(seed), cfg.model.modality_dropout)
    rows = []
    for i in range(F32_TRAIN_BATCH):
        b = to_device({k: v[i: i + 1] for k, v in batch.items()}, state.params[0].device)
        cls, reg = state.model(b["rgb"], b["event"], train=True, drop=drop)
        rows.append(torch.autograd.grad(sum(detection_loss(cls, reg, b["annot"], cfg)),
                                        state.params))
    two = torch.tensor(float(F32_TRAIN_BATCH), device=state.params[0].device)
    mean = [sum(gs) / two for gs in zip(*rows)]
    torch_clip_by_global_norm(mean, cfg.train.grad_clip_norm)
    return mean


def parallel_gloo_rank(rank: int, pth: str, fixture: dict, out_dir: str) -> dict:
    """One of two gloo ranks on cuda:0 (``run_ranks``): the train CLI's f32
    step on its row of the global batch of 2, the gradients all-reduced;
    rank 0 writes the running gradient sum to ``out_dir``. Returns its loss,
    its launches, and the ms and bytes of one more ``all_reduce_mean_`` of
    tensors the size of the gradients (median of 3, host clock ending in a
    synchronize)."""
    from frn_tpu_torch.parallel.mesh import all_reduce_mean_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, model, batch = _parallel_train_setup(pth, fixture, torch.device("cuda", 0))
    mine = {k: v[rank: rank + 1] for k, v in batch.items()}
    torch.cuda.synchronize()
    _reset_counts()
    metrics, acc, _ = _first_step_acc(cfg, model, mine)
    torch.cuda.synchronize()
    counts = _counts()
    if rank == 0:
        torch.save([a.cpu() for a in acc], str(Path(out_dir) / "gloo_acc.pt"))
    grads = [torch.zeros_like(a) for a in acc]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_mean_(grads)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"loss": metrics["loss"].item(), "skipped": metrics["skipped"].item(),
            "backend": torch.distributed.get_backend(), "launches": counts,
            "all_reduce_ms": statistics.median(times),
            "all_reduce_bytes": sum(g.numel() * g.element_size() for g in grads)}


def _subset_fixture(fixture: dict, images: int, path: Path) -> dict:
    """``fixture`` with its annotations CSV cut to its first ``images`` images."""
    keys, rows = [], []
    for line in Path(fixture["annotations_csv"]).read_text().splitlines():
        key = line.split(",")[0]
        if key not in keys:
            keys.append(key)
        if len(keys) <= images:
            rows.append(line)
    path.write_text("\n".join(rows) + "\n")
    return {**fixture, "annotations_csv": str(path)}


def check_parallel_training(kernel_rows, inputs: dict, root: Path) -> dict:
    """Training through the launcher and across ranks (see phase_parallel)."""
    from frn_tpu_torch.parallel.launch import run_ranks

    fixture = _subset_fixture(inputs["dsec"], PARALLEL_TRAIN_IMAGES, root / "dp_train.csv")
    steps = PARALLEL_TRAIN_IMAGES // F32_TRAIN_BATCH
    runs = {}
    for label, launcher in (("torchrun", True), ("plain A", False), ("plain B", False)):
        out = root / f"dp_{label.replace(' ', '_')}"
        argv = _train_cli_flags({"dsec": fixture, "dsec_pth": inputs["dsec_pth"]}, "dsec", out,
                                F32_TRAIN_BATCH)
        runs[label] = (out, _start_train_probe(label, argv, out, launcher))

    # meanwhile: two gloo ranks sharing cuda:0 against one process
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_gloo_rank, 2, args=(inputs["dsec_pth"], fixture, str(root)),
                      device="cuda:0", backend="gloo", timeout_s=PARALLEL_CHILD_TIMEOUT_S)
    gloo_s = time.perf_counter() - t0
    cfg, model, batch = _parallel_train_setup(inputs["dsec_pth"], fixture, torch.device("cuda"))
    # no Adam step at the first micro-step (accum_steps 2): the weights stay
    metrics, single, state = _first_step_acc(cfg, model, batch)
    row_mean = _row_mean_acc(state, cfg, batch)
    gen = torch.Generator().manual_seed(13)
    rgb = torch.from_numpy(batch["rgb"])
    half = torch.rand(rgb.shape, generator=gen) < 0.5
    nudged = {**batch, "rgb": torch.where(half, torch.nextafter(rgb, torch.full_like(rgb, math.inf)),
                                          rgb).numpy()}
    _, witness, _ = _first_step_acc(cfg, model, nudged)
    dp = [a.to(single[0].device) for a in torch.load(str(root / "gloo_acc.pt"), weights_only=True)]
    loss = metrics["loss"].item()
    gaps = {("gloo ranks", "the rows' mean"): _worst_grad_gap(state.names, dp, row_mean),
            ("gloo ranks", "batch 2"): _worst_grad_gap(state.names, dp, single),
            ("one ulp of the RGB input", "batch 2"): _worst_grad_gap(state.names, witness, single)}
    for (label, ref), ((gap, name), bias_gap, norm_gap) in gaps.items():
        print(f"data-parallel gradients (f32, global batch {F32_TRAIN_BATCH}), {label} vs one "
              f"process's {ref}: worst tensor max|diff|/max|ref| {gap:.3e} ({name}); theta "
              f"biases {bias_gap:.3e}; over all params {norm_gap:.3e}", flush=True)
    rank_losses = [r["loss"] for r in ranks]
    print(f"data-parallel training, 2 gloo ranks on cuda:0 ({gloo_s:.1f} s, spawn to join): "
          f"losses {rank_losses} (all-reduced) against one process's {loss}; launches per rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}; all_reduce_mean_ of "
          f"the gradients' {ranks[0]['all_reduce_bytes']} bytes in one gloo collective: "
          f"{[round(r['all_reduce_ms'], 2) for r in ranks]} ms (rank 0, rank 1)", flush=True)
    want = {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_F32_KERNELS, 4)}
    if not (all(r["backend"] == "gloo" and r["skipped"] == 0.0 and r["launches"] == want
                for r in ranks) and rank_losses[0] == rank_losses[1]
            and abs(rank_losses[0] - loss) <= PARALLEL_LOSS_RTOL * abs(loss)):
        fail(f"data-parallel training (gloo): ranks {ranks}, one process's loss {loss}")
    # the split and the reduction: against the mean of the rows' gradients,
    # each computed as its rank computes it, under the phase-9 gate; against
    # batch 2 (whose convolutions sum over both images in another order)
    # within the phase-9 gate or twice the one-ulp witness, the larger
    (wit_gap, _), _, wit_norm = gaps[("one ulp of the RGB input", "batch 2")]
    for ref, rel_tol, norm_tol in (
            ("the rows' mean", F32_GRAD_REL_TOL, F32_GRAD_NORM_TOL),
            ("batch 2", max(F32_GRAD_REL_TOL, 2 * wit_gap), max(F32_GRAD_NORM_TOL, 2 * wit_norm))):
        (gap, name), bias_gap, norm_gap = gaps[("gloo ranks", ref)]
        if not (gap <= rel_tol and bias_gap <= F32_GRAD_REL_TOL and norm_gap <= norm_tol):
            fail(f"data-parallel gradients disagree with one process's {ref} ({gap:.3e} at "
                 f"{name}, theta biases {bias_gap:.3e}, over all params {norm_gap:.3e}; gates "
                 f"{rel_tol:.1e}, {norm_tol:.1e})")
    for r in ranks:
        for key in TRAIN_F32_KERNELS:
            kernel_rows[key]["launches"] += r["launches"][key]
    del model, state, single, witness, dp, row_mean
    torch.cuda.empty_cache()

    done = {label: _finish_train_probe(label, *probe[1:], out) for label, (out, probe) in
            runs.items()}
    (rec, params), (rec_a, params_a), (_, params_b) = (done[k] for k in
                                                        ("torchrun", "plain A", "plain B"))

    def max_gap(a, b):
        return max((a[n] - b[n]).abs().max().item() for n in a)

    gap, spread = max_gap(params, params_a), max_gap(params_b, params_a)
    want = {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_F32_KERNELS, 4 * steps)}
    print(f"data-parallel training, the train CLI under torchrun --nproc_per_node 1: backend "
          f"{rec['backend']}, world {rec['world']}; micro-step losses {rec['losses']} against the "
          f"plain runs' {done['plain A'][0]['losses']}, {done['plain B'][0]['losses']}; "
          f"parameters after {steps} micro-steps max|diff| {gap:.3e} from plain A, the plain "
          f"runs' spread {spread:.3e}; launches {json.dumps({k: v for k, v in rec['launches'].items() if v})}",
          flush=True)
    if not (rec["backend"] == "nccl" and rec["world"] == 1 and rec_a["backend"] is None
            and len(rec["losses"]) == steps and rec["losses"][0] == rec_a["losses"][0]
            and rec["launches"] == want and gap <= PARALLEL_SPREAD_FACTOR * spread):
        fail(f"data-parallel training (torchrun): {rec} against plain {rec_a}; parameters "
             f"{gap:.3e} off, spread {spread:.3e}")
    for key in TRAIN_F32_KERNELS:
        kernel_rows[key]["launches"] += rec["launches"][key]
    return {"gloo_s": gloo_s, "gloo_all_reduce_ms": ranks[0]["all_reduce_ms"],
            "gloo_all_reduce_bytes": ranks[0]["all_reduce_bytes"],
            "gloo_grad_gap_rows": gaps[("gloo ranks", "the rows' mean")][2],
            "gloo_grad_gap_batch2": gaps[("gloo ranks", "batch 2")][2],
            "witness_grad_gap": wit_norm, "torchrun_param_gap": gap,
            "plain_param_spread": spread}


def _forward_enqueue_ms(fns, blocks) -> float:
    """Median host ms to enqueue every inference function's wire decode and
    forward on its block (nothing waits on the device), over 3 runs."""
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fn, (rgb, event) in zip(fns, blocks):
            with torch.cuda.device(fn.device):
                fn.forward(*fn.inputs(rgb, event))
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def check_parallel_evaluation(kernel_rows, inputs: dict, mesh) -> dict:
    """Evaluation over replicas (see phase_parallel)."""
    import numpy as np

    from frn_tpu_torch.eval.detections import collect_detections, make_inference_fn

    _, ds, config, single = eval_model(inputs, "dsec", "--compute_dtype", "bfloat16")
    infer = make_inference_fn(single.model, config, mesh=mesh)
    rgb, event = first_batch(ds, config)
    got = [x.cpu().numpy() for x in infer(rgb, event)]
    b = EVAL_BATCH // mesh.size
    for i in range(mesh.size):
        alone = [x.cpu().numpy() for x in single(rgb[i * b:(i + 1) * b], event[i * b:(i + 1) * b])]
        if not all(np.array_equal(g[i * b:(i + 1) * b], a) for g, a in zip(got, alone)):
            fail(f"data-parallel evaluation: replica {i}'s rows differ from the single device's "
                 f"forward + decode + NMS of the same {b}-row block")
    # against the whole batch on one model, beside one bf16 ulp of the input
    whole = single.forward(rgb, event)
    blocks = [infer.replicas[i].forward(rgb[i * b:(i + 1) * b], event[i * b:(i + 1) * b])
              for i in range(mesh.size)]
    x = rgb.to(torch.bfloat16)
    half = torch.rand(x.shape, generator=torch.Generator(device=x.device).manual_seed(3),
                      device=x.device) < 0.5
    witness = single.forward(torch.where(half, torch.nextafter(x, torch.full_like(x, math.inf)),
                                         x).float(), event)
    rel = max(((torch.cat([o[k] for o in blocks]) - w).abs().max() / w.abs().max()).item()
              for k, w in enumerate(whole))
    wit = max(((v - w).abs().max() / w.abs().max()).item() for v, w in zip(witness, whole))
    s8, l8, _ = (v.cpu().numpy() for v in single(rgb, event))
    thr = config.eval.score_threshold
    same = [int((s8[i] > thr).sum()) == int((got[0][i] > thr).sum())
            and np.array_equal(l8[i][s8[i] > thr], got[1][i][got[0][i] > thr])
            for i in range(EVAL_BATCH)]
    gate = max(MAIN_REL_TOL, 2 * wit)
    print(f"data-parallel evaluation (DSEC bf16, batch {EVAL_BATCH} over {mesh.size} replicas on "
          f"{mesh.devices[0]}): each replica's rows equal the single device's forward + decode + "
          f"NMS of its {b}-row block bit for bit; logits and deltas against the whole batch on one "
          f"model max|diff|/max|ref| {rel:.3e} (at most {gate:.1e}; one-ulp witness {wit:.3e}); "
          f"detections of {sum(same)} of {EVAL_BATCH} images equal in count and labels", flush=True)
    if not rel <= gate:
        fail(f"data-parallel evaluation: the replicas' outputs are {rel:.3e} off the whole batch's")

    turns, launches = [], 0
    batches = -(-len(ds) // EVAL_BATCH)
    for turn in PARALLEL_EVAL_TURNS:
        fn = infer if turn == "mesh" else single
        torch.cuda.synchronize()
        _reset_counts()
        _, seconds = collect_detections(ds, fn, config, batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
        counts = _counts()
        per_batch = 4 * (mesh.size if turn == "mesh" else 1)
        if counts != {**dict.fromkeys(_COUNTERS, 0), "flash_fwd": per_batch * batches}:
            fail(f"data-parallel evaluation ({turn}) launched {counts}")
        launches += counts["flash_fwd"]
        turns.append((turn, len(ds) / seconds))
    kernel_rows["flash_fwd"]["launches"] += launches
    enqueue = {"single": _forward_enqueue_ms([single], [(rgb, event)]),
               "mesh": _forward_enqueue_ms(infer.replicas, [
                   (rgb[i * b:(i + 1) * b], event[i * b:(i + 1) * b]) for i in range(mesh.size)])}
    rates = {k: statistics.median(r for t, r in turns if t == k) for k in ("single", "mesh")}
    phase8 = EVAL_WARM_LOOPS.get("DSEC bf16")
    print(f"data-parallel evaluation loop over {len(ds)} images, turns "
          f"{', '.join(f'{t} {r:.2f}' for t, r in turns)} img/s; the host's enqueue of a batch's "
          f"wire decode and forward {enqueue['mesh']:.2f} ms over {mesh.size} replicas against "
          f"{enqueue['single']:.2f} ms on one model; phase 8's warm loop "
          f"{f'{phase8[0]:.2f} img/s, idle {phase8[1]:.3f}' if phase8 else 'not run'}", flush=True)
    return {"eval_img_s_mesh": rates["mesh"], "eval_img_s_single": rates["single"],
            "enqueue_ms_mesh": enqueue["mesh"], "enqueue_ms_single": enqueue["single"]}


def check_replica_blocks(engine, records) -> int:
    """Each request of each recorded batch against its replica's direct
    forward of its row block of the padded batch (``wire_batch``, the
    replica's own ``model_inputs`` and inference function): scores, labels
    and boxes equal bit for bit. Returns the requests checked."""
    import numpy as np

    from frn_tpu_torch.parallel.mesh import row_blocks

    thr = engine.options.score_threshold
    cap = engine.options.max_detections or engine.config.eval.max_detections
    checked = 0
    for rec in records:
        wire = engine.wire_batch(rec.requests, rec.bucket)
        for fn, rows in zip(engine.replica_fns, row_blocks(rec.bucket, engine.mesh.size)):
            with torch.cuda.device(fn.device):
                out = fn(*engine.model_inputs(*[t[rows].to(fn.device) for t in wire]))
            scores, labels, boxes = (x.cpu().numpy() for x in out)
            for j, req in enumerate(rec.requests[rows]):
                det = req.future.result(timeout=0)
                keep = scores[j] > thr
                want = (scores[j][keep][:cap], labels[j][keep][:cap], boxes[j][keep][:cap])
                if not all(np.array_equal(g, w) for g, w in
                           zip((det.scores, det.labels, det.boxes), want)):
                    fail(f"data-parallel serving: a request in a bucket of {rec.bucket} differs "
                         f"from its replica's forward of its block")
                checked += 1
    return checked


def _serve_turn(label: str, engine, pool: list, replicas: int) -> dict:
    """PARALLEL_SINGLE lone requests at max_delay_ms 0, then PARALLEL_CLIENTS
    closed-loop clients over a PARALLEL_BURST_S window, launch counts zeroed
    just before and read just after (B1 4 times a batch a replica); the
    numbers printed and returned, the records kept."""
    import dataclasses as dc

    import numpy as np

    send, requests = _serve_sender(engine, pool)
    engine.record_batches()
    torch.cuda.synchronize()
    _reset_counts()
    delay = engine.options.max_delay_ms
    engine.options = dc.replace(engine.options, max_delay_ms=0.0)
    single, _ = _drive_clients(send, requests, 1, PARALLEL_SINGLE)
    engine.options = dc.replace(engine.options, max_delay_ms=delay)
    n_single = len(engine.batch_records())
    burst, (t_lo, t_hi), _ = _drive_window(send, requests, PARALLEL_CLIENTS,
                                           ramp_s=PARALLEL_RAMP_S, burst_s=PARALLEL_BURST_S)
    torch.cuda.synchronize()
    counts = _counts()
    records = engine.batch_records()
    if counts != {**dict.fromkeys(_COUNTERS, 0), "flash_fwd": 4 * replicas * len(records)}:
        fail(f"data-parallel serving ({label}) launched {counts} over {len(records)} batches")
    window = [r for r in records[n_single:] if t_lo <= r.t_dispatch <= t_hi]
    out = {"rps": len(burst) / PARALLEL_BURST_S,
           "p50": float(np.percentile(burst, 50)), "p99": float(np.percentile(burst, 99)),
           "single_p50": float(np.percentile(single, 50)),
           "host_ms": float(np.median([r.host_ms for r in window])),
           "fill": sum(len(r.requests) for r in window) / sum(r.bucket for r in window),
           "launches": counts["flash_fwd"]}
    print(f"data-parallel serving ({label}): one client {_percentiles(single)}; "
          f"{PARALLEL_CLIENTS} clients, the {PARALLEL_BURST_S:g} s after a {PARALLEL_RAMP_S:g} s "
          f"ramp-up: {_percentiles(burst)}, {out['rps']:.2f} requests/s, {len(window)} batches, "
          f"fill {out['fill']:.3f}; the dispatcher's host ms per batch, median {out['host_ms']:.2f}",
          flush=True)
    return out, records


def check_parallel_serving(kernel_rows, inputs: dict, mesh) -> dict:
    """Serving over replicas (see phase_parallel)."""
    from frn_tpu_torch.config import DSEC
    from frn_tpu_torch.serve import ServingEngine

    model, cfg = _serve_model(inputs, compute_dtype="bfloat16")
    pool = _serve_pool(DSEC, "compact", seed=44)
    results = {}
    for label, m in (("replicas", mesh), ("one model", None)):
        with ServingEngine(model, cfg, _wire_options("compact", buckets=PARALLEL_BUCKETS),
                           mesh=m) as engine:
            engine.warmup()
            replicas = len(engine.replica_fns)
            results[label], records = _serve_turn(
                f"{label}, bf16, the compact wire, buckets {PARALLEL_BUCKETS}", engine, pool,
                replicas)
            kernel_rows["flash_fwd"]["launches"] += results[label]["launches"]
            if m is not None:
                checked = check_replica_blocks(engine, records)
                print(f"data-parallel serving: {checked} requests in {len(records)} batches equal "
                      f"their replica's forward of their row block bit for bit", flush=True)
            else:
                check_served_exact("one model", engine, records)
    del model, engine
    torch.cuda.empty_cache()
    r, s = results["replicas"], results["one model"]
    print(f"data-parallel serving, {mesh.size} replicas against one model: {r['rps']:.2f} against "
          f"{s['rps']:.2f} requests/s, p50 {r['p50']:.2f} against {s['p50']:.2f} ms, p99 "
          f"{r['p99']:.2f} against {s['p99']:.2f} ms, the dispatcher's host ms per batch "
          f"{r['host_ms']:.2f} against {s['host_ms']:.2f}", flush=True)
    return {f"serve_{k}_{'mesh' if label == 'replicas' else 'single'}": v
            for label, res in results.items() for k, v in res.items() if k != "launches"}


def phase_parallel(kernel_rows, inputs: dict, root: Path) -> None:
    """Data parallelism on the one card, at full width (DSEC 480x640, fusion
    ResNet-50, feature size 256, 3 classes, phase 8's fixtures and seeded
    ``.pth``). Training first, while nothing else loads the card:

      * the train CLI (f32, batch 2, the first PARALLEL_TRAIN_IMAGES images:
        2 micro-steps) under ``torch.distributed.run --nproc_per_node 1``
        (NCCL at world size 1) and twice plainly, at once in three processes
        (``train_probe``): the launched run's backend is nccl, its first
        micro-step's loss bit-equal to a plain run's, its parameters after
        the 2 micro-steps within PARALLEL_SPREAD_FACTOR of the two plain
        runs' spread, B1-lse, B2a and B2b at f32 4 times a micro-step;
      * meanwhile two gloo ranks sharing cuda:0 (``parallel.launch.run_ranks``),
        each the CLI's step on its row of the global batch of 2: each rank's
        launches (B1-lse, B2a and B2b at f32 4 times, nothing else), the
        all-reduced loss within PARALLEL_LOSS_RTOL of one process's batch-2
        loss, the all-reduced gradient sum under the phase-9 gate
        (F32_GRAD_REL_TOL, F32_GRAD_NORM_TOL) against one process's, beside
        the gap that one f32 ulp of half the RGB input makes.

    Then evaluation over PARALLEL_REPLICAS replicas on cuda:0, DSEC bf16 at
    batch 8 through the CLI's helpers and ``make_inference_fn(mesh=...)``:
    each replica's rows bit-equal to the single device's forward + decode +
    NMS of its block; the logits and deltas against the whole batch on one
    model, beside a one-ulp witness (another batch size may take another
    cuDNN algorithm); ``collect_detections`` in turns PARALLEL_EVAL_TURNS (B1
    4 times a batch a replica), img/s and the host's enqueue ms a batch beside
    phase 8's. Last, serving: a bf16 engine on the compact wire, buckets
    PARALLEL_BUCKETS, over the replicas and over one model, each
    PARALLEL_SINGLE lone requests and a PARALLEL_BURST_S window of
    PARALLEL_CLIENTS clients: every request of the replicas' engine
    bit-equal to its replica's forward of its row block, requests/s, p50/p99
    and the dispatcher's host ms a batch of both."""
    from frn_tpu_torch.parallel import make_mesh

    print(f"data parallelism on {card_name_and_power_limit()}", flush=True)
    started = time.perf_counter()
    mesh = make_mesh(devices=["cuda:0"] * PARALLEL_REPLICAS)
    summary = check_parallel_training(kernel_rows, inputs, root)
    print(f"[phase 13 at {time.perf_counter() - started:.1f} s] training checked", flush=True)
    summary.update(check_parallel_evaluation(kernel_rows, inputs, mesh))
    print(f"[phase 13 at {time.perf_counter() - started:.1f} s] evaluation checked", flush=True)
    summary.update(check_parallel_serving(kernel_rows, inputs, mesh))
    print(f"phase 13 (data parallelism) passed in {time.perf_counter() - started:.1f} s; summary "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in summary.items()})}", flush=True)


# ------------------------------------------------------------ A17: the last model and postprocess options

# phase 14: the fused heads at inference, by configuration: label, dataset,
# compute dtype, batch, launches a batch of each kernel (every other: none)
OPTIONS_INFERENCE = (("DSEC bf16", "dsec", "bfloat16", MAIN_BATCH, {"flash_fwd": 4}),
                     ("DDD17 f32", "ddd17", "float32", EVAL_BATCH, {"flash_fwd_f32": 2}))
# timed batches of each inference model
OPTIONS_TIMED = 3
# the postprocess rungs (EvalConfig.postprocess) and the heads' emission
# each takes (classification mode, regression mode)
POSTPROCESS_RUNGS = {"dense": ("probs", "rows"), "pooled": ("probs", "rows"),
                     "pooled_logits": ("logits", "rows"),
                     "pooled_chanlast": ("logits_chanlast", "flat36")}
# the tempered head outputs: logits scaled by a power of two to at most this
# in magnitude (random weights give logits up to 1e4, whose probabilities
# tie at 1.0)
TEMPERED_LOGIT_MAX = 8.0


def _ulp_step(x, gen):
    """``x`` with every nonzero element moved one ulp of its dtype (f32 or
    bf16) up or down in magnitude (seeded), outside autograd: the witness of
    what one rounding step of ``x`` does downstream."""
    ints = torch.int32 if x.dtype == torch.float32 else torch.int16
    step = torch.randint(0, 2, x.shape, generator=gen, device=x.device, dtype=ints) * 2 - 1
    with torch.no_grad():
        moved = (x.detach().contiguous().view(ints) + step).view(x.dtype)  # sign-magnitude bits
        moved = torch.where(x == 0, x.detach(), moved)
    return x + (moved - x).detach() if x.requires_grad else moved


def _gap(got, want):
    """(max |got - want|, mean |got - want|). Both: at random weights the
    logits reach 1e4, so most probabilities saturate and one flip near the
    threshold makes a max gap of 1; the mean tells a few differing elements
    from a shift of all of them."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), diff.mean().item()


def _gap_text(gap) -> str:
    return f"{gap[0]:.3e} (mean {gap[1]:.3e})"


def _under(gap, witness, factor: float) -> bool:
    """Max and mean gap each at most ``factor`` times the witness's."""
    return gap[0] <= factor * witness[0] and gap[1] <= factor * witness[1]


def _options_fn(inputs: dict, dataset: str, dtype: str, **model_kw):
    """The full-width fusion ResNet-50 of ``dataset`` on the card at
    ``dtype``, with phase 8's seeded ``.pth`` and the ``ModelConfig`` fields
    ``model_kw``, as an inference function with the 'pooled' postprocess
    (the 'probs' emission, which the fused heads serve)."""
    from frn_tpu_torch import config as c
    from frn_tpu_torch.convert import load_reference_checkpoint
    from frn_tpu_torch.entry import InferenceFn
    from frn_tpu_torch.models.detector import init_detector

    geo = c.geometry_for(dataset)
    cfg = c.FrameworkConfig(geometry=geo, eval=c.EvalConfig(postprocess="pooled"),
                            model=c.ModelConfig(variant="fusion", depth=50,
                                                num_classes=geo.num_classes,
                                                compute_dtype=dtype, **model_kw))
    model = init_detector(cfg, seed=0, device="cuda")
    load_reference_checkpoint(inputs[f"{dataset}_pth"], model)
    return InferenceFn(model, cfg)


def _fixture_batch(inputs: dict, dataset: str, n: int):
    """The first ``n`` images of phase 8's fixture of ``dataset``, collated
    as ``collect_detections`` collates them, on the card."""
    from frn_tpu_torch import config as c
    from frn_tpu_torch.data.collate import collate_fixed
    from frn_tpu_torch.data.csv_dataset import CSVDetectionDataset
    from frn_tpu_torch.data.loader import to_device

    fix, geo = inputs[dataset], c.geometry_for(dataset)
    ds = CSVDetectionDataset(geo, fix["annotations_csv"], fix["class_map_csv"], fix["event_dir"],
                             fix["img_dir"])
    batch = collate_fixed([ds[i] for i in range(n)], geo, 1, n)
    batch = to_device({"rgb": batch["rgb"], "event": batch["event"]}, "cuda")
    return batch["rgb"], batch["event"]


def _pyramid(model, rgb, event):
    """The FPN's five levels of a batch (the backbones, the fusion stages with
    the flash kernels, the FPN), in the model's compute dtype."""
    with torch.inference_mode():
        dtype = model.compute_dtype
        r = model._backbones["rgb"](rgb.to(dtype).permute(0, 3, 1, 2))
        e = model._backbones["event"](event.to(dtype).permute(0, 3, 1, 2))
        return model.fpn([fus(ei, ri) for fus, ei, ri in zip(model.fus, e, r)])


def _heads_witness(model, pyramid, seed: int):
    """(the gap of the probabilities, of the deltas) that one ulp of the
    pyramid (each element moved up or down, seeded) makes through the unfused
    heads (``_gap``): the scale of a rounding difference at the heads' input."""
    from frn_tpu_torch.models.heads import apply_heads

    gen = torch.Generator(device=pyramid[0].device).manual_seed(seed)
    heads = model.classificationModel, model.regressionModel
    with torch.inference_mode():
        want = apply_heads(*heads, pyramid)
        moved = apply_heads(*heads, [_ulp_step(p, gen) for p in pyramid])
    return _gap(moved[0], want[0]), _gap(moved[1], want[1])


def _differing_slots(got, want) -> int:
    """Detection slots (image, rank) that hold a detection in either and
    whose score, label or box differ."""
    scores, labels, boxes = (g != w for g, w in zip(got, want))
    valid = (got[1] >= 0) | (want[1] >= 0)
    return int((valid & (scores | labels | boxes.any(dim=-1))).sum())


def check_fused_inference(kernel_rows, inputs: dict, label: str, dataset: str, dtype: str,
                          batch: int, per_batch: dict):
    """The fused heads at inference against the unfused heads at the same
    weights and batch ('pooled' postprocess): each model's ms a batch over
    OPTIONS_TIMED batches with its launches (``per_batch`` each, nothing
    else) and its detections; the gap of the probabilities and the deltas
    (max and mean), gated under twice the one-ulp witness of the pyramid
    through the unfused heads, and no detection slot differing. Returns (the unfused function, the batch, its pyramid)."""
    from frn_tpu_torch.models.heads import apply_heads, fused_dual_heads

    rgb, event = _fixture_batch(inputs, dataset, batch)
    fns, res = {}, {}
    for fused in (False, True):
        fn = fns[fused] = _options_fn(inputs, dataset, dtype, fused_heads=fused)
        fn(rgb, event)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        ms, dets = cuda_ms(lambda: fn(rgb, event), reps=OPTIONS_TIMED, warmup=0)
        counts = _counts()
        want = {**dict.fromkeys(_COUNTERS, 0),
                **{k: n * OPTIONS_TIMED for k, n in per_batch.items()}}
        if counts != want:
            fail(f"fused heads ({label}, fused {fused}) launched {counts}, expected {want}")
        for key, n in per_batch.items():
            kernel_rows[key]["launches"] += counts[key]
        res[fused] = ms, dets, fn.forward(rgb, event)
    model = fns[False].model
    pyramid = _pyramid(model, rgb, event)
    with torch.inference_mode():
        heads = model.classificationModel, model.regressionModel
        unfused = apply_heads(*heads, pyramid)
        fused = fused_dual_heads(*heads, pyramid, model.config.model.num_classes,
                                 model.config.anchors.num_anchors_per_cell, model.compute_dtype)
    witness = _heads_witness(model, pyramid, seed=41)
    gaps = [_gap(f, u) for f, u in zip(res[True][2], res[False][2])]
    heads_gaps = [_gap(f, u) for f, u in zip(fused, unfused)]
    valid = [int((res[f][1][1] >= 0).sum()) for f in (False, True)]
    differ = _differing_slots(res[True][1], res[False][1])
    print(f"fused heads ({label}, batch {batch}, postprocess pooled): unfused "
          f"{res[False][0]:.2f} ms a batch, fused {res[True][0]:.2f} (forward + decode + NMS, "
          f"CUDA events over {OPTIONS_TIMED} batches); detections {valid[0]} and {valid[1]} valid "
          f"slots, {differ} differ; fused vs unfused model: "
          f"max gap probs {_gap_text(gaps[0])}, deltas {_gap_text(gaps[1])} (heads alone on one "
          f"pyramid {_gap_text(heads_gaps[0])}, {_gap_text(heads_gaps[1])}); one-ulp witness of "
          f"the pyramid {_gap_text(witness[0])}, {_gap_text(witness[1])}; launches "
          f"{json.dumps(per_batch)} a batch", flush=True)
    # at random weights most probabilities saturate, so a max gap of a flip
    # near 0 or 1 passes the witness's; the detections must not differ at all
    if not all(_under(g, w, 2) for g, w in zip(gaps, witness)) or min(valid) == 0 or differ:
        fail(f"fused heads ({label}): gaps {gaps} over twice the one-ulp witness {witness}, "
             f"no detections ({valid}), or {differ} detection slots differ")
    del fns[True], res
    return fns[False], (rgb, event), pyramid


def _rung_outputs(model, pyramid):
    """Each postprocess rung's head outputs of ``pyramid`` in its emission
    (the 'probs' emissions in f32, as the detector gives them)."""
    from frn_tpu_torch.models.heads import apply_heads

    heads = model.classificationModel, model.regressionModel
    out = {}
    with torch.inference_mode():
        for rung, (cls_mode, reg_mode) in POSTPROCESS_RUNGS.items():
            if rung == "pooled":
                out[rung] = out["dense"]
                continue
            cls, reg = apply_heads(*heads, pyramid, cls_mode, reg_mode)
            out[rung] = (cls.float(), reg.float()) if cls_mode == "probs" else (cls, reg)
    return out


def _tempered(out):
    """The rungs' head outputs with the logits scaled by a power of two
    (exact) to at most TEMPERED_LOGIT_MAX in magnitude, and the 'probs'
    emissions their f32 sigmoid: probabilities that do not saturate, for
    pools and NMS that rank by score rather than by index among ties at 1.0."""
    logits, reg_rows = out["pooled_logits"]
    scale = 2.0 ** math.floor(math.log2(TEMPERED_LOGIT_MAX / logits.float().abs().max().item()))
    probs = torch.sigmoid((logits * scale).float())
    return {"dense": (probs, reg_rows), "pooled": (probs, reg_rows),
            "pooled_logits": (logits * scale, reg_rows),
            "pooled_chanlast": (out["pooled_chanlast"][0] * scale, out["pooled_chanlast"][1])}


def _pool_tables(out, config):
    """(B*K, A) score tables as the pool takes them: the thresholded
    probabilities (nonnegative, no -0.0), the logits with the logit-space
    sentinel, and the probabilities rounded to 1/32 (a table of ties)."""
    from frn_tpu_torch.core.nms import LOGIT_LO

    thr = config.eval.score_threshold
    probs = out["dense"][0].transpose(1, 2).flatten(0, 1)
    logits = out["pooled_chanlast"][0].flatten(0, 1)
    lo = torch.tensor(LOGIT_LO, dtype=logits.dtype, device=logits.device)
    logit_thr = torch.tensor(math.log(thr / (1 - thr)), dtype=logits.dtype, device=logits.device)
    return {"probs": (torch.where(probs > thr, probs, torch.zeros_like(probs)), True),
            "logits": (torch.where(logits > logit_thr, logits, lo), False),
            "tied": ((probs * 32).round() / 32, True)}


def check_postprocess_rungs(fn, pyramid, label: str) -> dict:
    """The postprocess rungs on one batch's head outputs, as the random
    weights give them and tempered (``_tempered``): dense against pooled bit
    for bit, pooled_logits and pooled_chanlast against dense (printed: at
    the random weights the detections that differ are sigmoid-saturation
    ties); the pool's top-k (two_stage) against the sort bit for bit (values
    and indices) on the (B*K, A) score tables and a tied table; device ms of
    the sort and the pool on the probabilities and of each rung's decode +
    NMS. Returns {name: ms}."""
    from frn_tpu_torch.core import nms
    from frn_tpu_torch.models.detector import decode_detections

    config = fn.config
    saturated = _rung_outputs(fn.model, pyramid)
    times = {}
    for outputs, out in (("random weights", saturated), ("tempered", _tempered(saturated))):
        dets = {}
        for rung in POSTPROCESS_RUNGS:
            cfg = dataclasses.replace(config, eval=dataclasses.replace(config.eval,
                                                                       postprocess=rung))
            ms, dets[rung] = cuda_ms(
                lambda: decode_detections(*out[rung], cfg, anchors=fn.anchors), reps=5)
            times[f"{outputs}: {rung}"] = ms
        if not all(torch.equal(a, b) for a, b in zip(dets["dense"], dets["pooled"])):
            fail(f"postprocess ({label}, {outputs}): dense and pooled disagree")
        differ = {rung: (_differing_slots(dets[rung], dets["dense"]),
                         int((dets[rung][1] != dets["dense"][1]).sum()))
                  for rung in ("pooled_logits", "pooled_chanlast")}
        valid = int((dets["dense"][1] >= 0).sum())
        ties = int((dets["dense"][0] == 1.0).sum())
        k = config.eval.per_class_topk
        for name, (table, nonneg) in _pool_tables(out, config).items():
            pools = {"sort": lambda: nms.exact_topk(table, k),
                     "two_stage": lambda: nms.exact_topk_two_stage(table, k, nonnegative=nonneg)}
            res = {}
            for pool, run in pools.items():
                ms, res[pool] = cuda_ms(run, reps=5)
                if name == "probs":
                    times[f"{outputs}: pool {pool}"] = ms
            bits = torch.int16 if table.dtype == torch.bfloat16 else torch.int32
            if not (torch.equal(res["two_stage"][1], res["sort"][1])
                    and torch.equal(res["two_stage"][0].view(bits), res["sort"][0].view(bits))):
                fail(f"postprocess ({label}, {outputs}): the two_stage pool differs from the "
                     f"sort on the {name} table {tuple(table.shape)}")
        print(f"postprocess rungs ({label}, {outputs}, {tuple(out['dense'][0].shape)} "
              f"probabilities): dense = pooled bit for bit, {valid} valid slots, {ties} of them "
              f"at probability 1.0; against dense, (slots that differ, of them in label) "
              f"{differ['pooled_logits']} in pooled_logits and {differ['pooled_chanlast']} in "
              f"pooled_chanlast; the two_stage pool equal to the sort bit for bit on the probs, "
              f"logits and tied tables ({table.shape[0]} rows of {table.shape[1]}, k {k})",
              flush=True)
    print(f"postprocess device ms ({label}, CUDA events): "
          f"{json.dumps({n: round(t, 4) for n, t in times.items()})}", flush=True)
    return times


def check_fused_training(kernel_rows, inputs: dict, root: Path) -> None:
    """One f32 micro-step of the train CLI's ``Trainer`` (batch 2, DSEC, the
    seeded ``.pth``) with ``fused_heads`` against the unfused trainer at the
    same weights and batch: the losses within WIRE_LOSS_RTOL, the gradients
    per tensor and over all parameters under the phase-9 gate
    (F32_GRAD_REL_TOL, F32_GRAD_NORM_TOL), beside the unfused step again
    (the run to run spread) and a witness (the unfused step with the pyramid
    moved one f32 ulp); the fused step's launches (B1-lse, B2a and B2b at
    f32 4 each, nothing else)."""
    from frn_tpu_torch.cli import common, train
    from frn_tpu_torch.data.collate import collate_fixed
    from frn_tpu_torch.data.loader import to_device
    from frn_tpu_torch.train.trainer import Trainer

    args = train.get_parser().parse_args(_train_cli_flags(inputs, "dsec", root, F32_TRAIN_BATCH))
    device = common.setup_device(args)
    ds = common.build_csv_dataset(args, args.csv_train)
    cfg = common.build_config(args, ds.num_classes(), args.batch_size, args.epochs)
    states = {}
    for fused in (False, True):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, fused_heads=fused))
        trainer = Trainer(c, ds, device=device)
        common.load_checkpoint_into_state(args, trainer.state)
        states[fused] = trainer.state, c
    b = F32_TRAIN_BATCH
    batch = to_device(collate_fixed([ds[i] for i in range(b)], cfg.geometry,
                                    cfg.train.max_annots_per_image, b), device)
    torch.cuda.synchronize()
    _reset_counts()
    loss_f, grads_f = _batch_grads(*states[True], batch)
    counts = _counts()
    want = {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_F32_KERNELS, 4)}
    if counts != want:
        fail(f"fused-heads micro-step launched {counts}, expected {want}")
    for key in TRAIN_F32_KERNELS:
        kernel_rows[key]["launches"] += counts[key]
    state, c = states[False]
    loss_u, grads_u = _batch_grads(state, c, batch)
    _, grads_again = _batch_grads(state, c, batch)
    fpn, gen = state.model.fpn, torch.Generator(device=device).manual_seed(47)
    fpn_forward = fpn.forward
    fpn.forward = lambda feats: [_ulp_step(p, gen) for p in fpn_forward(feats)]
    try:
        _, grads_ulp = _batch_grads(state, c, batch)
    finally:
        del fpn.forward
    worst = {}
    for name, got in (("fused", grads_f), ("unfused again", grads_again),
                      ("unfused, pyramid one ulp", grads_ulp)):
        worst[name] = _worst_grad_gap(state.names, got, grads_u)
        (gap, tensor), bias_gap, norm_gap = worst[name]
        print(f"fused-heads training (DSEC f32, batch {b}, one micro-step), {name} vs unfused: "
              f"worst tensor max|diff|/max|ref| {gap:.3e} ({tensor}); theta biases {bias_gap:.3e}; "
              f"over all params {norm_gap:.3e}", flush=True)
    (gap, tensor), bias_gap, norm_gap = worst["fused"]
    rel = abs(loss_f.item() - loss_u.item()) / abs(loss_u.item())
    print(f"fused-heads training: loss {loss_f.item():.6f} fused, {loss_u.item():.6f} unfused "
          f"(relative gap {rel:.3e}, at most {WIRE_LOSS_RTOL:.0e}); gradient gates "
          f"{F32_GRAD_REL_TOL:.0e} per tensor, {F32_GRAD_NORM_TOL:.0e} over all params; launches "
          f"{json.dumps({k: counts[k] for k in TRAIN_F32_KERNELS})}", flush=True)
    if not rel <= WIRE_LOSS_RTOL:
        fail(f"fused-heads training: losses {loss_f.item()} and {loss_u.item()} disagree")
    if not (gap <= F32_GRAD_REL_TOL and bias_gap <= F32_GRAD_REL_TOL
            and norm_gap <= F32_GRAD_NORM_TOL):
        fail(f"fused-heads training: gradients disagree with the unfused heads' ({gap:.3e} at "
             f"{tensor}, theta biases {bias_gap:.3e}, over all params {norm_gap:.3e})")


def check_disable_flash(kernel_rows, fn, rgb, event) -> None:
    """One bf16 batch with ``FRN_DISABLE_FLASH=1`` set inside the phase: the
    forward raises before any launch (the port has no dense route on the
    card); with it removed again, B1 4 times."""
    with torch.inference_mode():
        torch.cuda.synchronize()
        _reset_counts()
        os.environ["FRN_DISABLE_FLASH"] = "1"
        try:
            fn.model(rgb, event, eval_output="logits_chanlast36", train=False)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        finally:
            del os.environ["FRN_DISABLE_FLASH"]
        torch.cuda.synchronize()
        off = _counts()
        _reset_counts()
        fn.model(rgb, event, eval_output="logits_chanlast36", train=False)
        torch.cuda.synchronize()
        on = _counts()
    print(f"FRN_DISABLE_FLASH=1 (bf16, batch {rgb.shape[0]}): raised {raised!r}, launches "
          f"{sum(off.values())}; removed again: flash_fwd {on['flash_fwd']} launches", flush=True)
    if raised is None or "FRN_DISABLE_FLASH" not in raised or any(off.values()):
        fail(f"FRN_DISABLE_FLASH: the forward did not raise ({raised!r}) or launched {off}")
    if on != {**dict.fromkeys(_COUNTERS, 0), "flash_fwd": 4}:
        fail(f"FRN_DISABLE_FLASH removed: launches {on}")
    kernel_rows["flash_fwd"]["launches"] += on["flash_fwd"]


def phase_options(kernel_rows, inputs: dict, root: Path) -> None:
    """The last model and postprocess options (A17) at full width (fusion
    ResNet-50, feature size 256, phase 8's seeded ``.pth`` files and
    fixtures): the fused heads at inference (DSEC bf16 at batch 16, DDD17
    f32 at batch 8: the cls-padding cases) and in one f32 micro-step of the
    train CLI's trainer; the postprocess rungs and the pool's top-k on the
    bf16 batch's head outputs at bf16 and f32; ``FRN_DISABLE_FLASH`` set and
    removed inside the phase; and ``cli.test --postprocess dense
    --approx_topk`` on phase 8's DSEC fixture at bf16 (B1 4 times a batch,
    nothing else; its summary beside phase 8's)."""
    print(f"model and postprocess options on {card_name_and_power_limit()}", flush=True)
    started = time.perf_counter()
    fn = rgb = event = pyramid = None
    for label, dataset, dtype, batch, per_batch in OPTIONS_INFERENCE:
        got = check_fused_inference(kernel_rows, inputs, label, dataset, dtype, batch, per_batch)
        if dataset == "dsec":
            fn, (rgb, event), pyramid = got
        del got
    print(f"[phase 14 at {time.perf_counter() - started:.1f} s] fused heads at inference checked",
          flush=True)
    for label, pyr in (("bf16", pyramid), ("f32", [p.float() for p in pyramid])):
        check_postprocess_rungs(fn, pyr, f"{label}, batch {MAIN_BATCH}")
    check_disable_flash(kernel_rows, fn, rgb, event)
    del fn, rgb, event, pyramid
    torch.cuda.empty_cache()
    print(f"[phase 14 at {time.perf_counter() - started:.1f} s] postprocess rungs and "
          f"FRN_DISABLE_FLASH checked", flush=True)
    check_fused_training(kernel_rows, inputs, root)
    torch.cuda.empty_cache()
    folder = str(root / "eval_dense_approx")
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    text, counts, seconds = run_eval_cli(
        "DSEC bf16, --postprocess dense --approx_topk", "test",
        _cli_flags(inputs, "dsec", folder, "--compute_dtype", "bfloat16", "--postprocess", "dense",
                   "--approx_topk"))
    if counts != {**dict.fromkeys(_COUNTERS, 0), "flash_fwd": 4 * batches}:
        fail(f"evaluation (dense, approx_topk) launched {counts}")
    kernel_rows["flash_fwd"]["launches"] += counts["flash_fwd"]
    fps, summary = check_eval_summary("DSEC bf16, dense, approx_topk", text, folder)
    print(f"evaluation DSEC bf16, --postprocess dense --approx_topk: {fps:.2f} img/s, summary "
          f"{json.dumps(summary)}; phase 8 (pooled_chanlast, exact pool): "
          f"{json.dumps(EVAL_SUMMARIES.get('DSEC bf16'))}", flush=True)
    print(f"phase 14 (model and postprocess options) passed in "
          f"{time.perf_counter() - started:.1f} s", flush=True)


# ------------------------------------------------------------ phase 15: depth 18 and 34

# the d 8 and 16 instances (the depth-18 and -34 detectors' stages 1 and 2):
# rows of the kernels line named after their kind, beside the depth-50 rows
DEPTH18_SUFFIX = "_d8_16"
# the kernels' checks at the paths' N and d run at batch 2: the plain
# versions take 0.1-0.6 s a launch at the paths' batches
DEPTH18_CHECK_BATCH = 2
# rows a block owns in the d 8 and 16 mma.sync kernels: the forward's
# (csrc/flash_attention.cu, launch_mma: 128), the ring dQ and dK/dV kernels'
# (csrc/flash_attention_bwd.cu, dq_rows: 64, dkv_rows: 128) and the ring
# int8 forward's (csrc/flash_attention_int8.cu, ring_rows: 64)
MMA_ROWS = {"flash_fwd": 128, "flash_fwd_lse": 128, "flash_fwd_bf16exp": 128,
            "flash_bwd_dq": 64, "flash_bwd_dkv": 128, "flash_int8_qk": 64, "flash_int8": 64}
# the depth-18 paths' runs: inference batches timed, the bf16 micro-step's
# batch, the f32 train CLI's images (one micro-step at its batch 2)
DEPTH18_TIMED = 3
DEPTH18_TRAIN_IMAGES = F32_TRAIN_BATCH


def depth18_blocks(kind: str, b: int, n: int, d: int) -> int:
    """Blocks of one launch of ``kind`` at (B, N, d), d 8 or 16."""
    from frn_tpu_torch.ops import flash_attention as fa

    if kind in ("flash_fwd_f32", "flash_fwd_lse_f32"):
        return fa.f32_launch_plan(b, n, d)["blocks"]
    if kind in ("flash_bwd_dq_f32", "flash_bwd_dkv_f32"):
        return fa.f32_bwd_launch_plan(b, n, d, kind.split("_")[2])["blocks"]
    return b * -(-n // MMA_ROWS[kind])


def depth18_launch_shapes() -> dict:
    """{kind: [(B, N, d, count)]}: every timed launch of the eleven d 8 and 16
    instances at its path's batch, ``count`` its launches per inference
    batch or micro-step (two directions at DSEC stages 1 and 2; B4 ``int8``
    once over 2B under fused attention), DDD17's stage 1 with count 0 (a
    launch of its own, printed beside the DSEC sum)."""
    dsec = DEPTH18_FLASH_SHAPES
    ddd17_n, ddd17_d = DEPTH18_DDD17_SHAPE
    out = {kind: [(MAIN_BATCH, n, d, 2) for n, d in dsec]
           for kind in ("flash_fwd", "flash_fwd_bf16exp", "flash_int8_qk")}
    out["flash_int8"] = [(2 * MAIN_BATCH, n, d, 1) for n, d in dsec]
    for kind in TRAIN_KERNELS:
        out[kind] = [(TRAIN_BATCH, n, d, 2) for n, d in dsec]
    out["flash_fwd_f32"] = ([(EVAL_BATCH, n, d, 2) for n, d in dsec]
                            + [(EVAL_BATCH, ddd17_n, ddd17_d, 0)])
    for kind in TRAIN_F32_KERNELS:
        out[kind] = ([(F32_TRAIN_BATCH, n, d, 2) for n, d in dsec]
                     + [(DDD17_TRAIN_BATCH, ddd17_n, ddd17_d, 0)])
    return out


def depth18_path_launches() -> dict:
    """Each d 8 and 16 instance's launches over phase 15's runs:
    DEPTH18_TIMED default batches at depth 18 and one at depth 34 (B1 4 a
    batch), one batch of each opt-in configuration (B3 4, B4 ``int8_qk`` 4,
    B4 ``int8`` 2 over 2B), ``cli.test`` at depth 18 over EVAL_IMAGES (B1 at
    f32 4 a DSEC batch, 2 a DDD17 one), one f32 train-CLI micro-step and one
    bf16 micro-step (4 each)."""
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    steps = DEPTH18_TRAIN_IMAGES // F32_TRAIN_BATCH
    return {"flash_fwd": 4 * (DEPTH18_TIMED + 1), "flash_fwd_bf16exp": 4, "flash_int8_qk": 4,
            "flash_int8": 2, **dict.fromkeys(TRAIN_KERNELS, 4),
            "flash_fwd_f32": (4 + 2) * batches, **dict.fromkeys(TRAIN_F32_KERNELS, 4 * steps)}


def depth18_bound(kind: str, b: int, n: int, d: int):
    """(bytes time, operations time) of one launch of ``kind``: ``f32_bound``
    for the f32 kinds, ``kernel_bound`` for the others."""
    return f32_bound(b, n, d, kind) if kind.endswith("_f32") else kernel_bound(kind, b, n, d)


def _sdpa_backend(q4, k4, v4) -> str:
    """The backend SDPA takes on these (B, 1, N, d) inputs at scale 1.0 (a
    gradient wanted where they require one), by torch's own selector."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q4, k4, v4, scale=1.0)).name


def _sdpa_times(q, k, v, do=None):
    """SDPA at scale 1.0 on (B, N, d) q, k, v as one head: (forward ms,
    backward ms or None, backend); with ``do``, its autograd backward (dQ,
    dK and dV together) on the forward's graph."""
    import torch.nn.functional as F

    q4, k4, v4 = (x.unsqueeze(1).detach().requires_grad_(do is not None) for x in (q, k, v))
    backend = _sdpa_backend(q4, k4, v4)
    fwd_ms, _ = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0), reps=10)
    bwd_ms = None
    if do is not None:
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        bwd_ms, _ = cuda_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do.unsqueeze(1),
                                                        retain_graph=True), reps=10)
        del out
    return fwd_ms, bwd_ms, backend


def _depth18_calls(fa, kind: str, q, k, v, do=None, lse=None, delta=None):
    """(kernel, plain) callables of ``kind`` on these inputs."""
    if kind in ("flash_fwd", "flash_fwd_f32"):
        return lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_plain(q, k, v)
    if kind in ("flash_fwd_lse", "flash_fwd_lse_f32"):
        return (lambda: fa.flash_attention(q, k, v, return_lse=True),
                lambda: fa.flash_attention_plain(q, k, v, return_lse=True))
    if kind == "flash_fwd_bf16exp":
        return lambda: fa.flash_attention_bf16exp(q, k, v), lambda: fa.flash_attention_bf16exp_plain(q, k, v)
    if kind in ("flash_int8_qk", "flash_int8"):
        mode = kind[len("flash_"):]
        return (lambda: fa.flash_attention_int8(q, k, v, mode),
                lambda: fa.flash_attention_int8_plain(q, k, v, mode))
    if kind.startswith("flash_bwd_dq"):
        return (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta))
    return (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta))


def _depth18_check(kind: str, got, want, shape, errs: dict) -> None:
    """``kind``'s outputs against its plain version's at the gates of its
    depth-50 instances (the f32 and bf16 forward, lse and backward gates)."""
    f32 = kind.endswith("_f32")
    if kind.startswith("flash_bwd"):
        atol, rtol = (BWD_F32_ATOL, BWD_F32_RTOL) if f32 else (BWD_ATOL, BWD_RTOL)
        pairs = ((("dq", got, want),) if "_dq" in kind
                 else (("dk", got[0], want[0]), ("dv", got[1], want[1])))
        for name, g, w in pairs:
            check_close(kind, name, g, w, atol * w.float().abs().max().item(), rtol, shape, errs)
        return
    atol, rtol = (FLASH_F32_ATOL, FLASH_F32_RTOL) if f32 else (FLASH_ATOL, FLASH_RTOL)
    if "_lse" not in kind:
        check_close(kind, "o", got, want, atol, rtol, shape, errs)
        return
    check_close(kind, "o", got[0], want[0], atol, rtol, shape, errs)
    check_close(kind, "lse", got[1], want[1], LSE_F32_ATOL if f32 else LSE_ATOL, 0.0, shape, errs)
    if not f32:
        check_mean_lse(kind, got[1], want[1], shape)


def phase_depth18_kernels() -> dict:
    """The eleven d 8 and 16 instances (B1, B1-lse, B3, B2a, B2b, B4 in both
    modes at bf16; B1, B1-lse, B2a, B2b at f32): each against its plain
    version at the depth-18 paths' N and d (DSEC stages 1 and 2, DDD17's
    stage 1) at batch DEPTH18_CHECK_BATCH, then timed at its path's batch
    (``depth18_launch_shapes``) beside its bound, its blocks per launch, its
    plain version and SDPA at scale 1.0 (f32 for the f32 rows; its autograd
    backward for B2; for B4, no PyTorch call computes the quantized
    function: SDPA at bf16 beside it), with the backend SDPA took. Returns
    the rows, named ``<kind>_d8_16``."""
    from frn_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(30)

    def inputs(b, n, d, dtype, forward=fa.flash_attention_plain):
        """q, k, v, dO, and lse and D from ``forward`` (both backward
        versions get the same)."""
        q, k, v, do = (torch.randn((b, n, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = forward(q, k, v, return_lse=True)
        return q, k, v, do, lse, fa.attention_delta(o, do)

    plan = depth18_launch_shapes()
    errs = {}
    for n, d in DEPTH18_FLASH_SHAPES + (DEPTH18_DDD17_SHAPE,):
        shape = (DEPTH18_CHECK_BATCH, n, d)
        for dtype in (torch.bfloat16, torch.float32):
            args = inputs(*shape, dtype)
            for kind in plan:
                if kind.endswith("_f32") == (dtype == torch.float32):
                    kernel, plain = _depth18_calls(fa, kind, *args)
                    _depth18_check(kind, kernel(), plain(), shape, errs)
            del args

    rows = {}
    for kind, launches in plan.items():
        f32 = kind.endswith("_f32")
        times = KernelTimes(kind, kind + DEPTH18_SUFFIX)
        for b, n, d, count in launches:
            args = inputs(b, n, d, torch.float32 if f32 else torch.bfloat16, fa.flash_attention)
            q, k, v, do = args[:4]
            fwd_ms, bwd_ms, backend = _sdpa_times(q, k, v, do if kind.startswith("flash_bwd") else None)
            library_ms, extra = (bwd_ms or fwd_ms), None
            if kind in ("flash_int8_qk", "flash_int8"):
                # the wrapper's time holds the pre-pass's: the kernel alone on
                # the pre-pass's outputs (CUDA events) and the pre-pass's
                # device time beside it show the kernel's share. Late in the
                # whole script torch.profiler has recorded no device kernel
                # in this process: a 0 there is not measured (null)
                mode = kind[len("flash_"):]
                quantized = fa.int8_prepass(q, k, v, mode)
                kernel_ms, _ = cuda_ms(lambda: other_int8(fa._int8_library(), q, quantized, mode),
                                       reps=10)
                prepass_ms = device_ms(lambda: fa.int8_prepass(q, k, v, mode),
                                       ("int8_absmax_partial", "int8_quantize")) or None
                library_ms, extra = None, {"sdpa_bf16_ms": fwd_ms, "kernel_ms": kernel_ms,
                                           "prepass_device_ms": prepass_ms}
                del quantized
            shape = {"B": b, "N": n, "d": d, "blocks": depth18_blocks(kind, b, n, d),
                     "sdpa_backend": backend}
            kernel, plain = _depth18_calls(fa, kind, *args)
            got, want = times.add(shape, depth18_bound(kind, b, n, d), kernel, plain, library_ms,
                                  count=count, extra=extra)
            _depth18_check(kind, got, want, (b, n, d), errs)
            del args, got, want
        rows[times.name] = times.row(errs[kind], "depth-18 batch or micro-step")
    print(f"depth-18 kernels: checks and timings in {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def _depth18_pth(root: Path, geo, name: str) -> str:
    """A ``.pth`` of the seeded fusion ResNet-18 (feature size 256) at ``geo``,
    random head output convs, as ``write_eval_inputs`` writes depth 50's."""
    from frn_tpu_torch import config as c
    from frn_tpu_torch.models.detector import init_detector

    cfg = c.FrameworkConfig(geometry=geo, model=c.ModelConfig(
        variant="fusion", num_classes=geo.num_classes, depth=18))
    model = init_detector(cfg, seed=15, device="cpu")
    _random_head_outputs(model, seed=16)
    path = str(root / f"{name}_r18.pth")
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, path)
    return path


def _depth18_inference(depth: int, batches: int, optin: dict, want_per_batch: dict,
                       label: str, compare: bool = False) -> dict:
    """``entry(depth=depth, batch=MAIN_BATCH, **optin)`` on the card: one
    warm-up batch, then ``batches`` timed with the launch counts zeroed just
    before and read just after (``want_per_batch`` a batch, nothing else);
    detections finite, of the expected shapes, labels in range; with
    ``compare``, the logits and deltas against the same model with the plain
    attention (MAIN_REL_TOL). Returns the counts."""
    from frn_tpu_torch.entry import entry
    from frn_tpu_torch.ops import attention
    from frn_tpu_torch.ops import flash_attention as fa

    fn, (rgb, event) = entry(device="cuda", batch=MAIN_BATCH, depth=depth, **optin)
    _random_head_outputs(fn.model, seed=1)
    fn(rgb, event)
    torch.cuda.synchronize()
    _reset_counts()
    times = []
    for _ in range(batches):
        t0 = time.perf_counter()
        scores, labels, boxes = fn(rgb, event)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _counts()
    want = {**dict.fromkeys(_COUNTERS, 0), **{k: v * batches for k, v in want_per_batch.items()}}
    ms = statistics.mean(times)
    print(f"depth {depth} ({label}): DSEC 480x640 fusion R{depth} bf16 batch {MAIN_BATCH}, forward + "
          f"decode + NMS {ms:.2f} ms/batch (runs {', '.join(f'{t:.2f}' for t in times)}), "
          f"{MAIN_BATCH * 1e3 / ms:.1f} img/s; launches {json.dumps(counts)}", flush=True)
    if counts != want:
        fail(f"depth {depth} ({label}) launched {counts}, expected {want}")
    m, k = fn.config.eval.max_detections, fn.config.model.num_classes
    if ((scores.shape, labels.shape, boxes.shape) != ((MAIN_BATCH, m), (MAIN_BATCH, m),
                                                      (MAIN_BATCH, m, 4))
            or not (torch.isfinite(scores).all() and torch.isfinite(boxes).all())
            or int((labels >= 0).sum()) == 0 or int(labels.max()) >= k):
        fail(f"depth {depth} ({label}): detections of shapes {scores.shape} {labels.shape} "
             f"{boxes.shape}, {int((labels >= 0).sum())} valid, labels up to {int(labels.max())}")
    if compare:
        with torch.inference_mode():
            got = fn.model(rgb, event, eval_output=fn.eval_output)
            kernel_fn = attention.flash_attention
            attention.flash_attention = fa.flash_attention_plain
            try:
                want_out = fn.model(rgb, event, eval_output=fn.eval_output)
            finally:
                attention.flash_attention = kernel_fn
        for name, g, w in zip(("logits", "deltas"), got, want_out):
            rel = ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
            print(f"depth {depth} {name}, kernel vs plain attention: max|diff|/max|ref| = "
                  f"{rel:.3e}", flush=True)
            if not rel <= MAIN_REL_TOL:
                fail(f"depth {depth} {name} disagree with the plain attention run ({rel:.3e})")
    del fn, rgb, event
    torch.cuda.empty_cache()
    return counts


def _add_launches(total: dict, counts: dict) -> None:
    for kind, n in counts.items():
        total[kind] = total.get(kind, 0) + n


def phase_depth18(kernel_rows, inputs: dict, root: Path) -> None:
    """The depth-18 and -34 paths at full width (DSEC 480x640, fusion, feature
    size 256, 3 classes, seeded random weights), whose REFusion stages 1 and
    2 run the flash kernels at d 8 and 16: the eleven d 8 and 16 instances
    checked and timed (``phase_depth18_kernels``, rows added to
    ``kernel_rows``); bf16 inference at batch 16 through ``entry(depth=18)``
    (DEPTH18_TIMED batches after a warm-up, B1 4 a batch, the logits against
    the plain attention), the three opt-in configurations (OPTIN_CONFIGS) and
    depth 34, one batch each; ``cli.test --depth 18`` at f32 on phase 8's
    DSEC fixture (B1 at f32 4 a batch) and ``test_ddd17 --depth 18`` (2 a
    batch); one f32 micro-step of ``cli.train --depth 18`` at batch 2 (B1-lse,
    B2a and B2b at f32 4 each); one bf16 micro-step of
    ``train_entry(depth=18)`` at batch 8 (B1-lse, B2a, B2b 4 each). Each run
    with the launch counts zeroed just before and read just after, its
    outputs or losses finite; each row's launches are the sum over these
    runs."""
    from frn_tpu_torch import config as c
    from frn_tpu_torch.entry import train_entry
    from frn_tpu_torch.train.checkpoint import CheckpointManager

    print(f"depth 18 and 34 on {card_name_and_power_limit()}", flush=True)
    t0 = time.perf_counter()
    rows = phase_depth18_kernels()
    launches: dict = {}

    # bf16 inference: the default path, the opt-in configurations, depth 34
    _add_launches(launches, _depth18_inference(18, DEPTH18_TIMED, {}, {"flash_fwd": 4}, "default",
                                               compare=True))
    for label, optin, per_batch in OPTIN_CONFIGS:
        _add_launches(launches, _depth18_inference(18, 1, optin, per_batch, label))
    _add_launches(launches, _depth18_inference(34, 1, {}, {"flash_fwd": 4}, "default"))

    # f32 evaluation through the CLIs at depth 18
    pths = {"dsec": _depth18_pth(root, c.DSEC, "dsec"), "ddd17": _depth18_pth(root, c.DDD17, "ddd17")}
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    for label, module, dataset, per_batch in (("DSEC f32", "test", "dsec", 4),
                                              ("DDD17 f32", "test_ddd17", "ddd17", 2)):
        folder = str(root / f"eval_r18_{dataset}")
        fix = inputs[dataset]
        argv = ["--csv_classes", fix["class_map_csv"], "--root_img", fix["img_dir"],
                "--root_event", fix["event_dir"], "--csv_test", fix["annotations_csv"],
                "--checkpoint", pths[dataset], "--batch_size", str(EVAL_BATCH),
                "--save_detect_folder", folder, "--depth", "18"]
        text, counts, seconds = run_eval_cli(f"depth 18, {label}", module, argv)
        want = {**dict.fromkeys(_COUNTERS, 0), "flash_fwd_f32": per_batch * batches}
        if counts != want:
            fail(f"depth-18 evaluation ({label}) launched {counts}, expected {want}")
        fps, summary = check_eval_summary(f"depth 18, {label}", text, folder)
        print(f"depth-18 evaluation ({label}): {fps:.2f} img/s by the CLI ({EVAL_IMAGES} images, "
              f"batch {EVAL_BATCH}), {seconds:.1f} s; mAP {summary['mAP']:.4f}", flush=True)
        _add_launches(launches, counts)

    # one f32 micro-step through the train CLI at its batch 2
    fix = _subset_fixture(inputs["dsec"], DEPTH18_TRAIN_IMAGES, root / "r18_train.csv")
    ckpt_dir = root / "train_r18"
    argv = ["--csv_train", fix["annotations_csv"], "--csv_classes", fix["class_map_csv"],
            "--root_img", fix["img_dir"], "--root_event", fix["event_dir"],
            "--compute_dtype", "float32", "--batch_size", str(F32_TRAIN_BATCH), "--epochs", "1",
            "--continue_training", "--checkpoint", pths["dsec"], "--checkpoint_dir",
            str(ckpt_dir), "--depth", "18"]
    history, text, counts, seconds = run_cli("depth 18, train CLI, DSEC f32", "train", argv)
    steps = DEPTH18_TRAIN_IMAGES // F32_TRAIN_BATCH
    want = {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_F32_KERNELS, 4 * steps)}
    if counts != want:
        fail(f"depth-18 train CLI launched {counts}, expected {want}")
    if not (len(history) == 1 and math.isfinite(history[0])) or "skipped" in text:
        fail(f"depth-18 train CLI: loss history {history}, a micro-step skipped or not finite")
    saved = torch.load(CheckpointManager(str(ckpt_dir)).path(1), map_location="cpu",
                       weights_only=True)
    if saved["epoch"] != 1:
        fail("depth-18 train CLI wrote no checkpoint of epoch 1")
    print(f"depth-18 train CLI: {steps} f32 micro-step of batch {F32_TRAIN_BATCH} in {seconds:.1f} s "
          f"(model build and loading included); loss {history[0]:.5f}", flush=True)
    _add_launches(launches, counts)
    del saved

    # one bf16 micro-step through train_entry at batch 8, after a warm-up step
    trainer, batch = train_entry(device="cuda", batch=TRAIN_BATCH, num_samples=TRAIN_BATCH,
                                 depth=18)
    trainer.step_fn(trainer.state, batch, trainer.generator)
    torch.cuda.synchronize()
    _reset_counts()
    t1 = time.perf_counter()
    metrics = trainer.step_fn(trainer.state, batch, trainer.generator)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3
    counts = _counts()
    want = {**dict.fromkeys(_COUNTERS, 0), **dict.fromkeys(TRAIN_KERNELS, 4)}
    loss = metrics["loss"].item()
    print(f"depth-18 bf16 micro-step (batch {TRAIN_BATCH}): {step_ms:.2f} ms, loss {loss:.5f}, "
          f"skipped {metrics['skipped'].item():.0f}; launches {json.dumps(counts)}", flush=True)
    if counts != want or not math.isfinite(loss) or metrics["skipped"].item() != 0:
        fail(f"depth-18 bf16 micro-step: loss {loss}, launches {counts}, expected {want}")
    _add_launches(launches, counts)
    del trainer, batch, metrics
    torch.cuda.empty_cache()

    for kind, want in depth18_path_launches().items():
        if launches.get(kind, 0) != want:
            fail(f"{kind} was launched {launches.get(kind, 0)} times on the depth-18 and -34 "
                 f"paths, expected {want}")
        rows[kind + DEPTH18_SUFFIX]["launches"] = want
    kernel_rows.update(rows)
    print(f"depth 18 and 34: launches of the d 8 and 16 instances "
          f"{json.dumps(depth18_path_launches())}; phase in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_postprocess_against(other_nms: str, turns: int = 2) -> None:
    """The main path's decode + NMS (pooled_chanlast, the default) with
    another revision's ``core/nms.py`` against this one's, on the main
    path's head outputs (DSEC bf16 batch 16 at phase 3's random head weights,
    and the same outputs cast to f32), in turns other, this, this, other:
    ms a call by CUDA events over 10 back-to-back calls (the host's enqueue
    time where it is the longer) and the device-busy ms of all kernels
    (torch.profiler); and the whole main path, forward + decode + NMS, ms a
    batch by the host clock over MAIN_TIMED batches, as phase 3 times it.
    Each is the mean over its turns; the detections of both must be equal.
    Not run by ``main``; the kernels build on first use: ``python3 -c
    "import chip_smoke as c; c.phase_postprocess_against('OLD/core/nms.py')"``."""
    import importlib.util

    from frn_tpu_torch.entry import entry
    from frn_tpu_torch.models import detector

    spec = importlib.util.spec_from_file_location("nms_other", other_nms)
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    this = detector.pooled_detection_postprocess
    fn, (rgb, event) = entry(device="cuda", batch=MAIN_BATCH)
    _random_head_outputs(fn.model, seed=1)
    cls, reg = fn.forward(rgb, event)
    print(f"decode + NMS, {other_nms} against this revision ({fn.config.eval.postprocess}, "
          f"batch {MAIN_BATCH}) on {card_name_and_power_limit()}", flush=True)

    def main_path_ms():
        fn(rgb, event)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MAIN_TIMED):
            fn(rgb, event)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / MAIN_TIMED

    for label, outputs in (("bf16", (cls, reg)), ("f32", (cls.float(), reg.float()))):
        runs = {"other": [], "this": []}
        dets = {}
        for name in ("other", "this", "this", "other") * turns:
            detector.pooled_detection_postprocess = (
                other.pooled_detection_postprocess if name == "other" else this)
            try:
                call = lambda: fn.decode(*outputs)  # noqa: E731
                ms, dets[name] = cuda_ms(call, reps=10)
                busy = device_ms(call, [""], reps=10)
                whole = main_path_ms() if label == "bf16" else float("nan")
            finally:
                detector.pooled_detection_postprocess = this
            runs[name].append((ms, busy, whole))
        if not all(torch.equal(a, b) for a, b in zip(dets["other"], dets["this"])):
            fail(f"decode + NMS ({label}): the other revision's detections differ")
        mean = {n: [sum(r[i] for r in v) / len(v) for i in (0, 1, 2)] for n, v in runs.items()}
        whole = (f"; the main path (forward + decode + NMS, host clock): other "
                 f"{mean['other'][2]:.2f}, this {mean['this'][2]:.2f} ms a batch"
                 if label == "bf16" else "")
        print(f"decode + NMS ({label}): other {mean['other'][0]:.4f} ms a call, device busy "
              f"{mean['other'][1]:.4f} ms; this {mean['this'][0]:.4f} ms a call, device busy "
              f"{mean['this'][1]:.4f} ms{whole} (turns {json.dumps(runs)}); detections equal",
              flush=True)


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
    if "FRN_DISABLE_FLASH" in os.environ:  # every flash path raises with it set
        fail("FRN_DISABLE_FLASH is set: unset it, the script checks the flash kernels' paths")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    started = time.perf_counter()
    phase_environment()
    others = build_others(args.other_source) if args.other_source else {}
    rows = {"flash_fwd": phase_flash_kernel(), "flash_fwd_noexp": phase_flash_noexp(),
            "flash_fwd_f32": phase_flash_f32(),
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
        phase_serving(rows, inputs)
        phase_instruments(rows, inputs, root)
        phase_parallel(rows, inputs, root)
        phase_options(rows, inputs, root)
        phase_depth18(rows, inputs, root)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - started:.1f} s", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
