#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``frn_tpu_torch``).

    python3 chip_smoke.py          # one CUDA card; exits non-zero on any failure

Phases:
  1. environment and build: the card's name and power limit, then every CUDA
     kernel of the port built from ``frn_tpu_torch/csrc`` (one nvcc each, in
     parallel);
  2. each kernel against its plain PyTorch version on the card, at the shapes
     of the main path, then timed (CUDA events) beside its bound and a
     one-call PyTorch yardstick (``library_ms``, never used by the port);
  3. the main path, through ``frn_tpu_torch.entry.entry()``: DSEC 480x640
     fusion inference, two ResNet-50 backbones, bf16, batch 16, forward +
     pooled decode + NMS. Launch counts are zeroed just before the timed
     batches and read just after. The outputs are checked: finite, of the
     expected shapes, with detections; the logits agree with the same model
     run with the plain attention; then the device time of each layer of
     the path (CUDA events between layers), and a torch.profiler pass over
     one batch for the device-busy share and the costliest kernels; last, a
     small f32 model on the card agrees with the same model on the CPU;
  4. one JSON line listing the kernels, then the last line
     {"ok": true, "device": {...}}.
"""

import copy
import dataclasses
import json
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet) and the special-function-unit exp rate
# (FlashAttention-3 paper, H100 SXM5): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over their unit's rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
EXP_PER_S = 3.9e12

# kernel vs plain on bf16 outputs: both round p to bf16 before PV, but their
# exps and f32 sums differ in the last bits, so a p can land one bf16 ulp
# apart, and the output itself is rounded to bf16 (relative step 2^-8)
FLASH_ATOL, FLASH_RTOL = 2e-2, 2e-2
# main path with the kernel vs with the plain attention, as max|diff| over
# max|ref| of the bf16 logits and deltas: the attention outputs' one-ulp
# differences pass through the W conv, AdaIN, the FPN and the heads' five
# convs, each rounding to bf16 (relative step 2^-8)
MAIN_REL_TOL = 5e-2
MAIN_BATCH, MAIN_TIMED = 16, 5


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flash_bound(b: int, n: int, d: int):
    """(ms, 'bytes' | 'operations'): Q, K, V read once and O written once, bf16;
    4*B*N^2*d flops of the two products; B*N^2 exponentials."""
    t_bytes = 4 * b * n * d * 2 / HBM_BYTES_PER_S
    t_ops = max(4 * b * n * n * d / BF16_FLOP_PER_S, b * n * n / EXP_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)

    from frn_tpu_torch import build

    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {len(built)} kernel sources", flush=True)
    for name, (path, seconds, log) in built.items():
        print(f"  {name}: {seconds:.1f} s -> {path.name}", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)


def phase_flash_kernel():
    from frn_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul off, cudnn off", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, n, d):
        return [torch.randn((b, n, d), generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(3)]

    max_err = 0.0
    for b, n, d in ((2, 19200, 32), (2, 4800, 64), (2, 5655, 32), (2, 131, 32), (2, 517, 64)):
        q, k, v = qkv(b, n, d)
        out = fa.flash_attention(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        bad = err > FLASH_ATOL + FLASH_RTOL * ref.float().abs()
        print(f"flash_fwd vs plain B={b} N={n} d={d}: max_abs_err {err.max().item():.3e}, "
              f"{int(bad.sum())} outside atol {FLASH_ATOL} rtol {FLASH_RTOL}", flush=True)
        if not torch.isfinite(out.float()).all() or bad.any():
            fail(f"flash kernel disagrees with its plain version at B={b} N={n} d={d}")
        max_err = max(max_err, err.max().item())

    # per main-path forward at batch 16: two directions at each of stages 1, 2
    per_shape, totals = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    t_bytes = t_ops = 0.0
    for n, d in ((19200, 32), (4800, 64)):
        q, k, v = qkv(MAIN_BATCH, n, d)
        q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), reps=10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), reps=2, warmup=1)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, scale=1.0), reps=10)
        bound_ms, bound_by = flash_bound(MAIN_BATCH, n, d)
        t_bytes += 4 * MAIN_BATCH * n * d * 2 / HBM_BYTES_PER_S
        t_ops += max(4 * MAIN_BATCH * n * n * d / BF16_FLOP_PER_S, MAIN_BATCH * n * n / EXP_PER_S)
        row = {"B": MAIN_BATCH, "N": n, "d": d, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        per_shape.append(row)
        print(f"flash_fwd timing {json.dumps(row)}", flush=True)
        for key in totals:
            totals[key] += 2 * row[key]
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"flash_fwd per forward (4 launches): kernel {totals['ms']:.3f} ms, bound "
          f"{totals['bound_ms']:.3f} ms ({bound_by}), plain {totals['plain_ms']:.3f} ms, "
          f"sdpa {totals['library_ms']:.3f} ms", flush=True)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "frn_tpu_torch/csrc/flash_attention.cu",
            "replaces": "frn_tpu/ops/flash_attention.py:39",
            "launches": None, "max_abs_err": max_err, "bound_by": bound_by,
            **totals, "per_shape": per_shape}


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
    fa.flash_fwd_launches = 0
    times = []
    for _ in range(MAIN_TIMED):
        t0 = time.perf_counter()
        out = fn(rgb, event)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = fa.flash_fwd_launches
    peak = torch.cuda.max_memory_allocated()
    ms = sum(times) / len(times)
    print(f"main path: DSEC 480x640 fusion R50 bf16 batch {MAIN_BATCH}, forward + decode + NMS: "
          f"{ms:.2f} ms/batch (runs {', '.join(f'{t:.2f}' for t in times)}), "
          f"{MAIN_BATCH * 1e3 / ms:.1f} img/s, peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"main path launches: flash_fwd {launches} over {MAIN_TIMED} batches", flush=True)
    if launches != 4 * MAIN_TIMED:
        fail(f"flash_fwd launched {launches} times over {MAIN_TIMED} forwards, expected 4 each")
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

    # the same model with the plain attention in place of the kernel, batch 2
    with torch.inference_mode():
        got = fn.model(rgb[:2], event[:2], eval_output=fn.eval_output)
        kernel_fn = attention.flash_attention
        attention.flash_attention = fa.flash_attention_plain
        try:
            want = fn.model(rgb[:2], event[:2], eval_output=fn.eval_output)
        finally:
            attention.flash_attention = kernel_fn
    for name, g, w in zip(("logits", "deltas"), got, want):
        rel = ((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
        print(f"main path {name}, kernel vs plain attention: max|diff|/max|ref| = {rel:.3e}", flush=True)
        if not rel <= MAIN_REL_TOL:
            fail(f"main-path {name} disagree with the plain attention run ({rel:.3e})")
    return fn, rgb, event, ms


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


def phase_profile(fn, rgb, event, main_ms: float) -> None:
    """torch.profiler over one main-path batch (after one profiled warm-up
    batch): the device-busy time summed over kernels, the idle share of the
    unprofiled batch time ``main_ms``, and the costliest operators and
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []  # the active cycle's events, taken before the profiler clears them
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.extend(p.key_averages())) as prof:
            for _ in range(2):
                fn(rgb, event)
                torch.cuda.synchronize()
                prof.step()
    kernels, ops = [], []
    for ev in traced:
        ms = ev.self_device_time_total / 1e3
        if ms > 0 and not ev.key.startswith("ProfilerStep"):  # the step's own span is no kernel
            (kernels if ev.device_type == DeviceType.CUDA else ops).append((ms, ev.count, ev.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    idle = 1 - busy / main_ms if busy else float("nan")
    print(f"profile: one batch of {MAIN_BATCH}: {len(kernels)} kernels, device busy "
          f"{busy:.3f} ms; idle share of the unprofiled {main_ms:.3f} ms batch {idle:.3f}", flush=True)
    print("  operators by the device time of the kernels they launched:", flush=True)
    for ms, count, key in ops[:15]:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}", flush=True)
    print("  kernels:", flush=True)
    for ms, count, key in kernels[:12]:
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    phase_environment()
    rows = {"flash_fwd": phase_flash_kernel()}
    fn, rgb, event, main_ms = phase_main_path(rows)
    phase_breakdown(fn, rgb, event)
    phase_profile(fn, rgb, event, main_ms)
    phase_small_reference()
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
