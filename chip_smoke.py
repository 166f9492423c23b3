#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``depth_estimation_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build   — compiles the CUDA kernels under ``depth_estimation_tpu_torch/csrc/``
   (one ``nvcc`` per source, all started together) and gives ptxas's
   registers and spills for each kernel function;
3. kernel  — each kernel against its plain PyTorch version at the main
   paths' shapes: max abs error (asserted within the stated tolerance),
   kernel, plain and library device times (CUDA events, median of 25 runs of
   10 calls; for K1 also the library's kernel, as torch.profiler names it),
   and the bound (the larger of bytes over 3.35 TB/s and FLOPs
   over the peak rate of the route: K1 f32 runs 3xTF32 on the tensor cores,
   three TF32 products for each f32 one at 495 TFLOP/s, and its f32-FMA
   bound is kept beside it; otherwise the rate of the input type). K1 is
   checked in f32 and in bf16 at (1|4, 16, 769, 64) and (1, 16, 577, 64)
   and timed in both at (1, 16, 769, 64); K4 (grouped 3×3 conv) runs at the
   four MiDaS v2.1 conv2 shapes in f32 and bf16, timed in f32;
4. stream  — ``DepthEstimator("DPT_Large")`` (full width, random weights from
   seed 0, float32) under ``VidStream`` on ``synthetic:16x480x640`` into an
   .avi, per frame and with ``microbatch=4``, each after one untimed batch
   of its size (set-up); the kernels' launch counts are zeroed before and
   read after each run and asserted;
5. hold    — the same weights on a ``device="cpu"`` estimator (plain paths) on
   a 240×320 frame: max |gpu - cpu| / max |cpu| < 1e-3, the package's
   accuracy gate (BASELINE.md:23);
6. profile — one 480×640 frame program at a time: host-clock ms per program,
   then torch.profiler's device busy time per program, K1's device ms and
   calls per program, and the largest kernels;
7. bf16    — the opt-in bfloat16 mode on the same weights: finite, within 5%
   of the f32 map's range, its host-clock ms per frame and its K1 launches
   (asserted: 24 a frame, all on the bf16 route); then bf16_profile, phase 6
   for that bf16 estimator;
8. midas_stream, midas_hold, midas_profile, midas_bf16 — phases 4–7 for
   ``DepthEstimator("MiDaS")`` (v2.1 Large: ResNeXt-101 32x8d, full width),
   whose frame program launches K4 30 times and attention never (profiled
   at batch 1 and at the stream's microbatch of 4, where no kernel may be
   launched more than 2,000 times a program: cuDNN's heuristic once ran a
   head conv there as an FFT of 33,024 launches); its bf16
   bound is 0.1, the JAX package's own (tests/test_midas_v21.py).

Then the kernel table as one JSON line (each kernel's launches on its own
path's per-frame stream), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA GPU it exits 1 before any
phase. It imports nothing of JAX or of the JAX package.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 FMA units; bf16 dense tensor cores
PEAK_TF32 = 495e12  # dense TF32 tensor cores
FRAMES = 16
MICROBATCH = 4
SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's boost clock


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps=25, inner=10):
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls. A spin kernel queued ahead of the start event lets the host
    enqueue all the calls first, so the host's launch cost is not timed
    (except where a call itself waits for the device)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes, flops, peak=PEAK_FLOPS[torch.float32]):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(gen, b, h, n, dtype, atol, rtol, timed):
    from depth_estimation_tpu_torch.ops.kernels.attention import attention_plain, multi_head_attention

    d = 64
    # strided q, k, v views of one fused projection, as the ViT produces them
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(dtype).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    got, ref = multi_head_attention(q, k, v), attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol),
          f"attention {dtype} {(b, h, n, d)}: max abs err {err} over atol {atol} rtol {rtol}")
    row = {"shape": [b, h, n, d], "dtype": str(dtype), "max_abs_err": err, "atol": atol, "rtol": rtol}
    if timed:
        nbytes, flops = 4 * b * h * n * d * (torch.finfo(dtype).bits // 8), 4 * b * h * n * n * d
        if dtype == torch.float32:  # three TF32 products for each f32 one
            bnd, by = bound_ms(nbytes, 3 * flops, PEAK_TF32)
            row.update(bound_peak="3xTF32 tensor cores, 495 TFLOP/s",
                       fma_bound_ms=bound_ms(nbytes, flops, PEAK_FLOPS[dtype])[0])
        else:
            bnd, by = bound_ms(nbytes, flops, PEAK_FLOPS[dtype])
            row.update(bound_peak="bf16 tensor cores, 989 TFLOP/s")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            F.scaled_dot_product_attention(q, k, v)
            torch.cuda.synchronize()
        row.update(ms=time_ms(lambda: multi_head_attention(q, k, v)),
                   plain_ms=time_ms(lambda: attention_plain(q, k, v)),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   library_kernel=max(prof.key_averages(), key=lambda e: e.self_device_time_total).key[:120],
                   bound_ms=bnd, bound_by=by)
    emit("kernel", name="attention", **row)
    return row


def check_preprocess(frames, net_hw, cfg, timed):
    from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess, preprocess_plain

    got = fused_preprocess(frames, net_hw, cfg.mean, cfg.std)
    ref = preprocess_plain(frames, net_hw, cfg.mean, cfg.std)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(got.shape == ref.shape and err <= 3e-5, f"preprocess: max abs err {err} over 3e-5")
    row = {"in": list(frames.shape), "out": list(got.shape), "max_abs_err": err, "atol": 3e-5}
    if timed:
        h_out, w_out = net_hw
        nbytes = frames.numel() + got.numel() * 4 + (h_out + w_out) * 4 * 8  # frame, output, tap tables
        bnd, by = bound_ms(nbytes, got.numel() * (2 * 16 + 2))
        row.update(ms=time_ms(lambda: fused_preprocess(frames, net_hw, cfg.mean, cfg.std)),
                   plain_ms=time_ms(lambda: preprocess_plain(frames, net_hw, cfg.mean, cfg.std)),
                   library_ms=None, bound_ms=bnd, bound_by=by)
    emit("kernel", name="preprocess", **row)
    return row


def check_resize(gen, in_hw, out_hw):
    from depth_estimation_tpu_torch.ops.kernels.resize import resize_planes, resize_planes_plain

    x = torch.rand((1, *in_hw), generator=gen, device="cuda")
    got, ref = resize_planes(x, out_hw), resize_planes_plain(x, out_hw)
    lib = lambda: F.interpolate(x[None], size=out_hw, mode="bicubic", align_corners=False)  # noqa: E731
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= 3e-5, f"resize: max abs err {err} over 3e-5")
    bnd, by = bound_ms(x.numel() * 4 + got.numel() * 4 + sum(out_hw) * 4 * 8, got.numel() * 2 * 16)
    row = {"in": list(x.shape), "out": list(got.shape), "max_abs_err": err, "atol": 3e-5,
           "library_max_abs_diff": (lib()[0] - ref).abs().max().item(),
           "ms": time_ms(lambda: resize_planes(x, out_hw)),
           "plain_ms": time_ms(lambda: resize_planes_plain(x, out_hw)),
           "library_ms": time_ms(lib), "bound_ms": bnd, "bound_by": by}
    emit("kernel", name="resize", **row)
    return row


MIDAS_CONV2_SHAPES = {"layer1": (256, 48, 64), "layer2": (512, 24, 32), "layer3": (1024, 12, 16),
                      "layer4": (2048, 6, 8)}  # (C, H, W) at a 192×256 network input, G = 32


def check_grouped_conv(gen, layer, dtype, tol, timed, groups=32):
    from depth_estimation_tpu_torch.ops.kernels.grouped_conv import grouped_conv3x3, grouped_conv3x3_plain

    c, h, w = MIDAS_CONV2_SHAPES[layer]
    cg = c // groups
    x = torch.randn((1, c, h, w), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((c, cg, 3, 3), generator=gen, device="cuda") / math.sqrt(9 * cg)).to(dtype)
    got, ref = grouped_conv3x3(x, k, groups), grouped_conv3x3_plain(x, k, groups)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol),
          f"grouped conv {layer} {dtype}: max abs err {err} over atol {tol} rtol {tol}")
    lib = lambda: F.conv2d(x, k, padding=1, groups=groups)  # noqa: E731
    row = {"layer": layer, "shape": [1, c, h, w], "groups": groups, "dtype": str(dtype), "max_abs_err": err,
           "atol": tol, "rtol": tol, "library_max_abs_diff": (lib().float() - ref.float()).abs().max().item()}
    if timed:
        elem = torch.finfo(dtype).bits // 8
        bnd, by = bound_ms((2 * x.numel() + k.numel()) * elem, 2 * h * w * c * cg * 9, PEAK_FLOPS[dtype])
        row.update(ms=time_ms(lambda: grouped_conv3x3(x, k, groups)),
                   plain_ms=time_ms(lambda: grouped_conv3x3_plain(x, k, groups)),
                   library_ms=time_ms(lib),
                   bound_ms=bnd, bound_by=by)
    emit("kernel", name="grouped_conv3x3", **row)
    return row


def run_stream(est, out_path, microbatch, per_program, phase="stream", **extra):
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.stream import VidStream

    vs = VidStream(est, f"synthetic:{FRAMES}x480x640", out_path, verbose=False, microbatch=microbatch)
    est.predict_batch(np.zeros((microbatch, 480, 640, 3), np.uint8))  # set-up (cuDNN plans) for this batch
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    vs.update()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    programs = math.ceil(FRAMES / microbatch)
    want = {name: n * programs for name, n in per_program.items()}
    check(counts == want, f"{phase}: launch counts {counts} != {want} (microbatch={microbatch})")
    check(os.path.getsize(out_path) > 0, f"{out_path} is empty")
    s = vs.timer.summary()["depth"]
    check(s["frames"] == FRAMES, f"stream wrote {s['frames']} frames, expected {FRAMES}")
    emit(phase, model=est.model_type, microbatch=microbatch, frames=FRAMES, p50_ms=s["p50_ms"], p90_ms=s["p90_ms"],
         fps_completion=s["fps_completion"], ms_per_frame=1e3 / s["fps_completion"],
         wall_fps=FRAMES / wall, launches=counts,
         avi_bytes=os.path.getsize(out_path), **extra)
    return counts, s["fps_completion"]


K1_KERNELS = ("attention_f32_kernel", "attention_bf16_kernel")


def profile_frames(est, frame, phase="profile", batch=1, n=8, max_calls=None):
    """Frame programs of ``batch`` copies of ``frame``, one at a time: host-clock
    ms per program, then torch.profiler's device busy time, K1's share and the
    largest kernels. With ``max_calls``, fails if any kernel entry is launched
    more often than that in one program."""
    imgs = np.stack([frame] * batch)
    program = est._batched_fn(frame.shape[:2], "u8")
    for _ in range(2):
        program(imgs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        program(imgs)
    torch.cuda.synchronize()
    program_ms = (time.perf_counter() - t0) / n * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            program(imgs)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / n / 1e3
    k1 = [r for r in rows if any(name in r[0] for name in K1_KERNELS)]
    most = max(rows, key=lambda r: r[2])
    if max_calls is not None:
        check(most[2] / n <= max_calls,
              f"{phase}: {most[0][:100]} launched {most[2] / n} times a program, over {max_calls}")
    emit(phase, model=est.model_type, dtype=str(est.dtype), src_hw=list(frame.shape[:2]), batch=batch,
         program_ms=program_ms, frame_ms=program_ms / batch, device_busy_ms_per_program=busy_ms,
         device_idle_share=max(0.0, 1 - busy_ms / program_ms),
         k1_ms_per_program=sum(r[1] for r in k1) / n / 1e3, k1_calls_per_program=sum(r[2] for r in k1) / n,
         most_calls={"kernel": most[0][:100], "calls_per_program": most[2] / n},
         top=[{"kernel": k[:100], "ms_per_program": t / n / 1e3, "calls_per_program": c / n}
              for k, t, c in rows[:10]])


def hold(est, net_cfg, phase="hold"):
    """The same weights through the plain paths on the CPU, on a 240×320 frame."""
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
    from depth_estimation_tpu_torch.runtime.video import SyntheticSource

    _, frame = SyntheticSource(1, 240, 320).read()
    gpu = est.predict(frame)
    cpu_est = DepthEstimator(est.model_type, params={k: v.cpu() for k, v in est.model.state_dict().items()},
                             device="cpu", verbose=False)
    t0 = time.perf_counter()
    cpu = cpu_est.predict(frame)
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(cpu).max())
    rel = float(np.abs(gpu - cpu).max()) / scale
    check(gpu.shape == cpu.shape == (240, 320), f"{phase}: depth shapes {gpu.shape} {cpu.shape}")
    check(np.isfinite(gpu).all() and scale > 0, f"{phase}: depth map not finite or all zero")
    check(rel < 1e-3, f"{phase}: gpu vs cpu max abs-rel {rel} >= 1e-3")
    emit(phase, model=est.model_type, src_hw=[240, 320], net_hw=list(compute_resize_shape(240, 320, net_cfg)),
         max_abs_rel=rel, depth_max=scale, nonzero_share=float((cpu != 0).mean()), cpu_seconds=cpu_s)


def bf16_mode(est, frame, bound, per_program, phase="bf16"):
    """The opt-in bfloat16 mode, no parity gate: finite and within ``bound``
    of the f32 map's range; host-clock ms per frame, over which the kernels'
    launches must be ``per_program`` a frame. Returns the bf16 estimator."""
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops import kernels

    est16 = DepthEstimator(est.model_type, params=est.model.state_dict(), dtype="bfloat16", verbose=False)
    d32, d16 = est.predict(frame), est16.predict(frame)
    rel16 = float(np.abs(d32 - d16).max() / np.abs(d32).max())
    check(np.isfinite(d16).all() and rel16 < bound, f"{phase}: bf16 vs f32 max abs-rel {rel16} over {bound}")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(8):
        est16.predict_device_u8(frame)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / 8 * 1e3
    counts = kernels.launch_counts()
    want = {name: 8 * n for name, n in per_program.items()}
    check(counts == want, f"{phase}: launch counts {counts} != {want}")
    emit(phase, model=est.model_type, src_hw=list(frame.shape[:2]), max_abs_rel_vs_f32=rel16, frame_ms=frame_ms,
         launches=counts)
    return est16


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    from depth_estimation_tpu_torch.config import DPT_PREPROCESS, SMALL_PREPROCESS
    from depth_estimation_tpu_torch.device import full_f32
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops.kernels import build
    from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
    from depth_estimation_tpu_torch.runtime.video import SyntheticSource

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda, kind=kind,
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {}  # kernel function (mangled) -> ptxas's stack, spill and register lines
    for log in logs.values():
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                fn = ptxas.setdefault(ln.split("'")[1], [])
            elif "registers" in ln or "spill" in ln:
                fn.append(ln.replace("ptxas info    :", "").strip())
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    gen = torch.Generator(device="cuda").manual_seed(0)
    net_hw = compute_resize_shape(480, 640, DPT_PREPROCESS)
    check(net_hw == (384, 512), f"network input {net_hw}")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (MICROBATCH, 480, 640, 3), np.uint8)).cuda()
    with full_f32():
        att = check_attention(gen, 1, 16, 769, torch.float32, 2e-5, 1e-4, timed=True)
        check_attention(gen, 1, 16, 577, torch.float32, 2e-5, 1e-4, timed=False)
        check_attention(gen, MICROBATCH, 16, 769, torch.float32, 2e-5, 1e-4, timed=False)
        # bf16: the kernel rounds the unnormalised probabilities to bf16, the plain version the normalised ones
        att16 = check_attention(gen, 1, 16, 769, torch.bfloat16, 1e-2, 1e-2, timed=True)
        check_attention(gen, 1, 16, 577, torch.bfloat16, 1e-2, 1e-2, timed=False)
        check_attention(gen, MICROBATCH, 16, 769, torch.bfloat16, 1e-2, 1e-2, timed=False)
        pre = check_preprocess(frames[:1], net_hw, DPT_PREPROCESS, timed=True)
        check_preprocess(frames, net_hw, DPT_PREPROCESS, timed=False)
        rsz = check_resize(gen, net_hw, (480, 640))
        # K4 is timed at every conv2 shape; the table's row is layer 3, with 22 of its 30 launches a frame
        gconv = {layer: check_grouped_conv(gen, layer, torch.float32, 1e-4, timed=True)
                 for layer in MIDAS_CONV2_SHAPES}
        for layer in MIDAS_CONV2_SHAPES:
            check_grouped_conv(gen, layer, torch.bfloat16, 1e-2, timed=False)

    est = DepthEstimator("DPT_Large", seed=0, device="cuda")
    dpt_per_program = {"multi_head_attention": 24, "fused_preprocess": 1, "resize_planes": 1, "grouped_conv3x3": 0}
    with tempfile.TemporaryDirectory() as tmp:
        launches, fps = run_stream(est, os.path.join(tmp, "depth.avi"), 1, dpt_per_program)
        run_stream(est, os.path.join(tmp, "depth_mb.avi"), MICROBATCH, dpt_per_program, per_frame_fps=fps)
    hold(est, DPT_PREPROCESS)
    frame = SyntheticSource(1, 480, 640).read()[1]
    profile_frames(est, frame)
    profile_frames(bf16_mode(est, frame, 0.05, dpt_per_program), frame, "bf16_profile")

    midas = DepthEstimator("MiDaS", seed=0, device="cuda")
    check(compute_resize_shape(480, 640, SMALL_PREPROCESS) == (192, 256), "MiDaS network input")
    midas_per_program = {"multi_head_attention": 0, "fused_preprocess": 1, "resize_planes": 1,
                         "grouped_conv3x3": 30}
    with tempfile.TemporaryDirectory() as tmp:
        midas_launches, fps = run_stream(midas, os.path.join(tmp, "midas.avi"), 1, midas_per_program,
                                         "midas_stream")
        run_stream(midas, os.path.join(tmp, "midas_mb.avi"), MICROBATCH, midas_per_program, "midas_stream",
                   per_frame_fps=fps)
    hold(midas, SMALL_PREPROCESS, "midas_hold")
    profile_frames(midas, frame, "midas_profile")
    profile_frames(midas, frame, "midas_profile", batch=MICROBATCH, max_calls=2000)
    bf16_mode(midas, frame, 0.1, midas_per_program, "midas_bf16")

    def entry(name, source, replaces, row, path_launches, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": path_launches[name], **{k: row[k] for k in keys}, **extra}

    print(json.dumps({"kernels": [
        entry("multi_head_attention", "depth_estimation_tpu_torch/csrc/attention.cu",
              "depth_estimation_tpu/ops/pallas/attention.py:34", att, launches,
              bound_peak=att["bound_peak"], fma_bound_ms=att["fma_bound_ms"], bf16_ms=att16["ms"],
              library_kernel=att["library_kernel"], bf16_plain_ms=att16["plain_ms"],
              bf16_library_ms=att16["library_ms"], bf16_library_kernel=att16["library_kernel"],
              bf16_bound_ms=att16["bound_ms"], bf16_max_abs_err=att16["max_abs_err"]),
        entry("fused_preprocess", "depth_estimation_tpu_torch/csrc/resize.cu",
              "depth_estimation_tpu/ops/pallas/resize.py:44", pre, launches),
        entry("resize_planes", "depth_estimation_tpu_torch/csrc/resize.cu",
              "depth_estimation_tpu/ops/pallas/resize.py:102", rsz, launches),
        entry("grouped_conv3x3", "depth_estimation_tpu_torch/csrc/grouped_conv.cu",
              "depth_estimation_tpu/ops/pallas/grouped_conv.py:105", gconv["layer3"], midas_launches),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
