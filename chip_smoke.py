#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``depth_estimation_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device  — the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build   — compiles the CUDA kernels under ``depth_estimation_tpu_torch/csrc/``
   (one ``nvcc`` per source, all started together) and gives ptxas's
   registers and spills for each kernel function, then the C++ framepipe
   (``native/framepipe.cpp``, ``g++``) and its seconds;
3. kernel  — each kernel against its plain PyTorch version at the main
   paths' shapes: max abs error (asserted within the stated tolerance),
   kernel, plain and library device times (CUDA events, median of 25 runs of
   10 calls; for K1 also the library's kernel, as torch.profiler names it),
   and the bound (the larger of bytes over 3.35 TB/s and FLOPs
   over the peak rate of the route: K1 f32 runs 3xTF32 on the tensor cores,
   three TF32 products for each f32 one at 495 TFLOP/s, and its f32-FMA
   bound is kept beside it; otherwise the rate of the input type). K1 is
   checked in f32 and in bf16 at (1|4, 16, 769, 64) and (1, 16, 577, 64)
   and timed in both at (1, 16, 769, 64), checked in f32 at the servers'
   (8, 16, 769, 64), and at DPT_Hybrid's 12 heads,
   (1|4, 12, 769, 64), checked in both and timed in f32; K4 (grouped 3×3 conv) is checked
   and timed at the four MiDaS v2.1 conv2 shapes in f32 (3xTF32 on the tensor
   cores: bound at 495 / 3 TFLOP/s, the f32-FMA bound beside it) and in bf16
   (bf16 mma on the tensor cores; bound at the bf16 rate), each with its
   tiling printed, at batch 1, and checked in both at batch 4, the microbatch;
   K2 (preprocess) and K3 (resize) are checked and timed at both families'
   shapes (480×640 u8 → 384×512 or 192×256, and back to 480×640), and K2's
   linear route at the detectors' inputs (→ 128×128 and → 224×224, mean =
   std = 0.5, and → 256×256, mean 0, std 1; atol 1e-5), each with
   its tiling printed, at batch 1, and checked at batch 4 (K2 cubic and K3
   on DPT_Large's shapes also at the servers' batch of 8); K3 also on its u8
   route (the stream's wrap-around cast fused in) against ``wraparound_u8``
   of the plain version, bytes differing only where the f32 map lies within
   1e-3 of an integer, timed beside K3 f32 followed by ``wraparound_u8``;
4. stream  — ``DepthEstimator("DPT_Large")`` (full width, random weights from
   seed 0, float32) under ``VidStream`` on ``synthetic:16x480x640`` into an
   .avi, per frame and with ``microbatch=4``, each after one untimed batch
   of its size (set-up); the kernels' launch counts are zeroed before and
   read after each run and asserted (launches a program: K1 24, K2 1, K3 1, K4 0);
5. hold    — the same weights on a ``device="cpu"`` estimator (plain paths) on
   a 240×320 frame: max |gpu - cpu| / max |cpu| < 1e-3, the package's
   accuracy gate (BASELINE.md:23);
6. profile — one 480×640 u8 frame program at a time: host-clock ms per
   program, then torch.profiler's device busy time, device kernels, K1's and
   K4's device ms and calls per program, and the largest kernels;
7. bf16    — the opt-in bfloat16 mode on the same weights: finite, within 5%
   of the f32 map's range, its host-clock ms per frame and its K1 launches
   (asserted: 24 a frame, and in a profiled frame all on the bf16 route); then
   bf16_profile, phase 6 for that bf16 estimator;
8. midas_stream, midas_hold, midas_profile, midas_bf16, midas_bf16_profile
   — phases 4–7 for ``DepthEstimator("MiDaS")`` (v2.1 Large: ResNeXt-101
   32x8d, full width), whose frame program launches K4 30 times and
   attention never (profiled at batch 1 and at the stream's microbatch of 4,
   where no kernel may be launched more than 2,000 times a program: cuDNN's
   heuristic once ran a head conv there as an FFT of 33,024 launches); its
   bf16 bound is 0.1, the JAX package's own (tests/test_midas_v21.py), and
   midas_bf16_profile gives the bf16 frame's busy time, idle share and K4 sum;
9. small_stream, small_hold, small_profile, small_bf16 — phases 4–7 for
   ``DepthEstimator("MiDaS_small")`` (EfficientNet-Lite3, full width; 192×256
   network input): K1 0, K2 1, K3 1, K4 0 launches a program; profiled at
   batch 1 under the 2,000-launch cap (cuDNN's depthwise convs are new
   here); bf16 bound 0.1;
10. hybrid_stream, hybrid_hold, hybrid_profile, hybrid_bf16 — the same for
   ``DepthEstimator("DPT_Hybrid")`` (ResNetV2-50 stem + ViT-B/16, full
   width; 384×512): K1 12, K2 1, K3 1, K4 0 a program. Its bf16 bound is
   0.3: on random weights the stem's 16 GroupNorm bottlenecks amplify bf16
   rounding block by block (the whole bf16 map lies about 0.2 of the f32
   map's range from it). So hybrid_bf16_tail also runs the bf16 ViT-B and
   decoder on the f32 stem's features, which must land within 0.05.
11. fused_stream, fused_hold, fused_profile — the fused iris/pose + depth
   path (``runtime/fused.py``, ``FusedVidStream``) on the DPT_Large of phase
   4 with ``PersonDetector``'s random nets from seed 0, BlazeFace's heads
   rescaled so that it detects (``detector_weights``): the stream as in
   phase 4 (launches a program: K1 24, K2 3, K3 1, K4 0, plus a K2 for each
   staged ``findBody``; the frames of the iris and the body route printed);
   the hold on a hit and a miss at 240×320 against the plain paths on the
   CPU (depth 1e-3, scores 1e-4, and where the top two kept scores lie 1e-4
   apart or more, boxes 1e-4, the mesh by the ±1 rule, circles, pose); the
   profile at batch 1 and 4, with each branch's device time alone.
12. staged_stream — the staged loop (``FusedVidStream(fused=False)``,
   ``--no-fused``) on the same DPT_Large, 8 frames: launches a frame K1 24,
   K2 2 (depth, BlazeFace), K3 1, plus a K2 for each staged ``findBody``
   (the body route); FPS and routes.
13. detection_stream, detection_hold, detection_depth, detection_profile —
   the detection-only path (``depth_by_detection``, ``FaceDetector``,
   ``FusedDetectionRunner``) with ``detector_weights(seed=0)``: the port's
   ``_loop`` over ``synthetic:16x480x640`` (K2 2 a program, K1 = K3 = K4 =
   0, plus a K2 for each staged ``findBody``; the frames of each tier); the
   program against the CPU plain path on a hit and a miss (scores, boxes
   1e-4, mesh by the ±1 rule and from the BGR feed, pose max abs-rel 1e-4);
   tier 2 with ``--with-depth MiDaS_small`` on a hit (K2 3, K3 1; the ROI
   medians on the card equal to the CPU's on the same map, the map within
   1e-3 of the CPU plain path's); one program's profile. Each prints its
   seconds. Then tflite — the ``.tflite`` route (``tools/tflite_rehearsal``)
   under a temporary weight cache: the five MediaPipe files written at full
   size from ``detector_weights(seed=0)`` (its BlazePoseDetector's heads
   rescaled as BlazeFace's), imported by ``import_weights --tflite`` and
   again (a cache hit), each import's seconds; ``PersonDetector()`` and
   ``FaceDetector()`` on the card, given no params, hold the written state
   dicts bitwise; on them the fused program (the DPT_Large of phase 4; K1
   24, K2 3, K3 1) and the detection program (K2 2) are bitwise equal to
   the same programs given the state dicts; the pose detector stage (K2
   linear → 224², one launch) against the CPU plain path (scores 1e-4,
   boxes 1e-4 by the top-two rule).
14. server, server_hold, bucketed_server, fused_server, multistream,
   serve_cli — the serving surface on the DPT_Large of phase 4 (and
   ``detector_weights(seed=0)``): ``DepthServer`` (480×640, max_batch 8,
   warmed, 4 client threads × 8 requests; each result equal to the frame
   program on a batch of 8, or by the u8 rule; launches a dispatch K1 24,
   K2 1, K3 1; requests/s, p50/p90 submit→result; server_profile, phase 6
   at its batch of 8); its f32 output at
   240×320 against the CPU plain path (1e-3); ``BucketedDepthServer`` with
   480×640 and 240×320 clients at once, two dispatcher threads running
   programs together (results as in ``server``, stats a bucket, a third
   size refused); ``FusedDepthServer`` (max_batch 4, 12 requests; each dict
   equal to ``FusedFrameRunner(emit_depth_map=False).batched``; K1 24, K2 3,
   K3 1 a dispatch); ``MultiStream`` over three 8-frame 480×640 streams and
   a 5-frame 240×320 one at microbatch 1 and 2 (frames equal to a direct
   reference loop; launches a bucket's dispatch); ``tools.serve.main`` with
   DPT_Large, MultiStream mode and ``--online``, its printed lines. Each
   prints its seconds.

15. kernel_grad, train_hold, midas_train_hold, train, evaluate — training,
   evaluation and checkpoints: K1 (f32, (2,16,577,64), 2e-5 + 1e-4 rel), K3
   (288×384 → 240×320, batch 2, 3e-5) and K4 (f32, the four MiDaS conv2
   shapes, 1e-4) autograd Functions against autograd of the plain versions,
   the backward's ms beside the forward's; one ``make_train_step`` step of
   DPT_Large (batch 2 at 240×320, a 288×384 network; K1 24, K2 1, K3 1) and
   of MiDaS v2.1 (batch 1 at 192×256; K4 30 forward + 30 dX) on the card
   against the CPU's plain path on the same weights (loss 1e-3 abs-rel, the
   gradient 1e-3 max-scaled over all trainable tensors) and each tensor
   against the float64 gradient (4e-3 and 2.5e-2 of its own largest value);
   ``fit`` of DPT_Large with its head kept alive (batch 2, 8 steps; a
   checkpoint at step 4 restored bit for bit, a run resumed from it within
   1e-4 of the in-memory continuation over two steps and 1e-3 over four,
   one resumed with zeroed moments not), ms per step, images/s and
   peak memory; the evaluate CLI on the card against ``--device cpu`` on a
   cache filled by ``import_weights`` (MiDaS_small, 8 synthetic 192×256
   pairs, 1e-4).

16. export, export_cli — the export surface (``utils/export.py``) after the
   MiDaS phases, f32 at full width: DPT_Large at 480×640 (one frame, and
   B = 4), MiDaS v2.1 and the fused iris/pose + DPT_Large program exported
   with ``torch.export``, saved as ``.pt2`` and loaded from disk; the loaded
   programs against the live ones (max-scaled 1e-6, bitwise said; the fused
   program's ints and ``valid`` equal), DPT_Large also against the CPU plain
   path (1e-3) and on a second seed's weights; launches inside one loaded
   call as the live program's (K1 24, K2 1, K3 1 a DPT_Large call at either
   batch; K4 30 a MiDaS call; K1 24, K2 3, K3 1 a fused call); a fresh
   process that imports only torch and the operators loads and runs the
   DPT_Large artifact without the models; export seconds, archive and
   weight bytes, loaded and live host ms. Then ``tools.export_program`` for
   MiDaS_small, its line and its file against a live estimator.

17. parallel, parallel_tp — the parallel surface (``parallel/``): a world of
   one over NCCL (``init_process_group`` through a FileStore), ``make_mesh(1)``,
   at full width: DPT_Large ``predict_batch_sharded`` at the servers' batch
   of 8 frames of 480×640 and ``predict_sharded`` at 480×640 (each against
   ``predict_batch`` / ``predict``, max-scaled 1e-5; K1 24, K2 1, K3 1),
   ``dpt_apply_pipelined`` with pp=1 and 2 microbatches on a batch of 2
   384×512 network inputs (against the model's forward, 1e-4; K1 48), MiDaS
   v2.1 ``predict_batch_sharded`` at batch 4 (1e-5; K4 30, K2 1, K3 1) and
   ``fit(mesh=)`` of DPT_Large at batch 2, 240×320: one step with a
   checkpoint, then a resume to step 2 (K1 48, K2 2, K3 2), its two losses
   within 1e-4 relative of a ``fit`` without a mesh. Then tensor parallelism
   one rank at a time: one full-width DPT_Large block (C=1024, 16 heads,
   577 tokens, batch 1, f32) cut by ``shard_params`` for tp ∈ {2, 4}; each
   rank's shard runs its attention (K1 at 16/tp heads) and MLP with no group
   and its row-parallel biases zeroed, the script sums the partial outputs
   and adds the biases, and the sum is held against the whole block
   (max-scaled 2e-5); K1 checked and timed at (1, 8, 577, 64) and (1, 4,
   577, 64). Each path prints its max-scaled error and launches.

18. parallel_sp — sequence parallelism and spatial partitioning at full
   width. (a) A world of one over NCCL: ``predict_spatial`` of MiDaS v2.1,
   MiDaS_small, DPT_Large and DPT_Hybrid on a 480×640 frame against
   ``predict`` (the 1e-3 gate; K2 1, K3 1, K4 30 / 0 / 0 / 0, K1 0 / 0 /
   24 / 12: the DPT trunks sequence-parallel over the axis's group of one,
   the hybrid's GroupNorm statistics all-reduced), and DPT_Large's frame with its trunk
   ``sequence_parallel`` over an sp axis of one (the token scatter, K/V and
   hook gathers over NCCL) against ``predict`` (1e-5; K1 24, K2 1, K3 1).
   (b) One rank at a time, the exchanges done by slicing the whole tensor
   and the compute half on the card: DPT_Large's first block at 384×512
   (769 tokens, f32) cut for sp 2 and 4, each rank's ``Block.forward`` on
   its 385 / 193 (… 192) tokens with K/V of all 769 (K1 at (1, 16, 385, 64)
   × 769 and (1, 16, 193, 64) × 769, each launch held against its plain
   version at 2e-5), the concatenation against the whole block (max-scaled
   2e-5); MiDaS v2.1's frame program at 480×640 cut into 2 and 4 row slabs
   (``parallel.spatial.RowWorld.local``): each slab through K2's row window,
   the network with K4 on halo'd slabs, and K3's row window, the assembled
   map against ``predict`` (the 1e-3 gate; K2 n, K3 n, K4 30·n), and the
   same for DPT_Large's and DPT_Hybrid's frame programs (their patch, stem
   and decoder rows in slabs, the trunk whole: K1 24 / 12, K2 n, K3 n). Then K1
   checked and timed at the two sp shapes in f32 (3xTF32 bound) and bf16
   beside SDPA, and K2's and K3's window launches of a rank of 2 and of 4
   checked against their plain versions and the whole-frame launch sliced,
   and timed.

19. native — the C++ framepipe (``runtime/native.py``), after the
   DPT_Large profiles: built in phase 2 (this phase fails if it did not
   build or load; it prints whether it built with OpenCV and, if not,
   ``native_load_error()``), its synthetic
   source byte-equal to Python's over 200 frames at 480×640, and the
   DPT_Large stream of 16 frames on it (no Python prefetch thread,
   ``needs_prefetch`` False) writing the same u8 frames as on the Python
   source (K1 24, K2 1, K3 1 a frame each); both streams' FPS, with no
   claim.

Then the kernel table as one JSON line (each kernel's launches on its own
path's per-frame stream, and under ``per_path`` on each family's and the
fused, detection, tflite, staged, server, fused_server, multistream,
native_stream, train (8 steps of ``fit``) and midas_train_step paths', the loaded programs'
(``export_*``) and the parallel paths' (``parallel_*``), the backward under
``grad``, K1 at its tp shapes under ``tp_heads`` and at its sp shapes
under ``sp_shapes``, K2's and K3's window launches under ``windows``; K2's
and K3's for each network input under ``per_shape``, with K2's linear
route's shapes),
the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Without a CUDA GPU it exits 1 before any
phase. It imports nothing of JAX or of the JAX package. Every phase runs on
an empty temporary weight cache (``DEPTH_ESTIMATION_TPU_TORCH_CACHE``), so
that weights cached on the machine cannot change the random-weight phases.
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


PROFILE_MARGIN_S = 0.1


def cuda_events(fn, n=1):
    """torch.profiler's device rows (``key_averages()``) for ``n`` calls of
    ``fn`` and a sync. The profiler keeps only device activity whose
    timestamps, mapped from the device's clock to the host's, fall inside its
    capture window, so a kernel run at the window's opening could be dropped
    (one H100 run counted 16 of a bf16 frame's 24 K1 kernels). The calls are
    therefore made ``PROFILE_MARGIN_S`` after the window opens, on an idle
    device, and the window closes as long after their sync."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    return prof.key_averages()


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def bound_ms(nbytes, flops, peak=PEAK_FLOPS[torch.float32]):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_attention(gen, b, h, n, dtype, atol, rtol, timed, nk=None):
    """K1 at (b, h, n, 64); with ``nk``, n queries against nk keys, as a
    sequence-parallel rank runs it: q a view of its local fused projection,
    k and v views of the gathered K/V."""
    from depth_estimation_tpu_torch.ops.kernels.attention import attention_plain, multi_head_attention

    d = 64
    # strided q, k, v views of one fused projection, as the ViT produces them
    qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(dtype).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    if nk is not None:
        kv = torch.randn((b, nk, 2, h, d), generator=gen, device="cuda").to(dtype).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
    keys = k.shape[2]
    got, ref = multi_head_attention(q, k, v), attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(torch.allclose(got.float(), ref.float(), atol=atol, rtol=rtol),
          f"attention {dtype} {(b, h, n, d)} x {keys} keys: max abs err {err} over atol {atol} rtol {rtol}")
    row = {"shape": [b, h, n, d], "keys": keys, "dtype": str(dtype), "max_abs_err": err, "atol": atol, "rtol": rtol}
    if timed:
        nbytes, flops = 2 * b * h * (n + keys) * d * (torch.finfo(dtype).bits // 8), 4 * b * h * n * keys * d
        if dtype == torch.float32:  # three TF32 products for each f32 one
            bnd, by = bound_ms(nbytes, 3 * flops, PEAK_TF32)
            row.update(bound_peak="3xTF32 tensor cores, 495 TFLOP/s",
                       fma_bound_ms=bound_ms(nbytes, flops, PEAK_FLOPS[dtype])[0])
        else:
            bnd, by = bound_ms(nbytes, flops, PEAK_FLOPS[dtype])
            row.update(bound_peak="bf16 tensor cores, 989 TFLOP/s")
        events = cuda_events(lambda: F.scaled_dot_product_attention(q, k, v))
        row.update(ms=time_ms(lambda: multi_head_attention(q, k, v)),
                   plain_ms=time_ms(lambda: attention_plain(q, k, v)),
                   library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   library_kernel=max(events, key=lambda e: e.self_device_time_total).key[:120],
                   bound_ms=bnd, bound_by=by)
    emit("kernel", name="attention", **row)
    return row


def check_preprocess(frames, net_hw, cfg, timed, method="cubic"):
    """K2 against its plain version at ``atol`` 3e-5 (cubic) or 1e-5 (the
    linear route); its bound counts the route's taps: a 2-D cubic output
    value is 16 multiply-adds of the frame, a linear one 4. Its bytes are
    the frame pixels that some tap reaches (distinct rows × distinct columns
    with a nonzero weight × 3): a linear downscale reads only part of the
    frame (480×640 → 128² reaches 256 rows and 128 columns)."""
    from depth_estimation_tpu_torch.ops.kernels.resize import band_taps, fused_preprocess, preprocess_plain, tiling

    atol, taps = (3e-5, 16) if method == "cubic" else (1e-5, 4)
    got = fused_preprocess(frames, net_hw, cfg.mean, cfg.std, method=method)
    ref = preprocess_plain(frames, net_hw, cfg.mean, cfg.std, method=method)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(got.shape == ref.shape and err <= atol,
          f"preprocess {method} {tuple(got.shape)}: max abs err {err} over {atol}")
    row = {"in": list(frames.shape), "out": list(got.shape), "method": method, "max_abs_err": err, "atol": atol,
           "tiling": tiling(tuple(frames.shape[1:3]), tuple(net_hw), frames.shape[0], sm_count(), "preprocess",
                            method)}
    if timed:
        h_out, w_out = net_hw
        reached = [len(np.unique(idx[wts != 0])) for idx, wts in
                   (band_taps(n_in, n_out, method) for n_in, n_out in zip(frames.shape[1:3], net_hw))]
        frame_bytes = frames.shape[0] * reached[0] * reached[1] * frames.shape[3]
        nbytes = frame_bytes + got.numel() * 4 + (h_out + w_out) * 4 * 8  # frame, output, tap tables
        row.update(frame_rows_cols_reached=reached)
        bnd, by = bound_ms(nbytes, got.numel() * (2 * taps + 2))
        row.update(ms=time_ms(lambda: fused_preprocess(frames, net_hw, cfg.mean, cfg.std, method=method)),
                   plain_ms=time_ms(lambda: preprocess_plain(frames, net_hw, cfg.mean, cfg.std, method=method)),
                   library_ms=None, bound_ms=bnd, bound_by=by)
    emit("kernel", name="preprocess", **row)
    return row


def check_resize(gen, in_hw, out_hw, batch=1, timed=True):
    """K3's f32 route on values in [0, 1) within 3e-5 of the plain version;
    its u8 route on depth-like values from -50 to 550 against
    ``wraparound_u8`` of the plain version, bytes differing only where the
    f32 map lies within 1e-3 of an integer."""
    from depth_estimation_tpu_torch.ops.kernels.resize import resize_planes, resize_planes_plain, tiling
    from depth_estimation_tpu_torch.ops.postprocess import wraparound_u8

    x = torch.rand((batch, *in_hw), generator=gen, device="cuda")
    got, ref = resize_planes(x, out_hw), resize_planes_plain(x, out_hw)
    depth = x * 600 - 50
    got8, f32 = resize_planes(depth, out_hw, output="u8"), resize_planes_plain(depth, out_hw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= 3e-5, f"resize {tuple(got.shape)}: max abs err {err} over 3e-5")
    differ = got8 != wraparound_u8(f32)
    away = int((differ & ((f32 - f32.round()).abs() >= 1e-3)).sum())
    check(got8.dtype == torch.uint8 and away == 0,
          f"resize u8 {tuple(got8.shape)}: {away} bytes differ away from an integer")
    row = {"in": list(x.shape), "out": list(got.shape), "max_abs_err": err, "atol": 3e-5,
           "u8_bytes_differ": int(differ.sum()), "u8_bytes_differ_away_from_integer": away,
           "tiling": tiling(tuple(in_hw), tuple(out_hw), batch, sm_count(), "resize")}
    if timed:
        taps = sum(out_hw) * 4 * 8
        lib = lambda: F.interpolate(x[:, None], size=out_hw, mode="bicubic", align_corners=False)  # noqa: E731
        bnd, by = bound_ms(x.numel() * 4 + got.numel() * 4 + taps, got.numel() * 2 * 16)
        bnd8, by8 = bound_ms(x.numel() * 4 + got.numel() + taps, got.numel() * (2 * 16 + 1))
        row.update(library_max_abs_diff=(lib()[:, 0] - ref).abs().max().item(),
                   ms=time_ms(lambda: resize_planes(x, out_hw)),
                   plain_ms=time_ms(lambda: resize_planes_plain(x, out_hw)),
                   library_ms=time_ms(lib), bound_ms=bnd, bound_by=by,
                   u8_ms=time_ms(lambda: resize_planes(depth, out_hw, output="u8")),
                   u8_plain_ms=time_ms(lambda: resize_planes_plain(depth, out_hw, output="u8")),
                   u8_unfused_ms=time_ms(lambda: wraparound_u8(resize_planes(depth, out_hw))),
                   u8_library_ms=None, u8_bound_ms=bnd8, u8_bound_by=by8)
    emit("kernel", name="resize", **row)
    return row


MIDAS_CONV2_SHAPES = {"layer1": (256, 48, 64), "layer2": (512, 24, 32), "layer3": (1024, 12, 16),
                      "layer4": (2048, 6, 8)}  # (C, H, W) at a 192×256 network input, G = 32


def check_grouped_conv(gen, layer, dtype, tol, timed, batch=1, groups=32):
    from depth_estimation_tpu_torch.ops.kernels.grouped_conv import grouped_conv3x3, grouped_conv3x3_plain, tiling

    c, h, w = MIDAS_CONV2_SHAPES[layer]
    cg = c // groups
    x = torch.randn((batch, c, h, w), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((c, cg, 3, 3), generator=gen, device="cuda") / math.sqrt(9 * cg)).to(dtype)
    got, ref = grouped_conv3x3(x, k, groups), grouped_conv3x3_plain(x, k, groups)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol),
          f"grouped conv {layer} batch {batch} {dtype}: max abs err {err} over atol {tol} rtol {tol}")
    lib = lambda: F.conv2d(x, k, padding=1, groups=groups)  # noqa: E731
    row = {"layer": layer, "shape": [batch, c, h, w], "groups": groups, "dtype": str(dtype), "max_abs_err": err,
           "atol": tol, "rtol": tol, "library_max_abs_diff": (lib().float() - ref.float()).abs().max().item(),
           "tiling": tiling(x.shape, groups, sm_count(), dtype)}
    if timed:
        nbytes = (2 * x.numel() + k.numel()) * (torch.finfo(dtype).bits // 8)
        flops = 2 * batch * h * w * c * cg * 9
        if dtype == torch.float32:  # three TF32 products for each f32 one
            bnd, by = bound_ms(nbytes, 3 * flops, PEAK_TF32)
            row.update(bound_peak="3xTF32 tensor cores, 495 TFLOP/s",
                       fma_bound_ms=bound_ms(nbytes, flops, PEAK_FLOPS[dtype])[0])
        else:
            bnd, by = bound_ms(nbytes, flops, PEAK_FLOPS[dtype])
            row.update(bound_peak="bf16 tensor cores, 989 TFLOP/s")
        row.update(ms=time_ms(lambda: grouped_conv3x3(x, k, groups)),
                   plain_ms=time_ms(lambda: grouped_conv3x3_plain(x, k, groups)),
                   library_ms=time_ms(lib),
                   bound_ms=bnd, bound_by=by)
    emit("kernel", name="grouped_conv3x3", **row)
    return row


# The ViT's linear layers, (K, N, GELU): DPT_Large's qkv, proj, fc1 (GELU fused) and fc2 and its
# readout projection (GELU fused; the patch tokens alone), DPT_Hybrid's ViT-B four
VIT_LINEARS = {"qkv": (1024, 3072, False), "proj": (1024, 1024, False), "fc1": (1024, 4096, True),
               "fc2": (4096, 1024, False), "readout": (2048, 1024, True),
               "vit_b_qkv": (768, 2304, False), "vit_b_proj": (768, 768, False), "vit_b_fc1": (768, 3072, True),
               "vit_b_fc2": (3072, 768, False)}
LINEAR_ROWS = {1: 769, 4: 3076, 8: 6152}  # tokens × frames: webcam, the stream's microbatch, the servers' batch


def check_linear(gen, layer, frames, timed):
    """The f32 GEMM kernel at one of ``VIT_LINEARS``' layers over ``frames``
    frames' tokens, against float64 (the ×30-scaled inputs of K1's and K4's
    large cases: its error must be f32's, not TF32's) and against the plain
    version; ms beside the plain version's, ``F.linear``'s (TF32 off) and the
    3xTF32 bound."""
    from depth_estimation_tpu_torch.ops.kernels.dense import linear, linear_plain, tiling

    k, n, gelu = VIT_LINEARS[layer]
    m = LINEAR_ROWS[frames] - (frames if layer == "readout" else 0)  # the readout drops the cls token
    x = torch.randn((m, k), generator=gen, device="cuda") * 30
    w = torch.randn((n, k), generator=gen, device="cuda") * (30 / math.sqrt(k))
    b = torch.randn((n,), generator=gen, device="cuda")
    before = linear.launches
    got = linear(x, w, b, gelu)
    torch.cuda.synchronize()
    check(linear.launches == before + 1, f"linear {layer} x{frames}: no kernel launch")
    exact = linear_plain(x.double(), w.double(), b.double(), gelu)
    plain = linear_plain(x, w, b, gelu)
    scale = exact.abs().max().item()
    err, plain_err = ((t.double() - exact).abs().max().item() / scale for t in (got, plain))
    check(err <= max(2 * plain_err, 1e-6), f"linear {layer} x{frames}: max-scaled error {err} against float64, "
          f"f32's {plain_err}")
    check(torch.equal(got, linear(x, w, b, gelu)), f"linear {layer} x{frames}: two calls differ")
    row = {"layer": layer, "shape": [m, k, n], "gelu": gelu, "block_n": tiling(m, n, sm_count()),
           "max_abs_err": (got - plain).abs().max().item(), "max_scaled_err_vs_f64": err,
           "plain_max_scaled_err_vs_f64": plain_err}
    if timed:
        flops = 2 * m * k * n
        bnd, by = bound_ms((m * k + 2 * n * k + m * n) * 4, 3 * flops, PEAK_TF32)
        ms = time_ms(lambda: linear(x, w, b, gelu))
        row.update(ms=ms, plain_ms=time_ms(lambda: linear_plain(x, w, b, gelu)),
                   library_ms=time_ms(lambda: F.linear(x, w, b)), bound_ms=bnd, bound_by=by,
                   bound_peak="3xTF32 tensor cores, 495 TFLOP/s", tflops=flops / ms / 1e9, bound_share=bnd / ms)
    emit("kernel", name="linear", frames=frames, **row)
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
K4_KERNELS = ("grouped_conv3x3_tf32_kernel", "grouped_conv3x3_bf16_kernel")  # one entry per template instance
K4_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
K23_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "tiling")
K3_U8_KEYS = ("u8_ms", "u8_plain_ms", "u8_unfused_ms", "u8_library_ms", "u8_bound_ms", "u8_bytes_differ")


def profile_frames(est, frame, phase="profile", batch=1, n=8, max_calls=None):
    """Frame programs of ``batch`` copies of ``frame``, one at a time: host-clock
    ms per program, then torch.profiler's device busy time, K1's and K4's
    shares and the largest kernels. With ``max_calls``, fails if any kernel entry is launched
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
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in cuda_events(lambda: program(imgs), n)),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / n / 1e3
    k1 = [r for r in rows if any(name in r[0] for name in K1_KERNELS)]
    k4 = [r for r in rows if any(name in r[0] for name in K4_KERNELS)]
    kernels_run = sum(r[2] for r in rows if r[1] > 0 and not r[0].startswith(("Memcpy", "Memset"))) / n
    most = max(rows, key=lambda r: r[2])
    if max_calls is not None:
        check(most[2] / n <= max_calls,
              f"{phase}: {most[0][:100]} launched {most[2] / n} times a program, over {max_calls}")
    emit(phase, model=est.model_type, dtype=str(est.dtype), src_hw=list(frame.shape[:2]), batch=batch,
         program_ms=program_ms, frame_ms=program_ms / batch, device_busy_ms_per_program=busy_ms,
         device_idle_share=max(0.0, 1 - busy_ms / program_ms),
         k1_ms_per_program=sum(r[1] for r in k1) / n / 1e3, k1_calls_per_program=sum(r[2] for r in k1) / n,
         k4_ms_per_program=sum(r[1] for r in k4) / n / 1e3, k4_calls_per_program=sum(r[2] for r in k4) / n,
         device_kernels_per_program=kernels_run,
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
    launches must be ``per_program`` a frame, and in one profiled frame every
    K1 kernel on the bf16 route. Returns the bf16 estimator."""
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
    # bf16 linear layers take F.linear by dtype (cuBLAS bf16 is on the tensor cores): no linear launches
    want = {name: 8 * n for name, n in {**per_program, "linear": 0}.items()}
    check(counts == want, f"{phase}: launch counts {counts} != {want}")
    events = cuda_events(lambda: est16.predict_device_u8(frame))
    k1_route = {name: sum(e.count for e in events if name in e.key) for name in K1_KERNELS}
    check(k1_route == {"attention_f32_kernel": 0, "attention_bf16_kernel": per_program["multi_head_attention"]},
          f"{phase}: K1 kernels by route in one frame {k1_route}")
    emit(phase, model=est.model_type, src_hw=list(frame.shape[:2]), max_abs_rel_vs_f32=rel16, bound=bound,
         frame_ms=frame_ms, launches=counts, k1_route=k1_route)
    return est16


def bf16_tail(est, est16, frame, bound, phase):
    """DPT_Hybrid's ViT-B and decoder in bf16, fed the f32 stem's features
    (cast to bf16): unlike the stem, they do not amplify rounding, so a fault
    on the bf16 network path shows against ``bound``."""
    kept = {}
    stem32 = est.model.pretrained.model.patch_embed.backbone
    stem16 = est16.model.pretrained.model.patch_embed.backbone
    hooks = [stem32.register_forward_hook(lambda mod, inp, out: kept.update(out=out)),
             stem16.register_forward_hook(lambda mod, inp, out: (
                 kept["out"][0].to(out[0].dtype), [t.to(out[0].dtype) for t in kept["out"][1]]))]
    try:
        d32 = est.predict(frame)
        d16 = est16.predict(frame)
    finally:
        for h in hooks:
            h.remove()
    rel = float(np.abs(d32 - d16).max() / np.abs(d32).max())
    check(np.isfinite(d16).all() and rel < bound, f"{phase}: bf16 vs f32 max abs-rel {rel} over {bound}")
    emit(phase, model=est.model_type, src_hw=list(frame.shape[:2]), max_abs_rel_vs_f32=rel, bound=bound)


# -- the fused iris/pose + depth path ----------------------------------------------

FUSED_PER_PROGRAM = {"multi_head_attention": 24, "fused_preprocess": 3, "resize_planes": 1, "grouped_conv3x3": 0,
                     "linear": 100}
DETECTOR_INPUTS = {"blazeface_128x128": ((128, 128), (0.5,) * 3, (0.5,) * 3),
                   "blazepose_256x256": ((256, 256), (0.0,) * 3, (1.0,) * 3),
                   "blazepose_detector_224x224": ((224, 224), (0.5,) * 3, (0.5,) * 3)}


def detector_weights(seed=0):
    """The state dicts of ``PersonDetector(seed=seed)``'s random nets (built
    on the empty weight cache that ``main`` sets), with the SSD heads of
    BlazeFace and BlazePoseDetector rescaled so that random weights make
    working detectors: classifiers ×0.05 (scores near 0.75 instead of
    saturated at 1, so kept scores do not tie), box regressors ×0.5 with
    widths and heights biased to 0.2 of the input (boxes with an area, face
    crops of some 20-30% of the frame instead of 1×1)."""
    import warnings

    from depth_estimation_tpu_torch.config import CARD
    from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
    from depth_estimation_tpu_torch.geometry.face import FaceDet

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        det = PersonDetector(FaceDet(20, CARD), seed=seed, device="cpu")
    sd = {key: {k: v.clone() for k, v in net.state_dict().items()}
          for key, net in (("blazeface", det._face_det), ("facemesh", det._mesh),
                           ("blazepose_detector", det._pose_det), ("blazepose", det._pose))}
    for key, tags, values, size in (("blazeface", ("16", "8"), 16, 128),
                                    ("blazepose_detector", ("28", "14", "7"), 12, 224)):
        for tag in tags:
            sd[key][f"classifier_{tag}.weight"] *= 0.05
            sd[key][f"regressor_{tag}.weight"] *= 0.5
            sd[key][f"regressor_{tag}.bias"].view(-1, values)[:, 2:4] += 0.2 * size
    return sd


def make_detector(weights, thresh=0.2, device="cuda"):
    from depth_estimation_tpu_torch.config import CARD
    from depth_estimation_tpu_torch.detect.person_detector import PersonDetector
    from depth_estimation_tpu_torch.geometry.face import FaceDet

    return PersonDetector(FaceDet(20, CARD), minDetectionCon=thresh, params=weights, device=device)


def run_fused_stream(est, weights, out_path, microbatch, phase="fused_stream", **extra):
    """``FusedVidStream`` over ``synthetic:16x480x640`` after one untimed
    program of its batch (set-up): the kernels' launches must be
    FUSED_PER_PROGRAM a program, plus one K2 launch for each staged
    ``findBody`` (a hit whose iris fit is degenerate goes the body way by the
    staged call, as in the JAX loop)."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.stream import FusedVidStream

    det = make_detector(weights)
    vs = FusedVidStream(est, det, det.face, f"synthetic:{FRAMES}x480x640", out_path, verbose=False,
                        microbatch=microbatch)
    vs._runner.batched(np.zeros((microbatch, 480, 640, 3), np.uint8))  # set-up (cuDNN plans) for this batch
    staged = []
    find_body = det.findBody
    det.findBody = lambda img: (staged.append(1), find_body(img))[1]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    vs.stream()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    programs = math.ceil(FRAMES / microbatch)
    want = {name: n * programs for name, n in FUSED_PER_PROGRAM.items()}
    want["fused_preprocess"] += len(staged)
    check(counts == want, f"{phase}: launch counts {counts} != {want} (microbatch={microbatch})")
    check(os.path.getsize(out_path) > 0, f"{out_path} is empty")
    s = vs.timer.summary()["depth"]
    check(s["frames"] == FRAMES and sum(vs.route_counts.values()) == FRAMES,
          f"{phase}: {s['frames']} frames, routes {vs.route_counts}")
    check(np.isfinite(det.face.ri_depths).all() and len(det.face.abs_depths) >= FRAMES,
          f"{phase}: depth samples {det.face.ri_depths}")
    emit(phase, model=est.model_type, microbatch=microbatch, frames=FRAMES, p50_ms=s["p50_ms"], p90_ms=s["p90_ms"],
         fps_completion=s["fps_completion"], ms_per_frame=1e3 / s["fps_completion"], wall_fps=FRAMES / wall,
         launches=counts, launches_per_program=FUSED_PER_PROGRAM, staged_find_body=len(staged),
         routes=vs.route_counts, avi_bytes=os.path.getsize(out_path), **extra)
    return counts, s["fps_completion"]


def fused_hold(est, cpu_est, weights, thresh, case, phase="fused_hold"):
    """The fused program on the card against the same weights through the
    plain paths on the CPU, on a 240×320 frame: depth within 1e-3 max
    abs-rel, valid equal, scores within 1e-4; where the reference's top two
    kept scores lie 1e-4 apart or more, also boxes within 1e-4, the mesh
    (ints equal, or ±1 where the CPU's float landmark lies within 1e-3 of an
    integer), circles and pose landmarks; where they lie closer, the margin
    is printed and only depth and scores are held."""
    from depth_estimation_tpu_torch.device import full_f32
    from depth_estimation_tpu_torch.runtime.fused import FusedFrameRunner, crop_box, mesh_points
    from depth_estimation_tpu_torch.runtime.video import SyntheticSource

    _, frame = SyntheticSource(1, 240, 320).read()
    cpu_det = make_detector(weights, thresh, "cpu")
    gpu = {k: v.cpu().numpy() for k, v in FusedFrameRunner(est, make_detector(weights, thresh))(frame).items()}
    t0 = time.perf_counter()
    cpu = {k: v.numpy() for k, v in FusedFrameRunner(cpu_est, cpu_det)(frame).items()}
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(cpu["depth"]).max())
    rel = float(np.abs(gpu["depth"] - cpu["depth"]).max()) / scale
    check(np.isfinite(gpu["depth"]).all() and scale > 0 and rel < 1e-3, f"{phase} {case}: depth max abs-rel {rel}")
    check((gpu["valid"] == cpu["valid"]).all() and bool(cpu["valid"][0]) == (case == "hit"),
          f"{phase} {case}: valid {gpu['valid']} vs {cpu['valid']}")
    score_err = float(np.abs(gpu["scores"] - cpu["scores"]).max())
    check(score_err <= 1e-4, f"{phase} {case}: scores differ by {score_err}")
    kept = cpu["scores"][cpu["valid"]]
    margin = float(kept[0] - kept[1]) if len(kept) > 1 else None
    row = {"case": case, "max_abs_rel": rel, "depth_max": scale, "score_max_abs_err": score_err,
           "top_two_margin": margin, "valid": int(cpu["valid"].sum()), "cpu_seconds": cpu_s}
    if margin is not None and margin < 1e-4:
        row["held"] = "depth and scores only: the top two kept scores lie within 1e-4"
    else:
        box_err = float(np.abs(gpu["boxes"] - cpu["boxes"]).max())
        check(box_err <= 1e-4, f"{phase} {case}: boxes differ by {box_err}")
        with torch.inference_mode(), full_f32():
            pts, _ = mesh_points(cpu_det._mesh, torch.from_numpy(frame[None]),
                                 *crop_box(torch.from_numpy(cpu["boxes"][None]), 240, 320))
        near = np.abs(pts[0].numpy() - np.round(pts[0].numpy())) < 1e-3
        differ = gpu["mesh"] != cpu["mesh"] if case == "hit" else np.zeros_like(near)
        check(not (differ & ~near).any() and np.abs(gpu["mesh"] - cpu["mesh"]).max() <= 1,
              f"{phase} {case}: {int((differ & ~near).sum())} mesh ints differ away from an integer")
        iris_moved = bool(differ.any())
        circle_err = max(float(np.abs(gpu[k] - cpu[k]).max()) for k in ("l_center", "l_radius", "r_center",
                                                                         "r_radius"))
        check(circle_err <= (1.0 + 1e-3 if iris_moved else 1e-3), f"{phase} {case}: circles differ by {circle_err}")
        pose_scale = float(np.abs(cpu["pose_lm"]).max()) or 1.0
        pose_rel = float(np.abs(gpu["pose_lm"] - cpu["pose_lm"]).max()) / pose_scale
        check(pose_rel < 1e-3, f"{phase} {case}: pose landmarks max abs-rel {pose_rel}")
        row.update(held="depth, scores, boxes, mesh, circles, pose", box_max_abs_err=box_err,
                   mesh_moved_by_rule=int(differ.sum()), circle_max_abs_err=circle_err, pose_max_abs_rel=pose_rel,
                   l_radius=float(cpu["l_radius"]), r_radius=float(cpu["r_radius"]))
    emit(phase, model=est.model_type, src_hw=[240, 320], **row)


def branch_times(fn, n=8):
    """One part of a program alone: host ms a call (``n`` calls, then a sync),
    and its kernels' device time and count a call (torch.profiler)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    rows = [(e.key, e.self_device_time_total, e.count) for e in cuda_events(fn, n)]
    return {"host_ms": host_ms, "busy_ms": sum(r[1] for r in rows) / n / 1e3,
            "kernels": sum(r[2] for r in rows if r[1] > 0 and not r[0].startswith(("Memcpy", "Memset"))) / n}


def program_profile(call, n):
    """A program's ``call``, after two set-up calls: host ms a call (``n``
    calls, then a sync), then under torch.profiler its device busy ms,
    device kernels and ``cudaLaunchKernel`` calls a call, and the kernel rows
    (name, device µs, count over the ``n`` calls) by device time."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    program_ms = (time.perf_counter() - t0) / n * 1e3
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in cuda_events(call, n)), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / n / 1e3
    kernels_run = sum(r[2] for r in rows if r[1] > 0 and not r[0].startswith(("Memcpy", "Memset"))) / n
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as cprof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    launches = sum(e.count for e in cprof.key_averages() if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                                      "cudaLaunchKernelExC")) / n
    return program_ms, busy_ms, kernels_run, launches, rows


def profile_fused(est, weights, frame, phase="fused_profile", batch=1, n=8):
    """Fused programs of ``batch`` copies of ``frame``, one at a time: host
    ms a program, device busy ms and idle share, device kernels and
    ``cudaLaunchKernel`` calls a program, the largest kernels; then each
    part alone (``branch_times``): depth, BlazeFace with NMS, the mesh branch
    (crop, FaceMesh+iris, circles) and the pose branch, the last two being
    the branches that JAX's ``lax.cond`` chooses between, both of which run
    here. The larger of those two is the branch not taken, read as a share
    of the program's busy time and of its host time (the program is
    host-bound: the branch's dispatch is its larger cost)."""
    from depth_estimation_tpu_torch.detect.circle import min_enclosing_circle_torch
    from depth_estimation_tpu_torch.device import full_f32
    from depth_estimation_tpu_torch.runtime.fused import (FusedFrameRunner, blazeface_branch, crop_box, mesh_points,
                                                          pose_branch, to_int32)

    det = make_detector(weights)
    runner = FusedFrameRunner(est, det)
    imgs = np.stack([frame] * batch)
    program_ms, busy_ms, kernels_run, launches, rows = program_profile(lambda: runner.batched(imgs), n)
    frames = torch.from_numpy(imgs).cuda()
    with torch.inference_mode(), est._numerics(), full_f32():
        boxes = blazeface_branch(det._face_det, det._face_anchors, det.minDetectionCon, frames)[0]
        box = crop_box(boxes, *frame.shape[:2])
        iris_idx = torch.tensor([det.LEFT_IRIS, det.RIGHT_IRIS], device="cuda")

        def mesh_branch():
            mesh = to_int32(mesh_points(det._mesh, frames, *box)[0])
            return min_enclosing_circle_torch(mesh[:, iris_idx].float())

        branches = {"depth": lambda: est.depth_branch(frames),
                    "blazeface_nms": lambda: blazeface_branch(det._face_det, det._face_anchors, det.minDetectionCon,
                                                              frames),
                    "mesh": mesh_branch, "pose": lambda: pose_branch(det._pose, frames)}
        branch = {name: branch_times(fn, n) for name, fn in branches.items()}
    untaken = max(branch["mesh"]["busy_ms"], branch["pose"]["busy_ms"])
    untaken_host = max(branch["mesh"]["host_ms"], branch["pose"]["host_ms"])
    emit(phase, model=est.model_type, src_hw=list(frame.shape[:2]), batch=batch, program_ms=program_ms,
         frame_ms=program_ms / batch, device_busy_ms_per_program=busy_ms,
         device_idle_share=max(0.0, 1 - busy_ms / program_ms), device_kernels_per_program=kernels_run,
         cuda_launch_calls_per_program=launches, branches=branch,
         untaken_branch_busy_share_max=untaken / busy_ms, untaken_branch_host_share_max=untaken_host / program_ms,
         top=[{"kernel": k[:100], "ms_per_program": t / n / 1e3, "calls_per_program": c / n}
              for k, t, c in rows[:10]])


# -- the detection-only path (depth_by_detection) and the staged loop ---------------------

DETECTION_PER_PROGRAM = {"multi_head_attention": 0, "fused_preprocess": 2, "resize_planes": 0, "grouped_conv3x3": 0,
                         "linear": 0}
STAGED_PER_FRAME = {"multi_head_attention": 24, "fused_preprocess": 2, "resize_planes": 1, "grouped_conv3x3": 0,
                    "linear": 100}


def make_face_detector(weights, thresh=0.2, device="cuda"):
    from depth_estimation_tpu_torch.detect.face_detector import FaceDetector

    return FaceDetector(minDetectionCon=thresh, params=weights, device=device)


class _TierCounter:
    """A FaceDetector as ``depth_by_detection._loop`` sees it, counting the
    calls that mark each frame's tier: ``findFaces`` (tier 2, and before
    tier 3), ``body_from_fused`` and the staged ``findBody`` (tier 3)."""

    def __init__(self, det):
        self.det, self.calls = det, {"findFaces": 0, "body_from_fused": 0, "findBody": 0}

    def __getattr__(self, name):
        fn = getattr(self.det, name)
        if name not in self.calls:
            return fn

        def counted(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)

        return counted


def run_detection_stream(weights, out_path, phase="detection_stream"):
    """The port's ``depth_by_detection._loop`` through ``FusedDetectionRunner``
    over ``synthetic:16x480x640``, per frame, after one untimed program of
    that size (set-up): launches a program DETECTION_PER_PROGRAM, plus one
    K2 launch for each staged ``findBody`` (a hit whose iris fit is
    degenerate and no tier-2 distance); frames of each tier printed."""
    import argparse

    from depth_estimation_tpu_torch import depth_by_detection as dbd
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.fused import FusedDetectionRunner
    from depth_estimation_tpu_torch.runtime.video import open_sink, open_source

    t_phase = time.perf_counter()
    det = _TierCounter(make_face_detector(weights))
    runner = FusedDetectionRunner(det.det)
    runner(np.zeros((480, 640, 3), np.uint8))  # set-up
    video, writer = open_source(f"synthetic:{FRAMES}x480x640"), open_sink(out_path, (640, 480), fps=20)
    f = dbd.f_length(dbd.in_to_mm(20), w_object=82.6,
                     w_pix=dbd.dist_euclid((dbd.CARD[0], dbd.CARD[2]), (dbd.CARD[1], dbd.CARD[3])))
    head = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    dbd._loop(argparse.Namespace(quiet=True), video, writer, det, runner, None, f, head, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    video.release()
    writer.release()
    want = {name: n * FRAMES for name, n in DETECTION_PER_PROGRAM.items()}
    want["fused_preprocess"] += det.calls["findBody"]
    check(counts == want, f"{phase}: launch counts {counts} != {want}")
    check(os.path.getsize(out_path) > 0, f"{out_path} is empty")
    tiers = {"iris": len(head), "face_box": det.calls["findFaces"] - det.calls["body_from_fused"]
             - det.calls["findBody"], "body": det.calls["body_from_fused"] + det.calls["findBody"]}
    check(sum(tiers.values()) == FRAMES, f"{phase}: tiers {tiers} over {FRAMES} frames")
    emit(phase, frames=FRAMES, fps=FRAMES / wall, ms_per_frame=wall / FRAMES * 1e3, tiers=tiers,
         staged_find_body=det.calls["findBody"], launches=counts, launches_per_program=DETECTION_PER_PROGRAM,
         avi_bytes=os.path.getsize(out_path), seconds=time.perf_counter() - t_phase)
    return counts


def detection_hold(weights, frame, thresh, case, phase="detection_hold"):
    """The detection program on the card against the same weights through
    the plain paths on the CPU, on one 480×640 frame: valid equal, scores
    within 1e-4; where the CPU's top two kept scores lie 1e-4 apart or more,
    boxes within 1e-4, the mesh (ints equal, or ±1 where the CPU's float
    landmark lies within 1e-3 of an integer; zeros on a miss) and the pose
    (max abs-rel 1e-4; zeros on a hit). A hit's mesh must come from the BGR
    feed: against the RGB feed's landmarks the same rule must fail."""
    from depth_estimation_tpu_torch.device import full_f32
    from depth_estimation_tpu_torch.ops.sampling import bgr_u8_to_rgb01, u8_to_01
    from depth_estimation_tpu_torch.runtime.fused import DETECTION_FIELDS, FusedDetectionRunner, crop_box, mesh_points

    t_phase = time.perf_counter()
    names = [name for name, _shape, _dtype in DETECTION_FIELDS]
    cpu_det = make_face_detector(weights, thresh, "cpu")
    gpu = dict(zip(names, FusedDetectionRunner(make_face_detector(weights, thresh))(frame)))
    cpu = dict(zip(names, FusedDetectionRunner(cpu_det)(frame)))
    check((gpu["valid"] == cpu["valid"]).all() and bool(cpu["valid"][0]) == (case == "hit"),
          f"{phase} {case}: valid {gpu['valid']} vs {cpu['valid']}")
    score_err = float(np.abs(gpu["scores"] - cpu["scores"]).max())
    check(score_err <= 1e-4, f"{phase} {case}: scores differ by {score_err}")
    kept = cpu["scores"][cpu["valid"]]
    margin = float(kept[0] - kept[1]) if len(kept) > 1 else None
    row = {"case": case, "score_max_abs_err": score_err, "top_two_margin": margin, "valid": int(cpu["valid"].sum())}
    if margin is not None and margin < 1e-4:
        row["held"] = "scores only: the top two kept scores lie within 1e-4"
    else:
        box_err = float(np.abs(gpu["boxes"] - cpu["boxes"]).max())
        check(box_err <= 1e-4, f"{phase} {case}: boxes differ by {box_err}")

        def landmarks(pixels):
            with torch.inference_mode(), full_f32():
                pts, _ = mesh_points(cpu_det._impl._mesh, torch.from_numpy(frame[None]),
                                     *crop_box(torch.from_numpy(cpu["boxes"][None]), *frame.shape[:2]), pixels=pixels)
            return pts[0].numpy()

        def away(mesh, floats):  # entries the ±1 rule does not let through
            diff = np.abs(mesh - np.trunc(floats))
            return int(((diff > 0) & (np.abs(floats - np.round(floats)) >= 1e-3) | (diff > 1)).sum())

        if case == "hit":
            bgr, rgb = landmarks(u8_to_01), landmarks(bgr_u8_to_rgb01)
            check((cpu["mesh"] == np.trunc(bgr)).all(), f"{phase}: the CPU mesh is not its BGR-fed landmarks")
            moved, rgb_away = away(gpu["mesh"], bgr), away(gpu["mesh"], rgb)
            check(moved == 0, f"{phase} {case}: {moved} mesh ints differ away from an integer")
            check(rgb_away > 0, f"{phase} {case}: the mesh agrees with the RGB feed too")
            check(not gpu["pose_lm"].any() and gpu["pose_score"] == 0, f"{phase} {case}: pose not zeros on a hit")
            row.update(mesh_moved_by_rule=int((gpu["mesh"] != cpu["mesh"]).sum()),
                       mesh_entries_off_the_rgb_feed=rgb_away, feed="bgr")
        else:
            check(not gpu["mesh"].any(), f"{phase} {case}: mesh not zeros on a miss")
            pose_scale = float(np.abs(cpu["pose_lm"]).max()) or 1.0
            pose_rel = float(np.abs(gpu["pose_lm"] - cpu["pose_lm"]).max()) / pose_scale
            pscore_err = abs(float(gpu["pose_score"]) - float(cpu["pose_score"]))
            check(pose_rel <= 1e-4 and pscore_err <= 1e-4,
                  f"{phase} {case}: pose max abs-rel {pose_rel}, score {pscore_err}")
            row.update(pose_max_abs_rel=pose_rel, pose_score_abs_err=pscore_err)
        row.update(held="scores, boxes, mesh, pose", box_max_abs_err=box_err)
    emit(phase, src_hw=list(frame.shape[:2]), seconds=time.perf_counter() - t_phase, **row)


def detection_depth(weights, frame, phase="detection_depth"):
    """Tier 2 with ``--with-depth MiDaS_small`` on a hit frame, as the loop
    runs it: the detection program, ``findFaces(detection=…)``,
    ``predict_device`` and ``rois_median_depth`` on its boxes. Launches a
    tier-2 frame: K2 3 (2 detection, 1 cubic), K3 1. The medians on the card
    equal the CPU's on the same map (nan for an empty box); the map lies
    within the 1e-3 gate of the CPU plain path's; the medians' time."""
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.ops.sampling import rois_median_depth
    from depth_estimation_tpu_torch.runtime.fused import FusedDetectionRunner

    t_phase = time.perf_counter()
    small = DepthEstimator("MiDaS_small", seed=0, device="cuda", verbose=False)
    det = make_face_detector(weights, 0.0)
    runner = FusedDetectionRunner(det)
    runner(frame)
    small.predict_device(frame)  # set-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    boxes, scores, valid = runner(frame)[:3]
    img, bboxes = det.findFaces(frame.copy(), detection=(boxes, scores, valid))
    depth = small.predict_device(img)
    boxes_yxyx = torch.tensor([[b["bbox"][1], b["bbox"][0], b["bbox"][1] + b["bbox"][3], b["bbox"][0] + b["bbox"][2]]
                               for b in bboxes], dtype=torch.int32, device="cuda")
    ones = torch.ones(len(bboxes), dtype=torch.bool, device="cuda")
    meds = rois_median_depth(depth, boxes_yxyx, ones)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {"multi_head_attention": 0, "fused_preprocess": 3, "resize_planes": 1, "grouped_conv3x3": 0, "linear": 0}
    check(counts == want, f"{phase}: launch counts {counts} != {want}")
    check(len(bboxes) > 0, f"{phase}: no boxes on a hit")
    cpu_meds = rois_median_depth(depth.cpu(), boxes_yxyx.cpu(), ones.cpu())
    check(torch.equal(meds.cpu().isnan(), cpu_meds.isnan()) and bool(
        (meds.cpu() == cpu_meds)[~cpu_meds.isnan()].all()), f"{phase}: medians {meds.cpu()} != {cpu_meds}")
    cpu_small = DepthEstimator("MiDaS_small", params={k: v.cpu() for k, v in small.model.state_dict().items()},
                               device="cpu", verbose=False)
    gpu_map, cpu_map = depth.cpu().numpy(), cpu_small.predict(img)
    scale = float(np.abs(cpu_map).max())
    rel = float(np.abs(gpu_map - cpu_map).max()) / scale
    check(np.isfinite(gpu_map).all() and scale > 0 and rel < 1e-3, f"{phase}: map max abs-rel {rel}")
    emit(phase, model="MiDaS_small", src_hw=list(frame.shape[:2]), boxes=len(bboxes),
         empty_boxes=int(cpu_meds.isnan().sum()), launches=counts, map_max_abs_rel=rel,
         medians_ms=time_ms(lambda: rois_median_depth(depth, boxes_yxyx, ones), reps=10, inner=5),
         seconds=time.perf_counter() - t_phase)


def profile_detection(weights, frame, phase="detection_profile", n=8):
    """One detection program at a time (``FusedDetectionRunner``, batch 1,
    the frame's copy in and the packed row's copy out included): host ms a
    program, device busy ms and idle share, device kernels and
    ``cudaLaunchKernel`` calls a program, the largest kernels."""
    from depth_estimation_tpu_torch.runtime.fused import FusedDetectionRunner

    t_phase = time.perf_counter()
    runner = FusedDetectionRunner(make_face_detector(weights))
    program_ms, busy_ms, kernels_run, launches, rows = program_profile(lambda: runner(frame), n)
    emit(phase, src_hw=list(frame.shape[:2]), batch=1, program_ms=program_ms, device_busy_ms_per_program=busy_ms,
         device_idle_share=max(0.0, 1 - busy_ms / program_ms), device_kernels_per_program=kernels_run,
         cuda_launch_calls_per_program=launches, seconds=time.perf_counter() - t_phase,
         top=[{"kernel": k[:100], "ms_per_program": t / n / 1e3, "calls_per_program": c / n}
              for k, t, c in rows[:10]])


POSE_DETECT_PER_CALL = {"multi_head_attention": 0, "fused_preprocess": 1, "resize_planes": 0, "grouped_conv3x3": 0,
                        "linear": 0}


def _launched(call, per_call, what):
    """``call()`` with the launch counts zeroed just before and read just
    after (a sync between); they must be ``per_call``. → (result, counts)."""
    from depth_estimation_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts == per_call, f"{what}: launch counts {counts} != {per_call}")
    return out, counts


def _bitwise(a, b, what):
    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    check(a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True),
          f"{what}: differs (max abs {np.abs(a.astype(np.float64) - b.astype(np.float64)).max()})")


def run_tflite(est, weights, frame, phase="tflite"):
    """The ``.tflite`` route on the card (``tools/tflite_rehearsal.rehearse``
    under a temporary ``DEPTH_ESTIMATION_TPU_TORCH_CACHE``): the five
    MediaPipe files written at full size from ``weights`` (3 extra branch
    convs in the pose landmark file), imported by the CLI (its seconds),
    imported again (a cache hit: the converters raise if called; its
    seconds); ``PersonDetector()`` and ``FaceDetector()`` on the card, given
    no params, hold the written state dicts bitwise. Then, on those
    auto-loaded detectors, each against the same program on the state dicts
    given: the fused iris/pose program on the DPT_Large of phase 4 (K1 24,
    K2 3, K3 1) and the detection program (K2 2), outputs bitwise equal; the
    pose stage ``_detect_fn((480, 640), "pose")`` (one K2 launch, linear to
    224², mean = std = 0.5) against the CPU plain path on the same weights:
    valid equal, scores within 1e-4 and, where the CPU's top two kept scores
    lie 1e-4 apart or more, boxes within 1e-4. Returns the launches of the
    three auto-loaded calls."""
    from depth_estimation_tpu_torch.runtime.fused import FusedDetectionRunner, FusedFrameRunner
    from depth_estimation_tpu_torch.tools.tflite_rehearsal import rehearse

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tflite_cache_") as cache:
        report = rehearse(cache, weights=weights, device="cuda", log=lambda *_: None)
    det, fd, given = report["person_detector"], report["face_detector"], report["weights"]
    launches = {name: 0 for name in FUSED_PER_PROGRAM}

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    auto, direct = FusedFrameRunner(est, det), FusedFrameRunner(est, make_detector(given))
    auto(frame), direct(frame)  # set-up (cuDNN plans at this shape)
    got, counts = _launched(lambda: auto(frame), FUSED_PER_PROGRAM, f"{phase} fused")
    add(counts)
    want = direct(frame)
    check(got.keys() == want.keys(), f"{phase}: fused keys {sorted(got)} vs {sorted(want)}")
    for k in want:
        _bitwise(got[k], want[k], f"{phase} fused {k}")
    fused_valid = bool(got["valid"][0])

    auto_d, direct_d = FusedDetectionRunner(fd), FusedDetectionRunner(make_face_detector(given))
    auto_d(frame), direct_d(frame)  # set-up
    got_d, counts = _launched(lambda: auto_d(frame), DETECTION_PER_PROGRAM, f"{phase} detection")
    add(counts)
    for name, a, b in zip(("boxes", "scores", "valid", "mesh", "pose_lm", "pose_score"), got_d, direct_d(frame)):
        _bitwise(a, b, f"{phase} detection {name}")

    pose = det._detect_fn(frame.shape[:2], "pose")
    pose(frame)  # set-up
    (boxes, scores, valid), counts = _launched(lambda: pose(frame), POSE_DETECT_PER_CALL, f"{phase} pose detector")
    add(counts)
    cpu_boxes, cpu_scores, cpu_valid = (t.numpy() for t in
                                        make_detector(given, device="cpu")._detect_fn(frame.shape[:2], "pose")(frame))
    boxes, scores, valid = boxes.cpu().numpy(), scores.cpu().numpy(), valid.cpu().numpy()
    check((valid == cpu_valid).all(), f"{phase} pose detector: valid {valid} vs {cpu_valid}")
    score_err = float(np.abs(scores - cpu_scores).max())
    check(score_err <= 1e-4, f"{phase} pose detector: scores differ by {score_err}")
    kept = cpu_scores[cpu_valid]
    margin = float(kept[0] - kept[1]) if len(kept) > 1 else None
    pose_row = {"valid": int(cpu_valid.sum()), "score_max_abs_err": score_err, "top_two_margin": margin}
    if margin is not None and margin < 1e-4:
        pose_row["held"] = "scores only: the top two kept scores lie within 1e-4"
    else:
        box_err = float(np.abs(boxes - cpu_boxes).max())
        check(box_err <= 1e-4, f"{phase} pose detector: boxes differ by {box_err}")
        pose_row.update(held="scores, boxes", box_max_abs_err=box_err)
    emit(phase, files_bytes=report["files"], import_seconds=report["import_seconds"],
         cached_import_seconds=report["cached_import_seconds"], fused_bitwise=sorted(want), fused_hit=fused_valid,
         detection_bitwise=True, launches_per_program={"fused": FUSED_PER_PROGRAM, "detection": DETECTION_PER_PROGRAM,
                                                       "pose_detector": POSE_DETECT_PER_CALL},
         launches=launches, pose_detector=pose_row, seconds=time.perf_counter() - t_phase)
    return launches


def run_staged_stream(est, weights, out_path, frames=8, phase="staged_stream"):
    """``FusedVidStream(fused=False)`` (``--no-fused``) with ``est`` over
    ``synthetic:8x480x640`` after one untimed frame (set-up): launches a
    frame STAGED_PER_FRAME (the depth program's K1 24, K2 1, K3 1 and
    findIris's BlazeFace K2 1), plus one K2 for each staged ``findBody`` (the
    body route)."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.stream import FusedVidStream

    t_phase = time.perf_counter()
    det = make_detector(weights)
    vs = FusedVidStream(est, det, det.face, f"synthetic:{frames}x480x640", out_path, verbose=False, fused=False)
    zero = np.zeros((480, 640, 3), np.uint8)
    est.predict_device(zero)
    make_detector(weights).findIris(zero)  # set-up, on a detector of its own
    staged = []
    find_body = det.findBody
    det.findBody = lambda img: (staged.append(1), find_body(img))[1]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    vs.stream()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = {name: n * frames for name, n in STAGED_PER_FRAME.items()}
    want["fused_preprocess"] += len(staged)
    check(counts == want, f"{phase}: launch counts {counts} != {want}")
    check(len(staged) == vs.route_counts["body"] and sum(vs.route_counts.values()) == frames,
          f"{phase}: routes {vs.route_counts}, staged findBody {len(staged)}")
    check(os.path.getsize(out_path) > 0, f"{out_path} is empty")
    s = vs.timer.summary()
    emit(phase, model=est.model_type, frames=frames, fps=frames / wall, ms_per_frame=wall / frames * 1e3,
         depth_p50_ms=s["depth"]["p50_ms"], iris_p50_ms=s["iris"]["p50_ms"], routes=vs.route_counts,
         launches=counts, launches_per_frame=STAGED_PER_FRAME, staged_find_body=len(staged),
         avi_bytes=os.path.getsize(out_path), seconds=time.perf_counter() - t_phase)
    return counts


# -- the serving surface: DepthServer, BucketedDepthServer, FusedDepthServer, MultiStream, serve ---------

# linear: 24 blocks × (qkv, proj, fc1, fc2) + 4 readout projections
DPT_PER_PROGRAM = {"multi_head_attention": 24, "fused_preprocess": 1, "resize_planes": 1, "grouped_conv3x3": 0,
                   "linear": 100}
SERVER_BATCH = 8


def launches_per(per_program, dispatches):
    return {name: n * dispatches for name, n in per_program.items()}


def direct_u8(est, frames, batch):
    """The frame program on ``frames`` in batches of ``batch``, the last one
    padded with its last frame: each frame's u8 map, and a function giving
    the f32 maps of the same batches (for the u8 rule). A server's rows are
    computed independently of the other rows of their batch, so a frame's
    result at one batch shape does not depend on its neighbours."""
    hw = frames[0].shape[:2]

    def run(output):
        out = []
        for i in range(0, len(frames), batch):
            chunk = list(frames[i:i + batch])
            chunk += [chunk[-1]] * (batch - len(chunk))
            out.append(est._batched_fn(hw, output)(np.stack(chunk)).cpu().numpy()[:len(frames[i:i + batch])])
        return np.concatenate(out)

    return run("u8"), lambda: run("f32")


def check_u8_results(got, frames, est, batch, phase):
    """Each result equal to the direct program's bytes; where not, only where
    the f32 map lies within 1e-3 of an integer (the port's u8 rule). Returns
    the count of bytes that differ."""
    want, f32 = direct_u8(est, frames, batch)
    got = np.stack(got)
    check(got.shape == want.shape and got.dtype == np.uint8, f"{phase}: results {got.shape} {got.dtype}")
    differ = got != want
    if differ.any():
        maps = f32()
        away = int((differ & (np.abs(maps - np.round(maps)) >= 1e-3)).sum())
        check(away == 0, f"{phase}: {away} bytes differ from the direct program away from an integer")
    return int(differ.sum())


def client_threads(submit, groups):
    """One client thread for each list of frames in ``groups``, all started
    together, each submitting its frames at once and then waiting: results
    in the order of ``groups``' frames, submit→result seconds of each
    request, and the wall from the first submit to the last result."""
    import threading

    results = [[None] * len(g) for g in groups]
    spans, errors = [], []
    start = threading.Barrier(len(groups))
    lock = threading.Lock()

    def client(k):
        try:
            start.wait()
            futs = []
            for frame in groups[k]:
                t_submit = time.perf_counter()

                def stamp(_fut, t=t_submit):
                    with lock:
                        spans.append((t, time.perf_counter()))

                fut = submit(frame)
                fut.add_done_callback(stamp)
                futs.append(fut)
            for i, fut in enumerate(futs):
                results[k][i] = fut.result(timeout=300)
        except Exception as e:  # raised in the main thread below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(len(groups))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a client thread did not finish")
    if errors:
        raise errors[0]
    lat = sorted(b - a for a, b in spans)
    wall = max(b for _, b in spans) - min(a for a, _ in spans)
    return results, lat, wall


def pct(xs, q):
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def serving_frames(n, hw, offset=0):
    """``n`` distinct synthetic frames of ``hw`` from frame ``offset`` on."""
    from depth_estimation_tpu_torch.runtime.video import SyntheticSource

    src = SyntheticSource(offset + n, *hw)
    return [src.read()[1] for _ in range(offset + n)][offset:]


def run_server(est, phase="server", clients=4, per_client=8):
    """``DepthServer(est, (480, 640), max_batch=8, max_delay_ms=5)``, warmed
    once at its batch, then ``clients`` threads of ``per_client`` requests:
    each result equal to the direct program (``direct_u8``); frames served,
    fewer dispatches than requests, launches a dispatch DPT_PER_PROGRAM;
    requests/s and the p50/p90 of submit→result."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.server import DepthServer

    t_phase = time.perf_counter()
    frames = serving_frames(clients * per_client, (480, 640))
    srv = DepthServer(est, (480, 640), max_batch=SERVER_BATCH, max_delay_ms=5)
    srv.warm()
    torch.cuda.synchronize()
    b0, f0 = srv.batches_dispatched, srv.frames_served
    kernels.reset_launch_counts()
    groups = [frames[k * per_client:(k + 1) * per_client] for k in range(clients)]
    results, lat, wall = client_threads(srv.submit, groups)
    srv.close()
    counts = kernels.launch_counts()
    n = clients * per_client
    dispatches, served = srv.batches_dispatched - b0, srv.frames_served - f0
    check(served == n and dispatches < n, f"{phase}: {served} frames served in {dispatches} dispatches")
    check(counts == launches_per(DPT_PER_PROGRAM, dispatches), f"{phase}: launch counts {counts} over {dispatches}")
    differ = check_u8_results([r for g in results for r in g], frames, est, SERVER_BATCH, phase)
    emit(phase, model=est.model_type, src_hw=[480, 640], max_batch=SERVER_BATCH, max_delay_ms=5, clients=clients,
         requests=n, dispatches=dispatches, requests_per_s=n / wall, p50_ms=pct(lat, 0.5) * 1e3,
         p90_ms=pct(lat, 0.9) * 1e3, wall_s=wall, launches=counts, bytes_differ_from_direct=differ,
         seconds=time.perf_counter() - t_phase)
    return counts


def server_hold(est, cpu_est, phase="server_hold"):
    """``DepthServer(output="f32")`` at 240×320 against the same weights
    through the plain paths on the CPU: max abs-rel < 1e-3."""
    from depth_estimation_tpu_torch.runtime.server import DepthServer

    t_phase = time.perf_counter()
    frame = serving_frames(1, (240, 320), offset=3)[0]
    with DepthServer(est, (240, 320), max_batch=SERVER_BATCH, max_delay_ms=5, output="f32") as srv:
        gpu = srv.submit(frame).result(timeout=300)
    cpu = cpu_est.predict(frame)
    scale = float(np.abs(cpu).max())
    rel = float(np.abs(gpu - cpu).max()) / scale
    check(gpu.shape == cpu.shape == (240, 320) and gpu.dtype == np.float32, f"{phase}: {gpu.shape} {gpu.dtype}")
    check(np.isfinite(gpu).all() and scale > 0 and rel < 1e-3, f"{phase}: gpu vs cpu max abs-rel {rel}")
    emit(phase, model=est.model_type, src_hw=[240, 320], max_batch=SERVER_BATCH, max_abs_rel=rel, depth_max=scale,
         seconds=time.perf_counter() - t_phase)


def run_bucketed_server(est, phase="bucketed_server", per_client=8):
    """``BucketedDepthServer(est, max_batch=8, max_buckets=2)`` with both
    buckets warmed, then four client threads at once, two of 480×640 frames
    and two of 240×320, so both dispatcher threads run frame programs
    together: every result equal to the direct program (the phase that
    shows a numerics flag changed under a running program), each bucket's
    stats, launches over all dispatches, and a third size refused."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.server import BucketedDepthServer

    t_phase = time.perf_counter()
    sizes = {(480, 640): serving_frames(2 * per_client, (480, 640), offset=2),
             (240, 320): serving_frames(2 * per_client, (240, 320))}
    srv = BucketedDepthServer(est, max_batch=SERVER_BATCH, max_delay_ms=5, max_buckets=2)
    for hw in sizes:
        srv.warm(hw)
    torch.cuda.synchronize()
    before = srv.stats
    kernels.reset_launch_counts()
    groups = [f[k * per_client:(k + 1) * per_client] for k in range(2) for f in sizes.values()]
    results, lat, wall = client_threads(srv.submit, groups)
    try:
        srv.submit(np.zeros((120, 160, 3), np.uint8))
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "max_buckets" in refused, f"{phase}: a third size was not refused")
    srv.close()
    counts = kernels.launch_counts()
    stats = {hw: (b - before[hw][0], f - before[hw][1]) for hw, (b, f) in srv.stats.items()}
    check(set(stats) == set(sizes) and all(f == 2 * per_client and b < f for b, f in stats.values()),
          f"{phase}: bucket stats {stats}")
    dispatches = sum(b for b, _ in stats.values())
    check(counts == launches_per(DPT_PER_PROGRAM, dispatches), f"{phase}: launch counts {counts} over {dispatches}")
    differ = {}
    for j, (hw, frames) in enumerate(sizes.items()):
        got = [r for k in (j, j + 2) for r in results[k]]
        differ[f"{hw[0]}x{hw[1]}"] = check_u8_results(got, frames, est, SERVER_BATCH, phase)
    emit(phase, model=est.model_type, max_batch=SERVER_BATCH, clients=len(groups),
         stats={f"{h}x{w}": {"dispatches": b, "frames": f} for (h, w), (b, f) in stats.items()},
         requests_per_s=4 * per_client / wall, p50_ms=pct(lat, 0.5) * 1e3, p90_ms=pct(lat, 0.9) * 1e3,
         launches=counts, bytes_differ_from_direct=differ, third_size_refused=refused[:80],
         seconds=time.perf_counter() - t_phase)


def run_fused_server(est, weights, phase="fused_server", clients=3, per_client=4, batch=4):
    """``FusedDepthServer(est, det, (480, 640), max_batch=4)`` warmed, then
    ``clients`` threads of ``per_client`` requests: each dict equal, key for
    key, to ``FusedFrameRunner(est, det, emit_depth_map=False).batched`` on
    batches of 4 of the same frames (no ``depth`` key); launches a dispatch
    FUSED_PER_PROGRAM."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.fused import FusedFrameRunner
    from depth_estimation_tpu_torch.runtime.server import FusedDepthServer
    from depth_estimation_tpu_torch.runtime.stream import FusedFetch

    t_phase = time.perf_counter()
    det = make_detector(weights)
    n = clients * per_client
    frames = serving_frames(n, (480, 640))
    srv = FusedDepthServer(est, det, (480, 640), max_batch=batch, max_delay_ms=5)
    srv.warm()
    torch.cuda.synchronize()
    b0, f0 = srv.batches_dispatched, srv.frames_served
    kernels.reset_launch_counts()
    results, lat, wall = client_threads(srv.submit, [frames[k * per_client:(k + 1) * per_client]
                                                     for k in range(clients)])
    srv.close()
    counts = kernels.launch_counts()
    dispatches, served = srv.batches_dispatched - b0, srv.frames_served - f0
    check(served == n and dispatches < n, f"{phase}: {served} frames served in {dispatches} dispatches")
    check(counts == launches_per(FUSED_PER_PROGRAM, dispatches), f"{phase}: launch counts {counts} over {dispatches}")
    got = [r for g in results for r in g]
    runner = FusedFrameRunner(est, det, emit_depth_map=False)
    want = [d for i in range(0, n, batch) for d in FusedFetch(runner.batched(np.stack(frames[i:i + batch]))).result()]
    for i, (g, w) in enumerate(zip(got, want)):
        check(set(g) == set(w) and "depth" not in g and g["vis_u8"].dtype == np.uint8,
              f"{phase}: request {i} keys {sorted(g)}")
        bad = [k for k in w if not np.array_equal(g[k], w[k])]
        check(not bad, f"{phase}: request {i} differs from the direct program in {bad}")
    emit(phase, model=est.model_type, src_hw=[480, 640], max_batch=batch, clients=clients, requests=n,
         dispatches=dispatches, hits=int(sum(bool(g["valid"][0]) for g in got)), requests_per_s=n / wall,
         p50_ms=pct(lat, 0.5) * 1e3, p90_ms=pct(lat, 0.9) * 1e3, launches=counts, keys=sorted(got[0]),
         seconds=time.perf_counter() - t_phase)
    return counts


def drive_fleet(est, fleet, M):
    """JAX tests/test_multistream.py's reference loop on the port's frame
    program for a uniform fleet (lists of frames): per stream, its frames'
    expected outputs in order."""
    from depth_estimation_tpu_torch.ops.postprocess import merge_gray3

    hw = fleet[0][0].shape[:2]
    fn = est._batched_fn(hw, output="u8")
    expected = [[] for _ in fleet]
    for t in range(0, max(len(f) for f in fleet), M):
        batch = np.zeros((len(fleet) * M, *hw, 3), np.uint8)
        valid = []
        for i, frames in enumerate(fleet):
            got = frames[t:t + M]
            for j, f in enumerate(got):
                batch[i * M + j] = f
            if 0 < len(got) < M:
                batch[i * M + len(got):(i + 1) * M] = got[-1]
            valid.append(len(got))
        preds = fn(batch).cpu().numpy()
        for i, m in enumerate(valid):
            expected[i].extend(merge_gray3(preds[i * M + j]) for j in range(m))
    return expected


def run_multistream(est, M, phase="multistream"):
    """``MultiStream(est, …)`` over three 8-frame 480×640 streams (distinct
    frames: each from its own offset into the synthetic sequence) and one
    5-frame 240×320 stream, after a set-up program of each bucket's batch:
    every stream's frames equal to a direct reference loop of the frame
    program, launches a dispatch DPT_PER_PROGRAM (a bucket dispatches while
    one of its streams is live), ticks and frames/s."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.runtime.multistream import MultiStream
    from depth_estimation_tpu_torch.runtime.video import FrameSink, FrameSource

    class Collect(FrameSink):
        def __init__(self):
            self.frames = []

        def write(self, frame):
            self.frames.append(frame.copy())

    class Frames(FrameSource):
        def __init__(self, frames):
            self._frames, self.height, self.width = list(frames), *frames[0].shape[:2]
            self.frame_count = float(len(frames))

        def read(self):
            return (True, self._frames.pop(0)) if self._frames else (False, None)

        def is_opened(self):
            return True

    t_phase = time.perf_counter()
    fleets = {(480, 640): [serving_frames(8, (480, 640), offset=5 * k) for k in range(3)],
              (240, 320): [serving_frames(5, (240, 320))]}
    for hw, fleet in fleets.items():  # set-up (cuDNN's choice) at each bucket's batch
        est._batched_fn(hw, "u8")(np.zeros((len(fleet) * M, *hw, 3), np.uint8))
    streams = [f for fleet in fleets.values() for f in fleet]
    sinks = [Collect() for _ in streams]
    ms = MultiStream(est, [Frames(f) for f in streams], sinks, verbose=False, microbatch=M)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ms.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ticks = len(ms.timer.performance["depth"])
    dispatches = sum(math.ceil(max(len(f) for f in fleet) / M) for fleet in fleets.values())
    check(ms.counts == [len(f) for f in streams], f"{phase}: counts {ms.counts}")
    check(ticks == math.ceil(8 / M), f"{phase}: {ticks} ticks")
    check(counts == launches_per(DPT_PER_PROGRAM, dispatches), f"{phase}: launch counts {counts} over {dispatches}")
    expected = [e for fleet in fleets.values() for e in drive_fleet(est, fleet, M)]
    for k, (sink, exp) in enumerate(zip(sinks, expected)):
        check(len(sink.frames) == len(exp) and all(np.array_equal(g, e) for g, e in zip(sink.frames, exp)),
              f"{phase}: stream {k} differs from the direct reference loop")
    frames = sum(ms.counts)
    emit(phase, model=est.model_type, microbatch=M, streams={f"{h}x{w}": len(f) for (h, w), f in fleets.items()},
         frames=frames, ticks=ticks, dispatches=dispatches, frames_per_s=frames / wall, wall_s=wall,
         ms_per_tick=wall / ticks * 1e3, launches=counts, seconds=time.perf_counter() - t_phase)
    return counts


def run_serve_cli(tmp, phase="serve_cli"):
    """``tools.serve.main`` in this process on DPT_Large (its own random
    weights from seed 0): in MultiStream mode over two 8-frame 480×640
    streams into .avi files, and ``--online`` over a 480×640 and a 240×320
    stream; the lines JAX's ``depth-serve`` prints, and launches whole
    programs (K1 24, K2 1, K3 1 each)."""
    import contextlib
    import io
    import warnings

    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.tools import serve

    runs = {"multistream": ["--src", "synthetic:8x480x640", "--src", "synthetic:8x480x640",
                            "--output", os.path.join(tmp, "serve_a.avi"), "--output", os.path.join(tmp, "serve_b.avi")],
            "online": ["--src", "synthetic:8x480x640", "--src", "synthetic:6x240x320", "--online"]}
    want = {"multistream": "Sucessfully read 16 frames over 2 streams.",
            "online": "Sucessfully read 14 frames over 2 streams."}
    row = {}
    for mode, argv in runs.items():
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        buf = io.StringIO()
        with warnings.catch_warnings(), contextlib.redirect_stdout(buf):
            warnings.simplefilter("ignore")
            serve.main(["--model-type", "DPT_Large", *argv])
        torch.cuda.synchronize()
        lines = buf.getvalue().splitlines()
        counts = kernels.launch_counts()
        programs = counts["multi_head_attention"] // DPT_PER_PROGRAM["multi_head_attention"]
        check(want[mode] in lines, f"{phase} {mode}: no line {want[mode]!r} in {lines[-3:]}")
        check(programs > 0 and counts == launches_per(DPT_PER_PROGRAM, programs),
              f"{phase} {mode}: launch counts {counts}")
        if mode == "online":
            check(any(ln.startswith("Online: 14 requests in ") and "across 2 resolution bucket(s)" in ln
                      for ln in lines), f"{phase}: no Online line in {lines[-3:]}")
        else:
            check(all(os.path.getsize(os.path.join(tmp, f"serve_{x}.avi")) > 0 for x in "ab"), f"{phase}: empty .avi")
        row[mode] = {"lines": [ln for ln in lines if not ln.startswith("Tick:")], "programs": programs,
                     "seconds": time.perf_counter() - t0}
    emit(phase, **row)


# -- training, evaluation and checkpoints --------------------------------------

TRAIN_PER_STEP = {"multi_head_attention": 24, "fused_preprocess": 1, "resize_planes": 1, "grouped_conv3x3": 0,
                  "linear": 100}


def grads_of(fn, inputs, upstream):
    """The gradients of (fn(*inputs) · upstream).sum() for fresh leaf copies of ``inputs``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, upstream)


def backward_ms(fn, inputs, upstream):
    """Device ms of the backward alone: one forward, then the backward timed with a kept graph."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return time_ms(lambda: torch.autograd.grad(out, leaves, upstream, retain_graph=True), reps=10, inner=5)


def compare_grads(name, got, want, atol, rtol):
    errs = []
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        check(torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol),
              f"{name} gradient {tuple(g.shape)}: max abs err {err} over atol {atol} rtol {rtol}")
        errs.append(err)
    return max(errs)


def check_kernel_grads(gen):
    """Each kernel's autograd Function on the card against autograd of its
    plain version (the JAX package's XLA form, which XLA differentiates):
    K1 f32 at DPT_Large's training shape, K3 f32 from 288×384 to 240×320 at
    batch 2, K4 f32 at the four MiDaS conv2 shapes; the backward's device ms
    beside the forward's. Each forward and each K4 dX is one counted launch."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.ops.kernels import attention as tatt
    from depth_estimation_tpu_torch.ops.kernels import grouped_conv as tgc
    from depth_estimation_tpu_torch.ops.kernels import resize as trsz

    rows = {}
    kernels.reset_launch_counts()
    # K1: q, k, v as strided views of one fused projection, as the ViT gives them
    qkv = torch.randn((2, 577, 3, 16, 64), generator=gen, device="cuda")
    do = torch.randn((2, 16, 577, 64), generator=gen, device="cuda")
    views = lambda f: lambda t: f(*t.permute(2, 0, 3, 1, 4))  # noqa: E731
    err = compare_grads("attention", grads_of(views(tatt.multi_head_attention), [qkv], do),
                        grads_of(views(tatt.attention_plain), [qkv], do), 2e-5, 1e-4)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    rows["multi_head_attention"] = {
        "shape": [2, 16, 577, 64], "max_abs_err": err, "atol": 2e-5, "rtol": 1e-4,
        "ms": time_ms(lambda: tatt.multi_head_attention(q, k, v)),
        "bwd_ms": backward_ms(views(tatt.multi_head_attention), [qkv], do),
        "plain_bwd_ms": backward_ms(views(tatt.attention_plain), [qkv], do),
        "library_bwd_ms": backward_ms(views(F.scaled_dot_product_attention), [qkv], do)}
    # K3: the train step's resize of the 288×384 prediction back to 240×320
    x = torch.rand((2, 288, 384), generator=gen, device="cuda")
    g = torch.rand((2, 240, 320), generator=gen, device="cuda")
    fwd = lambda t: trsz.resize_planes(t, (240, 320))  # noqa: E731
    plain = lambda t: trsz.resize_planes_plain(t, (240, 320))  # noqa: E731
    err = compare_grads("resize", grads_of(fwd, [x], g), grads_of(plain, [x], g), 3e-5, 1e-5)
    rows["resize_planes"] = {"in": [2, 288, 384], "out": [2, 240, 320], "max_abs_err": err, "atol": 3e-5,
                             "rtol": 1e-5, "ms": time_ms(lambda: fwd(x)), "bwd_ms": backward_ms(fwd, [x], g),
                             "plain_bwd_ms": backward_ms(plain, [x], g)}
    # K4: dX is a K4 launch on the transposed, flipped weight; dW the plain im2col product
    k4 = {}
    for layer, (c, h, w) in MIDAS_CONV2_SHAPES.items():
        xg = torch.randn((1, c, h, w), generator=gen, device="cuda")
        wg = torch.randn((c, c // 32, 3, 3), generator=gen, device="cuda") / math.sqrt(9 * c // 32)
        dy = torch.randn((1, c, h, w), generator=gen, device="cuda")
        fwd = lambda a, b: tgc.grouped_conv3x3(a, b, 32)  # noqa: E731
        plain = lambda a, b: tgc.grouped_conv3x3_plain(a, b, 32)  # noqa: E731
        err = compare_grads(f"grouped conv {layer}", grads_of(fwd, [xg, wg], dy), grads_of(plain, [xg, wg], dy),
                            1e-4, 1e-4)
        wt = tgc.transposed_weight(wg, 32)
        k4[layer] = {"shape": [1, c, h, w], "max_abs_err": err, "atol": 1e-4, "rtol": 1e-4,
                     "ms": time_ms(lambda: fwd(xg, wg)), "bwd_ms": backward_ms(fwd, [xg, wg], dy),
                     "dx_ms": time_ms(lambda: tgc._launch(dy, wt, 32)),
                     "dw_ms": time_ms(lambda: tgc.weight_grad_plain(xg, dy, 32)),
                     "library_dw_ms": time_ms(
                         lambda: torch.nn.grad.conv2d_weight(xg, wg.shape, dy, padding=1, groups=32)),
                     "plain_bwd_ms": backward_ms(plain, [xg, wg], dy)}
    rows["grouped_conv3x3"] = {"per_layer": k4, **k4["layer3"]}
    emit("kernel_grad", **rows)
    return rows


def train_models(est, device):
    """A fresh copy of ``est``'s weights on ``device`` and the train step over u8 batches."""
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.train.data import TrainingApply
    from depth_estimation_tpu_torch.train.step import make_optimizer, make_train_step

    copy = DepthEstimator(est.model_type, params={k: v.cpu() for k, v in est.model.state_dict().items()},
                          device=device, verbose=False)
    return copy.model, make_train_step(TrainingApply(copy.model, copy.preprocess_cfg), make_optimizer(copy.model))


def train_hold(est, batch, src_hw, per_step, tensor_tol, phase="train_hold"):
    """One train step (K2 → the network → K3, SSI + 0.5 · gradient matching,
    AdamW) on the card and the same step on the CPU's plain path from the
    same weights and u8 batch, and the step's float64 gradient on the CPU
    (``float64_gradients``): the loss within 1e-3 abs-rel of the CPU's; the
    gradient, all trainable tensors as one vector, within 1e-3 of the CPU's
    largest value (the accuracy gate's max-scaled form); every tensor's
    gradient within ``tensor_tol`` of its own largest float64 value from the
    float64 gradient, and a tensor whose float64 gradient is all zero all
    zero on the card; the step's launches ``per_step``. Per tensor no f32
    implementation meets 1e-3 on these random weights: against float64 the
    card, the CPU and ATen's own CUDA convolutions land some tensors up to
    1.8e-3 (DPT_Large) and 7.4e-3 (MiDaS) off, while TF32, a control, lands
    9.1e-3 and 9.6e-2 (tools/train_grad_precision.py); ``tensor_tol`` lies
    between. The CPU runs PyTorch's defaults (oneDNN on; off, ATen's CPU
    convolutions land MiDaS 3.8e-2 per tensor and 1.4e-3 max-scaled off)."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.train.data import TrainingApply, batches, synthetic_pairs
    from depth_estimation_tpu_torch.train.step import float64_gradients, trainable_tensors

    (imgs, gt), = list(batches(synthetic_pairs(batch, *src_hw, seed=3), batch, shuffle=False))
    imgs, gt = torch.from_numpy(imgs), torch.from_numpy(gt)
    results = {}
    for device in ("cuda", "cpu"):
        model, step = train_models(est, device)
        if device == "cpu":
            t0 = time.perf_counter()
            loss64, grads64 = float64_gradients(TrainingApply(model, est.preprocess_cfg), imgs, gt)
            f64_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(step(imgs.to(device), gt.to(device)))
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        grads = {k: t.grad.detach().double().cpu() for k, t in trainable_tensors(model).items()}
        results[device] = (loss, grads, counts, seconds)
        del model, step
        torch.cuda.empty_cache()
    (loss_g, grads_g, counts, gpu_s), (loss_c, grads_c, cpu_counts, cpu_s) = results["cuda"], results["cpu"]
    check(counts == per_step, f"{phase}: launch counts {counts} != {per_step}")
    check(sum(cpu_counts.values()) == 0, f"{phase}: the CPU step launched kernels {cpu_counts}")
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    check(math.isfinite(loss_g) and loss_rel < 1e-3, f"{phase}: loss {loss_g} vs cpu {loss_c}, abs-rel {loss_rel}")
    check(sorted(grads_g) == sorted(grads_c) == sorted(grads64), f"{phase}: trainable tensors differ")
    top = max(float(g.abs().max()) for g in grads_c.values())
    check(top > 0 and all(torch.isfinite(g).all() for g in grads_g.values()), f"{phase}: gradients zero or not finite")
    diff = {k: float((grads_g[k] - gc).abs().max()) for k, gc in grads_c.items()}
    worst = max(diff, key=diff.get)

    def own_scaled(grads):  # each tensor's max |g − g64| over its own max |g64|
        return {k: float((grads[k] - g64).abs().max()) / float(g64.abs().max())
                for k, g64 in grads64.items() if g64.abs().max() > 0}

    own_card, own_cpu = own_scaled(grads_g), own_scaled(grads_c)
    zeros = sorted(k for k, g64 in grads64.items() if g64.abs().max() == 0)
    for k in zeros:
        check(grads_g[k].abs().max() == 0, f"{phase}: {k} has no float64 gradient but has one on the card")
    tail = lambda own: {k: own[k] for k in sorted(own, key=own.get)[-5:]}  # noqa: E731
    emit(phase, model=est.model_type, batch=batch, src_hw=list(src_hw), loss=loss_g, cpu_loss=loss_c,
         float64_loss=loss64, loss_abs_rel=loss_rel, tensors=len(diff), zero_in_float64=zeros,
         max_scaled=diff[worst] / top, worst=worst, largest_grad=top, tensor_tol=tensor_tol,
         card_own_scaled_worst=tail(own_card), cpu_own_scaled_worst=tail(own_cpu),
         card_own_scaled_over_1e3=sum(v >= 1e-3 for v in own_card.values()),
         cpu_own_scaled_over_1e3=sum(v >= 1e-3 for v in own_cpu.values()), launches=counts,
         first_step_s_card=gpu_s, cpu_step_s=cpu_s, float64_s=f64_s)
    check(diff[worst] / top < 1e-3, f"{phase}: gradient of {worst} off the CPU's by {diff[worst] / top} (max-scaled)")
    card_worst = max(own_card, key=own_card.get)
    check(own_card[card_worst] < tensor_tol,
          f"{phase}: gradient of {card_worst} {own_card[card_worst]} of its own max from float64 (over {tensor_tol})")
    return counts


def live_head(est, imgs):
    """``est``'s weights with the bias of its head's last convolution raised
    so that on ``imgs`` every pre-activation of the non-negative output
    lies at least their standard deviation above 0. The random DPT_Large
    outputs zero at a third of its pixels, and the first AdamW steps (each
    tensor moved by about lr·sign(g)) drive the rest below 0 too: the
    output is all zero from step 2 on, each loss a function of its batch
    alone. Raised, it stays above 0 through 8 steps at lr 1e-4."""
    from depth_estimation_tpu_torch.train.data import TrainingApply

    seen = []
    last = est.model.scratch.output_conv[4]
    hook = last.register_forward_hook(lambda mod, args, out: seen.append(out.detach()))
    try:
        with torch.no_grad():
            TrainingApply(est.model, est.preprocess_cfg)(imgs)
    finally:
        hook.remove()
    pre = seen[0]
    sd = {k: v.detach().cpu().clone() for k, v in est.model.state_dict().items()}
    sd["scratch.output_conv.4.bias"] += float(pre.std() - pre.min())
    return sd


def run_train(est, phase="train", batch=2, src_hw=(240, 320), steps=8, ckpt_every=4, timed_steps=5):
    """``fit`` of DPT_Large on the card over u8 ``synthetic_pairs`` batches
    (4 a pass, so a resumed run sees the batches the run it resumes saw),
    from ``live_head``'s weights: 8 straight steps (launches K1 24, K2 1, K3
    1 a step; the output not zero, and steps 2 and 6, one batch, at other
    losses); then 4 steps with a checkpoint at step 4, whose restored
    tensors and moments equal the saved ones bit for bit. From that state
    the same optimizer continues 4 steps in memory, and ``fit`` resumes from
    the file to step 8. Their first two losses, which the restored weights
    (step 5) and moments and step counts (step 6) decide, lie within
    1e-4 relative, all four within 1e-3. The step is deterministic on the
    card (cuDNN's deterministic algorithms, the upsampling's matrix
    backward), so the two runs should agree bit for bit; before that, atomic
    adds amplified by the random net's AdamW steps put them up to 3.2e-3
    apart by step 8 (``tools/train_determinism.py``). As a control, a run resumed from
    the file with its AdamW moments zeroed must miss 1e-4 (it missed by
    0.30 at step 6). Then ms per step (CUDA events,
    ``timed_steps`` steps after the runs), images/s and the peak memory of
    the steps."""
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.train.data import TrainingApply, batches, device_prefetch, synthetic_pairs
    from depth_estimation_tpu_torch.train.loop import fit
    from depth_estimation_tpu_torch.train.step import TrainState, make_optimizer, make_train_step
    from depth_estimation_tpu_torch.utils.checkpoint import load_train_state

    resume_tol, drift_tol = 1e-4, 1e-3
    t_phase = time.perf_counter()
    data = device_prefetch(batches(synthetic_pairs(4 * batch, *src_hw, seed=1), batch), device="cuda")
    first = next(iter(data))[0]
    weights = live_head(est, first)

    def model():
        return TrainingApply(DepthEstimator(est.model_type, params=weights, device="cuda", verbose=False).model,
                             est.preprocess_cfg)

    def resumed_run(ckpt):
        state, hist = fit(model(), data, steps=steps, ckpt_dir=ckpt, ckpt_every=steps, log_every=1,
                          verbose=False, device="cuda")
        check(state.step == steps and [s for s, _ in hist] == list(range(ckpt_every + 1, steps + 1)),
              f"{phase}: resumed history {hist}")
        del state
        torch.cuda.empty_cache()
        return [loss for _, loss in hist]

    kernels.reset_launch_counts()
    straight, hist_a = fit(model(), data, steps=steps, log_every=1, verbose=False, device="cuda")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts == launches_per(TRAIN_PER_STEP, steps), f"{phase}: launch counts {counts}")
    check(all(math.isfinite(l) for _, l in hist_a), f"{phase}: losses {hist_a}")
    with torch.no_grad():
        nonzero = float((straight.model(first) != 0).float().mean())
    check(nonzero > 0.5 and hist_a[1][1] != hist_a[5][1],
          f"{phase}: the trained output is {nonzero} non-zero, losses {hist_a}: the net died")
    with tempfile.TemporaryDirectory() as ckpt, tempfile.TemporaryDirectory() as bad:
        t0 = time.perf_counter()
        half, _ = fit(model(), data, steps=ckpt_every, ckpt_dir=ckpt, ckpt_every=ckpt_every, verbose=False,
                      device="cuda")
        torch.cuda.synchronize()
        half_s = time.perf_counter() - t0
        state_file = os.path.join(ckpt, "state")
        fresh = model()
        t0 = time.perf_counter()
        restored = load_train_state(state_file, TrainState(fresh, make_optimizer(fresh)))
        load_s = time.perf_counter() - t0
        check(restored.step == ckpt_every, f"{phase}: restored step {restored.step}")
        saved, back = half.model.state_dict(), restored.model.state_dict()
        check(all(torch.equal(saved[k], back[k]) for k in saved), f"{phase}: restored tensors differ")
        for sa, sb in zip(half.optimizer.state.values(), restored.optimizer.state.values()):
            check(all(torch.equal(sa[m], sb[m]) for m in ("exp_avg", "exp_avg_sq", "step")),
                  f"{phase}: restored optimizer state differs")
        del fresh, restored, saved, back
        zeroed = torch.load(state_file, map_location="cpu", weights_only=True)
        for st in zeroed["optimizer"]["state"].values():
            st["exp_avg"].zero_()
            st["exp_avg_sq"].zero_()
        torch.save(zeroed, os.path.join(bad, "state"))
        del zeroed
        step = make_train_step(half.model, half.optimizer)
        continued = [float(step(imgs, gt)) for _, (imgs, gt) in zip(range(steps - ckpt_every), data)]
        del half, step
        torch.cuda.empty_cache()
        resumed = resumed_run(ckpt)
        ckpt_bytes = os.path.getsize(state_file)
        control = resumed_run(bad)
    rel = lambda got, n=2: max(abs(a - b) / abs(b) for a, b in zip(got[:n], continued))  # noqa: E731
    resumed_rel, drift, control_rel = rel(resumed), rel(resumed, steps), rel(control)
    # ms per step on the card, inputs already there, after the runs' set-up
    step = make_train_step(straight.model, straight.optimizer)
    imgs, gt = next(iter(data))
    step(imgs, gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(timed_steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(imgs, gt)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    emit(phase, model=est.model_type, batch=batch, src_hw=list(src_hw), steps=steps, losses=hist_a,
         trained_output_nonzero_share=nonzero, continued_losses=continued, resumed_losses=resumed,
         resumed_first_two_max_rel=resumed_rel, resumed_max_rel=drift, control_zeroed_moments_losses=control,
         control_first_two_max_rel=control_rel, resume_tol=resume_tol, drift_tol=drift_tol, launches=counts,
         ms_per_step=ms, step_ms=times, images_per_s=batch / ms * 1e3,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), checkpoint_bytes=ckpt_bytes, checkpoint_run_s=half_s,
         checkpoint_load_s=load_s, seconds=time.perf_counter() - t_phase)
    check(resumed_rel < resume_tol and drift < drift_tol,
          f"{phase}: resumed losses {resumed} vs continued {continued}, max rel {resumed_rel} (first two), {drift}")
    check(control_rel >= resume_tol, f"{phase}: zeroed moments resumed within {resume_tol}: {control} vs {continued}")
    del straight, step
    torch.cuda.empty_cache()
    return counts


def run_evaluate(tmp, phase="evaluate", model_type="MiDaS_small"):
    """``tools.evaluate`` on the card and with ``--device cpu`` on one weight
    cache, filled through ``tools.import_weights`` from a .pt of random
    weights under a temporary ``DEPTH_ESTIMATION_TPU_TORCH_CACHE`` (no later
    phase or run sees it): the same JSON within 1e-4 (of the value where it
    is over 1). The card's run launches K2 and K3 once a batch."""
    import contextlib
    import io

    from depth_estimation_tpu_torch.estimator import random_state_dict
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.registry import get_entry
    from depth_estimation_tpu_torch.tools import evaluate, import_weights
    from depth_estimation_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    saved_env = os.environ.get(checkpoint.CACHE_ENV)
    os.environ[checkpoint.CACHE_ENV] = os.path.join(tmp, "cache")
    try:
        with torch.device("meta"):
            shapes = get_entry(model_type).make_model()
        pt = os.path.join(tmp, f"{model_type}.pt")
        torch.save(random_state_dict(shapes, seed=0), pt)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            check(import_weights.main([pt, model_type]) == 0, f"{phase}: import_weights failed")
        lines = {}
        for device in ("cuda", "cpu"):
            kernels.reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(evaluate.main(["--synthetic", "8", "--hw", "192", "256", "--model-type", model_type,
                                     "--device", device]) == 0, f"{phase}: evaluate --device {device} failed")
            lines[device] = (json.loads(buf.getvalue().strip().splitlines()[-1]), kernels.launch_counts())
    finally:
        if saved_env is None:
            os.environ.pop(checkpoint.CACHE_ENV)
        else:
            os.environ[checkpoint.CACHE_ENV] = saved_env
    (gpu, counts), (cpu, _) = lines["cuda"], lines["cpu"]
    check(counts == {"multi_head_attention": 0, "fused_preprocess": 1, "resize_planes": 1, "grouped_conv3x3": 0,
                     "linear": 0},
          f"{phase}: launch counts {counts}")
    check(set(gpu) == set(cpu) and gpu["images"] == 8, f"{phase}: {gpu} vs {cpu}")
    diffs = {k: abs(gpu[k] - v) / max(1.0, abs(v)) for k, v in cpu.items() if isinstance(v, float)}
    check(max(diffs.values()) <= 1e-4 and all(math.isfinite(gpu[k]) for k in diffs),
          f"{phase}: card {gpu} vs cpu {cpu}")
    emit(phase, model=model_type, imported=out.getvalue().strip(), card=gpu, cpu=cpu, max_diff=max(diffs.values()),
         launches=counts, seconds=time.perf_counter() - t0)


EXPORT_FRAMES = 4
MIDAS_PER_PROGRAM = {"multi_head_attention": 0, "fused_preprocess": 1, "resize_planes": 1, "grouped_conv3x3": 30,
                     "linear": 0}

_LOAD_ALONE = """
import json, sys, time
import torch
import depth_estimation_tpu_torch.ops.kernels as kernels
from depth_estimation_tpu_torch.utils.export import load_frame_program

t0 = time.perf_counter()
fn = load_frame_program(sys.argv[1])
load_s = time.perf_counter() - t0
want = torch.load(sys.argv[2], map_location="cuda")
fn(want["params"], want["img"])
torch.cuda.synchronize()
kernels.reset_launch_counts()
out = fn(want["params"], want["img"])
torch.cuda.synchronize()
counts = kernels.launch_counts()
ref = want["out"]
rel = float((out - ref).abs().max() / ref.abs().max())
port = sorted(m for m in sys.modules if m.startswith("depth_estimation_tpu_torch."))
print(json.dumps({"launches": counts, "max_abs_rel": rel, "load_seconds": load_s, "modules": port,
                  "models_imported": any(m.startswith("depth_estimation_tpu_torch.models") for m in port)}))
"""


def weight_bytes(state):
    return sum(t.numel() * t.element_size() for t in state.values())


def host_ms(fn, n=8):
    """Median host ms of ``n`` calls, each waited for, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_scaled(got, want):
    got, want = (t.float().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t)).float()
                 for t in (got, want))
    return float((got - want).abs().max() / (want.abs().max() + 1e-12))


def export_case(name, export, tmp):
    """Export with ``export()``, save the archive under ``tmp`` and load it
    back from disk: (loaded program, its path, the export's seconds, archive bytes)."""
    from depth_estimation_tpu_torch.utils.export import load_frame_program

    t0 = time.perf_counter()
    blob = export()
    export_s = time.perf_counter() - t0
    path = os.path.join(tmp, f"{name}.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    return load_frame_program(path), path, export_s, len(blob)


def loaded_launches(call, per_program, phase):
    from depth_estimation_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts == per_program, f"{phase}: launches inside one loaded call {counts} != {per_program}")
    return counts, out


def run_export(est, midas, weights, tmp, phase="export"):
    """The export surface (``utils/export.py``) on the card, f32, full width:
    each program exported (``torch.export``), saved as a ``.pt2`` under
    ``tmp`` and loaded back from disk, then called. DPT_Large at 480×640:
    4 synthetic frames through the loaded and the live program (max-scaled
    1e-6, bitwise said), the first against the CPU's plain path (1e-3);
    launches inside one loaded call K1 24, K2 1, K3 1. The same at B = 4
    (launches a batch as a frame), MiDaS v2.1 (K4 30 a call), and the fused
    program on the same DPT_Large with ``detector_weights(seed=0)``: every
    field against the live fused program (floats max-scaled 1e-6, ints and
    valid equal; K1 24, K2 3, K3 1). A second seed's DPT_Large state dict
    through the artifact equals a live estimator on it. A fresh process that
    imports only torch and the operator registrations loads the DPT_Large
    artifact, runs it (launches counted there) without importing the models.
    For each case: export seconds, archive bytes against the weights' bytes,
    loaded and live host ms a call (median of 8 after a warm call).
    Returns each case's launches inside one loaded call."""
    from depth_estimation_tpu_torch.estimator import DepthEstimator, random_state_dict
    from depth_estimation_tpu_torch.runtime.fused import make_fused_iris_frame_fn
    from depth_estimation_tpu_torch.runtime.video import SyntheticSource
    from depth_estimation_tpu_torch.utils.export import export_frame_program, export_fused_program

    hw = (480, 640)
    src = SyntheticSource(EXPORT_FRAMES, *hw)
    frames = torch.from_numpy(np.stack([src.read()[1] for _ in range(EXPORT_FRAMES)])).cuda()
    params = est.params
    rows, launches = {}, {}

    # DPT_Large, one frame a call
    fn, path, export_s, size = export_case("dpt_large", lambda: export_frame_program(est, hw), tmp)
    launches["export_dpt_large"], _ = loaded_launches(lambda: fn(params, frames[0]), DPT_PER_PROGRAM, phase)
    loaded = [fn(params, frames[i]) for i in range(EXPORT_FRAMES)]
    live = [est._run(frames[i:i + 1])[0] for i in range(EXPORT_FRAMES)]
    rel = max(max_scaled(a, b) for a, b in zip(loaded, live))
    check(rel <= 1e-6, f"{phase}: loaded DPT_Large vs live max-scaled {rel} > 1e-6")
    cpu_est = DepthEstimator("DPT_Large", params={k: v.cpu() for k, v in params.items()}, device="cpu", verbose=False)
    t0 = time.perf_counter()
    cpu = cpu_est.predict(frames[0].cpu().numpy())
    cpu_s = time.perf_counter() - t0
    del cpu_est
    cpu_rel = {"loaded": max_scaled(loaded[0], cpu), "live": max_scaled(live[0], cpu)}
    check(max(cpu_rel.values()) < 1e-3 and np.isfinite(cpu).all() and np.abs(cpu).max() > 0,
          f"{phase}: DPT_Large against the CPU plain path {cpu_rel}")
    rows["dpt_large"] = {"in_hw": list(hw), "export_seconds": export_s, "archive_bytes": size,
                         "weight_bytes": weight_bytes(params), "loaded_vs_live_max_scaled": rel,
                         "bitwise": all(torch.equal(a, b) for a, b in zip(loaded, live)),
                         "vs_cpu_max_abs_rel": cpu_rel, "cpu_seconds": cpu_s,
                         "loaded_host_ms": host_ms(lambda: fn(params, frames[0])),
                         "live_host_ms": host_ms(lambda: est._run(frames[:1]))}

    # a second checkpoint of the same architecture through the same artifact
    other = {k: v.cuda() for k, v in random_state_dict(est.model, seed=1).items()}
    est1 = DepthEstimator("DPT_Large", params=other, verbose=False)
    swap = max_scaled(fn(other, frames[0]), est1._run(frames[:1])[0])
    check(swap <= 1e-6, f"{phase}: the seed-1 weights through the artifact vs a live estimator on them {swap}")
    rows["dpt_large"]["weight_swap_max_scaled"] = swap
    del est1, other

    # the same artifact in a process that imports only torch and the operators
    want = os.path.join(tmp, "dpt_large_inputs.pt")
    torch.save({"params": {k: v.cpu() for k, v in params.items()}, "img": frames[0].cpu(),
                "out": live[0].cpu()}, want)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _LOAD_ALONE, path, want], capture_output=True, text=True,
                       timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(r.returncode == 0, f"{phase}: the load-alone process failed:\n{r.stdout}\n{r.stderr[-4000:]}")
    alone = json.loads(r.stdout.strip().splitlines()[-1])
    check(not alone["models_imported"] and alone["launches"] == DPT_PER_PROGRAM and alone["max_abs_rel"] < 1e-3,
          f"{phase}: the load-alone process {alone}")
    rows["dpt_large"]["load_alone"] = {**alone, "seconds": time.perf_counter() - t0}
    os.remove(want)

    # DPT_Large at B = 4
    fn4, _, export_s, size = export_case("dpt_large_b4", lambda: export_frame_program(
        est, hw, batched=True, batch=EXPORT_FRAMES), tmp)
    launches["export_dpt_large_b4"], out4 = loaded_launches(lambda: fn4(params, frames), DPT_PER_PROGRAM, phase)
    live4 = est._run(frames)
    rel = max_scaled(out4, live4)
    check(rel <= 1e-6, f"{phase}: loaded batched DPT_Large vs live max-scaled {rel} > 1e-6")
    rows["dpt_large_b4"] = {"batch": EXPORT_FRAMES, "export_seconds": export_s, "archive_bytes": size,
                            "loaded_vs_live_max_scaled": rel, "bitwise": torch.equal(out4, live4),
                            "loaded_host_ms": host_ms(lambda: fn4(params, frames)),
                            "live_host_ms": host_ms(lambda: est._run(frames))}

    # MiDaS v2.1
    mparams = midas.params
    fnm, _, export_s, size = export_case("midas", lambda: export_frame_program(midas, hw), tmp)
    launches["export_midas"], outm = loaded_launches(lambda: fnm(mparams, frames[0]), MIDAS_PER_PROGRAM, phase)
    livem = midas._run(frames[:1])[0]
    rel = max_scaled(outm, livem)
    check(rel <= 1e-6, f"{phase}: loaded MiDaS vs live max-scaled {rel} > 1e-6")
    rows["midas"] = {"export_seconds": export_s, "archive_bytes": size, "weight_bytes": weight_bytes(mparams),
                     "loaded_vs_live_max_scaled": rel, "bitwise": torch.equal(outm, livem),
                     "loaded_host_ms": host_ms(lambda: fnm(mparams, frames[0])),
                     "live_host_ms": host_ms(lambda: midas._run(frames[:1]))}

    # the fused iris/pose + depth program on the same DPT_Large
    det = make_detector(weights)
    states = (params, det._face_det.state_dict(), det._mesh.state_dict(), det._pose.state_dict())
    pts = torch.tensor([[40, 50], [300, 200]], dtype=torch.int32, device="cuda")
    fnf, _, export_s, size = export_case("fused", lambda: export_fused_program(est, det, hw), tmp)
    launches["export_fused"], _ = loaded_launches(lambda: fnf(*states, frames[0], pts), FUSED_PER_PROGRAM, phase)
    live_fn = make_fused_iris_frame_fn(est, det, hw, include_pose=True, emit_depth_map=True)
    worst, hits = 0.0, 0
    for i in range(EXPORT_FRAMES):
        got = fnf(*states, frames[i], pts)
        want_f = {k: v[0] for k, v in live_fn(frames[i:i + 1], pts[None]).items()}
        depth = want_f.pop("depth")
        check(set(got) == set(want_f), f"{phase}: fused fields {sorted(got)} != {sorted(want_f)}")
        for k, v in want_f.items():
            if k == "vis_u8":  # bytes may part only where the map lies within 1e-3 of an integer
                near = (depth - depth.round()).abs() < 1e-3
                check(not ((got[k] != v) & ~near).any(), f"{phase}: fused vis_u8 differs away from an integer")
            elif v.dtype.is_floating_point:
                worst = max(worst, max_scaled(got[k], v))
            else:
                check(torch.equal(got[k], v), f"{phase}: fused {k} differs from the live program")
        hits += int(want_f["valid"][0])
    check(worst <= 1e-6, f"{phase}: fused floats vs live max-scaled {worst} > 1e-6")
    rows["fused"] = {"export_seconds": export_s, "archive_bytes": size,
                     "weight_bytes": sum(weight_bytes(sd) for sd in states), "floats_max_scaled": worst,
                     "frames_hit": hits, "frames": EXPORT_FRAMES,
                     "loaded_host_ms": host_ms(lambda: fnf(*states, frames[0], pts)),
                     "live_host_ms": host_ms(lambda: live_fn(frames[:1], pts[None]))}
    emit(phase, launches=launches, **rows)
    return launches


def run_export_cli(tmp, phase="export_cli"):
    """``tools.export_program.main`` for MiDaS_small at 480×640 on the card
    (random weights from seed 0: the cache is pointed at an empty
    directory): its closing line, and the written file loaded and run against
    a live estimator on the same weights (max-scaled 1e-6)."""
    import contextlib
    import io
    import warnings

    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.runtime.video import SyntheticSource
    from depth_estimation_tpu_torch.tools import export_program
    from depth_estimation_tpu_torch.utils.export import load_frame_program

    out = os.path.join(tmp, "midas_small.pt2")
    os.environ["DEPTH_ESTIMATION_TPU_TORCH_CACHE"] = os.path.join(tmp, "empty_cache")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        export_program.main(["--model-type", "MiDaS_small", "--hw", "480", "640", "--out", out])
        est = DepthEstimator("MiDaS_small", verbose=False)
    seconds = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    check(line == f"exported MiDaS_small (480, 640, 3) -> {out} ({os.path.getsize(out)} bytes)",
          f"{phase}: printed {line!r}")
    frame = SyntheticSource(1, 480, 640).read()[1]
    rel = max_scaled(load_frame_program(out)(est.params, frame), est.predict(frame))
    check(rel <= 1e-6, f"{phase}: the CLI's file vs a live MiDaS_small max-scaled {rel}")
    emit(phase, line=line, seconds=seconds, loaded_vs_live_max_scaled=rel)


def max_scaled_err(got, want):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def held(phase, path, err, tol, counts, per_call, calls=1):
    """Check one parallel path against its non-mesh counterpart and its launches; the path's row."""
    check(err <= tol, f"{phase} {path}: max-scaled error {err} over {tol}")
    check(counts == launches_per(per_call, calls), f"{phase} {path}: launch counts {counts}")
    return {"max_scaled_err": err, "tol": tol, "launches": counts}


def counted(call):
    """``call()`` and the kernels' launches during it, the counts zeroed just before."""
    from depth_estimation_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = call()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def run_parallel(est, frames8, phase="parallel", batch=2, src_hw=(240, 320)):
    """The world-of-one paths (see the module docstring, phase 17)."""
    import torch.distributed as dist

    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops.kernels.resize import fused_preprocess
    from depth_estimation_tpu_torch.parallel.mesh import make_mesh
    from depth_estimation_tpu_torch.parallel.pipeline import dpt_apply_pipelined
    from depth_estimation_tpu_torch.train.data import TrainingApply, batches, device_prefetch, synthetic_pairs
    from depth_estimation_tpu_torch.train.loop import fit

    t_phase = time.perf_counter()
    rows, per_path = {}, {}
    frames = frames8.cpu().numpy()
    midas = DepthEstimator("MiDaS", seed=0, device="cuda", verbose=False)
    # one batch a pass: a resumed fit restarts the data, and its step 2 must see the straight run's batch
    data = device_prefetch(batches(synthetic_pairs(batch, *src_hw, seed=1), batch), device="cuda")
    weights = live_head(est, next(iter(data))[0])

    def model():
        return TrainingApply(DepthEstimator(est.model_type, params=weights, device="cuda", verbose=False).model,
                             est.preprocess_cfg)

    _, plain_hist = fit(model(), data, steps=2, log_every=1, verbose=False, device="cuda")
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = make_mesh(1, device="cuda")
            want = est.predict_batch(frames)
            got, counts = counted(lambda: est.predict_batch_sharded(frames, mesh))
            rows["predict_batch_sharded"] = held(phase, "predict_batch_sharded", max_scaled_err(got, want), 1e-5,
                                                 counts, DPT_PER_PROGRAM)
            want = est.predict(frames[0])
            got, counts = counted(lambda: est.predict_sharded(frames[0], mesh))
            rows["predict_sharded"] = held(phase, "predict_sharded", max_scaled_err(got, want), 1e-5, counts,
                                           DPT_PER_PROGRAM)
            cfg = est.preprocess_cfg
            x = fused_preprocess(frames8[:2], (384, 512), cfg.mean, cfg.std)
            with torch.inference_mode(), est._numerics():
                want = est.model(x)
                got, counts = counted(lambda: dpt_apply_pipelined(est.model, x, mesh, microbatches=2))
            # the trunk runs once a microbatch (K1 24 and 96 linear layers each), the decoder once on the
            # gathered hooks (its 4 readout projections)
            rows["pipelined"] = held(phase, "pipelined", max_scaled_err(got, want), 1e-4, counts,
                                     {**DPT_PER_PROGRAM, "multi_head_attention": 2 * 24, "fused_preprocess": 0,
                                      "resize_planes": 0, "linear": 2 * 96 + READOUTS["dpt_large"]})
            want = midas.predict_batch(frames[:MICROBATCH])
            got, counts = counted(lambda: midas.predict_batch_sharded(frames[:MICROBATCH], mesh))
            rows["midas_batch_sharded"] = held(phase, "midas_batch_sharded", max_scaled_err(got, want), 1e-5,
                                               counts, MIDAS_PER_PROGRAM)
            del midas
            ckpt = os.path.join(tmp, "ckpt")

            def sharded_fit():
                _, first = fit(model(), data, steps=1, mesh=mesh, ckpt_dir=ckpt, ckpt_every=1, log_every=1,
                               verbose=False)
                state, resumed = fit(model(), data, steps=2, mesh=mesh, ckpt_dir=ckpt, log_every=1, verbose=False)
                check(state.step == 2 and [s for s, _ in first + resumed] == [1, 2],
                      f"{phase} fit: histories {first}, {resumed}")
                return [loss for _, loss in first + resumed]

            losses, counts = counted(sharded_fit)
            torch.cuda.empty_cache()
            plain = [loss for _, loss in plain_hist]
            err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
            rows["fit"] = held(phase, "fit", err, 1e-4, counts, TRAIN_PER_STEP, 2)
            rows["fit"].update(losses=losses, plain_losses=plain, batch=batch, src_hw=list(src_hw))
        finally:
            dist.destroy_process_group()
    emit(phase, world_size=1, backend="nccl", paths=rows, seconds=time.perf_counter() - t_phase)
    per_path.update({f"parallel_{k}": v["launches"] for k, v in rows.items()})
    return per_path


def run_parallel_tp(est, gen, phase="parallel_tp", tps=(2, 4)):
    """Tensor parallelism one rank at a time on DPT_Large's first block (phase 17)."""
    import copy

    from depth_estimation_tpu_torch.device import full_f32
    from depth_estimation_tpu_torch.ops import kernels
    from depth_estimation_tpu_torch.parallel.mesh import shard_params

    blk = est.model.pretrained.model.blocks[0]
    prefix = "pretrained.model.blocks.0."
    full = {k: v for k, v in est.model.state_dict().items() if k.startswith(prefix)}
    x = torch.randn((1, 577, blk.norm1.normalized_shape[0]), generator=gen, device="cuda")
    rows, per_path = {}, {}
    with torch.inference_mode(), full_f32():
        want = blk(x)
        for tp in tps:
            ranks = []
            for r in range(tp):
                local = copy.deepcopy(blk)
                local.attn.shard_(tp, None)
                local.mlp.shard_(tp, None)
                shard = {k[len(prefix):]: v for k, v in shard_params(full, r, tp).items()}
                shard["attn.proj.bias"] = torch.zeros_like(shard["attn.proj.bias"])  # added once, below
                shard["mlp.fc2.bias"] = torch.zeros_like(shard["mlp.fc2.bias"])
                local.load_state_dict(shard)
                ranks.append(local)

            def block():
                h = x + sum(rank.attn(blk.norm1(x)) for rank in ranks) + blk.attn.proj.bias
                return h + sum(rank.mlp(blk.norm2(h)) for rank in ranks) + blk.mlp.fc2.bias

            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got = block()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            rows[f"tp{tp}"] = held(phase, f"tp{tp}", max_scaled_err(got, want), 2e-5, counts,
                                   BLOCK_PER_RANK, tp)
            rows[f"tp{tp}"]["local_heads"] = ranks[0].attn.num_heads
            per_path[f"parallel_tp{tp}_block"] = counts
    emit(phase, block="DPT_Large blocks.0", tokens=577, batch=1, dtype="float32", paths=rows)
    return per_path


SMALL_PER_PROGRAM = {"multi_head_attention": 0, "fused_preprocess": 1, "resize_planes": 1, "grouped_conv3x3": 0,
                     "linear": 0}
# linear: 12 blocks × 4 + 2 readouts (levels 0 and 1 are the stem's maps)
HYBRID_PER_PROGRAM = {"multi_head_attention": 12, "fused_preprocess": 1, "resize_planes": 1, "grouped_conv3x3": 0,
                      "linear": 50}
READOUTS = {"dpt_large": 4, "dpt_hybrid": 2}  # readout projections a program
# one ViT block on one rank: K1 once, its four linear layers
BLOCK_PER_RANK = {"multi_head_attention": 1, "fused_preprocess": 0, "resize_planes": 0, "grouped_conv3x3": 0,
                  "linear": 4}
SP_TOKENS = 769  # DPT_Large at 384×512


def run_parallel_sp(est, gen, frames8, phase="parallel_sp", sps=(2, 4)):
    """Sequence parallelism and spatial partitioning (the module docstring, phase 18)."""
    import copy

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from depth_estimation_tpu_torch.device import full_f32
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.models import vit as vit_module
    from depth_estimation_tpu_torch.ops.kernels.attention import attention_plain
    from depth_estimation_tpu_torch.parallel.mesh import make_mesh, sequence_parallel
    from depth_estimation_tpu_torch.parallel.ops import SeqShards, token_counts
    from depth_estimation_tpu_torch.parallel.spatial import RowWorld, spatial_depth

    t_phase = time.perf_counter()
    rows = {}
    frame = frames8[0].cpu().numpy()
    convs = {"midas": (DepthEstimator("MiDaS", seed=0, device="cuda", verbose=False), MIDAS_PER_PROGRAM),
             "midas_small": (DepthEstimator("MiDaS_small", seed=0, device="cuda", verbose=False), SMALL_PER_PROGRAM)}
    wants = {key: e.predict(frame) for key, (e, _) in convs.items()}
    want_dpt = est.predict(frame)
    dpts = {"dpt_large": (est, DPT_PER_PROGRAM),
            "dpt_hybrid": (DepthEstimator("DPT_Hybrid", seed=0, device="cuda", verbose=False), HYBRID_PER_PROGRAM)}
    wants.update({key: e.predict(frame) for key, (e, _) in dpts.items()})

    # (a) a world of one over NCCL
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
        try:
            mesh = make_mesh(1, device="cuda")
            for key, (e, per_program) in {**convs, **dpts}.items():
                got, counts = counted(lambda: e.predict_spatial(frame, mesh))
                rows[f"{key}_predict_spatial"] = held(phase, f"{key}_predict_spatial",
                                                      max_scaled_err(got, wants[key]), 1e-3, counts, per_program)
            mesh_sp = init_device_mesh("cuda", (1, 1, 1, 1), mesh_dim_names=("dp", "pp", "sp", "tp"))
            model = sequence_parallel(copy.deepcopy(est.model), mesh_sp)
            got, counts = counted(lambda: est._run(est._to_device(frame[None]), model=model)[0].cpu().numpy())
            rows["sp1_dpt_large"] = held(phase, "sp1_dpt_large", max_scaled_err(got, want_dpt), 1e-5, counts,
                                         DPT_PER_PROGRAM)
            del model
        finally:
            dist.destroy_process_group()

    # (b) one rank at a time: the exchanges by slicing the whole tensor, the compute on the card
    blk = est.model.pretrained.model.blocks[0]
    heads = blk.attn.num_heads
    x = torch.randn((1, SP_TOKENS, blk.norm1.normalized_shape[0]), generator=gen, device="cuda")
    gather_kv, attention = vit_module.gather_kv, vit_module.multi_head_attention
    launches = []

    def recorded(q, k, v):
        out = attention(q, k, v)
        launches.append((q, k, v, out))
        return out

    try:
        with torch.inference_mode(), full_f32():
            want = blk(x)
            qkv = blk.attn.qkv(blk.norm1(x)).reshape(1, SP_TOKENS, 3, heads, -1)
            whole_kv = qkv[:, :, 1:].contiguous()  # every rank's K/V, as the gather would give them
            vit_module.gather_kv = lambda local, seq: whole_kv
            vit_module.multi_head_attention = recorded
            for sp in sps:
                counts_sp = token_counts(SP_TOKENS, sp)
                starts = np.cumsum((0,) + counts_sp)
                launches.clear()
                got, counts = counted(lambda: torch.cat(
                    [blk(x[:, starts[r]:starts[r + 1]], SeqShards(None, sp, r, counts_sp)) for r in range(sp)], 1))
                k1_errs = [(o - attention_plain(q, k, v)).abs().max().item() for q, k, v, o in launches]
                check(max(k1_errs) <= 2e-5, f"{phase} sp{sp}: K1 launches off their plain versions by {k1_errs}")
                rows[f"sp{sp}_block"] = held(phase, f"sp{sp}_block", max_scaled_err(got, want), 2e-5, counts, BLOCK_PER_RANK,
                                             sp)
                rows[f"sp{sp}_block"].update(tokens=list(counts_sp), k1_max_abs_err=max(k1_errs),
                                             k1_shapes=[[list(q.shape), k.shape[2]] for q, k, _, _ in launches])
    finally:
        vit_module.gather_kv, vit_module.multi_head_attention = gather_kv, attention

    def slabs(e, n):
        with torch.inference_mode(), e._numerics():
            return spatial_depth(RowWorld.local(n), e, e._to_device(frame[None]))[0].cpu().numpy()

    for n in sps:
        got, counts = counted(lambda: slabs(convs["midas"][0], n))
        rows[f"midas_{n}_slabs"] = held(phase, f"midas_{n}_slabs", max_scaled_err(got, wants["midas"]), 1e-3, counts,
                                        MIDAS_PER_PROGRAM, n)
    # the DPT families' slabs: K2, K3 and the readout projections a slab, the trunk whole (one K1 a block)
    for key, (e, per_program) in dpts.items():
        for n in sps:
            got, counts = counted(lambda: slabs(e, n))
            rows[f"{key}_{n}_slabs"] = held(phase, f"{key}_{n}_slabs", max_scaled_err(got, wants[key]), 1e-3, counts,
                                            {**per_program, "fused_preprocess": n, "resize_planes": n,
                                             "linear": per_program["linear"] + (n - 1) * READOUTS[key]})
    del convs, dpts
    torch.cuda.empty_cache()
    emit(phase, world_size=1, backend="nccl", paths=rows, seconds=time.perf_counter() - t_phase)
    return {f"parallel_sp_{k}": v["launches"] for k, v in rows.items()}


NATIVE_FRAMES = 200


def run_native(est, phase="native"):
    """The C++ framepipe (the module docstring, phase 19), built in phase 2
    (failing where it did not build): its synthetic source byte-equal to
    Python's, and the DPT_Large stream on it against the stream on Python's."""
    from depth_estimation_tpu_torch.runtime import native
    from depth_estimation_tpu_torch.runtime.stream import VidStream
    from depth_estimation_tpu_torch.runtime.video import NullSink, SyntheticSource, needs_prefetch

    check(native.native_available(), f"{phase}: the framepipe did not build or load: {native.native_load_error()}")
    spec = f"synthetic:{NATIVE_FRAMES}x480x640"
    ns, ps = native.NativeSource(spec), SyntheticSource.from_spec(spec)
    n = 0
    while True:
        (ok_n, f_n), (ok_p, f_p) = ns.read(), ps.read()
        check(ok_n == ok_p, f"{phase}: the native source ended at frame {n}, the Python one did not, or back")
        if not ok_n:
            break
        check(np.array_equal(f_n, f_p), f"{phase}: synthetic frame {n} differs from Python's")
        n += 1
    ns.release()
    check(n == NATIVE_FRAMES, f"{phase}: {n} synthetic frames")

    class Keep(NullSink):
        def __init__(self):
            super().__init__()
            self.frames = []

        def write(self, frame):
            super().write(frame)
            self.frames.append(np.array(frame, copy=True))

    outs, fps, launches = {}, {}, {}
    for kind, src in (("native", f"synthetic:{FRAMES}x480x640"), ("python", SyntheticSource(FRAMES, 480, 640))):
        sink = Keep()
        vs = VidStream(est, src, sink, verbose=False)
        source = vs.video.inner  # the native source, under the ResilientSource alone
        if kind == "native":
            check(isinstance(source, native.NativeSource) and not needs_prefetch(source),
                  f"{phase}: the stream reads {type(source).__name__}, prefetch {needs_prefetch(source)}")
        _, launches[kind] = counted(vs.update)
        check(launches[kind] == launches_per(DPT_PER_PROGRAM, FRAMES), f"{phase} {kind}: launches {launches[kind]}")
        outs[kind], fps[kind] = sink.frames, vs.timer.summary()["depth"]["fps_completion"]
    check(len(outs["native"]) == len(outs["python"]) == FRAMES
          and all(np.array_equal(a, b) for a, b in zip(outs["native"], outs["python"])),
          f"{phase}: the stream's u8 frames differ between the native and the Python source")
    emit(phase, built_with_opencv=native.native_opencv(), load_error=native.native_load_error(), synthetic_frames=n,
         stream_frames=FRAMES, native_fps=fps["native"], python_fps=fps["python"], launches=launches["native"])
    return launches["native"]


def check_window(frames, gen, kernel, n, rank=1):
    """K2 (MiDaS: 480×640 → 3×192×256) or K3 (192×256 → 480×640) on rank
    ``rank``'s output rows of ``n``, from the source rows they read: held
    against the plain version on the same window (3e-5) and against the
    whole-frame launch's rows, and timed."""
    from depth_estimation_tpu_torch.config import SMALL_PREPROCESS as cfg
    from depth_estimation_tpu_torch.ops.kernels.resize import (fused_preprocess, preprocess_plain, resize_planes,
                                                               resize_planes_plain, tiling, window_rows)
    from depth_estimation_tpu_torch.parallel.spatial import row_bounds

    in_hw, out_hw = ((480, 640), (192, 256)) if kernel == "preprocess" else ((192, 256), (480, 640))
    r0, r1 = row_bounds(out_hw[0], n)[rank]
    lo, hi = window_rows(in_hw[0], out_hw[0], r0, r1)
    win = (r0, r1, in_hw[0], lo)
    if kernel == "preprocess":
        src = frames[:1]
        slab = src[:, lo:hi].contiguous()
        launch = lambda: fused_preprocess(slab, out_hw, cfg.mean, cfg.std, window=win)  # noqa: E731
        plain = lambda: preprocess_plain(slab, out_hw, cfg.mean, cfg.std, window=win)  # noqa: E731
        whole = fused_preprocess(src, out_hw, cfg.mean, cfg.std)[:, :, r0:r1]
        flops_per_out, in_bytes = 2 * 16 + 2, slab.numel()
    else:
        src = torch.rand((1, *in_hw), generator=gen, device="cuda")
        slab = src[:, lo:hi].contiguous()
        launch = lambda: resize_planes(slab, out_hw, window=win)  # noqa: E731
        plain = lambda: resize_planes_plain(slab, out_hw, window=win)  # noqa: E731
        whole = resize_planes(src, out_hw)[:, r0:r1]
        flops_per_out, in_bytes = 2 * 16, slab.numel() * 4
    got, ref = launch(), plain()
    torch.cuda.synchronize()
    err, err_whole = (got - ref).abs().max().item(), (got - whole).abs().max().item()
    check(got.shape == ref.shape == whole.shape and err <= 3e-5 and err_whole <= 3e-5,
          f"{kernel} window {win}: {tuple(got.shape)} off its plain version by {err}, the whole launch by {err_whole}")
    taps = ((r1 - r0) + out_hw[1]) * 4 * 8
    bnd, by = bound_ms(in_bytes + got.numel() * 4 + taps, got.numel() * flops_per_out)
    row = {"name": kernel, "ranks": n, "rank": rank, "out_rows": [r0, r1], "source_rows": [lo, hi],
           "in": list(slab.shape), "out": list(got.shape), "max_abs_err": err, "max_abs_diff_whole_launch": err_whole,
           "atol": 3e-5, "tiling": tiling(in_hw, out_hw, 1, sm_count(), kernel, "cubic", False, (r0, r1, lo)),
           "ms": time_ms(launch), "plain_ms": time_ms(plain), "library_ms": None, "bound_ms": bnd, "bound_by": by}
    emit("kernel", window=True, **row)
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 1
    from depth_estimation_tpu_torch.config import DPT_PREPROCESS, SMALL_PREPROCESS, PreprocessConfig
    from depth_estimation_tpu_torch.device import full_f32
    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.ops.kernels import build
    from depth_estimation_tpu_torch.ops.preprocess import compute_resize_shape
    from depth_estimation_tpu_torch.parallel.ops import token_counts
    from depth_estimation_tpu_torch.runtime import native
    from depth_estimation_tpu_torch.runtime.video import SyntheticSource
    from depth_estimation_tpu_torch.utils import checkpoint

    # every phase that builds nets without weights, and every CLI, reads an empty weight cache, so that a
    # cache on the machine cannot change the random-weight phases (the tflite and evaluate phases set their own)
    empty_cache = tempfile.TemporaryDirectory(prefix="chip_smoke_cache_")
    os.environ[checkpoint.CACHE_ENV] = empty_cache.name
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
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_built = native.native_available()  # the C++ framepipe, with g++; phase 19 fails without it
    emit("build", seconds=seconds, native_built=native_built, native_seconds=time.perf_counter() - t0, ptxas=ptxas)

    gen = torch.Generator(device="cuda").manual_seed(0)
    net_hw = compute_resize_shape(480, 640, DPT_PREPROCESS)
    check(net_hw == (384, 512), f"network input {net_hw}")
    midas_hw = compute_resize_shape(480, 640, SMALL_PREPROCESS)
    check(midas_hw == (192, 256), f"MiDaS network input {midas_hw}")
    resize_shapes = {"dpt_384x512": (net_hw, DPT_PREPROCESS), "midas_192x256": (midas_hw, SMALL_PREPROCESS)}
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (MICROBATCH, 480, 640, 3), np.uint8)).cuda()
    frames8 = torch.from_numpy(rng.integers(0, 256, (SERVER_BATCH, 480, 640, 3), np.uint8)).cuda()
    with full_f32():
        att = check_attention(gen, 1, 16, 769, torch.float32, 2e-5, 1e-4, timed=True)
        check_attention(gen, 1, 16, 577, torch.float32, 2e-5, 1e-4, timed=False)
        check_attention(gen, MICROBATCH, 16, 769, torch.float32, 2e-5, 1e-4, timed=False)
        check_attention(gen, SERVER_BATCH, 16, 769, torch.float32, 2e-5, 1e-4, timed=False)  # the servers' batch
        # bf16: the kernel rounds the unnormalised probabilities to bf16, the plain version the normalised ones
        att16 = check_attention(gen, 1, 16, 769, torch.bfloat16, 1e-2, 1e-2, timed=True)
        check_attention(gen, 1, 16, 577, torch.bfloat16, 1e-2, 1e-2, timed=False)
        check_attention(gen, MICROBATCH, 16, 769, torch.bfloat16, 1e-2, 1e-2, timed=False)
        # DPT_Hybrid's ViT-B: 12 heads
        att12 = check_attention(gen, 1, 12, 769, torch.float32, 2e-5, 1e-4, timed=True)
        check_attention(gen, MICROBATCH, 12, 769, torch.float32, 2e-5, 1e-4, timed=False)
        check_attention(gen, 1, 12, 769, torch.bfloat16, 1e-2, 1e-2, timed=False)
        check_attention(gen, MICROBATCH, 12, 769, torch.bfloat16, 1e-2, 1e-2, timed=False)
        # K2 and K3 at both families' shapes: timed at batch 1, checked at the microbatch
        pre = {key: check_preprocess(frames[:1], hw, cfg, timed=True) for key, (hw, cfg) in resize_shapes.items()}
        rsz = {key: check_resize(gen, hw, (480, 640)) for key, (hw, _) in resize_shapes.items()}
        for hw, cfg in resize_shapes.values():
            check_preprocess(frames, hw, cfg, timed=False)
            check_resize(gen, hw, (480, 640), batch=MICROBATCH, timed=False)
        # the servers' batch on DPT_Large (K3 on both routes)
        check_preprocess(frames8, net_hw, DPT_PREPROCESS, timed=False)
        check_resize(gen, net_hw, (480, 640), batch=SERVER_BATCH, timed=False)
        # K2's linear route at the fused path's detector inputs: timed at batch 1, checked at the microbatch
        pre_linear = {}
        for key, (hw, mean, std) in DETECTOR_INPUTS.items():
            cfg = PreprocessConfig(mean=mean, std=std)
            pre_linear[key] = check_preprocess(frames[:1], hw, cfg, timed=True, method="linear")
            check_preprocess(frames, hw, cfg, timed=False, method="linear")
        # K4 is timed at every conv2 shape in both types; the table's row is layer 3, with 22 of its 30
        # launches a frame
        gconv = {layer: check_grouped_conv(gen, layer, torch.float32, 1e-4, timed=True)
                 for layer in MIDAS_CONV2_SHAPES}
        gconv16 = {layer: check_grouped_conv(gen, layer, torch.bfloat16, 1e-2, timed=True)
                   for layer in MIDAS_CONV2_SHAPES}
        # the MiDaS stream's microbatch and profile run K4 at batch 4, where the f32 tilings differ
        for layer in MIDAS_CONV2_SHAPES:
            check_grouped_conv(gen, layer, torch.float32, 1e-4, timed=False, batch=MICROBATCH)
            check_grouped_conv(gen, layer, torch.bfloat16, 1e-2, timed=False, batch=MICROBATCH)
        # the linear layers at one frame, the microbatch and the servers' batch (ViT-B's at the microbatch
        # alone); the table's row is fc1 at the microbatch
        lin = {f"{layer}_x{frames}": check_linear(gen, layer, frames,
                                                 timed=not layer.startswith("vit_b") or frames == MICROBATCH)
               for layer in VIT_LINEARS for frames in LINEAR_ROWS}

    est = DepthEstimator("DPT_Large", seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        launches, fps = run_stream(est, os.path.join(tmp, "depth.avi"), 1, DPT_PER_PROGRAM)
        run_stream(est, os.path.join(tmp, "depth_mb.avi"), MICROBATCH, DPT_PER_PROGRAM, per_frame_fps=fps)
    hold(est, DPT_PREPROCESS)
    frame = SyntheticSource(1, 480, 640).read()[1]
    profile_frames(est, frame)
    profile_frames(bf16_mode(est, frame, 0.05, DPT_PER_PROGRAM), frame, "bf16_profile")
    native_launches = run_native(est)

    # the fused iris/pose + depth path on the same DPT_Large
    weights = detector_weights(seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        fused_launches, fps = run_fused_stream(est, weights, os.path.join(tmp, "fused.avi"), 1)
        run_fused_stream(est, weights, os.path.join(tmp, "fused_mb.avi"), MICROBATCH, per_frame_fps=fps)
    cpu_est = DepthEstimator("DPT_Large", params={k: v.cpu() for k, v in est.model.state_dict().items()},
                             device="cpu", verbose=False)
    fused_hold(est, cpu_est, weights, 0.0, "hit")
    fused_hold(est, cpu_est, weights, 2.0, "miss")
    profile_fused(est, weights, frame)
    profile_fused(est, weights, frame, batch=MICROBATCH)
    # the staged loop (--no-fused) on the same DPT_Large, then the detection-only path
    with tempfile.TemporaryDirectory() as tmp:
        staged_launches = run_staged_stream(est, weights, os.path.join(tmp, "staged.avi"))
        detection_launches = run_detection_stream(weights, os.path.join(tmp, "detection.avi"))
    detection_hold(weights, frame, 0.0, "hit")
    detection_hold(weights, frame, 2.0, "miss")
    detection_depth(weights, frame)
    profile_detection(weights, frame)
    # the .tflite route: the five files written from the same weights, imported, auto-loaded on the card
    tflite_launches = run_tflite(est, weights, frame)
    # the serving surface on the same DPT_Large
    server_launches = run_server(est)
    profile_frames(est, frame, "server_profile", batch=SERVER_BATCH)
    server_hold(est, cpu_est)
    del cpu_est
    run_bucketed_server(est)
    fused_server_launches = run_fused_server(est, weights)
    multistream_launches = run_multistream(est, 1)
    run_multistream(est, 2)
    with tempfile.TemporaryDirectory() as tmp:
        run_serve_cli(tmp)
    torch.cuda.empty_cache()

    midas = DepthEstimator("MiDaS", seed=0, device="cuda")
    midas_per_program = MIDAS_PER_PROGRAM
    with tempfile.TemporaryDirectory() as tmp:
        midas_launches, fps = run_stream(midas, os.path.join(tmp, "midas.avi"), 1, midas_per_program,
                                         "midas_stream")
        run_stream(midas, os.path.join(tmp, "midas_mb.avi"), MICROBATCH, midas_per_program, "midas_stream",
                   per_frame_fps=fps)
    hold(midas, SMALL_PREPROCESS, "midas_hold")
    profile_frames(midas, frame, "midas_profile")
    profile_frames(midas, frame, "midas_profile", batch=MICROBATCH, max_calls=2000)
    profile_frames(bf16_mode(midas, frame, 0.1, midas_per_program, "midas_bf16"), frame, "midas_bf16_profile")

    # the export surface: DPT_Large (one frame, B = 4, fused) and MiDaS v2.1 through torch.export
    with tempfile.TemporaryDirectory() as tmp:
        export_launches = run_export(est, midas, weights, tmp)
        run_export_cli(tmp)
    torch.cuda.empty_cache()

    family_launches = {}
    for name, prefix, net_cfg, per_program, bound in [("MiDaS_small", "small", SMALL_PREPROCESS, SMALL_PER_PROGRAM, 0.1),
                                                      ("DPT_Hybrid", "hybrid", DPT_PREPROCESS, HYBRID_PER_PROGRAM, 0.3)]:
        fam = DepthEstimator(name, seed=0, device="cuda")
        with tempfile.TemporaryDirectory() as tmp:
            family_launches[name], fps = run_stream(fam, os.path.join(tmp, f"{prefix}.avi"), 1, per_program,
                                                    f"{prefix}_stream")
            run_stream(fam, os.path.join(tmp, f"{prefix}_mb.avi"), MICROBATCH, per_program, f"{prefix}_stream",
                       per_frame_fps=fps)
        hold(fam, net_cfg, f"{prefix}_hold")
        profile_frames(fam, frame, f"{prefix}_profile", max_calls=2000)
        fam16 = bf16_mode(fam, frame, bound, per_program, f"{prefix}_bf16")
        if name == "DPT_Hybrid":
            bf16_tail(fam, fam16, frame, 0.05, "hybrid_bf16_tail")
        del fam, fam16
        torch.cuda.empty_cache()

    # training, evaluation and checkpoints: the kernels' gradients, one train step of each K4-free and K4
    # family against the CPU, fit with a checkpoint and a resume, the evaluate CLI
    with full_f32():
        grad_rows = check_kernel_grads(gen)
    train_hold(est, 2, (240, 320), TRAIN_PER_STEP, 4e-3)
    midas_train_launches = train_hold(midas, 1, (192, 256), {**TRAIN_PER_STEP, "multi_head_attention": 0,
                                                             "grouped_conv3x3": 60, "linear": 0}, 2.5e-2, "midas_train_hold")
    del midas
    torch.cuda.empty_cache()
    train_launches = run_train(est)
    with tempfile.TemporaryDirectory() as tmp:
        run_evaluate(tmp)

    # the parallel surface: a world of one over NCCL, then tensor parallelism one rank at a time
    parallel_launches = run_parallel(est, frames8)
    parallel_launches.update(run_parallel_tp(est, gen))
    with full_f32():
        att_tp = {h: check_attention(gen, 1, h, 577, torch.float32, 2e-5, 1e-4, timed=True) for h in (8, 4)}
    # sequence parallelism and spatial partitioning, then K1 at the sp shapes and K2/K3 on row windows
    parallel_launches.update(run_parallel_sp(est, gen, frames8))
    with full_f32():
        att_sp = {f"sp{sp}_{name}": check_attention(gen, 1, 16, token_counts(SP_TOKENS, sp)[0], dtype, atol, rtol,
                                                    timed=True, nk=SP_TOKENS)
                  for sp in (2, 4) for name, dtype, atol, rtol in (("f32", torch.float32, 2e-5, 1e-4),
                                                                   ("bf16", torch.bfloat16, 1e-2, 1e-2))}
        windows = {k: {f"rank1_of_{n}": check_window(frames, gen, k, n) for n in (2, 4)}
                   for k in ("preprocess", "resize")}

    path = {"dpt_384x512": launches, "midas_192x256": midas_launches}  # per-frame streams' launches
    per_path = {"dpt_large": launches, "midas": midas_launches, "midas_small": family_launches["MiDaS_small"],
                "dpt_hybrid": family_launches["DPT_Hybrid"], "fused_iris": fused_launches,
                "detection": detection_launches, "tflite": tflite_launches, "staged_iris": staged_launches,
                "server": server_launches,
                "fused_server": fused_server_launches, "multistream": multistream_launches,
                "train": train_launches, "midas_train_step": midas_train_launches, "native_stream": native_launches,
                **export_launches, **parallel_launches}

    def entry(name, source, replaces, row, path_launches, paths, **extra):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": path_launches[name], **{k: row[k] for k in keys},
                "per_path": {p: per_path[p][name] for p in paths}, **extra}

    print(json.dumps({"kernels": [
        entry("multi_head_attention", "depth_estimation_tpu_torch/csrc/attention.cu",
              "depth_estimation_tpu/ops/pallas/attention.py:34", att, launches,
              ("dpt_large", "dpt_hybrid", "fused_iris", "tflite", "staged_iris", "server", "fused_server",
               "multistream", "native_stream",
               "train", "export_dpt_large", "export_dpt_large_b4", "export_fused", *parallel_launches),
              grad=grad_rows["multi_head_attention"],
              bound_peak=att["bound_peak"], fma_bound_ms=att["fma_bound_ms"], bf16_ms=att16["ms"],
              library_kernel=att["library_kernel"], bf16_plain_ms=att16["plain_ms"],
              bf16_library_ms=att16["library_ms"], bf16_library_kernel=att16["library_kernel"],
              bf16_bound_ms=att16["bound_ms"], bf16_max_abs_err=att16["max_abs_err"],
              vit_b_12_heads={k: att12[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                    "library_kernel", "bound_ms", "bound_by", "fma_bound_ms")},
              tp_heads={f"{h}_heads": {k: att_tp[h][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                                   "bound_ms", "bound_by", "fma_bound_ms")}
                        for h in att_tp},
              sp_shapes={key: {k: row.get(k) for k in ("shape", "keys", "dtype", "max_abs_err", "ms", "plain_ms",
                                                       "library_ms", "library_kernel", "bound_ms", "bound_by",
                                                       "fma_bound_ms")}
                         for key, row in att_sp.items()}),
        entry("fused_preprocess", "depth_estimation_tpu_torch/csrc/resize.cu",
              "depth_estimation_tpu/ops/pallas/resize.py:44", pre["dpt_384x512"], launches, per_path,
              per_shape={**{key: {"launches": path[key]["fused_preprocess"], **{k: pre[key][k] for k in K23_KEYS}}
                            for key in resize_shapes},
                         # the linear route: one launch of each of 128² and 256² a fused program
                         # (per_path.fused_iris: 3 a frame) and a detection program (per_path.detection: 2 a
                         # frame), and of 224² a pose detector stage (per_path.tflite: 3 + 2 + 1)
                         **{key: {"method": "linear", **{k: pre_linear[key][k] for k in K23_KEYS}}
                            for key in DETECTOR_INPUTS}},
              windows=windows["preprocess"]),
        entry("resize_planes", "depth_estimation_tpu_torch/csrc/resize.cu",
              "depth_estimation_tpu/ops/pallas/resize.py:102", rsz["dpt_384x512"], launches, per_path,
              grad=grad_rows["resize_planes"],
              **{k: rsz["dpt_384x512"][k] for k in K3_U8_KEYS},
              per_shape={key: {"launches": path[key]["resize_planes"],
                               **{k: rsz[key][k] for k in K23_KEYS + K3_U8_KEYS}} for key in resize_shapes},
              windows=windows["resize"]),
        entry("grouped_conv3x3", "depth_estimation_tpu_torch/csrc/grouped_conv.cu",
              "depth_estimation_tpu/ops/pallas/grouped_conv.py:105", gconv["layer3"], midas_launches, per_path,
              grad=grad_rows["grouped_conv3x3"],
              bound_peak=gconv["layer3"]["bound_peak"], fma_bound_ms=gconv["layer3"]["fma_bound_ms"],
              bf16_ms=gconv16["layer3"]["ms"], bf16_plain_ms=gconv16["layer3"]["plain_ms"],
              bf16_bound_ms=gconv16["layer3"]["bound_ms"], bf16_library_ms=gconv16["layer3"]["library_ms"],
              bf16_max_abs_err=gconv16["layer3"]["max_abs_err"],
              per_layer={layer: {"f32": {k: gconv[layer][k] for k in K4_KEYS},
                                 "bf16": {k: gconv16[layer][k] for k in K4_KEYS}} for layer in MIDAS_CONV2_SHAPES}),
        entry("linear", "depth_estimation_tpu_torch/csrc/linear.cu",
              "none: the JAX package leaves the linear layers to XLA", lin["fc1_x4"], launches,
              ("dpt_large", "dpt_hybrid", "fused_iris", "tflite", "staged_iris", "server", "fused_server",
               "multistream", "native_stream", "train", "export_dpt_large", "export_dpt_large_b4", "export_fused",
               *parallel_launches),
              bound_peak=lin["fc1_x4"]["bound_peak"],
              per_shape={key: {k: row.get(k) for k in ("shape", "gelu", "block_n", "max_abs_err",
                                                       "max_scaled_err_vs_f64", "ms", "plain_ms", "library_ms",
                                                       "bound_ms", "tflops", "bound_share")}
                         for key, row in lin.items()}),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
