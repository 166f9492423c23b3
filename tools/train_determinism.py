#!/usr/bin/env python3
"""Is a DPT_Large train step's gradient the same every call on the card?

    python3 tools/train_determinism.py

Random DPT_Large weights (seed 0), one u8 batch of 2 at 240×320 through
``TrainingApply``. For each setting, the gradient is computed three times
from the same state (the first call sets up cuDNN's timed algorithm choice)
and the last two are compared tensor by tensor: how many of the 360
trainable tensors differ, and the largest differences (max-scaled). The
settings cross cuDNN's deterministic algorithms (``device.deterministic_convs``)
with the decoders' upsampling backward (ATen's ``F.interpolate`` backward, or
the port's matrix adjoint, ``models/midas_small.py::_Upsample2x``). Then two
``make_train_step`` steps at lr 0 (the port's step as it runs) are compared
the same way. Last, the step's cost: ``make_train_step`` at lr 0 as it runs
now and as it ran before (neither cuDNN's deterministic algorithms nor the
matrix backward), in turns (before, now, now, before), each the median
device ms of 7 steps (CUDA events around each) after one set-up step. One
JSON line each, after the card's ``nvidia-smi`` line.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, deterministic_convs, full_f32  # noqa: E402
from depth_estimation_tpu_torch.estimator import DepthEstimator  # noqa: E402
from depth_estimation_tpu_torch.models import midas_small  # noqa: E402
from depth_estimation_tpu_torch.train import step as train_step  # noqa: E402
from depth_estimation_tpu_torch.train.data import TrainingApply, batches, synthetic_pairs  # noqa: E402
from depth_estimation_tpu_torch.train.step import (loss_fn, make_optimizer, make_train_step,  # noqa: E402
                                                   trainable_tensors)
from depth_estimation_tpu_torch.utils import checkpoint  # noqa: E402


def aten_upsample2x(x, align_corners):
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=align_corners)


def median_ms(fn, n=7):
    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def differences(a, b):
    diff = {k: float((a[k] - b[k]).abs().max() / a[k].abs().max().clamp_min(1e-30))
            for k in a if not torch.equal(a[k], b[k])}
    return {"tensors": len(a), "differing": len(diff),
            "largest": sorted(diff.items(), key=lambda kv: -kv[1])[:3]}


def main():
    if not torch.cuda.is_available():
        print("train_determinism: no CUDA GPU is available", file=sys.stderr)
        return 1
    os.environ[checkpoint.CACHE_ENV] = tempfile.mkdtemp(prefix="train_determinism_cache_")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    est = DepthEstimator("DPT_Large", seed=0, device="cuda", verbose=False)
    apply = TrainingApply(est.model, est.preprocess_cfg)
    tensors = trainable_tensors(est.model)
    (imgs, gt), = list(batches(synthetic_pairs(2, 240, 320, seed=1), 2, shuffle=False))
    imgs, gt = torch.from_numpy(imgs).cuda(), torch.from_numpy(gt).cuda()
    port_upsample2x = midas_small.upsample2x

    def gradient(deterministic):
        for t in tensors.values():
            t.grad = None
        with full_f32(), conv_algorithms_by_timing(), \
                (deterministic_convs() if deterministic else contextlib.nullcontext()):
            loss_fn(apply, imgs, gt).backward()
        return {k: t.grad.clone() for k, t in tensors.items()}

    for deterministic in (False, True):
        for upsample in ("aten", "matrix"):
            midas_small.upsample2x = aten_upsample2x if upsample == "aten" else port_upsample2x
            gradient(deterministic)
            row = differences(gradient(deterministic), gradient(deterministic))
            print(json.dumps({"cudnn_deterministic": deterministic, "upsample_backward": upsample, **row}), flush=True)
    midas_small.upsample2x = port_upsample2x

    step = make_train_step(apply, make_optimizer(est.model, lr=0.0, weight_decay=0.0))
    runs = []
    for _ in range(3):
        step(imgs, gt)
        runs.append({k: t.grad.clone() for k, t in tensors.items()})
    print(json.dumps({"make_train_step_lr_0": True, **differences(runs[1], runs[2])}), flush=True)

    port_convs = train_step.deterministic_convs
    for setting in ("before", "now", "now", "before"):
        train_step.deterministic_convs = port_convs if setting == "now" else contextlib.nullcontext
        midas_small.upsample2x = port_upsample2x if setting == "now" else aten_upsample2x
        ms, times = median_ms(lambda: step(imgs, gt))
        print(json.dumps({"step": setting, "step_ms": ms, "times_ms": times}), flush=True)
    train_step.deterministic_convs, midas_small.upsample2x = port_convs, port_upsample2x
    return 0


if __name__ == "__main__":
    sys.exit(main())
