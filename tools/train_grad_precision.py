#!/usr/bin/env python3
"""How far one train step's f32 gradients lie from the float64 gradient, on the card and on the CPU.

    python3 tools/train_grad_precision.py [--model DPT_Large] [--model MiDaS]

For each model (random weights from seed 0; DPT_Large at batch 2 from
240×320, MiDaS v2.1 at batch 1 from 192×256) the float64 gradient of the
train step's loss (SSI + 0.5 · gradient matching) is computed on the CPU
(``train.step.float64_gradients``). Then the f32 gradient on the CPU
(oneDNN off and on) and on the card (the train step's numerics; with cuDNN
off, ATen's own CUDA convolutions; and, as a control that a gate must
fail, with TF32 allowed in cuBLAS and cuDNN). Prints one JSON line a model:
each variant's loss, and each tensor's max |g − g64| over max |g64| of that
tensor, as the number of tensors over 1e-2, 1e-3 and 1e-4 and the worst eight,
beside the same over the largest gradient of the model; and the card's
gradient against the CPU's (oneDNN on) in the same two forms. Needs a CUDA
GPU.
"""

import argparse
import contextlib
import json
import sys
import time
import warnings

import torch

sys.path.insert(0, __file__.rsplit("/tools/", 1)[0])
from depth_estimation_tpu_torch.device import conv_algorithms_by_timing, full_f32  # noqa: E402
from depth_estimation_tpu_torch.estimator import DepthEstimator  # noqa: E402
from depth_estimation_tpu_torch.train.data import TrainingApply, batches, synthetic_pairs  # noqa: E402
from depth_estimation_tpu_torch.train.step import float64_gradients, loss_fn, trainable_tensors  # noqa: E402

SHAPES = {"DPT_Large": (2, (240, 320)), "MiDaS": (1, (192, 256))}


def grads(model, apply_fn, imgs, gt, ctx):
    tt = trainable_tensors(model)
    for t in tt.values():
        t.grad = None
    with ctx:
        loss = loss_fn(apply_fn, imgs, gt)
        loss.backward()
    return float(loss), {k: t.grad.detach().double().cpu() for k, t in tt.items()}


def report(got, ref, top=8):
    diff = {k: float((got[k] - ref[k]).abs().max()) for k in ref}
    own = {k: diff[k] / max(float(ref[k].abs().max()), 1e-300) for k in ref}
    largest = max(float(r.abs().max()) for r in ref.values())
    worst = sorted(own, key=own.get)[-top:]
    return {**{f"own_over_{t}": sum(e >= float(t) for e in own.values()) for t in ("1e-2", "1e-3", "1e-4")},
            "own_worst": {k: own[k] for k in reversed(worst)}, "max_scaled": max(diff.values()) / largest}


@contextlib.contextmanager
def tf32_allowed():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def stack(*contexts):
    st = contextlib.ExitStack()
    for c in contexts:
        st.enter_context(c)
    return st


def run(model_type):
    batch, hw = SHAPES[model_type]
    est = DepthEstimator(model_type, seed=0, device="cpu", verbose=False)
    sd = {k: v.clone() for k, v in est.model.state_dict().items()}
    cfg = est.preprocess_cfg
    (imgs, gt), = list(batches(synthetic_pairs(batch, *hw, seed=3), batch, shuffle=False))
    imgs, gt = torch.from_numpy(imgs), torch.from_numpy(gt)
    loss64, ref = float64_gradients(TrainingApply(est.model, cfg), imgs, gt)
    del est
    out = {"model": model_type, "batch": batch, "src_hw": list(hw), "loss64": float(loss64)}
    cpu = DepthEstimator(model_type, params=sd, device="cpu", verbose=False).model
    got = {}
    for label, ctx in (("cpu_onednn_off", lambda: torch.backends.mkldnn.flags(enabled=False)),
                       ("cpu_onednn_on", contextlib.nullcontext)):
        t0 = time.perf_counter()
        loss, got[label] = grads(cpu, TrainingApply(cpu, cfg), imgs, gt, ctx())
        out[label] = {"loss": loss, "seconds": time.perf_counter() - t0, **report(got[label], ref)}
    del cpu
    card = DepthEstimator(model_type, params=sd, device="cuda", verbose=False).model
    for label, ctx in (("card", lambda: stack(full_f32(), conv_algorithms_by_timing())),
                       ("card_cudnn_off", lambda: stack(full_f32(), torch.backends.cudnn.flags(enabled=False))),
                       ("control_card_tf32", lambda: stack(conv_algorithms_by_timing(), tf32_allowed()))):
        for _ in range(2):  # the first call at a shape pays cuDNN's search
            loss, got[label] = grads(card, TrainingApply(card, cfg), imgs.cuda(), gt.cuda(), ctx())
        out[label] = {"loss": loss, **report(got[label], ref)}
    out["card_vs_cpu_onednn_on"] = report(got["card"], got["cpu_onednn_on"])
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", action="append", choices=sorted(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_grad_precision: no CUDA GPU is available", file=sys.stderr)
        return 1
    warnings.simplefilter("ignore")
    for model_type in args.model or sorted(SHAPES):
        run(model_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
