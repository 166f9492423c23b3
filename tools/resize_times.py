#!/usr/bin/env python3
"""K2 (fused preprocess) and K3 (plane resize) of a checkout of the PyTorch port, timed at both families' shapes.

    python3 tools/resize_times.py [--root DIR]

Imports ``depth_estimation_tpu_torch`` from DIR (this checkout by default),
so one call can time an older checkout's kernels beside this one's with the
same timer, chip_smoke's (CUDA events, median of 25 runs of 10 calls). At
batch 1 and 4, for DPT_Large (480×640 → 384×512 → 480×640) and MiDaS
(480×640 → 192×256 → 480×640): K2 on a u8 frame, K3 on f32 planes, and
the stream's u8 output of K3 (K3's u8 route where the checkout has one, else
K3 followed by ``wraparound_u8``), each checked against its plain version
first. Prints one JSON line per (batch, family), then the card's
``nvidia-smi`` name and power limit. Needs one CUDA GPU and nvcc; imports
nothing of JAX.
"""

import argparse
import importlib.util
import inspect
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

TOOL_ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = {"dpt_384x512": ((384, 512), "DPT_PREPROCESS"), "midas_192x256": ((192, 256), "SMALL_PREPROCESS")}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", TOOL_ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=pathlib.Path, default=TOOL_ROOT)
    root = parser.parse_args().root.resolve()
    if not torch.cuda.is_available():
        print("resize_times: no CUDA GPU is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from depth_estimation_tpu_torch import config
    from depth_estimation_tpu_torch.ops.kernels import resize
    from depth_estimation_tpu_torch.ops.postprocess import wraparound_u8

    time_ms = _chip_smoke().time_ms
    fused_u8 = "output" in inspect.signature(resize.resize_planes).parameters
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch in (1, 4):
        frames = torch.from_numpy(rng.integers(0, 256, (batch, 480, 640, 3), np.uint8)).cuda()
        for family, (net_hw, cfg_name) in FAMILIES.items():
            cfg = getattr(config, cfg_name)
            depth = torch.rand((batch, *net_hw), generator=gen, device="cuda") * 600 - 50
            pre = lambda: resize.fused_preprocess(frames, net_hw, cfg.mean, cfg.std)  # noqa: E731
            k3 = lambda: resize.resize_planes(depth, (480, 640))  # noqa: E731
            if fused_u8:
                u8 = lambda: resize.resize_planes(depth, (480, 640), output="u8")  # noqa: E731
            else:
                u8 = lambda: wraparound_u8(resize.resize_planes(depth, (480, 640)))  # noqa: E731
            pre_err = (pre() - resize.preprocess_plain(frames, net_hw, cfg.mean, cfg.std)).abs().max().item()
            f32 = resize.resize_planes_plain(depth, (480, 640))
            k3_err = (k3() - f32).abs().max().item()
            u8_away = int(((u8() != wraparound_u8(f32)) & ((f32 - f32.round()).abs() >= 1e-3)).sum())
            if pre_err > 3e-5 or k3_err > 3e-5 * 600 or u8_away:
                raise RuntimeError(f"{family} batch {batch}: K2 err {pre_err}, K3 err {k3_err}, u8 bytes {u8_away}")
            print(json.dumps({"root": str(root), "batch": batch, "family": family, "fused_u8_route": fused_u8,
                              "k2_ms": time_ms(pre), "k3_ms": time_ms(k3), "u8_output_ms": time_ms(u8),
                              "k2_max_abs_err": pre_err, "k3_max_abs_err": k3_err}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
