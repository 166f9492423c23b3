#!/usr/bin/env python3
"""Where a route of K4 (the grouped 3×3 conv of the PyTorch port) spends its time.

    python3 tools/k4_breakdown.py [--dtype float32|bfloat16]

Builds ``depth_estimation_tpu_torch/csrc/grouped_conv.cu`` five times with
nvcc, all started together, through the port's own build module: as it is,
and with each of the source's breakdown macros: ``K4_NO_STAGE`` (no cp.async
copies; the kernel multiplies whatever shared memory holds), ``K4_NO_MMA``
(no k loop; it stages and stores zeros), both, and ``K4_LAUNCH_ONLY`` (every
block returns at once: the launch and nothing else). Each is timed at the
four MiDaS v2.1 conv2 shapes at batch 1 and 4 with chip_smoke's timer (CUDA
events, median of 25 runs of 10 calls), on the route of ``--dtype`` (f32 by
default: 3xTF32; bf16: bf16 mma). Only the kernel as it is gets checked
against the plain version (within 1e-4 in f32; 1e-2 + 1e-2·|y| in bf16,
as chip_smoke holds it); the others compute nothing useful.
Prints one JSON line per (batch, layer), then the card's ``nvidia-smi``
name and power limit. Needs one CUDA GPU and nvcc; imports nothing of JAX.
"""

import argparse
import ctypes
import json
import math
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import MIDAS_CONV2_SHAPES, time_ms  # noqa: E402
from depth_estimation_tpu_torch.ops.kernels import build  # noqa: E402
from depth_estimation_tpu_torch.ops.kernels.grouped_conv import _DTYPES, grouped_conv3x3_plain  # noqa: E402

VARIANTS = {"kernel": (), "no_staging": ("K4_NO_STAGE",), "no_mma": ("K4_NO_MMA",),
            "neither": ("K4_NO_STAGE", "K4_NO_MMA"), "launch_only": ("K4_LAUNCH_ONLY",)}


def build_variants():
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # each build waits on its own nvcc
        list(pool.map(lambda defines: build.build(("grouped_conv",), defines), VARIANTS.values()))
    libs = {}
    for name, defines in VARIANTS.items():
        lib = build.load("grouped_conv", defines)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_conv3x3.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        libs[name] = lib
    return libs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    dtype = getattr(torch, parser.parse_args().dtype)
    atol, rtol = (1e-4, 0.0) if dtype == torch.float32 else (1e-2, 1e-2)
    if not torch.cuda.is_available():
        print("k4_breakdown: no CUDA GPU is available", file=sys.stderr)
        return 1
    libs = build_variants()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch in (1, 4):
        for layer, (c, h, w) in MIDAS_CONV2_SHAPES.items():
            cg = c // 32
            x = torch.randn((batch, c, h, w), generator=gen, device="cuda").to(dtype)
            k = (torch.randn((c, cg, 3, 3), generator=gen, device="cuda") / math.sqrt(9 * cg)).to(dtype)
            row = {"batch": batch, "layer": layer, "shape": [batch, c, h, w], "dtype": str(dtype)}
            for name, lib in libs.items():
                y = torch.empty_like(x)

                def call(lib=lib, y=y):
                    err = lib.grouped_conv3x3(x.data_ptr(), k.data_ptr(), y.data_ptr(), batch, c, h, w, 32,
                                              _DTYPES[dtype], sms, torch.cuda.current_stream().cuda_stream)
                    build.check(err, "grouped conv launch")

                call()
                if name == "kernel":
                    torch.cuda.synchronize()
                    ref = grouped_conv3x3_plain(x, k, 32).float()
                    err = (y.float() - ref).abs().max().item()
                    if not torch.allclose(y.float(), ref, atol=atol, rtol=rtol):
                        raise RuntimeError(f"{layer} batch {batch} {dtype}: max abs err {err} over {atol}, {rtol}")
                    row["max_abs_err"] = err
                row[f"{name}_ms"] = time_ms(call)
            print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
