"""Run one cell of the port's benchmark on the machine it is started on.

    python3 portbench/run.py --workload dpt_large.serve_poisson --seed 1 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``, and a ``breakdown``) and last ``checks``,
each number compared with its limit. The same numbers end standard error.
Exits nonzero, with no result, without a CUDA device, with fewer devices
than the cell asks for, where the program under test cannot be imported,
or where JAX or the JAX package was loaded.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _fixed_caches() -> None:
    """Every compiler or kernel cache in a fixed directory of the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["DEPTH_ESTIMATION_TPU_TORCH_CACHE"] = str(CACHE / "weights")
    os.environ.pop("DEPTH_TPU_LOG_JSON", None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness
    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    import depth_estimation_tpu_torch  # noqa: F401  (the program under test must be here)

    torch.set_num_threads(4)
    result = harness.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              process_start=PROCESS_START)
    steps = result.pop("setup_steps")
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items()), file=sys.stderr)
    result["checks"] = result.pop("checks")  # last in the line
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
