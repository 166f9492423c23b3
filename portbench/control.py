"""The control of the correctness check: the reference put in the program's
place and computed one precision lower, TF32 where the configuration
states float32, on the frames a run compares (the same frames, the same
count, at the cell's own size). Each field of the cell's limits is served
as the program serves it (``compare.served``: the value, its u8 cast, its
truncation or its flag), the TF32 reference making its own discrete
choices, and judged against the reference at full precision, which is
handed those choices as the program's are (``frame.outputs``). The control
has to fail one of the cell's limits.

    python3 portbench/control.py --workload dpt_large.serve_poisson --seeds 1 2 3

prints one JSON line a seed: each field's reading beside its limit, and the
range of the reference's values. ``tests/test_portbench_control.py`` runs
it on the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List

import torch


def readings(spec, workload: str, seeds: List[int], device="cuda", seconds: float = 20.0) -> List[Dict]:
    from portbench import compare, schedule
    from portbench.frames import Frames
    from portbench.harness import Run
    from portbench.reference import frame as ref
    from portbench.weights import make_weights

    out = []
    for seed in seeds:
        run = Run(spec, workload, seed, seconds, trace=False, device=device)
        limits = compare.fields(run.limits)
        due = schedule.arrivals(run.traffic["arrivals"], seconds, seed)
        idx = sorted(run.sample(len(due) if due is not None else 1000))
        frames = torch.from_numpy(Frames(seed, run.config["input_hw"], run.device).stack(idx)).to(run.device)
        model = ref.build_model(run.config, make_weights(run.config, seed, run.device), run.device)
        worst = {f["key"]: 0.0 for f in limits.values()}
        wants = {n: [] for n in limits}
        for i in range(0, len(idx), 8):
            block = frames[i:i + 8]
            low = ref.outputs(model, block, run.config, None, tf32=True)
            got = {**low, **{n: compare.served(f["compare"], low[n], **f["args"]) for n, f in limits.items()}}
            want = ref.outputs(model, block, run.config, got, tf32=False)
            compare.worst_gaps(limits, got, want, worst)
            for n in limits:
                wants[n].append(want[n].double())
        ranges = {}
        for n, w in wants.items():
            w = torch.cat(w)
            ranges[n] = {"min": float(w.min()), "max": float(w.max()), "mean": float(w.mean()),
                         "zero_share": float((w == 0).double().mean())}
        out.append({"workload": workload, "seed": seed, "frames": len(idx),
                    "controls": {f["key"]: {"value": worst[f["key"]], "limit": f["limit"]} for f in limits.values()},
                    "fails": any(worst[f["key"]] > f["limit"] for f in limits.values()), "reference": ranges})
        del model, wants
    return out


def main(argv=None) -> int:
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from portbench.spec import Spec

    p = argparse.ArgumentParser(description="control readings of a cell's correctness check")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for r in readings(Spec(root), args.workload, args.seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
