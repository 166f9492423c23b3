"""Find the knee of a serving cell: the highest open-loop rate the server
sustains without a growing backlog. One process, one server, warmed once;
each rate is a window of Poisson arrivals (``schedule.arrivals``).

    python3 portbench/sweep.py --workload dpt_large.serve_poisson --rates 36 40 44 48 52 --seconds 12

prints one JSON line a rate: requests completed a second, p50 and p95
latency from the due time, and the median latency of the window's first and
last quarter. A rate is sustained where the server completes what is
offered and the last quarter's median is within 1.5x of the first's. The
knee found is written into the traffic file by hand, with the sweep's
lines in PERF.md.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time


def main(argv=None) -> int:
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from portbench import schedule
    from portbench.drivers.server import send
    from portbench.harness import Run
    from portbench.spec import Spec
    from portbench.stats import percentile, rate

    from depth_estimation_tpu_torch.runtime.server import DepthServer

    p = argparse.ArgumentParser(description="open-loop rate sweep of a serving cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    ctx = Run(Spec(root), args.workload, args.seed, args.seconds, trace=False)
    t = ctx.traffic
    est = ctx.estimator()
    with DepthServer(est, tuple(ctx.config["input_hw"]), max_batch=t["max_batch"],
                     max_delay_ms=t["max_delay_ms"], output=t["output"]) as srv:
        for _ in range(int(t.get("warm_dispatches", 2))):
            srv.warm()
        for r in args.rates:
            offsets = schedule.arrivals({**t["arrivals"], "rate_per_s": r}, args.seconds, args.seed)
            t0 = time.perf_counter() + 0.05
            due = [t0 + off for off in offsets]
            b0, f0 = srv.batches_dispatched, srv.frames_served
            sent, done, failed, _ = send(srv, ctx.frames, due, set(), t0 + args.seconds + 60)
            lat = [(d - s) if d is not None else float("inf") for s, d in zip(due, done)]
            q = len(lat) // 4
            first, last = statistics.median(lat[:q]), statistics.median(lat[-q:])
            completed = rate([d for d in done if d is not None], t0, t0 + args.seconds)
            print(json.dumps({"rate_per_s": r, "requests": len(due), "failed": len(failed),
                              "completed_per_s": completed, "p50_ms": percentile(lat, 50) * 1e3,
                              "p95_ms": percentile(lat, 95) * 1e3, "first_quarter_p50_ms": first * 1e3,
                              "last_quarter_p50_ms": last * 1e3,
                              "batch_fill": (srv.frames_served - f0) / max(1, srv.batches_dispatched - b0)
                              / srv.max_batch,
                              "sustained": completed >= 0.97 * len(due) / args.seconds and last <= 1.5 * first}),
                  flush=True)
            time.sleep(1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
