"""Open-loop clients of ``DepthServer`` (runtime/server.py).

Traffic keys: ``max_batch``, ``max_delay_ms``, ``output`` ("f32" or "u8"),
``warm_dispatches`` and ``arrivals`` (``schedule.arrivals``). One thread
sends every request at its due time, whether or not earlier ones have
been answered; each request is timed from its due time to the moment its
map is on the host (the future's result is set right after the batch's
device-to-host copy). Set-up warms the one batch shape the server runs.
"""

from __future__ import annotations

import concurrent.futures
import time

from portbench import schedule
from portbench.harness import DRAIN_S, Outcome


def send(srv, frames, due, keep, deadline):
    """Send request ``i`` (frame ``i``) at ``due[i]``, whatever is pending;
    wait until every one is answered or ``deadline`` passes. Returns when
    each was sent and answered (None: never), the failed ones and the
    answers of those in ``keep``."""
    n = len(due)
    sent, done, failed, outputs, futs = [], [None] * n, [], {}, []

    def finished(i, fut):
        done[i] = time.perf_counter()
        if fut.exception() is not None:
            failed.append(i)
        elif i in keep:
            outputs[i] = fut.result()

    for i in range(n):
        frame = frames.frame(i)
        wait = due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent.append(time.perf_counter())
        fut = srv.submit(frame)
        fut.add_done_callback(lambda f, i=i: finished(i, f))
        futs.append(fut)
    concurrent.futures.wait(futs, timeout=max(0.0, deadline - time.perf_counter()))
    return sent, done, failed, outputs


def run(ctx) -> Outcome:
    from depth_estimation_tpu_torch.runtime.server import DepthServer

    t = ctx.traffic
    est = ctx.estimator()
    srv = DepthServer(est, tuple(ctx.config["input_hw"]), max_batch=t["max_batch"],
                      max_delay_ms=t["max_delay_ms"], output=t["output"])
    try:
        for _ in range(int(t.get("warm_dispatches", 2))):
            srv.warm()
        offsets = schedule.arrivals(t["arrivals"], ctx.seconds, ctx.seed)
        keep = ctx.sample(len(offsets))
        b0, f0 = srv.batches_dispatched, srv.frames_served
        t0 = ctx.begin_window()
        due = [t0 + off for off in offsets]
        sent, done, failed, outputs = send(srv, ctx.frames, due, keep, ctx.t1 + DRAIN_S)
        ctx.end_window()
        server = {"batches": srv.batches_dispatched - b0, "frames": srv.frames_served - f0,
                  "max_batch": srv.max_batch}
    except BaseException:
        srv.close()
        raise

    def release():
        srv.close()
        est.model = None

    spans = [(s, d, "requests in flight: batcher, copies, program on the host")
             for s, d in zip(sent, done) if d is not None]
    return Outcome(attempted=len(due), failed=len(failed), due=due, done=done, outputs=outputs,
                   output=t["output"], rows_per_program=srv.max_batch, release=release,
                   gen_lag=[s - d for s, d in zip(sent, due)], server=server, spans=spans,
                   idle_default="no request in flight: waiting for arrivals")
