"""Serve K video feeds: one batched frame program a resolution a tick.

The port's ``depth-serve`` (JAX ``tools/serve.py``): ``MultiStream`` by
default, or with ``--online`` the dynamic batcher (``BucketedDepthServer``)
with each stream as a client thread. Runs on ``cuda`` unless ``--device cpu``.

    python -m depth_estimation_tpu_torch.tools.serve [--online] --src a.mp4 --src synthetic:8x480x640
        [--output a_depth.avi ...] [--model-type MiDaS_small] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import threading
from collections import deque

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="video path / synthetic:<n>x<H>x<W>; repeat per stream")
    ap.add_argument("--output", action="append", default=None,
                    help="output path per stream (optional; repeat to match --src)")
    ap.add_argument("--model-type", default="MiDaS_small",
                    choices=("MiDaS_small", "MiDaS", "DPT_Large", "DPT_Hybrid"))
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="frames per stream per tick (same outputs, ~M frames more latency; for file→file runs)")
    ap.add_argument("--online", action="store_true",
                    help="serve through the online dynamic batcher (runtime/server.py): each stream becomes "
                    "a client thread submitting its frames as requests")
    ap.add_argument("--max-batch", type=int, default=8, help="--online: requests coalesced per dispatch")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="--online: straggler wait before a partial batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)

    from depth_estimation_tpu_torch.estimator import DepthEstimator
    from depth_estimation_tpu_torch.runtime.multistream import MultiStream

    est = DepthEstimator(args.model_type, device=args.device)
    if args.online:
        return _serve_online(est, args)
    MultiStream(est, args.src, args.output, verbose=not args.quiet, microbatch=args.microbatch).run()


def _serve_online(est, args) -> None:
    """One client thread per --src submitting frames to a shared
    BucketedDepthServer (mixed resolutions go to buckets of their own);
    each stream's outputs written in order, with at most 2·max_batch of its
    futures in flight."""
    from depth_estimation_tpu_torch.ops.postprocess import merge_gray3
    from depth_estimation_tpu_torch.runtime.server import BucketedDepthServer
    from depth_estimation_tpu_torch.runtime.video import open_sink, open_source

    outputs = args.output or [None] * len(args.src)
    if len(outputs) != len(args.src):
        raise SystemExit(f"{len(args.src)} --src but {len(outputs)} --output")
    sources = [open_source(s) for s in args.src]
    sinks = [open_sink(o, (int(v.width), int(v.height)), fps=20) for o, v in zip(outputs, sources)]
    counts = [0] * len(sources)
    errors = []
    with BucketedDepthServer(est, max_batch=args.max_batch, max_delay_ms=args.max_delay_ms) as srv:

        def client(i):
            try:
                pending: deque = deque()

                def drain_one():
                    sinks[i].write(merge_gray3(np.asarray(pending.popleft().result())))
                    counts[i] += 1

                while True:
                    ok, frame = sources[i].read()
                    if not ok:
                        break
                    pending.append(srv.submit(frame))
                    # bounded: a long source would otherwise queue a copy of every frame
                    if len(pending) > 2 * args.max_batch:
                        drain_one()
                while pending:
                    drain_one()
            except Exception as e:  # reported per stream by the main thread
                errors.append((args.src[i], e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(sources))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = srv.stats
    for v in sources:
        v.release()
    for s in sinks:
        s.release()
    if errors:
        for src, e in errors:
            print(f"stream {src} failed: {e!r}", file=sys.stderr)
        raise SystemExit(1)
    if not args.quiet:
        total_frames = sum(f for _, f in stats.values())
        total_batches = sum(b for b, _ in stats.values())
        print(f"Sucessfully read {sum(counts)} frames over {len(sources)} streams.")
        print(f"Online: {total_frames} requests in {total_batches} dispatches across {len(stats)} "
              f"resolution bucket(s) (max_batch {args.max_batch})")


if __name__ == "__main__":
    main()
