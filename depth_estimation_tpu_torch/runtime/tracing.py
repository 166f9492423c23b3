"""Profiling hooks (JAX ``runtime/tracing.py``) on ``torch.profiler``.

The reference's only instrumentation is process_time brackets
(midas_mediapipe.py:52-60), kept in ``runtime/timing.py``. This module
captures a trace of a block: host ops and, on a GPU, the device's kernels
and copies, written as a Chrome trace (open it in Perfetto or
chrome://tracing), and names spans on that timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

DEFAULT_DIR = "./torch_trace"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Trace the enclosed block into ``log_dir`` (default ./torch_trace) as
    ``trace_<time>_<pid>.json``; yields the directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or DEFAULT_DIR
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


def span(name: str):
    """A named span on the trace's timeline (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def maybe_trace(enabled: bool, log_dir: Optional[str] = None):
    """``trace(log_dir)`` when ``enabled``, else nothing (yields None)."""
    if enabled:
        with trace(log_dir) as d:
            yield d
    else:
        yield None
