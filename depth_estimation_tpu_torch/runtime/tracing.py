"""Profiling hooks (JAX ``runtime/tracing.py``) on ``torch.profiler``, and
the program's one span recorder.

``trace()`` captures a block: host ops and, on a GPU, the device's kernels
and copies, written as a Chrome trace (open it in Perfetto or
chrome://tracing). ``span()`` marks a region of the program where the work
happens (the batcher, the stream loop, the frame program); it records
nothing unless ``record()`` or ``trace()`` is on:

* off (the default), ``span()`` returns one shared do-nothing object: no
  clock is read and no profiler object is made;
* under ``record()``, each span is appended to an in-memory list as a
  :class:`Span`, its parent found on a per-thread stack;
* under ``trace()``, each span is also a ``record_function``, so the
  Chrome trace shows it on the host timeline.

Times are ``time.perf_counter()`` seconds, the clock that a device trace's
events are mapped onto by a marker kernel, so spans and kernels share one
timeline.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

DEFAULT_DIR = "./torch_trace"


class Span(NamedTuple):
    name: str
    start: float  # time.perf_counter() seconds
    end: float
    span_id: int
    parent_id: Optional[int]  # the enclosing span on the same thread, if any
    thread_id: int
    ids: Dict[str, int]  # what ties one request's or frame's spans together: req, batch, frame, rows


class _Recorder:
    def __init__(self, profile: bool):
        self.profile = profile  # also enter record_function (under trace())
        self.spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    def stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


_recorder: Optional[_Recorder] = None


class _Off:
    """The shared span of a program that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "name", "ids", "start", "span_id", "parent_id", "rf")

    def __init__(self, rec: _Recorder, name: str, ids: Dict[str, int]):
        self.rec, self.name, self.ids, self.rf = rec, name, ids, None

    def __enter__(self):
        stack = self.rec.stack()
        self.parent_id = stack[-1] if stack else None
        self.span_id = next(self.rec._ids)
        stack.append(self.span_id)
        if self.rec.profile:
            from torch.profiler import record_function

            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec.stack().pop()
        self.rec.spans.append(Span(self.name, self.start, end, self.span_id, self.parent_id,
                                   threading.get_ident(), self.ids))
        return False


def span(name: str, **ids: int):
    """A named region of the program (a context manager); ``ids`` (``req=``,
    ``batch=``, ``frame=``, ``rows=``) tie one request's or frame's spans
    together. Records only under ``record()`` or ``trace()``."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _On(rec, name, ids)


def emit(name: str, start: float, end: float, **ids: int) -> None:
    """Record a span that began before this thread saw it (a request's wait
    in a queue, from its submit on another thread), with this thread's
    current span as parent."""
    rec = _recorder
    if rec is None:
        return
    stack = rec.stack()
    rec.spans.append(Span(name, start, end, next(rec._ids), stack[-1] if stack else None,
                          threading.get_ident(), ids))


@contextlib.contextmanager
def _recording(profile: bool) -> Iterator[List[Span]]:
    global _recorder
    outer = _recorder
    _recorder = _Recorder(profile)
    try:
        yield _recorder.spans
    finally:
        _recorder = outer


def record() -> contextlib.AbstractContextManager:
    """Record every span of the enclosed block, on every thread, into the
    list it yields (spans are appended as they end)."""
    return _recording(profile=False)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Trace the enclosed block into ``log_dir`` (default ./torch_trace) as
    ``trace_<time>_<pid>.json``, the program's spans on it; yields the
    directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or DEFAULT_DIR
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        with _recording(profile=True):
            yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))


@contextlib.contextmanager
def maybe_trace(enabled: bool, log_dir: Optional[str] = None):
    """``trace(log_dir)`` when ``enabled``, else nothing (yields None)."""
    if enabled:
        with trace(log_dir) as d:
            yield d
    else:
        yield None
