"""The readers of the program's spans and the breakdown's idle gaps named by
them, on a hand-made record: spans as the program records them, device
events as the trace maps them, a window from 10 to 20 s."""

import math

import pytest

from depth_estimation_tpu_torch.runtime.tracing import Span
from portbench import spans, spec

W0, W1 = 10.0, 20.0


class _Record:
    window = (W0, W1)

    def __init__(self, program_spans=None, events=None):
        self.program_spans = program_spans
        self._events = events

    def events(self):
        return self._events


def _span(name, start, end, span_id, parent_id=None, thread_id=1, **ids):
    return Span(name, start, end, span_id, parent_id, thread_id, ids)


def _read(name, rec):
    return spec.reader(name).read(rec, {"name": name})


def _batch(k, t, first_id):
    """Batch ``k`` dispatched at ``t``: pad, program (upload, K2), fetch."""
    d = first_id
    return [_span("server.dispatch", t, t + 0.2, d, thread_id=2, batch=k, rows=6, padded=2),
            _span("server.pad", t, t + 0.002, d + 1, d, thread_id=2),
            _span("program", t + 0.002, t + 0.02, d + 2, d, thread_id=2, rows=8),
            _span("program.upload", t + 0.002, t + 0.005, d + 3, d + 2, thread_id=2),
            _span("program.k2", t + 0.005, t + 0.006, d + 4, d + 2, thread_id=2),
            _span("server.fetch", t + 0.02, t + 0.18, d + 5, d, thread_id=2)]


def test_readers_find_nothing_without_spans():
    for name in ("queue_wait_ms_p95.lat", "dispatch_gap_ms_p50.lat", "program_launch_ms_p50.lat",
                 "program_launch_ms_p50.fps", "map_ready_to_fetch_ms_p95.lat"):
        assert _read(name, _Record(None, [("k", 11.0, 12.0)])) is None
        assert _read(name, _Record([], [("k", 11.0, 12.0)])) is None


def test_queue_wait_counts_waits_that_end_in_the_window():
    waits = [_span("server.queue", 12.0, 12.0 + 0.001 * i, i, req=i, batch=0) for i in range(1, 101)]
    outside = [_span("server.queue", 9.0, 9.5, 200, req=200, batch=0), _span("server.queue", 19.9, 20.5, 201)]
    assert _read("queue_wait_ms_p95.lat", _Record(waits + outside)) == pytest.approx(95.05)


def test_dispatch_gap_is_next_k2_start_less_fetch_end():
    recorded = _batch(0, 11.0, 100) + _batch(1, 11.25, 200) + _batch(2, 11.6, 300) + _batch(3, 25.0, 400)
    # gaps: 11.255 - 11.18 = 75 ms, 11.605 - 11.43 = 175 ms; batch 3 starts after the window
    assert _read("dispatch_gap_ms_p50.lat", _Record(recorded)) == pytest.approx(125.0)


def test_program_launch_is_the_median_program_span():
    recorded = [_span("program", 10.0 + i, 10.0 + i + 0.01 * i, i) for i in range(1, 12)]
    # starts 11..21: the one at 21 is after the window; durations 10..100 ms
    assert _read("program_launch_ms_p50.fps", _Record(recorded)) == pytest.approx(55.0)
    assert _read("program_launch_ms_p50.lat", _Record(recorded)) == pytest.approx(55.0)


def test_map_ready_to_fetch_waits_from_the_copy_that_the_fetch_found_done():
    events = [("gemm", 11.0, 11.02), ("Memcpy DtoH (Device -> Pinned)", 11.02, 11.021),
              ("gemm", 11.05, 11.07), ("Memcpy DtoH (Device -> Pinned)", 11.07, 11.071)]
    recorded = [_span("stream.fetch", 11.041, 11.042, 1, frame=0, rows=1),  # 20 ms after the first copy
                _span("stream.fetch", 11.06, 11.0712, 2, frame=1, rows=1)]  # waited for the second: 0
    assert _read("map_ready_to_fetch_ms_p95.lat", _Record(recorded, events)) == pytest.approx(19.0)


def test_breakdown_names_idle_time_by_the_innermost_program_span():
    events = [("k", 10.0, 11.0), ("k", 11.1, 12.0), ("k", 12.2, 13.0), ("k", 13.4, 14.0), ("k", 14.5, 20.0)]
    # idle gaps: 11.0-11.1, 12.0-12.2, 13.0-13.4, 14.0-14.5
    recorded = [_span("server.dispatch", 10.9, 11.2, 1, thread_id=2),
                _span("server.fetch", 10.95, 11.08, 2, 1, thread_id=2),  # inside its dispatch: wins 11.0-11.08
                _span("server.collect", 12.05, 12.3, 5, thread_id=2),
                # emitted after the fact (it begins before its parent): names only what nothing else covers
                _span("server.queue", 12.0, 12.1, 3, 5, thread_id=2, req=0, batch=1),
                _span("program", 13.0, 13.1, 4, thread_id=3)]
    driver = [(11.5, 13.35, "driver span")]
    out = spans.breakdown(events, recorded, driver, W0, W1, "default")
    labels = {round(dur, 6): text.split(" @ ")[0] for text, dur in out["idle_gaps"]}
    assert labels == {0.1: "server.fetch", 0.2: "server.collect", 0.4: "driver span", 0.5: "default"}
    assert out["idle_by_span"] == pytest.approx({"server.fetch": 0.08, "server.dispatch": 0.02, "server.queue": 0.05,
                                                 "server.collect": 0.15, "program": 0.1, "driver span": 0.25,
                                                 "default": 0.55})
    assert math.isclose(sum(out["idle_by_span"].values()), 1.2)
    assert out["device_ops"] == [["k", pytest.approx(8.8)]]
