"""The trace reduction on a hand-made CUPTI trace: spans from the markers,
device time by span, busy union, idle gaps by host span."""

from __future__ import annotations

import pytest

from benchmark.trace import MARKER, Spans, Trace


def _ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _trace():
    edges = [("bench.window", 1), ("bench.request", 1), ("bench.pose", 1), ("bench.pose", -1),
             ("bench.request", -1), ("bench.wait", 1), ("bench.wait", -1), ("bench.window", -1)]
    host = [0.0, 1.0, 2.0, 10.0, 11.0, 12.0, 40.0, 41.0]         # each marker's launch
    events, corr = [], 100
    for t in host:
        corr += 1
        events += [_ev("cuda_runtime", "cudaLaunchKernel", t, 0.5, corr),
                   _ev("kernel", f"void at::native::k<{MARKER}>()", t + 30.0, 0.001, corr)]
    # A pose kernel launched at 3 us running 20..30, a request-level one launched at
    # 10.5 us running 30..35, one launched inside the wait (none should be), and
    # a kernel with no launch in the trace.
    for t, start, dur in ((3.0, 20.0, 10.0), (10.5, 30.0, 5.0)):
        corr += 1
        events += [_ev("cuda_runtime", "cudaLaunchKernel", t, 0.5, corr),
                   _ev("kernel", f"kern{corr}", start, dur, corr)]
    events.append(_ev("kernel", "orphan", 36.0, 1.0, 9999))
    return Trace(events, edges)


def test_spans_and_attribution():
    tr = _trace()
    assert tr.window == (0.0, 41.0)
    by = {n: s for n, _, _, s in tr.ops}
    assert by == {"kern109": "bench.pose", "kern110": "bench.request", "orphan": None}
    assert tr.device_seconds("bench.pose") == pytest.approx(10e-6)
    assert tr.device_seconds(match=lambda n: n.startswith("kern")) == pytest.approx(15e-6)
    assert tr.span_seconds("bench.request") == pytest.approx(10e-6)


def test_busy_union_and_idle_gaps():
    tr = _trace()
    # Busy: 20..35 and 36..37 -> 16 us of 41.
    assert tr.busy_s() == pytest.approx(16e-6)
    assert tr.window_s() == pytest.approx(41e-6)
    gaps = dict(tr.idle_gaps())
    # Gaps 0..20 (midpoint 10: the pose span), 35..36 (wait), 37..41 (wait).
    assert gaps["bench.pose"] == pytest.approx(20e-6)
    assert gaps["bench.wait"] == pytest.approx(5e-6)
    assert sum(gaps.values()) == pytest.approx(25e-6)


def test_marker_count_must_match():
    with pytest.raises(ValueError):
        Trace([_ev("cuda_runtime", "cudaLaunchKernel", 0.0, 1.0, 1)], [("bench.window", 1)])


def test_spans_off_do_nothing():
    s = Spans()
    with s.span("bench.pose"):
        pass
    assert s.edges == []
