"""The trace reduction on a hand-made CUPTI trace: spans from the markers,
device time by span, busy union, idle gaps by host span; records lost
inside the window refused, the padding outside it left out; a lost
window traced anew."""

from __future__ import annotations

import pytest

from benchmark.run import whole_trace
from benchmark.trace import MARKER, Lost, Spans, Trace


def _ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events():
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
    return events, edges


def _trace():
    return Trace(*_events())


def _padded(lose_lead: bool = False, lose_tail: bool = False):
    """_events() with a padding fill launched before the window and one after
    it, either of whose device record may be lost."""
    events, edges = _events()
    for corr, t, lose in ((1, -5.0, lose_lead), (5000, 45.0, lose_tail)):
        events.append(_ev("cuda_runtime", "cudaLaunchKernel", t, 0.5, corr))
        if not lose:
            events.append(_ev("kernel", "FillFunctor<int>", t + 1.0, 1.0, corr))
    return events, edges


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
    events, edges = _events()
    with pytest.raises(Lost):                       # the window's closing marker lost
        Trace([e for e in events if not (e["cat"] == "kernel" and e["ts"] == 71.0)], edges)


def test_padding_is_left_out():
    for lose_lead, lose_tail in ((False, False), (True, True)):
        tr = Trace(*_padded(lose_lead, lose_tail))
        assert {n for n, _, _, _ in tr.ops} == {"kern109", "kern110", "orphan"}
        assert tr.busy_s() == pytest.approx(16e-6)


@pytest.mark.parametrize("name", ["cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"])
def test_a_launch_inside_the_window_without_its_record_is_lost(name):
    events, edges = _events()
    events.append(_ev("cuda_runtime", name, 20.0, 0.5, 777))
    with pytest.raises(Lost, match="1 kernel launches"):
        Trace(events, edges)
    events[-1]["name"] = "cudaStreamSynchronize"     # no device record is due
    Trace(events, edges)


def test_a_lost_window_is_traced_anew(capsys):
    taken, reads = [], []

    def read(t):
        reads.append(t)
        if t < 2:
            raise Lost(f"reading {t} lost")
        return f"trace {t}"

    def take():
        taken.append(len(taken) + 1)
        return taken[-1]

    assert whole_trace(0, take, read, attempts=3) == "trace 2"
    assert reads == [0, 1, 2] and taken == [1, 2]
    assert capsys.readouterr().err.count("[trace] reading") == 2
    with pytest.raises(Lost):
        whole_trace(0, take, lambda t: read(-1), attempts=2)


def test_other_faults_are_not_traced_anew():
    def read(t):
        raise ValueError("span bench.pose closes bench.request")

    with pytest.raises(ValueError, match="closes"):
        whole_trace(0, lambda: pytest.fail("traced anew"), read)


def test_spans_off_do_nothing():
    s = Spans()
    with s.span("bench.pose"):
        pass
    assert s.edges == []
