"""The program's spans on the trace's clock (benchmark/program_spans.py), on a
hand-made CUPTI trace and a made-up snapshot of the program's recorder: the
clock offset under jittered latencies, the refusals, self time, idle by
innermost program span, and the eight readers."""

from __future__ import annotations

import importlib
import types

import pytest

from benchmark import program_spans as ps
from benchmark.trace import MARKER, Trace
from golfaction_tpu_torch.utils.profiling import CountRecord, Recorded, SpanRecord

OFF_US = 5_000_000.0            # the program's clock less the trace's
REQ_US = 1000.0                 # one request a millisecond
# (name, start, end) of the benchmark's spans in one request, trace clock (us).
BENCH = [("bench.request", 10, 700), ("bench.pose", 20, 300), ("bench.heads", 310, 400),
         ("bench.align", 410, 690), ("bench.wait", 700, 990)]
# The program's spans as they land on the trace's clock: (name, start, end,
# parent name); a top-level one starts where its LAGS entry puts it.
PROGRAM = [("pose", 20, 295, None), ("pose.crops", 30, 60, "pose"),
           ("pose.net", 60, 150, "pose"), ("pose.decode", 150, 200, "pose"),
           ("pose.track", 200, 280, "pose"),
           ("heads", 314, 395, None),
           ("align", 412, 685, None), ("align.encode", 420, 450, "align"),
           ("align.cost", 450, 470, "align"), ("align.path", 470, 520, "align"),
           ("align.warp", 520, 640, "align"), ("sync", 560, 630, "align.warp"),
           ("align.error", 640, 680, "align")]
LAGS = [{"pose": 3, "heads": 7, "align": 5}, {"pose": 9, "heads": 4, "align": 6}]
MIN_LAG = 3
# Device activity of one request: gaps 40-100 (pose.net), 150-210 (pose.decode),
# 240-310 (pose.track), 330-400 (heads), 480-490 (align.path), 560-620 (sync).
BUSY = [(0, 40), (100, 150), (210, 240), (310, 330), (400, 480), (490, 560), (620, 650),
        (650, 1000)]


def _ev(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _trace(n: int = 2) -> Trace:
    marks = [(0.0, "bench.window", 1), (n * REQ_US, "bench.window", -1)]
    for r in range(n):
        for name, a, b in BENCH:
            marks += [(r * REQ_US + a, name, 1), (r * REQ_US + b - 0.5, name, -1)]
    marks.sort(key=lambda m: (m[0], -m[2]))
    events, edges, corr = [], [], 0
    for t, name, edge in marks:
        corr += 1
        edges.append((name, edge))
        events += [_ev("cuda_runtime", "cudaLaunchKernel", t, 0.2, corr),
                   _ev("kernel", f"void at::native::k<{MARKER}>()", t + 1, 0.0, corr)]
    for r in range(n):
        for a, b in BUSY:
            corr += 1
            events += [_ev("cuda_runtime", "cudaLaunchKernel", r * REQ_US + 11, 0.2, corr),
                       _ev("kernel", f"kern{corr}", r * REQ_US + a, b - a, corr)]
    return Trace(events, edges)


def _snapshot(n: int = 2, drop_align: bool = False, heads_end: float = 395,
              dropped: int = 0) -> Recorded:
    """The program's records on its own clock (ns), in the order they closed.
    A top-level span opens `lag` us after its benchmark span: on the trace's
    clock (offset OFF_US + MIN_LAG) it lands lag - MIN_LAG us after it."""
    bench_start = {name: a for name, a, _ in BENCH}
    spans, counts, sid = [], [], 0
    for r in range(n):
        ids = {}
        for name, a, b, parent in PROGRAM:
            if drop_align and r == n - 1 and name.startswith(("align", "sync")):
                continue
            if parent is None:
                top = sid
                a = bench_start[f"bench.{name}"] + LAGS[r][name] - MIN_LAG
                b = heads_end if name == "heads" else b
            ids[name] = sid
            t0, t1 = ((r * REQ_US + t + OFF_US + MIN_LAG) * 1e3 for t in (a, b))
            spans.append(SpanRecord(name, int(t0), int(t1), sid,
                                    ids[parent] if parent else None, top))
            if name == "sync":
                counts.append(CountRecord("host_syncs", 1, ids["align.warp"], top))
            sid += 1
    return Recorded(tuple(sorted(spans, key=lambda s: s.end_ns)), tuple(counts), dropped)


def test_clock_offset_under_jittered_latencies():
    p = ps.build(_snapshot(), _trace())
    assert p is not None
    assert p.offset_us == pytest.approx(OFF_US + MIN_LAG)
    starts = {(round(s.start), s.name) for s in p.spans if s.parent is None}
    assert (20, "pose") in starts and (1000 + 20 + 6, "pose") in starts       # lag 9 - 3
    assert (310 + 4, "heads") in starts and (1000 + 310 + 1, "heads") in starts
    assert p.overhang_us <= 0.0


def test_self_time_and_sync():
    p = ps.build(_snapshot(), _trace())
    pose = [s for s in p.spans if s.name == "pose"]
    assert [round(s.self_us, 6) for s in pose] == [25.0, 19.0]     # 275 - 250; 269 - 250
    assert p.host_ms(ps.NET) == pytest.approx(2 * 120e-3)
    assert p.host_ms(ps.DECODE) == pytest.approx(2 * 130e-3)
    # align: 273 and 272 us long, less the sync's 70 each time.
    assert p.host_ms(ps.COMPARE) == pytest.approx((273 - 70 + 272 - 70) * 1e-3)
    assert p.sync_ms() == pytest.approx(2 * 70e-3)
    assert p.counts == {"host_syncs": 2}


def test_idle_goes_to_the_innermost_program_span():
    tr = _trace()
    p = ps.build(_snapshot(), tr)
    assert p.idle_ms(ps.NET) == pytest.approx(2 * 60e-3)
    assert p.idle_ms(ps.DECODE) == pytest.approx(2 * (60 + 70) * 1e-3)
    assert p.idle_ms(ps.COMPARE) == pytest.approx(2 * (10 + 60) * 1e-3)   # the sync's 60 too
    sync = [s for s in p.spans if s.name == "sync"]
    assert [s.idle_us for s in sync] == [pytest.approx(60.0)] * 2
    # The same gaps under the benchmark's spans: the cross-check of a traced run.
    bench = dict(tr.idle_gaps())
    for name, idle in p.idle_by_top().items():
        assert idle == pytest.approx(bench[ps.TOP[name]])


@pytest.mark.parametrize("case", ["dropped", "unequal", "overhang", "no_recorder", "empty"])
def test_nothing_is_read_when_the_mapping_cannot_be_trusted(case):
    tr = _trace()
    snap = {"dropped": lambda: _snapshot(dropped=1),
            "unequal": lambda: _snapshot(drop_align=True),
            "overhang": lambda: _snapshot(heads_end=399.5 + 51),
            "no_recorder": lambda: None,
            "empty": lambda: Recorded((), (), 0)}[case]()
    assert ps.build(snap, tr) is None


def test_an_overhang_inside_the_slack_is_read():
    p = ps.build(_snapshot(heads_end=399.5 + 49), _trace())
    assert p is not None and 48.0 < p.overhang_us < 50.0


READERS = {"net_host_ms_per_request": 0.120, "net_idle_ms_per_request": 0.060,
           "decode_host_ms_per_request": 0.130, "decode_idle_ms_per_request": 0.130,
           "compare_host_ms_per_request": (203 + 202) / 2e3,
           "compare_idle_ms_per_request": 0.070, "sync_wait_ms_per_request": 0.070,
           "host_syncs_per_request": 1.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_per_traced_request(name, monkeypatch):
    monkeypatch.setattr(ps, "snapshot", lambda: _snapshot())
    run = types.SimpleNamespace(trace=_trace(), traced=[object(), object()])
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(run) == pytest.approx(READERS[name])
    # Without the program's recorder (an older program) the metric is left out.
    monkeypatch.setattr(ps, "snapshot", lambda: None)
    assert reader.read(types.SimpleNamespace(trace=_trace(), traced=[object()])) is None
    assert reader.read(types.SimpleNamespace(trace=None, traced=[])) is None
