"""The program's own spans and counters (golfaction_tpu_torch.utils.profiling:
`span`, `count`, `recorded`), kept while the traced window's profile was
active, put on the device trace's clock.

The program stamps its spans with `time.perf_counter_ns`; the trace's host
times come from the profiler's clock.  Each top-level program span (`pose`,
`heads`, `align`) runs inside the benchmark's own span around the same call
(`bench.pose`, `bench.heads`, `bench.align`; benchmark/system.py), and opens
a few microseconds after it, never before.  So the k-th program span of a
name is paired with the k-th benchmark span of its name, and the clock
offset is the smallest difference between a program start and its
benchmark start.  Nothing is read (None) when the recorder dropped records,
when the pairs do not match up, or when a mapped program span sticks out of
its benchmark span by more than `SLACK_US`: the offset would be wrong.

On that clock each program span gets its host self time (its duration less
the part its child spans cover) and the device's idle gaps whose midpoint
falls inside it as its innermost span, as `Trace.idle_gaps` credits them to
the benchmark's spans.  A `sync` span (where the host waits for the card) keeps
its own host time; its idle counts toward the span it opened in.
"""

from __future__ import annotations

import sys

from benchmark.trace import innermost

TOP = {"pose": "bench.pose", "heads": "bench.heads", "align": "bench.align"}
SLACK_US = 50.0
SYNC = "sync"

# The spans each metric reads (golfaction_tpu_torch/pipeline/orchestrator.py).
NET = ("pose.crops", "pose.net")
DECODE = ("pose.decode", "pose.track", "pose.modes")
COMPARE = ("align", "align.encode", "align.cost", "align.path", "align.warp", "align.error")


class PSpan:
    """A program span on the trace's clock (microseconds)."""

    __slots__ = ("name", "start", "end", "id", "parent", "owner", "self_us", "idle_us")

    def __init__(self, name, start, end, id_, parent):
        self.name, self.start, self.end, self.id, self.parent = name, start, end, id_, parent
        self.owner, self.self_us, self.idle_us = name, 0.0, 0.0


class Program:
    """The traced window's program spans (`spans`, sorted by start), the
    summed counters (`counts`), the clock offset (`offset_us`: program
    microseconds less trace microseconds) and the largest overhang of a
    top-level span past its benchmark span (`overhang_us`)."""

    def __init__(self, spans: list, counts: dict, offset_us: float, overhang_us: float):
        self.spans, self.counts = spans, counts
        self.offset_us, self.overhang_us = offset_us, overhang_us

    def host_ms(self, names) -> float:
        """Host self time of the spans called one of `names`."""
        return sum(s.self_us for s in self.spans if s.name in names) * 1e-3

    def idle_ms(self, names) -> float:
        """Device idle time credited to those spans and to the `sync` spans inside them."""
        return sum(s.idle_us for s in self.spans if s.owner in names) * 1e-3

    def sync_ms(self) -> float:
        """Host time inside `sync` spans."""
        return sum(s.end - s.start for s in self.spans if s.name == SYNC) * 1e-3

    def idle_by_top(self) -> dict:
        """{top-level name: idle seconds credited to it and everything inside it}."""
        by_id = {s.id: s for s in self.spans}
        out = dict.fromkeys(TOP, 0.0)
        for s in self.spans:
            top = s
            while top.parent is not None:
                top = by_id[top.parent]
            out[top.name] += s.idle_us * 1e-6
        return out


def build(recorded, trace) -> Program | None:
    """A snapshot of the program's recorder (profiling.Recorded) on the clock
    of `trace` (benchmark.trace.Trace), or None (see the module's doc)."""
    if recorded is None or recorded.dropped:
        return None
    tops = {n: sorted((s for s in recorded.spans if s.parent is None and s.name == n),
                      key=lambda s: s.start_ns) for n in TOP}
    marks = {n: sorted((s for s in trace.spans if s.name == b), key=lambda s: s.start)
             for n, b in TOP.items()}
    pairs = [(p, b) for n in TOP for p, b in zip(tops[n], marks[n])]
    if not pairs or any(len(tops[n]) != len(marks[n]) for n in TOP):
        return None
    offset = min(p.start_ns * 1e-3 - b.start for p, b in pairs)
    overhang = max(max(b.start - (p.start_ns * 1e-3 - offset),
                       p.end_ns * 1e-3 - offset - b.end) for p, b in pairs)
    if overhang > SLACK_US:
        return None
    kept = {p.id for p, _ in pairs}
    spans = [PSpan(s.name, s.start_ns * 1e-3 - offset, s.end_ns * 1e-3 - offset, s.id, s.parent)
             for s in recorded.spans if s.top in kept]
    _self_time_and_owner(spans)
    _credit_idle(spans, trace)
    counts: dict = {}
    for c in recorded.counts:
        if c.top in kept:
            counts[c.name] = counts.get(c.name, 0) + c.n
    return Program(sorted(spans, key=lambda s: (s.start, -s.end)), counts, offset, overhang)


def _self_time_and_owner(spans: list) -> None:
    by_id = {s.id: s for s in spans}
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    for s in spans:
        covered, reach = 0.0, s.start
        for c in sorted(children.get(s.id, ()), key=lambda c: c.start):
            a, b = max(c.start, reach, s.start), min(c.end, s.end)
            if b > a:
                covered += b - a
                reach = b
        s.self_us = (s.end - s.start) - covered
    for s in spans:                      # a sync's idle goes to the span it opened in
        owner = s
        while owner.name == SYNC and owner.parent in by_id:
            owner = by_id[owner.parent]
        s.owner = owner.name


def _credit_idle(spans: list, trace) -> None:
    ordered = sorted(spans, key=lambda s: (s.start, -s.end))
    starts = [s.start for s in ordered]
    w0, w1 = trace.window
    edges = [w0]
    for a, b in trace.busy_intervals():
        edges += [a, b]
    edges.append(w1)
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            s = innermost(ordered, starts, (a + b) / 2)
            if s is not None:
                s.idle_us += b - a


def snapshot():
    """The program recorder's snapshot, or None where the program has none."""
    try:
        from golfaction_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return recorded() if recorded is not None else None


def reset() -> None:
    """Empty the program's recorder, where the program has one."""
    try:
        from golfaction_tpu_torch.utils import profiling
    except ImportError:
        return
    r = getattr(profiling, "reset", None)
    if r is not None:
        r()


def program(run) -> Program | None:
    """The traced window's Program of a run (benchmark.run.Run), built once."""
    if run.trace is None or not run.traced:
        return None
    if not hasattr(run, "_program_spans"):
        p = build(snapshot(), run.trace)
        run._program_spans = p
        if p is not None:
            idle = ", ".join(f"{k} {v:.6f}" for k, v in p.idle_by_top().items())
            print(f"[program spans] {len(p.spans)} spans; offset {p.offset_us:.3f} us; "
                  f"largest overhang {p.overhang_us:.3f} us; idle s by top-level span: {idle}",
                  file=sys.stderr)
    return run._program_spans


def per_request(run, value) -> float | None:
    """value(Program) over the traced requests, or None without a Program."""
    p = program(run)
    return value(p) / len(run.traced) if p is not None else None
