"""The measured window: a closed loop over the request order, and the
arithmetic of the end-to-end metrics over every request of the window.

A request is dispatched (the host clock read before its first call), an
event is recorded behind it, and once `in_flight` requests are out the
oldest one's event is waited for (the host clock read after the wait: its
completion).  Nothing is timed from medians of requests: a rate is all the
valid frames completed over all of the window's time, a tail is over every
request dispatched in it.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from benchmark.trace import Spans


@dataclasses.dataclass
class Done:
    item: tuple
    frames: int            # valid frames
    lengths: list          # valid length of each clip
    t_dispatch: float
    t_done: float = 0.0
    out: dict = None


def closed_loop(issue, order, in_flight: int, stop, device=None, spans=Spans()) -> list:
    """Dispatch `issue(item)` for items of `order` until `stop(n_dispatched,
    now)` says so, at most `in_flight` outstanding; then wait for the rest.
    issue(item) -> (outputs, valid frames, lengths).  Returns [Done] in
    dispatch order.  Each dispatch and each wait is a span of `spans`."""
    pending, done, n = collections.deque(), [], 0
    sync = torch.cuda.is_available() and device is not None and torch.device(device).type == "cuda"
    while True:
        now = time.perf_counter()
        if stop(n, now):
            break
        item = next(order)
        with spans.span("bench.request"):
            out, frames, lengths = issue(item)
            ev = None
            if sync:
                ev = torch.cuda.Event()
                ev.record()
        pending.append((Done(item, frames, lengths, now, out=out), ev))
        n += 1
        if len(pending) >= in_flight:
            done.append(_finish(*pending.popleft(), spans))
    while pending:
        done.append(_finish(*pending.popleft(), spans))
    return done


def _finish(d: Done, ev, spans=Spans()) -> Done:
    with spans.span("bench.wait"):
        if ev is not None:
            ev.synchronize()
    d.t_done = time.perf_counter()
    return d


def frames_per_s(done: list, t0: float, t1: float) -> float:
    """Valid frames of the requests completed inside [t0, t1], over t1 - t0."""
    return sum(d.frames for d in done if d.t_done <= t1) / (t1 - t0)


def latency_ms(done: list) -> np.ndarray:
    return np.asarray([(d.t_done - d.t_dispatch) * 1e3 for d in done], np.float64)


def percentile(values, q: float) -> float:
    """The q-th percentile (linear between order statistics), of all values."""
    return float(np.percentile(np.asarray(values, np.float64), q))
