"""The rate and tail arithmetic: every request, all of the window's time."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from benchmark import window


def done(t_dispatch, t_done, frames):
    return window.Done(item=(0, None), frames=frames, lengths=[frames],
                       t_dispatch=t_dispatch, t_done=t_done)


def test_rate_counts_requests_completed_inside_the_window_over_its_whole_length():
    ds = [done(0.0, 1.0, 100), done(0.5, 2.0, 50), done(1.0, 10.5, 70), done(9.0, 11.0, 30)]
    # The window is [0, 10]: the last two complete after it and do not count.
    assert window.frames_per_s(ds, 0.0, 10.0) == pytest.approx(150 / 10.0)
    assert window.frames_per_s(ds, 0.0, 20.0) == pytest.approx(250 / 20.0)


def test_tail_is_over_every_request_late_ones_too():
    ds = [done(float(i), float(i) + 0.1, 1) for i in range(19)] + [done(19.0, 29.0, 1)]
    lat = window.latency_ms(ds)
    assert lat.shape == (20,) and lat.max() == pytest.approx(10_000.0)
    assert window.percentile(lat, 90) == pytest.approx(np.percentile(lat, 90))
    assert window.percentile(lat, 100) == pytest.approx(10_000.0)


@pytest.mark.parametrize("in_flight", [1, 2, 3])
def test_closed_loop_keeps_at_most_in_flight_outstanding(in_flight, monkeypatch):
    outstanding, most = [0], [0]

    def issue(item):
        outstanding[0] += 1
        most[0] = max(most[0], outstanding[0])
        return {"item": item}, 10, [10]

    orig = window._finish

    def finish(*args):
        outstanding[0] -= 1
        return orig(*args)

    monkeypatch.setattr(window, "_finish", finish)
    ds = window.closed_loop(issue, itertools.count(), in_flight, lambda n, now: n >= 7)
    assert [d.item for d in ds] == list(range(7))
    assert most[0] == in_flight and outstanding[0] == 0
    assert all(d.t_done >= d.t_dispatch for d in ds)
    assert [d.out["item"] for d in ds] == list(range(7))
