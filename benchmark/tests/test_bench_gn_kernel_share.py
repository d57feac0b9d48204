"""The `gn_kernel_share` reader: the program's `gn_kernel` and `gn_plain`
counters over the traced requests, read as the other program metrics are
(benchmark/program_spans.py)."""

from __future__ import annotations

import dataclasses
import types

import pytest

from benchmark import program_spans as ps
from benchmark.metrics import gn_kernel_share
from benchmark.tests.test_bench_program_spans import _snapshot, _trace
from golfaction_tpu_torch.utils.profiling import CountRecord


def _with_counts(counts):
    """The two-request snapshot with `counts` [(name, n)] made inside each
    request's `pose` span."""
    snap = _snapshot()
    tops = sorted({s.top for s in snap.spans if s.name == "pose"})
    extra = tuple(CountRecord(name, n, top, top) for top in tops for name, n in counts)
    return dataclasses.replace(snap, counts=snap.counts + extra)


@pytest.mark.parametrize("counts,share", [([("gn_kernel", 23)], 100.0),
                                          ([("gn_kernel", 20), ("gn_plain", 5)], 80.0),
                                          ([("gn_plain", 23)], 0.0)])
def test_share_of_group_norms_in_kernel_g(counts, share, monkeypatch):
    monkeypatch.setattr(ps, "snapshot", lambda: _with_counts(counts))
    run = types.SimpleNamespace(trace=_trace(), traced=[object(), object()])
    assert gn_kernel_share.read(run) == pytest.approx(share)


def test_left_out_where_the_program_counts_neither(monkeypatch):
    # A program without the counters (the parent of kernel G) or without a
    # recorder: nothing to read.
    monkeypatch.setattr(ps, "snapshot", lambda: _snapshot())
    assert gn_kernel_share.read(types.SimpleNamespace(trace=_trace(), traced=[1, 2])) is None
    monkeypatch.setattr(ps, "snapshot", lambda: None)
    assert gn_kernel_share.read(types.SimpleNamespace(trace=_trace(), traced=[1])) is None
    assert gn_kernel_share.read(types.SimpleNamespace(trace=None, traced=[])) is None
