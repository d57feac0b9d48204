"""The port's span and counter recorder (`utils/profiling.py`) and the spans
the per-chunk program records: off outside a profile, on inside one.  CPU,
except the last test, which needs a card (a CUDA-only profile).

    python -m pytest tests/test_torch_tracing.py -q
"""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.ops import softdtw
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.utils import profiling

TINY = ["pose.stage_blocks=(1,1)", "pose.stage_channels=(16,32)", "pose.deconv_channels=(16,)",
        "pose.input_hw=(64,48)", "pose.heatmap_hw=(16,12)", "gcn.block_channels=(16,32)",
        "error.hidden_dim=32", "align.hidden_channels=(16,32)", "align.embed_dim=16",
        "frame_batch=8"]
TRACKED = ["pose.decode_tracking=4", "error.mode_features=True"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_keeps_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("pose"):
        with profiling.host_sync():
            profiling.count("host_syncs", 3)
    rec = profiling.recorded()
    assert rec.spans == () and rec.counts == () and rec.dropped == 0
    # One shared no-op: an off edge allocates nothing.
    assert profiling.span("a") is profiling.span("b") is profiling.host_sync()


def test_on_under_a_cpu_profile_nests_and_counts():
    with _cpu_profile() as prof:
        for _ in range(2):                                   # two requests
            with profiling.span("req"):
                time.sleep(0.002)                            # the request's own time
                with profiling.span("child"):
                    profiling.count("things", 2)
                    with profiling.span("grandchild"):
                        profiling.count("things")
                with profiling.host_sync():
                    pass
        profiling.count("loose")
    rec = profiling.recorded()
    assert rec.dropped == 0
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    assert [s.name for s in spans] == ["req", "child", "grandchild", "sync"] * 2
    by_id = {s.id: s for s in spans}
    for req in (spans[0], spans[4]):
        kids = [s for s in spans if s.top == req.id]
        assert req.parent is None and len(kids) == 4          # the request id
        child, grand, sync = kids[1:]
        assert child.parent == req.id and sync.parent == req.id
        assert grand.parent == child.id and by_id[grand.parent].parent == req.id
        assert req.start_ns <= child.start_ns <= grand.start_ns <= grand.end_ns \
            <= child.end_ns <= sync.start_ns <= sync.end_ns <= req.end_ns
        own = (req.end_ns - req.start_ns) - sum(s.end_ns - s.start_ns for s in (child, sync))
        assert 2e6 <= own < req.end_ns - req.start_ns        # self time holds the sleep
    assert spans[0].top != spans[4].top
    counts = [(c.name, c.n, by_id[c.span].name if c.span is not None else None, c.top)
              for c in rec.counts]
    assert counts == [("things", 2, "child", spans[0].id), ("things", 1, "grandchild", spans[0].id),
                      ("host_syncs", 1, "req", spans[0].id),
                      ("things", 2, "child", spans[4].id), ("things", 1, "grandchild", spans[4].id),
                      ("host_syncs", 1, "req", spans[4].id), ("loose", 1, None, None)]
    names = {e.key for e in prof.key_averages()}
    assert {"req", "child", "grandchild", "sync"} <= names    # record_function ranges
    profiling.reset()
    assert profiling.recorded().spans == ()


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    rec = profiling.Recorder(capacity=3)
    with _cpu_profile():
        for _ in range(4):
            with rec.span("s"):
                pass
        rec.count("c")
    got = rec.recorded()
    assert len(got.spans) == 3 and got.counts == () and got.dropped == 2
    rec.reset()
    assert rec.recorded() == profiling.Recorded((), (), 0)


def test_a_span_closes_on_an_exception():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError("x")
        with profiling.span("after"):
            pass
    spans = {s.name: s for s in profiling.recorded().spans}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["after"].parent is None                     # the stack unwound


def test_stage_timer_breakdown_unchanged_and_each_stage_a_span():
    timer = profiling.StageTimer()
    with timer.stage("prep"):
        pass
    assert profiling.recorded().spans == ()                 # off: timed, not recorded
    with _cpu_profile():
        for stage in ("prep", "pose", "prep"):
            with timer.stage(stage, fence=torch.ones(1)):
                time.sleep(0.001)
    got = timer.breakdown()
    assert set(got) == {"prep", "pose"} and got["prep"]["count"] == 3
    assert got["pose"]["count"] == 1 and got["pose"]["total_s"] >= 1e-3
    for v in got.values():
        assert set(v) == {"total_s", "count", "mean_ms"}
        assert v["mean_ms"] == pytest.approx(1e3 * v["total_s"] / v["count"])
    assert [s.name for s in profiling.recorded().spans] == ["prep", "pose", "prep"]


def _pipeline(tracked: bool) -> Pipeline:
    cfg = tcfg.apply_overrides(tcfg.get_config(), TINY + (TRACKED if tracked else []))
    return Pipeline(cfg, device="cpu", seed=0)


def _request(pipe, seed=0):
    g = torch.Generator().manual_seed(seed)
    N, T, H, W = 2, 8, 48, 64
    frames = torch.randint(0, 256, (N, T, H, W, 3), dtype=torch.uint8, generator=g)
    boxes = torch.tensor([W / 2, H / 2, 40.0, 44.0]).expand(N, T, 4).contiguous()
    valid = torch.ones((N, T), dtype=torch.bool)
    valid[1, 6:] = False
    return frames, boxes, valid


def _program(pipe, phase_logits=True):
    frames, boxes, valid = _request(pipe)
    with torch.inference_mode():
        kpts, aux = pipe._pose_fn(frames, boxes)
        out = pipe._heads_fn(kpts, aux, valid)
        pipe._align_batch_fn(out["keypoints"], valid, out["keypoints"][0], valid[0],
                             out["phase_logits"] if phase_logits else None, out.get("kpt_aux"))


@pytest.mark.parametrize("tracked", [True, False], ids=["tracked", "single_peak"])
def test_the_per_chunk_program_records_its_spans_in_order(tracked):
    pipe = _pipeline(tracked)
    _program(pipe)                                           # off: nothing
    assert profiling.recorded().spans == ()
    with _cpu_profile():
        _program(pipe)
    rec = profiling.recorded()
    spans = sorted(rec.spans, key=lambda s: s.start_ns)
    # 2 clips x 8 frames in micro-batches of 8: two rounds of crops, net,
    # decode (the tracked decode copies a constant to the device: a sync);
    # then the mapping to image pixels copies its affine (a sync).
    batch = ["pose.crops", "pose.net", "pose.decode"] + (["sync"] if tracked else [])
    tail = ["pose.track", "sync", "pose.modes"] if tracked else ["pose.decode", "sync"]
    align = ["align", "align.encode", "align.cost", "align.path", "sync", "align.warp", "sync",
             "align.error"]
    assert [s.name for s in spans] == ["pose", *batch, *batch, *tail, "heads", *align]
    tops = [s for s in spans if s.parent is None]
    assert [s.name for s in tops] == ["pose", "heads", "align"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None and s.name != "sync":
            assert by_id[s.top].name == s.name.split(".")[0]
    syncs = [by_id[s.parent].name for s in spans if s.name == "sync"]
    assert syncs == (["pose.decode"] * 2 + ["pose.track"] if tracked else ["pose.decode"]) \
        + ["align.path", "align.warp"]
    assert [(c.name, c.n, by_id[c.span].name) for c in rec.counts] == \
        [("host_syncs", 1, name) for name in syncs]


def test_host_syncs_of_a_compare():
    pipe = _pipeline(False)

    def compare_syncs(phase_logits):
        profiling.reset()
        with _cpu_profile():
            _program(pipe, phase_logits)
        rec = profiling.recorded()
        align = {s.id for s in rec.spans if s.name == "align"}
        return sum(c.n for c in rec.counts if c.name == "host_syncs" and c.top in align)

    # The backtrack's step table, and with phase logits warp_by_path's read.
    assert compare_syncs(False) == 1
    assert compare_syncs(True) == 2


def test_warp_by_path_counts_its_read_and_answers_the_same():
    path = torch.tensor([[[0, 0], [1, 0], [1, 1], [2, 2], [-1, -1]]], dtype=torch.int32)
    ref = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    plain = softdtw.warp_by_path(ref, path, torch.tensor([4]), 3)
    with _cpu_profile():
        traced = softdtw.warp_by_path(ref, path, torch.tensor([4]), 3)
        empty = softdtw.warp_by_path(ref, path[:, :0], torch.tensor([0]), 3)
    assert torch.equal(plain, traced) and empty.abs().sum() == 0
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["sync"]           # L = 0 reads nothing
    assert [(c.name, c.n, c.span) for c in rec.counts] == [("host_syncs", 1, None)]



def test_device_trace_around_analyze_batch_shows_the_program(tmp_path):
    pipe = _pipeline(False)
    frames, boxes, _ = _request(pipe)
    with profiling.device_trace(str(tmp_path)):
        results = pipe.analyze_batch([f.numpy() for f in frames], boxes=[b.numpy() for b in boxes])
    assert len(results) == 2
    want = {"pose", "pose.crops", "pose.net", "pose.decode", "heads"}
    assert want <= {s.name for s in profiling.recorded().spans}
    (path,) = tmp_path.iterdir()
    assert want <= {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


@pytest.mark.cuda
def test_a_cuda_only_profile_turns_recording_on():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profile traces the card alone")
    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.autograd._profiler_enabled()
        with profiling.span("pose"):
            y = (x * 2).sum()
            profiling.count("host_syncs")
        torch.cuda.synchronize()
    assert float(y) == 2048.0
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["pose"] and rec.counts[0].name == "host_syncs"


@pytest.mark.cuda
@pytest.mark.parametrize("tracked", [True, False], ids=["tracked", "single_peak"])
def test_host_syncs_count_every_wait_the_card_reports(tracked):
    """On the card, torch's sync debug mode warns at each point where the host
    waits for the stream: the `host_syncs` counter counts the same points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync debug mode watches the card")
    import warnings

    pose_only = [o for o in TINY if o.startswith(("pose.", "frame_batch"))]
    cfg = tcfg.apply_overrides(tcfg.get_config(), pose_only + (TRACKED if tracked else []))
    pipe = Pipeline(cfg, device="cuda", seed=0)
    frames, boxes, valid = (t.cuda() for t in _request(pipe))

    def program():
        with torch.inference_mode():
            kpts, aux = pipe._pose_fn(frames, boxes)
            out = pipe._heads_fn(kpts, aux, valid)
            pipe._align_batch_fn(out["keypoints"], valid, out["keypoints"][0], valid[0],
                                 out["phase_logits"], out.get("kpt_aux"))

    program()                                                # builds the kernels
    torch.cuda.synchronize()
    profiling.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                program()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    waits = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    counted = sum(c.n for c in profiling.recorded().counts if c.name == "host_syncs")
    assert counted == len(waits) == (5 if tracked else 3)
