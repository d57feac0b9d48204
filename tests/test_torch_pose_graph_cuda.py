"""The pose net's captured CUDA graph (`models/pose_graph.py`) on the card:
its heatmaps equal to the bit to the eager call, the outputs the caller
keeps, the calls that stay eager, capture again after the parameters move,
the counters a replay counts, and a traced window that still sees the net's
kernels inside the benchmark's pose span.

Every test needs a CUDA device and skips without one; on a machine with the
card (the conftest imports JAX, which that machine lacks):

    python -m pytest tests/test_torch_pose_graph_cuda.py -q --noconftest
"""

import collections
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models import pose as tpose
from golfaction_tpu_torch.models import pose_graph
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

BATCH = 64


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _shipped_net(dev, seed=0):
    net = tpose.PoseNet(tcfg.PoseConfig(dtype="bfloat16")).eval()
    weights.init_random(net, torch.Generator().manual_seed(seed))
    return net.to(dev)


def _crops(n, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, 256, 192, 3)).astype(np.float32)).to(dev)


def _counts() -> dict:
    out = {}
    for c in profiling.recorded().counts:
        out[c.name] = out.get(c.name, 0) + c.n
    return out


def test_replays_equal_eager_to_the_bit_and_are_kept(dev):
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    crops = [_crops(BATCH, s, dev) for s in (1, 2, 3)]
    with torch.inference_mode():
        kept = [graphs(net, c, BATCH) for c in crops]        # capture, then three replays
        want = [net(c) for c in crops]
    assert len(graphs._graphs) == 1
    (cap,) = graphs._graphs.values()
    for got, w in zip(kept, want):
        assert got.dtype == torch.float32 and got.shape == (BATCH, 17, 64, 48)
        assert got.data_ptr() != cap.static_out.data_ptr()
        assert torch.equal(got, w)             # the first kept is not overwritten by the others
    assert not torch.equal(kept[0], kept[1])


def test_a_remainder_runs_eager_and_counts_it(dev):
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    crops = _crops(40, 4, dev)
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CUDA]):
            got = graphs(net, crops, BATCH)
            torch.cuda.synchronize()
        assert torch.equal(got, net(crops))
    assert not graphs._graphs
    assert _counts() == {"gn_kernel": 23, "launch.group_norm": 20, "pose_eager": 1}


def test_captures_again_after_the_parameters_move_and_reads_new_weights_at_once(dev):
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    crops = _crops(BATCH, 5, dev)
    with torch.inference_mode():
        graphs(net, crops, BATCH)
        (first,) = graphs._graphs.values()
        net.load_state_dict(_shipped_net(dev, seed=7).state_dict())      # in place
        got = graphs(net, crops, BATCH)
        assert list(graphs._graphs.values()) == [first]
        assert torch.equal(got, net(crops))
        net.cpu().to(dev)                                                # storage moved
        got = graphs(net, crops, BATCH)
        (second,) = graphs._graphs.values()
        assert second is not first
        assert torch.equal(got, net(crops))


def test_deterministic_cudnn_takes_its_own_graph(dev):
    """A graph keeps the algorithms cuDNN chose at its capture: with cuDNN
    held to deterministic algorithms the call is captured anew, and two
    replays give the bits of the deterministic eager call."""
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    crops = _crops(BATCH, 11, dev)
    with torch.inference_mode():
        graphs(net, crops, BATCH)
        torch.backends.cudnn.deterministic = True
        try:
            got = [graphs(net, crops, BATCH) for _ in range(2)]
            want = net(crops)
        finally:
            torch.backends.cudnn.deterministic = False
    assert len(graphs._graphs) == 2
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


def test_a_replayed_call_counts_23_group_norms_and_one_replay(dev):
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    with torch.inference_mode():
        graphs(net, _crops(BATCH, 6, dev), BATCH)                        # the capture
        (first,) = graphs._graphs.values()
        profiling.reset()
        with profile(activities=[ProfilerActivity.CUDA]):
            with profiling.span("pose.net"):
                graphs(net, _crops(BATCH, 7, dev), BATCH)
            torch.cuda.synchronize()
    assert list(graphs._graphs.values()) == [first]                      # a replay alone
    assert _counts() == {"gn_kernel": 23, "launch.group_norm": 20, "pose_graph": 1}
    rec = profiling.recorded()
    (net_span,) = rec.spans
    assert all(c.span == net_span.id for c in rec.counts)


def test_kernel_g_launches_count_each_replay_and_not_the_capture(dev):
    """The counters count what the card ran: the first call's warm-up (20
    launches of G, 23 GroupNorms) and replay (20, 23), not its capture; 20
    and 23 each replay after."""
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    since = profiling.totals()

    def counted():                                   # (launches of G, GroupNorms)
        now = profiling.totals()
        return tuple(now.get(k, 0) - since.get(k, 0) for k in ("launch.group_norm", "gn_kernel"))

    with torch.inference_mode():
        graphs(net, _crops(BATCH, 12, dev), BATCH)
        assert counted() == (20 + 20, 23 + 23)
        for s in (13, 14):
            graphs(net, _crops(BATCH, s, dev), BATCH)
        assert counted() == (80, 92)
        net(_crops(BATCH, 15, dev))                                      # eager: 20 more
    assert counted() == (100, 115)
    (cap,) = graphs._graphs.values()
    assert cap.counts == {"gn_kernel": 23, "launch.group_norm": 20}


def test_a_graph_captured_in_inference_mode_replays_outside_it(dev):
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    with torch.inference_mode():
        graphs(net, _crops(BATCH, 16, dev), BATCH)
    crops = _crops(BATCH, 17, dev)
    with torch.no_grad():
        got = graphs(net, crops, BATCH)
        want = net(crops)
    assert len(graphs._graphs) == 1
    assert torch.equal(got, want)


def test_a_capture_under_a_profile(dev):
    """The first call of a shape made while a profile is on (a process
    traced from its start) captures, replays and counts as any other: its
    warm-up and its replay."""
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    crops = _crops(BATCH, 8, dev)
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CUDA]):
            got = graphs(net, crops, BATCH)
            torch.cuda.synchronize()
        assert torch.equal(got, net(crops))
    assert _counts() == {"gn_kernel": 23 + 23, "launch.group_norm": 20 + 20, "pose_graph": 1}


def _traced_pose(dev, call) -> list:
    """Device op names launched inside a `bench.pose` span around call(),
    from a profile read as a `--trace 1` run reads its window."""
    from benchmark import trace as tr

    spans = tr.Spans(dev, on=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.pad(dev, tr.LEAD)
        with spans.span("bench.window"):
            with spans.span("bench.pose"):
                call()
        tr.pad(dev, tr.TAIL, tr.TAIL_PAUSE_S)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"pose_graph_{os.getpid()}.json")
    trace = tr.Trace.from_profiler(prof, path, spans.edges)
    return [n for n, _, _, s in trace.ops if s == "bench.pose"]


def test_a_traced_window_sees_the_net_kernels_inside_the_pose_span(dev):
    net, graphs = _shipped_net(dev), pose_graph.PoseGraphs()
    crops = _crops(BATCH, 9, dev)
    with torch.inference_mode():
        graphs(net, crops, BATCH)                                        # the capture
        torch.cuda.synchronize()
        eager = collections.Counter(_traced_pose(dev, lambda: net(crops)))
        replay = collections.Counter(_traced_pose(dev, lambda: graphs(net, crops, BATCH)))
    print(f"eager {sum(eager.values())} device ops, replay {sum(replay.values())}")
    assert sum(1 for n in eager.elements() if "group_norm" in n) == 20
    # Every kernel of the eager call, plus the copy into the graph's input
    # and the clone of its output.
    assert not eager - replay
    assert sum((replay - eager).values()) == 2


def test_the_pipeline_pose_stage_equal_with_and_without_the_graph(dev, monkeypatch):
    """`_pose_fn` of the full_pipeline preset (the shipped widths, bfloat16,
    micro-batches of 64) on two clips of 96 frames, three full micro-batches:
    keypoints equal to the bit to the eager program's."""
    cfg = tcfg.get_config("full_pipeline")
    assert cfg.pose.dtype == "bfloat16" and cfg.frame_batch == BATCH
    assert cfg.box_refine_stride == 0
    pipe = Pipeline(cfg, device=dev, seed=0)
    rng = np.random.default_rng(10)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 96, 270, 480, 3), dtype=np.uint8)).to(dev)
    boxes = torch.tensor([240.0, 135.0, 120.0, 200.0], device=dev).expand(2, 96, 4).contiguous()
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CUDA]):
            got, _ = pipe._pose_fn(frames, boxes)
            torch.cuda.synchronize()
        counts = _counts()
        monkeypatch.setattr(pose_graph, "graph_route", lambda *a: "eager")
        want, _ = pipe._pose_fn(frames, boxes)
    assert counts["pose_graph"] == 3 and "pose_eager" not in counts
    assert counts["gn_kernel"] == 23 + 3 * 23                            # the warm-up, 3 replays
    assert torch.equal(got, want)
