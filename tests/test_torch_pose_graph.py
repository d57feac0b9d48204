"""The pose net's CUDA-graph runner (`models/pose_graph.py`) on the CPU: the
routing rule as a decision, and the runner's bookkeeping (capture once,
replay, counts tallied at capture and counted again at each replay, outputs
the caller owns, capture again when the parameters move) with a stand-in for
the graph, which needs no card; `benchmark/metrics/pose_graph_share.py` on
recorded counts.  The graph itself is held to the eager call on the card
(tests/test_torch_pose_graph_cuda.py).

    python -m pytest tests/test_torch_pose_graph.py -q
"""

import itertools
import types

import pytest
import torch

from benchmark import program_spans as ps
from benchmark.metrics import pose_graph_share
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models import pose as tpose
from golfaction_tpu_torch.models import pose_graph
from golfaction_tpu_torch.ops import group_norm, kernel_counters
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.utils import profiling

TINY = tcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1),
                       stage_channels=(16, 32), deconv_channels=(32,))
BATCH = 4


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _counts() -> dict:
    out = {}
    for c in profiling.recorded().counts:
        out[c.name] = out.get(c.name, 0) + c.n
    return out


@pytest.mark.parametrize("backbone,device,grad,hooked,batch", list(itertools.product(
    ("resnet", "vit"), ("cuda", "cpu"), (False, True), (False, True), (64, 40))))
def test_graph_route(backbone, device, grad, hooked, batch):
    got = pose_graph.graph_route(backbone == "resnet", device, grad, hooked, batch, 64)
    want = backbone == "resnet" and device == "cuda" and not grad and not hooked and batch == 64
    assert got == ("graph" if want else "eager")


class CountingNet(tpose.PoseNet):
    """A ResNet pose net that counts as the shipped net's forward does on
    the card (23 GroupNorms in 20 launches of kernel G), and how often it
    ran."""

    def __init__(self):
        super().__init__(TINY)
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        profiling.count("gn_kernel", 23)
        group_norm.group_norm_act.launches += 20
        return super().forward(x)


class StandInGraphs(pose_graph.PoseGraphs):
    """The runner with the card's parts replaced: the warm-up runs the model
    eagerly, and a "graph" replays by running it again on the captured
    input buffer into the captured output buffer, counting nothing (a real
    replay runs no Python)."""

    def __init__(self):
        super().__init__()
        self.captures = 0

    @staticmethod
    def _warm_up(model, x):
        model(x)

    def _record(self, model, x):
        self.captures += 1
        out = model(x)

        def replay():
            launches = {fn: fn.launches for fn in kernel_counters().values()}
            with profiling.tally():
                out.copy_(model(x))
            for fn, n in launches.items():
                fn.launches = n

        return types.SimpleNamespace(replay=replay), out


@pytest.fixture
def on_cpu_as_card(monkeypatch):
    """The rule as on the card, for CPU tensors; streams a constant."""
    real = pose_graph.graph_route
    monkeypatch.setattr(pose_graph, "graph_route",
                        lambda resnet, device_type, *rest: real(resnet, "cuda", *rest))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: "stream")


def _net(seed=0):
    net = CountingNet().eval()
    weights.init_random(net, torch.Generator().manual_seed(seed))
    return net


def _crops(seed, n=BATCH):
    return torch.randn(n, 64, 48, 3, generator=torch.Generator().manual_seed(seed))


def test_replays_equal_eager_and_the_caller_owns_each_output(on_cpu_as_card):
    net, graphs = _net(), StandInGraphs()
    with torch.no_grad():
        crops = [_crops(s) for s in (1, 2, 3)]
        want = [net(c) for c in crops]
        kept = [graphs(net, c, BATCH) for c in crops]
    assert graphs.captures == 1
    (cap,) = graphs._graphs.values()
    for got, w in zip(kept, want):
        assert torch.equal(got, w)                        # not overwritten by later replays
        assert got.data_ptr() != cap.static_out.data_ptr()
    assert not torch.equal(kept[0], kept[1])


def test_counts_of_a_replayed_call(on_cpu_as_card):
    net, graphs = _net(), StandInGraphs()
    with torch.no_grad():
        with _cpu_profile():
            graphs(net, _crops(1), BATCH)                 # the capture, then its replay
        assert _counts() == {"gn_kernel": 23, "pose_graph": 1}
        profiling.reset()
        with _cpu_profile():
            for s in (2, 3):
                graphs(net, _crops(s), BATCH)
    assert _counts() == {"gn_kernel": 46, "pose_graph": 2}
    assert graphs.captures == 1
    (cap,) = graphs._graphs.values()
    assert cap.counts == {"gn_kernel": 23}


def test_launch_counters_count_the_warm_up_and_each_replay_not_the_capture(on_cpu_as_card):
    net, graphs = _net(), StandInGraphs()
    g = group_norm.group_norm_act
    with torch.no_grad():
        n0 = g.launches
        graphs(net, _crops(1), BATCH)                 # warm-up, capture, replay
        assert g.launches == n0 + 40
        for s in (2, 3):
            graphs(net, _crops(s), BATCH)
    assert g.launches == n0 + 80
    (cap,) = graphs._graphs.values()
    assert cap.launches == {g: 20}


def test_a_capture_in_inference_mode_serves_a_call_outside_it(on_cpu_as_card):
    net, graphs = _net(), StandInGraphs()
    with torch.inference_mode():
        first = graphs(net, _crops(1), BATCH)
    (cap,) = graphs._graphs.values()
    assert not cap.static_in.is_inference() and not cap.static_out.is_inference()
    with torch.no_grad():
        got = graphs(net, _crops(2), BATCH)
        want = net(_crops(2))
    assert graphs.captures == 1
    assert torch.equal(got, want) and torch.equal(first, net(_crops(1)))


def test_a_remainder_a_hook_and_a_gradient_run_eager(on_cpu_as_card):
    net, graphs = _net(), StandInGraphs()
    with torch.no_grad():
        small = _crops(1, BATCH - 1)
        assert torch.equal(graphs(net, small, BATCH), net(small))
        handle = net.blocks[0].register_forward_hook(lambda m, a, out: None)
        try:
            graphs(net, _crops(2), BATCH)
        finally:
            handle.remove()
    graphs(net, _crops(3), BATCH)                         # autograd records: eager
    assert graphs.captures == 0 and not graphs._graphs


def test_captures_again_when_the_parameters_move(on_cpu_as_card):
    net, graphs = _net(), StandInGraphs()
    crops = _crops(1)
    with torch.no_grad():
        graphs(net, crops, BATCH)
        # Weights loaded in place: the same graph, the new weights at once.
        net.load_state_dict(_net(seed=5).state_dict())
        assert torch.equal(graphs(net, crops, BATCH), net(crops))
        assert graphs.captures == 1
        # A parameter's storage moved (as after .to()): captured again.
        net.stem.weight.data = net.stem.weight.data.clone()
        assert torch.equal(graphs(net, crops, BATCH), net(crops))
        assert graphs.captures == 2
        other = _net(seed=6)                             # another module: its own capture
        assert torch.equal(graphs(other, crops, BATCH), other(crops))
        assert graphs.captures == 3 and len(graphs._graphs) == 1


def test_another_cudnn_setting_takes_another_graph(on_cpu_as_card, monkeypatch):
    net, graphs = _net(), StandInGraphs()
    with torch.no_grad():
        graphs(net, _crops(1), BATCH)
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
        graphs(net, _crops(2), BATCH)
        graphs(net, _crops(3), BATCH)
    assert graphs.captures == 2 and len(graphs._graphs) == 2


def test_cpu_tensors_run_eager_and_count_no_call():
    graphs = pose_graph.PoseGraphs()
    net = _net()
    with torch.no_grad(), _cpu_profile():
        got = graphs(net, _crops(1), BATCH)
    assert torch.equal(got, net(_crops(1)).detach())
    assert not graphs._graphs
    assert _counts() == {"gn_kernel": 23}               # the net's own; no pose_eager on the CPU


def test_the_pipeline_sends_each_pose_net_call_through_the_runner(monkeypatch):
    over = ["pose.stage_blocks=(1,1)", "pose.stage_channels=(16,32)",
            "pose.deconv_channels=(16,)", "pose.input_hw=(64,48)", "pose.heatmap_hw=(16,12)",
            "gcn.block_channels=(16,32)", "error.hidden_dim=32",
            "align.hidden_channels=(16,32)", "align.embed_dim=16", "frame_batch=8"]
    pipe = Pipeline(tcfg.apply_overrides(tcfg.get_config(), over), device="cpu", seed=0)
    seen = []
    real = pipe._pose_graphs

    def spy(model, crops, frame_batch):
        seen.append((model is pipe.pose_model, crops.shape[0], frame_batch))
        return real(model, crops, frame_batch)

    monkeypatch.setattr(pipe, "_pose_graphs", spy)
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (2, 6, 48, 64, 3), dtype=torch.uint8, generator=g)
    boxes = torch.tensor([32.0, 24.0, 40.0, 44.0]).expand(2, 6, 4).contiguous()
    with torch.inference_mode():
        pipe._pose_fn(frames, boxes)
        pipe._pose_heatmaps(frames[0], boxes[0])
    assert seen == [(True, 8, 8), (True, 4, 8), (True, 6, 8)]


def test_a_tally_takes_the_counts_of_its_block():
    with profiling.tally() as outer:
        profiling.count("a")
        with profiling.tally() as inner:
            profiling.count("a", 2)
            profiling.count("b")
        profiling.count("a")
    assert outer == {"a": 2} and inner == {"a": 2, "b": 1}
    with _cpu_profile():
        with profiling.tally() as under:
            profiling.count("a", 3)                      # tallied, not recorded
        profiling.count("a")
    assert under == {"a": 3} and _counts() == {"a": 1}


def _recorded_counts(counts) -> dict:
    """The counts [(name, n)] as the recorder keeps them under a profile,
    summed as benchmark/program_spans.py sums a traced window's."""
    with _cpu_profile():
        for name, n in counts:
            profiling.count(name, n)
    return _counts()


@pytest.mark.parametrize("counts,share", [([("pose_graph", 1)] * 14, 100.0),
                                          ([("pose_graph", 1)] * 3 + [("pose_eager", 1)], 75.0),
                                          ([("pose_eager", 1)] * 2, 0.0),
                                          ([("gn_kernel", 23), ("pose_graph", 1)], 100.0)])
def test_pose_graph_share(counts, share, monkeypatch):
    summed = _recorded_counts(counts)
    monkeypatch.setattr(ps, "program", lambda run: types.SimpleNamespace(counts=summed))
    assert pose_graph_share.read(object()) == pytest.approx(share)


def test_pose_graph_share_left_out_where_the_program_counts_neither(monkeypatch):
    # A program without the counters (the parent of the runner), or no program.
    summed = _recorded_counts([("gn_kernel", 23)])
    monkeypatch.setattr(ps, "program", lambda run: types.SimpleNamespace(counts=summed))
    assert pose_graph_share.read(object()) is None
    monkeypatch.setattr(ps, "program", lambda run: None)
    assert pose_graph_share.read(object()) is None
