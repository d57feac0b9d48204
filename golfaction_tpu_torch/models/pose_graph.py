"""The ResNet pose net's forward on a full micro-batch, replayed as one
captured CUDA graph.

Eager, a micro-batch of the bfloat16 `PoseNet` is about 90 launches from
Python (23 convolutions with their weight casts, 18 `F.pad` copies, 20
launches of kernel G, the pool, the input cast, the projection's bias),
and the host takes longer to issue them than the card takes to run them.
`PoseGraphs` captures the forward once per input (shape, dtype, device)
and cuDNN settings (deterministic, benchmark, TF32), and then issues it as
one graph launch: the same kernels in the same
order on the same buffers, so the heatmaps are those of the eager call to
the bit.

`graph_route` says when a call may replay: the ResNet (`PoseNet`; the ViT
stays eager), crops on the card, no gradient to record, no forward hook on
the net or its modules (a replay would not call them), and exactly
`frame_batch` crops (a remainder micro-batch runs eager rather than
capturing a graph it would rarely use).  Everything else runs the module
as it always did.

A captured graph reads the live parameters (the weight casts are inside
it), so weights loaded in place take effect at the next replay; when a
parameter's storage moves (`.to()`, a new Parameter) the graph is captured
again.  Each call copies the crops into the graph's input buffer and
returns a clone of its output: the caller owns the heatmaps, and a later
replay never overwrites them.

Counters count what the card ran.  The eager warm-up before a capture
counts as it runs; the capture, which runs nothing, tallies what the
forward counts (profiling.tally: `gn_kernel` 23 and `launch.group_norm` 20
a call), and each replay counts that again, and `pose_graph`.  Each call on
a card tensor that ran eager counts `pose_eager`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.nn.modules import module as _module

from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.utils import profiling


def graph_route(resnet: bool, device_type: str, grad: bool, hooked: bool, batch: int,
                frame_batch: int) -> str:
    """How a pose-net call runs: "graph" (a replay of its captured CUDA
    graph) for the ResNet on the card with no gradient to record, no forward
    hook to call and a batch of exactly `frame_batch`; "eager" otherwise."""
    if resnet and device_type == "cuda" and not grad and not hooked and batch == frame_batch:
        return "graph"
    return "eager"


def _modules(model: torch.nn.Module) -> list:
    """model and its submodules (a walk of `_modules`, cheaper than
    `modules()`: the rule is read at every call)."""
    out = [model]
    for m in out:
        out.extend(c for c in m._modules.values() if c is not None)
    return out


def _tensors(modules: list) -> list:
    """The modules' parameters and buffers."""
    return [t for m in modules for d in (m._parameters, m._buffers) for t in d.values()
            if t is not None]


def _algorithm_flags() -> tuple:
    """The settings that steer cuDNN's choice of algorithm: a graph keeps
    the algorithms chosen at its capture, so a change of these asks for
    another graph (as eager calls would choose anew)."""
    cudnn = torch.backends.cudnn
    return (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
            torch.are_deterministic_algorithms_enabled())


def _hooked(modules: list) -> bool:
    """Whether a forward of these modules calls a forward hook (one of
    theirs or a global one)."""
    if _module._global_forward_hooks or _module._global_forward_pre_hooks:
        return True
    return any(m._forward_hooks or m._forward_pre_hooks for m in modules)


@dataclasses.dataclass
class Captured:
    """One captured forward: the graph, its input and output buffers, what
    the forward counted, the model and storage it was captured on, and the
    stream of its last replay."""
    graph: object
    static_in: torch.Tensor
    static_out: torch.Tensor
    counts: dict
    model: torch.nn.Module
    storage: tuple
    stream: object = None


class PoseGraphs:
    """`self(model, crops, frame_batch)` -> model(crops), by a replay of a
    captured graph where `graph_route` allows, else eager."""

    def __init__(self):
        self._graphs: dict = {}

    def __call__(self, model: torch.nn.Module, crops: torch.Tensor,
                 frame_batch: int) -> torch.Tensor:
        resnet = isinstance(model, PoseNet)
        modules = _modules(model) if resnet else []
        tensors = _tensors(modules)
        grad = torch.is_grad_enabled() and (
            crops.requires_grad or any(t.requires_grad for t in tensors))
        route = graph_route(resnet, crops.device.type, grad, _hooked(modules), crops.shape[0],
                            frame_batch)
        if route == "eager":
            if crops.device.type == "cuda":
                profiling.count("pose_eager")
            return model(crops)
        key = (tuple(crops.shape), crops.dtype, crops.device, _algorithm_flags())
        storage = tuple(t.data_ptr() for t in tensors)
        cap = self._graphs.get(key)
        if cap is None or cap.model is not model or cap.storage != storage:
            self._graphs.pop(key, None)              # free the old graph's pool first
            cap = self._graphs[key] = self._capture(model, crops, storage)
        stream = torch.cuda.current_stream(crops.device)
        if cap.stream is not None and cap.stream != stream:
            stream.wait_stream(cap.stream)           # the buffers' last users
        cap.stream = stream
        cap.static_in.copy_(crops)
        cap.graph.replay()
        for name, n in cap.counts.items():
            profiling.count(name, n)
        profiling.count("pose_graph")
        return cap.static_out.clone()

    def _capture(self, model: torch.nn.Module, crops: torch.Tensor, storage: tuple) -> Captured:
        # Outside inference mode, so that the buffers are ordinary tensors,
        # which a later call in any mode may copy into.
        with torch.inference_mode(False), torch.no_grad():
            static_in = crops.clone(memory_format=torch.contiguous_format)
            self._warm_up(model, static_in)
            with profiling.tally() as counts:
                graph, static_out = self._record(model, static_in)
        return Captured(graph, static_in, static_out, counts, model, storage)

    @staticmethod
    def _warm_up(model: torch.nn.Module, x: torch.Tensor) -> None:
        """One eager call on a side stream before the capture: cuDNN picks
        its plans and kernel G fills its card_limits / launch_geometry
        caches (a capture may query nothing of the card)."""
        cur = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            model(x)
        cur.wait_stream(side)

    @staticmethod
    def _record(model: torch.nn.Module, x: torch.Tensor) -> tuple:
        """(graph, output buffer) of model(x) captured on the card."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(x.device), \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = model(x)
        return graph, out
