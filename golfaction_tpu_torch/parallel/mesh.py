"""The device mesh over a torch.distributed process group, and moving a
batch or parameters onto it.

The counterpart of golfaction_tpu/parallel/mesh.py.  There one controller
holds a (data, model) mesh of devices and XLA inserts the collectives; here
one process drives one device (a rank) and the collectives are explicit.
The mesh lays the ranks of a group out as (data, model): rank r sits at data
index r // mp and model index r % mp.  The model axis replicates, as
P("data") does in JAX: the ranks of one data index hold the same shard and
compute the same values, and data collectives run over the ranks of one
model index (`Mesh.data_group`).

Payloads: a NCCL group's collectives take tensors on the card; a gloo
group's go through host tensors (gloo's support for CUDA tensors varies by
collective), which lets two gloo ranks share one card.  `wire` chooses by
the group's backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from golfaction_tpu_torch.config import MeshConfig


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    group: Any                 # the mesh's ranks, all data and model indices
    data_group: Any            # the ranks of this rank's model index, in data order
    data_ranks: tuple          # their global ranks, in data order
    dp: int
    mp: int
    data_axis: str
    model_axis: str
    rank: int                  # this rank within `group`
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {self.data_axis: self.dp, self.model_axis: self.mp}

    @property
    def data_index(self) -> int:
        return self.rank // self.mp


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() is "
                           "false; pass device='cpu' with the gloo backend to run on the CPU")
    return dev


def make_mesh(cfg: MeshConfig = MeshConfig(), group=None, device=None) -> Mesh:
    """A (data, model) mesh over `group` (default: the whole world) of an
    initialized process group.  data_parallel = -1 means world // mp.
    `device`: this rank's device; default the current card for either
    backend, raising without one: a rank runs on the CPU (gloo only) when
    `device="cpu"` asks for it.  Raises ValueError when dp·mp exceeds the
    group, and on a rank that the mesh leaves out (a group larger than
    dp·mp)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, or init_from_env)")
    group = group or dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    mp = max(cfg.model_parallel, 1)
    dp = cfg.data_parallel if cfg.data_parallel != -1 else world // mp
    if dp < 1 or dp * mp > world:
        raise ValueError(f"mesh {dp}x{mp} needs {max(dp, 1) * mp} devices, have {world}")
    members = dist.get_process_group_ranks(group)[:dp * mp]
    if rank >= dp * mp:
        raise ValueError(f"rank {rank} lies outside the {dp}x{mp} mesh of a {world}-rank "
                         f"group: start {dp * mp} processes")
    if dp * mp < world:
        group = dist.new_group(members, use_local_synchronization=True)
    data_ranks = tuple(members[d * mp + rank % mp] for d in range(dp))
    data_group = group if mp == 1 else dist.new_group(list(data_ranks),
                                                      use_local_synchronization=True)
    backend = str(dist.get_backend(group))
    device = _device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"a NCCL group needs a card, got device {device}")
    return Mesh(group=group, data_group=data_group, data_ranks=data_ranks, dp=dp, mp=mp,
                data_axis=cfg.data_axis, model_axis=cfg.model_axis, rank=rank, device=device,
                backend=backend)


def check_config(mesh: Mesh, cfg: MeshConfig) -> None:
    """Raise ValueError unless `mesh` has the layout `cfg` describes: its
    data and model sizes (data_parallel = -1 takes any) and axis names."""
    want = (mesh.dp if cfg.data_parallel == -1 else cfg.data_parallel,
            max(cfg.model_parallel, 1), cfg.data_axis, cfg.model_axis)
    if (mesh.dp, mesh.mp, mesh.data_axis, mesh.model_axis) != want:
        raise ValueError(f"the mesh {mesh.data_axis}={mesh.dp} x {mesh.model_axis}={mesh.mp} "
                         f"is not the layout of {cfg!r}: build it with make_mesh(cfg.mesh)")


def init_from_env(backend=None, device="cuda", cfg: MeshConfig = MeshConfig(),
                  timeout=None) -> Mesh:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR / MASTER_PORT) and return its mesh.  The rank
    runs on cuda:{LOCAL_RANK} over NCCL by default, and raises without a
    card; it runs on the CPU over gloo only when `device="cpu"` asks for it.
    `timeout`: a datetime.timedelta for every collective."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = _device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend needs a card; pass backend='gloo' for the CPU")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=timeout)
    return make_mesh(cfg, device=dev)


def wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A fresh copy of `t` to hand to a collective: on the card for NCCL, on
    the host for gloo."""
    if mesh.backend == "gloo":
        return t.detach().to("cpu", copy=True)
    return t.detach().clone()


def all_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` summed over the data shards, on `t`'s device; not differentiable
    (for normalizers, counts and reported values)."""
    w = wire(t, mesh)
    dist.all_reduce(w, group=mesh.data_group)
    return w.to(t.device)


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous slice of the leading axis of every tensor or
    array in `batch` (a tensor, or tuples, lists and dicts of them).  The
    axis must split evenly over the data shards, as JAX's P("data") needs."""
    def cut(x):
        n = x.shape[0]
        if n % mesh.dp:
            raise ValueError(f"a leading axis of {n} does not split over {mesh.dp} data shards")
        b = n // mesh.dp
        return x[mesh.data_index * b:(mesh.data_index + 1) * b]

    return _tree_map(cut, batch)


@torch.no_grad()
def replicate(module_or_state, mesh: Mesh):
    """Overwrite every parameter and buffer (a Module) or every tensor (a
    dict of them) with the mesh's rank 0's; returns its argument."""
    state = (module_or_state.state_dict() if isinstance(module_or_state, torch.nn.Module)
             else module_or_state)
    src = dist.get_global_rank(mesh.group, 0)
    for t in state.values():
        w = wire(t, mesh)
        dist.broadcast(w, src, group=mesh.group)
        t.copy_(w)
    return module_or_state


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        w = wire(x, mesh).contiguous()
        parts = [torch.empty_like(w) for _ in range(mesh.dp)]
        dist.all_gather(parts, w, group=mesh.data_group)
        return torch.cat(parts).to(x.device)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        b = g.shape[0] // mesh.dp
        return all_sum(g, mesh)[mesh.data_index * b:(mesh.data_index + 1) * b], None


def gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data shards' `x` (same shape on every rank) concatenated along
    axis 0, in data order.  Differentiable: each rank's gradient is the sum
    over ranks of the gradients of its slice, so the ranks' losses add up to
    one global loss, as in the data-parallel train step."""
    return _Gather.apply(x, mesh)


def gather_objects(obj, mesh: Mesh) -> list:
    """Every data shard's picklable `obj`, in data order (gloo: through the
    host; NCCL: through the current card).  Send host values: a pickled CUDA
    tensor comes back on its sender's device index."""
    out = [None] * mesh.dp
    dist.all_gather_object(out, obj, group=mesh.data_group)
    return out
