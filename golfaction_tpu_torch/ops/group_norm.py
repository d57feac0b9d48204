"""The pose net's bfloat16 GroupNorm with the ReLU and residual add that
follow it (kernel G).

    x --GroupNorm--> [+ residual | + GroupNorm(x2)] --> [relu]

x [N, ..., C] is channels last (the NHWC memory of the pose net's
channels-last activations).  The GroupNorm is flax's at dtype=bfloat16, as
models/precision.py computes it: statistics (mean and mean of squares,
variance clamped at 0, epsilon 1e-6) and arithmetic in float32, then
(x - mean) * (rstd * gamma) + beta rounded to x's dtype.  The residual is a
tensor of x's dtype (an identity shortcut) or a second GroupNorm of its own
input (a projection shortcut), each rounded before the add; the add is
torch's at that dtype (in float32, rounded once).

  * `group_norm_act` -- the entry point.  On CUDA tensors it launches the
    hand-written kernel (csrc/group_norm.cu), one launch a call, for
    bfloat16 only; on CPU tensors it runs the plain version.  G replaces no
    Pallas kernel (the JAX package leaves this GroupNorm to XLA): it was
    added because the plain version is about fourteen ATen launches a
    GroupNorm and a dozen float32 passes over the activations.
  * `group_norm_act_plain` -- the same arithmetic in torch ops, the op
    sequence models/precision.py has always run.
  * `launch_geometry` -- how the kernel's one launch cuts a call: a cluster
    of blocks per sample, each owning a run of rows that it keeps in shared
    memory where the run fits, in one wave of blocks where it can.

Each launch counts the GroupNorms it computes on the program's `gn_kernel`
counter (utils/profiling.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from golfaction_tpu_torch.ops import _kernels, requant
from golfaction_tpu_torch.utils import profiling

VEC = 8                      # channels a thread reads and writes: 16 bytes of bfloat16
MAX_CHANNELS = 4096          # a block's threads cover one row of channels
MAX_SMEM = requant.MAX_SMEM
MAX_CLUSTER = requant.MAX_CLUSTER
THREADS_TARGET = 512         # threads of a block, about
CHUNKS = 8                   # bulk copies a staged run takes, each with an 8-byte barrier
H100_SMS = requant.H100_SMS
H100_L2_BYTES = requant.H100_L2_BYTES
# A call whose bfloat16 rows exceed this share of L2 reads them again from
# device memory if they are not staged; below it the second read hits L2,
# and re-reading at one wave of blocks beats staging with larger clusters
# (the projection shortcut at batch 64, 25 MB: 0.027 against 0.058 ms; the
# last deconvolution, 50 MB, staged: 0.060 against 0.071; NVIDIA H100).
REREAD_L2_SHARE = 0.75


def group_norm_plain(x: torch.Tensor, groups: int, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """GroupNorm of channels-last x [N, ..., C] at x's dtype: flax's
    statistics (requant.group_stats) and arithmetic in float32, rounded to
    x.dtype."""
    xg, mu, rstd = requant.group_stats(x.float(), groups)
    shape = (1, 1, groups, -1)
    out = (xg - mu) * (rstd * weight.reshape(shape)) + bias.reshape(shape)
    return out.reshape(x.shape).to(x.dtype)


def group_norm_act_plain(x: torch.Tensor, groups: int, weight: torch.Tensor,
                         bias: torch.Tensor, residual: torch.Tensor | None = None,
                         x2: torch.Tensor | None = None, weight2: torch.Tensor | None = None,
                         bias2: torch.Tensor | None = None, relu: bool = True) -> torch.Tensor:
    """The function in torch ops: GroupNorm of channels-last x, plus
    `residual` or plus the GroupNorm of `x2` (same groups, its own weight
    and bias), then relu when `relu`."""
    y = group_norm_plain(x, groups, weight, bias)
    if residual is not None:
        y = y + residual
    elif x2 is not None:
        y = y + group_norm_plain(x2, groups, weight2, bias2)
    return F.relu(y) if relu else y


class Geometry(NamedTuple):
    """One call's launch: `cluster` blocks per sample, block r owning rows
    [r * rpb, (r + 1) * rpb), `threads` threads that cover `rpi` rows a
    pass; `staged`: the run stays in shared memory between the statistics
    and the apply pass; `smem` bytes of shared memory a block."""
    threads: int
    rpi: int
    cluster: int
    rpb: int
    staged: bool
    smem: int


def _layout_bytes(C: int, groups: int, sources: int, rpb: int, rpi: int, staged: bool) -> int:
    """Shared memory as csrc/group_norm.cu lays it out (`layout`): the bulk
    copies' barriers, the staged rows, the statistics tree (later each
    group's mean and rstd), and the partial sums the cluster reads."""
    def round16(n):
        return -(-n // 16) * 16

    stage = round16(sources * rpb * C * 2) if staged else 0
    scratch = round16(max(sources * 2 * rpi * C * 4, sources * groups * 8))
    return CHUNKS * 8 + stage + scratch + sources * groups * 2 * 4


@functools.lru_cache(maxsize=256)     # a few shapes a net; pure, and called every launch
def launch_geometry(N: int, R: int, C: int, groups: int, sources: int,
                    max_cluster: int = MAX_CLUSTER, sms: int = H100_SMS,
                    l2_bytes: int = H100_L2_BYTES, cluster: int | None = None) -> Geometry:
    """The launch of one call on rows [N, R, C].  By default one wave: the
    cluster grows (a power of two up to `max_cluster`) until the grid holds
    at least half as many blocks as the card has SMs, or a block would have
    less than one pass of rows; a block stages its run where it fits in
    shared memory and reads it twice where it does not.  Where the wave
    does not stage and the call's rows exceed REREAD_L2_SHARE of L2 (the
    second read would come from device memory), the cluster is instead the
    smallest that stages: several waves, each byte read once (the stem and
    the last deconvolution at batch 64).  `cluster` forces the cluster (to
    measure another layout)."""
    cv = C // VEC
    rpi = 1
    while 2 * rpi * cv <= THREADS_TARGET:
        rpi *= 2

    def fits(cluster):
        return _layout_bytes(C, groups, sources, -(-R // cluster), rpi, True) <= MAX_SMEM

    if cluster is None:
        cluster = 1
        while (cluster < max_cluster and 2 * N * cluster <= sms
               and -(-R // (2 * cluster)) >= rpi):
            cluster *= 2
        if not fits(cluster) and N * R * C * 2 * sources > REREAD_L2_SHARE * l2_bytes:
            fit = cluster
            while fit < max_cluster and not fits(fit):
                fit *= 2
            if fits(fit):
                cluster = fit
    rpb = -(-R // cluster)
    staged = fits(cluster)
    return Geometry(cv * rpi, rpi, cluster, rpb, staged,
                    _layout_bytes(C, groups, sources, rpb, rpi, staged))


@functools.lru_cache(maxsize=256)
def mean_factor(N: int, R: int, C: int, groups: int) -> float:
    """The float32 factor torch's CUDA mean multiplies a group's sum by:
    float(outputs) / float(elements) of the [N, R, G, C/G] reduction."""
    return float(np.float32(N * groups) / np.float32(N * R * C))


_card: dict[int, tuple[int, int, int]] = {}


def card_limits(dev: torch.device) -> tuple[int, int, int]:
    """(largest cluster the card places at the kernel's largest block, SMs,
    L2 bytes), asked once per device: 16 where cudaOccupancyMaxActiveClusters
    places a cluster of 16 blocks of THREADS_TARGET threads and MAX_SMEM
    bytes, else 8."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _card:
        with torch.cuda.device(idx):
            fn = _kernels.bind("group_norm", "group_norm_max_active_clusters", "iiii")
            placed = fn(2, MAX_CLUSTER, THREADS_TARGET, MAX_SMEM)
        if placed < 0:
            _kernels.check(-placed, "group_norm cluster occupancy query")
        props = torch.cuda.get_device_properties(idx)
        _card[idx] = (MAX_CLUSTER if placed > 0 else 8, props.multi_processor_count,
                      props.L2_cache_size)
    return _card[idx]


def _rows(t: torch.Tensor, what: str, like: torch.Tensor | None = None) -> torch.Tensor:
    """t as the kernel reads it: a contiguous bfloat16 CUDA tensor, 16-byte
    aligned (and of `like`'s shape and device)."""
    _kernels.require(t, torch.bfloat16, t.dim(), f"group_norm_act {what}")
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f"group_norm_act: {what} {tuple(t.shape)} on {t.device} against "
                         f"{tuple(like.shape)} on {like.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"group_norm_act: {what} is not 16-byte aligned")
    return t


def _vector(v: torch.Tensor, C: int, dev: torch.device) -> torch.Tensor:
    _kernels.require(v, torch.float32, 1, "group_norm_act weight or bias")
    if v.shape[0] != C or v.device != dev:
        raise ValueError(f"group_norm_act: a weight or bias of {v.shape[0]} on {v.device} "
                         f"for C={C} on {dev}")
    return v


def group_norm_act(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
                   residual: torch.Tensor | None = None, x2: torch.Tensor | None = None,
                   weight2: torch.Tensor | None = None, bias2: torch.Tensor | None = None,
                   relu: bool = True) -> torch.Tensor:
    """Channels-last x [N, ..., C] -> relu(GroupNorm(x) [+ residual | +
    GroupNorm(x2)]) of x's shape and dtype (relu only when `relu`).  On the
    card x (with `residual` or `x2`) is contiguous bfloat16 and C a
    multiple of 8; weight, bias [C] float32."""
    if x.device.type == "cpu":
        return group_norm_act_plain(x, groups, weight, bias, residual, x2, weight2, bias2, relu)
    if residual is not None and x2 is not None:
        raise ValueError("group_norm_act: a residual or a second GroupNorm, not both")
    _rows(x, "x")
    N, C = x.shape[0], x.shape[-1]
    R = x.numel() // max(1, N * C)
    if C % VEC or C > MAX_CHANNELS or groups < 1 or C % groups:
        raise ValueError(f"group_norm_act: C={C} with {groups} groups (C must be a multiple "
                         f"of {VEC} and of groups, at most {MAX_CHANNELS})")
    if N > 65535:
        raise ValueError(f"group_norm_act: batch {N} exceeds the launch grid (65535)")
    dev = x.device
    vecs = [_vector(weight, C, dev), _vector(bias, C, dev)]
    mode = 0
    if residual is not None:
        mode = 1
        _rows(residual, "residual", x)
    elif x2 is not None:
        mode = 2
        _rows(x2, "x2", x)
        vecs += [_vector(weight2, C, dev), _vector(bias2, C, dev)]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    max_cluster, sms, l2 = card_limits(dev)
    geo = launch_geometry(N, R, C, groups, 2 if mode == 2 else 1, max_cluster, sms, l2)
    launch(out, geo, x, groups, weight, bias, residual, x2, weight2, bias2, relu)
    _wrapper.launches += 1
    profiling.count("gn_kernel", 2 if mode == 2 else 1)
    return out


def launch(out, geo: Geometry, x, groups: int, weight, bias, residual=None, x2=None,
           weight2=None, bias2=None, relu: bool = True) -> None:
    """Kernel G into `out` under launch `geo` (the wrapper's, or another one
    to measure), on inputs `group_norm_act` has checked; counts nothing."""
    N, C = x.shape[0], x.shape[-1]
    R = x.numel() // (N * C)
    mode = 1 if residual is not None else 2 if x2 is not None else 0
    null = ctypes.c_void_p(None)
    p = _kernels.ptr
    fn = _kernels.bind("group_norm", "group_norm_launch", "pppppppiifpiiiiiiip")
    rc = fn(p(x), p(weight), p(bias),
            p(x2) if mode == 2 else null,
            p(weight2) if mode == 2 else null,
            p(bias2) if mode == 2 else null,
            p(residual) if mode == 1 else null,
            mode, int(bool(relu)), mean_factor(N, R, C, groups), p(out),
            N, R, C, groups, geo.cluster, geo.rpb, int(geo.staged), _kernels.stream_of(x))
    _kernels.check(rc, "group_norm kernel")


group_norm_act.launches = 0
_wrapper = group_norm_act  # keeps the count where a caller rebinds the module's name
