"""Fused int8 epilogue between two integer convolutions (kernel F).

    y_i32 --dequant--> GroupNorm --> [+ residual] --> [relu] --> int8 | bf16

`y_i32` [N, H, W, C] is an int8 x int8 -> int32 convolution output (channels
last, as an im2col product leaves it), `sy` [C] its per-channel dequantization
scales.  GroupNorm takes contiguous channel groups, epsilon 1e-6 and the
variance max(E[x^2] - mean^2, 0), in float32.  The optional residual is

  * an int8 tensor with one scale (identity shortcut), or
  * an int32 convolution output with per-channel scales and a GroupNorm of
    its own (projection shortcut).

With `out_scale` the result is clamp(round(x * (1 / out_scale)), -127, 127)
as int8 (round half to even); without, bfloat16.

  * `requant_epilogue` -- the entry point.  On CUDA tensors it launches the
    hand-written kernel (csrc/requant.cu), which replaces the TPU kernel
    golfaction_tpu/ops/pallas/requant_kernel.py (requant_epilogue_pallas), at
    every size; on CPU tensors it runs the plain version.
  * `requant_epilogue_plain` -- the same arithmetic in torch ops.
  * `launch_geometry` -- how the kernel's one launch cuts a call: a cluster
    of blocks per sample, each owning a run of rows it keeps in shared
    memory where the run fits, in one wave of blocks where it can.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from golfaction_tpu_torch.ops import _kernels

GN_EPS = 1e-6
MAX_CHANNELS = 1024          # a block's threads cover one row of channels
MAX_SMEM = 232448            # 227 KB, the most shared memory a block may ask for
MAX_CLUSTER = 16             # the largest (non-portable) cluster on the H100
THREADS_TARGET = 512         # threads of a block, about
H100_SMS = 132
H100_L2_BYTES = 50 * 2 ** 20
# A call whose int32 rows exceed this share of L2 reads them again from device
# memory if they are not staged; below it the second read mostly hits L2.
REREAD_L2_SHARE = 1.25


def group_stats(x: torch.Tensor, groups: int):
    """float32 x [N, ..., C] (channels last) -> (x as [N, R, G, C/G], mean,
    rstd [N, 1, G, 1]) over everything but the batch axis within each
    contiguous channel group, with flax's statistics: mean and mean of
    squares, variance clamped at 0, epsilon 1e-6."""
    N, C = x.shape[0], x.shape[-1]
    xg = x.reshape(N, -1, groups, C // groups)
    mu = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg * xg).mean(dim=(1, 3), keepdim=True) - mu * mu).clamp(min=0.0)
    return xg, mu, torch.rsqrt(var + GN_EPS)


def group_norm_rows(x: torch.Tensor, groups: int, gamma: torch.Tensor,
                    beta: torch.Tensor) -> torch.Tensor:
    """GroupNorm of float32 x [N, ..., C] (channels last), in the kernel's
    order: ((x - mean) * rstd) * gamma + beta."""
    xg, mu, rstd = group_stats(x, groups)
    return ((xg - mu) * rstd).reshape(x.shape) * gamma + beta


def _residual_mode(residual) -> int:
    if residual is None:
        return 0
    if residual.dtype == torch.int8:
        return 1
    if residual.dtype == torch.int32:
        return 2
    raise ValueError(f"requant_epilogue: residual must be int8 or int32, got {residual.dtype}")


def requant_epilogue_plain(y_i32, sy, gamma, beta, groups: int, residual=None,
                           res_scale=None, res_gamma=None, res_beta=None,
                           relu: bool = True, out_scale: float | None = None):
    """The epilogue in torch ops (see the module docstring)."""
    x = group_norm_rows(y_i32.float() * sy, groups, gamma, beta)
    mode = _residual_mode(residual)
    if mode == 1:
        x = x + residual.float() * float(res_scale)
    elif mode == 2:
        x = x + group_norm_rows(residual.float() * res_scale, groups, res_gamma, res_beta)
    if relu:
        x = x.clamp(min=0.0)
    if out_scale is None:
        return x.to(torch.bfloat16)
    inv = torch.tensor(1.0 / float(out_scale), dtype=torch.float32, device=x.device)
    return torch.round(x * inv).clamp(-127, 127).to(torch.int8)


class Geometry(NamedTuple):
    """One call's launch: `cluster` blocks per sample, block r owning rows
    [r * rpb, (r + 1) * rpb), `threads` threads that read `rpi` rows a pass
    for the statistics and write `wa` channels a thread; `staged`: the run
    (and an int32 residual's) stays in shared memory between the passes;
    `smem` bytes of shared memory a block."""
    wa: int
    threads: int
    rpi: int
    cluster: int
    rpb: int
    staged: bool
    smem: int


def _layout_bytes(C: int, groups: int, sources: int, rpb: int, rpi: int, staged: bool) -> int:
    """Shared memory as csrc/requant.cu lays it out (`layout`): the bulk
    copies' eight barriers, the per-channel vectors, the staged rows, the
    statistics tree or the per-channel constants, and the partial sums the
    cluster reads."""
    def round16(n):
        return -(-n // 16) * 16

    vecs = round16(sources * 3 * C * 4)
    stage = round16(sources * rpb * C * 4) if staged else 0
    scratch = max(sources * 2 * rpi * C * 4, sources * C * 16)
    return 64 + vecs + stage + scratch + sources * groups * 2 * 4


def launch_geometry(N: int, R: int, C: int, groups: int, res_mode: int, out_int8: bool,
                    aligned: bool = True, max_cluster: int = MAX_CLUSTER,
                    sms: int = H100_SMS, l2_bytes: int = H100_L2_BYTES,
                    cluster: int | None = None) -> Geometry:
    """The launch of one call on rows [N, R, C].  By default one wave: the
    cluster grows (a power of two up to `max_cluster`) until the grid holds
    at least half as many blocks as the card has SMs, or a block would have
    less than one pass of rows; a block stages its run where it fits in
    shared memory and reads it twice where it does not.  Where the wave
    does not stage and the call's int32 rows exceed REREAD_L2_SHARE of L2
    (the second read would come from device memory), the cluster is instead
    the smallest that stages: several waves, each byte read once (the stem
    and the last deconvolution at batch 64).  16-byte accesses (`wa` 16 for
    int8, 8 for bf16, else 4) need C % 4 == 0 and 16-byte aligned tensors
    (`aligned`).  `cluster` forces the cluster (to measure another layout)."""
    wa = 1
    if aligned and C % 4 == 0:
        wa = 4
        if out_int8 and C % 16 == 0:
            wa = 16
        elif not out_int8 and C % 8 == 0:
            wa = 8
    cv = C // 4 if wa > 1 else C
    rpi = 1
    while 2 * rpi * cv <= THREADS_TARGET:
        rpi *= 2
    sources = 2 if res_mode == 2 else 1

    def fits(cluster):
        return _layout_bytes(C, groups, sources, -(-R // cluster), rpi, True) <= MAX_SMEM

    if cluster is None:
        cluster = 1
        while (cluster < max_cluster and 2 * N * cluster <= sms
               and -(-R // (2 * cluster)) >= rpi):
            cluster *= 2
        if not fits(cluster) and N * R * C * 4 * sources > REREAD_L2_SHARE * l2_bytes:
            fit = cluster
            while fit < max_cluster and not fits(fit):
                fit *= 2
            if fits(fit):
                cluster = fit
    rpb = -(-R // cluster)
    staged = fits(cluster)
    return Geometry(wa, cv * rpi, rpi, cluster, rpb, staged,
                    _layout_bytes(C, groups, sources, rpb, rpi, staged))


_card: dict[int, tuple[int, int, int]] = {}


def card_limits(dev: torch.device) -> tuple[int, int, int]:
    """(largest cluster the card places at the kernel's largest block, SMs,
    L2 bytes), asked once per device: 16 where cudaOccupancyMaxActiveClusters
    places a cluster of 16 blocks of THREADS_TARGET threads and MAX_SMEM
    bytes, else 8 (the stem then takes the re-read branch)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _card:
        with torch.cuda.device(idx):
            fn = _kernels.bind("requant", "requant_max_active_clusters", "iiiii")
            placed = fn(16, 1, MAX_CLUSTER, THREADS_TARGET, MAX_SMEM)
        if placed < 0:
            _kernels.check(-placed, "requant cluster occupancy query")
        props = torch.cuda.get_device_properties(idx)
        _card[idx] = (MAX_CLUSTER if placed > 0 else 8, props.multi_processor_count,
                      props.L2_cache_size)
    return _card[idx]


def requant_epilogue(y_i32, sy, gamma, beta, groups: int, residual=None,
                     res_scale=None, res_gamma=None, res_beta=None,
                     relu: bool = True, out_scale: float | None = None):
    """y_i32 [N, H, W, C] int32, sy / gamma / beta [C] float32 -> [N, H, W, C]
    int8 (with `out_scale`) or bfloat16.  `residual` is int8 with the float
    `res_scale`, or int32 with `res_scale`, `res_gamma`, `res_beta` [C]."""
    if y_i32.device.type == "cpu":
        return requant_epilogue_plain(y_i32, sy, gamma, beta, groups, residual, res_scale,
                                      res_gamma, res_beta, relu, out_scale)
    _kernels.require(y_i32, torch.int32, 4, "requant_epilogue y")
    N, H, W, C = y_i32.shape
    R = H * W
    if C > MAX_CHANNELS or groups < 1 or C % groups:
        raise ValueError(f"requant_epilogue: C={C} with {groups} groups (C must be a multiple "
                         f"of groups and at most {MAX_CHANNELS})")
    if N > 65535:
        raise ValueError(f"requant_epilogue: batch {N} exceeds the launch grid (65535)")
    vecs = [sy, gamma, beta]
    mode = _residual_mode(residual)
    if mode:
        if residual.shape != y_i32.shape:
            raise ValueError(f"requant_epilogue: residual {tuple(residual.shape)} against "
                             f"{tuple(y_i32.shape)}")
        _kernels.require(residual, residual.dtype, 4, "requant_epilogue residual")
    if mode == 2:
        vecs += [res_scale, res_gamma, res_beta]
    for v in vecs:
        _kernels.require(v, torch.float32, 1, "requant_epilogue per-channel vector")
        if v.shape[0] != C or v.device != y_i32.device:
            raise ValueError(f"requant_epilogue: a per-channel vector of {v.shape[0]} on "
                             f"{v.device} for C={C} on {y_i32.device}")
    dev = y_i32.device
    out = torch.empty((N, H, W, C), device=dev,
                      dtype=torch.bfloat16 if out_scale is None else torch.int8)
    if out.numel() == 0:
        return out
    tensors = [y_i32, out] + ([residual] if mode else [])
    max_cluster, sms, l2 = card_limits(dev)
    geo = launch_geometry(N, R, C, groups, mode, out_scale is not None,
                          aligned=all(t.data_ptr() % 16 == 0 for t in tensors),
                          max_cluster=max_cluster, sms=sms, l2_bytes=l2)
    launch(out, geo, y_i32, sy, gamma, beta, groups, residual, res_scale, res_gamma, res_beta,
           relu, out_scale)
    requant_epilogue.launches += 1
    return out


def launch(out, geo: Geometry, y_i32, sy, gamma, beta, groups: int, residual=None,
           res_scale=None, res_gamma=None, res_beta=None, relu: bool = True,
           out_scale: float | None = None) -> None:
    """Kernel F into `out` under launch `geo` (the wrapper's, or another one
    to measure), on inputs `requant_epilogue` has checked; counts no launch."""
    N, H, W, C = y_i32.shape
    mode = _residual_mode(residual)
    null = ctypes.c_void_p(None)
    p = _kernels.ptr
    fn = _kernels.bind("requant", "requant_epilogue_launch", "ppppppppfiiifpiiiiiiiip")
    rc = fn(p(y_i32), p(sy), p(gamma), p(beta),
            p(residual) if mode else null,
            p(res_scale) if mode == 2 else null,
            p(res_gamma) if mode == 2 else null,
            p(res_beta) if mode == 2 else null,
            float(res_scale) if mode == 1 else 0.0, mode, int(bool(relu)),
            int(out_scale is not None), 0.0 if out_scale is None else 1.0 / float(out_scale),
            p(out), N, H * W, C, groups, geo.wa, geo.cluster, geo.rpb, int(geo.staged),
            _kernels.stream_of(y_i32))
    _kernels.check(rc, "requant epilogue kernel")


requant_epilogue.launches = 0
