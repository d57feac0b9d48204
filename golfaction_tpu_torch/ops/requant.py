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
"""

from __future__ import annotations

import ctypes

import torch

from golfaction_tpu_torch.ops import _kernels

GN_EPS = 1e-6
MAX_CHANNELS = 1024          # one thread per channel
_CHUNK_ELEMENTS = 8192       # elements one block walks in a pass


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


def launch_geometry(R: int, C: int) -> tuple[int, int, int]:
    """(threads per block, rows per chunk, chunks) for rows [R, C]: a thread
    owns one channel and one of `threads // C` row offsets."""
    rpi = max(1, 256 // C)
    rows = max(rpi, _CHUNK_ELEMENTS // C // rpi * rpi)
    return C * rpi, rows, -(-R // rows)


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
    threads, rows, chunks = launch_geometry(R, C)
    sources = 2 if mode == 2 else 1
    partial = torch.empty((sources, N, chunks, groups, 2), dtype=torch.float32, device=dev)
    stats = torch.empty((sources, N, groups, 2), dtype=torch.float32, device=dev)
    null = ctypes.c_void_p(None)
    p = _kernels.ptr
    fn = _kernels.bind("requant", "requant_epilogue_launch", "ppppppppfiiifpppiiiiiiip")
    rc = fn(p(y_i32), p(sy), p(gamma), p(beta),
            p(residual) if mode else null,
            p(res_scale) if mode == 2 else null,
            p(res_gamma) if mode == 2 else null,
            p(res_beta) if mode == 2 else null,
            float(res_scale) if mode == 1 else 0.0, mode, int(bool(relu)),
            int(out_scale is not None), 0.0 if out_scale is None else 1.0 / float(out_scale),
            p(partial), p(stats), p(out), N, R, C, groups, threads, rows, chunks,
            _kernels.stream_of(y_i32))
    _kernels.check(rc, "requant epilogue kernel")
    requant_epilogue.launches += 1
    return out


requant_epilogue.launches = 0
