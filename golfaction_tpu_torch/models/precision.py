"""The models' compute dtype, as flax's `dtype` argument sets it.

A module configured with `dtype="bfloat16"` keeps float32 parameters and
computes as flax does with that dtype: each convolution and dense layer
rounds its input and its weight to bfloat16 and returns bfloat16 (the bias
added after the product's rounding), and each normalization takes its
statistics and arithmetic in float32 and rounds its result to bfloat16
(on the card, with the ReLU and residual add after it, in one launch of
kernel G: `group_norm_act`);
a sigmoid is JAX's, each of its steps rounded to bfloat16.
The activations' own dtype carries the choice from layer to layer, so a
float32 input runs every layer exactly as the float32 modules always did.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from golfaction_tpu_torch.ops import group_norm as kernel_g
from golfaction_tpu_torch.utils import profiling

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """A config's `dtype` string -> the torch dtype the module computes in."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"dtype={name!r}: the models compute in one of "
                         f"{sorted(_DTYPES)}") from None


def linear(lin: torch.nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`lin` at x's dtype (flax Dense): weight rounded to x.dtype, the bias
    added after the product."""
    if x.dtype == lin.weight.dtype:
        return lin(x)
    y = F.linear(x, lin.weight.to(x.dtype))
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid at x's dtype: below float32 it is 1 / (1 + exp(-x))
    with each step rounded to x.dtype, as JAX lowers it."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def gn_route(device_type: str, dtype: torch.dtype, grad: bool, channels_last: bool) -> str:
    """Which code computes a GroupNorm of a tensor on `device_type` of
    `dtype`: "torch" (F.group_norm) for float32 [N, C, ...]; "kernel"
    (kernel G, ops/group_norm.py) for bfloat16 on the card with no gradient
    to record (`grad`: autograd is recording through it; G has no
    backward); "plain" (the op sequence in torch ops) otherwise."""
    if dtype == torch.float32 and not channels_last:
        return "torch"
    if device_type == "cuda" and dtype == torch.bfloat16 and not grad:
        return "kernel"
    return "plain"


def _norm_act(x: torch.Tensor, gn: torch.nn.GroupNorm, channels_last: bool, relu: bool,
              residual: torch.Tensor | None = None, residual_gn: torch.nn.GroupNorm | None = None,
              residual_x: torch.Tensor | None = None) -> torch.Tensor:
    two = residual_x is not None
    tensors = [x, gn.weight, gn.bias, residual, residual_x]
    if two:
        if residual_gn.num_groups != gn.num_groups:
            raise ValueError(f"group_norm_act: the shortcut's GroupNorm takes "
                             f"{residual_gn.num_groups} groups, the main one {gn.num_groups}")
        tensors += [residual_gn.weight, residual_gn.bias]
    grad = torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)
    route = gn_route(x.device.type, x.dtype, grad, channels_last)
    if route != "kernel" and x.device.type == "cuda":
        profiling.count("gn_plain", 2 if two else 1)
    if route == "torch":
        y = F.group_norm(x, gn.num_groups, gn.weight, gn.bias, gn.eps)
        if residual is not None:
            y = y + residual
        elif two:
            y = y + F.group_norm(residual_x, residual_gn.num_groups, residual_gn.weight,
                                 residual_gn.bias, residual_gn.eps)
        return F.relu(y) if relu else y

    def last(t):
        return t if t is None or channels_last else t.movedim(1, -1)

    fn = kernel_g.group_norm_act if route == "kernel" else kernel_g.group_norm_act_plain
    out = fn(last(x), gn.num_groups, gn.weight, gn.bias, last(residual), last(residual_x),
             residual_gn.weight if two else None, residual_gn.bias if two else None, relu)
    return out if channels_last else out.movedim(-1, 1)


def group_norm(x: torch.Tensor, gn: torch.nn.GroupNorm,
               channels_last: bool = False) -> torch.Tensor:
    """`gn` on x [N, C, ...] (or [N, ..., C] with channels_last) at x's
    dtype.  float32 x [N, C, ...] takes torch's group_norm; otherwise flax's
    statistics (requant.group_stats: mean and mean of squares, variance
    clamped at 0) and arithmetic run in float32 over the channels-last view,
    and the result is rounded to x.dtype: on the card in bfloat16 with no
    gradient to record by kernel G, else in torch ops (`gn_route`)."""
    return _norm_act(x, gn, channels_last, False)


def group_norm_act(x: torch.Tensor, gn: torch.nn.GroupNorm, residual: torch.Tensor | None = None,
                   residual_gn: torch.nn.GroupNorm | None = None,
                   residual_x: torch.Tensor | None = None) -> torch.Tensor:
    """relu(group_norm(x, gn) [+ residual | + group_norm(residual_x,
    residual_gn)]) on x [N, C, ...], each GroupNorm and the add rounded to
    x's dtype as torch rounds them: one launch of kernel G where `gn_route`
    says so.  On the card G takes x (and the residual) channels-last dense,
    NCHW with channels-last strides as the convolutions leave it, and
    raises on any other layout."""
    return _norm_act(x, gn, False, True, residual, residual_gn, residual_x)


class GroupNorm(torch.nn.GroupNorm):
    """nn.GroupNorm over [N, C, ...] at its input's dtype (`group_norm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self)
