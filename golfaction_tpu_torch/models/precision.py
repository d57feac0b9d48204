"""The models' compute dtype, as flax's `dtype` argument sets it.

A module configured with `dtype="bfloat16"` keeps float32 parameters and
computes as flax does with that dtype: each convolution and dense layer
rounds its input and its weight to bfloat16 and returns bfloat16 (the bias
added after the product's rounding), and each normalization takes its
statistics and arithmetic in float32 and rounds its result to bfloat16;
a sigmoid is JAX's, each of its steps rounded to bfloat16.
The activations' own dtype carries the choice from layer to layer, so a
float32 input runs every layer exactly as the float32 modules always did.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from golfaction_tpu_torch.ops import requant

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


def group_norm(x: torch.Tensor, gn: torch.nn.GroupNorm,
               channels_last: bool = False) -> torch.Tensor:
    """`gn` on x [N, C, ...] (or [N, ..., C] with channels_last) at x's
    dtype.  float32 x [N, C, ...] takes torch's group_norm; otherwise flax's
    statistics (requant.group_stats: mean and mean of squares, variance
    clamped at 0) and arithmetic run in float32 over the channels-last view,
    and the result is rounded to x.dtype."""
    if x.dtype == torch.float32 and not channels_last:
        return F.group_norm(x, gn.num_groups, gn.weight, gn.bias, gn.eps)
    xl = x if channels_last else x.movedim(1, -1)
    xg, mu, rstd = requant.group_stats(xl.float(), gn.num_groups)
    shape = (1, 1, gn.num_groups, -1)
    out = (xg - mu) * (rstd * gn.weight.reshape(shape)) + gn.bias.reshape(shape)
    out = out.reshape(xl.shape).to(x.dtype)
    return out if channels_last else out.movedim(-1, 1)


class GroupNorm(torch.nn.GroupNorm):
    """nn.GroupNorm over [N, C, ...] at its input's dtype (`group_norm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self)
