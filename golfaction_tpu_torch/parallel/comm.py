"""The neighbour exchange along a mesh's data axis, and its transpose.

`exchange` is the plain step: data rank d sends a tensor to d + step and
returns what d - step sent, zeros where there is no such rank (or, cyclic,
the indices wrap).  `shift_down` is it as an autograd function: forward
along +1, backward the transposed exchange along -1, the cotangents going up
the mesh.  The JAX package gets both from `lax.ppermute` and its transpose.

Every rank posts its receive and its send together (`batch_isend_irecv`)
and then waits for both, so no pair of ranks can wait on each other at any
world size.  Every rank of the data group must call each exchange, in the
same order, with tensors of the same shape.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from golfaction_tpu_torch.parallel.mesh import Mesh, wire


def exchange(x: torch.Tensor, mesh: Mesh, step: int = 1, cyclic: bool = False) -> torch.Tensor:
    """What data rank d - step sent, on `x`'s device; zeros when there is no
    such rank (not cyclic).  Not differentiable."""
    P, d = mesh.dp, mesh.data_index
    dst, src = d + step, d - step
    if cyclic:
        dst, src = dst % P, src % P
        if dst == d:
            return x.detach().clone()
    send = wire(x, mesh).contiguous()
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= src < P:
        ops.append(dist.P2POp(dist.irecv, recv, mesh.data_ranks[src], mesh.data_group))
    if 0 <= dst < P:
        ops.append(dist.P2POp(dist.isend, send, mesh.data_ranks[dst], mesh.data_group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device)


class _ShiftDown(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, cyclic):
        ctx.mesh, ctx.cyclic = mesh, cyclic
        return exchange(x, mesh, 1, cyclic)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.mesh, -1, ctx.cyclic), None, None


def shift_down(x: torch.Tensor, mesh: Mesh, cyclic: bool = False) -> torch.Tensor:
    """Differentiable `exchange(x, mesh, +1, cyclic)`: rank d gets rank
    d - 1's x; the gradient of what d received goes back to d - 1."""
    return _ShiftDown.apply(x, mesh, cyclic)


def roll(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """torch.roll(global, 1, dims=0) of the global batch whose contiguous
    shard on this rank is `x`: row i takes row i - 1, the first row of a
    shard takes the last of the shard before it, the global first the global
    last.  Differentiable."""
    return torch.cat([shift_down(x[-1:], mesh, cyclic=True), x[:-1]])
