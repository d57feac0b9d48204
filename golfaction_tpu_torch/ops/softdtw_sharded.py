"""Soft-DTW of one long pair with the DP table in row bands over a mesh's
data axis: the counterpart of golfaction_tpu/ops/softdtw_sharded.py.

Layout and schedule (as the JAX package's).  D [Ta, Tb] is cut into P row
bands of Ra = ceil(Ta / P) rows (data rank p owns rows [p·Ra, (p+1)·Ra)) and
C column chunks of W = ceil(Tb / C) columns.  Rank p computes tile (p, c) at
outer step s = p + c, P + C - 1 steps in all.  A tile needs the row above
it, which rank p - 1 computed one step earlier and sends down with one
exchange of W floats a step (parallel.comm.exchange), its own previous
chunk's last column, and the corner, the last element of the row above that
it used for the previous chunk.  Non-multiple lengths are padded with the
+1e10 sentinel (`_INF`), which makes the padded cells unreachable; the cost
is read at the true corner cell, on the rank that holds it, and replicated
by an all-reduce.  The DP inside a tile is plain torch (`_tile_dp`: ops/softdtw.py's
`wavefront_plain` given the tile's boundary): the JAX version is plain XLA
too, and no kernel lies here.

Gradient.  The backward is the transposed schedule, written out: steps in
reverse order, each tile's vector-Jacobian product by autograd on the graph
its forward kept, and one exchange a step that sends the cotangents of the
row above (and of the corner) up the mesh.  It is written out, and not left
to the autograd engine over per-step exchanges, because the engine orders a
rank's nodes by that rank's own graph, which differs from rank to rank;
every rank here makes the same exchanges in the same order.  Each rank's
gradient holds its own band's rows of the Cuturi–Blondel E matrix and zeros
elsewhere; their sum over the ranks is E.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from golfaction_tpu_torch.ops.softdtw import _INF, wavefront_plain
from golfaction_tpu_torch.parallel import comm
from golfaction_tpu_torch.parallel import mesh as mesh_mod


def _tile_dp(Dt, top, left, corner, gamma: float) -> torch.Tensor:
    """R over one [Ra, W] tile of D given its boundary: top [W] = R of the row
    above, left [Ra] = R of the column to the left, corner = R above-left
    (0 seeds the global first cell); +_INF marks unreachable cells."""
    return wavefront_plain(Dt[None], gamma, top[None], left[None], corner.reshape(1))[0]


class _ShardedCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma, mesh, C):
        Ta, Tb = D.shape
        P, p = mesh.dp, mesh.data_index
        Ra, W = -(-Ta // P), -(-Tb // C)
        dev = D.device
        band = torch.full((Ra, W * C), _INF, dtype=torch.float32, device=dev)
        lo, hi = p * Ra, min((p + 1) * Ra, Ta)
        if hi > lo:
            band[:hi - lo, :Tb] = D[lo:hi].float()
        p_star, r_star = divmod(Ta - 1, Ra)
        c_star, w_star = divmod(Tb - 1, W)
        inf_row = torch.full((W,), _INF, device=dev)
        inf_col = torch.full((Ra,), _INF, device=dev)
        top, left, corner_top = inf_row, inf_col, inf_row[0]
        cost = torch.zeros((), device=dev)
        keep = ctx.needs_input_grad[0]
        tiles = {}
        for s in range(P + C - 1):
            c = s - p
            sent = inf_row
            if 0 <= c < C:
                corner = (torch.zeros((), device=dev) if p == 0 and c == 0
                          else inf_row[0] if p == 0 or c == 0 else corner_top)
                args = (band[:, c * W:(c + 1) * W], inf_row if p == 0 else top,
                        inf_col if c == 0 else left, corner)
                if keep:
                    args = tuple(a.detach().requires_grad_() for a in args)
                    with torch.enable_grad():
                        R = _tile_dp(*args, gamma)
                    tiles[c] = (R, args)
                    R = R.detach()
                else:
                    R = _tile_dp(*args, gamma)
                left, sent = R[:, W - 1], R[Ra - 1]
                if (p, c) == (p_star, c_star):
                    cost = R[r_star, w_star]
            corner_top = top[W - 1]
            top = comm.exchange(sent, mesh, 1)
        ctx.mesh, ctx.tiles = mesh, tiles
        ctx.geometry = (Ta, Tb, Ra, W, C, p_star, r_star, c_star, w_star)
        return mesh_mod.all_sum(cost, mesh)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        mesh = ctx.mesh
        Ta, Tb, Ra, W, C, p_star, r_star, c_star, w_star = ctx.geometry
        P, p = mesh.dp, mesh.data_index
        dev = g.device
        gband = torch.zeros((Ra, W * C), device=dev)
        from_below = torch.zeros(W, device=dev)   # cotangent of the row this rank sent
        g_left = g_corner = None                  # from the chunk to the right
        for s in reversed(range(P + C - 1)):
            c = s - p
            up = torch.zeros(W, device=dev)       # cotangent of the row above, for p - 1
            if 0 <= c < C:
                R, args = ctx.tiles.pop(c)
                gR = torch.zeros_like(R)
                gR[Ra - 1] += from_below
                if g_left is not None:
                    gR[:, W - 1] += g_left
                if (p, c) == (p_star, c_star):
                    gR[r_star, w_star] += g.float()
                gD, up, g_left, g_c = torch.autograd.grad(R, args, gR)
                gband[:, c * W:(c + 1) * W] = gD
                if g_corner is not None:
                    up[W - 1] += g_corner         # the corner of chunk c + 1
                g_corner = g_c if c > 0 else None
            from_below = comm.exchange(up, mesh, -1)
        gD = torch.zeros((Ta, Tb), device=dev)
        lo, hi = p * Ra, min((p + 1) * Ra, Ta)
        if hi > lo:
            gD[lo:hi] = gband[:hi - lo, :Tb]
        return gD, None, None, None


def softdtw_cost_sharded(D: torch.Tensor, gamma: float, mesh: mesh_mod.Mesh,
                         col_chunks: int | None = None) -> torch.Tensor:
    """Soft-DTW cost of one pair, D [Ta, Tb], row-band sharded over the
    mesh's data axis; the scalar cost on every rank.  Every rank passes the
    same full D, as the JAX signature takes the global array.
    `col_chunks` defaults to the number of data shards (a balanced systolic
    pipeline); raise it for finer overlap on a wide D.  Differentiable in D:
    call backward on every rank with the same upstream gradient (the copies
    of the cost count once); each rank's gradient holds its band's rows."""
    if gamma <= 0:
        raise ValueError("softdtw_cost_sharded needs gamma > 0")
    if D.dim() != 2:
        raise ValueError(f"softdtw_cost_sharded: expected D [Ta, Tb], got {tuple(D.shape)}")
    return _ShardedCost.apply(D, gamma, mesh, col_chunks or mesh.dp)
