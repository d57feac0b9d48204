"""Soft-DTW cost, hard-DTW table, path checks and the warp of a reference
along a path, as plain PyTorch."""

from __future__ import annotations

import torch

_INF = 1e10


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """D[..., Ta, Tb] = |a_i - b_j|^2, computed as |a|^2 + |b|^2 - 2 a.b, >= 0."""
    a, b = a.float(), b.float()
    an, bn = (a * a).sum(-1), (b * b).sum(-1)
    return torch.clamp(an[..., :, None] + bn[..., None, :] - 2.0 * a @ b.transpose(-1, -2),
                       min=0.0)


def dtw_table(D: torch.Tensor, gamma: float) -> torch.Tensor:
    """R[b, i, j] = D[b, i, j] + softmin_gamma(R[i-1, j], R[i, j-1], R[i-1, j-1])
    (the hard minimum at gamma 0), with R[-1, -1] = 0 and +INF off the
    table, one anti-diagonal a step: Ta + Tb - 1 vector steps."""
    B, Ta, Tb = D.shape
    D = D.float()
    dev = D.device
    R = torch.full((B, Ta + 1, Tb + 1), _INF, dtype=torch.float32, device=dev)
    R[:, 0, 0] = 0.0
    i_all = torch.arange(1, Ta + 1, device=dev)
    for k in range(2, Ta + Tb + 1):
        i = i_all[(k - i_all >= 1) & (k - i_all <= Tb)]
        j = k - i
        a, b, c = R[:, i, j - 1], R[:, i - 1, j], R[:, i - 1, j - 1]
        m = torch.minimum(torch.minimum(a, b), c)
        if gamma > 0:
            s = (torch.exp(-(a - m) / gamma) + torch.exp(-(b - m) / gamma)
                 + torch.exp(-(c - m) / gamma))
            m = m - gamma * torch.log(s)
        R[:, i, j] = D[:, i - 1, j - 1] + m
    return R[:, 1:, 1:]


def path_cost(D: torch.Tensor, path: torch.Tensor, length: torch.Tensor, la, lb):
    """Sum of D [B, Ta, Tb] along each path [B, L, 2] of `length` [B] steps,
    and whether the path is a DTW path of D[:la, :lb]: it starts at (0, 0),
    ends at (la-1, lb-1), and each step moves by (1, 0), (0, 1) or (1, 1).
    Returns (cost [B] float64, ok [B] bool)."""
    B, L, _ = path.shape
    n = length.long()
    steps = torch.arange(L, device=D.device)[None, :] < n[:, None]
    p = path.long()
    ok = (n >= 1) & (n <= L)
    inside = (p[..., 0] >= 0) & (p[..., 0] < la.long()[:, None]) & (p[..., 1] >= 0) \
        & (p[..., 1] < lb.long()[:, None])
    ok &= (inside | ~steps).all(dim=1)
    first = p[:, 0]
    last = torch.gather(p, 1, (n - 1).clamp(0, L - 1)[:, None, None].expand(B, 1, 2))[:, 0]
    ok &= (first == 0).all(-1) & (last[:, 0] == la.long() - 1) & (last[:, 1] == lb.long() - 1)
    d = p[:, 1:] - p[:, :-1]
    move = ((d[..., 0] == 1) & (d[..., 1] == 0)) | ((d[..., 0] == 0) & (d[..., 1] == 1)) \
        | ((d[..., 0] == 1) & (d[..., 1] == 1))
    ok &= (move | ~steps[:, 1:]).all(dim=1)
    pc = p.clamp(min=0)
    pc = torch.stack([pc[..., 0].clamp(max=D.shape[1] - 1), pc[..., 1].clamp(max=D.shape[2] - 1)], -1)
    vals = D[torch.arange(B, device=D.device)[:, None], pc[..., 0], pc[..., 1]].double()
    return (vals * steps).sum(dim=1), ok


def warp(ref: torch.Tensor, path: torch.Tensor, length: torch.Tensor, T: int) -> torch.Tensor:
    """ref [Tr, ...] warped onto T clip frames along paths [N, L, 2]: per clip
    frame, the mean of the reference frames the path pairs with it; zeros
    where the path never visits the frame."""
    N, L = path.shape[:2]
    dev = ref.device
    steps = torch.arange(L, device=dev)[None, :] < length.long()[:, None]
    ti = torch.where(steps, path[..., 0].long(), T)
    rj = torch.where(steps, path[..., 1].long(), 0).clamp(0, ref.shape[0] - 1)
    flat = (torch.arange(N, device=dev)[:, None] * (T + 1) + ti).reshape(-1)
    vals = ref[rj.reshape(-1)].float()
    acc = torch.zeros((N * (T + 1), *ref.shape[1:]), dtype=torch.float32, device=dev)
    acc.index_add_(0, flat, vals)
    cnt = torch.zeros(N * (T + 1), dtype=torch.float32, device=dev)
    cnt.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    acc = acc.reshape(N, T + 1, *ref.shape[1:])[:, :T]
    cnt = cnt.reshape(N, T + 1)[:, :T].clamp(min=1.0)
    return acc / cnt.reshape(N, T, *([1] * (ref.dim() - 1)))
