"""Crop, heatmap decode and keypoint tracking, as plain PyTorch.

Coordinates follow the unbiased (UDP) corner-aligned convention: crop pixel
(0, 0) and (w-1, h-1) land on the box's corners, heatmap pixel (0, 0) and
(Wh-1, Hh-1) on the crop's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def center_scale(boxes: torch.Tensor, aspect: float, padding: float = 1.25) -> torch.Tensor:
    """(cx, cy, w, h) boxes widened to the crop's aspect (w / h) and padded by 1.25."""
    cx, cy, w, h = boxes.unbind(-1)
    w = torch.maximum(w, h * aspect)
    h = w / aspect
    return torch.stack([cx, cy, w * padding, h * padding], dim=-1)


def crops(frames: torch.Tensor, boxes: torch.Tensor, out_hw) -> torch.Tensor:
    """frames [B, H, W, 3] uint8, centre-scale boxes [B, 4] -> normalized
    crops [B, h, w, 3] float32: bilinear taps, zero outside the frame."""
    B, H, W, C = frames.shape
    oh, ow = out_hw
    cx, cy, bw, bh = boxes.float().unbind(-1)
    dev = frames.device
    sx = (cx - bw / 2.0)[:, None] + torch.arange(ow, device=dev) * (bw / (ow - 1))[:, None]
    sy = (cy - bh / 2.0)[:, None] + torch.arange(oh, device=dev) * (bh / (oh - 1))[:, None]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0                                   # [B, ow], [B, oh]
    flat = frames.reshape(B, H * W, C)
    out = torch.zeros((B, oh, ow, C), dtype=torch.float32, device=dev)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        yi = y0 + dy
        iny = (yi >= 0) & (yi < H)
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi = x0 + dx
            inx = (xi >= 0) & (xi < W)
            idx = yi.clamp(0, H - 1).long()[:, :, None] * W + xi.clamp(0, W - 1).long()[:, None]
            tap = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(B, oh * ow, C))
            wgt = (wy * iny)[:, :, None] * (wx * inx)[:, None, :]
            out += tap.reshape(B, oh, ow, C).float() * wgt[..., None]
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return (out / 255.0 - mean) / std


def _peak(hm: torch.Tensor):
    """First maximum of each map [..., H, W] -> (x, y, value)."""
    H, W = hm.shape[-2:]
    flat = hm.reshape(*hm.shape[:-2], H * W)
    peak = flat.max(dim=-1).values
    idx = (flat == peak[..., None]).to(torch.uint8).argmax(dim=-1)
    return idx % W, idx // W, peak


def _at(hm: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    H, W = hm.shape[-2:]
    flat = hm.reshape(*hm.shape[:-2], H * W)
    idx = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
    if idx.dim() == flat.dim() - 1:
        return torch.gather(flat, -1, idx[..., None])[..., 0]
    return torch.gather(flat, -1, idx)


def udp_offset(hm: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Sub-pixel step -H^-1 grad log h at integer (x, y), clipped to +-0.5,
    zero where the Hessian is not negative definite."""
    logh = torch.log(hm.clamp(min=1e-10))

    def g(dx, dy):
        return _at(logh, x + dx, y + dy)

    c = g(0, 0)
    xp, xm, yp, ym = g(1, 0), g(-1, 0), g(0, 1), g(0, -1)
    dx, dy = 0.5 * (xp - xm), 0.5 * (yp - ym)
    dxx, dyy = xp - 2.0 * c + xm, yp - 2.0 * c + ym
    dxy = 0.25 * (g(1, 1) - g(1, -1) - g(-1, 1) + g(-1, -1))
    det = dxx * dyy - dxy * dxy
    ok = (det.abs() > 1e-12) & (dxx < 0) & (dyy < 0)
    det = torch.where(ok, det, torch.ones_like(det))
    ox = torch.where(ok, (-(dyy * dx - dxy * dy) / det).clamp(-0.5, 0.5), torch.zeros_like(det))
    oy = torch.where(ok, (-(dxx * dy - dxy * dx) / det).clamp(-0.5, 0.5), torch.zeros_like(det))
    return ox, oy


def decode_single(hm: torch.Tensor) -> torch.Tensor:
    """Single-peak UDP decode: heatmaps [..., H, W] -> [..., 3] (x, y, peak)."""
    x, y, peak = _peak(hm)
    ox, oy = udp_offset(hm, x, y)
    return torch.stack([x.float() + ox, y.float() + oy, peak.float()], dim=-1)


def topk_modes(hm: torch.Tensor, k: int, radius: float) -> torch.Tensor:
    """k greedy rounds of (argmax over 3x3 local maxima, suppress a disk of
    `radius`) -> modes [..., k, 3], UDP-refined on the whole map; empty slots
    score 0 at (0, 0)."""
    H, W = hm.shape[-2:]
    dev = hm.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    pooled = F.max_pool2d(F.pad(hm.reshape(-1, 1, H, W), (1, 1, 1, 1), value=float("-inf")),
                          3, 1).reshape(hm.shape)
    neg = torch.tensor(-1e30, dtype=hm.dtype, device=dev)
    h = torch.where(hm >= pooled, hm, neg)
    xk, yk, pk = [], [], []
    for _ in range(k):
        x, y, p = _peak(h)
        d2 = (xs - x[..., None, None].float()) ** 2 + (ys - y[..., None, None].float()) ** 2
        h = torch.where(d2 <= radius ** 2, neg, h)
        xk.append(x)
        yk.append(y)
        pk.append(p)
    xk, yk = torch.stack(xk, -1), torch.stack(yk, -1)
    ox, oy = udp_offset(hm, xk, yk)
    score = torch.stack(pk, -1).float().clamp(min=0.0)
    return torch.stack([xk.float() + ox, yk.float() + oy, score], dim=-1)


def to_image(kpts_hm: torch.Tensor, boxes: torch.Tensor, heatmap_hw, crop_hw) -> torch.Tensor:
    """Heatmap-px keypoints [..., K, 3] -> image px through centre-scale boxes [..., 4]."""
    (Hh, Wh), (Hc, Wc) = heatmap_hw, crop_hw
    cx, cy, w, h = boxes.unbind(-1)
    sx = (w / (Wc - 1)) * ((Wc - 1) / (Wh - 1))
    sy = (h / (Hc - 1)) * ((Hc - 1) / (Hh - 1))
    x = kpts_hm[..., 0] * sx[..., None] + (cx - w / 2.0)[..., None]
    y = kpts_hm[..., 1] * sy[..., None] + (cy - h / 2.0)[..., None]
    return torch.stack([x, y, kpts_hm[..., 2]], dim=-1)


def viterbi(modes: torch.Tensor, lam: float, eps: float = 1e-6) -> torch.Tensor:
    """Per track, the mode sequence minimizing sum_t -log(score_t) +
    lam * |xy_t - xy_{t-1}|^2; empty slots cost 1e9, ties take the first
    index.  modes [T, ..., k, 3] -> [T, ..., 3]."""
    xy, score = modes[..., :2], modes[..., 2]
    unary = torch.where(score > 0.0, -torch.log(score.clamp(min=eps)),
                        torch.full_like(score, 1e9))
    T = modes.shape[0]
    cost, backs = unary[0], []
    for t in range(1, T):
        d2 = ((xy[t][..., None, :, :] - xy[t - 1][..., :, None, :]) ** 2).sum(-1)
        tot = cost[..., :, None] + lam * d2
        mins = tot.min(dim=-2).values
        backs.append((tot == mins[..., None, :]).to(torch.uint8).argmax(dim=-2))
        cost = mins + unary[t]
    idx = [(cost == cost.min(dim=-1, keepdim=True).values).to(torch.uint8).argmax(dim=-1)]
    for back in reversed(backs):
        idx.append(torch.gather(back, -1, idx[-1][..., None])[..., 0])
    idx = torch.stack(idx[::-1], dim=0)
    sel = idx[..., None, None].expand(*idx.shape, 1, modes.shape[-1])
    return torch.gather(modes, modes.dim() - 2, sel)[..., 0, :]


def secondary_modes(img: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
    """(dx, dy, rel_mass, sep) [..., V, 4] of the strongest mode that the
    track did not select, relative to the selection; zeros where none.
    img [..., V, K, 3] (image px), kpts [..., V, 3]."""
    K = img.shape[-2]
    d = img[..., :2] - kpts[..., None, :2]
    dist = torch.linalg.norm(d, dim=-1)
    score = img[..., 2]
    inf = torch.full_like(dist, float("inf"))
    sel = torch.where(score > 0, dist, inf).argmin(dim=-1)
    other = torch.where(F.one_hot(sel, K).bool() | (score <= 0), -inf, score)
    best = other.argmax(dim=-1)
    has = torch.isfinite(torch.gather(other, -1, best[..., None]))[..., 0]
    dj = torch.gather(d, -2, best[..., None, None].expand(*best.shape, 1, 2))[..., 0, :]
    sj = torch.gather(score, -1, best[..., None])[..., 0]
    zero = torch.zeros_like(sj)
    rel = torch.where(has, sj / kpts[..., 2].clamp(min=1e-6), zero)
    sep = torch.where(has, torch.linalg.norm(dj, dim=-1), zero)
    off = torch.where(has[..., None], dj, torch.zeros_like(dj))
    return torch.cat([off, rel[..., None], sep[..., None]], dim=-1)
