"""Heatmap keypoint decode: single-peak decode with sub-pixel refinement,
top-k non-max-suppressed modes, Viterbi mode tracking over a clip, and the
windowed heatmap moments of the spread features.

All functions take heatmaps [..., K, H, W] and are vectorized over the
batch dims; coordinates are in heatmap pixel space (corner-aligned) until
`keypoints_to_image` maps them into source-image pixels.

`decode_heatmaps(hm, "udp")` on a CUDA tensor launches the hand-written
kernel csrc/decode.cu (kernel D), which replaces the TPU kernel
golfaction_tpu/ops/pallas/decode_kernel.py (decode_heatmaps_pallas); on a CPU
tensor it runs `decode_heatmaps_plain`.  Everything else here is plain torch
ops: the reference computes them outside any hand-written kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from golfaction_tpu_torch.ops import _kernels, affine
from golfaction_tpu_torch.utils import profiling


def _peak_coords(heatmaps: torch.Tensor):
    """Flat argmax (first maximum) -> (x, y) int coords + peak value."""
    H, W = heatmaps.shape[-2:]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], H * W)
    peak, idx = flat.max(dim=-1)
    # torch.max does not promise the first index on ties; argmax of the
    # equality mask does.
    idx = (flat == peak[..., None]).to(torch.uint8).argmax(dim=-1)
    return idx % W, idx // W, peak


def _gather_at(heatmaps: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """heatmaps [..., H, W] sampled at integer (x, y) with edge clamping;
    x, y are [...] (one point per map) or [..., n] (n points per map)."""
    H, W = heatmaps.shape[-2:]
    flat = heatmaps.reshape(*heatmaps.shape[:-2], H * W)
    idx = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
    if idx.dim() == flat.dim() - 1:
        return torch.gather(flat, -1, idx[..., None])[..., 0]
    return torch.gather(flat, -1, idx)


def _udp_offset(heatmaps: torch.Tensor, x_i: torch.Tensor, y_i: torch.Tensor):
    """DARK/UDP sub-pixel offset -H⁻¹ ∇ log h at integer peak (x_i, y_i),
    clipped to ±0.5 px, zero where the Hessian is not negative definite."""
    logh = torch.log(heatmaps.clamp(min=1e-10))

    def g(dx, dy):
        return _gather_at(logh, x_i + dx, y_i + dy)

    c = g(0, 0)
    xp, xm, yp, ym = g(1, 0), g(-1, 0), g(0, 1), g(0, -1)
    xpyp, xpym, xmyp, xmym = g(1, 1), g(1, -1), g(-1, 1), g(-1, -1)
    dx = 0.5 * (xp - xm)
    dy = 0.5 * (yp - ym)
    dxx = xp - 2.0 * c + xm
    dyy = yp - 2.0 * c + ym
    dxy = 0.25 * (xpyp - xpym - xmyp + xmym)
    det = dxx * dyy - dxy * dxy
    safe = (det.abs() > 1e-12) & (dxx < 0) & (dyy < 0)
    det = torch.where(safe, det, torch.ones_like(det))
    off_x = -(dyy * dx - dxy * dy) / det
    off_y = -(dxx * dy - dxy * dx) / det
    zero = torch.zeros_like(off_x)
    off_x = torch.where(safe, off_x.clamp(-0.5, 0.5), zero)
    off_y = torch.where(safe, off_y.clamp(-0.5, 0.5), zero)
    return off_x, off_y


def decode_heatmaps_plain(heatmaps: torch.Tensor, method: str = "udp") -> torch.Tensor:
    """heatmaps [..., K, H, W] -> keypoints [..., K, 3] (x, y, score)."""
    x_i, y_i, peak = _peak_coords(heatmaps)
    x = x_i.float()
    y = y_i.float()
    if method == "argmax":
        pass
    elif method == "quarter":
        right = _gather_at(heatmaps, x_i + 1, y_i)
        left = _gather_at(heatmaps, x_i - 1, y_i)
        up = _gather_at(heatmaps, x_i, y_i - 1)
        down = _gather_at(heatmaps, x_i, y_i + 1)
        x = x + 0.25 * torch.sign(right - left)
        y = y + 0.25 * torch.sign(down - up)
    elif method == "udp":
        off_x, off_y = _udp_offset(heatmaps, x_i, y_i)
        x = x + off_x
        y = y + off_y
    else:
        raise ValueError(f"unknown decode method: {method!r}")
    return torch.stack([x, y, peak.float()], dim=-1)


def decode_heatmaps(heatmaps: torch.Tensor, method: str = "udp") -> torch.Tensor:
    """heatmaps [..., K, H, W] -> keypoints [..., K, 3] (x, y, score): the
    first maximum of each map, refined by `method` ("udp": DARK/UDP Taylor
    step, kernel D on the card; "quarter"; "argmax")."""
    if method != "udp" or heatmaps.device.type == "cpu":
        return decode_heatmaps_plain(heatmaps, method)
    if heatmaps.dim() < 2 or heatmaps.shape[-1] * heatmaps.shape[-2] == 0:
        raise ValueError(f"decode_heatmaps: expected [..., H, W], got {tuple(heatmaps.shape)}")
    *lead, H, W = heatmaps.shape
    hm = heatmaps.float().reshape(-1, H * W).contiguous()
    _kernels.require(hm, torch.float32, 2, "decode heatmaps")
    M = hm.shape[0]
    out = torch.empty((M, 3), dtype=torch.float32, device=hm.device)
    if M == 0:
        return out.reshape(*lead, 3)
    fn = _kernels.bind("decode", "decode_heatmaps_launch", "ppiiip")
    rc = fn(_kernels.ptr(hm), _kernels.ptr(out), M, H, W, _kernels.stream_of(hm))
    _kernels.check(rc, "heatmap decode kernel")
    decode_heatmaps.launches += 1
    return out.reshape(*lead, 3)


decode_heatmaps.launches = 0


def topk_modes(heatmaps: torch.Tensor, k: int = 4, suppress_radius: float = 3.0,
               refine: bool = True) -> torch.Tensor:
    """Top-k non-max-suppressed local maxima of heatmaps [..., H, W] ->
    modes [..., k, 3] (x, y, score), score-descending.

    A candidate must be a 3x3 local maximum of the original map (SAME
    max-pool, -inf padding); k greedy rounds of (argmax, suppress a disk of
    `suppress_radius` px) follow.  Slots with no remaining local maximum
    carry the -1e30 sentinel at (0, 0) and are clamped to score 0.  Each mode
    gets the UDP refinement on the unsuppressed map.
    """
    H, W = heatmaps.shape[-2:]
    dev = heatmaps.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    r2 = float(suppress_radius) ** 2
    flat = heatmaps.reshape(-1, 1, H, W)
    pooled = F.max_pool2d(F.pad(flat, (1, 1, 1, 1), value=float("-inf")), 3, 1)
    pooled = pooled.reshape(heatmaps.shape)
    with profiling.host_sync():         # a copy from host memory waits for the stream
        neg = torch.tensor(-1e30, dtype=heatmaps.dtype, device=dev)
    h = torch.where(heatmaps >= pooled, heatmaps, neg)
    xk, yk, pk = [], [], []
    for _ in range(k):
        x_i, y_i, peak = _peak_coords(h)
        d2 = (xs - x_i[..., None, None].float()) ** 2 + (ys - y_i[..., None, None].float()) ** 2
        h = torch.where(d2 <= r2, neg, h)
        xk.append(x_i)
        yk.append(y_i)
        pk.append(peak)
    xk = torch.stack(xk, dim=-1)                        # [..., k]
    yk = torch.stack(yk, dim=-1)
    pk = torch.stack(pk, dim=-1).float().clamp(min=0.0)
    x = xk.float()
    y = yk.float()
    if refine:
        off_x, off_y = _udp_offset(heatmaps, xk, yk)
        x = x + off_x
        y = y + off_y
    return torch.stack([x, y, pk], dim=-1)


def moment_stats(heatmaps: torch.Tensor, radius: float = 8.0) -> torch.Tensor:
    """Windowed first and second moments of heatmaps [..., H, W] -> [..., 5]:
    (mu_x, mu_y, cov_xx, cov_xy, cov_yy) in heatmap pixel units, of the
    positive-clipped heatmap inside a `radius`-px disk around the argmax peak
    (the window keeps far-field blobs of other body parts out of the
    covariance).

    A deflected joint whose two belief components sit closer than two sigma
    merges into one elongated blob that no mode decode can split; its second
    moment still carries the separation: the variance along the separation
    axis is sigma^2 + w(1-w) d^2 for weights (1-w, w) at distance d."""
    H, W = heatmaps.shape[-2:]
    dev = heatmaps.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    x_i, y_i, _ = _peak_coords(heatmaps)
    d2 = (xs - x_i[..., None, None].float()) ** 2 + (ys - y_i[..., None, None].float()) ** 2
    w = heatmaps.float().clamp(min=0.0)
    w = torch.where(d2 <= float(radius) ** 2, w, torch.zeros_like(w))
    z = w.sum((-2, -1)).clamp(min=1e-9)
    mux = (w * xs).sum((-2, -1)) / z
    muy = (w * ys).sum((-2, -1)) / z
    cxx = (w * xs * xs).sum((-2, -1)) / z - mux * mux
    cyy = (w * ys * ys).sum((-2, -1)) / z - muy * muy
    cxy = (w * xs * ys).sum((-2, -1)) / z - mux * muy
    return torch.stack([mux, muy, cxx, cxy, cyy], dim=-1)


def viterbi_track(modes: torch.Tensor, lam: float = 0.1, eps: float = 1e-6) -> torch.Tensor:
    """Per-joint mode sequence minimizing Σ_t -log(score_t) + lam·|xy_t - xy_{t-1}|²
    by exact Viterbi DP.  modes [T, ..., k, 3] -> keypoints [T, ..., 3].
    Pad slots (score <= 0) cost 1e9; ties take the first index."""
    xy = modes[..., :2]
    score = modes[..., 2]
    unary = torch.where(score > 0.0, -torch.log(score.clamp(min=eps)),
                        torch.full_like(score, 1e9))
    T = modes.shape[0]
    cost = unary[0]
    backs = []
    for t in range(1, T):
        d2 = ((xy[t][..., None, :, :] - xy[t - 1][..., :, None, :]) ** 2).sum(-1)
        tot = cost[..., :, None] + lam * d2             # [..., k_prev, k_cur]
        mins = tot.min(dim=-2).values
        back = (tot == mins[..., None, :]).to(torch.uint8).argmax(dim=-2)
        backs.append(back)
        cost = mins + unary[t]
    last = (cost == cost.min(dim=-1, keepdim=True).values).to(torch.uint8).argmax(dim=-1)
    idx = [last]
    for back in reversed(backs):
        idx.append(torch.gather(back, -1, idx[-1][..., None])[..., 0])
    idx = torch.stack(idx[::-1], dim=0)                 # [T, ...]
    sel = idx[..., None, None].expand(*idx.shape, 1, modes.shape[-1])
    return torch.gather(modes, modes.dim() - 2, sel)[..., 0, :]


def make_heatmap_targets(kpts_hm: torch.Tensor, heatmap_hw: tuple[int, int],
                         sigma: float = 2.0):
    """Gaussian target heatmaps for training the pose model.

    kpts_hm [..., K, 2] in heatmap pixel coords (sub-pixel ok) -> (targets
    [..., K, H, W], weights [..., K]); weight 0 marks joints whose peak falls
    outside the heatmap, and their target is zero."""
    H, W = heatmap_hw
    dev = kpts_hm.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    mu = kpts_hm[..., None, None, :]
    d2 = (xs - mu[..., 0]) ** 2 + (ys - mu[..., 1]) ** 2
    targets = torch.exp(-d2 / (2.0 * sigma ** 2))
    inside = ((kpts_hm[..., 0] >= 0) & (kpts_hm[..., 0] <= W - 1)
              & (kpts_hm[..., 1] >= 0) & (kpts_hm[..., 1] <= H - 1))
    weights = inside.float()
    return targets * weights[..., None, None], weights


def _heatmap_to_image_transform(boxes, heatmap_hw, crop_hw):
    hm2crop = affine.heatmap_to_crop_transform(heatmap_hw, crop_hw, device=boxes.device)
    crop2img = affine.crop_transform(boxes, crop_hw)
    return affine.compose(crop2img, hm2crop.expand_as(crop2img))


def image_keypoints_to_heatmap(kpts_img: torch.Tensor, boxes: torch.Tensor,
                               heatmap_hw: tuple[int, int],
                               crop_hw: tuple[int, int]) -> torch.Tensor:
    """Inverse of `keypoints_to_image`, for building training targets."""
    inv = affine.invert_transform(_heatmap_to_image_transform(boxes, heatmap_hw, crop_hw))
    xy = affine.apply_transform(inv, kpts_img[..., :2])
    return torch.cat([xy, kpts_img[..., 2:]], dim=-1)


def keypoints_to_image(kpts_hm: torch.Tensor, boxes: torch.Tensor,
                       heatmap_hw: tuple[int, int], crop_hw: tuple[int, int]) -> torch.Tensor:
    """Heatmap-space keypoints [..., K, 3] -> source-image pixels, through the
    (cx, cy, w, h) crop boxes [..., 4] used by preprocessing."""
    full = _heatmap_to_image_transform(boxes, heatmap_hw, crop_hw)
    xy = affine.apply_transform(full, kpts_hm[..., :2])
    return torch.cat([xy, kpts_hm[..., 2:]], dim=-1)
