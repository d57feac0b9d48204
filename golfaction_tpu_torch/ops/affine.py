"""Affine-transform utilities for top-down pose cropping.

Transforms are 2x3 matrices acting on row vectors [x, y, 1], batched over
leading dims, with the unbiased (UDP-style) corner-aligned mapping: pixel
centers (0, 0) and (W-1, H-1) correspond exactly across resolutions.
"""

from __future__ import annotations

import torch

from golfaction_tpu_torch.utils import profiling


def box_to_center_scale(boxes: torch.Tensor, aspect_ratio: float,
                        padding: float = 1.25) -> torch.Tensor:
    """Expand (cx, cy, w, h) boxes to the crop aspect ratio (crop_w / crop_h)
    with padding.  Returns boxes [..., 4] with w / h == aspect_ratio."""
    cx, cy, w, h = boxes.unbind(-1)
    w = torch.maximum(w, h * aspect_ratio)
    h = w / aspect_ratio
    return torch.stack([cx, cy, w * padding, h * padding], dim=-1)


def scalar_like(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python number as a 0-dim tensor of `like`'s type on its device.  A
    divisor that is a tensor is divided by on every device; a host scalar is
    multiplied with as its reciprocal on CUDA, which rounds differently."""
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def crop_transform(boxes: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """2x3 affine mapping output crop pixel coords -> source image coords.

    src_x = cx - w/2 + x * (w / (W-1)) (UDP unit-length convention).
    """
    H, W = out_hw
    cx, cy, w, h = boxes.unbind(-1)
    sx = w / scalar_like(W - 1, boxes)
    sy = h / scalar_like(H - 1, boxes)
    tx = cx - w / 2.0
    ty = cy - h / 2.0
    zeros = torch.zeros_like(sx)
    row0 = torch.stack([sx, zeros, tx], dim=-1)
    row1 = torch.stack([zeros, sy, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)  # [..., 2, 3]


def invert_transform(mat: torch.Tensor) -> torch.Tensor:
    """Invert a batch of 2x3 affine matrices."""
    A, t = mat[..., :2], mat[..., 2]
    det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    inv = torch.stack([
        torch.stack([A[..., 1, 1] / det, -A[..., 0, 1] / det], dim=-1),
        torch.stack([-A[..., 1, 0] / det, A[..., 0, 0] / det], dim=-1)], dim=-2)
    tinv = -torch.stack([inv[..., i, 0] * t[..., 0] + inv[..., i, 1] * t[..., 1]
                         for i in range(2)], dim=-1)
    return torch.cat([inv, tinv[..., None]], dim=-1)


def apply_transform(mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply 2x3 affine `mat` [..., 2, 3] to points [..., N, 2]."""
    A = mat[..., :2]
    x = points[..., 0:1]
    y = points[..., 1:2]
    # Written out (not a matmul) so it rounds like the reference's
    # "highest"-precision einsum on every backend.
    out_x = x * A[..., None, 0, 0:1] + y * A[..., None, 0, 1:2]
    out_y = x * A[..., None, 1, 0:1] + y * A[..., None, 1, 1:2]
    return torch.cat([out_x, out_y], dim=-1) + mat[..., None, :2, 2]


def heatmap_to_crop_transform(heatmap_hw: tuple[int, int],
                              crop_hw: tuple[int, int],
                              device=None) -> torch.Tensor:
    """Static 2x3 affine mapping heatmap pixel coords -> crop pixel coords."""
    Hh, Wh = heatmap_hw
    Hc, Wc = crop_hw
    sx = (Wc - 1) / (Wh - 1)
    sy = (Hc - 1) / (Hh - 1)
    with profiling.host_sync():         # a copy from host memory waits for the stream
        return torch.tensor([[sx, 0.0, 0.0], [0.0, sy, 0.0]], dtype=torch.float32,
                            device=device)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose affines: result(x) = a(b(x)).  Shapes broadcast over batch dims."""
    A, ta = a[..., :2], a[..., 2]
    B, tb = b[..., :2], b[..., 2]
    M = torch.stack([
        torch.stack([A[..., i, 0] * B[..., 0, k] + A[..., i, 1] * B[..., 1, k]
                     for k in range(2)], dim=-1)
        for i in range(2)], dim=-2)
    t = torch.stack([A[..., i, 0] * tb[..., 0] + A[..., i, 1] * tb[..., 1]
                     for i in range(2)], dim=-1) + ta
    return torch.cat([M, t[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Keypoint-seeded box tracking
# ---------------------------------------------------------------------------

def boxes_from_keypoints(kpts: torch.Tensor, image_hw: tuple[int, int], margin: float = 1.2,
                         min_size: float = 48.0) -> torch.Tensor:
    """Tight person boxes from decoded keypoints.

    kpts [..., V, >=2] image-space keypoints -> boxes [..., 4] (cx, cy, w, h).
    `margin` expands the keypoint extent (a skeleton underestimates the
    silhouette); `min_size` floors degenerate extents (bad coarse decode).
    """
    H, W = image_hw
    xy = kpts[..., :2].float()
    lo = xy.amin(dim=-2)
    hi = xy.amax(dim=-2)
    top = torch.tensor([W - 1.0, H - 1.0], dtype=torch.float32, device=xy.device)
    c = torch.minimum(((lo + hi) / 2).clamp(min=0.0), top)
    wh = ((hi - lo) * margin).clamp(min=min_size)
    return torch.cat([c, wh], dim=-1)


def smooth_boxes(boxes: torch.Tensor, window: int = 9) -> torch.Tensor:
    """Temporal moving average over boxes [T, 4] (edge-padded): a cumulative
    sum and one difference, as the reference takes it."""
    T = boxes.shape[0]
    k = min(window, T if T % 2 else max(T - 1, 1))
    if k <= 1:
        return boxes
    pad = k // 2
    padded = torch.cat([boxes.new_zeros((1, 4)), boxes[:1].expand(pad, 4), boxes,
                        boxes[-1:].expand(pad, 4)])
    cs = torch.cumsum(padded, dim=0)
    return (cs[k:] - cs[:-k]) / k


def interp_boxes(boxes_s: torch.Tensor, stride: int, T: int) -> torch.Tensor:
    """Linearly upsample strided boxes [ceil(T/stride), 4] to [T, 4].

    Row i of the input corresponds to frame i*stride; frames past the last
    strided sample hold its value.
    """
    Ts = boxes_s.shape[0]
    if Ts == 1:
        return boxes_s.expand(T, 4)
    tq = torch.arange(T, dtype=torch.float32, device=boxes_s.device)
    i = torch.div(tq, stride, rounding_mode="floor").long().clamp(max=Ts - 2)
    lo, hi = boxes_s[i], boxes_s[i + 1]
    frac = ((tq - i.float() * stride) / tq.new_tensor(float(stride)))[:, None]
    out = lo + frac * (hi - lo)
    return torch.where((tq > (Ts - 1) * stride)[:, None], boxes_s[-1], out)
