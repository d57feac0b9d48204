"""Fused crop / resize / normalize preprocessing (kernel A).

Raw frames [B, H, W, 3] uint8 plus per-frame person boxes -> normalized
model-input crops [B, h, w, 3] float32 (NHWC), zero border, corner-aligned
sampling (ops.affine).

  * `crop_resize_normalize` — the entry point.  On a CUDA tensor it launches
    the hand-written kernel (csrc/preprocess.cu), which replaces the TPU
    kernel golfaction_tpu/ops/pallas/preprocess_kernel.py
    (crop_resize_normalize_pallas); on a CPU tensor it runs the plain gather
    version, which computes the same 4-tap bilinear gather.
  * `crop_resize_normalize_reference` — plain gather version.
  * `crop_resize_normalize_separable` — plain separable version,
    Wy @ frame @ Wx^T with the 2-tap hat matrices.
"""

from __future__ import annotations

import torch

from golfaction_tpu_torch.ops import _kernels
from golfaction_tpu_torch.ops import affine

# ImageNet normalization.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _sample_coords(boxes: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """Source coordinates [..., out_size] of output pixel centers along x
    (axis=0: cx, w) or y (axis=1: cy, h).

    The step divides by a tensor on the boxes' device, not by a host scalar
    (which PyTorch on CUDA multiplies with as its reciprocal), so the CPU,
    the card and the kernel (csrc/preprocess.cu:sample_coord, which repeats
    these operations one by one) round the same way."""
    c = boxes[..., 0 + axis]
    s = boxes[..., 2 + axis]
    step = s / affine.scalar_like(out_size - 1, boxes)
    start = c - s / 2.0
    idx = torch.arange(out_size, dtype=torch.float32, device=boxes.device)
    return start[..., None] + idx * step[..., None]


def _interp_matrix(coords: torch.Tensor, src_size: int) -> torch.Tensor:
    """Dense bilinear interpolation matrix W[..., out, src] = max(0, 1 - |c - s|)."""
    src = torch.arange(src_size, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - (coords[..., :, None] - src).abs(), min=0.0)


def _normalize(out: torch.Tensor, mean, std) -> torch.Tensor:
    mean_t = torch.tensor(mean, dtype=torch.float32, device=out.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=out.device)
    return (out / 255.0 - mean_t) / std_t


def crop_resize_normalize_reference(frames: torch.Tensor, boxes: torch.Tensor,
                                    out_hw: tuple[int, int],
                                    mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Plain gather version.  frames [B,H,W,3] uint8/float, boxes [B,4]."""
    B, H, W, C = frames.shape
    oh, ow = out_hw
    mat = affine.crop_transform(boxes.float(), out_hw)          # [B, 2, 3]
    ys = torch.arange(oh, dtype=torch.float32, device=frames.device)
    xs = torch.arange(ow, dtype=torch.float32, device=frames.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # [oh*ow, 2]
    src = affine.apply_transform(mat, pts.expand(B, oh * ow, 2))
    sx, sy = src[..., 0], src[..., 1]
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    flat = frames.reshape(B, H * W, C).float()

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        idx = (yc * W + xc)[..., None].expand(B, oh * ow, C)
        return torch.gather(flat, 1, idx) * inb[..., None]

    out = (
        tap(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
        + tap(x0 + 1, y0) * (fx * (1 - fy))[..., None]
        + tap(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
        + tap(x0 + 1, y0 + 1) * (fx * fy)[..., None]
    )
    return _normalize(out.reshape(B, oh, ow, C), mean, std)


def crop_resize_normalize_separable(frames: torch.Tensor, boxes: torch.Tensor,
                                    out_hw: tuple[int, int],
                                    mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Plain separable version: out = Wy @ frame @ Wx^T per channel."""
    B, H, W, C = frames.shape
    oh, ow = out_hw
    Wy = _interp_matrix(_sample_coords(boxes.float(), oh, axis=1), H)  # [B, oh, H]
    Wx = _interp_matrix(_sample_coords(boxes.float(), ow, axis=0), W)  # [B, ow, W]
    t = torch.einsum("bpw,bhwc->bhpc", Wx, frames.float())
    out = torch.einsum("boh,bhpc->bopc", Wy, t)
    return _normalize(out, mean, std)


def crop_resize_normalize(frames: torch.Tensor, boxes: torch.Tensor,
                          out_hw: tuple[int, int],
                          mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """frames [B,H,W,3] uint8, boxes [B,4] (cx,cy,w,h) -> crops [B,oh,ow,3] f32."""
    if frames.device.type == "cpu":
        return crop_resize_normalize_reference(frames, boxes, out_hw, mean, std)
    _kernels.require(frames, torch.uint8, 4, "crop_resize_normalize frames")
    _kernels.require(boxes, torch.float32, 2, "crop_resize_normalize boxes")
    B, H, W, C = frames.shape
    if C != 3 or tuple(boxes.shape) != (B, 4) or boxes.device != frames.device:
        raise ValueError(f"crop_resize_normalize: frames {tuple(frames.shape)}, "
                         f"boxes {tuple(boxes.shape)} on {boxes.device}")
    oh, ow = out_hw
    out = torch.empty((B, oh, ow, 3), dtype=torch.float32, device=frames.device)
    if B == 0:
        return out
    # One launch and nothing else on the device: the kernel computes the
    # plain versions' sample coordinates itself, operation by operation.
    fn = _kernels.bind("preprocess", "crop_resize_normalize_launch", "pppiiiiiffffffp")
    rc = fn(_kernels.ptr(frames), _kernels.ptr(boxes), _kernels.ptr(out),
            B, H, W, oh, ow, *[float(m) for m in mean], *[float(s) for s in std],
            _kernels.stream_of(frames))
    _kernels.check(rc, "crop_resize_normalize kernel")
    crop_resize_normalize.launches += 1
    return out


crop_resize_normalize.launches = 0
