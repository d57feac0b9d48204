"""Fused crop / resize / normalize preprocessing (kernel A).

Raw frames [B, H, W, 3] uint8 plus per-frame person boxes -> normalized
model-input crops [B, h, w, 3] (NHWC), float32 or bfloat16, zero border,
corner-aligned sampling (ops.affine).

  * `crop_resize_normalize` — the entry point.  On a CUDA tensor it launches
    a hand-written kernel (csrc/preprocess.cu), which replaces the TPU
    kernel golfaction_tpu/ops/pallas/preprocess_kernel.py
    (crop_resize_normalize_pallas); on a CPU tensor it runs the plain gather
    version of the same arithmetic.  `dtype=torch.bfloat16` goes through
    `crop_resize_normalize_bf16`.
  * `crop_resize_normalize_reference` — plain gather version, float32.
  * `crop_resize_normalize_separable` — plain separable version,
    Wy @ frame @ Wx^T with the 2-tap hat matrices.
  * `crop_resize_normalize_bf16_reference` — plain gather version of the
    bfloat16 crops of the JAX package's `crop_resize_normalize(...,
    dtype=bfloat16)`, rounded where that function rounds.
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


def _taps(coords: torch.Tensor, size: int) -> list:
    """The two bilinear taps floor(c) and floor(c) + 1 of each sample
    coordinate [..., n] along an axis of `size` source pixels, as [(index
    clamped into the axis, weight)].  The weight is the hat kernel
    max(0, 1 - |c - s|) of each tap on its own, as the JAX package's
    interpolation matrices compute it (not frac and 1 - frac: for c in
    (0, 0.5) the float32 1 - (1 - c) is not always c), rounded to bfloat16;
    zero for a tap outside the axis, which those matrices have no column
    for."""
    lo = torch.floor(coords)
    taps = []
    for s in (lo, lo + 1):
        w = torch.clamp(1.0 - (coords - s).abs(), min=0.0)
        w = torch.where((s >= 0) & (s < size), w, torch.zeros_like(w))
        taps.append((s.clamp(0, size - 1).long(), w.to(torch.bfloat16).float()))
    return taps


def crop_resize_normalize_bf16_reference(frames: torch.Tensor, boxes: torch.Tensor,
                                         out_hw: tuple[int, int],
                                         mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """Plain gather version of the bfloat16 crops.  frames [B,H,W,3] uint8,
    boxes [B,4] -> [B,oh,ow,3] bfloat16.

    The JAX package's bfloat16 warp (Wy @ frame @ Wx^T with bfloat16 operands
    and float32 sums) rounds at three points: the hat weights, the
    W-contracted row values and the normalized result.  Each of its sums has
    at most two non-zero terms, and every product of a bfloat16 weight with a
    pixel or a bfloat16 row value is exact in float32, so this gather
    computes the same bits: per y-tap the row value wx0*f[y,x0] + wx1*f[y,x1]
    in float32 rounded to bfloat16, the column sum wy0*t0 + wy1*t1 in
    float32, then /255, -mean, /std in float32 (divisions by tensors, which
    every device divides by) rounded to bfloat16."""
    B = frames.shape[0]
    oh, ow = out_hw
    b = boxes.float()
    y_taps = _taps(_sample_coords(b, oh, axis=1), frames.shape[1])     # [B, oh] each
    x_taps = _taps(_sample_coords(b, ow, axis=0), frames.shape[2])     # [B, ow] each
    bi = torch.arange(B, device=frames.device)[:, None, None]
    v = None
    for yi, wy in y_taps:
        t = None
        for xi, wx in x_taps:
            term = wx[:, None, :, None] * frames[bi, yi[:, :, None], xi[:, None, :]].float()
            t = term if t is None else t + term
        term = wy[:, :, None, None] * t.to(torch.bfloat16).float()
        v = term if v is None else v + term
    mean_t = torch.tensor(mean, dtype=torch.float32, device=frames.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=frames.device)
    return ((v / affine.scalar_like(255.0, v) - mean_t) / std_t).to(torch.bfloat16)


def _check_inputs(frames: torch.Tensor, boxes: torch.Tensor, what: str) -> None:
    _kernels.require(frames, torch.uint8, 4, f"{what} frames")
    _kernels.require(boxes, torch.float32, 2, f"{what} boxes")
    B, C = frames.shape[0], frames.shape[3]
    if C != 3 or tuple(boxes.shape) != (B, 4) or boxes.device != frames.device:
        raise ValueError(f"{what}: frames {tuple(frames.shape)}, "
                         f"boxes {tuple(boxes.shape)} on {boxes.device}")


def _launch(symbol: str, frames: torch.Tensor, boxes: torch.Tensor, out_hw, mean, std,
            dtype: torch.dtype) -> torch.Tensor:
    """One launch of `symbol` and nothing else on the device: the kernel
    computes the plain versions' sample coordinates itself, operation by
    operation."""
    B, H, W, _ = frames.shape
    oh, ow = out_hw
    out = torch.empty((B, oh, ow, 3), dtype=dtype, device=frames.device)
    if B == 0:
        return out
    fn = _kernels.bind("preprocess", symbol, "pppiiiiiffffffp")
    rc = fn(_kernels.ptr(frames), _kernels.ptr(boxes), _kernels.ptr(out),
            B, H, W, oh, ow, *[float(m) for m in mean], *[float(s) for s in std],
            _kernels.stream_of(frames))
    _kernels.check(rc, f"{symbol} kernel")
    return out


def crop_resize_normalize_bf16(frames: torch.Tensor, boxes: torch.Tensor,
                               out_hw: tuple[int, int],
                               mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """frames [B,H,W,3] uint8, boxes [B,4] (cx,cy,w,h) -> crops [B,oh,ow,3]
    bfloat16: the bfloat16 kernel on a CUDA tensor, its plain version
    (`crop_resize_normalize_bf16_reference`) on a CPU tensor."""
    if frames.device.type == "cpu":
        return crop_resize_normalize_bf16_reference(frames, boxes, out_hw, mean, std)
    _check_inputs(frames, boxes, "crop_resize_normalize_bf16")
    out = _launch("crop_resize_normalize_bf16_launch", frames, boxes, out_hw, mean, std,
                  torch.bfloat16)
    if out.shape[0]:
        crop_resize_normalize_bf16.launches += 1
    return out


def crop_resize_normalize(frames: torch.Tensor, boxes: torch.Tensor,
                          out_hw: tuple[int, int],
                          mean=IMAGENET_MEAN, std=IMAGENET_STD,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """frames [B,H,W,3] uint8, boxes [B,4] (cx,cy,w,h) -> crops [B,oh,ow,3]
    of `dtype`, float32 or bfloat16 (the JAX package's `dtype` argument)."""
    if dtype == torch.bfloat16:
        return crop_resize_normalize_bf16(frames, boxes, out_hw, mean, std)
    if dtype != torch.float32:
        raise ValueError(f"crop_resize_normalize: dtype {dtype}; the crops are float32 "
                         "or bfloat16")
    if frames.device.type == "cpu":
        return crop_resize_normalize_reference(frames, boxes, out_hw, mean, std)
    _check_inputs(frames, boxes, "crop_resize_normalize")
    out = _launch("crop_resize_normalize_launch", frames, boxes, out_hw, mean, std,
                  torch.float32)
    if out.shape[0]:
        crop_resize_normalize.launches += 1
    return out


crop_resize_normalize.launches = 0
crop_resize_normalize_bf16.launches = 0
