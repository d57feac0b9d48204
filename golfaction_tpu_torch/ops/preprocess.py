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
  * `division_reciprocals` — the float32 reciprocals the bfloat16 kernel
    divides by (a reciprocal and one correction), and
    `division_mismatches`, which holds those divisions to IEEE division on
    the card.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np
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


def _launch(symbol: str, frames: torch.Tensor, boxes: torch.Tensor, out_hw,
            dtype: torch.dtype, norm) -> torch.Tensor:
    """One launch of `symbol` and nothing else on the device: the kernel
    computes the plain versions' sample coordinates itself, operation by
    operation.  `norm`: the kernel's normalization floats, in its order."""
    B, H, W, _ = frames.shape
    oh, ow = out_hw
    out = torch.empty((B, oh, ow, 3), dtype=dtype, device=frames.device)
    if B == 0:
        return out
    fn = _kernels.bind("preprocess", symbol, "pppiiiii" + "f" * len(norm) + "p")
    rc = fn(_kernels.ptr(frames), _kernels.ptr(boxes), _kernels.ptr(out),
            B, H, W, oh, ow, *[float(v) for v in norm], _kernels.stream_of(frames))
    _kernels.check(rc, f"{symbol} kernel")
    return out


# Divisors and means the bfloat16 kernel's division (a reciprocal and one
# correction, csrc/preprocess.cu:divide) takes: inside this range no operand,
# remainder or quotient of its two divisions leaves float32's normal range.
DIVISION_RANGE = (2.0 ** -40, 2.0 ** 40)


def _f32(x: float) -> float:
    return float(np.float32(x))


@functools.lru_cache(maxsize=64)
def reciprocal_f32(d: float) -> float:
    """RN(1 / d): the float32 nearest the exact reciprocal of the float32 d."""
    d = _f32(d)
    r = np.float32(1.0 / d)              # may round twice: take the nearest neighbour
    near = (r, np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(np.inf)))
    return float(min(near, key=lambda c: abs(Fraction(float(c)) * Fraction(d) - 1)))


def division_reciprocals(mean, std) -> tuple[float, ...]:
    """The bfloat16 kernel's reciprocals, in its launch order: RN(1 / std[c])
    for each channel, then RN(1 / 255), each of the float32 value the plain
    version divides by.  Raises for a std that is not positive inside
    DIVISION_RANGE, or a mean neither 0 nor of a size inside it: there the
    kernel's quotients could differ from IEEE division's."""
    lo, hi = DIVISION_RANGE

    def takes(v: float, is_std: bool) -> bool:
        a = abs(_f32(v))
        return (lo <= a <= hi and (v > 0 or not is_std)) or (a == 0 and not is_std)

    refused = ([f"std {v}" for v in std if not takes(v, True)]
               + [f"mean {v}" for v in mean if not takes(v, False)])
    if refused:
        raise ValueError(f"crop_resize_normalize_bf16: {', '.join(refused)}: the kernel's "
                         "division takes a std in [2^-40, 2^40] and a mean of 0 or of a "
                         "size in it")
    return (*[reciprocal_f32(s) for s in std], reciprocal_f32(255.0))


def division_mismatches(lo: float, hi: float, d: float, guarded: bool,
                        stride: int = 1) -> tuple[int, int]:
    """On the card: for how many float32 x in [lo, hi] (both zeros where the
    range holds 0; with `stride` > 1 every stride-th float counted from the
    end nearest zero) the bfloat16 kernel's x / d has other bits than IEEE
    division's: its division by 255 (`guarded` False) or by a std (True).
    Returns (mismatches, floats checked)."""
    d = _f32(d)
    r = reciprocal_f32(d)
    check = _kernels.bind("preprocess", "preprocess_division_check", "iiiffipp")
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")

    def bits(x: float) -> int:
        return int(np.float32(abs(x)).view(np.uint32))

    spans = []                                     # (first pattern, last pattern)
    if hi >= 0:
        spans.append((0, bits(hi)) if lo <= 0 else (bits(lo), bits(hi)))
    if lo <= 0:
        spans.append((1 << 31, (1 << 31) | bits(lo)) if hi >= 0
                     else ((1 << 31) | bits(hi), (1 << 31) | bits(lo)))
    checked = 0
    for first, last in spans:
        count = (last - first) // stride + 1
        rc = check(first, count, stride, d, r, int(guarded), _kernels.ptr(bad),
                   _kernels.stream_of(bad))
        _kernels.check(rc, "preprocess_division_check kernel")
        checked += count
    return int(bad), checked


def crop_resize_normalize_bf16(frames: torch.Tensor, boxes: torch.Tensor,
                               out_hw: tuple[int, int],
                               mean=IMAGENET_MEAN, std=IMAGENET_STD) -> torch.Tensor:
    """frames [B,H,W,3] uint8, boxes [B,4] (cx,cy,w,h) -> crops [B,oh,ow,3]
    bfloat16: the bfloat16 kernel on a CUDA tensor, its plain version
    (`crop_resize_normalize_bf16_reference`) on a CPU tensor."""
    if frames.device.type == "cpu":
        return crop_resize_normalize_bf16_reference(frames, boxes, out_hw, mean, std)
    _check_inputs(frames, boxes, "crop_resize_normalize_bf16")
    H, W = frames.shape[1:3]
    if H < 1 or W < 1 or 3 * H * W > 2 ** 31 - 1:
        raise ValueError(f"crop_resize_normalize_bf16: frames of {H}x{W}; the kernel takes "
                         "1 to 2^31 - 1 bytes a frame")
    out = _launch("crop_resize_normalize_bf16_launch", frames, boxes, out_hw, torch.bfloat16,
                  (*mean, *std, *division_reciprocals(mean, std)))
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
    out = _launch("crop_resize_normalize_launch", frames, boxes, out_hw, torch.float32,
                  (*mean, *std))
    if out.shape[0]:
        crop_resize_normalize.launches += 1
    return out


crop_resize_normalize.launches = 0
crop_resize_normalize_bf16.launches = 0
