"""Host-side video decode, person-box estimation and bucket padding (numpy).

Boxes come from the caller or from motion-energy estimation (frame
differencing against the clip median, for a static camera watching one
moving golfer), with a full-frame-ish fallback when motion is too weak.  The
estimate runs in the multithreaded C++ library (golfaction_tpu_torch.native)
by default, as in the JAX package; the numpy body here is its oracle.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from golfaction_tpu_torch import native


def load_video(path: str, max_frames: Optional[int] = None) -> tuple[np.ndarray, float]:
    """Decode a video file -> (frames [T, H, W, 3] uint8 RGB, fps).  Needs
    OpenCV, which is imported here and nowhere else."""
    import cv2

    if not os.path.exists(path):
        raise FileNotFoundError(path)
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames), float(fps)


def estimate_person_boxes(frames: np.ndarray, smooth: int = 9,
                          min_size: float = 0.15, use_native: bool = True) -> np.ndarray:
    """Motion-energy person boxes [T, 4] float32 (cx, cy, w, h) in pixels,
    median-smoothed over time, with a minimum size (fraction of the frame).

    `use_native` (the default): the C++ library, built with g++ at first use
    (a failed build raises); else this numpy body, up to 1 px apart (the
    library takes its percentiles from per-frame histograms)."""
    if use_native:
        return native.motion_boxes(frames, min_size=min_size, smooth=smooth)
    T, H, W, _ = frames.shape
    gray = frames.mean(axis=-1).astype(np.float32)
    background = np.median(gray, axis=0)
    energy = np.abs(gray - background)              # [T, H, W]
    thresh = np.maximum(12.0, energy.mean() + energy.std())
    mask = energy > thresh

    boxes = np.zeros((T, 4), np.float32)
    fallback = np.array([W / 2, H / 2, W * 0.5, H * 0.9], np.float32)
    for t in range(T):
        ys, xs = np.nonzero(mask[t])
        if len(xs) < 50:  # not enough motion evidence
            boxes[t] = fallback
            continue
        # Percentile bounds reject speckle outliers.
        x0, x1 = np.percentile(xs, [1, 99])
        y0, y1 = np.percentile(ys, [1, 99])
        w = max(x1 - x0, min_size * W)
        h = max(y1 - y0, min_size * H)
        boxes[t] = [(x0 + x1) / 2, (y0 + y1) / 2, w * 1.1, h * 1.1]

    if smooth > 1 and T > 1:
        k = min(smooth, T if T % 2 else T - 1)
        pad = k // 2
        padded = np.pad(boxes, ((pad, pad), (0, 0)), mode="edge")
        boxes = np.stack([np.median(padded[i:i + k], axis=0)
                          for i in range(T)]).astype(np.float32)
    return boxes


def pad_to_bucket(frames: np.ndarray, boxes: np.ndarray, buckets: Sequence[int]
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a clip to the smallest bucket >= T by repeating its last frame and
    box.  Returns (frames [Tb, ...], boxes [Tb, 4], valid [Tb] bool)."""
    T = len(frames)
    tb = next((b for b in sorted(buckets) if b >= T), None)
    if tb is None:
        raise ValueError(
            f"clip length {T} exceeds largest bucket {max(buckets)}; "
            "split the clip or extend PipelineConfig.length_buckets")
    valid = np.zeros(tb, bool)
    valid[:T] = True
    if tb == T:
        return frames, boxes.astype(np.float32), valid
    pad = tb - T
    frames_p = np.concatenate([frames, np.repeat(frames[-1:], pad, axis=0)])
    boxes_p = np.concatenate([boxes, np.repeat(boxes[-1:], pad, axis=0)])
    return frames_p, boxes_p.astype(np.float32), valid
