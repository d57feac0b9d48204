"""Host-side video decode, person-box estimation and bucket padding (numpy).

Boxes come from the caller or from motion-energy estimation (frame
differencing against the clip median, for a static camera watching one
moving golfer), with a full-frame-ish fallback when motion is too weak.  The
estimate runs in the multithreaded C++ library (golfaction_tpu_torch.native)
by default, as in the JAX package; the numpy body here is its oracle.  A
shaking camera can be compensated on the host (`stabilize`, phase
correlation); `frame_source` yields frames from a live-style source.
OpenCV is imported by the functions that use it.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional, Sequence

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


def iter_clip_batches(frames: np.ndarray, batch: int) -> Iterator[np.ndarray]:
    """Yield frame micro-batches for pipelined device feeding."""
    for i in range(0, len(frames), batch):
        yield frames[i:i + batch]


def estimate_camera_shifts(frames: np.ndarray, downsample: int = 4,
                           tiles: int = 3) -> np.ndarray:
    """Per-frame global camera translation [T, 2] (dx, dy) against frame 0.

    Downsampled grayscale frames are split into tiles x tiles; each tile's
    translation against frame 0's comes from phase correlation, and the
    median over the tiles with a confident peak is taken, so the golfer,
    who covers a few tiles, cannot drag the estimate.  Near zero for a
    tripod clip."""
    import cv2

    # At least ~32 px a tile on the short side: smaller tiles make the
    # correlation peak meaningless.
    downsample = max(1, min(downsample, min(frames.shape[1:3]) // (32 * tiles)))
    g = frames[:, ::downsample, ::downsample].mean(axis=-1).astype(np.float32)
    T, H, W = g.shape
    th, tw = H // tiles, W // tiles
    if th < 8 or tw < 8:
        tiles, th, tw = 1, H, W
    win = cv2.createHanningWindow((tw, th), cv2.CV_32F)
    shifts = np.zeros((T, 2), np.float32)
    # Every frame against frame 0 directly: chained pair deltas integrate
    # sub-pixel bias into phantom drift on a static clip.
    for t in range(1, T):
        est = []
        for i in range(tiles):
            for j in range(tiles):
                a = g[0, i * th:(i + 1) * th, j * tw:(j + 1) * tw]
                b = g[t, i * th:(i + 1) * th, j * tw:(j + 1) * tw]
                (dx, dy), resp = cv2.phaseCorrelate(a, b, win)
                # Textureless tiles give a meaningless peak of low response.
                if resp >= 0.08 and abs(dx) < tw / 2 and abs(dy) < th / 2:
                    est.append((dx, dy))
        if len(est) >= 3:
            shifts[t] = np.median(np.asarray(est), axis=0)
    return shifts * downsample


def estimate_person_boxes(frames: np.ndarray, smooth: int = 9, min_size: float = 0.15,
                          use_native: bool = True, stabilize: bool = False) -> np.ndarray:
    """Motion-energy person boxes [T, 4] float32 (cx, cy, w, h) in pixels,
    median-smoothed over time, with a minimum size (fraction of the frame).

    `use_native` (the default): the C++ library, built with g++ at first use
    (a failed build raises); else this numpy body, up to 1 px apart (the
    library takes its percentiles from per-frame histograms).
    `stabilize` (opt-in): the camera's translation is estimated first
    (`estimate_camera_shifts`) and, where it moved by 1.5 px or more, the
    numpy body differences shift-compensated frames and maps the centres
    back; a static clip keeps the C++ path."""
    shifts = None
    if stabilize:
        shifts = estimate_camera_shifts(frames)
        if np.abs(shifts).max() < 1.5:
            shifts = None
    if use_native and shifts is None:
        return native.motion_boxes(frames, min_size=min_size, smooth=smooth)
    T, H, W, _ = frames.shape
    gray = frames.mean(axis=-1).astype(np.float32)
    if shifts is not None:
        # Into frame 0's coordinates (an integer roll is enough for boxes).
        comp = np.empty_like(gray)
        for t in range(T):
            dx, dy = int(round(shifts[t, 0])), int(round(shifts[t, 1]))
            comp[t] = np.roll(gray[t], (-dy, -dx), axis=(0, 1))
        gray = comp
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
    if shifts is not None:
        boxes[:, 0] += shifts[:, 0]
        boxes[:, 1] += shifts[:, 1]
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


def _paced(frames: Iterator[np.ndarray], fps: float, pace: bool) -> Iterator[np.ndarray]:
    period = 1.0 / max(fps, 1.0)
    t_next = time.perf_counter()
    for f in frames:
        if pace:
            t_next += period
            dt = t_next - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        yield f


def frame_source(spec: str, realtime: bool = False, max_frames: Optional[int] = None,
                 npy_fps: float = 30.0) -> Iterator[np.ndarray]:
    """Yield RGB frames from a live-style source, one at a time (the clip is
    never held whole):
      * "camera:N": OpenCV capture device N (it paces itself);
      * "<path>.npy": a saved [T, H, W, 3] uint8 array, paced at `npy_fps`
        with `realtime` (the file has no frame rate);
      * anything else: a video file, paced at its own fps with `realtime`
        (a simulated live feed)."""
    if spec.endswith(".npy"):
        arr = np.load(spec)
        n = len(arr) if max_frames is None else min(len(arr), max_frames)
        yield from _paced((np.asarray(f) for f in arr[:n]), npy_fps, realtime)
        return

    import cv2

    if spec.startswith("camera:"):
        cap = cv2.VideoCapture(int(spec.split(":", 1)[1]))
        if not cap.isOpened():
            raise RuntimeError(f"camera {spec} failed to open")
        pace = False
    else:
        if not os.path.exists(spec):
            raise FileNotFoundError(spec)
        cap = cv2.VideoCapture(spec)
        pace = realtime

    def read():
        n = 0
        while max_frames is None or n < max_frames:
            ok, frame = cap.read()
            if not ok:
                return
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            n += 1

    try:
        yield from _paced(read(), cap.get(cv2.CAP_PROP_FPS) or 30.0, pace)
    finally:
        cap.release()
