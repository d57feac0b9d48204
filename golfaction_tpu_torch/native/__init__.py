"""ctypes binding of the host library native/golfer_host.cpp: motion-energy
person boxes and batch BGR -> RGB conversion, multithreaded.

The library is built with g++ at first use into golfaction_tpu_torch/build/
(ops/_kernels.py, the same build step and lock as the CUDA kernels).  A failed
build raises with the compiler's output; nothing falls back quietly.  The
numpy body of `pipeline.video_io.estimate_person_boxes(use_native=False)` is
its oracle.
"""

from __future__ import annotations

import ctypes

import numpy as np

from golfaction_tpu_torch.ops import _kernels


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def motion_boxes(frames: np.ndarray, min_size: float = 0.15, smooth: int = 9) -> np.ndarray:
    """Motion-energy boxes [T, 4] float32 (cx, cy, w, h) of frames
    [T, H, W, 3] uint8: the numpy body's algorithm, percentiles from
    per-frame histograms (within 1 px of it)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"motion_boxes: expected frames [T, H, W, 3], got {frames.shape}")
    T, H, W, _ = frames.shape
    out = np.empty((T, 4), np.float32)
    fn = _kernels.bind("golfer_host", "motion_boxes", "plllfip", restype=None)
    fn(_u8(frames), T, H, W, float(min_size), int(smooth), _u8(out))
    return out


def bgr_to_rgb(frames: np.ndarray) -> np.ndarray:
    """Swap the first and last channel of uint8 pixels [..., 3]."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.shape[-1] != 3:
        raise ValueError(f"bgr_to_rgb: expected [..., 3] pixels, got {frames.shape}")
    out = np.empty_like(frames)
    fn = _kernels.bind("golfer_host", "bgr_to_rgb", "plp", restype=None)
    fn(_u8(frames), frames.size // 3, _u8(out))
    return out
