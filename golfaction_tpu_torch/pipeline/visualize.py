"""Skeleton rendering and the aligned side-by-side comparison of two swings.

Host-side numpy and OpenCV (imported where it draws), as the JAX package's
`pipeline/visualize.py`; the images equal its to the pixel.  Keypoints,
labels and paths may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch import graph
from golfaction_tpu_torch.types import to_numpy

# Left limbs / right limbs / center drawn in distinct colors (RGB).
_LEFT = {1, 3, 5, 7, 9, 11, 13, 15}
_RIGHT = {2, 4, 6, 8, 10, 12, 14, 16}
_COLOR_LEFT = (66, 133, 244)
_COLOR_RIGHT = (234, 67, 53)
_COLOR_MID = (52, 168, 83)


def _edge_color(a: int, b: int):
    if a in _LEFT and b in _LEFT:
        return _COLOR_LEFT
    if a in _RIGHT and b in _RIGHT:
        return _COLOR_RIGHT
    return _COLOR_MID


def draw_skeleton(image: np.ndarray, kpts, score_threshold: float = 0.2, radius: int = 4,
                  thickness: int = 2) -> np.ndarray:
    """A copy of an RGB uint8 image with one skeleton [V, 3] drawn on it."""
    import cv2

    kpts = to_numpy(kpts)
    out = np.array(image, copy=True)
    ok = kpts[:, 2] >= score_threshold
    for a, b in graph.COCO_EDGES:
        if ok[a] and ok[b]:
            pa = tuple(np.round(kpts[a, :2]).astype(int))
            pb = tuple(np.round(kpts[b, :2]).astype(int))
            cv2.line(out, pa, pb, _edge_color(a, b), thickness, cv2.LINE_AA)
    for v in range(len(kpts)):
        if ok[v]:
            p = tuple(np.round(kpts[v, :2]).astype(int))
            cv2.circle(out, p, radius, (255, 255, 255), -1, cv2.LINE_AA)
    return out


def _phase_label(idx: int) -> str:
    return cfg_mod.SWING_PHASES[idx] if 0 <= idx < cfg_mod.NUM_PHASES else "?"


def render_analysis(frames: np.ndarray, result, show_phase: bool = True) -> np.ndarray:
    """Keypoints and the phase label drawn on each valid frame of a clip:
    frames [T, H, W, 3] uint8, an AnalysisResult -> [Tv, H, W, 3]."""
    import cv2

    kpts = to_numpy(result.keypoints)
    labels = to_numpy(result.phase_labels)
    valid = to_numpy(result.valid)
    out = []
    for t in range(min(len(frames), valid.sum())):
        img = draw_skeleton(frames[t], kpts[t])
        if show_phase:
            cv2.putText(img, _phase_label(int(labels[t])), (12, 32),
                        cv2.FONT_HERSHEY_SIMPLEX, 1.0, (255, 255, 0), 2, cv2.LINE_AA)
        out.append(img)
    return np.stack(out)


def render_comparison(frames_a: np.ndarray, kpts_a, frames_b: np.ndarray, kpts_b, path,
                      path_length: int, max_pairs: Optional[int] = None) -> np.ndarray:
    """Side-by-side pairs along the DTW path: for each step (i, j), frame i
    of swing A beside frame j of swing B, skeletons drawn ->
    [L, H, Wa + Wb, 3] uint8 (at most `max_pairs` evenly spaced steps)."""
    steps = to_numpy(path)[:int(path_length)]
    if max_pairs is not None and len(steps) > max_pairs:
        sel = np.linspace(0, len(steps) - 1, max_pairs).astype(int)
        steps = steps[sel]
    kpts_a, kpts_b = to_numpy(kpts_a), to_numpy(kpts_b)
    H = max(frames_a.shape[1], frames_b.shape[1])

    def pad_h(img):
        return img if img.shape[0] == H else np.pad(img, ((0, H - img.shape[0]), (0, 0), (0, 0)))

    panels = [np.concatenate([pad_h(draw_skeleton(frames_a[i], kpts_a[i])),
                              pad_h(draw_skeleton(frames_b[j], kpts_b[j]))], axis=1)
              for i, j in steps]
    return np.stack(panels)


def write_video(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """Write RGB frames [T, H, W, 3] uint8 to an mp4 file."""
    import cv2

    T, H, W, _ = frames.shape
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
