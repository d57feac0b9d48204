"""Online / streaming swing analysis: push frames as they arrive and receive
per-frame results with bounded latency.

A sliding window of `window` frames (one of the pipeline's length buckets)
advances every `hop` frames; each step runs the pipeline's single-clip
program (`Pipeline._core_fn`, on the card: kernels A and B, and the box
refinement when `box_refine_stride > 0`) and emits final results for the
`hop` oldest frames, which then have at least `window - hop` frames of
context.  Person boxes default to constant full-frame boxes, refined on the
device by the keypoint-seeded box tracking; host motion-energy boxes are
the opt-in (`host_boxes=True`) and the default of a pipeline without that
refinement.  It emits the frame indices and fields of the JAX package's
`pipeline/streaming.py`.

Latency: `window` frames for the first emission, then `hop` frames a step
(at 30 fps, window 64 and hop 16: about 2.1 s, then 0.5 s).
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch

from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.pipeline import video_io
from golfaction_tpu_torch.types import to_numpy


class StreamAnalyzer:
    """Incremental analysis over a frame stream.

        sa = StreamAnalyzer(pipe, window=64, hop=16)
        for frame in camera:
            for res in sa.push(frame):
                ...  # dict(frame_index, keypoints [V, 3], phase_label, ...)
        for res in sa.flush():
            ...

    Telemetry: `host_box_s` (seconds of host box work) and
    `windows_processed`."""

    def __init__(self, pipeline, window: int = 64, hop: int = 16,
                 host_boxes: Optional[bool] = None):
        if hop < 1 or hop > window:
            raise ValueError("need 1 <= hop <= window")
        if window not in pipeline.cfg.length_buckets:
            raise ValueError(
                f"window {window} must be one of the pipeline's length "
                f"buckets {pipeline.cfg.length_buckets} (shared jit program)")
        self.pipe = pipeline
        self.window = window
        self.hop = hop
        if host_boxes is None:
            host_boxes = pipeline.cfg.box_refine_stride <= 0
        self.host_boxes = host_boxes
        self._buf: list[np.ndarray] = []
        self._next_emit = 0          # global index of the next frame to emit
        self._total_pushed = 0
        self.host_box_s = 0.0
        self.windows_processed = 0

    def push(self, frame: np.ndarray) -> list[dict]:
        """Add one frame [H, W, 3] uint8; returns the newly final results."""
        self._buf.append(np.asarray(frame))
        self._total_pushed += 1
        if len(self._buf) < self.window:
            return []
        window_start = self._total_pushed - self.window
        frames = np.stack(self._buf[-self.window:])
        res = self._run(frames, self._boxes_for(frames), np.ones(self.window, bool))
        emit_from = self._next_emit - window_start
        out = self._emit(res, window_start, emit_from, n_valid=self.window,
                         emit_until=max(self.hop, emit_from))
        self._buf = self._buf[self.hop:]
        return out

    def flush(self) -> list[dict]:
        """Process the remaining frames (a padded window) and emit the rest."""
        if self._next_emit >= self._total_pushed or not self._buf:
            self._buf = []
            return []
        frames = np.stack(self._buf)
        frames_p, boxes_p, valid = video_io.pad_to_bucket(
            frames, self._boxes_for(frames), self.pipe.cfg.length_buckets)
        res = self._run(frames_p, boxes_p, valid)
        start = self._total_pushed - len(self._buf)
        out = self._emit(res, start, self._next_emit - start, n_valid=len(self._buf))
        self._buf = []
        return out

    def _boxes_for(self, frames: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        if self.host_boxes:
            boxes = video_io.estimate_person_boxes(frames)
        else:
            T, H, W = frames.shape[:3]
            boxes = np.tile(np.asarray([W / 2.0, H / 2.0, float(W), float(H)], np.float32),
                            (T, 1))
        self.host_box_s += time.perf_counter() - t0
        self.windows_processed += 1
        return boxes

    @torch.inference_mode()
    def _run(self, frames, boxes, valid) -> dict:
        p = self.pipe
        out = p._core_fn(p._to_device([frames]), p._to_device([boxes]),
                         p._to_device([valid]))
        out["error_probs"] = torch.sigmoid(out["error_logits"])
        return {k: to_numpy(v[0]) for k, v in out.items()}

    def _emit(self, res: dict, start: int, emit_from: int, n_valid: int,
              emit_until: Optional[int] = None) -> list[dict]:
        if emit_until is None:
            emit_until = n_valid
        probs, labels = res["error_probs"], res["phase_labels"]
        out = []
        for i in range(max(emit_from, 0), emit_until):
            gi = start + i
            if gi < self._next_emit or i >= n_valid:
                continue
            out.append({
                "frame_index": gi,
                "keypoints": res["keypoints"][i],
                "phase_label": int(labels[i]),
                "phase": cfg_mod.SWING_PHASES[int(labels[i])],
                "phase_logits": res["phase_logits"][i],
                "error_probs": probs,
            })
            self._next_emit = gi + 1
        return out


def analyze_stream(pipeline, frames: Iterator[np.ndarray], window: int = 64,
                   hop: int = 16) -> Iterator[dict]:
    """Generator convenience: per-frame results from a frame iterator."""
    sa = StreamAnalyzer(pipeline, window=window, hop=hop)
    for f in frames:
        yield from sa.push(f)
    yield from sa.flush()
