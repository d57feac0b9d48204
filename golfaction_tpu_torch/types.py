"""Value types flowing out of the pipeline, holding torch tensors.

Shape conventions (T is padded to a length bucket):
  keypoints: [T, V, 3]                  (x, y, score) in source-image pixels
  phases:    [T] int32                  per-frame swing-phase label (-1 = pad)
  path:      [Ta + Tb - 1, 2] int32     alignment path (padded with -1)
  errors:    [E] float32                per-fault probability
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like -> a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Skeleton:
    """Per-frame 2D keypoints for one clip."""

    keypoints: torch.Tensor             # [T, V, 3] (x, y, score), image px
    valid: torch.Tensor                 # [T] bool

    @property
    def num_frames(self) -> int:
        return self.keypoints.shape[0]

    @property
    def num_joints(self) -> int:
        return self.keypoints.shape[1]


@dataclasses.dataclass
class AlignmentResult:
    """Soft-DTW comparison of two swings."""

    cost: torch.Tensor                  # [] soft-DTW alignment cost
    path: torch.Tensor                  # [Lmax, 2] int32 (i, j); -1 padding
    path_length: torch.Tensor           # [] int32 number of valid path steps


@dataclasses.dataclass
class AnalysisResult:
    """Full-pipeline output."""

    keypoints: torch.Tensor             # [T, V, 3]
    phase_labels: torch.Tensor          # [T] int32 into config.SWING_PHASES
    phase_logits: torch.Tensor          # [T, P]
    error_flags: torch.Tensor           # [E] bool
    error_probs: torch.Tensor           # [E] float32
    valid: torch.Tensor                 # [T] bool
    alignment: Optional[AlignmentResult] = None
