"""Typed configuration: the same dataclasses, presets and `--set` override
syntax as the JAX package, so one config describes both implementations.

Each model's `dtype` field sets its compute dtype as flax's `dtype` does
(models/precision.py: parameters float32, products and normalizations'
results rounded to bfloat16, the layers the JAX package pins to float32 kept
float32), so the shipped default runs bfloat16.  The GCN's inference is the
exception the JAX package makes too: on the TPU it is float32 whatever
`GCNConfig.dtype` says (models/gcn.py).  The JAX package's `*_impl`
fields, which choose between two implementations of one function, are not
carried: each stage here has one, its kernel on the card, and an override
naming such a field is refused.  `mesh` is read by `parallel.mesh.make_mesh`.
`preprocess_dtype` is "float32" or "bfloat16", the dtype of the pose pass's
crops (kernel A or its bfloat16 variant); any other value is refused when
the PipelineConfig is built, so also by `apply_overrides`.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Sequence

from golfaction_tpu_torch import graph

# Per-frame swing-phase label set of the action-segmentation head.
SWING_PHASES = (
    "background",
    "address",
    "takeaway",
    "backswing",
    "top",
    "downswing",
    "impact",
    "follow_through",
    "finish",
)
NUM_PHASES = len(SWING_PHASES)

# Swing-fault taxonomy of the error-detection head (multi-label flags).
SWING_ERRORS = (
    "swaying",            # lateral hip slide in backswing
    "hanging_back",       # weight stays on trail side at impact
    "early_extension",    # hips move toward ball in downswing
    "over_the_top",       # downswing plane above backswing plane
    "casting",            # early wrist release
    "reverse_spine",      # upper body tilts toward target at top
    "chicken_wing",       # lead elbow breaks down after impact
    "head_movement",      # excessive head drift
)
NUM_ERRORS = len(SWING_ERRORS)


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    """Top-down heatmap pose model."""

    input_hw: tuple[int, int] = (256, 192)      # crop H, W fed to the backbone
    heatmap_hw: tuple[int, int] = (64, 48)      # output heatmap H, W (stride 4)
    num_joints: int = graph.NUM_JOINTS
    stage_blocks: tuple[int, ...] = (2, 2, 2, 2)
    stage_channels: tuple[int, ...] = (64, 128, 256, 512)
    deconv_channels: tuple[int, ...] = (256, 128, 128)
    dtype: str = "bfloat16"
    # Odd number of adjacent frames concatenated on channels (1 = single).
    in_frames: int = 1
    udp: bool = True                             # sub-pixel (UDP-style) decode
    sigma: float = 2.0                           # target heatmap gaussian sigma
    # Tracked decode: 0 = single-peak decode; k > 1 = top-k NMS modes per
    # frame, selected per joint by Viterbi over the clip.
    decode_tracking: int = 0
    track_lambda: float = 0.1
    # NMS suppression radius (heatmap px) of the tracked-decode modes.
    track_suppress_radius: float = 3.0


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    """Skeleton GCN action segmentation."""

    num_joints: int = graph.NUM_JOINTS
    in_channels: int = 3                         # (x, y, score)
    num_phases: int = NUM_PHASES
    block_channels: tuple[int, ...] = (64, 64, 128, 128, 256, 256)
    # Multi-branch temporal conv: (kernel, dilation) branches + maxpool branch.
    temporal_branches: tuple[tuple[int, int], ...] = ((3, 1), (3, 2), (3, 3), (3, 4))
    channel_att_reduction: int = 4
    graph_strategy: str = "spatial"
    dropout: float = 0.1
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Temporal-alignment embedding net + soft-DTW."""

    num_joints: int = graph.NUM_JOINTS
    in_channels: int = 3
    embed_dim: int = 128
    hidden_channels: tuple[int, ...] = (64, 128)
    temporal_kernel: int = 5
    gamma: float = 0.1                           # soft-DTW smoothing
    normalize_embeddings: bool = True
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class ErrorConfig:
    """Swing-error classifier."""

    num_errors: int = NUM_ERRORS
    num_phases: int = NUM_PHASES
    num_joints: int = graph.NUM_JOINTS
    in_channels: int = 3
    hidden_dim: int = 256
    dtype: str = "bfloat16"
    # Heatmap-spread features (+2*V feature channels).
    spread_features: bool = False
    # Secondary-mode features (+3*V); requires pose.decode_tracking >= 2.
    mode_features: bool = False


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Keypoint-sequence refiner (opt-in)."""

    enabled: bool = False
    block_channels: tuple[int, ...] = (48, 48)
    temporal_branches: tuple[tuple[int, int], ...] = ((3, 1), (3, 2), (3, 4))
    channel_att_reduction: int = 4
    max_residual: float = 0.5
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout, read by parallel.mesh.make_mesh."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


# The dtypes of the pose pass's crops: kernel A writes float32, its variant
# bfloat16.
PREPROCESS_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end orchestrator."""

    pose: PoseConfig = PoseConfig()
    gcn: GCNConfig = GCNConfig()
    align: AlignConfig = AlignConfig()
    error: ErrorConfig = ErrorConfig()
    refine: RefineConfig = RefineConfig()
    mesh: MeshConfig = MeshConfig()
    frame_batch: int = 32                        # frames per pose micro-batch
    # Clip lengths are padded up to the nearest bucket.
    length_buckets: tuple[int, ...] = (64, 128, 256, 512)
    video_hw: tuple[int, int] = (1080, 1920)
    preprocess_dtype: str = "float32"
    # analyze_batch processes clips in chunks of this many.
    clip_batch: int = 8
    # Keypoint-seeded box refinement: a coarse pose pass every this many
    # frames seeds the boxes of the full pass; 0 = off.
    box_refine_stride: int = 0

    def __post_init__(self):
        if self.preprocess_dtype not in PREPROCESS_DTYPES:
            raise ValueError(
                f"preprocess_dtype={self.preprocess_dtype!r}: the crops are one of "
                f"{', '.join(map(repr, PREPROCESS_DTYPES))} (the dtypes the models compute in)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
    checkpoint_dir: str = "/tmp/golfaction_ckpt"
    checkpoint_every: int = 200
    # TensorBoard scalar mirror; only None until the logging module is ported.
    tb_logdir: str | None = None


def _preset_pose_single() -> PipelineConfig:
    return PipelineConfig(frame_batch=1)


def _preset_clip_pose() -> PipelineConfig:
    return PipelineConfig(frame_batch=32)


def _preset_segmentation() -> PipelineConfig:
    return PipelineConfig()


def _preset_alignment() -> PipelineConfig:
    return PipelineConfig()


def _preset_full_pipeline() -> PipelineConfig:
    return PipelineConfig(frame_batch=64)


PRESETS = {
    "pose_single": _preset_pose_single,
    "clip_pose": _preset_clip_pose,
    "segmentation": _preset_segmentation,
    "alignment": _preset_alignment,
    "full_pipeline": _preset_full_pipeline,
}


def get_config(name: str = "full_pipeline", **overrides) -> PipelineConfig:
    cfg = PRESETS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def apply_overrides(cfg, assignments: Sequence[str]):
    """Apply `dotted.key=value` overrides to a (nested) frozen dataclass.

    Values parse as Python literals when possible, else stay strings:
        apply_overrides(cfg, ["frame_batch=16", "length_buckets=(32,64)"])
    """
    for item in assignments:
        key, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} must look like key=value")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        parts = key.strip().split(".")
        chain = [cfg]
        for p in parts[:-1]:
            chain.append(getattr(chain[-1], p))
        if not hasattr(chain[-1], parts[-1]):
            raise AttributeError(f"no config field {key!r}")
        node = dataclasses.replace(chain[-1], **{parts[-1]: value})
        for obj, name in zip(reversed(chain[:-1]), reversed(parts[:-1])):
            node = dataclasses.replace(obj, **{name: node})
        cfg = node
    return cfg
