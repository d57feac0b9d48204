"""Shared helpers of the cascade tests (tests/test_torch_cascade*.py): a tiny
artifacts tree made from the JAX pipeline's random parameters, the tiny
float32 config both packages run it at, and the port's `--set` list of the
same widths."""

import dataclasses
import json
import os
import shutil
from pathlib import Path

import numpy as np

from golfaction_tpu import config as jcfg
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.train import checkpoint as jckpt

ROOT = Path(__file__).resolve().parent.parent
PROBES = ("probe_arm_gain.json", "probe_heatmap_spread.json", "probe_heatmap_modes.json")
POSE_META = {"sigma": 1.25, "decode_tracking": 4, "track_suppress_radius": 2.0}

# The golden fixture's widths (tests/golden/common.py), float32, the GCN with
# its default dropout (the cascade trains without it) and an error head of the
# mode-features width.
TINY = jcfg.PipelineConfig(
    pose=jcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
                         stage_channels=(8, 16, 32), deconv_channels=(16, 16), dtype="float32"),
    gcn=jcfg.GCNConfig(block_channels=(8, 16), temporal_branches=((3, 1), (3, 2)),
                       dtype="float32"),
    align=jcfg.AlignConfig(embed_dim=16, hidden_channels=(8, 16), dtype="float32"),
    error=jcfg.ErrorConfig(hidden_dim=32, dtype="float32", mode_features=True),
    refine=jcfg.RefineConfig(block_channels=(8,), temporal_branches=((3, 1),), dtype="float32"),
    frame_batch=4,
)

# The same widths as the port's --set overrides.
TINY_SET = [
    "pose.input_hw=(64, 48)", "pose.heatmap_hw=(16, 12)", "pose.stage_blocks=(1, 1, 1)",
    "pose.stage_channels=(8, 16, 32)", "pose.deconv_channels=(16, 16)", "pose.dtype=float32",
    "gcn.block_channels=(8, 16)", "gcn.temporal_branches=((3, 1), (3, 2))",
    "gcn.dtype=float32", "align.embed_dim=16", "align.hidden_channels=(8, 16)",
    "align.dtype=float32", "error.hidden_dim=32", "error.dtype=float32",
    "refine.block_channels=(8,)", "refine.temporal_branches=((3, 1),)", "refine.dtype=float32",
    "frame_batch=4",
]


def tiny_get_config(name: str = "full_pipeline", **overrides):
    """Stands in for golfaction_tpu.config.get_config: TINY whatever preset."""
    return dataclasses.replace(TINY, **overrides) if overrides else TINY


def jax_params(cfg=TINY, seed: int = 0) -> dict:
    """The JAX pipeline's random parameters at `cfg` (with the tracked decode
    of the shipped tree)."""
    cfg = dataclasses.replace(cfg, pose=dataclasses.replace(cfg.pose, **POSE_META))
    return jorch.Pipeline(cfg, seed=seed).params


def build_tree(root, params=None, refine=None) -> str:
    """A tiny artifacts tree at `root`: params/*.npz (float32) of the JAX
    pipeline's random parameters, pose_meta.json (tracked decode 4), the
    repo's probe_*.json and error_thresholds.json; `refine` adds a refiner."""
    params = params if params is not None else jax_params()
    pdir = os.path.join(root, "params")
    os.makedirs(pdir, exist_ok=True)
    for name in ("pose", "gcn", "align", "error"):
        jckpt.save_params_npz(os.path.join(pdir, f"{name}.npz"), params[name], dtype=np.float32)
    if refine is not None:
        jckpt.save_params_npz(os.path.join(pdir, "refine.npz"), refine, dtype=np.float32)
    with open(os.path.join(root, "pose_meta.json"), "w") as f:
        json.dump(POSE_META, f)
    for fname in (*PROBES, "error_thresholds.json"):
        shutil.copyfile(ROOT / "artifacts" / fname, os.path.join(root, fname))
    return str(root)


def tree_bytes(root) -> dict:
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for fname in files:
            path = os.path.join(dirpath, fname)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out
