"""Loading the shipped weights and config from an artifacts tree, and
writing weights back in the same form.

Reads and writes the compact float16 `<root>/params/<model>.npz` checkpoints
(flax key paths such as `params/ResBlock_0/Conv_0/kernel`), and reads
`pose_meta.json` and `error_thresholds.json`.  Numpy and json only.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.graph import NUM_JOINTS
from golfaction_tpu_torch.models.error import NUM_ANGLE_FEATURES


def _params_dir(root: str) -> str:
    p = os.path.join(root, "params")
    return p if os.path.isdir(p) else root


def restore_params_npz(path: str, cast=np.float32) -> dict:
    """A flattened npz checkpoint -> nested dict of numpy arrays, float
    leaves cast to `cast` (float32 by default)."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = data[key]
            if cast is not None and np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(cast)
            node[parts[-1]] = arr
    return tree


def save_params_npz(path: str, params: dict, dtype=np.float16) -> str:
    """Compact single-file checkpoint in the JAX package's layout: the nested
    dict of arrays (a flax tree, see weights.to_flax) flattened to '/'-joined
    key paths in one compressed .npz, float leaves cast to `dtype`."""
    out = {}

    def walk(node, prefix):
        for key in sorted(node):
            val = node[key]
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
                continue
            arr = np.asarray(val)
            if dtype is not None and np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(dtype)
            out[f"{prefix}{key}"] = arr

    walk(params, "")
    np.savez_compressed(path, **out)
    return path


def load_params(root: str, names=("pose", "gcn", "align", "error", "refine")) -> dict:
    """{name: nested numpy tree} for every `<name>.npz` present."""
    base = _params_dir(root)
    out = {}
    for name in names:
        path = os.path.join(base, f"{name}.npz")
        if os.path.exists(path):
            out[name] = restore_params_npz(path)
    return out


def _npz_shape(root: str, name: str, key: str):
    path = os.path.join(_params_dir(root), f"{name}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return d[key].shape if key in d.files else None


def detect_pose_in_frames(root: str) -> int:
    """pose.in_frames from the stem kernel [7, 7, 3*in_frames, 64]; 1 when
    no pose checkpoint exists."""
    shape = _npz_shape(root, "pose", "params/Conv_0/kernel")
    return 1 if shape is None else max(int(shape[2]) // 3, 1)


def detect_error_aux(root: str) -> Optional[dict]:
    """The error head's aux-feature variant from its first Dense input dim:
    base, +2*V (spread_features) or +3*V (mode_features); None when
    undetectable."""
    shape = _npz_shape(root, "error", "params/Dense_0/kernel")
    if shape is None:
        return None
    in_dim = int(shape[0])
    V = NUM_JOINTS
    base_dim = 2 * V + 2 * V + 2 * NUM_ANGLE_FEATURES + 3 * V + 1
    if in_dim == base_dim:
        return {"spread_features": False, "mode_features": False}
    if in_dim == base_dim + 2 * V:
        return {"spread_features": True, "mode_features": False}
    if in_dim == base_dim + 3 * V:
        return {"spread_features": False, "mode_features": True}
    return None


#: pose_meta.json keys -> PipelineConfig override paths (decode properties
#: that array shapes cannot reveal).
POSE_META_KEYS = {
    "sigma": "pose.sigma",
    "decode_tracking": "pose.decode_tracking",
    "track_lambda": "pose.track_lambda",
    "track_suppress_radius": "pose.track_suppress_radius",
}


def load_pose_meta(root: str) -> dict:
    path = os.path.join(os.path.abspath(root), "pose_meta.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {k: v for k, v in json.load(f).items() if k in POSE_META_KEYS}


def config_for_artifacts(cfg, root: str):
    """Adapt a PipelineConfig to an artifacts tree: pose_meta.json's decode
    settings, the pose stem's in_frames, the keypoint refiner when the tree
    carries `refine.npz` and the error head's aux variant.  No-op when they
    agree.  Raises on a refiner kept as an Orbax step directory
    (`params/refine/step_*`), which the port cannot read."""
    overrides = []
    meta = load_pose_meta(root)
    for key, path in POSE_META_KEYS.items():
        val = meta.get(key)
        if val is None:
            continue
        obj = cfg
        for part in path.split(".")[:-1]:
            obj = getattr(obj, part)
        if val != getattr(obj, path.split(".")[-1]):
            overrides.append(f"{path}={val}")
    nf = detect_pose_in_frames(root)
    if nf != cfg.pose.in_frames:
        overrides.append(f"pose.in_frames={nf}")
    # The JAX package enables a refiner kept as an Orbax step directory; the
    # port reads the compact npz form only, so such a tree is refused rather
    # than run without its refiner.
    steps = os.path.join(_params_dir(root), "refine")
    if os.path.isdir(steps) and any(d.startswith("step_") for d in os.listdir(steps)):
        raise ValueError(
            f"{steps} holds a trained keypoint refiner as an Orbax checkpoint, which the "
            "port does not read: convert it to the npz form first "
            "(golfaction_tpu.train.checkpoint.save_params_npz of its params, as "
            f"{os.path.join(_params_dir(root), 'refine.npz')}), so that it is not dropped")
    has_refine = os.path.exists(os.path.join(_params_dir(root), "refine.npz"))
    if has_refine != cfg.refine.enabled:
        overrides.append(f"refine.enabled={has_refine}")
    aux = detect_error_aux(root)
    if aux is not None:
        for k, v in aux.items():
            if v != getattr(cfg.error, k):
                overrides.append(f"error.{k}={v}")
    return cfg_mod.apply_overrides(cfg, overrides) if overrides else cfg


def load_error_thresholds(root: str) -> Optional[np.ndarray]:
    """Per-fault decision thresholds [NUM_ERRORS] float32 ordered like
    config.SWING_ERRORS, or None when the tree has none."""
    path = os.path.join(root, "error_thresholds.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return np.asarray([float(d.get(name, 0.5)) for name in cfg_mod.SWING_ERRORS],
                      np.float32)
