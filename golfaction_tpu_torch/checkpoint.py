"""Loading the shipped weights and config from an artifacts tree, and
writing weights back in the same form.

Reads and writes the compact `<root>/params/<model>.npz` checkpoints (flax
key paths such as `params/ResBlock_0/Conv_0/kernel`), and reads and writes
`pose_meta.json` and reads `error_thresholds.json`.  `write_artifacts`
writes a new tree beside the one it was derived from.

The JAX package also keeps a model as an Orbax step folder
(`params/<model>/step_*`), which it prefers to `<model>.npz`.  The port
reads npz only, so every reader of a tree (`load_params`,
`config_for_artifacts`) refuses a tree that holds such a folder for any
model rather than run other weights than the JAX package would
(`refuse_step_dirs`).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Optional

import numpy as np

from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.graph import NUM_JOINTS
from golfaction_tpu_torch.models.error import NUM_ANGLE_FEATURES


#: The models an artifacts tree may hold, as `params/<name>.npz`.
MODEL_NAMES = ("pose", "gcn", "align", "error", "refine")


def _params_dir(root: str) -> str:
    p = os.path.join(root, "params")
    return p if os.path.isdir(p) else root


def _npz_advice(where: str) -> str:
    return ("convert it to the npz form first (golfaction_tpu.train.checkpoint."
            f"save_params_npz of its restored params, as {where}), or remove it")


def step_dirs(root: str) -> list:
    """The Orbax step folders `<params>/<name>/step_*` of a tree, sorted; an
    empty `<params>/<name>/` holds none (the JAX package's
    `latest_step_dir` returns None for it)."""
    base = _params_dir(root)
    out = []
    for name in MODEL_NAMES:
        d = os.path.join(base, name)
        if os.path.isdir(d):
            out += [os.path.join(d, e) for e in sorted(os.listdir(d)) if e.startswith("step_")]
    return out


def refuse_step_dirs(root: str) -> None:
    """ValueError naming every `params/<name>/step_*` of the tree at `root`:
    the JAX package loads such a folder in preference to `<name>.npz`, and
    the port cannot read it."""
    found = step_dirs(root)
    if found:
        npz = sorted({os.path.dirname(d) + ".npz" for d in found})
        raise ValueError(
            f"{root} holds Orbax checkpoints {found}, which the JAX package loads in "
            "preference to the npz form and the port does not read: for each model "
            + _npz_advice(" / ".join(npz)))


def refuse_step_dir(path: str) -> None:
    """ValueError when `path`, given as a params checkpoint file, is a folder
    (an Orbax checkpoint)."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a folder, an Orbax checkpoint, which the port does not "
                         "read: " + _npz_advice("a .npz file"))


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


def load_params(root: str, names=MODEL_NAMES) -> dict:
    """{name: nested numpy tree} for every `<name>.npz` present.  Raises
    ValueError on a tree with an Orbax step folder (`refuse_step_dirs`)."""
    refuse_step_dirs(root)
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


def save_pose_meta(root: str, **meta) -> str:
    """Write `<root>/pose_meta.json`: the decode configuration of the tree's
    pose checkpoint (POSE_META_KEYS), which array shapes cannot reveal;
    `config_for_artifacts` reads it back.  Raises ValueError on another key."""
    unknown = set(meta) - set(POSE_META_KEYS)
    if unknown:
        raise ValueError(f"unknown pose_meta keys: {sorted(unknown)}")
    path = os.path.join(os.path.abspath(root), "pose_meta.json")
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


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
    agree.  Raises ValueError on a tree with an Orbax step folder for any
    model (`refuse_step_dirs`): the JAX package would load that folder, and
    the port cannot."""
    refuse_step_dirs(root)
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


#: The repo's shipped tree, which nothing in the port writes into.
REPO_ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "artifacts")


def _inside(path: str, root: str) -> bool:
    path, root = os.path.realpath(path), os.path.realpath(root)
    return path == root or path.startswith(root.rstrip(os.sep) + os.sep)


def refuse_inside(out: str, src: Optional[str] = None) -> None:
    """ValueError when the output folder `out` is the tree `src`, lies
    inside it, or lies inside the repo's `artifacts/`."""
    for root, what in ((src, "the source tree"), (REPO_ARTIFACTS, "the repo's artifacts/")):
        if root is not None and _inside(out, root):
            raise ValueError(f"out={out!r} lies inside {what} ({root}); write the new files "
                             "to a folder of their own")


def write_artifacts(out: str, src: str, params: dict, thresholds: Optional[dict] = None) -> dict:
    """Write a new artifacts tree at `out` derived from the tree `src`.

    `params` {model name: torch state_dict}: each written as
    `<out>/params/<name>.npz` (weights.to_flax, float32: nothing is rounded).
    `thresholds` {fault: threshold}: written as `<out>/error_thresholds.json`.
    Everything else that `Pipeline.from_artifacts` and the cascade read is
    copied from `src` as it is: the other `params/*.npz`, `pose_meta.json`,
    `probe_*.json` and, without `thresholds`, `error_thresholds.json`.
    Raises ValueError when `out` is `src`, lies inside it, or lies inside the
    repo's `artifacts/`.  Returns {name or "thresholds": path written}."""
    from golfaction_tpu_torch import weights

    refuse_inside(out, src)
    pdir = os.path.join(out, "params")
    os.makedirs(pdir, exist_ok=True)
    written = {}
    for name, tree in weights.to_flax(params).items():
        written[name] = save_params_npz(os.path.join(pdir, f"{name}.npz"), tree,
                                        dtype=np.float32)
    for path in sorted(glob.glob(os.path.join(_params_dir(src), "*.npz"))):
        if os.path.basename(path)[:-4] not in written:
            shutil.copyfile(path, os.path.join(pdir, os.path.basename(path)))
    keep = ["pose_meta.json", *sorted(os.path.basename(p) for p in
                                      glob.glob(os.path.join(src, "probe_*.json")))]
    if thresholds is None:
        keep.append("error_thresholds.json")
    for fname in keep:
        if os.path.exists(os.path.join(src, fname)):
            shutil.copyfile(os.path.join(src, fname), os.path.join(out, fname))
    if thresholds is not None:
        written["thresholds"] = os.path.join(out, "error_thresholds.json")
        with open(written["thresholds"], "w") as f:
            json.dump(thresholds, f, indent=2)
    return written
