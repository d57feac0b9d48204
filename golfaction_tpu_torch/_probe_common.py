"""Shared pieces of the pose-front probes (`probe_arm_gain`,
`probe_heatmap_modes`, `probe_heatmap_spread`): the counterpart of the JAX
package's `scripts/_probe_common.py`.

`render_pair` renders a (fault, clean-twin) clip pair that differs only by
the fault deflection, from the port's own generator (`train/data.py`),
equal to the bit to the JAX script's.  `probe_pipeline` builds the pipeline
the probes measure from an artifacts tree of npz checkpoints (an Orbax step
folder is refused, see `checkpoint.refuse_step_dirs`).  The raw heatmaps
come from `Pipeline._pose_heatmaps`, the pose front up to the pose net.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.train import data

#: Joints each fault deflects (the generator's fault model).
FAULT_JOINTS = {
    "swaying": [11, 12, 13, 14],
    "hanging_back": [11, 12],
    "early_extension": [11, 12],
    "over_the_top": [7, 9],
    "casting": [9, 10],
    "reverse_spine": [0, 1, 2, 3, 4, 5, 6],
    "chicken_wing": [7],
    "head_movement": [0, 1, 2, 3, 4],
}
ARM_FAULTS = ("over_the_top", "casting", "chicken_wing")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pair_seed(seed: int, p: int, fault: str) -> int:
    """The render seed of pair `p` of `fault`."""
    return seed + 977 * (p + 1) + 13 * cfg_mod.SWING_ERRORS.index(fault)


def render_pair(fault: str, severity: float, seed: int, frames: int, hw):
    """(faulty, clean) SwingSamples sharing body, tempo, scene and camera.

    In-domain scene families only: the probes isolate fast-arm pose
    fidelity; cross-domain transfer is measured separately (demo_e2e
    --domain-clips)."""
    out = []
    for faults in ({fault: severity}, {}):
        s = data.swing_keypoints(
            frames, np.random.default_rng(seed),
            tempo_warp=float(np.random.default_rng(seed + 1).uniform(-0.8, 0.8)),
            faults=faults)
        s = data.place_in_image(s, hw, person_height_px=0.65 * hw[0],
                                rng=np.random.default_rng(seed + 2))
        fam_rng = np.random.default_rng(seed + 4)
        s = data.render_frames_photo(
            s, hw, rng=np.random.default_rng(seed + 3),
            scene_family=int(fam_rng.choice(data.TRAIN_SCENE_FAMILIES)))
        out.append(s)
    return out


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """The flags every probe shares (the JAX scripts' defaults); `--out` is
    required, where the scripts wrote into artifacts/."""
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--out", required=True, help="the JSON file to write (not in artifacts/)")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--hw", type=int, nargs=2, default=(540, 960))
    ap.add_argument("--seed", type=int, default=880_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override applied after the tree's own settings, e.g. "
                         "--set pose.decode_tracking=4 (repeatable)")


def probe_pipeline(args, pose_npz: str | None = None):
    """The full_pipeline preset at --frames and --hw, adapted to the tree at
    --artifacts, then --set; the tree's npz weights (the pose net's from
    `pose_npz` when given, its in_frames from that file's stem).  Raises
    ValueError on an Orbax step folder in the tree or as `pose_npz`."""
    hw = tuple(args.hw)
    cfg = cfg_mod.get_config("full_pipeline", video_hw=hw, length_buckets=(args.frames,))
    cfg = checkpoint.config_for_artifacts(cfg, args.artifacts)
    tree = checkpoint.load_params(args.artifacts)
    if pose_npz:
        checkpoint.refuse_step_dir(pose_npz)
        tree["pose"] = checkpoint.restore_params_npz(pose_npz)
        stem = tree["pose"]["params"]["Conv_0"]["kernel"]
        nf = max(int(np.shape(stem)[2]) // 3, 1)
        if nf != cfg.pose.in_frames:
            cfg = cfg_mod.apply_overrides(cfg, [f"pose.in_frames={nf}"])
        log(f"pose params overridden from {pose_npz}")
    if args.overrides:
        cfg = cfg_mod.apply_overrides(cfg, args.overrides)
    return Pipeline(cfg, weights.from_flax(tree), device="cpu" if args.cpu else args.device)


def heatmaps_of(pipe, frames: np.ndarray):
    """One clip through the pose front (its C++ motion boxes, the pad to the
    bucket, `Pipeline._pose_heatmaps`) -> (heatmaps [T, V, Hh, Wh], boxes
    [T, 4]) on the pipeline's device."""
    frames_p, boxes_p, _ = pipe._prepare(frames, None)
    with torch.inference_mode():
        return pipe._pose_heatmaps(pipe._to_device([frames_p])[0],
                                   pipe._to_device([boxes_p])[0])
