"""Per-joint fault-deflection transfer gain through the real pose front: the
port's counterpart of the JAX package's `scripts/probe_arm_gain.py`, with
its flags, seeds and JSON layout.

For every fault class it renders N paired clips, the fault at a fixed
severity and its clean twin (same body, tempo, scene, occluders, camera),
runs both through `Pipeline.analyze` (C++ motion boxes -> crop (kernel A)
-> pose net -> the tree's decode -> GCN (kernel B) -> error head), and
regresses the predicted deflection onto the true one over the fault's
joints, on frames where the true deflection exceeds 1 px:

    gain_j = sum_t(pred_defl . true_defl) / sum_t(|true_defl|^2)

gain 1.0: the fault survives the pose stage intact; 0.0: wiped out.  The
weights come from the tree's `params/*.npz` (an Orbax step folder is
refused); `--pose-dir` names another pose checkpoint, a `.npz` file.

    python -m golfaction_tpu_torch.probe_arm_gain --pairs 4 --out <file>
        [--device cpu] [--pose-dir <pose.npz>] [--set pose.decode_tracking=4 ...]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from golfaction_tpu_torch import checkpoint
from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch._probe_common import (ARM_FAULTS, FAULT_JOINTS, add_common_args,
                                                log, pair_seed, probe_pipeline, render_pair)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--severity", type=float, default=1.0)
    ap.add_argument("--pose-in-frames", type=int, default=None,
                    help="default: from the pose checkpoint's stem")
    ap.add_argument("--pose-dir", default=None,
                    help="another pose checkpoint, a .npz file (compare candidates without "
                         "touching the tree)")
    return ap.parse_args(argv)


def fault_gain(pred_d: np.ndarray, true_d: np.ndarray, joints) -> tuple:
    """(num [J], den [J], peak |true| per joint with a >1 px frame) of the
    gain regression over one pair's deflections [T, V, 2]."""
    num = np.zeros(len(joints))
    den = np.zeros(len(joints))
    mag = []
    for ji, j in enumerate(joints):
        m = np.linalg.norm(true_d[:, j], axis=-1) > 1.0
        num[ji] += float((pred_d[m, j] * true_d[m, j]).sum())
        den[ji] += float((true_d[m, j] ** 2).sum())
        if m.any():
            mag.append(float(np.abs(true_d[m, j]).max()))
    return num, den, mag


def main(argv=None) -> dict:
    """Run the probe, write --out, print the JAX script's last line; returns
    the report."""
    args = parse_args(argv)
    checkpoint.refuse_inside(args.out)
    if args.pose_in_frames is not None:
        args.overrides = [f"pose.in_frames={args.pose_in_frames}", *args.overrides]
    pipe = probe_pipeline(args, pose_npz=args.pose_dir)
    hw, T = tuple(args.hw), args.frames
    report = {"severity": args.severity, "pairs": args.pairs, "hw": list(hw), "faults": {}}
    for fault in cfg_mod.SWING_ERRORS:
        joints = FAULT_JOINTS[fault]
        num = np.zeros(len(joints))
        den = np.zeros(len(joints))
        mag = []
        for p in range(args.pairs):
            s_fault, s_clean = render_pair(fault, args.severity, pair_seed(args.seed, p, fault),
                                           T, hw)
            kp_f = pipe.analyze(s_fault.frames).keypoints.float().cpu().numpy()[:T, :, :2]
            kp_c = pipe.analyze(s_clean.frames).keypoints.float().cpu().numpy()[:T, :, :2]
            true_d = s_fault.keypoints[:T, :, :2] - s_clean.keypoints[:T, :, :2]
            n_, d_, m_ = fault_gain(kp_f - kp_c, true_d, joints)
            num, den, mag = num + n_, den + d_, mag + m_
        gains = {str(j): round(float(num[ji] / max(den[ji], 1e-9)), 3)
                 for ji, j in enumerate(joints)}
        entry = {"per_joint_gain": gains,
                 "mean_gain": round(float(np.mean(list(gains.values()))), 3),
                 "peak_true_defl_px": round(float(np.max(mag)) if mag else 0.0, 1)}
        report["faults"][fault] = entry
        log(f"[{fault:16s}] mean gain {entry['mean_gain']:+.3f}  per-joint {gains}  "
            f"peak true defl {entry['peak_true_defl_px']:.0f}px")
    report["arm_mean_gain"] = round(float(np.mean(
        [report["faults"][f]["mean_gain"] for f in ARM_FAULTS])), 3)
    report["drift_mean_gain"] = round(float(np.mean(
        [report["faults"][f]["mean_gain"] for f in cfg_mod.SWING_ERRORS
         if f not in ARM_FAULTS])), 3)
    log(f"ARM faults mean gain:   {report['arm_mean_gain']:+.3f}  (target >= 0.7)")
    log(f"drift faults mean gain: {report['drift_mean_gain']:+.3f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"arm_mean_gain": report["arm_mean_gain"],
                      "drift_mean_gain": report["drift_mean_gain"]}))
    return report


if __name__ == "__main__":
    main()
