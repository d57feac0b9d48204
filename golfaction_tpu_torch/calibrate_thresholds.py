"""Calibrate per-fault decision thresholds through the real pipeline.

Renders a stratified held-out set (every fault `--per-fault` times plus
twice as many clean clips), runs both `analyze` modes (without and with a
reference swing) clip by clip with the weights of `--artifacts`, and picks
each fault's threshold maximizing F1 on the pooled probabilities
(train/metrics.calibrate_error_thresholds).  Writes
`<--out>/error_thresholds.json`, never into `--artifacts` or the repo's
`artifacts/`.  The arguments, seeds and last line are those of the JAX
package's `scripts/calibrate_thresholds.py`.

    python -m golfaction_tpu_torch.calibrate_thresholds --artifacts artifacts
        --out <dir> [--per-fault 10] [--device cpu] [--set error.dtype=float32 ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from golfaction_tpu_torch import checkpoint
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.train import data, metrics


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def calibration_probs(pipe: Pipeline, per_fault: int, frames: int, hw, log=_log):
    """(probs, truth) [2 * clips, NUM_ERRORS] of the stratified calibration
    set (seed 580_000) through `pipe.analyze`, one clip at a time, without
    and then with the reference skeleton (a clean clip, seed 581_000).
    `analyze_batch` is not used: its chunked programs move a probability by
    up to 0.017 on a self-similar clip, enough to move a threshold."""
    hw = tuple(hw)
    cal = data.make_fault_balanced_batch(
        per_fault, frames, seed=580_000, image_hw=hw, render=True, clean=2 * per_fault,
        scene_families=data.TRAIN_SCENE_FAMILIES)
    ref = data.make_swing_batch(1, frames, seed=581_000, image_hw=hw, render=True,
                                fault_prob=0.0, scene_families=data.TRAIN_SCENE_FAMILIES)[0]
    ref_skel = pipe.extract_skeleton(pipe.analyze(ref.frames))
    log(f"calibrating on {len(cal)} stratified clips x 2 modes ...")
    probs, truth = [], []
    for s in cal:
        a = pipe.analyze(s.frames)
        b = pipe.analyze(s.frames, reference=ref_skel)
        probs += [a.error_probs.float().cpu().numpy(), b.error_probs.float().cpu().numpy()]
        truth += [s.error_flags, s.error_flags]
    return np.stack(probs), np.stack(truth)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--out", required=True,
                    help="folder for error_thresholds.json (not --artifacts, not artifacts/)")
    ap.add_argument("--per-fault", type=int, default=10,
                    help="positive clips per fault (thresholds fitted on 4 flipped with "
                         "single clips)")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--hw", type=int, nargs=2, default=(540, 960))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. --set error.dtype=float32 (repeatable)")
    args = ap.parse_args(argv)
    checkpoint.refuse_inside(args.out, args.artifacts)
    T, hw = args.frames, tuple(args.hw)
    pipe = Pipeline.from_artifacts(
        args.artifacts, "full_pipeline", device="cpu" if args.cpu else args.device,
        overrides=[f"video_hw={hw}", f"length_buckets=({T},)", *args.set])
    probs, truth = calibration_probs(pipe, args.per_fault, T, hw)
    thresholds = metrics.calibrate_error_thresholds(probs, truth, log=_log)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "error_thresholds.json")
    with open(path, "w") as f:
        json.dump(thresholds, f, indent=2)
    print(json.dumps({"thresholds": path}))
    return {"thresholds": path, "values": thresholds, "probs": probs, "truth": truth}


if __name__ == "__main__":
    main()
