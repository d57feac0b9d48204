"""Per-fault thresholds of `calibrate_thresholds` beside the shipped ones.

Runs the calibration set of `golfaction_tpu_torch.calibrate_thresholds`
(stratified clips, both `analyze` modes) through the shipped tree at
bfloat16 (as shipped) and at float32, picks each fault's threshold on each,
and prints for every fault: the shipped threshold (`error_thresholds.json`),
each dtype's, the calibration F1 at each of them on that dtype's
probabilities, the positives, and how many probabilities lie within 0.05 of
the chosen threshold; and between the dtypes, the largest probability gap
and how many (clip, fault) flags the two thresholds sets flip.

    python tools/threshold_compare.py [--artifacts artifacts] [--per-fault 10]
        [--device cuda] [--save out.json] [--set KEY=VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from golfaction_tpu_torch import config as cfg_mod  # noqa: E402
from golfaction_tpu_torch.calibrate_thresholds import calibration_probs  # noqa: E402
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline  # noqa: E402
from golfaction_tpu_torch.train import metrics  # noqa: E402

FLOAT32 = [f"{m}.dtype=float32" for m in ("pose", "gcn", "align", "error", "refine")]


def f1_at(p: np.ndarray, t: np.ndarray, thr: float) -> float:
    """calibrate_error_thresholds' F1 of one fault at one threshold."""
    pred = p > thr
    tp = float((pred & (t > 0)).sum())
    fp = float((pred & (t == 0)).sum())
    fn = float((~pred & (t > 0)).sum())
    return 2 * tp / max(2 * tp + fp + fn, 1e-9)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--per-fault", type=int, default=10)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--hw", type=int, nargs=2, default=(540, 960))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override of both runs (repeatable)")
    args = ap.parse_args(argv)
    with open(os.path.join(args.artifacts, "error_thresholds.json")) as f:
        shipped = json.load(f)
    T, hw = args.frames, tuple(args.hw)
    runs = {}
    for name, ov in (("bfloat16", []), ("float32", FLOAT32)):
        pipe = Pipeline.from_artifacts(args.artifacts, device=args.device,
                                       overrides=[f"video_hw={hw}", f"length_buckets=({T},)",
                                                  *args.set, *ov])
        probs, truth = calibration_probs(pipe, args.per_fault, T, hw, log=lambda m: None)
        runs[name] = {"probs": probs, "truth": truth,
                      "thr": metrics.calibrate_error_thresholds(probs, truth)}
        del pipe
    per_fault = {}
    for e, fault in enumerate(cfg_mod.SWING_ERRORS):
        row = {"shipped": shipped[fault], "positives": int(runs["float32"]["truth"][:, e].sum())}
        for name, r in runs.items():
            p, t, thr = r["probs"][:, e], r["truth"][:, e], r["thr"][fault]
            row[name] = {"thr": thr, "f1": round(f1_at(p, t, thr), 4),
                         "f1_at_shipped": round(f1_at(p, t, shipped[fault]), 4),
                         "near_thr": int((np.abs(p - thr) < 0.05).sum())}
        per_fault[fault] = row
    pb, pf = runs["bfloat16"]["probs"], runs["float32"]["probs"]
    thr_b = np.array([runs["bfloat16"]["thr"][k] for k in cfg_mod.SWING_ERRORS])
    thr_f = np.array([runs["float32"]["thr"][k] for k in cfg_mod.SWING_ERRORS])
    out = {"clips": int(len(pf) // 2), "rows": int(len(pf)), "per_fault": per_fault,
           "equal_to_shipped": {n: sum(abs(r["thr"][k] - shipped[k]) < 1e-9 for k in shipped)
                                for n, r in runs.items()},
           "dtype_gap": {"max_abs_prob": float(np.abs(pb - pf).max()),
                         "mean_abs_prob": float(np.abs(pb - pf).mean()),
                         "flags_flipped_own_thresholds": int(((pb > thr_b)
                                                              != (pf > thr_f)).sum()),
                         "flags_flipped_float32_thresholds": int(((pb > thr_f)
                                                                  != (pf > thr_f)).sum())},
           "device": args.device}
    if args.save:
        with open(args.save, "w") as f:
            json.dump({**out, "probs": {n: r["probs"].tolist() for n, r in runs.items()},
                       "truth": runs["float32"]["truth"].tolist()}, f)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
