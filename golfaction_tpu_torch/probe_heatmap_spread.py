"""Can heatmap second moments recover the attenuated fault deflection?  The
port's counterpart of the JAX package's `scripts/probe_heatmap_spread.py`,
with its flags, seeds and JSON layout (`{severity, pairs, hw, radius,
faults}`, the layout the cascade's `load_spread_profile` reads).

When the canonical-prior and true modes sit closer than two sigma they
merge into one elongated blob: the decoded mean moves only w·d, but the
variance along the separation axis reads sigma² + w(1-w)d².  For paired
(fault, clean-twin) clips, on frames where the true deflection is at least
`--min-defl-px`, per affected joint:

  dev      the predicted deflection projected on the true direction u;
  excess   sqrt(max(u'Σu − (sigma·s)², 0)) in image px, Σ the windowed
           heatmap covariance mapped to image space, sigma·s the training
           target's spread;
  excess_c the same on the clean twin's frame (the false-signal floor).

Reports per fault the dev-only gain, leave-one-pair-out gains of a·dev and
of a·dev + b·excess (no intercept), the fault/clean excess separability
(AUC) and the spread-transfer coefficient beta.  The heatmaps come from
`Pipeline._pose_heatmaps` (crops through kernel A), the keypoints from its
single-peak UDP decode (kernel D on the card).  The weights come from the
tree's `params/*.npz` (an Orbax step folder is refused).

    python -m golfaction_tpu_torch.probe_heatmap_spread --pairs 4 --out <file>
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from golfaction_tpu_torch import checkpoint
from golfaction_tpu_torch._probe_common import (ARM_FAULTS, FAULT_JOINTS, add_common_args,
                                                heatmaps_of, log, pair_seed, probe_pipeline,
                                                render_pair)
from golfaction_tpu_torch.ops import heatmap


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--faults", nargs="*", default=list(ARM_FAULTS))
    ap.add_argument("--min-defl-px", type=float, default=8.0)
    ap.add_argument("--radius", type=float, default=8.0)
    return ap.parse_args(argv)


def clip_stats(hm, boxes, pose_cfg, radius: float):
    """Heatmaps [T, V, Hh, Wh] and their center-scale boxes [T, 4] ->
    (keypoints in image px [T, V, 3] by single-peak UDP decode, windowed
    moments [T, V, 5], image px per heatmap px [T]) as numpy."""
    kpt = heatmap.keypoints_to_image(heatmap.decode_heatmaps(hm, method="udp"), boxes,
                                     pose_cfg.heatmap_hw, pose_cfg.input_hw)
    mom = heatmap.moment_stats(hm, radius=radius)
    scale = boxes[:, 3] / pose_cfg.heatmap_hw[0]
    return tuple(a.float().cpu().numpy() for a in (kpt, mom, scale))


def pair_rows(p: int, fault_stats, clean_stats, true_d: np.ndarray, joints,
              min_defl_px: float, sigma0: float) -> list:
    """One pair's rows (pair, |true defl|, dev, excess_fault, excess_clean)."""
    kp_f, mom_f, sc_f = fault_stats
    kp_c, mom_c, sc_c = clean_stats
    rows = []
    for j in joints:
        mag = np.linalg.norm(true_d[:, j], axis=-1)
        for t in np.nonzero(mag >= min_defl_px)[0]:
            u = true_d[t, j] / mag[t]
            dev = float((kp_f[t, j, :2] - kp_c[t, j, :2]) @ u)

            def excess(mom, sc):
                _, _, cxx, cxy, cyy = mom[t, j]
                var_u = sc[t] ** 2 * (u[0] * u[0] * cxx + 2 * u[0] * u[1] * cxy
                                      + u[1] * u[1] * cyy)
                return float(np.sqrt(max(var_u - (sigma0 * sc[t]) ** 2, 0.0)))

            rows.append((p, float(mag[t]), dev, excess(mom_f, sc_f), excess(mom_c, sc_c)))
    return rows


def fault_entry(rows: list, joints, pairs: int) -> dict:
    """The JAX script's per-fault entry from all pairs' rows."""
    if not rows:
        return {"rows": 0}
    arr = np.asarray(rows, np.float64)
    tgt, dev, exf, exc = arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4]
    gain_dev = float((dev @ tgt) / (tgt @ tgt))

    def lopo_gain(cols):
        """Fit s_hat = X coef on the other pairs (no intercept), gain on the
        held-out pair, summed over pairs."""
        num = den = 0.0
        X = np.stack(cols, 1)
        for p in range(pairs):
            tr, te = arr[:, 0] != p, arr[:, 0] == p
            if not te.any() or tr.sum() < 4:
                continue
            coef, *_ = np.linalg.lstsq(X[tr], tgt[tr], rcond=None)
            s_hat = X[te] @ coef
            num += float(s_hat @ tgt[te])
            den += float(tgt[te] @ tgt[te])
        return float(num / max(den, 1e-9))

    # How much of the mixture model's excess variance (g(1-g)d², with g·d
    # the decoded dev) the real heatmaps deliver; the cascade scales its
    # synthetic spread by it.
    denom = float(np.mean(np.maximum(dev * (tgt - dev), 0.0)))
    beta = float(np.clip((np.mean(exf ** 2) - np.mean(exc ** 2)) / max(denom, 1e-6), 0.0, 1.5))
    return {
        "rows": len(rows),
        "beta": round(beta, 3),
        "per_joint_beta": {str(j): round(beta, 3) for j in joints},
        "gain_dev_only": round(gain_dev, 3),
        "gain_dev_lopo": round(lopo_gain([dev]), 3),
        "gain_combo_lopo": round(lopo_gain([dev, exf]), 3),
        "excess_auc_vs_twin": round(float(np.mean(exf > exc)), 3),
        "median_excess_fault_px": round(float(np.median(exf)), 2),
        "median_excess_clean_px": round(float(np.median(exc)), 2),
        "median_true_defl_px": round(float(np.median(tgt)), 1),
    }


def main(argv=None) -> dict:
    """Run the probe, write --out, print the JAX script's last line (each
    fault's combo gain); returns the report."""
    args = parse_args(argv)
    checkpoint.refuse_inside(args.out)
    pipe = probe_pipeline(args)
    c = pipe.cfg
    hw, T = tuple(args.hw), args.frames
    report = {"severity": "varied 0.4-1.15", "pairs": args.pairs, "hw": list(hw),
              "radius": args.radius, "faults": {}}
    for fault in args.faults:
        joints = FAULT_JOINTS[fault]
        rows = []
        for p in range(args.pairs):
            # The severity varies over the pairs: at one severity any fit
            # predicts the mean magnitude.
            sev = 0.4 + 0.75 * p / max(args.pairs - 1, 1)
            s_fault, s_clean = render_pair(fault, sev, pair_seed(args.seed, p, fault), T, hw)
            stats = [clip_stats(*heatmaps_of(pipe, s.frames), c.pose, args.radius)
                     for s in (s_fault, s_clean)]
            true_d = s_fault.keypoints[:T, :, :2] - s_clean.keypoints[:T, :, :2]
            rows += pair_rows(p, *stats, true_d, joints, args.min_defl_px, c.pose.sigma)
            log(f"[{fault}] pair {p}: {len(rows)} rows so far")
        entry = fault_entry(rows, joints, args.pairs)
        report["faults"][fault] = entry
        if rows:
            log(f"[{fault:14s}] dev-gain {entry['gain_dev_only']:+.3f}  combo-gain "
                f"{entry['gain_combo_lopo']:+.3f}  AUC {entry['excess_auc_vs_twin']:.3f}  "
                f"excess f/c {entry['median_excess_fault_px']}/"
                f"{entry['median_excess_clean_px']} px")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({f: report["faults"][f].get("gain_combo_lopo") for f in args.faults}))
    return report


if __name__ == "__main__":
    main()
