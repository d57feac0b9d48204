"""Is the true (deflected) joint location still present as a heatmap mode?
The port's counterpart of the JAX package's `scripts/probe_heatmap_modes.py`,
with its flags, seeds and output: one fault's `{"summary": ..., "frames":
[...]}` (the repo's `artifacts/probe_heatmap_modes.json` is a hand-merged
`{"faults": {...}}` of several such runs; the cascade reads both forms).

For paired (fault, clean-twin) clips it runs the pose front up to the raw
heatmaps (`Pipeline._pose_heatmaps`: the coarse full-frame pass and refined
boxes when the config asks for them, crops through kernel A, the pose net),
takes the fault joint's heatmaps on frames where the true deflection is at
least `--min-defl-px`, finds the top-K local maxima (greedy peak, 3 px
suppression) and reports, per frame, each mode's distance to the TRUE and
the CANONICAL location in heatmap px.  Unimodal at the canonical spot: the
network never represents the deflection; bimodal: the information survives
the backbone and is lost at the single-peak decode.  The weights come from
the tree's `params/*.npz` (an Orbax step folder is refused).

    python -m golfaction_tpu_torch.probe_heatmap_modes --fault chicken_wing --pairs 4
        --out <file> [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from golfaction_tpu_torch import checkpoint
from golfaction_tpu_torch._probe_common import (FAULT_JOINTS, add_common_args, heatmaps_of, log,
                                                pair_seed, probe_pipeline, render_pair)
from golfaction_tpu_torch.ops import heatmap


def topk_modes(hm: np.ndarray, k: int = 5, suppress_px: float = 3.0):
    """Greedy non-max-suppressed local maxima of one [H, W] heatmap:
    [(x, y, value)] in order, stopping at a value <= 0."""
    h = hm.astype(np.float64).copy()
    H, W = h.shape
    ys, xs = np.mgrid[0:H, 0:W]
    modes = []
    for _ in range(k):
        idx = int(np.argmax(h))
        y, x = divmod(idx, W)
        v = float(h[y, x])
        if v <= 0:
            break
        modes.append((float(x), float(y), v))
        h[(ys - y) ** 2 + (xs - x) ** 2 <= suppress_px ** 2] = 0.0
    return modes


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--fault", default="chicken_wing")
    ap.add_argument("--severity", type=float, default=1.0)
    ap.add_argument("--min-defl-px", type=float, default=8.0)
    return ap.parse_args(argv)


def gt_heatmap_px(kpts: np.ndarray, boxes: torch.Tensor, pose_cfg) -> np.ndarray:
    """Ground-truth image keypoints [T, V, 3] -> heatmap px of the crops
    taken with the center-scale boxes [T, 4]."""
    return heatmap.image_keypoints_to_heatmap(
        torch.from_numpy(np.ascontiguousarray(kpts)).to(boxes.device), boxes,
        pose_cfg.heatmap_hw, pose_cfg.input_hw).float().cpu().numpy()


def frame_records(pair: int, hm: np.ndarray, gt_true: np.ndarray, gt_canon: np.ndarray,
                  true_d: np.ndarray, joints, min_defl_px: float) -> list:
    """One pair's per-frame records: heatmaps [T, V, Hh, Wh], the true and
    canonical positions in heatmap px [T, V, >=2], the true deflection in
    image px [T, V, 2]."""
    out = []
    for j in joints:
        mask = np.linalg.norm(true_d[:, j], axis=-1) >= min_defl_px
        for t in np.nonzero(mask)[0]:
            modes = topk_modes(hm[t, j])
            if not modes:
                continue
            tx, ty = gt_true[t, j, :2]
            cx, cy = gt_canon[t, j, :2]
            d_true = [float(np.hypot(m[0] - tx, m[1] - ty)) for m in modes]
            d_canon = [float(np.hypot(m[0] - cx, m[1] - cy)) for m in modes]
            best = int(np.argmin(d_true))
            out.append({
                "pair": pair, "frame": int(t), "joint": int(j),
                "true_defl_img_px": round(float(np.linalg.norm(true_d[t, j])), 1),
                "sep_hm_px": round(float(np.hypot(tx - cx, ty - cy)), 2),
                "peak_d_true": round(d_true[0], 2),
                "peak_d_canon": round(d_canon[0], 2),
                "best_mode_d_true": round(d_true[best], 2),
                "best_mode_rank": best,
                "best_mode_rel_mass": round(modes[best][2] / modes[0][2], 3),
                "n_modes": len(modes),
            })
    return out


def summarize(fault: str, per_frame: list) -> dict:
    """The JAX script's summary of the per-frame records (the shares over
    frames whose true and canonical spots lie >= 2 heatmap px apart)."""
    sep = np.array([f["sep_hm_px"] for f in per_frame])
    well = sep >= 2.0
    bt = np.array([f["best_mode_d_true"] for f in per_frame])
    pt = np.array([f["peak_d_true"] for f in per_frame])
    pc = np.array([f["peak_d_canon"] for f in per_frame])
    if not well.any():
        none = dict.fromkeys(("peak_nearer_canon_frac", "true_mode_present_frac",
                              "median_peak_d_true", "median_best_mode_d_true",
                              "median_best_mode_rel_mass"))
        return {"fault": fault, "frames": len(per_frame), "frames_well_separated": 0, **none}
    return {
        "fault": fault,
        "frames": len(per_frame),
        "frames_well_separated": int(well.sum()),
        # the peak nearer the canonical spot than the true one: the prior dominates
        "peak_nearer_canon_frac": round(float(np.mean(pc[well] < pt[well])), 3),
        # some mode within 2 heatmap px of the true spot: recoverable
        "true_mode_present_frac": round(float(np.mean(bt[well] <= 2.0)), 3),
        "median_peak_d_true": round(float(np.median(pt[well])), 2),
        "median_best_mode_d_true": round(float(np.median(bt[well])), 2),
        "median_best_mode_rel_mass": round(float(np.median(
            [f["best_mode_rel_mass"] for f, w in zip(per_frame, well) if w])), 3),
    }


def main(argv=None) -> dict | None:
    """Run the probe, write --out, print the summary; returns {"summary",
    "frames"}, or None (nothing written) when no frame passes the deflection
    threshold, as the JAX script does."""
    args = parse_args(argv)
    checkpoint.refuse_inside(args.out)
    pipe = probe_pipeline(args)
    c = pipe.cfg
    joints = FAULT_JOINTS[args.fault]
    per_frame = []
    for p in range(args.pairs):
        faulty, clean = render_pair(args.fault, args.severity,
                                    pair_seed(args.seed, p, args.fault), args.frames,
                                    tuple(args.hw))
        hm, boxes = heatmaps_of(pipe, faulty.frames)
        true_d = faulty.keypoints[..., :2] - clean.keypoints[..., :2]
        recs = frame_records(p, hm.float().cpu().numpy(),
                             gt_heatmap_px(faulty.keypoints, boxes, c.pose),
                             gt_heatmap_px(clean.keypoints, boxes, c.pose), true_d, joints,
                             args.min_defl_px)
        per_frame += recs
        log(f"pair {p}: {len(recs)} faulted frames analyzed")
    if not per_frame:
        log("no frames above deflection threshold")
        return None
    summary = summarize(args.fault, per_frame)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "frames": per_frame}, f, indent=1)
    log(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return {"summary": summary, "frames": per_frame}


if __name__ == "__main__":
    main()
