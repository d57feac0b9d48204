"""Swing analysis report: the coach-facing summary of an AnalysisResult.

Phase timing, tempo, detected faults and the comparison against a reference
swing, derived on the host from what `analyze` returns (tensors on any
device or numpy arrays).  The dicts and strings equal the JAX package's
`pipeline/report.py` on the same inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.types import to_numpy

# Swing tempo is conventionally backswing:downswing time; ~3:1 is the
# classic target for full swings.
_BACKSWING = {"takeaway", "backswing", "top"}
_DOWNSWING = {"downswing", "impact"}

_FAULT_DESCRIPTIONS = {
    "swaying": "hips slide laterally during the backswing instead of turning",
    "hanging_back": "weight stays on the trail side through impact",
    "early_extension": "hips thrust toward the ball in the downswing",
    "over_the_top": "downswing plane comes over the backswing plane",
    "casting": "wrist angle releases too early in the downswing",
    "reverse_spine": "upper body tilts toward the target at the top",
    "chicken_wing": "lead elbow breaks down after impact",
    "head_movement": "head drifts noticeably during the swing",
}


def phase_segments(labels: np.ndarray, fps: float = 30.0) -> list[dict]:
    """Contiguous phase runs -> [{phase, start_frame, end_frame, seconds}]."""
    labels = to_numpy(labels)
    segs = []
    start = 0
    for i in range(1, len(labels) + 1):
        if i == len(labels) or labels[i] != labels[start]:
            lab = int(labels[start])
            if lab >= 0:
                segs.append({
                    "phase": cfg_mod.SWING_PHASES[lab],
                    "start_frame": int(start),
                    "end_frame": int(i - 1),
                    "seconds": round((i - start) / fps, 3),
                })
            start = i
    return segs


def tempo_ratio(segs: list[dict]) -> Optional[float]:
    back = sum(s["seconds"] for s in segs if s["phase"] in _BACKSWING)
    down = sum(s["seconds"] for s in segs if s["phase"] in _DOWNSWING)
    if down <= 0:
        return None
    return round(back / down, 2)


def build_report(
    result,
    fps: float = 30.0,
    error_threshold=0.5,
    reference_name: str = "reference swing",
) -> dict:
    """AnalysisResult -> structured report dict (JSON-safe).

    ``error_threshold`` is a scalar or a per-fault array of length
    ``len(SWING_ERRORS)`` (e.g. calibrated thresholds from
    ``checkpoint.load_error_thresholds``); the report's fault list then
    agrees with ``result.error_flags`` computed from the same thresholds.
    """
    valid = to_numpy(result.valid)
    T = int(valid.sum())
    labels = to_numpy(result.phase_labels)[:T]
    probs = to_numpy(result.error_probs)
    thr = np.broadcast_to(to_numpy(error_threshold).astype(np.float32), probs.shape)

    segs = phase_segments(labels, fps)
    ratio = tempo_ratio(segs)

    faults = []
    for name, p, t in zip(cfg_mod.SWING_ERRORS, probs, thr):
        if p > t:
            faults.append({
                "fault": name,
                "confidence": round(float(p), 3),
                "description": _FAULT_DESCRIPTIONS[name],
            })
    faults.sort(key=lambda f: -f["confidence"])

    report = {
        "frames": T,
        "duration_s": round(T / fps, 2),
        "phases": segs,
        "tempo_ratio": ratio,
        "tempo_note": (
            None if ratio is None else
            f"backswing:downswing = {ratio}:1 "
            + ("(close to the classic 3:1)" if 2.5 <= ratio <= 3.5 else
               "(slower than 3:1 — smooth but long)" if ratio > 3.5 else
               "(quicker than 3:1 — rushed transition)")
        ),
        "faults": faults,
        "fault_probabilities": {
            n: round(float(p), 3)
            for n, p in zip(cfg_mod.SWING_ERRORS, probs)
        },
    }

    if result.alignment is not None:
        L = int(result.alignment.path_length)
        path = to_numpy(result.alignment.path)[:L]
        # Where does this swing run ahead/behind the reference?
        drift = path[:, 0] - path[:, 1]
        report["comparison"] = {
            "against": reference_name,
            "alignment_cost": round(float(result.alignment.cost), 4),
            "max_lag_frames": int(drift.max()),
            "max_lead_frames": int(-drift.min()),
            "pacing_note": (
                "paces evenly with the reference" if abs(drift).max() <= 3
                else "falls behind the reference mid-swing"
                if drift.max() > -drift.min()
                else "runs ahead of the reference mid-swing"
            ),
        }
    return report


def format_report(report: dict) -> str:
    """Render the report dict as readable text."""
    lines = [
        f"Swing analysis — {report['frames']} frames "
        f"({report['duration_s']} s)",
        "",
        "Phases:",
    ]
    for s in report["phases"]:
        lines.append(
            f"  {s['phase']:>15}: frames {s['start_frame']:3d}-{s['end_frame']:3d}"
            f"  ({s['seconds']} s)"
        )
    if report.get("tempo_note"):
        lines += ["", f"Tempo: {report['tempo_note']}"]
    lines.append("")
    if report["faults"]:
        lines.append("Detected faults:")
        for f in report["faults"]:
            lines.append(
                f"  [{f['confidence']:.0%}] {f['fault']}: {f['description']}"
            )
    else:
        lines.append("No faults detected above threshold.")
    cmp_ = report.get("comparison")
    if cmp_:
        lines += [
            "",
            f"Vs {cmp_['against']}: alignment cost {cmp_['alignment_cost']}, "
            f"{cmp_['pacing_note']} "
            f"(lag {cmp_['max_lag_frames']}f / lead {cmp_['max_lead_frames']}f)",
        ]
    return "\n".join(lines)
