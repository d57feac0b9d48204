"""What decides `correct`: the outputs of requests from the timed window,
held to the plain reference (benchmark/reference) stage by stage.

  pose     the reference computes keypoints and aux from the same frames and
           boxes:  kpt_p50_px    median keypoint gap, px, valid (frame, joint)
                   kpt_far_share share of valid (frame, joint) whose keypoint
                                 is off by > 2 px or its score by > 0.02
                   aux_p50_px    median gap of the secondary-mode features:
                                 the largest of |dx|, |dy|, |sep| (px) and
                                 10 |mass ratio| (0 without mode features,
                                 inf for aux where the configuration has none
                                 or none where it has them)
  heads    the reference GCN and error head run on the system's keypoints
           and aux:  phase_logit_gap  largest |logit gap| / max(1, largest |logit|)
                     label_mismatches labels unlike the argmax of the
                                      system's (so judged) logits on valid
                                      frames, or other than -1 on padding
  compare  the reference encoder and DTW run on the system's keypoints and
           reference skeleton:  cost_rel_gap     |cost gap| / |cost|
                                path_cost_gap    the system's path's cost in
                                                 the reference's hard-DTW
                                                 table over the optimum, less
                                                 1 (inf for no valid path)
                                error_logit_gap  refined error logits, with
                                                 the reference warped along
                                                 the system's path
                                flag_mismatches  flags unlike sigmoid(logit)
                                                 > the stated thresholds
Each is the worst over the checked requests; the pose numbers also cover
the reference swing's own analysis.  Limits come from the configuration file.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import align

FAR_PX, FAR_SCORE = 2.0, 0.02
NUMBERS = ("kpt_p50_px", "kpt_far_share", "aux_p50_px", "phase_logit_gap", "label_mismatches",
           "cost_rel_gap", "path_cost_gap", "error_logit_gap", "flag_mismatches")


def pose_numbers(kp, aux, rkp, raux, valid) -> dict:
    """kp, rkp [N, T, V, 3]; aux, raux [N, T, V, 4] or None; valid [N, T]."""
    v = valid.bool()
    dxy = torch.linalg.norm(kp[..., :2].float() - rkp[..., :2].float(), dim=-1)[v]
    far = (dxy > FAR_PX) | ((kp[..., 2].float() - rkp[..., 2].float()).abs()[v] > FAR_SCORE)
    aux_gap = 0.0
    if (raux is None) != (aux is None):
        aux_gap = math.inf                # aux where the configuration has none, or none
    elif raux is not None:
        da = (aux.float() - raux.float()).abs()[v]
        da[..., 2] *= 10.0
        aux_gap = float(da.max(-1).values.median())
    return {"kpt_p50_px": float(dxy.median()), "kpt_far_share": float(far.float().mean()),
            "aux_p50_px": aux_gap}


def heads_numbers(out: dict, r_logits, valid) -> dict:
    v = valid.bool()
    p = out["phase_logits"].float()
    gap = float((p - r_logits).abs()[v].max()) / max(1.0, float(r_logits.abs()[v].max()))
    want = torch.where(v, p.argmax(-1), -1)
    return {"phase_logit_gap": gap,
            "label_mismatches": float((out["phase_labels"].long() != want).sum())}


def compare_numbers(out: dict, stage, r_err, thresholds) -> dict:
    """stage: Reference.compare's (D, cost, hard table, la, lb) on the system's keypoints."""
    D, cost, hard, la, lb = stage
    c = out["cost"].double()
    cost_gap = float(((c - cost.double()).abs() / cost.double().abs().clamp(min=1e-6)).max())
    pc, ok = align.path_cost(D, out["path"], out["path_length"], la, lb)
    idx = torch.arange(D.shape[0], device=D.device)
    best = hard[idx, la - 1, lb - 1].double()
    rel = pc / best.clamp(min=1e-6) - 1.0
    path_gap = float(rel.max()) if bool(ok.all()) else math.inf
    err = out["error_logits"].float()
    flags = torch.sigmoid(err) > thresholds
    return {"cost_rel_gap": cost_gap, "path_cost_gap": path_gap,
            "error_logit_gap": float((err - r_err).abs().max()),
            "flag_mismatches": float((flags != out["error_flags"].bool()).sum())}


def judge(reference, items: list, ref_swing: dict, thresholds) -> dict:
    """items: [(frames, boxes, valid, [outputs of each request of this input])];
    ref_swing: {"frames", "boxes", "valid", "keypoints", "kpt_aux"} of the
    system's reference-swing analysis.  -> {number: worst value}."""
    worst = {k: 0.0 for k in NUMBERS}

    def take(d):
        for k, x in d.items():
            worst[k] = x if (math.isnan(x) or math.isnan(worst[k])) else max(worst[k], x)

    rs = ref_swing
    rkp, raux = reference.pose(rs["frames"], rs["boxes"])
    take(pose_numbers(rs["keypoints"], rs["kpt_aux"], rkp, raux, rs["valid"]))
    ref = (rs["keypoints"][0], rs["valid"][0])
    for frames, boxes, valid, outs in items:
        rkp, raux = reference.pose(frames, boxes)
        for out in outs:
            take(pose_numbers(out["keypoints"], out["kpt_aux"], rkp, raux, valid))
            r_logits, _ = reference.heads(out["keypoints"], out["kpt_aux"], valid)
            take(heads_numbers(out, r_logits, valid))
            stage = reference.compare(out["keypoints"], valid, ref[0], ref[1])
            r_err = reference.refined_error(out["keypoints"], out["phase_logits"], valid, ref[0],
                                            out["path"], out["path_length"], out["kpt_aux"])
            take(compare_numbers(out, stage, r_err, thresholds))
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": numbers[k], "limit": limits.get(k)} for k in NUMBERS}
    ok = all(v["limit"] is not None and math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in shown.values())
    return ok, shown


def backtrack(hard: torch.Tensor, la, lb):
    """Hard-DTW paths from (la-1, lb-1) back to (0, 0) over tables [N, T, Tr]:
    ties go to the diagonal, then up, then left.  -> (path [N, T+Tr-1, 2]
    int32 padded with -1, length [N] int32)."""
    R = hard.double().cpu().numpy()
    N, Ta, Tb = R.shape
    L = Ta + Tb - 1
    path = np.full((N, L, 2), -1, np.int32)
    length = np.zeros(N, np.int32)
    for n in range(N):
        i, j = int(la[n]) - 1, int(lb[n]) - 1
        steps = [(i, j)]
        while (i, j) != (0, 0):
            opts = []
            if i > 0 and j > 0:
                opts.append((R[n, i - 1, j - 1], 0, (i - 1, j - 1)))
            if i > 0:
                opts.append((R[n, i - 1, j], 1, (i - 1, j)))
            if j > 0:
                opts.append((R[n, i, j - 1], 2, (i, j - 1)))
            i, j = min(opts)[2]
            steps.append((i, j))
        steps.reverse()
        path[n, :len(steps)] = steps
        length[n] = len(steps)
    dev = hard.device
    return torch.from_numpy(path).to(dev), torch.from_numpy(length).to(dev)


def control_request(low, frames, boxes, valid, ref, thresholds) -> dict:
    """The reference at the control's precision in the system's place: the
    outputs of one request, keyed as `system.request` keys them."""
    kpts, aux = low.pose(frames, boxes)
    logits, _ = low.heads(kpts, aux, valid)
    labels = torch.where(valid, logits.argmax(-1), -1).to(torch.int32)
    D, cost, hard, la, lb = low.compare(kpts, valid, ref[0], ref[1])
    path, length = backtrack(hard, la, lb)
    err = low.refined_error(kpts, logits, valid, ref[0], path, length, aux)
    return {"keypoints": kpts, "kpt_aux": aux, "phase_logits": logits, "phase_labels": labels,
            "error_logits": err, "error_flags": torch.sigmoid(err) > thresholds, "cost": cost,
            "path": path, "path_length": length}
