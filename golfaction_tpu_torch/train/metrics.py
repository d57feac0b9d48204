"""Evaluation metrics: PCK@alpha, swing-phase F1/accuracy/confusion,
alignment error along a DTW path, fault-detection precision/recall/F1 and
per-fault threshold calibration."""

from __future__ import annotations

import numpy as np
import torch

from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.types import to_numpy


def pck(pred_kpts, gt_kpts, bbox_size, alpha: float = 0.05, mask=None):
    """Percentage of Correct Keypoints at alpha * bbox_size.

    pred/gt [..., V, >=2] in the same pixel space; bbox_size [...] the
    normalization length (e.g. max(w, h) of the person box).
    """
    d = torch.linalg.norm(pred_kpts[..., :2].float() - gt_kpts[..., :2].float(), dim=-1)
    correct = (d <= (alpha * bbox_size)[..., None]).float()
    if mask is not None:
        m = mask.float()
        return (correct * m).sum() / m.sum().clamp(min=1.0)
    return correct.mean()


def phase_accuracy(pred_labels, gt_labels, valid=None):
    ok = (pred_labels == gt_labels).float()
    if valid is not None:
        v = valid.float()
        return (ok * v).sum() / v.sum().clamp(min=1.0)
    return ok.mean()


def phase_f1(pred_labels, gt_labels, num_classes: int, valid=None):
    """Macro-F1 over phase classes (classes absent from both pred and gt are
    excluded from the macro average)."""
    v = torch.ones_like(gt_labels, dtype=torch.bool) if valid is None else valid
    f1s, present = [], []
    for c in range(num_classes):
        p = (pred_labels == c) & v
        g = (gt_labels == c) & v
        tp = (p & g).sum().float()
        fp = (p & ~g).sum().float()
        fn = (~p & g).sum().float()
        f1s.append(2 * tp / (2 * tp + fp + fn).clamp(min=1e-9))
        present.append((tp + fn + fp) > 0)
    f1s = torch.stack(f1s)
    present = torch.stack(present).float()
    return (f1s * present).sum() / present.sum().clamp(min=1.0)


def phase_confusion(pred_labels, gt_labels, num_classes: int, valid=None):
    """Confusion matrix [P, P] (rows = ground truth)."""
    idx = gt_labels.long() * num_classes + pred_labels.long()
    if valid is not None:
        idx = torch.where(valid, idx, num_classes * num_classes)
    counts = torch.bincount(idx.reshape(-1), minlength=num_classes * num_classes + 1)
    return counts[:num_classes * num_classes].reshape(num_classes, num_classes)


def alignment_progress_error(path, path_length, progress_a, progress_b):
    """Mean |progress_a[i] - progress_b[j]| along a DTW path [L, 2] (-1
    padded beyond path_length): how well the alignment recovers the true
    time correspondence of two swings."""
    L = path.shape[0]
    m = (torch.arange(L, device=path.device) < path_length).float()
    i = path[:, 0].long().clamp(0, progress_a.shape[0] - 1)
    j = path[:, 1].long().clamp(0, progress_b.shape[0] - 1)
    err = (progress_a[i] - progress_b[j]).abs() * m
    return err.sum() / m.sum().clamp(min=1.0)


def error_detection_metrics(probs, flags, threshold: float = 0.5):
    """Multi-label precision/recall/F1 (micro) for fault flags [B, E]."""
    pred = probs > threshold
    gt = flags > 0.5
    tp = (pred & gt).sum().float()
    fp = (pred & ~gt).sum().float()
    fn = (~pred & gt).sum().float()
    precision = tp / (tp + fp).clamp(min=1e-9)
    recall = tp / (tp + fn).clamp(min=1e-9)
    f1 = 2 * precision * recall / (precision + recall).clamp(min=1e-9)
    return {"precision": precision, "recall": recall, "f1": f1}


def error_detection_per_fault(probs, flags, threshold=0.5):
    """Per-fault precision/recall/F1 breakdown.  threshold: scalar or [E]
    per-fault array.  Returns {fault_name: {precision, recall, f1, support}}."""
    probs = to_numpy(probs)
    flags = to_numpy(flags) > 0.5
    thr = np.broadcast_to(np.asarray(to_numpy(threshold), np.float32), (probs.shape[-1],))
    out = {}
    for e, name in enumerate(cfg_mod.SWING_ERRORS):
        pred = probs[:, e] > thr[e]
        gt = flags[:, e]
        tp = float((pred & gt).sum())
        fp = float((pred & ~gt).sum())
        fn = float((~pred & gt).sum())
        p = tp / max(tp + fp, 1e-9)
        r = tp / max(tp + fn, 1e-9)
        out[name] = {
            "precision": round(p, 4), "recall": round(r, 4),
            "f1": round(2 * p * r / max(p + r, 1e-9), 4),
            "support": int(gt.sum()),
        }
    return out


def calibrate_error_thresholds(probs, truth, log=None):
    """Per-fault decision thresholds maximizing F1 on pooled probabilities.

    probs/truth: [N, E] (probabilities / 0-1 flags).  Returns
    {fault_name: threshold}.  The grid is floored at 0.2 — tiny thresholds
    flag everything and win calibration F1 through recall while collapsing
    held-out precision — and ties break toward the HIGHER threshold
    (precision bias).
    """
    probs = to_numpy(probs)
    truth = to_numpy(truth)
    grid = np.linspace(0.20, 0.90, 15)
    thresholds = {}
    for e, fault in enumerate(cfg_mod.SWING_ERRORS):
        best_thr, best_f1 = 0.5, -1.0
        for thr in grid:
            p = probs[:, e] > thr
            tp = float((p & (truth[:, e] > 0)).sum())
            fp = float((p & (truth[:, e] == 0)).sum())
            fn = float((~p & (truth[:, e] > 0)).sum())
            f1 = 2 * tp / max(2 * tp + fp + fn, 1e-9)
            if f1 > best_f1 + 1e-9 or (abs(f1 - best_f1) <= 1e-9 and thr > best_thr):
                best_thr, best_f1 = float(thr), f1
        thresholds[fault] = best_thr
        if log is not None:
            log(f"   {fault:16s} thr={best_thr:.2f} calib-F1={best_f1:.2f}")
    return thresholds
