"""Swing-error detection classifier.

Per-frame features of the clip-normalized, temporally smoothed skeleton
(joint positions, velocities, joint angles and their velocities, optional
deviations from a DTW-aligned reference swing, optional secondary-heatmap-
mode or heatmap-spread features) are pooled per swing phase with the phase posteriors as soft
weights, then an MLP emits one logit per fault (multi-label).  The features
are float32; the MLP and the pooling compute at `ErrorConfig.dtype`
(models/precision.py) and the last layer in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from golfaction_tpu_torch.config import ErrorConfig
from golfaction_tpu_torch.models.gcn import LayerNorm, normalize_skeleton_clip
from golfaction_tpu_torch.models.precision import compute_dtype, linear

# Angle triplets (a, vertex, b) over COCO-17 joints: elbows, knees,
# shoulder and hip hinges on both sides.
_ANGLE_TRIPLETS = (
    (5, 7, 9), (6, 8, 10),      # elbows
    (11, 13, 15), (12, 14, 16),  # knees
    (7, 5, 11), (8, 6, 12),     # shoulders (arm vs torso)
    (5, 11, 13), (6, 12, 14),   # hip hinges
)
NUM_ANGLE_FEATURES = 2 * len(_ANGLE_TRIPLETS) + 3  # cos/sin + spine + head


def feature_dim(cfg: ErrorConfig) -> int:
    """Width of the per-frame feature vector (the first Dense's input)."""
    V = cfg.num_joints
    d = 2 * V + 2 * V + 2 * NUM_ANGLE_FEATURES + 3 * V + 1
    if cfg.mode_features:
        d += 3 * V
    if cfg.spread_features:
        d += 2 * V
    return d


def _smooth_time(x: torch.Tensor, valid=None) -> torch.Tensor:
    """Binomial [1,2,1]/4 filter along axis 1 (edge-replicated); with
    `valid` [B, T] mask-normalized so padded frames never leak into valid
    ones, and invalid frames pass through."""

    def conv(z):
        pad = torch.cat([z[:, :1], z, z[:, -1:]], dim=1)
        return 0.25 * pad[:, :-2] + 0.5 * pad[:, 1:-1] + 0.25 * pad[:, 2:]

    if valid is None:
        return conv(x)
    m = valid.float().reshape(*valid.shape, *([1] * (x.dim() - 2)))
    num = conv(x * m)
    den = conv(m)
    return torch.where(m > 0, num / den.clamp(min=1e-6), x)


def angle_features(sk: torch.Tensor) -> torch.Tensor:
    """Skeletons [B, T, V, C>=2] -> angle features [B, T, NUM_ANGLE_FEATURES]."""
    xy = sk[..., :2].float()
    eps = 1e-6

    def unit(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=eps)

    feats = []
    for a, c, b in _ANGLE_TRIPLETS:
        u = unit(xy[..., a, :] - xy[..., c, :])
        w = unit(xy[..., b, :] - xy[..., c, :])
        feats += [(u * w).sum(-1), u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0]]
    mid_hip = (xy[..., 11, :] + xy[..., 12, :]) / 2
    mid_sho = (xy[..., 5, :] + xy[..., 6, :]) / 2
    spine = unit(mid_sho - mid_hip)
    feats += [spine[..., 0], spine[..., 1]]
    torso = torch.linalg.norm(mid_sho - mid_hip, dim=-1).clamp(min=eps)
    feats.append((xy[..., 0, 0] - mid_hip[..., 0]) / torso)
    return torch.stack(feats, dim=-1)


def _diff_prepend(x: torch.Tensor) -> torch.Tensor:
    return torch.diff(x, dim=1, prepend=x[:, :1])


class ErrorClassifier(nn.Module):
    """(keypoints [B,T,V,C] raw image px, phase_logits [B,T,P], valid [B,T],
    ref_aligned [B,T,V,C] raw | None, aux [B,T,V,4] | None) -> logits [B,E]."""

    def __init__(self, cfg: ErrorConfig = ErrorConfig()):
        super().__init__()
        if cfg.spread_features and cfg.mode_features:
            raise ValueError("spread_features and mode_features are "
                             "mutually exclusive aux-channel semantics")
        self.cfg = cfg
        self.dt = compute_dtype(cfg.dtype)
        self.fc0 = nn.Linear(feature_dim(cfg), cfg.hidden_dim)
        self.ln0 = LayerNorm(cfg.hidden_dim)
        self.fc1 = nn.Linear(cfg.num_phases * cfg.hidden_dim, cfg.hidden_dim)
        self.ln1 = LayerNorm(cfg.hidden_dim)
        self.fc2 = nn.Linear(cfg.hidden_dim, cfg.num_errors)

    def forward(self, skeletons, phase_logits, valid=None, ref_aligned=None, aux=None):
        cfg = self.cfg
        B, T, V, C = skeletons.shape
        skeletons, clip_scale = normalize_skeleton_clip(
            skeletons.float(), valid, return_scale=True)
        skeletons = _smooth_time(skeletons, valid)
        if ref_aligned is not None:
            ref_aligned = _smooth_time(normalize_skeleton_clip(ref_aligned.float(), valid),
                                       valid)

        x = skeletons[..., :2].reshape(B, T, V * 2)
        ang = angle_features(skeletons)
        diff = None
        if ref_aligned is None:
            dev = torch.zeros((B, T, V * 3), device=x.device)
            has_ref = torch.zeros((B, T, 1), device=x.device)
        else:
            diff = skeletons[..., :2] - ref_aligned[..., :2]
            dist = torch.linalg.norm(diff, dim=-1)
            dev = torch.cat([diff.reshape(B, T, V * 2), dist], dim=-1)
            has_ref = torch.ones((B, T, 1), device=x.device)
        blocks = [x, _diff_prepend(x), ang, _diff_prepend(ang), dev, has_ref]

        if cfg.mode_features:
            # Secondary-mode block from aux (dx, dy, rel_mass, sep) in image
            # px: mass-weighted hidden deflection, raw mass ratio, and the
            # offset's projection on the reference-deviation direction.
            if aux is None:
                blocks.append(torch.zeros((B, T, 3 * V), device=x.device))
            else:
                m = _smooth_time(aux.float(), valid)
                scale = clip_scale.clamp(min=1e-3)[:, None, None]
                off = m[..., :2] / scale[..., None]
                rel = m[..., 2].clamp(0.0, 4.0)
                sep = m[..., 3] / scale
                w = rel / (1.0 + rel)
                if diff is None:
                    proj = torch.zeros((B, T, V), device=x.device)
                else:
                    u = diff / torch.linalg.norm(diff, dim=-1, keepdim=True).clamp(min=1e-6)
                    proj = (u * off).sum(-1) * w
                blocks.append(torch.cat([w * sep, rel, proj], dim=-1))

        if cfg.spread_features:
            # Heatmap-spread block from aux (cov_xx, cov_xy, cov_yy, floor) in
            # image px², floor being the training target's spread: the
            # isotropic excess, and the excess along the reference-deviation
            # direction, both in units of the clip scale.
            if aux is None:
                blocks.append(torch.zeros((B, T, 2 * V), device=x.device))
            else:
                sp = _smooth_time(aux.float(), valid)
                sp = sp / clip_scale.clamp(min=1e-3)[:, None, None, None] ** 2
                cxx, cxy, cyy, floor = sp.unbind(-1)
                iso = torch.sqrt((0.5 * (cxx + cyy) - floor).clamp(min=0.0))
                if diff is None:
                    dir_exc = torch.zeros((B, T, V), device=x.device)
                else:
                    u = diff / torch.linalg.norm(diff, dim=-1, keepdim=True).clamp(min=1e-6)
                    var_u = (u[..., 0] ** 2 * cxx + 2.0 * u[..., 0] * u[..., 1] * cxy
                             + u[..., 1] ** 2 * cyy)
                    dir_exc = torch.sqrt((var_u - floor).clamp(min=0.0))
                blocks.append(torch.cat([dir_exc, iso], dim=-1))

        dt = self.dt
        feat = F.relu(self.ln0(linear(self.fc0, torch.cat(blocks, dim=-1).to(dt))))
        # Soft per-phase pooling: weights = phase posterior, masked+normalized.
        w = torch.softmax(phase_logits.float(), dim=-1)
        if valid is not None:
            w = w * valid.float()[..., None]
        denom = w.sum(dim=1).clamp(min=1e-3)                  # [B, P]
        pooled = torch.einsum("btp,btf->bpf", w.to(dt), feat) / denom[..., None].to(dt)
        h = F.relu(self.ln1(linear(self.fc1, pooled.reshape(B, -1))))
        return self.fc2(h.float())                            # float32 (error.py:252)
