"""Keypoint-sequence refiner: a graph-temporal second stage for pose.

The pose front passes fault deflections with a joint-dependent gain below 1;
the attenuation is systematic, so a second stage trained on (predicted,
ground-truth) keypoint-sequence pairs can learn the inverse mapping from
skeletal structure, temporal context and the decoder's per-joint confidence.

The refiner reuses the GCN trunk blocks (their plain module chain) at its own
narrow widths, at `RefineConfig.dtype` (models/precision.py), and adds a
clipped per-joint residual computed in float32.  Opt-in:
`RefineConfig.enabled`; the pipeline applies it only when its params carry a
"refine" entry.
"""

from __future__ import annotations

import torch
from torch import nn

from golfaction_tpu_torch import graph
from golfaction_tpu_torch.config import GCNConfig, RefineConfig
from golfaction_tpu_torch.models.gcn import GCNBlock, normalize_skeleton_clip
from golfaction_tpu_torch.models.precision import compute_dtype


class KeypointRefiner(nn.Module):
    """Residual keypoint refinement: [B, T, V, 3] px -> [B, T, V, 3] px.

    The output head starts at zero, so a new refiner is the identity and
    training only ever has to learn the correction."""

    def __init__(self, cfg: RefineConfig = RefineConfig()):
        super().__init__()
        self.cfg = cfg
        self.dt = compute_dtype(cfg.dtype)
        gcfg = GCNConfig(temporal_branches=cfg.temporal_branches,
                         channel_att_reduction=cfg.channel_att_reduction, dropout=0.0,
                         dtype=cfg.dtype)
        A = graph.build_adjacency(gcfg.graph_strategy)
        blocks, cin = [], 3
        for ch in cfg.block_channels:
            blocks.append(GCNBlock(cin, ch, gcfg, A))
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, 2)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, kpts: torch.Tensor, valid=None) -> torch.Tensor:
        kpts = kpts.float()
        # Clip-mean mid-hip center and masked mean torso scale: per-frame
        # centering would erase the drift the refiner must keep.
        x, scale = normalize_skeleton_clip(kpts, valid, return_scale=True)
        x = x.to(self.dt)
        for blk in self.blocks:
            x = blk(x, valid)
        delta = self.head(x.float()).clamp(-self.cfg.max_residual, self.cfg.max_residual)
        xy = kpts[..., :2] + delta * scale[..., None, None, None]
        out = torch.cat([xy, kpts[..., 2:]], dim=-1)
        if valid is not None:
            out = torch.where(valid[..., None, None], out, kpts)
        return out
