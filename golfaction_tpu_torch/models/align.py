"""Temporal-alignment embedding network: per-frame joint mixer + dilated
temporal conv stack (a small TCN), skeleton [B, T, V, C] -> frame embeddings
[B, T, D] float32, L2-normalized and masked, matched by soft-DTW.  The
trunk computes at `AlignConfig.dtype` (models/precision.py); the embedding
layer and what follows are float32, so the soft-DTW kernels see float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from golfaction_tpu_torch.config import AlignConfig
from golfaction_tpu_torch.models.gcn import LayerNorm
from golfaction_tpu_torch.models.precision import compute_dtype, linear


def _mask_bt(x: torch.Tensor, valid) -> torch.Tensor:
    if valid is None:
        return x
    return x * valid.to(x.dtype)[..., None]


class AlignEncoder(nn.Module):
    def __init__(self, cfg: AlignConfig = AlignConfig()):
        super().__init__()
        self.cfg = cfg
        self.dt = compute_dtype(cfg.dtype)
        h = cfg.hidden_channels
        self.mixer = nn.Linear(cfg.num_joints * cfg.in_channels, h[0])
        self.mixer_ln = LayerNorm(h[0])
        convs, lns, projs = [], [], []
        cin = h[0]
        for i, ch in enumerate(h):
            convs.append(nn.Conv1d(cin, ch, cfg.temporal_kernel, dilation=2 ** i, bias=False))
            lns.append(LayerNorm(ch))
            projs.append(nn.Linear(cin, ch, bias=False) if cin != ch else None)
            cin = ch
        self.convs = nn.ModuleList(convs)
        self.lns = nn.ModuleList(lns)
        self.projs = nn.ModuleList([p if p is not None else nn.Identity() for p in projs])
        self.embed = nn.Linear(cin, cfg.embed_dim)

    def forward(self, x, valid=None):
        B, T, V, C = x.shape
        x = F.relu(self.mixer_ln(linear(self.mixer, x.to(self.dt).reshape(B, T, V * C))))
        k = self.cfg.temporal_kernel
        for i, (conv, ln, proj) in enumerate(zip(self.convs, self.lns, self.projs)):
            y = _mask_bt(x, valid).transpose(1, 2)              # [B, C, T]
            pad = (k - 1) * 2 ** i                              # flax SAME
            y = F.conv1d(F.pad(y, (pad // 2, pad - pad // 2)), conv.weight.to(y.dtype),
                         dilation=2 ** i).transpose(1, 2)
            y = F.relu(ln(y))
            x = (x if isinstance(proj, nn.Identity) else linear(proj, x)) + y
        emb = self.embed(x.float())                          # float32 (align.py:62)
        if self.cfg.normalize_embeddings:
            emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True).clamp(min=1e-6)
        return _mask_bt(emb, valid)
