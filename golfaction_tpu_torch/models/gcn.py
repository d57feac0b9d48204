"""Skeleton-GCN action-segmentation model.

Spatial graph conv -> multi-branch temporal conv -> channel attention ->
ST-joint attention, with a residual, per block; a per-frame swing-phase head.
Features are [B, T, V, C], channels last, and a `valid` [B, T] mask gates
every temporal mixing op so bucket padding never leaks into real frames.

Two forward paths compute the same function:
  * the plain module chain (`fused=False`), module for module as in the
    JAX package's flax model; the tests hold the fused path to it;
  * the fused path (`fused=True`, the default), as the JAX package's
    gcn_forward_pallas: the spatial conv and the residual in torch, the
    block tail through ops.gcn_tail (the CUDA kernel on the card).  Its
    weights are packed once by `prepare()`.

Training (`.train()`) runs the plain chain with the live weights and the
block dropout: the tail kernel is forward-only, as the TPU kernel it
replaces.  `GCNConfig.dtype` sets the compute dtype of training, as the JAX
trainers' flax chain honours it (models/precision.py).  Inference computes
in float32 on both paths whatever the dtype says (reference behaviour
(vii)): on the
TPU the JAX program takes gcn_forward_pallas, which casts the input to
float32 and runs float32 products (golfaction_tpu/ops/pallas/gcn_kernel.py:
346-369; the tail reads float32, :65, 200, 327), and only the flax chain, on
the JAX package's CPU path (golfaction_tpu/pipeline/orchestrator.py:404-410)
and in its training, honours `dtype`.  The refiner's blocks are this chain
at the refiner's own dtype.

Entering training mode drops what `prepare()` packed, so weights changed by
training never meet a stale copy; `prepare()` runs again before the next
fused forward.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from golfaction_tpu_torch import graph
from golfaction_tpu_torch.config import GCNConfig
from golfaction_tpu_torch.models.precision import compute_dtype, linear, sigmoid
from golfaction_tpu_torch.ops import gcn_tail
from golfaction_tpu_torch.ops.gcn_tail import layer_norm


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's statistics (eps 1e-6); a
    lower-precision x is normalized in float32 and rounded back."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        if x.dtype != torch.float32:
            return layer_norm(x.float(), self.weight, self.bias).to(x.dtype)
        return layer_norm(x, self.weight, self.bias)


def _mask(x: torch.Tensor, valid) -> torch.Tensor:
    """Zero features at padded frames.  x [B,T,...]; valid [B,T]."""
    if valid is None:
        return x
    v = valid.to(x.dtype)
    return x * v.reshape(v.shape + (1,) * (x.dim() - 2))


def _mean(x: torch.Tensor, dim) -> torch.Tensor:
    """jnp.mean: a lower-precision x is summed and divided in float32."""
    if x.dtype == torch.float32:
        return x.mean(dim=dim)
    return x.float().mean(dim=dim).to(x.dtype)


class SpatialGraphConv(nn.Module):
    """y[v] = Σ_p Σ_w A[p,v,w]·M[p,v,w] · (x[w] W_p), folded into one
    [B·T, V·Ci] @ [V·Ci, V·Co] product with Wbig[(w,ci),(v,co)]."""

    def __init__(self, cin: int, cout: int, adjacency: np.ndarray):
        super().__init__()
        P, V, _ = adjacency.shape
        self.register_buffer("A", torch.as_tensor(adjacency, dtype=torch.float32),
                             persistent=False)
        self.kernel = nn.Parameter(torch.zeros(P, cin, cout))
        self.edge_importance = nn.Parameter(torch.ones(P, V, V))
        self._wbig = None

    def wbig(self) -> torch.Tensor:
        P, V, _ = self.A.shape
        _, C, Co = self.kernel.shape
        w = torch.einsum("pvw,pco->wcvo", self.A * self.edge_importance, self.kernel)
        return w.reshape(V * C, V * Co)

    def forward(self, x):
        B, T, V, C = x.shape
        w = self._wbig if self._wbig is not None else self.wbig()
        return (x.reshape(B, T, V * C) @ w.to(x.dtype)).reshape(B, T, V, -1)


class MultiBranchTemporalConv(nn.Module):
    """Parallel dilated depthwise temporal branches + a max-pool branch."""

    def __init__(self, channels: int, branches):
        super().__init__()
        self.branches = tuple(branches)
        nb = len(self.branches) + 1
        cb = channels // nb
        rem = channels - cb * nb
        widths = [cb + (rem if i == 0 else 0) for i in range(len(self.branches))]
        self.dense = nn.ModuleList([nn.Linear(channels, ch, bias=False)
                                    for ch in widths + [cb]])
        self.ln = nn.ModuleList([LayerNorm(ch) for ch in widths + [cb, channels]])
        self.conv = nn.ModuleList([nn.Conv1d(ch, ch, k, dilation=d, groups=ch, bias=False)
                                   for ch, (k, d) in zip(widths, self.branches)])

    def forward(self, x, valid=None):
        B, T, V, _ = x.shape
        x = _mask(x, valid)
        outs = []
        for i, (k, d) in enumerate(self.branches):
            b = _mask(F.relu(self.ln[i](linear(self.dense[i], x))), valid)
            ch = b.shape[-1]
            seq = b.permute(0, 2, 3, 1).reshape(B * V, ch, T)
            pad = d * (k - 1)
            seq = F.pad(seq, (pad // 2, pad - pad // 2))
            seq = F.conv1d(seq, self.conv[i].weight.to(seq.dtype), dilation=d, groups=ch)
            outs.append(seq.reshape(B, V, ch, T).permute(0, 3, 1, 2))
        nb = len(self.branches)
        mp = _mask(self.ln[nb](linear(self.dense[nb], x)), valid)
        if valid is not None:
            v = valid.to(mp.dtype)[..., None, None]
            mp = mp + (1.0 - v) * -1e4
        cb = mp.shape[-1]
        seq = mp.permute(0, 2, 3, 1).reshape(B * V, cb, T)
        seq = F.max_pool1d(F.pad(seq, (1, 1), value=float("-inf")), 3, 1)
        outs.append(seq.reshape(B, V, cb, T).permute(0, 3, 1, 2))
        y = self.ln[nb + 1](torch.cat(outs, dim=-1))
        return _mask(F.relu(y), valid)


class ChannelAtt(nn.Module):
    """SE-style squeeze-excitation over channels."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        mid = max(channels // reduction, 8)
        self.fc1 = nn.Linear(channels, mid)
        self.fc2 = nn.Linear(mid, channels)

    def forward(self, x, valid=None):
        B, T, V, C = x.shape
        if valid is None:
            s = _mean(x, (1, 2))
        else:
            denom = valid.to(x.dtype).sum(1).clamp(min=1.0) * V
            s = _mask(x, valid).sum(dim=(1, 2)) / denom[:, None]
        g = sigmoid(linear(self.fc2, F.relu(linear(self.fc1, s))))
        return x * g[:, None, None, :]


class STJointAtt(nn.Module):
    """Factorized frame x joint attention gate from shared pooled embeddings."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        mid = max(channels // reduction, 8)
        self.fused = nn.Linear(channels, mid, bias=False)
        self.norm = LayerNorm(mid)
        self.t_fc = nn.Linear(mid, channels)
        self.v_fc = nn.Linear(mid, channels)

    def forward(self, x, valid=None):
        xm = _mask(x, valid)
        t_pool = _mean(xm, 2)
        if valid is None:
            v_pool = _mean(xm, 1)
        else:
            v_pool = xm.sum(dim=1) / valid.to(x.dtype).sum(1).clamp(min=1.0)[:, None, None]
        t_emb = torch.clamp(self.norm(linear(self.fused, t_pool)), -1.0, 1.0)
        v_emb = torch.clamp(self.norm(linear(self.fused, v_pool)), -1.0, 1.0)
        t_gate = sigmoid(linear(self.t_fc, t_emb))
        v_gate = sigmoid(linear(self.v_fc, v_emb))
        return x * t_gate[:, :, None, :] * v_gate[:, None, :, :]


class GCNBlock(nn.Module):
    def __init__(self, cin: int, channels: int, cfg: GCNConfig, adjacency):
        super().__init__()
        self.sgc = SpatialGraphConv(cin, channels, adjacency)
        self.ln0 = LayerNorm(channels)
        self.mbtc = MultiBranchTemporalConv(channels, cfg.temporal_branches)
        self.ca = ChannelAtt(channels, cfg.channel_att_reduction)
        self.stja = STJointAtt(channels, cfg.channel_att_reduction)
        self.proj = nn.Linear(cin, channels, bias=False) if cin != channels else None
        self.tail = None

    def pack(self) -> gcn_tail.TailWeights:
        """The tail's weights packed for ops.gcn_tail, in [in, out] layout."""
        m = self.mbtc
        nb = len(m.branches)

        def ln(mod):
            return (mod.weight.detach(), mod.bias.detach())

        def dense(lin):
            return (lin.weight.detach().t(), lin.bias.detach())

        return gcn_tail.pack_tail(
            ln0=ln(self.ln0),
            branch_dense=[m.dense[i].weight.detach().t() for i in range(nb)],
            branch_ln=[ln(m.ln[i]) for i in range(nb)],
            branch_taps=[m.conv[i].weight.detach()[:, 0, :].t() for i in range(nb)],
            branches=m.branches,
            mp_dense=m.dense[nb].weight.detach().t(),
            mp_ln=ln(m.ln[nb]),
            lnf=ln(m.ln[nb + 1]),
            ca1=dense(self.ca.fc1), ca2=dense(self.ca.fc2),
            stja_fused=self.stja.fused.weight.detach().t(),
            stja_ln=ln(self.stja.norm),
            stja_t=dense(self.stja.t_fc), stja_v=dense(self.stja.v_fc),
        )

    def forward(self, x, valid, la=None, fused: bool = False, dropout: float = 0.0,
                generator=None):
        y = self.sgc(x)
        if fused:
            z = gcn_tail.gcn_block_tail(y.contiguous(), la, self.tail)
        else:
            y = F.relu(self.ln0(y))
            y = self.mbtc(y, valid)
            y = self.ca(y, valid)
            z = self.stja(y, valid)
        residual = x if self.proj is None else linear(self.proj, x)
        z = z + residual
        if dropout > 0:
            keep = torch.rand(z.shape, generator=generator, device=z.device) >= dropout
            z = z * keep / (1.0 - dropout)
        return _mask(z, valid)


class ActionSegmentationGCN(nn.Module):
    """skeletons [B, T, V, C_in] (normalized), valid [B, T] -> phase logits
    [B, T, num_phases] float32.

    A new model is in eval mode (inference is the default use), where both
    paths compute in float32; `.train()` enters training mode, where
    `forward` takes the plain chain at cfg.dtype and draws the block dropout
    from `generator` (a torch.Generator on the model's device)."""

    def __init__(self, cfg: GCNConfig = GCNConfig()):
        super().__init__()
        self.cfg = cfg
        self.dt = compute_dtype(cfg.dtype)
        A = graph.build_adjacency(cfg.graph_strategy)
        blocks, cin = [], cfg.in_channels
        for ch in cfg.block_channels:
            blocks.append(GCNBlock(cin, ch, cfg, A))
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.head0 = nn.Linear(cin, cfg.block_channels[-1])
        self.head1 = nn.Linear(cfg.block_channels[-1], cfg.num_phases)
        self.train(False)

    def train(self, mode: bool = True):
        if mode:
            for blk in self.blocks:
                blk.tail = None
                blk.sgc._wbig = None
        return super().train(mode)

    @torch.no_grad()
    def prepare(self) -> None:
        """Fold the adjacency into each spatial conv and pack each block's
        tail weights, once, after the weights are loaded."""
        for blk in self.blocks:
            blk.sgc._wbig = blk.sgc.wbig().detach()
            blk.tail = blk.pack().to(blk.sgc.kernel.device)

    def forward(self, x, valid, fused: bool = True, generator=None):
        dropout, dt = 0.0, torch.float32
        if self.training:
            fused, dt = False, self.dt
            dropout = self.cfg.dropout
            if dropout > 0 and generator is None:
                raise ValueError("training with dropout needs an explicit torch.Generator")
        if fused and self.blocks[0].tail is None:
            raise RuntimeError("ActionSegmentationGCN.prepare() must run before "
                               "the fused forward")
        h = x.to(dt)
        la = valid.sum(1).to(torch.int32).contiguous() if fused else None
        for blk in self.blocks:
            h = blk(h, valid, la=la, fused=fused, dropout=dropout, generator=generator)
        feat = F.relu(linear(self.head0, _mean(h, 2)))
        return self.head1(feat.float())              # float32 logits (gcn.py:231)


def _torso(kpts: torch.Tensor):
    xy = kpts[..., :2]
    hips = (xy[..., 11, :] + xy[..., 12, :]) / 2.0
    shoulders = (xy[..., 5, :] + xy[..., 6, :]) / 2.0
    return xy, hips, torch.linalg.norm(shoulders - hips, dim=-1)


def normalize_skeleton(kpts: torch.Tensor, valid=None) -> torch.Tensor:
    """kpts [..., T, V, 3] image px -> per-frame hip-centered, torso-scaled
    (x, y, score); the scale is the (masked) clip-mean torso length."""
    xy, hips, torso = _torso(kpts)
    if valid is not None:
        v = valid.to(torso.dtype)
        scale = (torso * v).sum(-1) / v.sum(-1).clamp(min=1.0)
    else:
        scale = torso.mean(-1)
    scale = scale.clamp(min=1e-3)[..., None, None, None]
    centered = (xy - hips[..., None, :]) / scale
    return torch.cat([centered, kpts[..., 2:]], dim=-1)


def normalize_skeleton_clip(kpts: torch.Tensor, valid=None, return_scale: bool = False):
    """Like normalize_skeleton but centered on the clip-mean mid-hip, which
    keeps the within-clip drift that translation faults are made of."""
    xy, hips, torso = _torso(kpts)
    if valid is not None:
        v = valid.to(torso.dtype)
        denom = v.sum(-1).clamp(min=1.0)
        scale = (torso * v).sum(-1) / denom
        center = (hips * v[..., None]).sum(-2) / denom[..., None]
    else:
        scale = torso.mean(-1)
        center = hips.mean(-2)
    scale = scale.clamp(min=1e-3)[..., None, None, None]
    out = torch.cat([(xy - center[..., None, None, :]) / scale, kpts[..., 2:]], dim=-1)
    if return_scale:
        return out, scale[..., 0, 0, 0]
    return out
