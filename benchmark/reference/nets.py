"""The four networks as plain PyTorch modules: the pose net (a SimpleBaseline
ResNet with GroupNorm, Xiao et al., ECCV 2018), the skeleton GCN, the
alignment encoder and the error head.

Parameter names and shapes are those of the system's state dicts, so the
same weights load into both.  Each module computes as flax does at its
configured dtype: a convolution or dense layer rounds its input and weight to
the compute dtype and adds the bias after the product's rounding, norms take
their statistics in float32 and round back, and the GCN runs float32 at
inference whatever its dtype says.

`Numerics` lowers the precision for the control: products in float8 (e4m3,
per-tensor scales) where the configuration states bfloat16, and in TF32
(inputs rounded to 10 mantissa bits) where it states float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import graph

_EPS = 1e-6
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale (amax onto 448), back at x's dtype."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / 448.0
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Numerics:
    """lowp=False: the configuration's precisions.  lowp=True: the control,
    one step below each (bfloat16 -> float8, float32 -> TF32)."""
    lowp: bool = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.lowp:
            return x
        return tf32_round(x) if x.dtype == torch.float32 else fp8_round(x)


def _dense(lin: nn.Linear, x: torch.Tensor, num: Numerics) -> torch.Tensor:
    w = lin.weight.to(x.dtype)
    y = F.linear(num.q(x), num.q(w))
    return y if lin.bias is None else y + lin.bias.to(x.dtype)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm over the last axis (E[x^2] - E[x]^2, clamped), in float32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return ((xf - mean) * torch.rsqrt(var + _EPS) * w + b).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over [N, C, H, W]: float32 statistics and arithmetic over the
    channels-last view (flax's), rounded to x's dtype."""

    def forward(self, x):
        xl = x.movedim(1, -1).float()
        N, C, G = xl.shape[0], xl.shape[-1], self.num_groups
        xg = xl.reshape(N, -1, G, C // G)
        mu = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(1, 3), keepdim=True) - mu * mu).clamp(min=0.0)
        shape = (1, 1, G, -1)
        out = (xg - mu) * (torch.rsqrt(var + self.eps) * self.weight.reshape(shape)) \
            + self.bias.reshape(shape)
        return out.reshape(xl.shape).to(x.dtype).movedim(-1, 1)


# ---------------------------------------------------------------------------
# Pose net
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, s, value=0.0):
    ph, pw = _same_pads(x.shape[-2], k, s), _same_pads(x.shape[-1], k, s)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class Conv(nn.Module):
    """Bias-free k x k convolution, flax SAME padding."""

    def __init__(self, cin, cout, k, stride=1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.k, self.stride = k, stride

    def forward(self, x, num):
        w = self.weight.to(x.dtype)
        return F.conv2d(num.q(_pad_same(x, self.k, self.stride)), num.q(w), stride=self.stride)


class Deconv(nn.Module):
    """Bias-free 4x4 stride-2 transposed convolution (weight [Cin, Cout, 4, 4])."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 4, 4))

    def forward(self, x, num):
        return F.conv_transpose2d(num.q(x), num.q(self.weight.to(x.dtype)), stride=2, padding=1)


class Project(nn.Module):
    """1x1 heatmap projection with bias (added after the product's rounding)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, num):
        y = F.conv2d(num.q(x), num.q(self.weight.to(x.dtype)))
        return y + self.bias.to(x.dtype)[:, None, None]


def _gn(ch, groups=None):
    return GroupNorm(groups or min(32, ch), ch, eps=_EPS)


class ResBlock(nn.Module):
    def __init__(self, cin, ch, stride):
        super().__init__()
        self.conv1, self.gn1 = Conv(cin, ch, 3, stride), _gn(ch)
        self.conv2, self.gn2 = Conv(ch, ch, 3), _gn(ch)
        self.proj = None
        if cin != ch or stride != 1:
            self.proj, self.gn3 = Conv(cin, ch, 1, stride), _gn(ch)

    def forward(self, x, num):
        y = F.relu(self.gn1(self.conv1(x, num)))
        y = self.gn2(self.conv2(y, num))
        r = x if self.proj is None else self.gn3(self.proj(x, num))
        return F.relu(y + r)


class PoseNet(nn.Module):
    """crops [B, h, w, 3] float32 (normalized, NHWC) -> heatmaps [B, V, Hh, Wh] float32."""

    def __init__(self, c: dict, num: Numerics = Numerics()):
        super().__init__()
        self.dt, self.num = _DTYPES[c["dtype"]], num
        self.stem, self.gn0 = Conv(3 * c["in_frames"], 64, 7, 2), _gn(64)
        blocks, cin = [], 64
        for i, (nb, ch) in enumerate(zip(c["stage_blocks"], c["stage_channels"])):
            for b in range(nb):
                blocks.append(ResBlock(cin, ch, 2 if (b == 0 and i > 0) else 1))
                cin = ch
        self.blocks = nn.ModuleList(blocks)
        head = list(c["deconv_channels"])
        stride = 4 * 2 ** (len(c["stage_blocks"]) - 1) // 2 ** len(head)
        n_extra = 0
        while stride > c["input_hw"][0] // c["heatmap_hw"][0]:
            n_extra, stride = n_extra + 1, stride // 2
        head += [head[-1]] * n_extra
        deconvs, gns = [], []
        for i, ch in enumerate(head):
            deconvs.append(Deconv(cin, ch))
            gns.append(_gn(ch) if i < len(c["deconv_channels"]) else _gn(ch, 32))
            cin = ch
        self.deconvs, self.dgns = nn.ModuleList(deconvs), nn.ModuleList(gns)
        self.final = Project(cin, c["num_joints"])

    def forward(self, x):
        num = self.num
        x = x.to(self.dt).permute(0, 3, 1, 2)
        x = F.relu(self.gn0(self.stem(x, num)))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for blk in self.blocks:
            x = blk(x, num)
        for d, g in zip(self.deconvs, self.dgns):
            x = F.relu(g(d(x, num)))
        return self.final(x, num).float()


def _out(n: int, s: int) -> int:
    return -(-n // s)


def pose_flops(p: dict) -> int:
    """The matrix FLOPs of one crop through PoseNet (benchmark.counts's convention)."""
    h, w = p["input_hw"]
    total = 0

    def conv(cin, cout, k, s):
        nonlocal h, w, total
        h, w = _out(h, s), _out(w, s)
        total += 2 * cin * cout * k * k * h * w

    conv(3 * p["in_frames"], 64, 7, 2)
    h, w = _out(h, 2), _out(w, 2)                        # max pool
    cin = 64
    for i, (nb, ch) in enumerate(zip(p["stage_blocks"], p["stage_channels"])):
        for b in range(nb):
            s = 2 if (b == 0 and i > 0) else 1
            conv(cin, ch, 3, s)
            conv(ch, ch, 3, 1)
            if cin != ch or s != 1:
                total += 2 * cin * ch * h * w            # 1x1 projection at the output size
            cin = ch
    head = list(p["deconv_channels"])
    stride = 4 * 2 ** (len(p["stage_blocks"]) - 1) // 2 ** len(head)
    while stride > p["input_hw"][0] // p["heatmap_hw"][0]:
        head.append(head[-1])
        stride //= 2
    for ch in head:                                      # 4x4 stride-2 transposed convs
        total += 2 * cin * ch * 16 * h * w
        h, w, cin = 2 * h, 2 * w, ch
    total += 2 * cin * p["num_joints"] * h * w
    return total


# ---------------------------------------------------------------------------
# GCN (inference: float32)
# ---------------------------------------------------------------------------

def _mask(x, valid):
    v = valid.to(x.dtype)
    return x * v.reshape(v.shape + (1,) * (x.dim() - 2))


class SpatialGraphConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        A = graph.spatial_adjacency()
        self.register_buffer("A", torch.as_tensor(A), persistent=False)
        P, V, _ = A.shape
        self.kernel = nn.Parameter(torch.zeros(P, cin, cout))
        self.edge_importance = nn.Parameter(torch.ones(P, V, V))

    def forward(self, x, num):
        # y[v] = sum_p sum_w A[p, v, w] * M[p, v, w] * (x[w] @ W_p)
        xw = torch.einsum("btwc,pco->btpwo", num.q(x), num.q(self.kernel))
        return torch.einsum("pvw,btpwo->btvo", self.A * self.edge_importance, xw)


class TemporalBranches(nn.Module):
    def __init__(self, ch, branches):
        super().__init__()
        self.branches = tuple(tuple(b) for b in branches)
        nb = len(self.branches) + 1
        cb = ch // nb
        widths = [cb + (ch - cb * nb if i == 0 else 0) for i in range(len(self.branches))]
        self.dense = nn.ModuleList([nn.Linear(ch, w, bias=False) for w in widths + [cb]])
        self.ln = nn.ModuleList([LayerNorm(w) for w in widths + [cb, ch]])
        self.conv = nn.ModuleList([nn.Conv1d(w, w, k, dilation=d, groups=w, bias=False)
                                   for w, (k, d) in zip(widths, self.branches)])

    def forward(self, x, valid, num):
        B, T, V, _ = x.shape
        x = _mask(x, valid)
        outs = []
        for i, (k, d) in enumerate(self.branches):
            b = _mask(F.relu(self.ln[i](_dense(self.dense[i], x, num))), valid)
            ch = b.shape[-1]
            seq = b.permute(0, 2, 3, 1).reshape(B * V, ch, T)
            pad = d * (k - 1)
            seq = F.conv1d(F.pad(seq, (pad // 2, pad - pad // 2)), self.conv[i].weight,
                           dilation=d, groups=ch)
            outs.append(seq.reshape(B, V, ch, T).permute(0, 3, 1, 2))
        nb = len(self.branches)
        mp = _mask(self.ln[nb](_dense(self.dense[nb], x, num)), valid)
        mp = mp + (1.0 - valid.to(mp.dtype)[..., None, None]) * -1e4
        cb = mp.shape[-1]
        seq = mp.permute(0, 2, 3, 1).reshape(B * V, cb, T)
        seq = F.max_pool1d(F.pad(seq, (1, 1), value=float("-inf")), 3, 1)
        outs.append(seq.reshape(B, V, cb, T).permute(0, 3, 1, 2))
        return _mask(F.relu(self.ln[nb + 1](torch.cat(outs, dim=-1))), valid)


class ChannelAtt(nn.Module):
    def __init__(self, ch, reduction):
        super().__init__()
        mid = max(ch // reduction, 8)
        self.fc1, self.fc2 = nn.Linear(ch, mid), nn.Linear(mid, ch)

    def forward(self, x, valid, num):
        V = x.shape[2]
        denom = valid.to(x.dtype).sum(1).clamp(min=1.0) * V
        s = _mask(x, valid).sum(dim=(1, 2)) / denom[:, None]
        g = _sigmoid(_dense(self.fc2, F.relu(_dense(self.fc1, s, num)), num))
        return x * g[:, None, None, :]


class STJointAtt(nn.Module):
    def __init__(self, ch, reduction):
        super().__init__()
        mid = max(ch // reduction, 8)
        self.fused = nn.Linear(ch, mid, bias=False)
        self.norm = LayerNorm(mid)
        self.t_fc, self.v_fc = nn.Linear(mid, ch), nn.Linear(mid, ch)

    def forward(self, x, valid, num):
        xm = _mask(x, valid)
        t_pool = xm.mean(dim=2)
        v_pool = xm.sum(dim=1) / valid.to(x.dtype).sum(1).clamp(min=1.0)[:, None, None]
        t_emb = torch.clamp(self.norm(_dense(self.fused, t_pool, num)), -1.0, 1.0)
        v_emb = torch.clamp(self.norm(_dense(self.fused, v_pool, num)), -1.0, 1.0)
        t_gate = _sigmoid(_dense(self.t_fc, t_emb, num))
        v_gate = _sigmoid(_dense(self.v_fc, v_emb, num))
        return x * t_gate[:, :, None, :] * v_gate[:, None, :, :]


class GCNBlock(nn.Module):
    def __init__(self, cin, ch, c):
        super().__init__()
        self.sgc = SpatialGraphConv(cin, ch)
        self.ln0 = LayerNorm(ch)
        self.mbtc = TemporalBranches(ch, c["temporal_branches"])
        self.ca = ChannelAtt(ch, c["channel_att_reduction"])
        self.stja = STJointAtt(ch, c["channel_att_reduction"])
        self.proj = nn.Linear(cin, ch, bias=False) if cin != ch else None

    def forward(self, x, valid, num):
        y = F.relu(self.ln0(self.sgc(x, num)))
        y = self.stja(self.ca(self.mbtc(y, valid, num), valid, num), valid, num)
        r = x if self.proj is None else _dense(self.proj, x, num)
        return _mask(y + r, valid)


class GCN(nn.Module):
    """skeletons [B, T, V, 3] (normalized), valid [B, T] -> phase logits [B, T, P] float32."""

    def __init__(self, c: dict, num: Numerics = Numerics()):
        super().__init__()
        self.num = num
        blocks, cin = [], c["in_channels"]
        for ch in c["block_channels"]:
            blocks.append(GCNBlock(cin, ch, c))
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.head0 = nn.Linear(cin, c["block_channels"][-1])
        self.head1 = nn.Linear(c["block_channels"][-1], c["num_phases"])

    def forward(self, x, valid):
        h = x.float()
        for blk in self.blocks:
            h = blk(h, valid, self.num)
        feat = F.relu(_dense(self.head0, h.mean(dim=2), self.num))
        return _dense(self.head1, feat, self.num)


# ---------------------------------------------------------------------------
# Skeleton normalization, error head, alignment encoder
# ---------------------------------------------------------------------------

def _torso(kpts):
    xy = kpts[..., :2]
    hips = (xy[..., 11, :] + xy[..., 12, :]) / 2.0
    shoulders = (xy[..., 5, :] + xy[..., 6, :]) / 2.0
    return xy, hips, torch.linalg.norm(shoulders - hips, dim=-1)


def normalize_skeleton(kpts, valid):
    """Hip-centred per frame, scaled by the masked clip-mean torso length."""
    xy, hips, torso = _torso(kpts)
    v = valid.to(torso.dtype)
    scale = ((torso * v).sum(-1) / v.sum(-1).clamp(min=1.0)).clamp(min=1e-3)
    centered = (xy - hips[..., None, :]) / scale[..., None, None, None]
    return torch.cat([centered, kpts[..., 2:]], dim=-1)


def normalize_skeleton_clip(kpts, valid):
    """Centred on the clip-mean mid-hip; returns (skeleton, scale [B])."""
    xy, hips, torso = _torso(kpts)
    v = valid.to(torso.dtype)
    denom = v.sum(-1).clamp(min=1.0)
    scale = ((torso * v).sum(-1) / denom).clamp(min=1e-3)
    center = (hips * v[..., None]).sum(-2) / denom[..., None]
    out = torch.cat([(xy - center[..., None, None, :]) / scale[..., None, None, None],
                     kpts[..., 2:]], dim=-1)
    return out, scale


def _smooth_time(x, valid):
    def conv(z):
        pad = torch.cat([z[:, :1], z, z[:, -1:]], dim=1)
        return 0.25 * pad[:, :-2] + 0.5 * pad[:, 1:-1] + 0.25 * pad[:, 2:]

    m = valid.float().reshape(*valid.shape, *([1] * (x.dim() - 2)))
    return torch.where(m > 0, conv(x * m) / conv(m).clamp(min=1e-6), x)


_ANGLES = ((5, 7, 9), (6, 8, 10), (11, 13, 15), (12, 14, 16),
           (7, 5, 11), (8, 6, 12), (5, 11, 13), (6, 12, 14))
NUM_ANGLE_FEATURES = 2 * len(_ANGLES) + 3


def angle_features(sk):
    xy = sk[..., :2].float()

    def unit(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=1e-6)

    feats = []
    for a, c, b in _ANGLES:
        u, w = unit(xy[..., a, :] - xy[..., c, :]), unit(xy[..., b, :] - xy[..., c, :])
        feats += [(u * w).sum(-1), u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0]]
    mid_hip = (xy[..., 11, :] + xy[..., 12, :]) / 2
    mid_sho = (xy[..., 5, :] + xy[..., 6, :]) / 2
    spine = unit(mid_sho - mid_hip)
    torso = torch.linalg.norm(mid_sho - mid_hip, dim=-1).clamp(min=1e-6)
    feats += [spine[..., 0], spine[..., 1], (xy[..., 0, 0] - mid_hip[..., 0]) / torso]
    return torch.stack(feats, dim=-1)


def _diff(x):
    return torch.diff(x, dim=1, prepend=x[:, :1])


def error_feature_dim(c: dict) -> int:
    V = c["num_joints"]
    return 7 * V + 2 * NUM_ANGLE_FEATURES + 1 + (3 * V if c["mode_features"] else 0)


class ErrorHead(nn.Module):
    """(keypoints [B, T, V, 3] image px, phase logits [B, T, P], valid, warped
    reference [B, T, V, 3] or None, aux [B, T, V, 4] or None) -> logits [B, E]."""

    def __init__(self, c: dict, num: Numerics = Numerics()):
        super().__init__()
        if c["spread_features"]:
            raise ValueError("the reference implements the error head without spread features")
        self.c, self.dt, self.num = c, _DTYPES[c["dtype"]], num
        self.fc0 = nn.Linear(error_feature_dim(c), c["hidden_dim"])
        self.ln0 = LayerNorm(c["hidden_dim"])
        self.fc1 = nn.Linear(c["num_phases"] * c["hidden_dim"], c["hidden_dim"])
        self.ln1 = LayerNorm(c["hidden_dim"])
        self.fc2 = nn.Linear(c["hidden_dim"], c["num_errors"])

    def forward(self, kpts, phase_logits, valid, ref=None, aux=None):
        B, T, V, _ = kpts.shape
        sk, clip_scale = normalize_skeleton_clip(kpts.float(), valid)
        sk = _smooth_time(sk, valid)
        x = sk[..., :2].reshape(B, T, V * 2)
        ang = angle_features(sk)
        diff = None
        if ref is None:
            dev = torch.zeros((B, T, V * 3), device=x.device)
            has_ref = torch.zeros((B, T, 1), device=x.device)
        else:
            r = _smooth_time(normalize_skeleton_clip(ref.float(), valid)[0], valid)
            diff = sk[..., :2] - r[..., :2]
            dev = torch.cat([diff.reshape(B, T, V * 2), torch.linalg.norm(diff, dim=-1)], -1)
            has_ref = torch.ones((B, T, 1), device=x.device)
        blocks = [x, _diff(x), ang, _diff(ang), dev, has_ref]
        if self.c["mode_features"]:
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
        dt, num = self.dt, self.num
        feat = F.relu(self.ln0(_dense(self.fc0, torch.cat(blocks, dim=-1).to(dt), num)))
        w = torch.softmax(phase_logits.float(), dim=-1) * valid.float()[..., None]
        denom = w.sum(dim=1).clamp(min=1e-3)
        pooled = torch.einsum("btp,btf->bpf", num.q(w.to(dt)), num.q(feat)) \
            / denom[..., None].to(dt)
        h = F.relu(self.ln1(_dense(self.fc1, pooled.reshape(B, -1), num)))
        return _dense(self.fc2, h.float(), num)


class AlignEncoder(nn.Module):
    """skeletons [B, T, V, 3] -> L2-normalized, masked frame embeddings [B, T, D] float32."""

    def __init__(self, c: dict, num: Numerics = Numerics()):
        super().__init__()
        self.c, self.dt, self.num = c, _DTYPES[c["dtype"]], num
        h = c["hidden_channels"]
        self.mixer = nn.Linear(c["num_joints"] * c["in_channels"], h[0])
        self.mixer_ln = LayerNorm(h[0])
        convs, lns, projs, cin = [], [], [], h[0]
        for ch in h:
            convs.append(nn.Conv1d(cin, ch, c["temporal_kernel"], bias=False))
            lns.append(LayerNorm(ch))
            projs.append(nn.Linear(cin, ch, bias=False) if cin != ch else nn.Identity())
            cin = ch
        self.convs, self.lns, self.projs = (nn.ModuleList(convs), nn.ModuleList(lns),
                                            nn.ModuleList(projs))
        self.embed = nn.Linear(cin, c["embed_dim"])

    def forward(self, x, valid):
        B, T, V, C = x.shape
        num, k = self.num, self.c["temporal_kernel"]
        x = F.relu(self.mixer_ln(_dense(self.mixer, x.to(self.dt).reshape(B, T, V * C), num)))
        for i, (conv, ln, proj) in enumerate(zip(self.convs, self.lns, self.projs)):
            y = (x * valid.to(x.dtype)[..., None]).transpose(1, 2)
            pad = (k - 1) * 2 ** i
            y = F.conv1d(num.q(F.pad(y, (pad // 2, pad - pad // 2))),
                         num.q(conv.weight.to(y.dtype)), dilation=2 ** i).transpose(1, 2)
            y = F.relu(ln(y))
            x = (x if isinstance(proj, nn.Identity) else _dense(proj, x, num)) + y
        emb = _dense(self.embed, x.float(), num)
        if self.c["normalize_embeddings"]:
            emb = emb / torch.linalg.norm(emb, dim=-1, keepdim=True).clamp(min=1e-6)
        return emb * valid.to(emb.dtype)[..., None]

