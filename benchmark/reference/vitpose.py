"""The pose net of the `vitpose_l` configuration in plain PyTorch: ViTPose
(Xu, Zhang, Zhang, Tao, NeurIPS 2022, https://arxiv.org/abs/2204.12484;
the COCO top-down model at 256x192), a plain vision transformer before
`nets`' SimpleBaseline head, named by the configuration file's
"pose_reference" (benchmark.reference.pose_reference), and the plain
reference that the system's tier-1 tests hold its ViT to, at tiny widths
with the default `Numerics`.

  patch embedding   Conv2d(3, C, 16, stride 16, padding 2, bias): every
                    ViTPose variant's PATCH and PATCH_PADDING
  position          + pos_embed[:, 1:] + pos_embed[:, :1] (the class row
                    added to every token; no class token)
  depth x block     x + proj(attn(LN1(x))), then x + fc2(GELU(fc1(LN2(x)))):
                    qkv with bias, heads of C / heads, scale (C / heads)^-0.5,
                    exact GELU, LayerNorm eps 1e-6
  last_norm         LayerNorm, tokens back to [B, C, h, w]
  head              nets' deconvolutions with GroupNorm and ReLU, the 1x1
                    projection (GroupNorm in place of the paper's BatchNorm,
                    as the configurations' ResNet has)

Parameter names and shapes are those of the system's state dict.  At the
configured dtype it computes as the system states its precision: products
round input and weight to the dtype and add the bias after their rounding;
LayerNorm, GELU and GroupNorm take float32 statistics and arithmetic and
round once; the attention follows the card's fused kernels (flash, cuDNN):
scores in float32, p = exp(s - rowmax) rounded to the dtype before its
product with v, that product summed in float32 and divided by the float32
sum of p, the output rounded once; the residual and position adds round at
the dtype.  Every product goes through `num.q` (the control's lower
precision).

`pose_flops(p)` counts a crop's matrix FLOPs; `attn_bytes_flops(B, N, C)`
the least bytes and FLOPs of one attention over B crops of N tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import nets

_EPS = 1e-6
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PATCH = 16
PATCH_PADDING = 2


def token_grid(p: dict) -> tuple[int, int]:
    return tuple((n + 2 * PATCH_PADDING - PATCH) // PATCH + 1 for n in p["input_hw"])


def layer_norm(x, ln):
    """Over the last axis: mean and variance (two passes) in float32, rounded once."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + _EPS) * ln.weight + ln.bias).to(x.dtype)


def gelu(x):
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


class Linear(nn.Module):
    def __init__(self, n_in, n_out):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, x, num):
        return F.linear(num.q(x), num.q(self.weight.to(x.dtype))) + self.bias.to(x.dtype)


class Norm(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))


class PatchConv(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))


class Attention(nn.Module):
    def __init__(self, C, heads):
        super().__init__()
        self.heads = heads
        self.qkv, self.proj = Linear(C, 3 * C), Linear(C, C)

    def forward(self, x, num):
        B, N, C = x.shape
        qkv = self.qkv(x, num).reshape(B, N, 3, self.heads, C // self.heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        s = num.q(q).float() @ num.q(k).float().transpose(-2, -1) / math.sqrt(q.shape[-1])
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = (num.q(p.to(x.dtype)).float() @ num.q(v).float()) / p.sum(-1, keepdim=True)
        o = o.to(x.dtype)
        return self.proj(o.transpose(1, 2).reshape(B, N, C), num)


class Mlp(nn.Module):
    def __init__(self, C, hidden):
        super().__init__()
        self.fc1, self.fc2 = Linear(C, hidden), Linear(hidden, C)


class Block(nn.Module):
    def __init__(self, C, heads, hidden):
        super().__init__()
        self.norm1, self.attn = Norm(C), Attention(C, heads)
        self.norm2, self.mlp = Norm(C), Mlp(C, hidden)

    def forward(self, x, num):
        x = x + self.attn(layer_norm(x, self.norm1), num)
        m = self.mlp
        return x + m.fc2(gelu(m.fc1(layer_norm(x, self.norm2), num)), num)


def _head_channels(p: dict) -> list:
    """The head's deconvolution widths from stride PATCH."""
    head = list(p["deconv_channels"])
    stride = PATCH // 2 ** len(head)
    while stride > p["input_hw"][0] // p["heatmap_hw"][0]:
        head.append(head[-1])
        stride //= 2
    return head


class PoseNet(nn.Module):
    """crops [B, h, w, 3] float32 (normalized, NHWC) -> heatmaps [B, V, Hh, Wh] float32."""

    def __init__(self, c: dict, num: nets.Numerics = nets.Numerics()):
        super().__init__()
        self.c, self.dt, self.num = c, _DTYPES[c["dtype"]], num
        C = c["vit_width"]
        self.grid = token_grid(c)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = PatchConv(3 * c["in_frames"], C, PATCH)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid[0] * self.grid[1] + 1, C))
        self.blocks = nn.ModuleList(Block(C, c["vit_heads"], c["vit_mlp_width"])
                                    for _ in range(c["vit_depth"]))
        self.last_norm = Norm(C)
        head = _head_channels(c)
        cins = [C] + head[:-1]
        self.deconvs = nn.ModuleList(nets.Deconv(a, o) for a, o in zip(cins, head))
        self.dgns = nn.ModuleList(nets._gn(ch) if i < len(c["deconv_channels"])
                                  else nets._gn(ch, 32) for i, ch in enumerate(head))
        self.final = nets.Project(head[-1], c["num_joints"])

    def forward(self, x):
        num, dt, c = self.num, self.dt, self.c
        x = x.to(dt).permute(0, 3, 1, 2)
        pe = self.patch_embed.proj
        x = F.conv2d(num.q(x), num.q(pe.weight.to(dt)), stride=PATCH,
                     padding=PATCH_PADDING) + pe.bias.to(dt)[:, None, None]
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed.to(dt)
        x = x + pos[:, 1:] + pos[:, :1]
        for blk in self.blocks:
            x = blk(x, num)
        x = layer_norm(x, self.last_norm)
        x = x.transpose(1, 2).reshape(x.shape[0], -1, *self.grid)
        for d, g in zip(self.deconvs, self.dgns):
            x = F.relu(g(d(x, num)))
        return self.final(x, num).float()


def attn_bytes_flops(B: int, N: int, C: int) -> tuple[int, int]:
    """One attention over B crops of N tokens of width C in bfloat16: q, k
    and v read and the output written once (bytes); q k^T and the
    probabilities' product with v (FLOPs, 2 a multiply-add)."""
    return 4 * B * N * C * 2, 2 * 2 * B * N * N * C


def pose_flops(p: dict) -> int:
    """The matrix FLOPs of one crop through PoseNet (benchmark.counts's convention)."""
    h, w = token_grid(p)
    N, C, k, hidden = h * w, p["vit_width"], PATCH, p["vit_mlp_width"]
    total = 2 * 3 * p["in_frames"] * k * k * C * N                       # patch embedding
    block = 2 * N * C * 3 * C + 2 * N * C * C + 2 * 2 * N * C * hidden     # qkv, proj, MLP
    total += p["vit_depth"] * (block + attn_bytes_flops(1, N, C)[1])
    cin = C
    for ch in _head_channels(p):                                          # 4x4 stride-2 deconvs
        total += 2 * cin * ch * 16 * h * w
        h, w, cin = 2 * h, 2 * w, ch
    return total + 2 * cin * p["num_joints"] * h * w
