"""ViTPose's backbone: a plain vision transformer before the SimpleBaseline
heatmap head (Xu, Zhang, Zhang, Tao, "ViTPose: Simple Vision Transformer
Baselines for Human Pose Estimation", NeurIPS 2022; the COCO top-down
model at 256x192).  The JAX package has no counterpart.

  patch embedding   Conv2d(3, C, 16, stride 16, padding 2, bias): 16 x 12
                    tokens at 256 x 192 (PATCH and PATCH_PADDING: every
                    ViTPose variant has them)
  position          + pos_embed[:, 1:] + pos_embed[:, :1]: learned rows for
                    the tokens and a class row added to every token (no
                    class token)
  depth x block     x + proj(attn(LN1(x))), then x + fc2(GELU(fc1(LN2(x)))):
                    qkv with bias, heads of C / heads, scale (C / heads)^-0.5,
                    exact GELU, LayerNorm eps 1e-6
  last_norm         LayerNorm, tokens back to [B, C, h, w]
  head              models/pose.py's HeatmapHead at stride PATCH

Parameters are float32 and compute follows `PoseConfig.dtype` as the ResNet's
does (models/precision.py): each dense layer and the patch embedding round
input and weight to the compute dtype and add the bias after the product,
LayerNorm and GELU compute in float32 and round once, the residual and
position adds happen at the activations' dtype, attention goes through
`precision.attention` (a fused kernel on the card in bfloat16; its
probabilities rounded to the dtype before their product with v), and the
heatmaps come out float32.  A traced forward records the spans
`pose.vit.embed`, `pose.vit.blocks` and `pose.vit.head`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from golfaction_tpu_torch.config import PoseConfig
from golfaction_tpu_torch.models import precision
from golfaction_tpu_torch.models.pose import HeatmapHead
from golfaction_tpu_torch.utils.profiling import span

_LN_EPS = 1e-6
PATCH = 16
PATCH_PADDING = 2


def token_grid(cfg: PoseConfig) -> tuple[int, int]:
    """(rows, columns) of patch tokens the embedding makes of a crop."""
    return tuple((n + 2 * PATCH_PADDING - PATCH) // PATCH + 1 for n in cfg.input_hw)


class PatchEmbed(nn.Module):
    """crops [B, Cin, H, W] -> tokens [B, h * w, C] at the crops' dtype."""

    def __init__(self, cin: int, width: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, width, PATCH, PATCH, PATCH_PADDING)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.proj
        if x.dtype == p.weight.dtype:
            y = p(x)
        else:                       # the bias after the product's rounding
            y = F.conv2d(x, p.weight.to(x.dtype), stride=p.stride, padding=p.padding) \
                + p.bias.to(x.dtype)[:, None, None]
        return y.flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        qkv = precision.linear(self.qkv, x).reshape(B, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = precision.attention(q, k, v).transpose(1, 2).reshape(B, N, C)
        return precision.linear(self.proj, o)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.linear(self.fc2, F.gelu(precision.linear(self.fc1, x)))


class Block(nn.Module):
    """One pre-LN transformer block."""

    def __init__(self, width: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=_LN_EPS)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=_LN_EPS)
        self.mlp = Mlp(width, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(precision.layer_norm(x, self.norm1))
        return x + self.mlp(precision.layer_norm(x, self.norm2))


class ViTPose(HeatmapHead):
    """crops [B, H, W, 3*in_frames] (normalized, NHWC) -> heatmaps
    [B, K, Hh, Wh] float32."""

    def __init__(self, cfg: PoseConfig):
        super().__init__()
        if cfg.backbone != "vit":
            raise ValueError(f"ViTPose is pose.backbone='vit', not {cfg.backbone!r}")
        self.cfg = cfg
        self.dt = precision.compute_dtype(cfg.dtype)
        self.grid = token_grid(cfg)
        C = cfg.vit_width
        self.patch_embed = PatchEmbed(3 * cfg.in_frames, C)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.grid[0] * self.grid[1] + 1, C))
        self.blocks = nn.ModuleList(Block(C, cfg.vit_heads, cfg.vit_mlp_width)
                                    for _ in range(cfg.vit_depth))
        self.last_norm = nn.LayerNorm(C, eps=_LN_EPS)
        self._build_head(cfg, C, PATCH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("pose.vit.embed"):
            x = self.patch_embed(x.to(self.dt).permute(0, 3, 1, 2))
            pos = self.pos_embed.to(x.dtype)
            x = x + pos[:, 1:] + pos[:, :1]
        with span("pose.vit.blocks"):
            for blk in self.blocks:
                x = blk(x)
        with span("pose.vit.head"):
            x = precision.layer_norm(x, self.last_norm)
            # [B, h*w, C] -> [B, C, h, w], channels-last in memory as the
            # head's convolutions and GroupNorms take it.
            x = x.unflatten(1, self.grid).permute(0, 3, 1, 2)
            return self._heatmaps(x)
