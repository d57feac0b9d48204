"""Top-down heatmap pose-estimation model (SimpleBaseline family).

ResNet-style backbone with GroupNorm plus a transposed-conv head, one
heatmap per COCO-17 joint.  Input crops are NHWC like the JAX package's;
the convolutions run NCHW.  Padding reproduces flax's "SAME" rule
(pad_total = max((ceil(n/s) - 1) * s + k - n, 0), low side gets the
floor half), and GroupNorm uses flax's epsilon 1e-6.

`PoseConfig.dtype` sets the compute dtype as flax's does
(models/precision.py); the heatmaps come out float32 either way, so the
decode sees float32.  Each GroupNorm goes with the ReLU (and the residual
add) after it through `precision.group_norm_act`: in bfloat16 on the card
one launch of kernel G, on the activations' channels-last memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from golfaction_tpu_torch.config import PoseConfig
from golfaction_tpu_torch.models.precision import GroupNorm, compute_dtype, group_norm_act

_GN_EPS = 1e-6


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    ph = _same_pads(x.shape[-2], k, s)
    pw = _same_pads(x.shape[-1], k, s)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


class SameConv2d(nn.Conv2d):
    """Bias-free Conv2d with flax SAME padding (square kernel), at x's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, bias=False)

    def forward(self, x):
        return self._conv_forward(_pad_same(x, self.kernel_size[0], self.stride[0]),
                                  self.weight.to(x.dtype), None)


class Deconv2d(nn.ConvTranspose2d):
    """Bias-free 4x4 stride-2 transposed conv (flax SAME), at x's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 4, 2, padding=1, bias=False)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), stride=2, padding=1)


class Project(nn.Conv2d):
    """The 1x1 heatmap projection at x's dtype; below float32 the bias is
    added after the product's rounding, as flax adds it."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x):
        if x.dtype == torch.float32:
            return super().forward(x)
        return F.conv2d(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)[:, None, None]


def _gn(ch: int) -> GroupNorm:
    return GroupNorm(min(32, ch), ch, eps=_GN_EPS)


class ResBlock(nn.Module):
    """Basic 3x3 residual block; 1x1 projection when width or stride change."""

    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(cin, channels, 3, stride)
        self.gn1 = _gn(channels)
        self.conv2 = SameConv2d(channels, channels, 3)
        self.gn2 = _gn(channels)
        self.proj = None
        if cin != channels or stride != 1:
            self.proj = SameConv2d(cin, channels, 1, stride)
            self.gn3 = _gn(channels)

    def forward(self, x):
        y = self.conv2(group_norm_act(self.conv1(x), self.gn1))
        if self.proj is None:
            return group_norm_act(y, self.gn2, residual=x)
        return group_norm_act(y, self.gn2, residual_gn=self.gn3, residual_x=self.proj(x))


class PoseNet(nn.Module):
    """crops [B, H, W, 3*in_frames] (normalized, NHWC) -> heatmaps
    [B, K, Hh, Wh] float32."""

    def __init__(self, cfg: PoseConfig = PoseConfig()):
        super().__init__()
        self.cfg = cfg
        self.dt = compute_dtype(cfg.dtype)
        self.stem = SameConv2d(3 * cfg.in_frames, 64, 7, 2)
        self.gn0 = _gn(64)
        blocks, cin = [], 64
        for i, (nb, ch) in enumerate(zip(cfg.stage_blocks, cfg.stage_channels)):
            for b in range(nb):
                blocks.append(ResBlock(cin, ch, 2 if (b == 0 and i > 0) else 1))
                cin = ch
        self.blocks = nn.ModuleList(blocks)
        # SimpleBaseline head, then extra deconvs until heatmap resolution.
        head = list(cfg.deconv_channels)
        stride = 4 * 2 ** (len(cfg.stage_blocks) - 1) // (2 ** len(cfg.deconv_channels))
        target = cfg.input_hw[0] // cfg.heatmap_hw[0]
        n_extra = 0
        while stride > target:
            n_extra += 1
            stride //= 2
        head += [cfg.deconv_channels[-1]] * n_extra
        deconvs, gns = [], []
        for i, ch in enumerate(head):
            deconvs.append(Deconv2d(cin, ch))
            # The extra deconvs' GroupNorm always takes 32 groups.
            gns.append(_gn(ch) if i < len(cfg.deconv_channels)
                       else GroupNorm(32, ch, eps=_GN_EPS))
            cin = ch
        self.deconvs = nn.ModuleList(deconvs)
        self.dgns = nn.ModuleList(gns)
        self.final = Project(cin, cfg.num_joints)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dt).permute(0, 3, 1, 2)
        x = group_norm_act(self.stem(x), self.gn0)
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for blk in self.blocks:
            x = blk(x)
        for d, g in zip(self.deconvs, self.dgns):
            x = group_norm_act(d(x), g)
        # float32 heatmaps for the decode (golfaction_tpu/models/pose.py:110-111).
        return self.final(x).float()
