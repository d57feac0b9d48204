"""The yardstick's arithmetic: the card's peaks, the networks' FLOPs from
their shapes (the pose net's from its reference module), and the least
bytes and operations of kernels A and B.

FLOPs count each multiply-add of a matrix product or convolution as 2,
whatever implements it, and nothing else (FlopCounterMode's convention, to
which the tests hold these functions on the reference networks).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import pose_reference

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the full 700 W.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                                   "hbm_bytes": 3.35e12}}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peak figures for {kind!r}; add the card's data-sheet rates")
    return PEAKS[kind]


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def gcn_flops(g: dict, T: int) -> int:
    """One clip of T frames through the GCN."""
    V, cin, total = g["num_joints"], g["in_channels"], 0
    for ch in g["block_channels"]:
        P = 3
        total += 2 * T * V * cin * P * ch + 2 * T * P * V * V * ch      # spatial graph conv
        nb = len(g["temporal_branches"]) + 1
        cb = ch // nb
        widths = [cb + (ch - cb * nb if i == 0 else 0) for i in range(nb - 1)] + [cb]
        total += sum(2 * T * V * ch * wd for wd in widths)              # branch projections
        total += sum(2 * T * V * k * wd for (k, _), wd in zip(g["temporal_branches"], widths))
        mid = max(ch // g["channel_att_reduction"], 8)
        total += 2 * ch * mid * 2                                       # channel attention
        total += 2 * (T + V) * ch * mid + 2 * T * mid * ch + 2 * V * mid * ch   # joint attention
        if cin != ch:
            total += 2 * T * V * cin * ch
        cin = ch
    c = g["block_channels"][-1]
    return total + 2 * T * c * c + 2 * T * c * g["num_phases"]


def align_flops(a: dict, T: int) -> int:
    """One clip of T frames through the alignment encoder."""
    h = a["hidden_channels"]
    total = 2 * T * a["num_joints"] * a["in_channels"] * h[0]
    cin = h[0]
    for ch in h:
        total += 2 * T * cin * ch * a["temporal_kernel"]
        if cin != ch:
            total += 2 * T * cin * ch
        cin = ch
    return total + 2 * T * cin * a["embed_dim"]


def error_flops(e: dict, T: int, feature_dim: int) -> int:
    """One clip of T frames through the error head."""
    H, P = e["hidden_dim"], e["num_phases"]
    return 2 * T * feature_dim * H + 2 * P * T * H + 2 * P * H * H + 2 * H * e["num_errors"]


def request_flops(stated: dict, lengths, ref_frames: int, feature_dim: int) -> int:
    """The matrix FLOPs that clips of these valid lengths need: the pose net
    on each valid frame, one count for every frame from the pose reference
    module that `stated["pose_reference"]` names (benchmark.reference.
    pose_reference; Run.stated carries it), the GCN, the error head twice
    (without and with the warped reference) and the encoder on each clip at
    its own length, and the clip-by-reference distance product."""
    per_frame = pose_reference(stated).pose_flops(stated["pose"])
    total = 0
    for T in lengths:
        T = int(T)
        total += T * per_frame + gcn_flops(stated["gcn"], T)
        total += 2 * error_flops(stated["error"], T, feature_dim)
        total += align_flops(stated["align"], T)
        total += 2 * T * ref_frames * stated["align"]["embed_dim"]
    return total


# ---------------------------------------------------------------------------
# Kernels A and B: the least bytes and operations
# ---------------------------------------------------------------------------

def _taps_touched(coords: torch.Tensor, size: int) -> np.ndarray:
    """Distinct in-range source rows (or columns) the two bilinear taps of
    each box's sample coordinates [B, n] touch."""
    lo = torch.floor(coords)
    out = []
    for row in lo:
        taps = torch.cat([row, row + 1]).unique()
        out.append(int(((taps >= 0) & (taps < size)).sum()))
    return np.asarray(out, np.int64)


def kernel_a_bytes_ops(cs_boxes: torch.Tensor, H: int, W: int, oh: int, ow: int,
                       out_bytes: int = 4, ops_per_px: int = 47):
    """Crop/resize/normalize of frames [B, H, W, 3] uint8 with centre-scale
    boxes [B, 4] -> [B, oh, ow, 3]: each source pixel that a tap touches read
    once (3 bytes), the output written once, the boxes read once;
    `ops_per_px` float operations an output pixel."""
    b = cs_boxes.detach().float().cpu()
    xs = (b[:, 0] - b[:, 2] / 2)[:, None] + torch.arange(ow) * (b[:, 2] / (ow - 1))[:, None]
    ys = (b[:, 1] - b[:, 3] / 2)[:, None] + torch.arange(oh) * (b[:, 3] / (oh - 1))[:, None]
    touched = int((_taps_touched(xs, W) * _taps_touched(ys, H)).sum()) * 3
    n = b.shape[0]
    return touched + n * oh * ow * 3 * out_bytes + b.numel() * 4, float(ops_per_px) * n * oh * ow


def kernel_b_bytes_ops(B: int, T: int, V: int, C: int, weights: int):
    """One GCN block tail over x [B, T, V, C] float32: x read and the output
    written once, the lengths and `weights` (the tail's parameter count)
    read once; per row the C x C branch product once plus the layer norms'
    and branches' element work, and the gate MLPs per frame and per joint."""
    M = max(C // 4, 8)
    rows = B * T * V
    nbytes = 2 * rows * C * 4 + B * 4 + weights * 4
    gates = B * (T + V) * (2 * C * M + 2 * M * C + 10 * M) + B * 4 * C * M
    return nbytes, rows * (2 * C * C + 60 * C) + gates


def tail_parameters(block: torch.nn.Module) -> int:
    """The parameters a GCN block's tail reads: all of the block's but the
    spatial graph conv and the residual projection."""
    return int(sum(p.numel() for n, p in block.named_parameters()
                   if not n.startswith(("sgc.", "proj."))))
