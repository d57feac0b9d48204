"""The yardstick's counts against FlopCounterMode and hand counts at small shapes."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference import nets, pose_reference
from benchmark.tests.conftest import load


def _conf(tiny: bool):
    from benchmark.tests.conftest import tiny_pipeline
    conf = load("configs", "shipped")
    return tiny_pipeline(conf) if tiny else conf


def _stated(tiny: bool):
    return _conf(tiny)["pipeline"]


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("tiny", [True, False])
def test_pose_flops_match_flop_counter(tiny):
    pose = pose_reference(_conf(tiny))
    p = dict(_stated(tiny)["pose"], dtype="float32")
    net = pose.PoseNet(p, nets.Numerics())
    h, w = p["input_hw"]
    assert pose.pose_flops(p) == _flops(lambda: net(torch.zeros(1, h, w, 3)))


def test_pose_flops_at_the_shipped_widths():
    # 4.37 GFLOP a crop at 256 x 192 (the ResNet-18-like trunk, three deconvs).
    assert pose_reference(_conf(False)).pose_flops(_stated(False)["pose"]) == 4_371_775_488


@pytest.mark.parametrize("T", [5, 16])
def test_heads_and_encoder_flops_match_flop_counter(T):
    s = _stated(True)
    valid = torch.ones(1, T, dtype=torch.bool)
    g = nets.GCN(s["gcn"])
    assert counts.gcn_flops(s["gcn"], T) == _flops(lambda: g(torch.zeros(1, T, 17, 3), valid))
    a = nets.AlignEncoder(dict(s["align"], dtype="float32"))
    assert counts.align_flops(s["align"], T) == _flops(
        lambda: a(torch.zeros(1, T, 17, 3), valid))
    e = nets.ErrorHead(dict(s["error"], dtype="float32"))
    fd = nets.error_feature_dim(s["error"])
    assert counts.error_flops(s["error"], T, fd) == _flops(
        lambda: e(torch.zeros(1, T, 17, 3), torch.zeros(1, T, 9), valid, None,
                  torch.zeros(1, T, 17, 4)))


def test_kernel_a_bytes_ops_by_hand():
    # One box covering source pixels 0..3 x 0..2 with a 3 x 4 output: the
    # taps touch columns {0..4} (x = 0, 1, 2, 3 and +1) -> 4 in a 4-wide
    # frame, rows {0..3} -> 3 in a 3-high frame: 12 pixels, 36 bytes.
    box = torch.tensor([[1.5, 1.0, 3.0, 2.0]])
    nbytes, ops = counts.kernel_a_bytes_ops(box, H=3, W=4, oh=3, ow=4)
    assert nbytes == 12 * 3 + 3 * 4 * 3 * 4 + 4 * 4
    assert ops == 47 * 3 * 4
    # A box wholly outside the frame touches nothing.
    nbytes, _ = counts.kernel_a_bytes_ops(torch.tensor([[-50.0, -50.0, 3.0, 2.0]]), 3, 4, 3, 4)
    assert nbytes == 3 * 4 * 3 * 4 + 16


def test_kernel_b_bytes_ops_by_hand():
    nbytes, ops = counts.kernel_b_bytes_ops(B=2, T=3, V=17, C=8, weights=100)
    rows, M = 2 * 3 * 17, 8
    assert nbytes == 2 * rows * 8 * 4 + 2 * 4 + 400
    assert ops == rows * (2 * 64 + 480) + 2 * (3 + 17) * (2 * 8 * M * 2 + 10 * M) + 2 * 4 * 8 * M


def test_tail_parameters_leave_out_the_graph_conv_and_projection():
    g = nets.GCN(_stated(True)["gcn"])
    blk = g.blocks[1]
    total = sum(p.numel() for p in blk.parameters())
    assert counts.tail_parameters(blk) == total - blk.sgc.kernel.numel() \
        - blk.sgc.edge_importance.numel() - blk.proj.weight.numel()


def test_peaks_name_the_card():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    with pytest.raises(KeyError):
        counts.peaks("cpu")
