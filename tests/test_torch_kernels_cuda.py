"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (the kernels have no CPU mode) and skips
without one; run them on a machine with the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

float32 throughout (the configs pin dtype="float32", the dtype their limits
were set for), with TF32 off for matmuls and convolutions, so the
tolerances only absorb reduction order; the bfloat16 tests at the end say
their own limits.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.models.gcn import GCNBlock
from golfaction_tpu_torch.ops import _kernels, affine, gcn_tail, heatmap, preprocess, softdtw
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.types import Skeleton

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _frames_boxes(rng, b, h, w):
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    boxes = np.stack([rng.uniform(-0.1 * w, 1.1 * w, b), rng.uniform(-0.1 * h, 1.1 * h, b),
                      rng.uniform(0.1 * w, 0.8 * w, b), rng.uniform(0.2 * h, 1.2 * h, b)],
                     axis=-1).astype(np.float32)
    return frames, boxes


# The main path's shape, B = 1, and output widths off a multiple of 4 (the
# kernel's scalar-store path).
@pytest.mark.parametrize("b,h,w,oh,ow", [(3, 120, 160, 64, 48), (8, 1080, 1920, 256, 192),
                                         (1, 1080, 1920, 256, 192), (2, 90, 130, 33, 31),
                                         (1, 64, 64, 17, 5), (5, 200, 300, 40, 36)])
def test_preprocess_kernel_matches_plain(dev, b, h, w, oh, ow):
    frames, boxes = _frames_boxes(np.random.default_rng(b), b, h, w)
    f = torch.from_numpy(frames).to(dev)
    bx = torch.from_numpy(boxes).to(dev)
    n0 = preprocess.crop_resize_normalize.launches
    got = preprocess.crop_resize_normalize(f, bx, (oh, ow))
    want = preprocess.crop_resize_normalize_reference(f, bx, (oh, ow))
    torch.cuda.synchronize()
    assert preprocess.crop_resize_normalize.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    again = preprocess.crop_resize_normalize(f, bx, (oh, ow))
    assert torch.equal(got, again)                        # two runs, the same bits


@pytest.mark.parametrize("kind", ["upscaled", "outside", "far", "one_px"])
@pytest.mark.parametrize("oh,ow", [(64, 48), (33, 31)])
def test_preprocess_kernel_takes_odd_boxes(dev, kind, oh, ow):
    """A small box blown up to the output size, boxes that lie wholly outside
    the frame (normalized zero), boxes too far off for an int, 1 px boxes."""
    rng = np.random.default_rng(7)
    h, w, b = 120, 160, 4
    frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
    boxes = {"upscaled": [[80.3, 60.7, 9.0, 12.0], [10.0, 10.0, 4.0, 4.0], [150.0, 110.0, 6.5, 3.2],
                          [80.0, 60.0, 2.0, 2.0]],
             "outside": [[-300.0, 60.0, 50.0, 50.0], [500.0, 500.0, 30.0, 40.0],
                         [80.0, -200.0, 60.0, 90.0], [80.0, 400.0, 10.0, 10.0]],
             "far": [[5e6, -3e7, 20.0, 30.0], [-1e9, 1e9, 1e3, 1e3], [3e9, 3e9, 1.0, 1.0],
                     [1e12, 0.0, 5.0, 5.0]],
             "one_px": [[80.0, 60.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0], [159.0, 119.0, 1.0, 1.0],
                        [80.5, 60.5, 1.0, 0.5]]}[kind]
    bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
    got = preprocess.crop_resize_normalize(frames, bx, (oh, ow))
    want = preprocess.crop_resize_normalize_reference(frames, bx, (oh, ow))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4)
    if kind in ("outside", "far"):
        zero = -np.asarray(preprocess.IMAGENET_MEAN, np.float32) / np.asarray(
            preprocess.IMAGENET_STD, np.float32)
        np.testing.assert_allclose(got.cpu().numpy(), np.broadcast_to(zero, got.shape), atol=1e-6)


# The bfloat16 variant: its plain version on the same card computes the same
# operations one by one (divisions by tensors, each rounding where JAX's
# bfloat16 warp rounds), so the two are held equal to the bit.
@pytest.mark.parametrize("b,h,w,oh,ow", [(3, 120, 160, 64, 48), (8, 1080, 1920, 256, 192),
                                         (2, 90, 130, 33, 31), (1, 64, 64, 17, 5),
                                         (5, 200, 300, 40, 36)])
def test_preprocess_bf16_kernel_matches_plain(dev, b, h, w, oh, ow):
    frames, boxes = _frames_boxes(np.random.default_rng(b), b, h, w)
    f = torch.from_numpy(frames).to(dev)
    bx = torch.from_numpy(boxes).to(dev)
    n0 = preprocess.crop_resize_normalize_bf16.launches
    n32 = preprocess.crop_resize_normalize.launches
    got = preprocess.crop_resize_normalize(f, bx, (oh, ow), dtype=torch.bfloat16)
    want = preprocess.crop_resize_normalize_bf16_reference(f, bx, (oh, ow))
    torch.cuda.synchronize()
    assert preprocess.crop_resize_normalize_bf16.launches == n0 + 1
    assert preprocess.crop_resize_normalize.launches == n32
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, oh, ow, 3)
    assert torch.equal(got, want)
    # The CPU's plain version gives the same bits.
    cpu = preprocess.crop_resize_normalize_bf16_reference(f.cpu(), bx.cpu(), (oh, ow))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("kind", ["upscaled", "outside", "far", "one_px", "unit_corner"])
@pytest.mark.parametrize("oh,ow", [(64, 48), (33, 31)])
def test_preprocess_bf16_kernel_takes_odd_boxes(dev, kind, oh, ow):
    """The float32 kernel's odd boxes, and boxes whose sample coordinates all
    lie in [-1, 1), around the frame's first pixel."""
    rng = np.random.default_rng(7)
    h, w, b = 120, 160, 4
    frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
    boxes = {"upscaled": [[80.3, 60.7, 9.0, 12.0], [10.0, 10.0, 4.0, 4.0], [150.0, 110.0, 6.5, 3.2],
                          [80.0, 60.0, 2.0, 2.0]],
             "outside": [[-300.0, 60.0, 50.0, 50.0], [500.0, 500.0, 30.0, 40.0],
                         [80.0, -200.0, 60.0, 90.0], [80.0, 400.0, 10.0, 10.0]],
             "far": [[5e6, -3e7, 20.0, 30.0], [-1e9, 1e9, 1e3, 1e3], [3e9, 3e9, 1.0, 1.0],
                     [1e12, 0.0, 5.0, 5.0]],
             "one_px": [[80.0, 60.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0], [159.0, 119.0, 1.0, 1.0],
                        [80.5, 60.5, 1.0, 0.5]],
             "unit_corner": [[0.0, 0.0, 1.0, 1.0], [0.05, -0.1, 0.7, 0.9], [-0.3, 0.2, 0.5, 0.4],
                             [1e-8, 1e-8, 1e-8, 1e-8]]}[kind]
    bx = torch.tensor(boxes, dtype=torch.float32, device=dev)
    got = preprocess.crop_resize_normalize(frames, bx, (oh, ow), dtype=torch.bfloat16)
    want = preprocess.crop_resize_normalize_bf16_reference(frames, bx, (oh, ow))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, want)
    if kind in ("outside", "far"):
        zero = -torch.tensor(preprocess.IMAGENET_MEAN) / torch.tensor(preprocess.IMAGENET_STD)
        assert torch.equal(got.cpu(), zero.to(torch.bfloat16).expand_as(got.cpu()))


# The variant's divisions (a reciprocal and one correction) against IEEE
# division over every 101st float32 of their domains; chip_smoke.py
# enumerates every float of them.
@pytest.mark.parametrize("channel", [None, 0, 1, 2])
def test_preprocess_bf16_divisions_are_ieee_division(dev, channel):
    if channel is None:
        bad, n = preprocess.division_mismatches(0.0, 255.0, 255.0, False, stride=101)
    else:
        m = np.float32(preprocess.IMAGENET_MEAN[channel])
        bad, n = preprocess.division_mismatches(float(-m), float(np.float32(1) - m),
                                                preprocess.IMAGENET_STD[channel], True,
                                                stride=101)
    assert n > 10 ** 7 and bad == 0


@pytest.mark.parametrize("seed", range(4))
def test_preprocess_bf16_division_by_other_stds_is_ieee_division(dev, seed):
    """Other means and stds inside what the host lets through."""
    rng = np.random.default_rng(seed)
    m, sd = np.float32(rng.uniform(-2, 2)), float(np.exp(rng.uniform(-5, 3)))
    bad, n = preprocess.division_mismatches(float(min(-m, 0)), float(np.float32(1) - m), sd,
                                            True, stride=1009)
    assert n > 10 ** 4 and bad == 0


def test_preprocess_bf16_kernel_takes_other_normalization(dev):
    frames, boxes = _frames_boxes(np.random.default_rng(4), 3, 120, 160)
    f, bx = torch.from_numpy(frames).to(dev), torch.from_numpy(boxes).to(dev)
    norm = dict(mean=(0.5, 0.0, -0.25), std=(0.3, 1.7, 0.05))
    got = preprocess.crop_resize_normalize(f, bx, (64, 48), dtype=torch.bfloat16, **norm)
    want = preprocess.crop_resize_normalize_bf16_reference(f, bx, (64, 48), **norm)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for bad in (dict(mean=(0.5, 0.5, 0.5), std=(0.2, -0.2, 0.2)),
                dict(mean=(1e-45, 0.5, 0.5), std=(0.2, 0.2, 0.2))):
        with pytest.raises(ValueError, match="division"):
            preprocess.crop_resize_normalize(f, bx, (64, 48), dtype=torch.bfloat16, **bad)


def _random_block(C, cin, seed):
    blk = GCNBlock(cin, C, tcfg.GCNConfig(), np.ones((3, 17, 17), np.float32))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    return blk


def _ragged_lengths(B, T):
    """Valid lengths for B clips: full, empty, one frame, and in between."""
    return ([T, 0, 1, T - 5, T // 2, T, 3, T - 1] * 2)[:B] if T > 5 else ([T, 0, 1] * 3)[:B]


@pytest.mark.parametrize("C", [16, 64, 128, 256])
@pytest.mark.parametrize("T", [16, 37, 64, 128, 512])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_gcn_tail_kernel_matches_plain(dev, C, T, B):
    tail = _random_block(C, C, C + T).pack().to(dev)
    gen = torch.Generator().manual_seed(T)
    x = torch.randn((B, T, 17, C), generator=gen).to(dev)
    la = torch.tensor(_ragged_lengths(B, T), dtype=torch.int32, device=dev)
    n0 = gcn_tail.gcn_block_tail.launches
    got = gcn_tail.gcn_block_tail(x, la, tail)
    want = gcn_tail.gcn_block_tail_plain(x, la, tail)
    torch.cuda.synchronize()
    assert gcn_tail.gcn_block_tail.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=1e-4)
    masked = torch.arange(T, device=dev)[None, :] >= la[:, None]
    assert not bool(got[masked].any())                    # padded frames stay zero
    again = gcn_tail.gcn_block_tail(x, la, tail)
    assert torch.equal(got, again)                        # two runs, the same bits


@pytest.mark.parametrize("C,T,B", [(8, 5, 1), (24, 20, 2), (25, 9, 2), (100, 33, 2), (72, 3, 3)])
def test_gcn_tail_kernel_takes_widths_off_the_mma_tile(dev, C, T, B):
    """C off a multiple of 8 or 16 (zero padding in the packed fragments), off
    a multiple of 4 (scalar loads and stores), clips shorter than the taps reach."""
    tail = _random_block(C, C, C).pack().to(dev)
    x = torch.randn((B, T, 17, C), generator=torch.Generator().manual_seed(C)).to(dev)
    la = torch.tensor(_ragged_lengths(B, T), dtype=torch.int32, device=dev)
    got = gcn_tail.gcn_block_tail(x, la, tail)
    want = gcn_tail.gcn_block_tail_plain(x, la, tail)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3, rtol=1e-4)


def test_gcn_tail_kernel_on_the_shipped_weights(dev):
    """All six widths of the shipped GCN, ragged lengths, the kernel's limit."""
    pipe = Pipeline.from_artifacts(str(ROOT / "artifacts"), device="cuda")
    gen = torch.Generator().manual_seed(0)
    la = torch.tensor([64, 55, 23, 0], dtype=torch.int32, device=dev)
    for blk in pipe.gcn_model.blocks:
        x = torch.randn((4, 64, 17, blk.tail.C), generator=gen).to(dev)
        got = gcn_tail.gcn_block_tail(x, la, blk.tail)
        want = gcn_tail.gcn_block_tail_plain(x, la, blk.tail)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-3)


# (96, 48, 48): one train_align step; (4, 512, 512): two warps a table and the
# register ring (the table does not fit in shared memory); (301, 20, 24):
# several tables a block, the last block short; (2, 600, 20): three warps.
@pytest.mark.parametrize("B,Ta,Tb", [(3, 7, 11), (8, 64, 64), (8, 128, 64), (2, 600, 20),
                                     (96, 48, 48), (4, 512, 512), (301, 20, 24)])
@pytest.mark.parametrize("gamma", [0.1, 0.0])
def test_wavefront_kernel_matches_plain(dev, B, Ta, Tb, gamma):
    rng = np.random.default_rng(Ta * Tb)
    a = torch.from_numpy(rng.normal(size=(B, Ta, 16)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.normal(size=(B, Tb, 16)).astype(np.float32)).to(dev)
    D = softdtw.pairwise_sqdist(a, c).contiguous()
    n0 = softdtw.wavefront.launches
    got = softdtw.wavefront(D, gamma)
    want = softdtw.wavefront_plain(D, gamma)
    torch.cuda.synchronize()
    assert softdtw.wavefront.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    if gamma == 0.0:
        la = torch.full((B,), Ta, dtype=torch.int32)
        lb = torch.full((B,), Tb, dtype=torch.int32)
        pg, lg = softdtw._backtrack(got, la, lb)
        pw, lw = softdtw._backtrack(want, la, lb)
        assert torch.equal(pg.cpu(), pw.cpu()) and torch.equal(lg.cpu(), lw.cpu())


@pytest.mark.parametrize("H,W", [(64, 48), (16, 12), (5, 7)])
def test_decode_kernel_matches_plain(dev, H, W):
    import chip_smoke

    rng = np.random.default_rng(H * W)
    rand = rng.normal(size=(40, H, W)).astype(np.float32)
    smooth = np.stack([np.exp(-((np.mgrid[0:H, 0:W][1] - rng.uniform(0, W - 1)) ** 2
                                + (np.mgrid[0:H, 0:W][0] - rng.uniform(0, H - 1)) ** 2) / 8.0)
                       for _ in range(40)]).astype(np.float32)
    hm = torch.from_numpy(np.concatenate([chip_smoke.decode_edge_rows(H, W), rand, smooth])).to(dev)
    n0 = heatmap.decode_heatmaps.launches
    got = heatmap.decode_heatmaps(hm, "udp")
    want = heatmap.decode_heatmaps_plain(hm, "udp")
    torch.cuda.synchronize()
    assert heatmap.decode_heatmaps.launches == n0 + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    # Integer peak and score exact; x, y within 1e-4 px (logf and the
    # Taylor step round the same way on the card, so they are equal there).
    np.testing.assert_array_equal(np.round(got[:, :2]), np.round(want[:, :2]))
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4)
    assert got[0].tolist() == [0.0, 0.0, 0.0]                 # all zeros -> (0, 0)
    assert (np.round(got[1, 0]), np.round(got[1, 1])) == (W // 2, H // 3)   # first of a tie


@pytest.mark.parametrize("B,Ta,Tb", [(3, 7, 11), (96, 48, 48), (8, 128, 64), (2, 600, 20)])
def test_softdtw_backward_kernel_matches_plain(dev, B, Ta, Tb):
    rng = np.random.default_rng(Ta * Tb)
    a = torch.from_numpy(rng.normal(size=(B, Ta, 16)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.normal(size=(B, Tb, 16)).astype(np.float32)).to(dev)
    a, c = (torch.nn.functional.normalize(t, dim=-1) for t in (a, c))
    D = softdtw.pairwise_sqdist(a, c).contiguous()
    R = softdtw.wavefront(D, 0.1)
    n0 = softdtw.softdtw_backward.launches
    got = softdtw.softdtw_backward(D, R, 0.1)
    want = softdtw.softdtw_backward_plain(D, R, 0.1)
    torch.cuda.synchronize()
    assert softdtw.softdtw_backward.launches == n0 + 1
    # float32 products of up to Ta+Tb weights: relative error grows with the
    # path length, so rtol 1e-4 with a floor at 1e-6 of the largest entry.
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-6 * float(want.abs().max()))
    Dg = D.clone().requires_grad_()
    (g,) = torch.autograd.grad(softdtw.softdtw_cost(Dg[:, :, :], 0.1).sum(), Dg)
    assert softdtw.softdtw_backward.launches == n0 + 2
    np.testing.assert_array_equal(g.cpu().numpy(), got.cpu().numpy())


def _bwd_inputs(B, Ta, Tb, dev, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(B, Ta, 16)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(B, Tb, 16)).astype(np.float32))
    a, c = (torch.nn.functional.normalize(t, dim=-1).to(dev) for t in (a, c))
    D = softdtw.pairwise_sqdist(a, c).contiguous()
    if B > 1 and Ta > 2 and Tb > 2:
        D[0, Ta - 2:, :] = 1e10                       # a padded tail: the corner is INF
        D[-1, Ta // 2, :Tb - 1] = 1e10                # INF cells inside the table
    return D


# Kernel E's layouts (ops/softdtw.py backward_geometry): one launch at
# (96, 48, 48), (5, 7, 3), (1, 1, 1), (4, 64, 64), (1, 65, 65) (231,968 bytes
# of shared memory) and (600, 48, 48) (two tables a block, the last block
# short); the weights through device memory and a ring of 8 diagonals at
# (8, 128, 64), (200, 300, 17) and (2, 600, 20) (three warps a table); a
# ring of 2 at (1, 3000, 5) (12 warps); Ta > 8192 through the transposed
# problem at (1, 8200, 3).
# The long tables at one gamma: their plain version takes seconds.
@pytest.mark.parametrize("B,Ta,Tb,gamma", [
    (B, Ta, Tb, g) for B, Ta, Tb in ((96, 48, 48), (5, 7, 3), (1, 1, 1), (4, 64, 64), (1, 65, 65),
                                     (600, 48, 48), (8, 128, 64), (200, 300, 17), (2, 600, 20))
    for g in (0.1, 1.0)] + [(1, 3000, 5, 0.1), (1, 8200, 3, 0.1)])
def test_softdtw_backward_layouts_match_plain(dev, B, Ta, Tb, gamma):
    D = _bwd_inputs(B, Ta, Tb, dev, seed=Ta + Tb + B)
    R = softdtw.wavefront_plain(D, gamma) if Ta > 8192 else softdtw.wavefront(D, gamma)
    n0 = softdtw.softdtw_backward.launches
    got = softdtw.softdtw_backward(D, R, gamma)
    want = softdtw.softdtw_backward_plain(D, R, gamma)
    torch.cuda.synchronize()
    assert softdtw.softdtw_backward.launches == n0 + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(softdtw.softdtw_backward(D, R, gamma), got)       # two runs, same bits
    if Ta <= 8192:
        g = softdtw.backward_geometry(B, Ta, Tb)
        if g.fits:
            # The same weights and chain through device memory and the ring.
            ring = softdtw.launch_backward(D, R, gamma, g._replace(fits=False, ring=8, smem=0))
            assert torch.equal(ring, got)
        # A view 4 bytes off a 16-byte boundary takes the scalar copies.
        flat = torch.empty(2 * D.numel() + 2, device=dev)
        Do, Ro = flat[1:D.numel() + 1].view_as(D), flat[D.numel() + 2:].view_as(D)
        Do.copy_(D)
        Ro.copy_(R)
        assert torch.equal(softdtw.softdtw_backward(Do, Ro, gamma), got)


@pytest.mark.parametrize("B,Ta,Tb", [(96, 48, 48), (3, 20, 31), (2, 300, 40)])
def test_softdtw_cost_gradient_on_card_matches_cpu(dev, B, Ta, Tb):
    D = _bwd_inputs(B, Ta, Tb, torch.device("cpu"), seed=B * Ta)
    weights = torch.linspace(0.5, 1.5, B)
    grads = {}
    for name in ("cpu", "cuda"):
        Dg = D.to(name).clone().requires_grad_()
        (softdtw.softdtw_cost(Dg, 0.1) * weights.to(name)).sum().backward()
        grads[name] = Dg.grad.cpu()
    np.testing.assert_allclose(grads["cuda"].numpy(), grads["cpu"].numpy(), rtol=1e-4,
                               atol=1e-6 * float(grads["cpu"].abs().max()))


def test_compare_mode_runs_are_bit_equal(dev):
    """Two compare-mode analyze_batch runs on the same clips give the same
    bits: no output of the port depends on the order of float atomics
    (warp_by_path sums in path order).  cuDNN is held to deterministic
    algorithms: its default choice for a convolution may accumulate with
    atomics (chip_smoke.py's `compare_determinism` reports where)."""
    import chip_smoke

    rng = np.random.default_rng(5)
    clips = [rng.integers(0, 256, (n, 96, 128, 3), dtype=np.uint8) for n in (14, 20, 9)]
    ref_kpts = np.concatenate([rng.uniform(20, 100, (16, 17, 2)),
                               rng.uniform(0.2, 1.0, (16, 17, 1))], -1).astype(np.float32)
    pipe = Pipeline(_small_cfg(), device="cuda", seed=0)
    ref = Skeleton(keypoints=torch.from_numpy(ref_kpts).to(dev),
                   valid=torch.ones(16, dtype=torch.bool, device=dev))
    torch.backends.cudnn.deterministic = True
    try:
        runs = [pipe.analyze_batch(clips, reference=ref) for _ in range(2)]
    finally:
        torch.backends.cudnn.deterministic = False
    assert chip_smoke.differing_fields(runs) == []


@pytest.mark.parametrize("gamma", [0.1, 0.0])
def test_wavefront_staged_and_ring_paths_agree(dev, gamma):
    rng = np.random.default_rng(7)
    for B, Ta, Tb in ((4, 64, 64), (2, 600, 20), (3, 33, 70)):
        D = torch.from_numpy(rng.uniform(0, 4, (B, Ta, Tb)).astype(np.float32)).to(dev)
        g = softdtw.wavefront_geometry(B, Ta, Tb)
        assert g.staged
        ring = softdtw.launch_wavefront(D, gamma, g._replace(staged=False, smem=0))
        assert torch.equal(softdtw.wavefront(D, gamma), ring)
        # A view 4 bytes off a 16-byte boundary takes the scalar copies.
        flat = torch.empty(D.numel() + 1, device=dev)
        off = flat[1:].view(B, Ta, Tb)
        off.copy_(D)
        assert torch.equal(softdtw.wavefront(off, gamma), ring)


def test_quick_division_is_ieee_division_for_every_float(dev):
    """Kernel C divides by gamma with a reciprocal and one FMA correction
    where the dividend is 0 or within [2^-60, 2^60]; over every float32 bit
    pattern, at the shipped gamma, at the ends of the range gamma may take and
    at random gammas, the quotient is the IEEE quotient."""
    check = _kernels.bind("softdtw", "softdtw_division_check", "iifpp")
    rng = np.random.default_rng(11)
    gammas = [0.1, 0.05, 1.0, 1.0 / 3.0, 7.7, 2.0 ** -40, 2.0 ** 40, 0.0999999940395]
    gammas += list(np.exp(rng.uniform(-6, 4, 8)))
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    for gamma in gammas:
        for first in (0, 1 << 31):                       # positive, then negative x
            assert check(first, (1 << 31) - 1, float(np.float32(gamma)), _kernels.ptr(bad),
                         _kernels.stream_of(bad)) == 0
    torch.cuda.synchronize()
    assert int(bad) == 0
    assert check(0, 16, 1e20, _kernels.ptr(bad), _kernels.stream_of(bad)) == 1   # out of range


def test_kernel_geometry_agrees_with_python(dev):
    from golfaction_tpu_torch.ops import requant

    layout = _kernels.bind("requant", "requant_layout", "iiiiiip")
    buf = (ctypes.c_int * 3)()
    for N, R, C, G in ((64, 12288, 64, 32), (64, 3072, 128, 32), (64, 48, 512, 32),
                       (1, 49152, 64, 32), (2, 35, 12, 4), (3, 9, 1024, 32), (2, 40, 6, 3),
                       (2, 7, 1023, 1)):
        for mode in (0, 1, 2):
            for out_int8 in (True, False):
                for max_cluster in (16, 8):
                    g = requant.launch_geometry(N, R, C, G, mode, out_int8, max_cluster=max_cluster)
                    assert layout(C, G, mode, g.wa, g.rpb, int(g.staged),
                                  ctypes.cast(buf, ctypes.c_void_p)) == 0
                    assert (buf[0], buf[1], buf[2]) == (g.threads, g.rpi, g.smem)
    max_cluster, sms, l2 = requant.card_limits(dev)
    props = torch.cuda.get_device_properties(dev)
    assert max_cluster in (8, 16)
    assert (sms, l2) == (props.multi_processor_count, props.L2_cache_size)
    smem = _kernels.bind("softdtw", "softdtw_wavefront_smem", "iiiii")
    for B, Ta, Tb in ((4, 64, 64), (96, 48, 48), (2, 600, 20), (4, 512, 512), (600, 30, 31)):
        g = softdtw.wavefront_geometry(B, Ta, Tb)
        assert smem(Ta, Tb, g.warps, g.tables, int(g.staged)) == g.smem
    bwd_smem = _kernels.bind("softdtw_bwd", "softdtw_backward_smem", "iiiiiii")
    bwd_blocks = _kernels.bind("softdtw_bwd", "softdtw_backward_blocks_per_sm", "iiiiiii")
    for B, Ta, Tb in ((96, 48, 48), (4, 64, 64), (1, 65, 65), (600, 48, 48), (8, 128, 64),
                      (2, 600, 20), (1, 3000, 5), (1, 8192, 3), (1, 1, 1)):
        g = softdtw.backward_geometry(B, Ta, Tb)
        args = (Ta, Tb, g.rows, g.warps, g.tables, int(g.fits), g.ring)
        assert bwd_smem(*args) == g.smem
        assert bwd_blocks(*args) >= 1


def test_tail_weight_layout_agrees_with_the_kernel(dev):
    total = _kernels.bind("gcn_tail", "gcn_tail_layout_total", "ii")
    smem = _kernels.bind("gcn_tail", "gcn_tail_smem", "iiii")
    for C, M in ((16, 8), (64, 16), (256, 64), (25, 8), (100, 25)):
        assert total(C, M) == gcn_tail.tail_layout(C, M)["_total"][0]
        # The shared memory each pass asks for, as the wrapper computes it.
        assert smem(0, C, 17, M) == gcn_tail.rows_smem(C)
        assert smem(1, C, 17, M) == gcn_tail.taps_smem(C, 17)
        assert smem(2, C, 17, M) == gcn_tail.gates_smem(C, M)


def test_kernels_refuse_bad_inputs(dev):
    with pytest.raises(ValueError):
        preprocess.crop_resize_normalize(torch.zeros((1, 8, 8, 3), device=dev),
                                         torch.zeros((1, 4), device=dev), (4, 4))
    with pytest.raises(ValueError):
        softdtw.wavefront(torch.zeros((1, 4, 4), dtype=torch.float64, device=dev), 0.1)
    D = torch.zeros((2, 4, 6), device=dev)
    with pytest.raises(ValueError):
        softdtw.softdtw_backward(D.transpose(1, 2), D.transpose(1, 2), 0.1)   # strided
    with pytest.raises(ValueError):
        softdtw.softdtw_cost(D, 0.0)
    tail = _random_block(16, 16, 0).pack().to(dev)
    with pytest.raises(ValueError):
        gcn_tail.gcn_block_tail(torch.zeros((1, 4, 17, 16), device=dev),
                                torch.ones((1,), dtype=torch.int64, device=dev), tail)


def _small_cfg(decode_tracking: int = 0, dtype: str = "float32", clip_batch: int = 8):
    # Single-peak decode by default: random weights on noise frames give
    # heatmaps whose modes nearly tie, and a tracked decode turns float noise
    # in them into jumps between modes (test_tracked_decode_gap_is_heatmap_noise).
    # The shipped tracked decode is held against the CPU with trained weights
    # in test_shipped_pipeline_on_card_matches_cpu.
    return tcfg.PipelineConfig(
        pose=tcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
                             stage_channels=(8, 16, 32), deconv_channels=(16, 16),
                             decode_tracking=decode_tracking, track_suppress_radius=2.0,
                             dtype=dtype),
        gcn=tcfg.GCNConfig(block_channels=(16, 32), temporal_branches=((3, 1), (3, 2)),
                           dtype=dtype),
        align=tcfg.AlignConfig(embed_dim=16, hidden_channels=(8, 16), dtype=dtype),
        error=tcfg.ErrorConfig(hidden_dim=32, dtype=dtype),
        frame_batch=8, length_buckets=(16, 32), clip_batch=clip_batch)


def test_tracked_decode_gap_is_heatmap_noise(dev):
    """Random-weight heatmaps on both devices, and the tracked decode (top-k
    modes, then Viterbi) of each.  The decode ops agree across devices when
    fed the same heatmaps; the heatmaps themselves differ only by float
    noise; so any gap between the two full decodes is that noise moved
    across a near-tie of modes, not a fault of the ops on the card."""
    cfg = _small_cfg(decode_tracking=4)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2 * 16, 96, 128, 3), dtype=np.uint8)
    boxes = np.tile(np.float32([64, 48, 50, 80]), (2 * 16, 1))
    hms = {}
    for name in ("cpu", "cuda"):
        pipe = Pipeline(cfg, device=name, seed=0)
        bx = affine.box_to_center_scale(torch.from_numpy(boxes).to(pipe.device), 48 / 64)
        with torch.no_grad():
            crops = preprocess.crop_resize_normalize(
                torch.from_numpy(frames).to(pipe.device), bx.contiguous(), (64, 48))
            hms[name] = pipe.pose_model(crops)

    def decode(hm):
        modes = heatmap.topk_modes(hm, k=4, suppress_radius=2.0)            # [32, V, 4, 3]
        seq = modes.reshape(2, 16, *modes.shape[1:]).transpose(0, 1)
        return modes, heatmap.viterbi_track(seq, lam=cfg.pose.track_lambda)

    hm_gap = float((hms["cuda"].cpu() - hms["cpu"]).abs().max() / hms["cpu"].abs().max())
    modes_g, track_g = decode(hms["cuda"])
    modes_gc, track_gc = decode(hms["cuda"].cpu())           # the card's maps, on the CPU
    _, track_c = decode(hms["cpu"])
    same_maps_gap = float((track_g.cpu() - track_gc).abs().max())
    full_gap = (track_g.cpu() - track_c)[..., :2].abs()
    print(f"tracked decode, random weights: heatmap gap {hm_gap:.3e} of the largest value, "
          f"same-heatmap decode gap {same_maps_gap:.3e} px, full-path elements > 1 px apart "
          f"{int((full_gap > 1).sum())} of {full_gap.numel()} (max {float(full_gap.max()):.3f})")
    assert hm_gap <= 1e-4
    np.testing.assert_allclose(modes_g.cpu().numpy(), modes_gc.numpy(), atol=1e-4)
    np.testing.assert_allclose(track_g.cpu().numpy(), track_gc.numpy(), atol=1e-4)


def _assert_outputs_match(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], atol=1e-2)
    np.testing.assert_allclose(got["phase_logits"], want["phase_logits"], atol=1e-3)
    np.testing.assert_allclose(got["error_probs"], want["error_probs"], atol=1e-4)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-4)
    for k in ("phase_labels", "path", "path_length"):
        np.testing.assert_array_equal(got[k], want[k])


def test_shipped_pipeline_on_card_matches_cpu(dev):
    """The shipped model (trained weights, tracked decode, mode features,
    compare mode) on two short rendered swings, card against CPU.  The pose
    network's heatmaps agree to float noise; everything after it (tracked
    decode, GCN with kernel B, alignment with kernel C, error head) is held
    to the CPU on the same heatmaps: the card's, fed to the CPU's program.
    Two independent runs may still pick different modes where two nearly
    tie; the test prints how many keypoints that moved."""
    import chip_smoke

    rng = np.random.default_rng(3)
    kps = [chip_smoke.swing_keypoints(16, rng) for _ in range(3)]
    clips = [chip_smoke.render_clip(k, seed=10 + i) for i, k in enumerate(kps[:2])]
    boxes = [chip_smoke.boxes_of(k) for k in kps[:2]]
    ref_kpts = torch.from_numpy(np.concatenate([kps[2], np.ones((16, 17, 1), np.float32)], -1))

    def run(pipe, replay=None):
        """analyze_batch's device programs on one chunk; `replay` replaces
        the pose network's output, micro-batch by micro-batch."""
        seen = []

        def hook(module, args, out):
            seen.append(out.cpu())
            return None if replay is None else replay[len(seen) - 1].to(out.device)

        handle = pipe.pose_model.register_forward_hook(hook)
        try:
            with torch.inference_mode():
                prep = [pipe._prepare(c, b) for c, b in zip(clips, boxes)]
                fr, bx, vd = (pipe._to_device([p[k] for p in prep]) for k in range(3))
                out = pipe._core_fn(fr, bx, vd)
                a = pipe._align_batch_fn(out["keypoints"], vd, ref_kpts.to(pipe.device),
                                         torch.ones(16, dtype=torch.bool, device=pipe.device),
                                         out["phase_logits"], out.get("kpt_aux"))
        finally:
            handle.remove()
        res = dict(keypoints=out["keypoints"], phase_logits=out["phase_logits"],
                   phase_labels=out["phase_labels"], error_probs=torch.sigmoid(a["error_logits"]),
                   cost=a["cost"], path=a["path"], path_length=a["path_length"])
        return {k: v.cpu().numpy() for k, v in res.items()}, seen

    pipes = {}
    for name in ("cpu", "cuda"):
        pipes[name] = Pipeline.from_artifacts(str(ROOT / "artifacts"), device=name,
                                              overrides=chip_smoke.FLOAT32)
        assert pipes[name].cfg.pose.decode_tracking == 4 and pipes[name].cfg.error.mode_features
    card, hm_card = run(pipes["cuda"])
    cpu, hm_cpu = run(pipes["cpu"])
    replayed, _ = run(pipes["cpu"], replay=hm_card)
    hm_gap = max(float((g - c).abs().max() / c.abs().max()) for g, c in zip(hm_card, hm_cpu))
    valid = np.stack([pipes["cpu"]._prepare(c, b)[2] for c, b in zip(clips, boxes)])

    def moved(a, b):
        m = np.abs(a["keypoints"] - b["keypoints"])[..., :2].max(-1) > 1e-2      # [N, T, V]
        return (f"{int(m.sum())} keypoints > 1e-2 px apart ({int(m[valid].sum())} in valid "
                f"frames) at {sorted(map(tuple, np.argwhere(m).tolist()))}, phase labels equal "
                f"{bool((a['phase_labels'] == b['phase_labels']).all())}"), m

    # A second witness on the CPU alone: its own heatmaps moved by uniform
    # noise as large as the gap between the devices.
    gen = torch.Generator().manual_seed(0)
    noisy = [c + (torch.rand(c.shape, generator=gen) * 2 - 1) * hm_gap * c.abs().max()
             for c in hm_cpu]
    perturbed, _ = run(pipes["cpu"], replay=noisy)
    text_dev, m_dev = moved(card, cpu)
    text_cpu, m_cpu = moved(perturbed, cpu)
    print(f"shipped model: heatmap gap {hm_gap:.3e} of the largest value; card vs CPU: "
          f"{text_dev}; CPU vs CPU with heatmap noise of that size: {text_cpu}; "
          f"keypoints moved by both: {int((m_dev & m_cpu).sum())}")
    assert hm_gap <= 1e-4
    _assert_outputs_match(card, replayed)


def test_pipeline_on_card_matches_cpu(dev):
    cfg = _small_cfg()
    rng = np.random.default_rng(0)
    clips = [rng.integers(0, 256, (n, 96, 128, 3), dtype=np.uint8) for n in (14, 20)]
    boxes = [np.tile(np.float32([64, 48, 50, 80]), (n, 1)) for n in (14, 20)]
    ref_kpts = np.concatenate([rng.uniform(20, 100, (16, 17, 2)),
                               rng.uniform(0.2, 1.0, (16, 17, 1))], -1).astype(np.float32)
    results = {}
    for name in ("cpu", "cuda"):
        pipe = Pipeline(cfg, device=name, seed=0)
        a = pipe.analyze(clips[0], boxes=boxes[0])
        # A reference unlike every clip: at zero deviation the error head's
        # projection feature is discontinuous (see ROADMAP Queue 3).
        ref = Skeleton(keypoints=torch.from_numpy(ref_kpts).to(pipe.device),
                       valid=torch.ones(16, dtype=torch.bool, device=pipe.device))
        batch = pipe.analyze_batch(clips, boxes=boxes, reference=ref)
        results[name] = [a] + batch
    for c, g in zip(results["cpu"], results["cuda"]):
        # 1e-2 px: the UDP step divides by the log-heatmap Hessian, which
        # amplifies float32 reduction-order differences of the random-weight
        # convolutions on flat heatmaps (measured 2.8e-3 px on the card).
        np.testing.assert_allclose(g.keypoints.cpu().numpy(), c.keypoints.numpy(), atol=1e-2)
        np.testing.assert_allclose(g.phase_logits.cpu().numpy(), c.phase_logits.numpy(),
                                   atol=1e-3)
        np.testing.assert_allclose(g.error_probs.cpu().numpy(), c.error_probs.numpy(),
                                   atol=1e-4)


def test_trainers_on_card_go_through_their_kernels(dev):
    """A few narrow steps of each trainer on the card: one forward wavefront
    and one backward launch per alignment step, crops through kernel A, the
    evaluation's decode through kernel D, and no launch of the forward-only
    GCN tail."""
    from golfaction_tpu_torch.train import data as data_mod
    from golfaction_tpu_torch.train import loops

    tc = tcfg.TrainConfig(batch_size=4, learning_rate=3e-3, warmup_steps=2, total_steps=5)
    counts = lambda: (softdtw.wavefront.launches, softdtw.softdtw_backward.launches,  # noqa: E731
                      gcn_tail.gcn_block_tail.launches, preprocess.crop_resize_normalize.launches,
                      heatmap.decode_heatmaps.launches)
    c0 = counts()
    _, hist = loops.train_align(tcfg.AlignConfig(embed_dim=16, hidden_channels=(8, 16)), tc,
                                frames_per_clip=16, log_every=1)
    c1 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (5, 5) and hist[-1]["loss"] < hist[0]["loss"]
    state, hist = loops.train_gcn(tcfg.GCNConfig(block_channels=(16, 32)), tc, frames_per_clip=16,
                                  log_every=1)
    assert counts()[2] == c1[2] and np.isfinite([r["loss"] for r in hist]).all()
    assert next(state.model.parameters()).device.type == "cuda"
    pc = _small_cfg().pose
    state, hist = loops.train_pose(pc, tc, image_hw=(96, 128), clips_per_epoch=1,
                                   frames_per_clip=8, log_every=1, pool_clips=2)
    c2 = counts()
    assert c2[3] - c1[3] == 2 and np.isfinite([r["loss"] for r in hist]).all()
    samples = data_mod.make_swing_batch(2, 4, seed=1, image_hw=(96, 128), render=True,
                                        scene_families=data_mod.TRAIN_SCENE_FAMILIES)
    pck = loops.evaluate_pose(state.model, pc, samples)
    c3 = counts()
    assert 0.0 <= pck <= 1.0 and (c3[3] - c2[3], c3[4] - c2[4]) == (2, 2)


# ---------------------------------------------------------------------------
# Kernel F: the int8 GroupNorm + requant epilogue
# ---------------------------------------------------------------------------

def _requant_inputs(rng, shape, residual, dev):
    c = shape[-1]

    def vec(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (c,)).astype(np.float32)).to(dev)

    y = torch.from_numpy(rng.integers(-20000, 20000, shape).astype(np.int32)).to(dev)
    args = (y, vec(1e-4, 3e-4), vec(0.8, 1.2), vec(-0.2, 0.2))
    kw = {}
    if residual == "int8":
        kw = {"residual": torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev),
              "res_scale": 0.02}
    elif residual == "conv":
        kw = {"residual": torch.from_numpy(
                  rng.integers(-20000, 20000, shape).astype(np.int32)).to(dev),
              "res_scale": vec(1e-4, 3e-4), "res_gamma": vec(0.8, 1.2), "res_beta": vec(-0.2, 0.2)}
    return args, kw


# (1, 256, 192, 64): a slab too large for 16 blocks' shared memory, the
# re-read branch; C = 12 and 24: 4-byte int8 stores (and 8-byte bf16 at 12);
# C = 6: the scalar path.
@pytest.mark.parametrize("shape,groups", [((2, 8, 16, 32), 8), ((1, 5, 7, 16), 4),
                                          ((3, 33, 17, 48), 6), ((2, 128, 96, 64), 32),
                                          ((2, 8, 6, 512), 32), ((1, 3, 3, 1024), 32),
                                          ((1, 256, 192, 64), 32), ((2, 5, 9, 12), 4),
                                          ((2, 11, 3, 24), 8), ((2, 7, 5, 6), 3)])
@pytest.mark.parametrize("residual", ["none", "int8", "conv"])
@pytest.mark.parametrize("out_scale", [0.04, None])
@pytest.mark.parametrize("relu", [True, False])
def test_requant_kernel_matches_plain(dev, shape, groups, residual, out_scale, relu):
    from golfaction_tpu_torch.ops import requant

    rng = np.random.default_rng(sum(shape) + groups)
    args, kw = _requant_inputs(rng, shape, residual, dev)
    n0 = requant.requant_epilogue.launches
    got = requant.requant_epilogue(*args, groups, relu=relu, out_scale=out_scale, **kw)
    want = requant.requant_epilogue_plain(*args, groups, relu=relu, out_scale=out_scale, **kw)
    torch.cuda.synchronize()
    assert requant.requant_epilogue.launches == n0 + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if out_scale is None:
        # Within one bfloat16 ulp: the sums' order moves mean and rstd in
        # their last bits, which can move a value across a rounding boundary.
        # 1e-5 beside it: where the terms cancel (or relu cuts at zero) the
        # float32 noise of terms of size 1 to 4 is larger than the result's ulp.
        w = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
        assert bool(((got.float() - w).abs() <= ulp.clamp(min=1e-5)).all())
    else:
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff != 0).float().mean()) < 0.001


def test_requant_kernel_takes_rows_off_a_16_byte_boundary(dev):
    from golfaction_tpu_torch.ops import requant

    rng = np.random.default_rng(5)
    args, kw = _requant_inputs(rng, (2, 16, 12, 64), "conv", dev)
    flat = torch.empty(args[0].numel() + 1, dtype=torch.int32, device=dev)
    y = flat[1:].view(args[0].shape)
    y.copy_(args[0])
    n0 = requant.requant_epilogue.launches
    got = requant.requant_epilogue(y, *args[1:], 32, out_scale=0.04, **kw)   # 4-byte accesses
    want = requant.requant_epilogue_plain(*args, 32, out_scale=0.04, **kw)
    assert requant.requant_epilogue.launches == n0 + 1
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) < 0.001


def test_requant_kernel_refuses_what_it_cannot_take(dev):
    from golfaction_tpu_torch.ops import requant

    rng = np.random.default_rng(0)
    args, _ = _requant_inputs(rng, (1, 2, 2, 2048), "none", dev)
    with pytest.raises(ValueError, match="at most 1024"):
        requant.requant_epilogue(*args, 32, out_scale=0.05)
    args, _ = _requant_inputs(rng, (1, 4, 4, 24), "none", dev)
    with pytest.raises(ValueError, match="multiple"):
        requant.requant_epilogue(*args, 16, out_scale=0.05)
    with pytest.raises(ValueError):
        requant.requant_epilogue(args[0].float(), *args[1:], 8, out_scale=0.05)   # not int32
    with pytest.raises(ValueError):
        requant.requant_epilogue(args[0].permute(0, 2, 1, 3), *args[1:], 8, out_scale=0.05)
    with pytest.raises(ValueError):
        requant.requant_epilogue(args[0], args[1].cpu(), *args[2:], 8, out_scale=0.05)


@pytest.mark.parametrize("k,stride,cin,cout,hw", [(7, 2, 3, 64, (64, 48)), (3, 1, 512, 64, (8, 6)),
                                                  (1, 2, 64, 128, (16, 12)), (3, 2, 20, 24, (9, 7))])
def test_integer_convolution_on_card_is_exact(dev, k, stride, cin, cout, hw):
    from golfaction_tpu_torch.models import pose_quant as pq

    rng = np.random.default_rng(k + cin)
    x = torch.from_numpy(rng.integers(-127, 128, (2, *hw, cin)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k * k * cin, cout)).astype(np.int8))
    got = pq.conv_i8(x.to(dev), w.to(dev), k, stride)
    assert torch.equal(got.cpu(), pq.conv_i8(x, w, k, stride))
    x = x[:, :5, :4]
    wd = torch.from_numpy(rng.integers(-127, 128, (16 * cin, cout)).astype(np.int8))
    assert torch.equal(pq.deconv_i8(x.to(dev), wd.to(dev)).cpu(), pq.deconv_i8(x, wd))
    assert torch.equal(pq.max_pool_i8(x.to(dev)).cpu(), pq.max_pool_i8(x))


@pytest.mark.parametrize("M", [1, 17, 24, 40, 48, 72, 96])
def test_int_mm_takes_any_shape_on_card(dev, M):
    """cuBLASLt's int8 product refuses M <= 16, K or O off a multiple of 8
    and, on the H100, M off a multiple of 32 when K < 128 and O >= 32 (M=48,
    K=32, O=64 is the small model's last projection); `_int_mm` pads."""
    from golfaction_tpu_torch.models import pose_quant as pq

    rng = np.random.default_rng(M)
    for K, O in ((8, 32), (32, 64), (72, 128), (96, 48), (147, 64), (20, 17)):
        a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (K, O)).astype(np.int8))
        got = pq._int_mm(a.to(dev), b.to(dev))
        assert tuple(got.shape) == (M, O)
        assert torch.equal(got.cpu(), a.int() @ b.int())


def test_fused_int8_forward_on_card_runs_kernel_f_at_every_site(dev):
    from golfaction_tpu_torch import weights
    from golfaction_tpu_torch.models import pose_quant as pq
    from golfaction_tpu_torch.models.pose import PoseNet
    from golfaction_tpu_torch.ops import requant

    cfg = tcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
                          stage_channels=(16, 32, 64), deconv_channels=(32, 32))
    model = PoseNet(cfg)
    weights.init_random(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    gen = torch.Generator().manual_seed(1)
    calib = torch.randn((8, 64, 48, 3), generator=gen).to(dev)
    x = torch.randn((4, 64, 48, 3), generator=gen).to(dev)
    qw, scales = pq.prepare_int8(model, calib)
    n0 = requant.requant_epilogue.launches
    got = pq.pose_forward_int8_fused(model, qw, scales, x)
    assert requant.requant_epilogue.launches - n0 == 1 + 2 * 3 + 2
    want = pq.pose_forward_int8_fused(model, qw, scales, x,
                                      epilogue=requant.requant_epilogue_plain)
    assert requant.requant_epilogue.launches - n0 == 1 + 2 * 3 + 2
    # Site by site the two epilogues differ by 1 LSB on a few elements in a
    # million; each such element moves the next convolution's sums, so the
    # flips multiply along the chain and the heatmaps differ by a few int8
    # steps of the last activations (measured: 0.012 of the largest value
    # here, 0.037 at full width).
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 0.08 * scale
    assert float((got - want).abs().mean()) <= 5e-3 * scale
    for fn in (pq.pose_forward_int8, pq.pose_forward_int8_mixed):
        out = fn(model, qw, scales, x)
        assert bool(torch.isfinite(out).all()) and tuple(out.shape) == (4, 17, 16, 12)


def test_overlapped_batch_equals_one_chunk_calls(dev):
    """analyze_batch over three chunks (pinned staging, the copy on a side
    stream one chunk ahead) equals the same clips run as three one-chunk
    calls, to the bit, with deterministic cuDNN; the telemetry has the JAX
    package's keys and one copy time a chunk."""
    import chip_smoke

    rng = np.random.default_rng(11)
    # One bucket, so each chunk of the 3-chunk call holds two clips as each
    # one-chunk call does (another batch size may take other algorithms).
    clips = [rng.integers(0, 256, (14, 96, 128, 3), dtype=np.uint8) for _ in range(2)]
    ref = Skeleton(keypoints=torch.from_numpy(np.concatenate(
        [rng.uniform(20, 100, (16, 17, 2)), rng.uniform(0.2, 1.0, (16, 17, 1))],
        -1).astype(np.float32)).to(dev), valid=torch.ones(16, dtype=torch.bool, device=dev))
    pipe = Pipeline(_small_cfg(clip_batch=2), device="cuda", seed=0)
    torch.backends.cudnn.deterministic = True
    try:
        whole = pipe.analyze_batch(clips * 3, reference=ref, decode_workers=1)
        copy_ms, stats = pipe.last_copy_ms, pipe.last_batch_stats
        parts = [r for _ in range(3) for r in pipe.analyze_batch(clips, reference=ref)]
    finally:
        torch.backends.cudnn.deterministic = False
    assert chip_smoke.differing_fields([whole, parts]) == []
    assert len(copy_ms) == 3 and all(ms > 0 for ms in copy_ms)
    assert set(stats) == {"wall_s", "decode_s_total", "decode_workers", "first_dispatch_s",
                          "clips", "failures"} and stats["clips"] == 6


@pytest.mark.parametrize("in_frames", [1, 3])
def test_bfloat16_models_on_card_match_cpu(dev, in_frames):
    """The models at dtype="bfloat16" on the card against the CPU, the same
    weights and inputs, at the caps the CPU is held to against flax
    (tests/test_torch_dtype.py): heatmaps within 5e-2 (mean 5e-3) of the
    largest value, error logits within 5e-2, embeddings rel 2e-2; the GCN's
    inference is float32 on both, within 1e-3."""
    import dataclasses

    cfg = _small_cfg(decode_tracking=4, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, pose=dataclasses.replace(cfg.pose, in_frames=in_frames))
    gen = torch.Generator().manual_seed(3)
    crops = torch.randn((6, 64, 48, 3 * in_frames), generator=gen)
    sk = torch.randn((2, 16, 17, 3), generator=gen)
    kp = torch.rand((2, 16, 17, 3), generator=gen) * 100
    valid = torch.arange(16)[None] < torch.tensor([[16], [11]])
    logits = torch.randn((2, 16, 9), generator=gen)
    out = {}
    with torch.inference_mode():
        for name in ("cpu", "cuda"):
            p = Pipeline(cfg, device=name, seed=0)
            d = p.device
            res = {"heatmaps": p.pose_model(crops.to(d)),
                   "phase_logits": p.gcn_model(sk.to(d), valid.to(d)),
                   "error_logits": p.error_model(kp.to(d), logits.to(d), valid.to(d),
                                                 kp.to(d) + 1.0),
                   "embeddings": p.align_model(sk.to(d), valid.to(d))}
            out[name] = {k: v.float().cpu() for k, v in res.items()}
    c, g = out["cpu"], out["cuda"]
    peak = float(c["heatmaps"].abs().max())
    gap = (g["heatmaps"] - c["heatmaps"]).abs()
    assert float(gap.max()) <= 5e-2 * peak and float(gap.mean()) <= 5e-3 * peak
    m = valid[..., None]
    assert float(((g["phase_logits"] - c["phase_logits"]) * m).abs().max()) <= 1e-3
    assert float((g["error_logits"] - c["error_logits"]).abs().max()) <= 5e-2
    assert float((g["embeddings"] - c["embeddings"]).norm()) <= 2e-2 * float(
        c["embeddings"].norm())
