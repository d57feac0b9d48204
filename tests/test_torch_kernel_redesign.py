"""What the redesigned kernels A (preprocess warp) and B (GCN block tail) rest
on, checked without a card: the TF32 split of the branch product and its
fragment layout, the product as the kernel rounds it run through the shipped
GCN's tails, the tiling helpers, and kernel A's own sample coordinates,
transcribed to numpy operation by operation.  The kernels themselves are held
to their plain versions on the card (tests/test_torch_kernels_cuda.py)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch.config import get_config
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN
from golfaction_tpu_torch.ops import gcn_tail, preprocess

ROOT = Path(__file__).resolve().parent.parent
V = 17


# ---------------------------------------------------------------------------
# (a) The split of W1 and the layout pack_tail stores it in.
# ---------------------------------------------------------------------------

def w1_from_fragments(frag: torch.Tensor, C: int) -> torch.Tensor:
    """Inverse of gcn_tail.w1_fragments: W1 [C, C] back from the mma order."""
    kp, nt = -(-C // 16), -(-C // 8)
    wp = frag.reshape(kp, nt, 8, 4, 2, 2).permute(0, 4, 5, 3, 1, 2)   # kp, step, half, t, nt, g
    return wp.reshape(16 * kp, 8 * nt)[:C, :C]


def _w1(C, seed=0):
    rng = np.random.default_rng(seed + C)
    return torch.from_numpy((rng.normal(size=(C, C)) * rng.choice([1e-3, 0.3, 20.0], (C, C)))
                            .astype(np.float32))


@pytest.mark.parametrize("C", [16, 64, 128, 256])
def test_tf32_split_is_exact_to_21_bits(C):
    w = _w1(C)
    # Activations: both parts rounded to nearest.  Weights: the head rounded, the
    # tail truncated by the tensor core.  Either way 2^-21 of the value is kept.
    for truncate_tail in (False, True):
        hi, lo = gcn_tail.split_tf32(w, truncate_tail=truncate_tail)
        for part in (hi, lo):                              # TF32: the low 13 bits are zero
            assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
        assert float(((w - hi).abs() / w.abs()).max()) <= 2.0 ** -11
        gap = (hi.double() + lo.double() - w.double()).abs() / w.double().abs()
        assert float(gap.max()) <= 2.0 ** -21


def test_tf32_rounding_ties_go_away_from_zero():
    # cvt.rna: 1 + 2^-11 lies halfway between two TF32 values and goes up.
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(gcn_tail.round_tf32(x), want)


@pytest.mark.parametrize("C", [8, 16, 20, 64, 100, 128, 256])
def test_w1_fragments_hold_w1_in_mma_order(C):
    w = _w1(C, seed=1)
    frag = gcn_tail.w1_fragments(w)
    kp, nt = -(-C // 16), -(-C // 8)
    assert frag.dtype == torch.float32 and frag.numel() == 16 * kp * 8 * nt
    assert torch.equal(w1_from_fragments(frag, C), w)
    # Lane 4 g + t of (pair 0, tile 0) holds W1[t, g], W1[t + 4, g], W1[8 + t, g], W1[12 + t, g].
    g, t = 3, 2
    got = frag[(4 * g + t) * 4:(4 * g + t) * 4 + 4].tolist()
    want = [float(w[r, g]) if r < C else 0.0 for r in (t, t + 4, 8 + t, 12 + t)]
    assert got == want
    assert float(frag.abs().sum()) == pytest.approx(float(w.abs().sum()), rel=1e-5)  # zero padding


# ---------------------------------------------------------------------------
# (b) The product as the kernel rounds it, through the shipped GCN's tails.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shipped_tails():
    cfg = checkpoint.config_for_artifacts(get_config("full_pipeline"), str(ROOT / "artifacts"))
    params = weights.from_flax(checkpoint.load_params(str(ROOT / "artifacts"), names=("gcn",)))
    model = ActionSegmentationGCN(cfg.gcn)
    model.load_state_dict(params["gcn"])
    model.prepare()
    tails = [blk.tail for blk in model.blocks]
    assert [t.C for t in tails] == [64, 64, 128, 128, 256, 256]
    return tails


def one_tf32_pass(y, w):
    """The product a single tensor-core pass would give: both factors rounded
    to TF32 once, float32 sums.  The kernel does not run this form."""
    return gcn_tail.round_tf32(y) @ gcn_tail.round_tf32(w)


def _tail_gaps(tail, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, 16, V, tail.C)).astype(np.float32))
    la = torch.tensor([16, 9], dtype=torch.int32)
    want = gcn_tail.gcn_block_tail_plain(x, la, tail)
    gaps = []
    for product in (gcn_tail.product_tf32, one_tf32_pass):
        got = gcn_tail.gcn_block_tail_plain(x, la, tail, product=product)
        gaps.append(float((got - want).abs().max()))
    return gaps


@pytest.mark.parametrize("block", range(6))
def test_split_product_holds_the_tail_and_one_pass_does_not(shipped_tails, block):
    """The kernel's 3xTF32 product, emulated (factors rounded to TF32, float32
    sums), is within 1e-4 of the float32 tail at every width of the shipped
    GCN; one TF32 pass alone uses up more than half of the kernel's 1e-3 limit
    at every width before any other difference is counted."""
    split, single = _tail_gaps(shipped_tails[block], block)
    print(f"block {block}, C={shipped_tails[block].C}: 3xTF32 gap {split:.3e}, "
          f"one TF32 pass {single:.3e} (kernel limit 1e-3)")
    assert split <= 1e-4
    assert single > 5e-4
    assert single > 50 * split


def test_one_tf32_pass_breaks_the_limit_at_the_widest_block(shipped_tails):
    gaps = [_tail_gaps(t, i)[1] for i, t in enumerate(shipped_tails)]
    print("one TF32 pass, six widths:", [f"{g:.3e}" for g in gaps])
    assert max(gaps) > 1e-3            # beyond the limit: the kernel must split
    assert gaps[5] > 1e-3


def test_pack_tail_stores_fragments_of_its_w1(shipped_tails):
    for tail in shipped_tails:
        assert torch.equal(w1_from_fragments(tail.w1_frag, tail.C), tail.view("w1"))
        moved = tail.to("cpu")
        assert moved.w1_frag.device.type == "cpu" and moved.w1_frag.shape == tail.w1_frag.shape


# ---------------------------------------------------------------------------
# (c) The tiling helpers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 16, 37, 64, 128, 512])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_frame_tile_leaves_a_block_for_every_sm(B, T):
    """The wrapper hands the kernel one number, the frames of a taps or apply
    block; the kernel's grid is the clips times ceil(T / ft) such tiles."""
    ft = gcn_tail.frames_per_block(B, T)
    assert 1 <= ft <= min(16, T)
    blocks = B * -(-T // ft)
    if B * T >= 132:            # enough frames: at least half an SM count of blocks
        assert blocks >= 66
    if ft < 16:                 # a smaller tile only where a larger one would idle SMs
        assert B * -(-T // (ft + 1)) < 132 or ft == T


def test_main_path_shape_fills_the_card():
    # [4, 64, 17, C]: 136 blocks in the rows pass at every C, 128 in the taps pass.
    assert -(-4 * 64 * V // gcn_tail.ROW_TILE) == 136
    assert 4 * -(-64 // gcn_tail.frames_per_block(4, 64)) == 128


@pytest.mark.parametrize("T", [1, 16, 37, 64, 128, 512])
def test_shared_memory_fits_at_every_width(T):
    for C in range(8, 257, 8):
        M = max(C // 4, 8)
        for B in (1, 4, 8):
            need = max(gcn_tail.rows_smem(C), gcn_tail.taps_smem(C, V),
                       gcn_tail.gates_smem(C, M))
            assert need <= gcn_tail.SMEM_LIMIT == 232448, (C, T, B, need)
    # Two rows-pass blocks fit one SM at the widest block (228 KB an SM, 1 KB a block).
    assert 2 * (gcn_tail.rows_smem(256) + 1024) <= 228 * 1024


# ---------------------------------------------------------------------------
# (d) Kernel A's sample coordinates, operation by operation in numpy float32.
# ---------------------------------------------------------------------------

def kernel_sample_coords(c: np.ndarray, s: np.ndarray, n: int) -> np.ndarray:
    """csrc/preprocess.cu:sample_coord for every output index: each operation
    rounded to float32 on its own, no reciprocal, no fused multiply-add."""
    c, s = c.astype(np.float32), s.astype(np.float32)
    step = s / np.float32(n - 1)                              # __fdiv_rn
    start = c - s * np.float32(0.5)                           # __fsub_rn(c, __fmul_rn(s, 0.5f))
    idx = np.arange(n, dtype=np.float32)
    out = start[:, None] + idx[None, :] * step[:, None]       # __fadd_rn(start, __fmul_rn(i, step))
    assert out.dtype == np.float32
    return out


def _boxes_1080p(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"inside": 0, "leaving": 1, "one_px": 2, "far": 3}[kind])
    n, W, H = 64, 1920.0, 1080.0
    if kind == "inside":
        b = [rng.uniform(0.3 * W, 0.7 * W, n), rng.uniform(0.3 * H, 0.7 * H, n),
             rng.uniform(0.1 * W, 0.5 * W, n), rng.uniform(0.2 * H, 0.9 * H, n)]
    elif kind == "leaving":
        b = [rng.uniform(-0.3 * W, 1.3 * W, n), rng.uniform(-0.3 * H, 1.3 * H, n),
             rng.uniform(0.1 * W, 1.5 * W, n), rng.uniform(0.2 * H, 1.5 * H, n)]
    elif kind == "one_px":
        b = [rng.uniform(0, W, n), rng.uniform(0, H, n), np.full(n, 1.0),
             rng.choice([1.0, 0.5, 2.0], n)]
    else:
        b = [rng.uniform(-1e7, 1e7, n), rng.uniform(-1e7, 1e7, n),
             rng.uniform(1.0, 1e6, n), rng.uniform(1.0, 1e6, n)]
    return np.stack(b, axis=-1).astype(np.float32)


@pytest.mark.parametrize("kind", ["inside", "leaving", "one_px", "far"])
@pytest.mark.parametrize("axis,n", [(0, 192), (1, 256), (0, 5), (1, 31)])
def test_kernel_coordinates_equal_the_plain_versions_to_the_bit(kind, axis, n):
    boxes = _boxes_1080p(kind)
    want = preprocess._sample_coords(torch.from_numpy(boxes), n, axis=axis).numpy()
    got = kernel_sample_coords(boxes[:, axis], boxes[:, 2 + axis], n)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind", ["inside", "leaving", "one_px"])
def test_gather_version_samples_the_same_coordinates(kind):
    """crop_transform + apply_transform (the gather version's route) give the
    same coordinates, to the bit, as _sample_coords (the separable version's
    and, transcribed, the kernel's)."""
    from golfaction_tpu_torch.ops import affine

    boxes = torch.from_numpy(_boxes_1080p(kind))
    oh, ow = 256, 192
    mat = affine.crop_transform(boxes, (oh, ow))
    xs = torch.arange(ow, dtype=torch.float32)
    pts = torch.stack([xs, torch.zeros(ow)], dim=-1).expand(len(boxes), ow, 2)
    sx = affine.apply_transform(mat, pts)[..., 0]
    ys = torch.arange(oh, dtype=torch.float32)
    pts = torch.stack([torch.zeros(oh), ys], dim=-1).expand(len(boxes), oh, 2)
    sy = affine.apply_transform(mat, pts)[..., 1]
    assert torch.equal(sx, preprocess._sample_coords(boxes, ow, axis=0))
    assert torch.equal(sy, preprocess._sample_coords(boxes, oh, axis=1))


def test_division_by_a_tensor_does_not_change_the_cpu_results():
    """_sample_coords divides by a 0-dim tensor so that the card divides too;
    on the CPU that is the division by the Python number it replaced."""
    boxes = torch.from_numpy(_boxes_1080p("leaving"))
    for axis, n in ((0, 192), (1, 256)):
        s, c = boxes[:, 2 + axis], boxes[:, axis]
        old = (c - s / 2.0)[:, None] + torch.arange(n, dtype=torch.float32) * (s / (n - 1))[:, None]
        assert torch.equal(preprocess._sample_coords(boxes, n, axis=axis), old)

