"""What the redesigned kernels A (preprocess warp) and B (GCN block tail) rest
on, checked without a card: the TF32 split of the branch product and its
fragment layout, the product as the kernel rounds it run through the shipped
GCN's tails, the tiling helpers, kernel A's own sample coordinates and its
bfloat16 variant (windows, word loads, byte permutes, fused multiply-adds and
divisions by a reciprocal and one correction), transcribed to numpy
operation by operation.  The kernels themselves are held to their plain
versions on the card (tests/test_torch_kernels_cuda.py)."""

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



# ---------------------------------------------------------------------------
# (e) Kernel A's bfloat16 variant, operation by operation in numpy: the
#     two-pixel windows read by aligned word loads, the byte permutes, the
#     fused multiply-adds and the divisions by reciprocal and one correction.
# ---------------------------------------------------------------------------

F32, F64 = np.float32, np.float64


def rn32(s: np.ndarray, t: np.ndarray) -> np.ndarray:
    """RN_float32(s + t) for float64 s = fl(a + b) and t its exact error: s
    rounds to the nearest float32, and t decides only where s is a midpoint
    between two float32s (t is smaller than s's float64 ulp)."""
    r = s.astype(F32)
    up, dn = np.nextafter(r, F32(np.inf)), np.nextafter(r, F32(-np.inf))
    r = np.where((s == (r.astype(F64) + up.astype(F64)) / 2) & (t > 0), up, r)
    return np.where((s == (r.astype(F64) + dn.astype(F64)) / 2) & (t < 0), dn, r)


def fma32(a, b, c) -> np.ndarray:
    """__fmaf_rn: a * b (exact in float64) + c with one rounding to float32."""
    p = np.asarray(a, F32).astype(F64) * np.asarray(b, F32).astype(F64)
    c = np.broadcast_to(np.asarray(c, F32).astype(F64), p.shape)
    s = p + c
    bb = s - p
    return rn32(s, (p - (s - bb)) + (c - bb))


def divide32(x, d, r) -> np.ndarray:
    """csrc/preprocess.cu:divide."""
    x = np.asarray(x, F32)
    q = x * F32(r)
    return fma32(-fma32(q, d, -x), r, q)


def divide32_guarded(x, d, r) -> np.ndarray:
    """csrc/preprocess.cu:divide_guarded: IEEE division under 2^-100."""
    x = np.asarray(x, F32)
    with np.errstate(under="ignore"):
        return np.where(np.abs(x) < F32(2.0 ** -100), x / F32(d), divide32(x, d, r))


def bf16(x) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(torch.bfloat16).float().numpy()


def hat(c, s):
    return bf16(np.maximum(F32(0), F32(1) - np.abs(c - s)))


def floor_index(c, size):
    lo = np.floor(c)
    return lo, np.maximum(np.minimum(lo, F32(size)), F32(-2)).astype(np.int64)


def kernel_window(c, size):
    """make_window: byte offset of [s, s + 1] in a row, wa, wb, cb."""
    lo, i = floor_index(c, size)
    w0 = np.where((i >= 0) & (i < size), hat(c, lo), F32(0))
    w1 = np.where((i + 1 >= 0) & (i + 1 < size), hat(c, lo + F32(1)), F32(0))
    s = np.minimum(np.maximum(i, 0), max(size - 2, 0))
    wa = np.where(s == i, w0, np.where(s == i + 1, w1, F32(0))).astype(F32)
    wb = np.where(s + 1 == i, w0, np.where(s == i, w1, F32(0))).astype(F32)
    return 3 * s, wa, wb, -wb * F32(2.0 ** 23)


def kernel_row_taps(c, size, row_bytes):
    """make_row_taps: the two tap rows' byte offsets (clamped) and weights."""
    lo, i = floor_index(c, size)
    ok0, ok1 = (i >= 0) & (i < size), (i + 1 >= 0) & (i + 1 < size)
    return (np.where(ok0, i, 0) * row_bytes, np.where(ok1, i + 1, 0) * row_bytes,
            np.where(ok0, hat(c, lo), F32(0)), np.where(ok1, hat(c, lo + F32(1)), F32(0)))


def kernel_bf16_crops(frames: np.ndarray, boxes: np.ndarray, oh: int, ow: int, lead: int,
                      rng) -> np.ndarray:
    """The bfloat16 kernel's crops, its frames placed `lead` bytes past an
    8-byte boundary among random bytes."""
    B, H, W, _ = frames.shape
    fb = 3 * H * W
    buf = rng.integers(0, 256, lead + B * fb + 8, dtype=np.uint8)
    buf[lead:lead + B * fb] = frames.reshape(-1)
    rs = preprocess.division_reciprocals(preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD)
    mean, std = (np.asarray(v, F32) for v in (preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD))
    big = F32(2.0 ** 23)
    out = np.empty((B, oh, ow, 3), F32)
    for b in range(B):
        start = lead + b * fb
        fl = start & 7                               # the frame's lead
        base, last = start - fl, (fl + fb - 1) & ~7

        def word(off):                               # the 32-bit word at base + off
            a = base + off
            return sum(buf[a + k].astype(np.uint64) << np.uint64(8 * k) for k in range(4))

        def window(j):                               # load_window: lo, hi as uint64
            w = j & ~7
            a, b8 = w, np.minimum(w + 8, last)       # the two 8-byte loads
            up = (j & 4) != 0
            w0 = np.where(up, word(a + 4), word(a))
            w1 = np.where(up, word(b8), word(a + 4))
            w2 = np.where(up, word(b8 + 4), word(b8))
            sh = (np.uint64(8) * (j & 3).astype(np.uint64))
            mask = np.uint64(0xFFFFFFFF)
            return ((w1 << np.uint64(32) | w0) >> sh) & mask, ((w2 << np.uint64(32) | w1) >> sh) & mask

        def byte_big(w, k):                          # big(): 2^23 + byte k, as a float
            bits = (np.uint64(0x4B000000) | ((w >> np.uint64(8 * k)) & np.uint64(0xFF)))
            return bits.astype(np.uint32).view(F32)

        cx = kernel_sample_coords(boxes[b:b + 1, 0], boxes[b:b + 1, 2], ow)[0]
        cy = kernel_sample_coords(boxes[b:b + 1, 1], boxes[b:b + 1, 3], oh)[0]
        xoff, wa, wb, cb = kernel_window(cx, W)
        off0, off1, wy0, wy1 = kernel_row_taps(cy, H, 3 * W)
        xoff = (xoff + fl)[None, :]
        rows = []
        for off in (off0, off1):
            lo_, hi_ = window(off[:, None] + xoff)
            rows.append([(byte_big(lo_, ch), byte_big(lo_, 3) if ch == 0 else byte_big(hi_, ch - 1))
                         for ch in range(3)])
        for ch in range(3):
            t = [bf16(fma32(wa, rows[r][ch][0] - big, fma32(wb, rows[r][ch][1], cb)))
                 for r in range(2)]
            v = fma32(wy0[:, None], t[0], wy1[:, None] * t[1])
            q = divide32(v, F32(255), rs[3])
            out[b, :, :, ch] = divide32_guarded(q - mean[ch], std[ch], rs[ch])
    return bf16(out)


def _bf16_case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "odd":
        h, w = 120, 160
        boxes = np.array([[80.3, 60.7, 9.0, 12.0], [150.0, 110.0, 6.5, 3.2], [-300.0, 60.0, 50, 50],
                          [5e6, -3e7, 20.0, 30.0], [80.0, 60.0, 1.0, 1.0], [159.0, 119.0, 1.0, 1.0],
                          [0.05, -0.1, 0.7, 0.9], [1e-8, 1e-8, 1e-8, 1e-8]], np.float32)
    else:
        h, w = {"random": (40, 50), "one_column": (9, 1), "one_row": (1, 11)}[kind]
        b = 4
        boxes = np.stack([rng.uniform(-0.2 * w, 1.2 * w, b), rng.uniform(-0.2 * h, 1.2 * h, b),
                          rng.uniform(0.3, 1.5 * w, b), rng.uniform(0.3, 1.5 * h, b)],
                         axis=-1).astype(np.float32)
    frames = rng.integers(0, 256, (len(boxes), h, w, 3), dtype=np.uint8)
    return frames, boxes, rng


@pytest.mark.parametrize("kind", ["random", "odd", "one_column", "one_row"])
@pytest.mark.parametrize("lead", [0, 1, 3, 6])
def test_bf16_kernel_arithmetic_equals_the_plain_version_to_the_bit(kind, lead):
    """The windows (an edge tap moved into the window's other slot, a frame one
    pixel wide), the word loads from any byte alignment, and every rounding
    of the variant give the plain version's bits."""
    frames, boxes, rng = _bf16_case(kind, 5 + lead)
    oh, ow = 17, 13
    got = kernel_bf16_crops(frames, boxes, oh, ow, lead, rng)
    want = preprocess.crop_resize_normalize_bf16_reference(
        torch.from_numpy(frames), torch.from_numpy(boxes), (oh, ow)).float().numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _domain_sample(lo: float, hi: float, n: int, rng) -> np.ndarray:
    """n float32s spread over the bit patterns of [lo, hi], its ends, both
    zeros where it holds 0, and the smallest normals and subnormals."""
    def bits(x):
        return int(np.float32(abs(x)).view(np.uint32))
    pats = []
    if hi >= 0:
        pats.append(rng.integers(0 if lo <= 0 else bits(lo), bits(hi) + 1, n))
        pats.append(np.array([0, 1, 2, 0x7FFFFF, 0x800000, 0x800001, bits(hi)]))
    if lo <= 0:
        pats.append((1 << 31) | rng.integers(0, bits(lo) + 1, n))
        pats.append((1 << 31) | np.array([0, 1, 0x800000, bits(lo)]))
    return np.concatenate(pats).astype(np.uint32).view(F32)


@pytest.mark.parametrize("channel", [None, 0, 1, 2])
def test_bf16_kernel_division_is_ieee_division_on_a_sample(channel):
    """divide(x, 255, RN(1/255)) and divide_guarded(x, std, RN(1/std))
    against numpy's IEEE float32 division over a sample of their domains:
    [0, 255], and [-mean, 1 - mean] for each channel (the card enumerates
    every float of them: chip_smoke.py, phase preprocess_bf16)."""
    rng = np.random.default_rng(channel or 7)
    rs = preprocess.division_reciprocals(preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD)
    if channel is None:
        x = _domain_sample(0.0, 255.0, 20000, rng)
        got, d = divide32(x, F32(255), rs[3]), F32(255)
    else:
        m = F32(preprocess.IMAGENET_MEAN[channel])
        x = _domain_sample(-m, F32(1) - m, 20000, rng)
        d = F32(preprocess.IMAGENET_STD[channel])
        got = divide32_guarded(x, d, rs[channel])
    with np.errstate(under="ignore"):
        want = x / d
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_division_by_std_needs_its_guard_only_for_tiny_dividends():
    """Without the guard, /std differs from IEEE division only for dividends
    under 2^-100, whose remainder is subnormal; /255 never does."""
    rng = np.random.default_rng(3)
    m, d = F32(preprocess.IMAGENET_MEAN[0]), F32(preprocess.IMAGENET_STD[0])
    r = preprocess.division_reciprocals(preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD)[0]
    x = _domain_sample(-m, F32(1) - m, 200000, rng)
    with np.errstate(under="ignore"):
        off = divide32(x, d, r).view(np.uint32) != (x / d).view(np.uint32)
    assert off.any() and float(np.abs(x[off]).max()) < 2.0 ** -100
