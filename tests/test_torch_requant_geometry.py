"""What kernel F (csrc/requant.cu) rests on, checked without a card: the
launch geometry of `ops.requant.launch_geometry` (rows owned once, cluster
and shared memory within the card's limits, vector widths, the large slabs
staged), and the kernel's order of summation transcribed to numpy float32
(each thread over its rows in row order, the tree over the threads' row
offsets, the channels of a group in order, the cluster's ranks in order),
held to the plain version.  The kernel itself is held to its plain version
on the card (tests/test_torch_kernels_cuda.py)."""

import math

import numpy as np
import pytest
import torch

from golfaction_tpu_torch.ops import requant

# The 20 epilogue sites of one fused int8 forward of PoseConfig() at batch 64:
# (R, C, residual mode (0 none, 1 int8, 2 int32 with its own GroupNorm), int8 out).
SITES = ([(12288, 64, 0, True)]
         + [(3072, 64, 0, True), (3072, 64, 1, True)] * 2
         + [(768, 128, 0, True), (768, 128, 2, True), (768, 128, 0, True), (768, 128, 1, True)]
         + [(192, 256, 0, True), (192, 256, 2, True), (192, 256, 0, True), (192, 256, 1, True)]
         + [(48, 512, 0, True), (48, 512, 2, True), (48, 512, 0, True), (48, 512, 1, True)]
         + [(192, 256, 0, True), (768, 128, 0, True), (3072, 128, 0, False)])


def assert_geometry_covers(N, R, C, groups, res_mode, out_int8, **kw):
    """The checks every launch geometry must pass; returns it."""
    g = requant.launch_geometry(N, R, C, groups, res_mode, out_int8, **kw)
    owned = np.zeros(R, np.int64)
    for rank in range(g.cluster):
        r0 = min(R, rank * g.rpb)
        owned[r0:min(R, r0 + g.rpb)] += 1
    assert (owned == 1).all(), "every row owned by exactly one block of the cluster"
    assert 1 <= g.cluster <= 16 and g.cluster & (g.cluster - 1) == 0
    assert g.smem <= requant.MAX_SMEM
    assert C % g.wa == 0 and g.wa in (1, 4, 8, 16)
    assert g.wa != 16 or out_int8
    assert g.wa != 8 or not out_int8
    cv = C // 4 if g.wa > 1 else C
    assert g.threads == cv * g.rpi <= 1024
    assert g.threads % (C // g.wa) == 0, "the apply pass's threads tile whole rows"
    sources = 2 if res_mode == 2 else 1
    if g.staged:
        assert g.smem >= sources * g.rpb * C * 4
    return g


@pytest.mark.parametrize("R,C,res_mode,out_int8", SITES)
def test_site_geometry_at_batch_64(R, C, res_mode, out_int8):
    g = assert_geometry_covers(64, R, C, min(32, C), res_mode, out_int8)
    assert g.wa == (16 if out_int8 else 8), "16-byte accesses at every site"
    int32_bytes = 64 * R * C * 4 * (2 if res_mode == 2 else 1)
    if int32_bytes > requant.REREAD_L2_SHARE * requant.H100_L2_BYTES:
        assert g.staged, "rows beyond L2 are read once"
    else:
        assert g.cluster == 2, "one wave: 128 blocks on 132 SMs"


def test_large_slabs_are_staged_at_16_and_8():
    stem = assert_geometry_covers(64, 12288, 64, 32, 0, True)        # 3.1 MB a sample
    deconv = assert_geometry_covers(64, 3072, 128, 32, 0, False)     # 1.6 MB a sample
    assert (stem.cluster, stem.staged) == (16, True)
    assert (deconv.cluster, deconv.staged) == (8, True)
    # A card that places no cluster of 16: the stem reads its rows twice, in
    # one wave.
    stem8 = assert_geometry_covers(64, 12288, 64, 32, 0, True, max_cluster=8)
    assert (stem8.cluster, stem8.staged) == (2, False)
    # A slab too large for 16 blocks' shared memory takes the same branch.
    big = assert_geometry_covers(1, 256 * 192, 64, 32, 0, True)
    assert (big.cluster, big.staged) == (16, False)


@pytest.mark.parametrize("C,aligned,out_int8,wa", [(64, True, True, 16), (64, True, False, 8),
                                                   (12, True, True, 4), (12, True, False, 4),
                                                   (24, True, True, 4), (24, True, False, 8),
                                                   (6, True, True, 1), (64, False, True, 1)])
def test_vector_width_follows_c_and_alignment(C, aligned, out_int8, wa):
    g = assert_geometry_covers(2, 40, C, math.gcd(C, 32), 0, out_int8, aligned=aligned)
    assert g.wa == wa


# ---------------------------------------------------------------------------
# The kernel's order of summation, in numpy float32.
# ---------------------------------------------------------------------------

def kernel_stats(rows: np.ndarray, s: np.ndarray, groups: int, g) -> tuple:
    """mean, rstd [N, G] float32 of y [N, R, C] int32 dequantized by s [C],
    summed as csrc/requant.cu sums them under geometry `g`."""
    f32 = np.float32
    N, R, C = rows.shape
    cpg = C // groups
    count = f32(R) * f32(cpg)
    mean = np.empty((N, groups), f32)
    rstd = np.empty((N, groups), f32)
    for n in range(N):
        total = np.zeros((2, groups), f32)
        for rank in range(g.cluster):
            r0 = min(R, rank * g.rpb)
            x = rows[n, r0:min(R, r0 + g.rpb)].astype(f32) * s        # __fmul_rn
            # Thread (ro, c) adds rows ro, ro + rpi, ... in order.
            acc = np.zeros((2, g.rpi, C), f32)
            for k0 in range(0, x.shape[0], g.rpi):
                part = x[k0:k0 + g.rpi]
                acc[0, :len(part)] = acc[0, :len(part)] + part
                acc[1, :len(part)] = acc[1, :len(part)] + part * part
            stride = g.rpi // 2
            while stride:                                                # the tree
                acc[:, :stride] = acc[:, :stride] + acc[:, stride:2 * stride]
                stride //= 2
            per_group = acc[:, 0].reshape(2, groups, cpg)
            part = np.zeros((2, groups), f32)
            for k in range(cpg):                                         # channel order
                part = part + per_group[:, :, k]
            total = total + part                                         # rank order
        mu = total[0] / count
        var = np.maximum(total[1] / count - mu * mu, f32(0))
        mean[n] = mu
        rstd[n] = f32(1) / np.sqrt(var + f32(requant.GN_EPS))
    return mean, rstd


def kernel_epilogue(y, s, gamma, beta, groups, g, out_scale):
    """The whole kernel without a residual, in numpy float32: statistics in
    the kernel's order, then ((y * s - mean) * rstd) * gamma + beta, relu,
    and int8 (rint, half to even) or bfloat16."""
    N, H, W, C = y.shape
    rows = y.reshape(N, H * W, C)
    mean, rstd = kernel_stats(rows, s, groups, g)
    cpg = C // groups
    mu = np.repeat(mean, cpg, axis=1)[:, None, :]
    rs = np.repeat(rstd, cpg, axis=1)[:, None, :]
    x = ((rows.astype(np.float32) * s - mu) * rs) * gamma + beta
    x = np.maximum(x, np.float32(0))
    if out_scale is None:
        return torch.from_numpy(x.reshape(y.shape)).to(torch.bfloat16), mean, rstd
    q = np.clip(np.rint(x * np.float32(1.0 / out_scale)), -127, 127).astype(np.int8)
    return torch.from_numpy(q.reshape(y.shape)), mean, rstd


def _site_inputs(seed, shape):
    """Convolution-like int32 rows: a channel offset and spread, so the
    means are not lost in the noise of the sums."""
    rng = np.random.default_rng(seed)
    C = shape[-1]
    centre = rng.normal(0, 4000, C)
    y = (centre + rng.normal(0, 8000, shape)).round().astype(np.int32)
    s = rng.uniform(1e-4, 3e-4, C).astype(np.float32)
    gamma = rng.normal(1.0, 0.1, C).astype(np.float32)
    beta = rng.normal(0.0, 0.1, C).astype(np.float32)
    return y, s, gamma, beta


def _exact_stats(rows, s, groups):
    """mean, rstd [N, G] in float64 from the float32 dequantized rows, and the
    root mean square, the scale a mean's rounding is measured against."""
    N, R, C = rows.shape
    x = (rows.astype(np.float32) * s).astype(np.float64).reshape(N, R, groups, C // groups)
    mean, sq = x.mean(axis=(1, 3)), (x * x).mean(axis=(1, 3))
    rstd = 1.0 / np.sqrt(np.maximum(sq - mean * mean, 0.0) + requant.GN_EPS)
    return mean, rstd, np.sqrt(sq)


def _ulps(got, want, scale):
    return np.abs(np.asarray(got, np.float64) - want) / np.spacing(scale.astype(np.float32))


# The stem and the last deconvolution at N = 2 (the geometry of batch 2).
@pytest.mark.parametrize("shape,out_scale", [((2, 128, 96, 64), 0.05), ((2, 64, 48, 128), None)])
def test_kernel_summation_order_matches_the_plain_version(shape, out_scale):
    y, s, gamma, beta = _site_inputs(sum(shape), shape)
    N, H, W, C = shape
    groups = 32
    g = requant.launch_geometry(N, H * W, C, groups, 0, out_scale is not None)
    assert g.staged and g.cluster == 16
    got, mean, rstd = kernel_epilogue(y, s, gamma, beta, groups, g, out_scale)

    ty, ts, tg, tb = (torch.from_numpy(a) for a in (y, s, gamma, beta))
    _, t_mean, t_rstd = requant.group_stats(ty.float() * ts, groups)
    t_mean = t_mean.reshape(N, groups).numpy()
    t_rstd = t_rstd.reshape(N, groups).numpy()
    # Within a few ulp of the exact statistics (a mean in ulp of the rows' root
    # mean square); group_stats, summed in torch's order on the CPU, is itself
    # 6-32 ulp off them at these shapes, so the kernel's order sits within that
    # distance of group_stats, plus a few ulp.
    e_mean, e_rstd, rms = _exact_stats(y.reshape(N, H * W, C), s, groups)
    assert _ulps(mean, e_mean, rms).max() <= 2
    assert _ulps(rstd, e_rstd, e_rstd).max() <= 4
    assert (_ulps(mean, t_mean, rms) <= _ulps(t_mean, e_mean, rms) + 2).all()
    assert (_ulps(rstd, t_rstd, e_rstd) <= _ulps(t_rstd, e_rstd, e_rstd) + 4).all()
    want = requant.requant_epilogue_plain(ty, ts, tg, tb, groups, out_scale=out_scale)
    if out_scale is None:
        w = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
        assert bool(((got.float() - w).abs() <= ulp.clamp(min=1e-5)).all())
    else:
        diff = (got.int() - want.int()).abs()
        assert int(diff.max()) <= 1
        assert float((diff != 0).float().mean()) < 1e-3


def test_every_rank_and_row_offset_enters_the_sums():
    # Rows of ones: each block's sum is its row count, so a rank or a row
    # offset dropped from the order shows in the mean.
    N, R, C, groups = 1, 1000, 16, 4
    g = requant.launch_geometry(N, R, C, groups, 0, True)
    assert g.cluster > 1 and g.rpi > 1
    rows = np.ones((N, R, C), np.int32)
    rows[0, R - 1] = 1 + R                         # the last row of the last rank
    mean, _ = kernel_stats(rows, np.ones(C, np.float32), groups, g)
    assert np.allclose(mean, 2.0)
