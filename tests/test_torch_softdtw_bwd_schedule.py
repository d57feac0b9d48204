"""What kernel E (csrc/softdtw_bwd.cu) rests on, checked without a card: the
launch geometry of `ops.softdtw.backward_geometry` for every Ta up to 1200,
and the kernel's two phases transcribed to numpy --

  * the weights: every slot (diagonal k, row q of lane t) holds the three
    successor weights of cell (t * rows + q, k - t * rows - q) in the layout
    W[k][c][q][t], 0 for a successor outside the table, -1 as the "down"
    weight of a cell that is not live (outside the table, or D >= INF);
  * the chain: lane t holds `rows` consecutive rows, E diagonals k+1 and
    k+2 in registers, the "down" successor of its last row shuffled down
    from lane t+1 (lane 31 of a warp: the next warp's boundary slot, 0 for
    the last warp), the "diagonal" one the previous step's shuffle, then
    ((w_down * down + w_right * right) + w_diag * diag) rounded after each
    operation, and 0 where w_down < 0 --

equal to `softdtw_backward_plain` to the bit.  The exponentials themselves
are torch's, computed on the plain version's [B, Ta] shapes as it computes
them (what is transcribed is where each weight goes and what the chain does
with it).  The kernel is held to its plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from golfaction_tpu_torch.ops import softdtw

INF = 1e10


@pytest.mark.parametrize("Tb", [1, 20, 64, 600])
def test_geometry_owns_every_row_once_for_every_ta(Tb):
    for Ta in range(1, 1201):
        for B in (1, 4, 96, 600):
            g = softdtw.backward_geometry(B, Ta, Tb)
            assert g.rows in (1, 2, 4, 8)
            lanes = 32 * g.warps
            assert lanes * g.rows >= Ta and lanes * g.rows - Ta < 32 * g.rows, "rows owned once"
            assert g.rows == 8 or 32 * g.rows >= Ta, "one warp while Ta <= 256"
            assert g.warps == 1 or g.tables == 1, "a table of several warps has its block"
            assert g.tables == 1 or B >= g.tables * softdtw.H100_SMS
            assert not g.fits or g.warps == 1
            assert g.tables * 32 <= (softdtw.BWD_FIT_THREADS if g.fits else 1024)
            assert g.smem <= softdtw.MAX_SMEM
            assert g.smem == softdtw._backward_smem(Ta, Tb, g.rows, g.warps, g.tables, g.fits,
                                                     g.ring)
            assert g.fits == (g.warps == 1 and softdtw._backward_smem(
                Ta, Tb, g.rows, 1, g.tables, True, 0) <= softdtw.MAX_SMEM)
            if not g.fits:                       # the deepest ring that fits
                deeper = {8: 32, 2: 8}.get(g.ring)
                assert g.ring in ((32, 8) if g.warps == 1 else (8, 2))
                assert deeper is None or (g.warps > 1 and deeper == 32) or softdtw._backward_smem(
                    Ta, Tb, g.rows, g.warps, g.tables, False, deeper) > softdtw.MAX_SMEM


def test_training_shape_and_the_limits():
    # One train_align step: 96 tables of 48 x 48 in one launch, 91 KB a block.
    g = softdtw.backward_geometry(96, 48, 48)
    assert g == (2, 1, 1, True, 0, 4 * (2 * 48 * 48 + 3 * 95 * 64))
    assert softdtw.backward_geometry(600, 48, 48).tables == 2          # 4 do not fit
    assert softdtw.backward_geometry(8, 128, 64)[3:5] == (False, 32)
    assert softdtw.backward_geometry(600, 200, 200)[2:5] == (4, False, 8)  # 32 do not fit
    assert softdtw.backward_geometry(1, 2304, 5)[1:5] == (9, 1, False, 8)
    assert softdtw.backward_geometry(1, 3000, 5).ring == 2             # 12 warps
    assert softdtw.backward_geometry(1, 8192, 3).warps == 32
    with pytest.raises(ValueError, match="transposed"):
        softdtw.backward_geometry(1, 8193, 3)


def weights_phase(D: torch.Tensor, R: torch.Tensor, gamma: float, g) -> np.ndarray:
    """W [B, K, 3, rows, lanes] float32 as the kernel lays it out."""
    B, Ta, Tb = D.shape
    K, rows, lanes = Ta + Tb - 1, g.rows, 32 * g.warps
    i = torch.arange(Ta)
    neg_inf = torch.tensor(float("-inf"))
    W = np.zeros((B, K, 3, rows, lanes), np.float32)
    W[:, :, 0] = -1.0                            # rows past Ta are never live

    def at(M, ii, jj):
        return M[:, ii.clamp(0, Ta - 1), jj.clamp(0, Tb - 1)]

    for k in range(K):
        j = k - i
        in_band = (j >= 0) & (j < Tb)
        r0 = at(R, i, j)
        live = (in_band & (at(D, i, j) < INF)).numpy()
        for c, (di, dj) in enumerate(((1, 0), (0, 1), (1, 1))):
            ok = in_band & (i + di < Ta) & (j + dj < Tb)
            expo = (at(R, i + di, j + dj) - r0 - at(D, i + di, j + dj)) / gamma
            w = torch.exp(torch.where(ok, expo, neg_inf)).numpy()          # [B, Ta]
            if c == 0:
                w = np.where(live, w, np.float32(-1.0))
            # slot of row i: lane i // rows, register q = i % rows
            W[:, k, c, i.numpy() % rows, i.numpy() // rows] = w
    return W


def chain_phase(D: torch.Tensor, W: np.ndarray, g) -> np.ndarray:
    """E [B, Ta, Tb] from the weights, step by step as the warps run.  As in
    the one-launch kernel, diagonal k's E goes over diagonal k's "down"
    weights (read the step before), and is put back in row order at the end."""
    B, Ta, Tb = D.shape
    K, rows, warps = Ta + Tb - 1, g.rows, g.warps
    lanes = 32 * warps
    f32 = np.float32
    corner = np.where(D[:, Ta - 1, Tb - 1].numpy() < INF, f32(1.0), f32(0.0))
    e1 = np.zeros((B, lanes, rows), f32)                 # diagonal k+1 of each row
    e2 = np.zeros((B, lanes, rows), f32)                 # diagonal k+2
    e1[:, (Ta - 1) // rows, (Ta - 1) % rows] = corner
    bnd = np.zeros((B, 2, warps), f32)                   # shared memory [2][warps]
    bnd[:, (K - 1) & 1, :] = e1[:, ::32, 0]
    W = W.copy()
    W[:, K - 1, 0] = e1.transpose(0, 2, 1)
    shprev = np.zeros((B, lanes), f32)
    for k in range(K - 2, -1, -1):
        w = W[:, k]                                       # [B, 3, rows, lanes]
        # __shfl_down_sync of each lane's first row; lane 31 of warp w takes
        # the boundary slot of warp w+1 (0 for the last warp).
        sh = np.concatenate([e1[:, 1:, 0], e1[:, -1:, 0]], axis=1)
        for wt in range(warps):
            sh[:, 32 * wt + 31] = bnd[:, (k + 1) & 1, wt + 1] if wt + 1 < warps else 0.0
        down = np.concatenate([e1[:, :, 1:], sh[:, :, None]], axis=2)
        diag = np.concatenate([e2[:, :, 1:], shprev[:, :, None]], axis=2)
        wd, wr, wg = (w[:, c].transpose(0, 2, 1) for c in range(3))    # [B, lanes, rows]
        s = (wd * down + wr * e1) + wg * diag            # float32, rounded after each op
        e = np.where(wd < 0, f32(0.0), s).astype(f32)
        e2, e1, shprev = e1, e, sh
        bnd[:, k & 1, :] = e[:, ::32, 0]
        W[:, k, 0] = e.transpose(0, 2, 1)                # [B, rows, lanes]
    i, j = np.meshgrid(np.arange(Ta), np.arange(Tb), indexing="ij")
    return W[:, i + j, 0, i % rows, i // rows]


def _inputs(B, Ta, Tb, pad, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, Ta, 16)).astype(np.float32)
    c = rng.normal(size=(B, Tb, 16)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    D = softdtw.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(c)).contiguous()
    if pad and Ta > 2 and Tb > 2:
        D[0, Ta - 2:, :] = INF                       # a padded tail: the corner is INF
        D[-1, Ta // 2, :Tb - 1] = INF                # INF cells inside the table
    return D


@pytest.mark.parametrize("B", [1, 5, 200])
@pytest.mark.parametrize("Ta,Tb", [(1, 1), (7, 3), (48, 48), (64, 64), (300, 17)])
@pytest.mark.parametrize("gamma", [0.1, 1.0])
def test_two_phases_equal_the_plain_version_to_the_bit(B, Ta, Tb, gamma):
    g = softdtw.backward_geometry(B, Ta, Tb)
    D = _inputs(B, Ta, Tb, pad=B > 1, seed=Ta * Tb + B)
    R = softdtw.wavefront_plain(D, gamma)
    E = chain_phase(D, weights_phase(D, R, gamma, g), g)
    want = softdtw.softdtw_backward_plain(D, R, gamma)
    assert torch.equal(torch.from_numpy(E), want)
