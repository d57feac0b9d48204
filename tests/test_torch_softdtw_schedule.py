"""What kernel C (csrc/softdtw.cu) rests on, checked without a card: the
launch geometry of `ops.softdtw.wavefront_geometry` for every Ta up to 1200,
and the kernel's lane/row schedule transcribed to torch float32 -- each lane
holding `rows` consecutive rows, "up" of its first row shuffled from lane
l-1, "diag" the previous step's "up", the boundary row handed from warp w-1
to warp w, D read from a staged copy that R overwrites or from a register
ring a few diagonals ahead -- equal to `wavefront_plain` to the bit.  The
kernel itself is held to its plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

from golfaction_tpu_torch.ops import softdtw

INF = 1e10
RING = 4                       # csrc/softdtw.cu kRing


@pytest.mark.parametrize("Tb", [1, 20, 64, 600])
def test_geometry_owns_every_row_once_for_every_ta(Tb):
    for Ta in range(1, 1201):
        for B in (1, 4, 96, 600):
            g = softdtw.wavefront_geometry(B, Ta, Tb)
            assert g.rows in (1, 2, 4, 8)
            lanes = 32 * g.warps
            owner = np.repeat(np.arange(lanes), g.rows)        # lane of each row
            assert len(owner) >= Ta and len(owner) - Ta < 32 * g.rows, "rows owned once"
            assert g.rows == 8 or 32 * g.rows >= Ta, "one warp while Ta <= 256"
            assert g.warps == 1 or g.tables == 1, "a table of several warps has its block"
            assert g.tables == 1 or B >= g.tables * softdtw.H100_SMS
            assert g.smem <= softdtw.MAX_SMEM
            assert g.staged == (softdtw._wavefront_smem(Ta, Tb, g.warps, g.tables, True)
                                <= softdtw.MAX_SMEM)


def test_main_path_and_training_shapes():
    assert softdtw.wavefront_geometry(4, 64, 64) == (2, 1, 1, True, 64 * 64 * 4 + 8)
    assert softdtw.wavefront_geometry(96, 48, 48) == (2, 1, 1, True, 48 * 48 * 4 + 8)
    assert softdtw.wavefront_geometry(2, 600, 20) == (8, 3, 1, True, 600 * 20 * 4 + 2 * 3 * 4)
    big = softdtw.wavefront_geometry(4, 512, 512)
    assert (big.rows, big.warps, big.staged) == (8, 2, False)
    assert softdtw.wavefront_geometry(600, 48, 48).tables == 4


def transcribe(D: torch.Tensor, gamma: float, g) -> torch.Tensor:
    """R [B, Ta, Tb] computed the way the kernel's lanes compute it under
    geometry `g`.  Each step gathers every row's (left, up, diag, d) from the
    lanes' registers, the shuffle and the boundary slots, then applies the
    plain version's soft-min to the rows as one [B, Ta] tensor."""
    B, Ta, Tb = D.shape
    rows, warps = g.rows, g.warps
    lanes = 32 * warps
    P = lanes * rows
    i = torch.arange(P)
    lane_of, q_of = i // rows, i % rows
    left = torch.full((B, lanes, rows), INF)              # diagonal k-1 of each row
    upprev = torch.full((B, lanes, rows), INF)            # the previous step's "up"
    bnd = torch.full((B, 2, warps), INF)                  # shared memory [2][warps]
    tab = D.clone()                                       # staged: R overwrites D

    def d_at(k):
        j = k - i
        inside = (i < Ta) & (j >= 0) & (j < Tb)
        src = tab if g.staged else D
        return torch.where(inside, src[:, i.clamp(max=Ta - 1), j.clamp(0, Tb - 1)], INF)

    # D a step ahead: staged, the next diagonal, read before this step's cells
    # are overwritten; else RING diagonals in the register ring.
    depth = 1 if g.staged else RING
    ring = [d_at(p) for p in range(depth)]
    R = torch.full((B, Ta, Tb), float("nan"))
    for k in range(Ta + Tb - 1):
        d = ring[k % depth]
        ring[k % depth] = d_at(k + depth)
        # __shfl_up_sync of each lane's last row; lane 0 of a warp takes the
        # boundary slot of the warp before (INF for warp 0 and at k == 0).
        last = left[:, :, rows - 1]
        up0 = torch.cat([torch.full((B, 1), INF), last[:, :-1]], dim=1)
        for w in range(warps):
            up0[:, 32 * w] = INF if (w == 0 or k == 0) else bnd[:, (k - 1) & 1, w - 1]
        up = torch.cat([up0[:, :, None], left[:, :, :-1]], dim=2)   # row q-1 of the same lane
        diag = upprev
        l_rows = left.reshape(B, P)[:, :Ta].contiguous()
        u_rows = up.reshape(B, P)[:, :Ta].contiguous()
        g_rows = diag.reshape(B, P)[:, :Ta].contiguous()
        if gamma > 0:
            sm = softdtw._softmin3(l_rows, u_rows, g_rows, gamma)
        else:
            sm = torch.minimum(torch.minimum(l_rows, u_rows), g_rows)
        if k == 0:
            sm[:, 0] = 0.0
        r = torch.where(d[:, :Ta] >= INF, INF, d[:, :Ta] + sm)
        new = torch.full((B, P), INF)
        new[:, :Ta] = r
        upprev = up
        left = new.reshape(B, lanes, rows)
        j = k - i[:Ta]
        inside = (j >= 0) & (j < Tb)
        ii, jj = i[:Ta][inside], j[inside]
        (tab if g.staged else R)[:, ii, jj] = r[:, inside]
        for w in range(warps):
            bnd[:, k & 1, w] = left[:, 32 * w + 31, rows - 1]
    assert (lane_of < lanes).all() and (q_of < rows).all()
    return tab if g.staged else R


@pytest.mark.parametrize("B,Ta,Tb", [(3, 7, 11), (4, 64, 64), (2, 600, 20)])
@pytest.mark.parametrize("gamma", [0.1, 0.0])
@pytest.mark.parametrize("staged", [True, False])
def test_lane_schedule_equals_the_plain_version_to_the_bit(B, Ta, Tb, gamma, staged):
    rng = np.random.default_rng(Ta * Tb)
    a = torch.from_numpy(rng.normal(size=(B, Ta, 16)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(B, Tb, 16)).astype(np.float32))
    D = softdtw.pairwise_sqdist(a, c).contiguous()
    g = softdtw.wavefront_geometry(B, Ta, Tb)._replace(staged=staged)
    got = transcribe(D, gamma, g)
    assert torch.equal(got, softdtw.wavefront_plain(D, gamma))
