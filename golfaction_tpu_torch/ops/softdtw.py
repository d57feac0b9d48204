"""Soft-DTW temporal alignment: anti-diagonal wavefront (kernel C) and its
backward, the E-recursion as a reverse wavefront (kernel E).

  * `wavefront` — the DP table of a batch of cost matrices, soft-min
    (gamma > 0) or hard min (gamma == 0).  On a CUDA tensor it launches the
    hand-written kernel (csrc/softdtw.cu: one warp per table, rows in
    registers, cut by `wavefront_geometry`), which replaces the TPU kernel
    golfaction_tpu/ops/pallas/softdtw_kernel.py (_wavefront_batch_jit); on a
    CPU tensor it runs `wavefront_plain`, the same anti-diagonal recursion.
  * `softdtw_backward` — E = d cost / d D of a batch of tables, which is
    also the soft alignment matrix.  On a CUDA tensor it launches the
    hand-written kernel (csrc/softdtw_bwd.cu: the weights computed up front
    by the whole block, then one warp a table runs the chain, cut by
    `backward_geometry`), which replaces the TPU kernel
    golfaction_tpu/ops/pallas/softdtw_kernel.py (_backward_batch_jit); on a
    CPU tensor it runs `softdtw_backward_plain`.
  * `softdtw_cost` — the differentiable cost: forward through `wavefront`,
    backward through `softdtw_backward`.
  * `softdtw_cost_masked` / `dtw_path_masked` — cost and hard path of
    D[:la, :lb] read from the full padded table: the DP flows strictly
    forward, so R[0:la, 0:lb] equals the trimmed problem's table.
    `dtw_path` is the hard path over the whole table.
  * `softdtw_reference` / `softdtw_grad_reference` / `dtw_path_reference` —
    O(Ta*Tb) numpy loop oracles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from golfaction_tpu_torch.ops import _kernels
from golfaction_tpu_torch.utils import profiling

_INF = 1e10


# ---------------------------------------------------------------------------
# NumPy oracles
# ---------------------------------------------------------------------------

def softmin_np(values, gamma):
    values = np.asarray(values, dtype=np.float64)
    m = values.min()
    return float(m - gamma * np.log(np.exp(-(values - m) / gamma).sum()))


def softdtw_reference(D: np.ndarray, gamma: float) -> tuple[float, np.ndarray]:
    """O(Ta·Tb) loop DP.  Returns (cost, R) with R the padded DP table."""
    Ta, Tb = D.shape
    R = np.full((Ta + 1, Tb + 1), np.inf, dtype=np.float64)
    R[0, 0] = 0.0
    for i in range(1, Ta + 1):
        for j in range(1, Tb + 1):
            R[i, j] = D[i - 1, j - 1] + softmin_np(
                [R[i - 1, j], R[i, j - 1], R[i - 1, j - 1]], gamma
            )
    return float(R[Ta, Tb]), R


def softdtw_grad_reference(D: np.ndarray, R: np.ndarray, gamma: float) -> np.ndarray:
    """Backward E-recursion (Cuturi & Blondel 2017, Alg. 2) over the padded
    table R of `softdtw_reference`.  d cost / d D = E."""
    Ta, Tb = D.shape
    E = np.zeros((Ta + 2, Tb + 2), dtype=np.float64)
    E[Ta + 1, Tb + 1] = 1.0
    Rp = np.full((Ta + 2, Tb + 2), -np.inf, dtype=np.float64)
    Rp[1 : Ta + 1, 1 : Tb + 1] = R[1:, 1:]
    Rp[Ta + 1, Tb + 1] = R[Ta, Tb]
    Dp = np.zeros((Ta + 2, Tb + 2), dtype=np.float64)
    Dp[1 : Ta + 1, 1 : Tb + 1] = D
    for i in range(Ta, 0, -1):
        for j in range(Tb, 0, -1):
            a = np.exp((Rp[i + 1, j] - Rp[i, j] - Dp[i + 1, j]) / gamma)
            b = np.exp((Rp[i, j + 1] - Rp[i, j] - Dp[i, j + 1]) / gamma)
            c = np.exp((Rp[i + 1, j + 1] - Rp[i, j] - Dp[i + 1, j + 1]) / gamma)
            E[i, j] = a * E[i + 1, j] + b * E[i, j + 1] + c * E[i + 1, j + 1]
    return E[1 : Ta + 1, 1 : Tb + 1]


def dtw_path_reference(D: np.ndarray) -> np.ndarray:
    """Classic hard-DTW optimal path (list of (i, j)) by backtracking."""
    Ta, Tb = D.shape
    R = np.full((Ta + 1, Tb + 1), np.inf)
    R[0, 0] = 0.0
    for i in range(1, Ta + 1):
        for j in range(1, Tb + 1):
            R[i, j] = D[i - 1, j - 1] + min(R[i - 1, j], R[i, j - 1], R[i - 1, j - 1])
    path = [(Ta - 1, Tb - 1)]
    i, j = Ta, Tb
    while (i, j) != (1, 1):
        opts = [(R[i - 1, j - 1], (i - 1, j - 1)), (R[i - 1, j], (i - 1, j)),
                (R[i, j - 1], (i, j - 1))]
        _, (i, j) = min(opts, key=lambda t: t[0])
        path.append((i - 1, j - 1))
    return np.array(path[::-1], dtype=np.int32)


# ---------------------------------------------------------------------------
# Wavefront
# ---------------------------------------------------------------------------

def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances D[..., Ta, Tb] = |a|² + |b|² - 2 a·bᵀ, >= 0."""
    a = a.float()
    b = b.float()
    an = (a * a).sum(-1)
    bn = (b * b).sum(-1)
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp(an[..., :, None] + bn[..., None, :] - 2.0 * ab, min=0.0)


def _softmin3(a, b, c, gamma: float):
    m = torch.minimum(torch.minimum(a, b), c)
    s = (torch.exp(-(a - m) / gamma) + torch.exp(-(b - m) / gamma)
         + torch.exp(-(c - m) / gamma))
    return m - gamma * torch.log(s)


def wavefront_plain(D: torch.Tensor, gamma: float, top=None, left=None,
                    corner=None) -> torch.Tensor:
    """D [B, Ta, Tb] -> R [B, Ta, Tb]: one step per anti-diagonal, each
    diagonal indexed by row i (cell (i, k - i)); out-of-table cells are +INF
    and a virtual R[-1, -1] = 0 feeds cell (0, 0).  Given a boundary, R of
    one tile of a larger table: top [B, Tb] = R of the row above, left
    [B, Ta] = R of the column to the left, corner [B] = R above-left (the
    defaults, +INF, +INF and 0, give the whole table)."""
    B, Ta, Tb = D.shape
    D = D.float()
    dev = D.device
    i = torch.arange(Ta, device=dev)
    inf_col = torch.full((B, 1), _INF, dtype=torch.float32, device=dev)
    r1 = torch.full((B, Ta), _INF, dtype=torch.float32, device=dev)
    r2 = r1.clone()
    inf_k = inf_col.expand(B, Ta - 1)
    top = inf_col.expand(B, Tb) if top is None else top
    up0 = torch.cat([top, inf_k], dim=1)                       # R[-1, k]
    corner = torch.zeros_like(inf_col) if corner is None else corner.reshape(B, 1)
    dg0 = torch.cat([corner, top, inf_k], dim=1)               # R[-1, k - 1]
    if left is not None:
        left_sh = torch.cat([inf_col, left[:, :-1]], dim=1)   # R[i - 1, -1]
    diags = []
    for k in range(Ta + Tb - 1):
        j = k - i
        in_band = (j >= 0) & (j < Tb)
        d = torch.where(in_band, D[:, i, j.clamp(0, Tb - 1)], _INF)
        up = torch.cat([up0[:, k:k + 1], r1[:, :-1]], dim=1)
        dg = torch.cat([dg0[:, k:k + 1], r2[:, :-1]], dim=1)
        lf = r1
        if left is not None:
            first = i == k                                     # j == 0
            lf = torch.where(first, left, r1)
            dg = torch.where(first & (i > 0), left_sh, dg)
        if gamma > 0:
            sm = _softmin3(lf, up, dg, gamma)
        else:
            sm = torch.minimum(torch.minimum(lf, up), dg)
        r0 = torch.where(d >= _INF, _INF, d + sm)
        diags.append(r0)
        r1, r2 = r0, r1
    table = torch.stack(diags, dim=1)                  # [B, K, Ta]
    ii = i[:, None].expand(Ta, Tb)
    jj = torch.arange(Tb, device=dev)[None, :].expand(Ta, Tb)
    return table[:, ii + jj, ii]


MAX_SMEM = 232448            # 227 KB, the most shared memory a block may ask for
MAX_ROWS = 8                 # rows a lane holds: Ta <= 256 in one warp
TABLES_PER_BLOCK = 4         # the most tables a block takes, when B outnumbers the SMs
H100_SMS = 132


class WavefrontGeometry(NamedTuple):
    """Kernel C's launch: each lane holds `rows` consecutive rows, a table
    takes `warps` warps (more than one only for Ta > 32 * MAX_ROWS) and a
    block `tables` tables; `staged`: D (then R) in shared memory, `smem`
    bytes a block."""
    rows: int
    warps: int
    tables: int
    staged: bool
    smem: int


def _wavefront_smem(Ta: int, Tb: int, warps: int, tables: int, staged: bool) -> int:
    """Shared memory as csrc/softdtw.cu lays it out: one slot of Ta*Tb floats
    (rounded up to 4) per table when staged, then the boundary hand-over
    [2, warps]."""
    slot = -(-Ta * Tb // 4) * 4
    return 4 * ((tables * slot if staged else 0) + 2 * warps)


def wavefront_geometry(B: int, Ta: int, Tb: int, sms: int = H100_SMS) -> WavefrontGeometry:
    """One warp per table, the fewest rows a lane that hold Ta; several tables
    a block only when B outnumbers the SMs; D staged where the block's tables
    fit in shared memory (else the register ring)."""
    rows = 1
    while rows < MAX_ROWS and 32 * rows < Ta:
        rows *= 2
    warps = -(-Ta // (32 * rows))
    tables = 1 if warps > 1 else max(1, min(TABLES_PER_BLOCK, B // sms))
    while tables > 1 and _wavefront_smem(Ta, Tb, warps, tables, True) > MAX_SMEM:
        tables //= 2
    staged = _wavefront_smem(Ta, Tb, warps, tables, True) <= MAX_SMEM
    return WavefrontGeometry(rows, warps, tables, staged,
                             _wavefront_smem(Ta, Tb, warps, tables, staged))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms_of(t: torch.Tensor) -> int:
    return _sm_count(t.device.index if t.device.index is not None else torch.cuda.current_device())


def wavefront(D: torch.Tensor, gamma: float) -> torch.Tensor:
    """DP table R [B, Ta, Tb] of cost matrices D [B, Ta, Tb] (kernel C)."""
    if D.device.type == "cpu":
        return wavefront_plain(D, gamma)
    _kernels.require(D, torch.float32, 3, "softdtw wavefront D")
    B, Ta, Tb = D.shape
    if B == 0:
        return torch.empty_like(D)
    geo = wavefront_geometry(B, Ta, Tb, _sms_of(D))
    R = launch_wavefront(D, gamma, geo)
    wavefront.launches += 1
    return R


def launch_wavefront(D: torch.Tensor, gamma: float, geo: WavefrontGeometry) -> torch.Tensor:
    """Kernel C on a checked CUDA D [B, Ta, Tb] under launch `geo` (the
    wrapper's, or another one to measure); counts no launch."""
    B, Ta, Tb = D.shape
    R = torch.empty_like(D)
    vec = (Ta * Tb) % 4 == 0 and D.data_ptr() % 16 == 0 and R.data_ptr() % 16 == 0
    fn = _kernels.bind("softdtw", "softdtw_wavefront_launch", "ppiiifiiiiip")
    rc = fn(_kernels.ptr(D), _kernels.ptr(R), B, Ta, Tb, float(gamma), geo.rows, geo.warps,
            geo.tables, int(geo.staged), int(vec), _kernels.stream_of(D))
    _kernels.check(rc, "softdtw wavefront kernel")
    return R


wavefront.launches = 0


# ---------------------------------------------------------------------------
# Backward (E-recursion) and the differentiable cost
# ---------------------------------------------------------------------------

def softdtw_backward_plain(D: torch.Tensor, R: torch.Tensor, gamma: float) -> torch.Tensor:
    """(D, R) [B, Ta, Tb] -> E [B, Ta, Tb]: the mirror of `wavefront_plain`,
    one step per anti-diagonal from k = Ta+Tb-2 down to 0, each diagonal
    indexed by row i.  Cell (i, k-i) pulls from its successors down (i+1, j),
    right (i, j+1) and diagonal (i+1, j+1) with weight
    exp((R[s] - R[i, j] - D[s]) / gamma); a successor outside the table
    weighs 0 by an index test made before the exponential."""
    B, Ta, Tb = D.shape
    D = D.float()
    R = R.float()
    dev = D.device
    i = torch.arange(Ta, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    e1 = torch.zeros((B, Ta), dtype=torch.float32, device=dev)
    e2 = e1.clone()
    K = Ta + Tb - 1

    def at(M, ii, jj):
        return M[:, ii.clamp(0, Ta - 1), jj.clamp(0, Tb - 1)]

    def below(e):                                     # e[i] -> e[i + 1]
        return torch.cat([e[:, 1:], zero_col], dim=1)

    diags = [None] * K
    for k in range(K - 1, -1, -1):
        j = k - i
        in_band = (j >= 0) & (j < Tb)
        r0 = at(R, i, j)

        def term(di, dj, e_succ):
            ok = in_band & (i + di < Ta) & (j + dj < Tb)
            expo = (at(R, i + di, j + dj) - r0 - at(D, i + di, j + dj)) / gamma
            return torch.exp(torch.where(ok, expo, neg_inf)) * e_succ

        e0 = term(1, 0, below(e1)) + term(0, 1, e1) + term(1, 1, below(e2))
        if k == K - 1:
            e0 = torch.where(i == Ta - 1, 1.0, e0)
        e0 = torch.where(in_band & (at(D, i, j) < _INF), e0, 0.0)
        diags[k] = e0
        e1, e2 = e0, e1
    table = torch.stack(diags, dim=1)                  # [B, K, Ta]
    ii = i[:, None].expand(Ta, Tb)
    jj = torch.arange(Tb, device=dev)[None, :].expand(Ta, Tb)
    return table[:, ii + jj, ii]


BWD_FIT_THREADS = 1024      # a block of E's one-launch layout (csrc/softdtw_bwd.cu kFitThreads)
BWD_MAX_WARPS = 32          # warps a table may take: Ta <= 32 * 32 * MAX_ROWS


class BackwardGeometry(NamedTuple):
    """Kernel E's launch: each lane holds `rows` consecutive rows, a table
    takes `warps` warps (more than one only for Ta > 32 * MAX_ROWS) and a
    block `tables` tables; `fits`: one launch with D, R and the weights of
    the block's tables in shared memory, else a launch that writes the
    weights to device memory and a chain launch with a ring of `ring`
    diagonals of them a warp; `smem` bytes a block."""
    rows: int
    warps: int
    tables: int
    fits: bool
    ring: int
    smem: int


def _backward_smem(Ta: int, Tb: int, rows: int, warps: int, tables: int, fits: bool,
                   ring: int) -> int:
    """Shared memory as csrc/softdtw_bwd.cu lays it out: per table the staged
    D and R slots and the weights [Ta+Tb-1][3][rows][32] when `fits`; else a
    ring [ring][3][rows][32] a warp, then the boundary hand-over [2, warps]."""
    if fits:
        slot = -(-Ta * Tb // 4) * 4
        return 4 * tables * (2 * slot + 3 * (Ta + Tb - 1) * 32 * rows)
    return 4 * (tables * warps * ring * 3 * 32 * rows + 2 * warps)


@functools.lru_cache(maxsize=256)
def backward_geometry(B: int, Ta: int, Tb: int, sms: int = H100_SMS) -> BackwardGeometry:
    """Rows and warps as kernel C's; several tables a block only when B
    outnumbers the SMs; one launch where the block's tables and their
    weights fit in shared memory (one warp a table), else two, with a ring
    of diagonals a warp: 32 (one warp a table) or 8 where they fit, else 2
    (more than 9 warps a table)."""
    rows = 1
    while rows < MAX_ROWS and 32 * rows < Ta:
        rows *= 2
    warps = -(-Ta // (32 * rows))
    if warps > BWD_MAX_WARPS:
        raise ValueError(f"softdtw backward on the card: Ta = {Ta} takes more than "
                         f"{BWD_MAX_WARPS} warps of {MAX_ROWS} rows; pass the transposed "
                         f"problem (E of D^T is E^T) when Tb is smaller")
    tables = 1 if warps > 1 else max(1, min(TABLES_PER_BLOCK, B // sms))
    if warps == 1:
        t = tables
        while t > 1 and _backward_smem(Ta, Tb, rows, 1, t, True, 0) > MAX_SMEM:
            t //= 2
        smem = _backward_smem(Ta, Tb, rows, 1, t, True, 0)
        if smem <= MAX_SMEM:
            return BackwardGeometry(rows, 1, t, True, 0, smem)
        ring = 32 if _backward_smem(Ta, Tb, rows, 1, tables, False, 32) <= MAX_SMEM else 8
    else:
        ring = 8 if warps <= 9 else 2
    return BackwardGeometry(rows, warps, tables, False, ring,
                            _backward_smem(Ta, Tb, rows, warps, tables, False, ring))


def softdtw_backward(D: torch.Tensor, R: torch.Tensor, gamma: float) -> torch.Tensor:
    """E [B, Ta, Tb] = d R[:, -1, -1] / d D from the cost matrices D and
    their soft-DTW tables R (kernel E).  gamma > 0."""
    if gamma <= 0:
        raise ValueError("softdtw_backward needs gamma > 0: the hard minimum "
                         "has no E-recursion")
    if D.device.type == "cpu":
        return softdtw_backward_plain(D, R, gamma)
    _kernels.require(D, torch.float32, 3, "softdtw backward D")
    _kernels.require(R, torch.float32, 3, "softdtw backward R")
    if R.shape != D.shape:
        raise ValueError(f"softdtw backward: D {tuple(D.shape)} and R {tuple(R.shape)} differ")
    B, Ta, Tb = D.shape
    if B == 0:
        return torch.empty_like(D)
    if Ta > BWD_MAX_WARPS * 32 * MAX_ROWS and Tb < Ta:
        # E of the transposed problem is E transposed, to the bit: the
        # successors' sum only swaps its first two terms.
        E = softdtw_backward(D.transpose(1, 2).contiguous(), R.transpose(1, 2).contiguous(),
                             gamma)
        return E.transpose(1, 2).contiguous()
    geo = backward_geometry(B, Ta, Tb, _sms_of(D))
    E = launch_backward(D, R, gamma, geo)
    softdtw_backward.launches += 1
    return E


def launch_backward(D: torch.Tensor, R: torch.Tensor, gamma: float,
                    geo: BackwardGeometry) -> torch.Tensor:
    """Kernel E on checked CUDA D, R [B, Ta, Tb] under launch `geo` (the
    wrapper's, or another one to measure); counts no launch."""
    B, Ta, Tb = D.shape
    E = torch.empty_like(D)
    W = None
    if not geo.fits:         # the weights [B, Ta+Tb-1, 3, rows, 32 * warps]
        W = torch.empty(B * (Ta + Tb - 1) * 3 * 32 * geo.rows * geo.warps,
                        dtype=torch.float32, device=D.device)
    vec = ((Ta * Tb) % 4 == 0 and D.data_ptr() % 16 == 0 and R.data_ptr() % 16 == 0
           and E.data_ptr() % 16 == 0)
    fn = _kernels.bind("softdtw_bwd", "softdtw_backward_launch", "ppppiiifiiiiiip")
    rc = fn(_kernels.ptr(D), _kernels.ptr(R), _kernels.ptr(E),
            _kernels.ptr(W) if W is not None else None, B, Ta, Tb, float(gamma), geo.rows,
            geo.warps, geo.tables, int(geo.fits), geo.ring, int(vec), _kernels.stream_of(D))
    _kernels.check(rc, "softdtw backward kernel")
    return E


softdtw_backward.launches = 0


class _SoftDTWCost(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma, plain):
        D = D.float().contiguous()       # autograd may hand over a strided view
        R = (wavefront_plain if plain else wavefront)(D, gamma)
        ctx.save_for_backward(D, R)
        ctx.gamma, ctx.plain = gamma, plain
        return R[:, -1, -1].clone()

    @staticmethod
    def backward(ctx, g):
        D, R = ctx.saved_tensors
        bwd = softdtw_backward_plain if ctx.plain else softdtw_backward
        return g[:, None, None] * bwd(D, R, ctx.gamma), None, None


def softdtw_cost(D: torch.Tensor, gamma: float, plain: bool = False) -> torch.Tensor:
    """Soft-DTW cost [B] of cost matrices D [B, Ta, Tb], differentiable in D:
    one wavefront forward (kernel C on the card), one E-recursion backward
    (kernel E on the card).  `plain` runs both through their plain versions
    on any device (the baseline that `softdtw_bwd_bench` times)."""
    if gamma <= 0:
        raise ValueError("softdtw_cost needs gamma > 0: the hard minimum has "
                         "no E-recursion; use dtw_path_masked for hard DTW")
    if D.dim() != 3:
        raise ValueError(f"softdtw_cost: expected D [B, Ta, Tb], got {tuple(D.shape)}")
    return _SoftDTWCost.apply(D, gamma, plain)


def softdtw_with_alignment(D: torch.Tensor, gamma: float):
    """(cost [B], E [B, Ta, Tb]) of D [B, Ta, Tb]; E is the soft alignment
    matrix (the expected alignment under the Gibbs distribution)."""
    D = D.float().contiguous()
    R = wavefront(D, gamma)
    return R[:, -1, -1], softdtw_backward(D, R, gamma)


def softdtw_cost_masked(D: torch.Tensor, la: torch.Tensor, lb: torch.Tensor,
                        gamma: float) -> torch.Tensor:
    """Soft-DTW cost of D[b, :la, :lb] for a batch D [B, Ta, Tb] -> [B]."""
    R = wavefront(D, gamma)
    bi = torch.arange(D.shape[0], device=D.device)
    return R[bi, la.long() - 1, lb.long() - 1]


def dtw_path_masked(D: torch.Tensor, la: torch.Tensor, lb: torch.Tensor):
    """Hard DTW path of D[b, :la, :lb]; path [B, Ta+Tb-1, 2] int32 padded
    with -1, and lengths [B] int32."""
    return _backtrack(wavefront(D, 0.0), la, lb)


def dtw_path(D: torch.Tensor):
    """Hard DTW path over the whole of D [Ta, Tb] (or a batch [B, Ta, Tb]):
    path [Ta+Tb-1, 2] int32 from (0, 0) to (Ta-1, Tb-1), padded with -1, and
    its length; `dtw_path_masked` at full lengths (kernel C at gamma 0, then
    the backtrack, on the card)."""
    single = D.dim() == 2
    Db = (D[None] if single else D).float().contiguous()
    B, Ta, Tb = Db.shape
    la = torch.full((B,), Ta, dtype=torch.int32, device=D.device)
    lb = torch.full((B,), Tb, dtype=torch.int32, device=D.device)
    path, length = dtw_path_masked(Db, la, lb)
    return (path[0], length[0]) if single else (path, length)


def _backtrack(R: torch.Tensor, la: torch.Tensor, lb: torch.Tensor):
    """Backtrack optimal paths from (la-1, lb-1) over hard-min tables R
    [B, Ta, Tb].  Ties go to diagonal, then up, then left (first argmin).

    Runs where R lies, all pairs at once.  Every cell's move is chosen up
    front, with the JAX package's rule (cells outside the table cost INF);
    the walk is then a fixed L = Ta+Tb-1 steps of one gather each over flat
    cell indices, and (0, 0) steps to itself."""
    B, Ta, Tb = R.shape
    L = Ta + Tb - 1
    dev = R.device
    Rp = torch.nn.functional.pad(R.float(), (1, 0, 1, 0), value=_INF)
    pred = torch.stack([Rp[:, :-1, :-1], Rp[:, :-1, 1:], Rp[:, 1:, :-1]], dim=-1)
    move = pred.argmin(dim=-1)                  # 0 diagonal, 1 up, 2 left
    # On the edges INF ties only when R itself reached INF; stay in the table.
    move[:, 0, 1:] = 2
    move[:, 1:, 0] = 1
    move[:, 0, 0] = 3                           # stay
    with profiling.host_sync():                 # a copy from host memory waits for the stream
        steps = torch.tensor([Tb + 1, Tb, 1, 0], device=dev)
    back = steps[move].reshape(B, Ta * Tb)
    p = ((la.to(dev, torch.long) - 1) * Tb + lb.to(dev, torch.long) - 1)[:, None]
    rev = torch.empty((B, L), dtype=torch.long, device=dev)
    for s in range(L):
        rev[:, s] = p[:, 0]
        p = p - torch.gather(back, 1, p)
    length = (rev != 0).sum(dim=1) + 1          # only (0, 0) has flat index 0
    idx = torch.arange(L, device=dev)[None, :]
    inside = idx < length[:, None]
    flat = torch.gather(rev, 1, torch.where(inside, length[:, None] - 1 - idx, idx))
    path = torch.stack([flat // Tb, flat % Tb], dim=-1)
    path = torch.where(inside[..., None], path, -1)
    return path.to(torch.int32), length.to(torch.int32)


def warp_by_path(ref_vals: torch.Tensor, path: torch.Tensor, length, T: int) -> torch.Tensor:
    """Warp per-frame reference values onto the clip timeline via DTW paths.

    ref_vals [Tr, ...], path [N, L, 2] int32 (clip_idx, ref_idx) rows with -1
    padding beyond `length` [N] -> [N, T, ...]: per clip frame, the mean of
    the reference frames its path aligns to it (zeros where the path never
    visits).  One path [L, 2] with a scalar length gives [T, ...].

    The sums take a fixed order, so that two runs give the same bits: the
    path's entries are sorted by clip frame (stably: a DTW path is already
    monotone, so each frame's entries stay one run in path order), each run
    is laid out along a row of a [N, T + 1, S] table (S the longest run;
    every slot written once, no atomics) and summed along it one slot after
    another, in path order as the JAX scatter-add sums on the CPU.
    """
    single = path.dim() == 2
    if single:
        path = path[None]
    dev = ref_vals.device
    N, L = path.shape[:2]
    extra = (1,) * (ref_vals.dim() - 1)
    length = torch.as_tensor(length, device=dev).reshape(-1).expand(N)
    lmask = torch.arange(L, device=dev)[None, :] < length[:, None]
    ti = torch.where(lmask, path[..., 0].long(), T)          # bucket T collects the pads
    rj = torch.where(lmask, path[..., 1].long(), 0).clamp(0, ref_vals.shape[0] - 1)
    ti, order = torch.sort(ti, dim=1, stable=True)
    rj = torch.gather(rj, 1, order)
    w = torch.gather(lmask, 1, order).float()
    pos = torch.arange(L, device=dev) - torch.searchsorted(ti, ti)   # place in its run
    S = 1
    if L:
        with profiling.host_sync():
            S = int(pos.max()) + 1
    n = torch.arange(N, device=dev)[:, None].expand(N, L)
    acc = torch.zeros((N, T + 1, S, *ref_vals.shape[1:]), dtype=torch.float32, device=dev)
    acc[n, ti, pos] = ref_vals[rj].float() * w.reshape(N, L, *extra)
    cnt = torch.zeros((N, T + 1, S), dtype=torch.float32, device=dev)
    cnt[n, ti, pos] = w
    total = acc[:, :T, 0]
    for k in range(1, S):          # in path order: a run's padding adds exact zeros
        total = total + acc[:, :T, k]
    out = total / cnt[:, :T].sum(2).clamp(min=1.0).reshape(N, T, *extra)
    return out[0] if single else out
