"""GCN block tail (kernel B): everything between two spatial graph convs.

x [B, T, V, C] (the spatial conv's output, before its LayerNorm) and valid
lengths la [B] -> [B, T, V, C] (before the residual):

  LN0 + relu; multi-branch temporal conv (per branch a 1x1 product, LN,
  relu and a dilated depthwise 3-tap conv; plus a max-pool branch: 1x1, LN,
  temporal max over 3 frames); concat, LN, relu; SE channel attention;
  ST-joint attention — all masked by the valid length.

  * `gcn_block_tail` — on a CUDA tensor it launches the hand-written kernel
    (csrc/gcn_tail.cu), which replaces the TPU kernel
    golfaction_tpu/ops/pallas/gcn_kernel.py (gcn_block_tail_pallas); on a
    CPU tensor it runs `gcn_block_tail_plain`, the same function in torch.
  * `pack_tail` — packs one block's tail weights into the flat float32
    buffer both read, once at load time, and the branch kernel W1 a second
    time for the tensor cores, laid out in the order of the kernel's mma
    fragments (`w1_fragments`).  The kernel multiplies in 3xTF32: each factor
    split into a TF32 head and tail as `split_tf32` does, `product_tf32`
    being the same product in torch.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from golfaction_tpu_torch.ops import _kernels
from golfaction_tpu_torch.utils import profiling

_EPS = 1e-6            # flax LayerNorm epsilon
_MAX_SEG = 16          # branches + max-pool branch the kernel takes
SMEM_LIMIT = 232448    # dynamic shared memory a block may use (227 KB)
ROW_TILE = 32          # rows of the flattened [B*T*V, C] matrix per block of the rows pass
_SMS = 132             # the frame tile aims at one block per SM
_MAX_FRAME_TILE = 16
_GATE_ROWS = 8         # frames of one frame-gate block of the gates pass
_MAX_PARTS = 16        # fixed-order pieces of a gate's dot product
_RING = 2              # stages of the rows pass's ring of weights in flight
_TAP_CHUNK = 2         # frames a taps block has in flight
_GATE_THREADS = 256    # threads of a gates block


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with flax's statistics:
    var = E[x²] - E[x]² (clamped at 0), eps 1e-6."""
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + _EPS) * scale + bias


def tail_layout(C: int, M: int) -> dict[str, tuple[int, tuple[int, ...]]]:
    """name -> (float offset, shape) of the packed tail weights.  The order
    is mirrored by make_layout in csrc/gcn_tail.cu."""
    shapes = [
        ("ln0_s", (C,)), ("ln0_b", (C,)),
        ("w1", (C, C)),                       # concat of the branch 1x1 kernels
        ("bln_s", (C,)), ("bln_b", (C,)),     # per-channel branch LN
        ("taps", (3, C)),                     # depthwise taps (0 on max-pool)
        ("lnf_s", (C,)), ("lnf_b", (C,)),
        ("ca_w1", (C, M)), ("ca_b1", (M,)), ("ca_w2", (M, C)), ("ca_b2", (C,)),
        ("wf", (C, M)), ("sln_s", (M,)), ("sln_b", (M,)),
        ("wt", (M, C)), ("bt", (C,)), ("wv", (M, C)), ("bv", (C,)),
    ]
    out, off = {}, 0
    for name, shape in shapes:
        out[name] = (off, shape)
        off += math.prod(shape)
    out["_total"] = (off, ())
    return out


def round_tf32(x: torch.Tensor, truncate: bool = False) -> torch.Tensor:
    """float32 cut to TF32's 10 mantissa bits: rounded to nearest with ties
    away from zero, as `cvt.rna.tf32.f32` does on the card, or truncated, as
    the tensor core does to a float32 it is handed as it is."""
    bits = x.float().contiguous().view(torch.int32)
    if not truncate:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor, truncate_tail: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo up to 2^-21 of |x|, both with TF32's mantissa: the two
    factors of the error-compensated product a_lo*b_hi + a_hi*b_lo + a_hi*b_hi.
    The kernel rounds both parts of an activation to nearest; of a weight it
    rounds the head and leaves the tail's truncation to the tensor core
    (truncate_tail)."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi, truncate=truncate_tail)


def product_tf32(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y @ w as the kernel's tensor-core product rounds it: each factor split
    into TF32 parts, three products, float32 sums."""
    yh, yl = split_tf32(y)
    wh, wl = split_tf32(w, truncate_tail=True)
    return yl @ wh + yh @ wl + yh @ wh


def w1_fragments(w1: torch.Tensor) -> torch.Tensor:
    """W1 [C, C] -> flat float32 [Kp * Np], Kp = C rounded up to 16 and Np to
    8 (zero padding), in the order the kernel's m16n8k8 B fragments are read.
    For the pair of k-steps kp, column tile nt and lane = 4 g + t the four
    values are (b0, b1) of k-step 2 kp, then of 2 kp + 1, where for k-step kt
    b0 = W1[8 kt + t, 8 nt + g] and b1 = W1[8 kt + t + 4, 8 nt + g].  The
    kernel splits each value into its TF32 head and tail (`split_tf32`)."""
    C = w1.shape[0]
    kp, nt = -(-C // 16), -(-C // 8)
    wp = torch.zeros((16 * kp, 8 * nt), dtype=torch.float32)
    wp[:C, :C] = w1.float()
    frag = wp.reshape(kp, 2, 2, 4, nt, 8).permute(0, 4, 5, 3, 1, 2)   # kp, nt, g, t, step, half
    return frag.reshape(-1).contiguous()


@dataclasses.dataclass
class TailWeights:
    """One block's packed tail weights.

    packed: flat float32 buffer in `tail_layout` order; w1_frag: W1 once
    more in mma fragment order (`w1_fragments`), read by the kernel only;
    meta: int32 [nseg, bounds[0..nseg], dil[0..nseg-1]] with dil -1 on
    the max-pool segment; segments are the branches' channel ranges in concat
    order.
    """

    packed: torch.Tensor
    w1_frag: torch.Tensor
    meta: torch.Tensor
    C: int
    M: int
    bounds: tuple[int, ...]
    dilations: tuple[int, ...]
    kernels: tuple[int, ...]
    branch_taps: tuple[torch.Tensor, ...]   # [k, ch] per branch (any k)

    def view(self, name: str) -> torch.Tensor:
        off, shape = tail_layout(self.C, self.M)[name]
        return self.packed[off:off + math.prod(shape)].view(shape)

    def to(self, device) -> "TailWeights":
        return dataclasses.replace(
            self, packed=self.packed.to(device), w1_frag=self.w1_frag.to(device),
            meta=self.meta.to(device),
            branch_taps=tuple(t.to(device) for t in self.branch_taps))


def pack_tail(ln0, branch_dense, branch_ln, branch_taps, branches, mp_dense,
              mp_ln, lnf, ca1, ca2, stja_fused, stja_ln, stja_t, stja_v) -> TailWeights:
    """Pack a block's tail weights (all in input-major [in, out] layout).

    ln0, lnf, branch_ln[i], mp_ln, stja_ln: (scale, bias); branch_dense[i],
    mp_dense, stja_fused: [C, ch] kernels; branch_taps[i]: [k, ch];
    ca1, ca2, stja_t, stja_v: (kernel [in, out], bias).
    """
    C = ln0[0].shape[0]
    M = ca1[0].shape[1]
    if stja_fused.shape[1] != M:
        raise ValueError("channel and ST-joint attention widths differ")
    lay = tail_layout(C, M)
    P = torch.zeros(lay["_total"][0], dtype=torch.float32)

    def put(name, t):
        off, shape = lay[name]
        P[off:off + math.prod(shape)] = t.float().reshape(-1)

    w1 = torch.cat(list(branch_dense) + [mp_dense], dim=1)
    bln_s = torch.cat([s for s, _ in branch_ln] + [mp_ln[0]])
    bln_b = torch.cat([b for _, b in branch_ln] + [mp_ln[1]])
    taps = torch.zeros(3, C)
    bounds, dils, ks = [0], [], []
    for tw, (k, d) in zip(branch_taps, branches):
        ch = tw.shape[1]
        if k == 3:
            taps[:, bounds[-1]:bounds[-1] + ch] = tw
        bounds.append(bounds[-1] + ch)
        dils.append(d)
        ks.append(k)
    bounds.append(C)
    dils.append(-1)
    ks.append(3)
    if w1.shape != (C, C) or bounds[-2] + mp_dense.shape[1] != C:
        raise ValueError(f"branch widths do not add up to C={C}")
    put("ln0_s", ln0[0]); put("ln0_b", ln0[1])
    put("w1", w1)
    put("bln_s", bln_s); put("bln_b", bln_b)
    put("taps", taps)
    put("lnf_s", lnf[0]); put("lnf_b", lnf[1])
    put("ca_w1", ca1[0]); put("ca_b1", ca1[1]); put("ca_w2", ca2[0]); put("ca_b2", ca2[1])
    put("wf", stja_fused); put("sln_s", stja_ln[0]); put("sln_b", stja_ln[1])
    put("wt", stja_t[0]); put("bt", stja_t[1]); put("wv", stja_v[0]); put("bv", stja_v[1])
    nseg = len(dils)
    meta = torch.tensor([nseg, *bounds, *dils], dtype=torch.int32)
    return TailWeights(P, w1_fragments(w1), meta, C, M, tuple(bounds), tuple(dils), tuple(ks),
                       tuple(t.float() for t in branch_taps))


def _shift_time(h: torch.Tensor, off: int, fill: float) -> torch.Tensor:
    """out[:, t] = h[:, t + off], `fill` past the clip edge.  h [B, T, ...]."""
    if off == 0:
        return h
    T = h.shape[1]
    pad = torch.full_like(h[:, :min(abs(off), T)], fill)
    if abs(off) >= T:
        return torch.full_like(h, fill)
    if off > 0:
        return torch.cat([h[:, off:], pad], dim=1)
    return torch.cat([pad, h[:, :T + off]], dim=1)


def gcn_block_tail_plain(x: torch.Tensor, la: torch.Tensor, w: TailWeights,
                         product=torch.matmul) -> torch.Tensor:
    """Plain torch version of the tail.  x [B,T,V,C] f32, la [B] int.
    `product` computes the branch product y @ W1 (float32 by default; the
    tests pass `product_tf32` to round it as the kernel does)."""
    B, T, V, C = x.shape
    x = x.float()
    t_idx = torch.arange(T, device=x.device)
    valid = (t_idx[None, :] < la[:, None].to(x.device)).float()[:, :, None, None]
    y = F.relu(layer_norm(x, w.view("ln0_s"), w.view("ln0_b"))) * valid
    h = product(y, w.view("w1"))
    bln_s, bln_b = w.view("bln_s"), w.view("bln_b")
    outs = []
    for s in range(len(w.dilations)):
        a, e = w.bounds[s], w.bounds[s + 1]
        hs = layer_norm(h[..., a:e], bln_s[a:e], bln_b[a:e])
        d = w.dilations[s]
        if d < 0:   # max-pool branch: no relu; masked frames -1e4, edge -inf
            g = hs * valid + (1.0 - valid) * -1e4
            gm = torch.maximum(torch.maximum(g, _shift_time(g, -1, float("-inf"))),
                               _shift_time(g, 1, float("-inf")))
            outs.append(gm)
            continue
        hs = F.relu(hs) * valid
        taps = w.branch_taps[s]
        k = taps.shape[0]
        half = (k - 1) // 2
        acc = torch.zeros_like(hs)
        for j in range(k):
            acc = acc + taps[j] * _shift_time(hs, (j - half) * d, 0.0)
        outs.append(acc)
    z = torch.cat(outs, dim=-1)
    z = F.relu(layer_norm(z, w.view("lnf_s"), w.view("lnf_b"))) * valid
    # SE channel attention over the valid frames.
    laf = la.to(x.device).float().clamp(min=1.0)
    s = z.sum(dim=(1, 2)) / (laf * V)[:, None]
    h1 = F.relu(s @ w.view("ca_w1") + w.view("ca_b1"))
    gate_c = torch.sigmoid(h1 @ w.view("ca_w2") + w.view("ca_b2"))
    z = z * gate_c[:, None, None, :]
    # ST-joint attention: frame and joint pools share one embedding.
    t_pool = z.mean(dim=2)                                  # [B, T, C]
    v_pool = z.sum(dim=1) / laf[:, None, None]              # [B, V, C]

    def emb(p):
        e = layer_norm(p @ w.view("wf"), w.view("sln_s"), w.view("sln_b"))
        return torch.clamp(e, -1.0, 1.0)

    t_gate = torch.sigmoid(emb(t_pool) @ w.view("wt") + w.view("bt"))
    v_gate = torch.sigmoid(emb(v_pool) @ w.view("wv") + w.view("bv"))
    return z * t_gate[:, :, None, :] * v_gate[:, None, :, :]


def frames_per_block(B: int, T: int) -> int:
    """Frames of one clip that a block of the taps and apply passes takes:
    the smallest tile (at most 16) that leaves about one block per SM."""
    return max(1, min(_MAX_FRAME_TILE, -(-B * T // _SMS), T))


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


# Dynamic shared memory of each pass in bytes, a mirror of the functions of
# the same names in csrc/gcn_tail.cu (and of its tile constants above).  The
# mirror is here so that the fit of every width can be tested without a card;
# the card tests hold it equal to what the library reports (gcn_tail_smem).
def rows_smem(C: int) -> int:
    kp = -(-C // 16) * 16
    tiles_per_warp = -(-_pad8(C) // 64)                 # 8-column tiles, 8 warps
    ring = 16 * _RING * tiles_per_warp * 256            # 16 bytes per thread, stage and tile
    return ring + 4 * (2 * ROW_TILE * (kp + 4) + 2 * ROW_TILE * _MAX_SEG + kp + ROW_TILE
                       + 2 * _MAX_SEG + 1)


def taps_smem(C: int, V: int) -> int:
    return 4 * ((_TAP_CHUNK + 1) * V * C + 2 * _MAX_SEG + 1)


def gates_smem(C: int, M: int) -> int:
    return 4 * (_pad8(C) + _GATE_ROWS * (_pad8(C) + _pad8(M))
                + max(_GATE_ROWS * max(_GATE_THREADS, C, M), 2 * C * _MAX_PARTS)
                + 2 * (-(-C * M // 4) * 4))          # two weight matrices at a time


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def gcn_block_tail(x: torch.Tensor, la: torch.Tensor, w: TailWeights) -> torch.Tensor:
    """x [B,T,V,C] f32, la [B] int32 valid lengths -> [B,T,V,C] (kernel B)."""
    if x.device.type == "cpu":
        return gcn_block_tail_plain(x, la, w)
    _kernels.require(x, torch.float32, 4, "gcn_block_tail x")
    _kernels.require(la, torch.int32, 1, "gcn_block_tail la")
    _kernels.require(w.packed, torch.float32, 1, "gcn_block_tail weights")
    _kernels.require(w.w1_frag, torch.float32, 1, "gcn_block_tail fragment weights")
    _kernels.require(w.meta, torch.int32, 1, "gcn_block_tail meta")
    B, T, V, C = x.shape
    if C != w.C or la.shape[0] != B:
        raise ValueError(f"gcn_block_tail: x {tuple(x.shape)}, la {tuple(la.shape)}, "
                         f"weights for C={w.C}")
    if C > 256 or len(w.dilations) > _MAX_SEG or any(k != 3 for k in w.kernels):
        raise ValueError("gcn_block_tail kernel takes C <= 256, at most "
                         f"{_MAX_SEG} branches, all of 3 taps")
    ft = frames_per_block(B, T)
    smem = max(rows_smem(C), taps_smem(C, V), gates_smem(C, w.M))
    if smem > SMEM_LIMIT:
        raise ValueError(f"gcn_block_tail: C={C}, V={V} need {smem} bytes of shared memory")
    out = torch.empty_like(x)
    if B == 0 or T == 0:
        return out
    # One scratch allocation, sliced: h (the branches before the taps), z,
    # the frame pools, the per-tile joint and channel sums, the three gates.
    ntiles = -(-T // ft)
    sizes = (B * T * V * C, B * T * V * C, B * T * C, B * ntiles * V * C, B * ntiles * C,
             B * C, B * V * C, B * T * C)
    scratch = torch.empty(sum(_align4(n) for n in sizes), dtype=torch.float32, device=x.device)
    parts, off = [], 0
    for n in sizes:
        parts.append(_kernels.ptr(scratch[off:off + n]))
        off += _align4(n)
    fn = _kernels.bind("gcn_tail", "gcn_tail_launch", "p" * 14 + "iiiiiii" + "p")
    rc = fn(_kernels.ptr(x), _kernels.ptr(la), _kernels.ptr(w.packed), _kernels.ptr(w.w1_frag),
            _kernels.ptr(w.meta), *parts, _kernels.ptr(out),
            B, T, V, C, w.M, ft, len(w.dilations), _kernels.stream_of(x))
    _kernels.check(rc, "gcn_block_tail kernel")
    # One count per call of the kernel, which is four __global__ launches:
    # rows, taps, gates, apply.
    profiling.count("launch.gcn_tail")
    return out
