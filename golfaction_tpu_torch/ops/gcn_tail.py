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
    buffer both read, once at load time.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from golfaction_tpu_torch.ops import _kernels

_EPS = 1e-6            # flax LayerNorm epsilon
_MAX_SEG = 16          # branches + max-pool branch the kernel takes
_SMEM_LIMIT = 232448   # dynamic shared memory a block may use (227 KB)
_SMEM_RESERVE = 1024


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


@dataclasses.dataclass
class TailWeights:
    """One block's packed tail weights.

    packed: flat float32 buffer in `tail_layout` order; meta: int32
    [nseg, bounds[0..nseg], dil[0..nseg-1]] with dil -1 on the max-pool
    segment; segments are the branches' channel ranges in concat order.
    """

    packed: torch.Tensor
    meta: torch.Tensor
    C: int
    M: int
    bounds: tuple[int, ...]
    dilations: tuple[int, ...]
    kernels: tuple[int, ...]
    branch_taps: tuple[torch.Tensor, ...]   # [k, ch] per branch (any k)

    @property
    def halo(self) -> int:
        h = [d * (k - 1) // 2 for k, d in zip(self.kernels, self.dilations) if d > 0]
        return max(h + [1])

    def view(self, name: str) -> torch.Tensor:
        off, shape = tail_layout(self.C, self.M)[name]
        return self.packed[off:off + math.prod(shape)].view(shape)

    def to(self, device) -> "TailWeights":
        return dataclasses.replace(
            self, packed=self.packed.to(device), meta=self.meta.to(device),
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
    return TailWeights(P, meta, C, M, tuple(bounds), tuple(dils), tuple(ks),
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


def gcn_block_tail_plain(x: torch.Tensor, la: torch.Tensor, w: TailWeights) -> torch.Tensor:
    """Plain torch version of the tail.  x [B,T,V,C] f32, la [B] int."""
    B, T, V, C = x.shape
    x = x.float()
    t_idx = torch.arange(T, device=x.device)
    valid = (t_idx[None, :] < la[:, None].to(x.device)).float()[:, :, None, None]
    y = F.relu(layer_norm(x, w.view("ln0_s"), w.view("ln0_b"))) * valid
    h = y @ w.view("w1")
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


def _frames_smem(C: int, V: int, halo: int, tt: int) -> int:
    """Dynamic shared memory of the frame-tile pass (csrc/gcn_tail.cu):
    segment tables, the 16-row staging tile and the extended frame tile."""
    return 4 * (C + 64 + 16 * C + (tt + 2 * halo) * V * C)


def frame_tile(C: int, V: int, halo: int, T: int) -> int:
    """Largest power-of-two frame tile (<= 32) whose extended tile fits the
    shared memory of one block."""
    tt = 32
    while tt > 1 and _frames_smem(C, V, halo, tt) > _SMEM_LIMIT - _SMEM_RESERVE:
        tt //= 2
    return max(1, min(tt, T))


def gcn_block_tail(x: torch.Tensor, la: torch.Tensor, w: TailWeights) -> torch.Tensor:
    """x [B,T,V,C] f32, la [B] int32 valid lengths -> [B,T,V,C] (kernel B)."""
    if x.device.type == "cpu":
        return gcn_block_tail_plain(x, la, w)
    _kernels.require(x, torch.float32, 4, "gcn_block_tail x")
    _kernels.require(la, torch.int32, 1, "gcn_block_tail la")
    _kernels.require(w.packed, torch.float32, 1, "gcn_block_tail weights")
    _kernels.require(w.meta, torch.int32, 1, "gcn_block_tail meta")
    B, T, V, C = x.shape
    if C != w.C or la.shape[0] != B:
        raise ValueError(f"gcn_block_tail: x {tuple(x.shape)}, la {tuple(la.shape)}, "
                         f"weights for C={w.C}")
    if C > 256 or len(w.dilations) > _MAX_SEG or any(k != 3 for k in w.kernels):
        raise ValueError("gcn_block_tail kernel takes C <= 256, at most "
                         f"{_MAX_SEG} branches, all of 3 taps")
    halo = w.halo
    tt = frame_tile(C, V, halo, T)
    smem = _frames_smem(C, V, halo, tt)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"gcn_block_tail: C={C} needs {smem} bytes of shared memory")
    ntiles = -(-T // tt)
    dev = x.device
    z = torch.empty_like(x)
    tpool = torch.empty((B, T, C), dtype=torch.float32, device=dev)
    vpart = torch.empty((B, ntiles, V, C), dtype=torch.float32, device=dev)
    gate_c = torch.empty((B, C), dtype=torch.float32, device=dev)
    gate_v = torch.empty((B, V, C), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    if B == 0 or T == 0:
        return out
    fn = _kernels.bind("gcn_tail", "gcn_tail_launch", "ppppppppppiiiiiiip")
    rc = fn(_kernels.ptr(x), _kernels.ptr(la), _kernels.ptr(w.packed), _kernels.ptr(w.meta),
            _kernels.ptr(z), _kernels.ptr(tpool), _kernels.ptr(vpart),
            _kernels.ptr(gate_c), _kernels.ptr(gate_v), _kernels.ptr(out),
            B, T, V, C, w.M, tt, halo, _kernels.stream_of(x))
    _kernels.check(rc, "gcn_block_tail kernel")
    # One count per call of the kernel, which is three __global__ launches:
    # frame tiles, per-clip gates, elementwise apply.
    gcn_block_tail.launches += 1
    return out


gcn_block_tail.launches = 0
