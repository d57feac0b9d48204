// Kernel B: the GCN block tail — everything between two spatial graph convs.
//
// Replaces golfaction_tpu/ops/pallas/gcn_kernel.py (gcn_block_tail_pallas,
// body _tail_kernel).  Per clip it computes, on x [T, V, C] (post spatial
// conv, pre LayerNorm), with frames t >= la masked:
//   y  = relu(LN0(x))
//   h_s = branch 1x1 product, LN, relu (no relu on the max-pool branch)
//   z  = relu(LNf(concat(depthwise dilated taps of h_s, temporal max of h_mp)))
//   SE channel gate g_c from the masked mean of z; ST-joint gates g_t, g_v
//   from the frame and joint pools of z * g_c
//   out = z * g_c * g_t[t] * g_v[v]
//
// The TPU kernel holds one whole clip ([T*V, C] rows) in VMEM.  Here the work
// is cut where the data dependencies are, not by what fits one block:
//   1. tail_rows_kernel, one block per 32 rows of the flattened [B*T*V, C]
//      matrix.  Nothing couples rows before the temporal taps, so there is no
//      halo and nothing is computed twice: LN0, relu, mask, the C x C product,
//      the per-branch LayerNorm, relu and the mask values, written as h.  At
//      [4, 64, 17, C] that is 136 blocks at every C; h (4.5 MB at C = 256)
//      stays in the 50 MB L2 for the next pass.
//   2. tail_taps_kernel, grid (frame tile, clip), one warp per joint: reads h
//      at t and t +- d, concat, LNf, relu, mask -> z, and forms the per-frame
//      joint means, the per-tile per-joint sums and the per-tile channel sums
//      from the values it holds (the pools are linear, so pool(z * g_c) =
//      g_c * pool(z) and the gate can come later).
//   3. tail_gates_kernel, grid (joints + frame tiles, clip): every block
//      adds up the per-tile channel sums in tile order and computes the SE
//      gate g_c of its clip (two small products: cheaper than a launch of
//      its own, or than one block making it while the others wait); a
//      joint's block then computes its gate g_v, a frame tile's block the
//      frame gates g_t of eight frames.  The two kinds need nothing of each
//      other, so they share a launch.  The gates are a chain of four small
//      products, each waiting for the one before: the weights come into
//      shared memory two matrices at a time (cp.async) while the pools are
//      summed, and a block has only 256 threads, because in steps this short
//      every further warp costs more in instructions to execute than it
//      hides in latency.
//   4. tail_apply_kernel: out = z * g_c * g_t * g_v, elementwise.
// Every sum runs in a fixed order (partials, no float atomics): two runs on
// the same input give the same bits.
//
// The C x C product runs on the tensor cores: mma.sync m16n8k8 TF32 with
// float32 accumulators.  One TF32 pass keeps 10 mantissa bits of each factor,
// which is too coarse for outputs that pass through three LayerNorms, so each
// factor is split into a TF32 head and a TF32 tail and the product is
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (3xTF32, error about 2^-21 of a term).
// The activations are split once, when LN0 writes them to shared memory.
// With 32 rows to a block, every block reads all of W1 (136 blocks x 256 KB
// from L2 at C = 256), and each weight is used by one warp only.  So W1 is
// stored once, in float32, in the order of the mma's B fragments
// (ops/gcn_tail.py:w1_fragments): a thread copies what it needs for two
// k-steps of one 8-column tile with one 16-byte cp.async into its own slots
// of a ring in shared memory, two pairs of k-steps ahead of their use, and
// splits it in registers with one conversion (the tail's truncation is left
// to the tensor core).  A stored split would double the traffic; conversions
// in the loop are what the product waits for next, and after them the
// mma.sync rate itself (three passes are not free at 8 warps to an SM).
//
// Bound: operations.  The product (2 C^2 FLOPs per row) outweighs the traffic
// of one read and one write of [B, T*V, C] float32 at C >= 64.  In practice
// the four launches of a call are a dependent chain of short kernels.
//
// LayerNorm follows flax: var = E[x^2] - E[x]^2 (clamped at 0), eps 1e-6.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowTile = 32;       // rows of one rows-pass block (two m16 tiles)
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRowsPerWarp = kRowTile / kRowWarps;
constexpr int kTapWarpsMax = 17;   // 544 threads keep 120 registers each
constexpr int kTapChunk = 2;       // frames a taps block has in flight
constexpr int kRing = 2;           // pairs of k-steps whose weights are in flight
constexpr int kGateThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kMaxParts = 16;      // fixed-order pieces of a gate's dot product
constexpr int kDotRows = 8;        // rows one thread of a gate's dot product carries
constexpr int kDotMin = 32;        // terms a piece of a dot product has at least
constexpr int kMaxSeg = 16;
constexpr float kEps = 1e-6f;

// Float offsets of the packed weights; mirrored by
// golfaction_tpu_torch/ops/gcn_tail.py:tail_layout.
struct Layout {
  int ln0s, ln0b, w1, blns, blnb, taps, lnfs, lnfb;
  int caw1, cab1, caw2, cab2, wf, slns, slnb, wt, bt, wv, bv, total;
};

__host__ __device__ inline Layout make_layout(int C, int M) {
  Layout L;
  int o = 0;
  L.ln0s = o; o += C;
  L.ln0b = o; o += C;
  L.w1 = o; o += C * C;
  L.blns = o; o += C;
  L.blnb = o; o += C;
  L.taps = o; o += 3 * C;
  L.lnfs = o; o += C;
  L.lnfb = o; o += C;
  L.caw1 = o; o += C * M;
  L.cab1 = o; o += M;
  L.caw2 = o; o += M * C;
  L.cab2 = o; o += C;
  L.wf = o; o += C * M;
  L.slns = o; o += M;
  L.slnb = o; o += M;
  L.wt = o; o += M * C;
  L.bt = o; o += C;
  L.wv = o; o += M * C;
  L.bv = o; o += C;
  L.total = o;
  return L;
}

// Shared memory of each pass in bytes; mirrored by rows_smem, taps_smem and
// gates_smem in ops/gcn_tail.py.  The apply pass uses none.
__host__ __device__ inline int pad8(int C) { return (C + 7) & ~7; }
__host__ __device__ inline int pad16(int C) { return (C + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
inline int row_tiles_per_warp(int C) { return (pad8(C) / 8 + kRowWarps - 1) / kRowWarps; }
inline size_t rows_smem(int C) {
  return 16 * (size_t)kRing * row_tiles_per_warp(C) * kRowThreads +
         4 * (2 * (size_t)kRowTile * (pad16(C) + 4) + 2 * kRowTile * kMaxSeg + pad16(C) +
              kRowTile + 2 * kMaxSeg + 1);
}
inline size_t taps_smem(int C, int V) {
  return 4 * ((kTapChunk + 1) * (size_t)V * C + 2 * kMaxSeg + 1);
}
inline size_t gates_smem(int C, int M) {
  return 4 * (pad8(C) + (size_t)kDotRows * (pad8(C) + pad8(M)) +
              imax(kDotRows * imax(kGateThreads, imax(C, M)), 2 * C * kMaxParts) +
              2 * (size_t)((C * M + 3) & ~3));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a (16x8, row) * b (8x8, col), TF32 factors, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying n floats into shared memory, by the whole block, in 16-byte
// pieces where both ends are aligned.  The caller commits, waits and syncs.
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src, int n,
                                            int tid, int nthreads) {
  if (((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) == 0 && n % 4 == 0) {
    for (int i = tid; i < n / 4; i += nthreads) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = tid; i < n; i += nthreads) cp_async4(dst + i, src + i);
  }
}

// meta = [nseg, bounds[0..nseg], dil[0..nseg-1]]; dil < 0 marks the
// max-pool segment.
__device__ __forceinline__ void load_meta(const int* __restrict__ meta, int nseg, int* bounds,
                                          int* segdil, int tid) {
  if (tid <= nseg) bounds[tid] = meta[1 + tid];
  if (tid < nseg) segdil[tid] = meta[2 + nseg + tid];
}

// ---- Pass 1: rows.  NJ = 8-column tiles per warp (C / 64, rounded up).
template <int NJ>
__global__ void __launch_bounds__(kRowThreads) tail_rows_kernel(
    const float* __restrict__ x, const int* __restrict__ la_arr,
    const float* __restrict__ P, const float4* __restrict__ w1f,
    const int* __restrict__ meta, float* __restrict__ h,
    int R, int T, int V, int C, int M, int nseg) {
  constexpr int KCH = 2 * NJ;           // channels per lane: C <= 64 NJ
  extern __shared__ float4 smem4[];
  const int Kp = pad16(C), S = Kp + 4;  // S = 4 mod 8: fragment reads hit 32 banks
  float4* ring = smem4;                               // [kRing, NJ, threads] weights in flight
  float* Yhi = reinterpret_cast<float*>(ring + kRing * NJ * kRowThreads);
  float* Ylo = Yhi + kRowTile * S;                    // [kRowTile, S] each: y's TF32 head, tail
  float* Ys = Yhi;                                    // after the product: h
  float* stats = Ylo + kRowTile * S;                  // [kRowTile, kMaxSeg, 2] mean, rstd
  int* chseg = reinterpret_cast<int*>(stats + 2 * kRowTile * kMaxSeg);   // [Kp]
  int* rowstate = chseg + Kp;                         // 1 valid, 0 masked, -1 past the end
  int* bounds = rowstate + kRowTile;                  // [kMaxSeg + 1]
  int* segdil = bounds + kMaxSeg + 1;                 // [kMaxSeg]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * kRowTile;
  const Layout L = make_layout(C, M);
  const int NT = pad8(C) / 8;         // 8-column tiles
  const int KP = Kp / 16;             // pairs of 8-deep k-steps
  load_meta(meta, nseg, bounds, segdil, tid);
  if (tid < kRowTile) {   // one thread a row: masked, valid or past the end
    const int r = r0 + tid;
    int state = -1;
    if (r < R) {
      const int bt = r / V;
      state = bt % T < la_arr[bt / T] ? 1 : 0;
    }
    rowstate[tid] = state;
  }

  // A thread's weights for the pair of k-steps kp, one 16-byte copy per column
  // tile, into its own slots of the ring: no other thread reads them.
  auto fetch = [&](int kp) {
    if (kp < KP) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int nt = warp + kRowWarps * j;
        if (nt < NT)
          cp_async16(ring + ((kp % kRing) * NJ + j) * kRowThreads + tid,
                     w1f + ((size_t)kp * NT + nt) * 32 + lane);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int kp = 0; kp < kRing; ++kp) fetch(kp);   // on their way during LN0

  // y = mask(relu(LN0(x))): a warp takes four rows and has them all in flight.
  // x is read whatever la says, so the two loads do not wait on each other.
  int any = 0;
  {
    float xv[kRowsPerWarp][KCH], gs[KCH], gb[KCH];
#pragma unroll
    for (int k = 0; k < KCH; ++k) {
      const int c = lane + 32 * k;
      gs[k] = c < C ? P[L.ln0s + c] : 0.0f;
      gb[k] = c < C ? P[L.ln0b + c] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = r0 + warp + kRowWarps * j;
#pragma unroll
      for (int k = 0; k < KCH; ++k) {
        const int c = lane + 32 * k;
        xv[j][k] = r < R && c < C ? x[(size_t)r * C + c] : 0.0f;
      }
    }
    __syncthreads();   // rowstate
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int q = warp + kRowWarps * j;
      const bool valid = rowstate[q] > 0;
      any |= valid;
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int k = 0; k < KCH; ++k) {
        s1 += xv[j][k];
        s2 += xv[j][k] * xv[j][k];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const float mean = s1 / C;
      const float rs = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + kEps);
#pragma unroll
      for (int k = 0; k < KCH; ++k) {
        const int c = lane + 32 * k;
        if (c < Kp) {
          const float y =
              valid && c < C ? fmaxf((xv[j][k] - mean) * rs * gs[k] + gb[k], 0.0f) : 0.0f;
          const float hi = __uint_as_float(tf32_rna(y));
          Yhi[q * S + c] = hi;
          Ylo[q * S + c] = __uint_as_float(tf32_rna(y - hi));
        }
      }
    }
  }
  any = __syncthreads_or(any);
  for (int c = tid; c < C; c += kRowThreads) {
    int s = 0;
    while (c >= bounds[s + 1]) ++s;
    chseg[c] = s;
  }

  // h = y @ W1 (3xTF32).  A tile whose rows are all masked skips it.
  if (any) {
    const int g = lane >> 2, t = lane & 3;
    // An mma waits for the one before it on the same accumulator, so the
    // three products of the split go pass by pass over all accumulators, and
    // narrow tiles (few accumulators) keep a second set for the odd k-steps.
    constexpr int HS = NJ <= 2 ? 2 : 1;
    float acc[HS][2][NJ][4];
#pragma unroll
    for (int hs = 0; hs < HS; ++hs)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[hs][mt][j][i] = 0.0f;

    for (int kp = 0; kp < KP; ++kp) {
      cp_async_wait<kRing - 1>();   // this thread's copies for kp have landed
      float4 b[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = ring[((kp % kRing) * NJ + j) * kRowThreads + tid];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t ahi[2][4], alo[2][4], bhi[NJ][2], blo[NJ][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int o = (mt * 16 + g) * S + (2 * kp + half) * 8 + t;
          const int offs[4] = {o, o + 8 * S, o + 4, o + 8 * S + 4};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ahi[mt][i] = __float_as_uint(Yhi[offs[i]]);
            alo[mt][i] = __float_as_uint(Ylo[offs[i]]);
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float w0 = half ? b[j].z : b[j].x, w1 = half ? b[j].w : b[j].y;
          // The tail goes in as it is: the tensor core reads its upper 19
          // bits (a truncation of a value 2^-11 of the weight), and a second
          // conversion per weight would hold the product loop up.
          bhi[j][0] = tf32_rna(w0);
          bhi[j][1] = tf32_rna(w1);
          blo[j][0] = __float_as_uint(w0 - __uint_as_float(bhi[j][0]));
          blo[j][1] = __float_as_uint(w1 - __uint_as_float(bhi[j][1]));
        }
        float (&c)[2][NJ][4] = acc[half % HS];
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (warp + kRowWarps * j < NT) {   // the same for a whole warp
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                if (pass == 0) mma_tf32(c[mt][j], alo[mt], bhi[j][0], bhi[j][1]);
                if (pass == 1) mma_tf32(c[mt][j], ahi[mt], blo[j][0], blo[j][1]);
                if (pass == 2) mma_tf32(c[mt][j], ahi[mt], bhi[j][0], bhi[j][1]);
              }
            }
      }
      fetch(kp + kRing);   // the slots just used take the pair after next
    }
    if (HS == 2) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[0][mt][j][i] += acc[HS - 1][mt][j][i];
    }
    __syncthreads();   // every warp has read its last y
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nt = warp + kRowWarps * j;
      if (nt < NT) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* d = Ys + (mt * 16 + g) * S + nt * 8 + 2 * t;
          d[0] = acc[0][mt][j][0];
          d[1] = acc[0][mt][j][1];
          d[8 * S] = acc[0][mt][j][2];
          d[8 * S + 1] = acc[0][mt][j][3];
        }
      }
    }
  } else {
    cp_async_wait<0>();   // nothing is left in flight when the block ends
  }
  __syncthreads();

  // Per-branch LayerNorm statistics: eight lanes per (row, branch).
  {
    const int q = tid / 8, l8 = tid % 8;   // kRowThreads / 8 == kRowTile
    const bool on = rowstate[q] > 0;   // every lane takes part in the shuffles
    for (int s = 0; s < nseg; ++s) {
      const int a = bounds[s], e = bounds[s + 1];
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 4
      for (int c = a + l8; on && c < e; c += 8) {
        const float v = Ys[q * S + c];
        s1 += v;
        s2 += v * v;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (on && l8 == 0) {
        const int n = e - a;
        const float mean = s1 / n;
        stats[(q * kMaxSeg + s) * 2] = mean;
        stats[(q * kMaxSeg + s) * 2 + 1] = rsqrtf(fmaxf(s2 / n - mean * mean, 0.0f) + kEps);
      }
    }
  }
  __syncthreads();

  // Normalize, relu, mask, and write h.  Masked frames hold 0, and -1e4 on
  // the max-pool branch; the taps pass supplies what lies past the clip's edge.
  for (int q = warp; q < kRowTile; q += kRowWarps) {
    const int state = rowstate[q];
    if (state < 0) break;
    float* out = h + (size_t)(r0 + q) * C;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
      const int s = chseg[c];
      const bool mp = segdil[s] < 0;
      float v = mp ? -1e4f : 0.0f;
      if (state > 0) {
        const float mean = stats[(q * kMaxSeg + s) * 2], rs = stats[(q * kMaxSeg + s) * 2 + 1];
        v = (Ys[q * S + c] - mean) * rs * P[L.blns + c] + P[L.blnb + c];
        if (!mp) v = fmaxf(v, 0.0f);
      }
      out[c] = v;
    }
  }
}

// dst[r * ldd + col] = act(bias[col] + sum_c a[r * lda + c] * Wm[c * ldw + col])
// for r < ROWS (stored for r < rows), col < ncols, by the whole block; act 0
// none, 1 relu, 2 sigmoid.  A thread
// takes one column and all ROWS rows, eight values of c at a time: eight
// weights asked for together, the rows' values read from shared memory as two
// 16-byte loads each.  So a's rows are 16-byte aligned and readable (zero or
// finite) up to lda = n rounded up to 8.  The c range is cut into as many
// pieces as the block has threads to spare (at most kMaxParts, of at least
// kDotMin terms: adding the pieces up costs more than a short piece saves),
// each summed in order and the pieces then added in order, so the result
// does not depend on timing.  Wm lies in shared or in device memory.  scratch holds ROWS *
// max(threads, ncols) floats.  Ends in a __syncthreads.
template <int ROWS>   // not inlined: called four times in a row, one copy of the code
__device__ __noinline__ void block_dot(const float* a, int lda, int rows, const float* Wm, int n,
                                       int ncols, int ldw, const float* __restrict__ bias,
                                       int act, float* scratch, float* dst, int ldd, int tid,
                                       int nthreads) {
  const int parts = max(1, min(min(kMaxParts, n / kDotMin), nthreads / ncols));
  const int chunk = ((n + parts - 1) / parts + 7) & ~7;
  const float bias0 =   // asked for early
      bias != nullptr && tid < ROWS * ncols ? bias[tid % ncols] : 0.0f;
  for (int i = tid; i < ncols * parts; i += nthreads) {
    const int p = i / ncols, col = i - p * ncols;
    const float* wc = Wm + col;
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
    const int c1 = min(n, (p + 1) * chunk);
    for (int c = p * chunk; c < c1; c += 8) {
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float* src = wc + (size_t)(c + u) * ldw;
        w[u] = c + u < c1 ? *src : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + r * lda + c);
        const float4 a1 = *reinterpret_cast<const float4*>(a + r * lda + c + 4);
        s[r] += a0.x * w[0];
        s[r] += a0.y * w[1];
        s[r] += a0.z * w[2];
        s[r] += a0.w * w[3];
        s[r] += a1.x * w[4];
        s[r] += a1.y * w[5];
        s[r] += a1.z * w[6];
        s[r] += a1.w * w[7];
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) scratch[(p * ROWS + r) * ncols + col] = s[r];
  }
  __syncthreads();
  for (int i = tid; i < ROWS * ncols; i += nthreads) {
    const int r = i / ncols, col = i - r * ncols;
    float v = 0.0f;
    for (int p = 0; p < parts; ++p) v += scratch[p * ROWS * ncols + i];
    if (bias != nullptr) v += i == tid ? bias0 : bias[col];
    if (r < rows) dst[r * ldd + col] = act == 1 ? fmaxf(v, 0.0f) : act == 2 ? sigmoidf_(v) : v;
  }
  __syncthreads();
}

// LayerNorm over e[0..M) by one warp, then clamp to [-1, 1].
__device__ __forceinline__ void embed_norm(float* e, const float* __restrict__ P, const Layout& L,
                                           int M, int lane) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int m = lane; m < M; m += 32) {
    s1 += e[m];
    s2 += e[m] * e[m];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mean = s1 / M;
  const float rs = rsqrtf(fmaxf(s2 / M - mean * mean, 0.0f) + kEps);
  for (int m = lane; m < M; m += 32) {
    const float u = (e[m] - mean) * rs * P[L.slns + m] + P[L.slnb + m];
    e[m] = fminf(fmaxf(u, -1.0f), 1.0f);
  }
}

// ---- Pass 2: taps / max-pool, concat, LNf, relu, mask -> z, and the pools.
// One warp per joint (joints beyond the warps wrap around); a lane owns
// channels lane, lane + 32, ... (KCH of them) and keeps their constants in
// registers.  Frames go two at a time, so their loads overlap.
template <int KCH>
__global__ void __launch_bounds__(kTapWarpsMax * 32) tail_taps_kernel(
    const float* __restrict__ h, const int* __restrict__ la_arr,
    const float* __restrict__ P, const int* __restrict__ meta,
    float* __restrict__ z, float* __restrict__ tpool, float* __restrict__ vpart,
    float* __restrict__ cpart, int T, int V, int C, int M, int FT, int nseg) {
  constexpr int CH = KCH >= 8 ? 1 : kTapChunk;        // wide rows fill the registers alone
  extern __shared__ float smem[];
  const int VC = V * C;
  float* fs = smem;                                   // [CH, V, C] the chunk's z
  float* vs = fs + kTapChunk * VC;                    // [V, C] sums over the tile's frames
  int* bounds = reinterpret_cast<int*>(vs + VC);      // [kMaxSeg + 1]
  int* segdil = bounds + kMaxSeg + 1;                 // [kMaxSeg]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int tile = blockIdx.x, b = blockIdx.y, ntiles = gridDim.x;
  const int t0 = tile * FT, t1 = min(t0 + FT, T);
  const int la = la_arr[b];
  const Layout L = make_layout(C, M);
  float tp0[KCH], tp1[KCH], tp2[KCH], ls[KCH], lb[KCH];
#pragma unroll
  for (int k = 0; k < KCH; ++k) {
    const int c = lane + 32 * k;
    const bool on = c < C;
    tp0[k] = on ? P[L.taps + c] : 0.0f;
    tp1[k] = on ? P[L.taps + C + c] : 0.0f;
    tp2[k] = on ? P[L.taps + 2 * C + c] : 0.0f;
    ls[k] = on ? P[L.lnfs + c] : 0.0f;
    lb[k] = on ? P[L.lnfb + c] : 0.0f;
  }
  load_meta(meta, nseg, bounds, segdil, tid);
  for (int v = warp; v < V; v += nwarps)
    for (int c = lane; c < C; c += 32) vs[v * C + c] = 0.0f;   // the thread's own entries
  __syncthreads();
  int dil[KCH];
#pragma unroll
  for (int k = 0; k < KCH; ++k) {
    const int c = lane + 32 * k;
    int s = 0;
    if (c < C)
      while (c >= bounds[s + 1]) ++s;
    dil[k] = c < C ? segdil[s] : 0;
  }

  for (int f0 = t0; f0 < t1; f0 += CH) {
    for (int v = warp; v < V; v += nwarps) {
      float val[CH][KCH];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int f = f0 + j;
        const bool live = f < t1 && f < la;
        const float* hr = h + ((size_t)b * T + f) * VC + (size_t)v * C;
#pragma unroll
        for (int k = 0; k < KCH; ++k) {
          const int c = lane + 32 * k;
          float a = 0.0f;
          if (live && c < C) {
            const int d = dil[k];
            if (d < 0) {   // -inf past the clip's edge: the edge frame is left out
              a = hr[c];
              if (f >= 1) a = fmaxf(a, hr[c - (ptrdiff_t)VC]);
              if (f + 1 < T) a = fmaxf(a, hr[c + (ptrdiff_t)VC]);
            } else {       // zero padding past the clip's edge
              a = f - d >= 0 ? tp0[k] * hr[c - (ptrdiff_t)d * VC] : 0.0f;
              a += tp1[k] * hr[c];
              if (f + d < T) a += tp2[k] * hr[c + (ptrdiff_t)d * VC];
            }
          }
          val[j][k] = a;
        }
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int f = f0 + j;
        if (f >= t1) break;
        const bool live = f < la;   // a masked frame: z = 0, pools unchanged
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int k = 0; k < KCH; ++k) {
          s1 += val[j][k];
          s2 += val[j][k] * val[j][k];
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        const float mean = s1 / C;
        const float rs = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + kEps);
        float* zr = z + ((size_t)b * T + f) * VC + (size_t)v * C;
#pragma unroll
        for (int k = 0; k < KCH; ++k) {
          const int c = lane + 32 * k;
          if (c < C) {
            const float zz = live ? fmaxf((val[j][k] - mean) * rs * ls[k] + lb[k], 0.0f) : 0.0f;
            zr[c] = zz;
            fs[j * VC + v * C + c] = zz;
            vs[v * C + c] += zz;
          }
        }
      }
    }
    __syncthreads();
    const int nf = min(CH, t1 - f0);
    for (int i = tid; i < nf * C; i += nthreads) {
      const int j = i / C, c = i - j * C;
      float s = 0.0f;
      for (int v = 0; v < V; ++v) s += fs[j * VC + v * C + c];
      tpool[((size_t)b * T + f0 + j) * C + c] = s / V;
    }
    __syncthreads();
  }

  const size_t part = (size_t)b * ntiles + tile;
  for (int i = tid; i < VC; i += nthreads) vpart[part * VC + i] = vs[i];
  for (int c = tid; c < C; c += nthreads) {
    float s = 0.0f;
    for (int v = 0; v < V; ++v) s += vs[v * C + c];
    cpart[part * C + c] = s;
  }
}

// Sums over the tiles, in tile order, of one or two [ntiles] x [C] arrays with
// row strides stride0, stride1 (src1 may be null): dst0[c] = sum_t src0[t *
// stride0 + c], the same for dst1.  The tiles are cut into pieces as in
// block_dot.  scratch holds 2 C kMaxParts floats.  Ends in a __syncthreads.
__device__ __noinline__ void tile_sums(const float* __restrict__ src0, size_t stride0,
                                          float* dst0, const float* __restrict__ src1,
                                          size_t stride1, float* dst1, int ntiles, int C,
                                          float* scratch, int tid, int nthreads) {
  const int tasks = src1 != nullptr ? 2 * C : C;
  const int parts = max(1, min(min(kMaxParts, ntiles), nthreads / tasks));
  for (int i = tid; i < tasks * parts; i += nthreads) {
    const int p = i / tasks, j = i - p * tasks;
    const bool second = j >= C;
    const float* src = second ? src1 + (j - C) : src0 + j;
    const size_t stride = second ? stride1 : stride0;
    const int t1 = (p + 1) * ntiles / parts;
    float s = 0.0f;
    for (int t = p * ntiles / parts; t < t1; t += 8) {
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = t + u < t1 ? __ldg(src + (t + u) * stride) : 0.0f;
#pragma unroll
      for (int u = 0; u < 8; ++u) s += w[u];
    }
    scratch[i] = s;
  }
  __syncthreads();
  for (int j = tid; j < tasks; j += nthreads) {
    float s = 0.0f;
    for (int p = 0; p < parts; ++p) s += scratch[p * tasks + j];
    if (j < C) dst0[j] = s; else dst1[j - C] = s;
  }
  __syncthreads();
}

// ---- Pass 3: the gates.  Every block computes the SE gate g_c of its clip
// from the per-tile channel sums (block (0, b) writes it for the apply pass):
// a clip's gate costs two small products, less than a launch of its own or a
// wait for one block to make it.  Blocks x < V then compute the joint gate
// g_v of joint x from the per-tile joint sums, blocks x >= V the frame gates
// g_t of kDotRows frames from their frame pools: the two kinds need nothing
// of each other, so they share a launch.
template <int ROWS>
__device__ __forceinline__ void gate_chain(float* pool, float* emb, float* scratch, int rows,
                                           const float* __restrict__ P, const Layout& L,
                                           const float* Wf, const float* W2, const float* b2,
                                           float* dst, int C, int M, int tid) {
  const int warp = tid / 32, lane = tid % 32;
  block_dot<ROWS>(pool, pad8(C), ROWS, Wf, C, M, M, nullptr, 0, scratch, emb, pad8(M), tid,
                  kGateThreads);
  for (int r = warp; r < ROWS; r += kGateThreads / 32) embed_norm(emb + r * pad8(M), P, L, M, lane);
  __syncthreads();
  block_dot<ROWS>(emb, pad8(M), rows, W2, M, C, C, b2, 2, scratch, dst, C, tid, kGateThreads);
}

__global__ void __launch_bounds__(kGateThreads) tail_gates_kernel(
    const int* __restrict__ la_arr, const float* __restrict__ P,
    const float* __restrict__ tpool, const float* __restrict__ vpart,
    const float* __restrict__ cpart, float* __restrict__ gate_c, float* __restrict__ gate_v,
    float* __restrict__ gate_t, int T, int V, int C, int M, int ntiles) {
  extern __shared__ float smem[];
  const int Cs = pad8(C), Ms = pad8(M);
  float* gc = smem;                 // [Cs] the SE pool, then the SE gate
  float* pool = gc + Cs;            // [kDotRows, Cs] the joint's or the frames' pool of z * g_c
  float* emb = pool + kDotRows * Cs;   // [kDotRows, Ms]; first the SE gate's hidden layer
  float* scratch = emb + kDotRows * Ms;
  // Two weight matrices at a time come into shared memory while the pools are
  // summed, so that the chain of small products does not wait on device
  // memory at every step: first the SE gate's two, then the ST-joint gate's.
  float* w0 = scratch + imax(kDotRows * imax(kGateThreads, imax(C, M)), 2 * C * kMaxParts);
  float* w1 = w0 + ((C * M + 3) & ~3);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const bool joint = blockIdx.x < V;
  const int v = blockIdx.x, t0 = (blockIdx.x - V) * kDotRows;
  const int rows = joint ? 1 : min(kDotRows, T - t0);
  const float la = fmaxf((float)la_arr[b], 1.0f);
  const Layout L = make_layout(C, M);

  stage_async(w0, P + L.caw1, C * M, tid, kGateThreads);
  stage_async(w1, P + L.caw2, C * M, tid, kGateThreads);
  cp_async_commit();
  for (int i = tid; i < Cs + kDotRows * (Cs + Ms); i += kGateThreads) gc[i] = 0.0f;   // padding
  __syncthreads();
  float pre[kDotRows];   // the frames' pools (C <= 256 <= threads), asked for before the sums
#pragma unroll
  for (int k = 0; k < kDotRows; ++k) {
    const int i = tid + k * kGateThreads;
    pre[k] = !joint && i < rows * C ? tpool[((size_t)b * T + t0) * C + i] : 0.0f;
  }
  tile_sums(cpart + (size_t)b * ntiles * C, C, gc,
            joint ? vpart + ((size_t)b * ntiles * V + v) * C : nullptr, (size_t)V * C, pool,
            ntiles, C, scratch, tid, kGateThreads);
  for (int c = tid; c < C; c += kGateThreads) gc[c] = gc[c] / (la * V);
  cp_async_wait<0>();
  __syncthreads();
  block_dot<1>(gc, Cs, 1, w0, C, M, M, P + L.cab1, 1, scratch, emb, Ms, tid, kGateThreads);
  block_dot<1>(emb, Ms, 1, w1, M, C, C, P + L.cab2, 2, scratch, gc, Cs, tid, kGateThreads);
  stage_async(w0, P + L.wf, C * M, tid, kGateThreads);
  stage_async(w1, P + (joint ? L.wv : L.wt), C * M, tid, kGateThreads);
  cp_async_commit();
  if (blockIdx.x == 0)
    for (int c = tid; c < C; c += kGateThreads) gate_c[(size_t)b * C + c] = gc[c];
  if (joint) {
    for (int c = tid; c < C; c += kGateThreads) pool[c] = pool[c] * gc[c] / la;
    cp_async_wait<0>();
    __syncthreads();
    gate_chain<1>(pool, emb, scratch, 1, P, L, w0, w1, P + L.bv,
                  gate_v + ((size_t)b * V + v) * C, C, M, tid);
  } else {
#pragma unroll
    for (int k = 0; k < kDotRows; ++k) {
      const int i = tid + k * kGateThreads;
      if (i < rows * C) pool[(i / C) * Cs + i % C] = pre[k] * gc[i % C];
    }
    cp_async_wait<0>();
    __syncthreads();
    gate_chain<kDotRows>(pool, emb, scratch, rows, P, L, w0, w1, P + L.bt,
                         gate_t + ((size_t)b * T + t0) * C, C, M, tid);
  }
}

// ---- Pass 4: out = z * g_c * g_t * g_v, elementwise.
__global__ void __launch_bounds__(kApplyThreads) tail_apply_kernel(
    const float* __restrict__ z, const float* __restrict__ gate_c,
    const float* __restrict__ gate_t, const float* __restrict__ gate_v,
    float* __restrict__ out, size_t total, int T, int V, int C) {
  const size_t i = (size_t)blockIdx.x * kApplyThreads + threadIdx.x;
  if (C % 4 == 0) {   // rows are 16-byte aligned
    const size_t idx = 4 * i;
    if (idx >= total) return;
    const int c = idx % C;
    const size_t row = idx / C;
    const int v = row % V;
    const size_t bt = row / V, b = bt / T;
    const float4 a = *reinterpret_cast<const float4*>(z + idx);
    const float4 g1 = *reinterpret_cast<const float4*>(gate_c + b * C + c);
    const float4 g2 = *reinterpret_cast<const float4*>(gate_t + bt * C + c);
    const float4 g3 = *reinterpret_cast<const float4*>(gate_v + (b * V + v) * C + c);
    *reinterpret_cast<float4*>(out + idx) =
        make_float4(a.x * g1.x * g2.x * g3.x, a.y * g1.y * g2.y * g3.y,
                    a.z * g1.z * g2.z * g3.z, a.w * g1.w * g2.w * g3.w);
  } else {
    for (size_t idx = 4 * i; idx < 4 * i + 4 && idx < total; ++idx) {
      const int c = idx % C;
      const size_t row = idx / C;
      const int v = row % V;
      const size_t bt = row / V, b = bt / T;
      out[idx] = z[idx] * gate_c[b * C + c] * gate_t[bt * C + c] * gate_v[(b * V + v) * C + c];
    }
  }
}

template <int NJ>
cudaError_t launch_rows(const float* x, const int* la, const float* P, const float4* w1f,
                        const int* meta, float* h, int R, int T, int V, int C, int M, int nseg,
                        cudaStream_t st) {
  const size_t smem = rows_smem(C);
  cudaError_t err = cudaFuncSetAttribute(tail_rows_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tail_rows_kernel<NJ><<<(R + kRowTile - 1) / kRowTile, kRowThreads, smem, st>>>(
      x, la, P, w1f, meta, h, R, T, V, C, M, nseg);
  return cudaGetLastError();
}

template <int KCH>
cudaError_t launch_taps(const float* h, const int* la, const float* P, const int* meta, float* z,
                        float* tpool, float* vpart, float* cpart, int B, int T, int V, int C,
                        int M, int FT, int nseg, int ntiles, int threads, size_t smem,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(tail_taps_kernel<KCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tail_taps_kernel<KCH><<<dim3(ntiles, B), threads, smem, st>>>(
      h, la, P, meta, z, tpool, vpart, cpart, T, V, C, M, FT, nseg);
  return cudaGetLastError();
}

template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" int gcn_tail_layout_total(int C, int M) { return make_layout(C, M).total; }

// Shared memory of pass `which` (0 rows, 1 taps, 2 gates) in bytes.
extern "C" int gcn_tail_smem(int which, int C, int V, int M) {
  switch (which) {
    case 0: return (int)rows_smem(C);
    case 1: return (int)taps_smem(C, V);
    default: return (int)gates_smem(C, M);
  }
}

// Blocks of pass `which` (0 rows, 1 taps, 2 gates, 3 apply) that one SM holds
// at once, at the launch's own thread count and shared memory.
extern "C" int gcn_tail_blocks_per_sm(int which, int C, int V, int M) {
  if (which == 0) {
    const size_t smem = rows_smem(C);
    switch (row_tiles_per_warp(C)) {
      case 1: return blocks_per_sm(tail_rows_kernel<1>, kRowThreads, smem);
      case 2: return blocks_per_sm(tail_rows_kernel<2>, kRowThreads, smem);
      case 3: return blocks_per_sm(tail_rows_kernel<3>, kRowThreads, smem);
      default: return blocks_per_sm(tail_rows_kernel<4>, kRowThreads, smem);
    }
  }
  if (which == 1) {
    const int threads = 32 * (V < kTapWarpsMax ? V : kTapWarpsMax);
    const size_t smem = taps_smem(C, V);
    if (C <= 32) return blocks_per_sm(tail_taps_kernel<1>, threads, smem);
    if (C <= 64) return blocks_per_sm(tail_taps_kernel<2>, threads, smem);
    if (C <= 128) return blocks_per_sm(tail_taps_kernel<4>, threads, smem);
    return blocks_per_sm(tail_taps_kernel<8>, threads, smem);
  }
  if (which == 2) return blocks_per_sm(tail_gates_kernel, kGateThreads, gates_smem(C, M));
  return blocks_per_sm(tail_apply_kernel, kApplyThreads, 0);
}

// meta's first entry, the number of branches, comes in as nseg as well, so
// that no load in a kernel has to wait for it.
extern "C" int gcn_tail_launch(const void* x, const void* la, const void* P, const void* w1f,
                               const void* meta, void* h, void* z, void* tpool, void* vpart,
                               void* cpart, void* gate_c, void* gate_v, void* gate_t, void* out,
                               int B, int T, int V, int C, int M, int FT, int nseg,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (T + FT - 1) / FT;
  const int R = B * T * V;
  cudaError_t err;
#define ROWS(NJ)                                                                              \
  launch_rows<NJ>((const float*)x, (const int*)la, (const float*)P, (const float4*)w1f,       \
                  (const int*)meta, (float*)h, R, T, V, C, M, nseg, st)
  switch (row_tiles_per_warp(C)) {
    case 1: err = ROWS(1); break;
    case 2: err = ROWS(2); break;
    case 3: err = ROWS(3); break;
    case 4: err = ROWS(4); break;
    default: return (int)cudaErrorInvalidValue;   // C > 256
  }
#undef ROWS
  if (err != cudaSuccess) return (int)err;

  const int tap_threads = 32 * (V < kTapWarpsMax ? V : kTapWarpsMax);
  const size_t smem2 = taps_smem(C, V);
#define TAPS(KCH)                                                                             \
  launch_taps<KCH>((const float*)h, (const int*)la, (const float*)P, (const int*)meta,        \
                   (float*)z, (float*)tpool, (float*)vpart, (float*)cpart, B, T, V, C, M, FT, \
                   nseg, ntiles, tap_threads, smem2, st)
  if (C <= 32) err = TAPS(1);
  else if (C <= 64) err = TAPS(2);
  else if (C <= 128) err = TAPS(4);
  else err = TAPS(8);
#undef TAPS
  if (err != cudaSuccess) return (int)err;

  const size_t smem3 = gates_smem(C, M);
  err = cudaFuncSetAttribute(tail_gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return (int)err;
  tail_gates_kernel<<<dim3(V + (T + kDotRows - 1) / kDotRows, B), kGateThreads, smem3, st>>>(
      (const int*)la, (const float*)P, (const float*)tpool, (const float*)vpart,
      (const float*)cpart, (float*)gate_c, (float*)gate_v, (float*)gate_t, T, V, C, M, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t total = (size_t)R * C;
  const size_t quads = (total + 3) / 4;
  tail_apply_kernel<<<(unsigned)((quads + kApplyThreads - 1) / kApplyThreads), kApplyThreads, 0,
                      st>>>((const float*)z, (const float*)gate_c, (const float*)gate_t,
                            (const float*)gate_v, (float*)out, total, T, V, C);
  return (int)cudaGetLastError();
}
