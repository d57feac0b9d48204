// Kernel E: soft-DTW backward, the E-recursion as a reverse wavefront.
//
// Replaces golfaction_tpu/ops/pallas/softdtw_kernel.py (_backward_batch_jit,
// body _backward_kernel).  E[i, j] = d cost / d D[i, j] is
//   E[i, j] = sum over the successors s in {(i+1, j), (i, j+1), (i+1, j+1)}
//             of exp((R[s] - R[i, j] - D[s]) / gamma) * E[s],
// summed down, right, diagonal as the reference does, seeded with
// E[Ta-1, Tb-1] = 1; a successor outside the table weighs 0 (an index test
// made before any expf, so no INF - INF forms) and a cell whose own cost is
// the +INF padding (1e10) gets E = 0.
//
// Unlike the forward (csrc/softdtw.cu), no weight depends on E: all
// 3 * Ta * Tb of them are known before the first step.  So the design is C's
// minus the exponentials on the chain:
//
//   * weights, off the chain: every thread of the block computes the three
//     successor weights of every slot, expf(quick_div(x, gamma, 1/gamma)) as
//     in C (the IEEE quotient; a warp vote falls back to `/` outside
//     [2^-60, 2^60]), and stores them diagonal-major, W[k][c][q][lane]
//     (diagonal k, successor c, row q of the lane), so that the chain reads a
//     diagonal's weights as consecutive, conflict-free words.  A slot whose
//     cell is not live (outside the table, or D >= INF) stores -1 as its
//     "down" weight: the chain then writes 0 there.
//   * the chain: one warp per table; lane l holds ROWS consecutive rows
//     (as wavefront_geometry lays out C), E diagonals k+1 and k+2 in
//     registers; the "down" and "diagonal" successors of a lane's last row
//     come from lane l+1 by one __shfl_down_sync a step (the diagonal one is
//     the previous step's shuffle).  A step is that shuffle and, per row,
//     three products and two sums (round-to-nearest intrinsics: no FMA, the
//     reference's rounding) on weights read a diagonal ahead.  No block
//     barrier, except for Ta > 32 * 8: there a table takes several warps,
//     which hand their boundary row over through shared memory with one
//     barrier a step.
//
// Two layouts, cut by ops/softdtw.py backward_geometry:
//   * `fits` (one launch): the block stages D and R in shared memory with
//     16-byte loads, computes the weights into shared memory with all 32 of
//     its warps, one __syncthreads(), runs the chain, which writes each
//     diagonal's E over that diagonal's consumed weights (one store a row),
//     and copies E out in row order, coalesced.  [96, 48, 48] takes 91 KB a
//     block.
//   * otherwise (two launches): weights_kernel writes W [B][K][3][ROWS][lanes]
//     to a device scratch buffer with every thread of the card, and the chain
//     kernel streams each warp's slice through a ring of DEPTH diagonals in
//     shared memory with cp.async (32, else 8, else 2: as many as fit),
//     writing E cell by cell.
//
// Bound: latency.  The Ta + Tb - 1 steps are a chain; D, R are read and E
// written once.  The exponent is <= 0 in exact arithmetic and may sit a few
// ulp above 0 in float32; it is not clamped, as in the plain version.
// tests/test_torch_softdtw_bwd_schedule.py transcribes the weight layout and
// the lane/row schedule.

#include <cuda_runtime.h>

#include <cmath>

#include "softdtw_common.cuh"

namespace {

constexpr int kFitThreads = 1024;  // a block of the one-launch layout: 32 warps for the weights
constexpr unsigned kFull = 0xffffffffu;

// Floats one table takes in the one-launch layout: the staged D and R (E is
// written over D), then W [K][3][ROWS][32].
__host__ __device__ inline int fit_table_floats(int Ta, int Tb, int rows) {
  return 2 * slot_floats(Ta, Tb) + 3 * (Ta + Tb - 1) * 32 * rows;
}

// `fits`: the tables of the one-launch layout; else each warp's ring of
// `ring` diagonals of weights, then the boundary hand-over [2][warps].
__host__ __device__ inline int smem_bytes(int Ta, int Tb, int rows, int warps, int tables,
                                          int fits, int ring) {
  if (fits) return 4 * tables * fit_table_floats(Ta, Tb, rows);
  return 4 * (tables * warps * ring * 3 * 32 * rows + 2 * warps);
}

template <bool GLOBAL>
__device__ __forceinline__ float ld(const float* p) {
  return GLOBAL ? __ldg(p) : *p;
}

// The three successor weights of cell (i, k - i) of one table (D, R
// [Ta, Tb] in shared or device memory) into w: down, right, diagonal; 0 for
// a successor outside the table; w[0] = -1 where the cell is not live.
// Every lane of the warp calls this together (`act`: the lane has a slot).
template <bool GLOBAL>
__device__ __forceinline__ void cell_weights(float (&w)[3], const float* Dt, const float* Rt,
                                             int i, int k, int Ta, int Tb, float gamma,
                                             float inv, bool act) {
  const int j = k - i;
  const bool inside = act && i < Ta && j >= 0 && j < Tb;
  const int cell = i * Tb + j;
  const bool live = inside && ld<GLOBAL>(Dt + cell) < kInf;
  const bool on[3] = {live && i + 1 < Ta, live && j + 1 < Tb, live && i + 1 < Ta && j + 1 < Tb};
  const int off[3] = {Tb, 1, Tb + 1};
  float x[3] = {0.0f, 0.0f, 0.0f};
  bool quick = inv != 0.0f;
  if (live) {
    const float r = ld<GLOBAL>(Rt + cell);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (on[c]) {
        x[c] = (ld<GLOBAL>(Rt + cell + off[c]) - r) - ld<GLOBAL>(Dt + cell + off[c]);
        quick = quick && quick_ok(x[c]);
      }
    }
  }
  if (__all_sync(kFull, quick)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = on[c] ? expf(quick_div(x[c], gamma, inv)) : 0.0f;
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) w[c] = on[c] ? expf(x[c] / gamma) : 0.0f;
  }
  if (!live) w[0] = -1.0f;
}

// Weights of the one-launch layout: W [K][3][ROWS][32] of one table in
// shared memory, read in place.
template <int ROWS>
struct SmemWeights {
  const float* W;  // this lane's column: W + lane
  __device__ __forceinline__ void fetch(int k, float (&w)[3][ROWS]) const {
    const float* d = W + k * 3 * ROWS * 32;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int q = 0; q < ROWS; ++q) w[c][q] = d[(c * ROWS + q) * 32];
    }
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Weights of the two-launch layout: the warp's slice of W [K][3][ROWS][T32]
// in device memory, streamed through a ring of DEPTH diagonals in shared
// memory ([DEPTH][3][ROWS][32]) by cp.async, DEPTH - 1 diagonals ahead.
// fetch() is called for k = K-2, K-3, ..., 0 in that order, by the whole warp.
template <int ROWS, int DEPTH>
struct RingWeights {
  const float* g;  // W of the table + 32 * (warp within the table)
  float* ring;     // the warp's ring
  int T32, lane, K;
  int m;           // fetches so far

  __device__ __forceinline__ void issue(int n) {  // diagonal K-2-n into slot n % DEPTH
    const int k = K - 2 - n;
    if (k >= 0) {
      float* dst = ring + (n % DEPTH) * 3 * ROWS * 32;
      const float* src = g + (size_t)k * 3 * ROWS * T32;
      for (int e = lane; e < 3 * ROWS * 8; e += 32) {
        const int row = e >> 3, part = e & 7;
        cp_async16(dst + row * 32 + part * 4, src + (size_t)row * T32 + part * 4);
      }
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void prime() {
    for (int n = 0; n < DEPTH - 1; ++n) issue(n);
  }
  __device__ __forceinline__ void fetch(int, float (&w)[3][ROWS]) {
    cp_async_wait<DEPTH - 2>();  // fetch m's group has landed for this lane
    __syncwarp();                // ... and for the others; slot (m-1) % DEPTH is free
    issue(m + DEPTH - 1);
    const float* d = ring + (m % DEPTH) * 3 * ROWS * 32 + lane;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int q = 0; q < ROWS; ++q) w[c][q] = d[(c * ROWS + q) * 32];
    }
    ++m;
  }
};

// The chain of one table for one warp: diagonals K-1 down to 0 (K-1 holds
// only the corner).  `row0`: the lane's first row; `out(k, q, e)` stores
// row q's E at diagonal k.
// MULTI: the table's warps hand their boundary rows over through `bnd`
// [2][warps] with a block barrier a step.
template <int ROWS, bool MULTI, class Weights, class Out>
__device__ __forceinline__ void run_chain(Weights& src, Out out, int Ta, int Tb, int row0,
                                          int lane, int wt, int warps, float corner,
                                          float* bnd) {
  const int K = Ta + Tb - 1;
  float e1[ROWS], e2[ROWS], w[3][ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const bool at = row0 + q == Ta - 1;
    e1[q] = at ? corner : 0.0f;
    e2[q] = 0.0f;
  }
  if (MULTI) {
    if (lane == 0) bnd[((K - 1) & 1) * warps + wt] = e1[0];
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) out(K - 1, q, e1[q]);
  float shprev = 0.0f;  // lane l+1's first row at diagonal k+2
  if (K >= 2) src.fetch(K - 2, w);
  for (int k = K - 2; k >= 0; --k) {
    float wn[3][ROWS];
    if (k > 0) src.fetch(k - 1, wn);
    float sh = __shfl_down_sync(kFull, e1[0], 1);  // lane l+1's first row at k+1
    if (MULTI) {
      const float handed = bnd[((k + 1) & 1) * warps + (wt + 1 < warps ? wt + 1 : wt)];
      if (lane == 31) sh = wt + 1 < warps ? handed : 0.0f;
    } else if (lane == 31) {
      sh = 0.0f;
    }
    float e[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const float down = q + 1 < ROWS ? e1[q + 1] : sh;
      const float diag = q + 1 < ROWS ? e2[q + 1] : shprev;
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(w[0][q], down), __fmul_rn(w[1][q], e1[q])),
                                __fmul_rn(w[2][q], diag));
      e[q] = w[0][q] < 0.0f ? 0.0f : s;
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      e2[q] = e1[q];
      e1[q] = e[q];
      out(k, q, e[q]);
    }
    shprev = sh;
    if (MULTI) {
      if (lane == 0) bnd[(k & 1) * warps + wt] = e[0];
      __syncthreads();
    }
    if (k > 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int q = 0; q < ROWS; ++q) w[c][q] = wn[c][q];
      }
    }
  }
}

// One launch: stage, weights by the whole block, chain by warp t for the
// block's table t, copy out.
template <int ROWS>
__global__ void __launch_bounds__(kFitThreads)
    backward_fit_kernel(const float* __restrict__ D, const float* __restrict__ R,
                        float* __restrict__ E, int B, int Ta, int Tb, float gamma, float inv,
                        int tables, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int n = Ta * Tb, K = Ta + Tb - 1, P = 32 * ROWS;
  const int tf = fit_table_floats(Ta, Tb, ROWS), slot = slot_floats(Ta, Tb);
  const int b0 = blockIdx.x * tables;
  const int here = min(tables, B - b0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  for (int t = 0; t < here; ++t) {
    const float* src[2] = {D + (size_t)(b0 + t) * n, R + (size_t)(b0 + t) * n};
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float* dst = smem + t * tf + a * slot;
      if (vec) {
        const float4* s4 = reinterpret_cast<const float4*>(src[a]);
        float4* d4 = reinterpret_cast<float4*>(dst);
        for (int e = threadIdx.x; e < n / 4; e += blockDim.x) d4[e] = __ldg(s4 + e);
      } else {
        for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = __ldg(src[a] + e);
      }
    }
  }
  __syncthreads();

  // A warp takes whole diagonals, its lanes consecutive rows (conflict-free
  // reads of the staged table where Tb is even), so every lane reaches the
  // vote in cell_weights.
  const int warps = blockDim.x / 32;
  for (int tk = warp; tk < here * K; tk += warps) {
    const int t = tk / K, k = tk % K;
    const float* base = smem + t * tf;
    float* Wk = smem + t * tf + 2 * slot + k * 3 * P;
#pragma unroll
    for (int q0 = 0; q0 < ROWS; ++q0) {
      const int i = q0 * 32 + lane;
      float w[3];
      cell_weights<false>(w, base, base + slot, i, k, Ta, Tb, gamma, inv, true);
      float* W = Wk + (i % ROWS) * 32 + i / ROWS;
      W[0] = w[0];
      W[P] = w[1];
      W[2 * P] = w[2];
    }
  }
  __syncthreads();

  // The chain writes diagonal k's E over diagonal k's "down" weights,
  // which it read a step before: one store a row, at consecutive words.
  if (warp < here) {
    float* base = smem + warp * tf;
    const float corner = base[n - 1] < kInf ? 1.0f : 0.0f;
    float* Wl = base + 2 * slot + lane;
    SmemWeights<ROWS> src{Wl};
    run_chain<ROWS, false>(src, [Wl](int k, int q, float v) { Wl[(k * 3 * ROWS + q) * 32] = v; },
                           Ta, Tb, lane * ROWS, lane, 0, 1, corner, nullptr);
  }
  __syncthreads();

  // E back to row-major order, coalesced stores.
  for (int t = 0; t < here; ++t) {
    const float* Et = smem + t * tf + 2 * slot;
    float* dst = E + (size_t)(b0 + t) * n;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = e / Tb, k = i + e % Tb;
      dst[e] = Et[k * 3 * P + (i % ROWS) * 32 + i / ROWS];
    }
  }
}

// Two launches, the first: W [B][K][3][rows][T32] with T32 = 32 * warps, one
// thread a slot (table, diagonal, row q, lane t; t fastest, so the stores
// are coalesced), row i = t * rows + q.
__global__ void weights_kernel(const float* __restrict__ D, const float* __restrict__ R,
                               float* __restrict__ W, int B, int Ta, int Tb, float gamma,
                               float inv, int rows, int T32) {
  const int n = Ta * Tb, K = Ta + Tb - 1;
  const long long total = (long long)B * K * rows * T32;
  const int lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s0 = (long long)blockIdx.x * blockDim.x + threadIdx.x - lane; s0 < total;
       s0 += stride) {
    const long long s = s0 + lane;
    const bool act = s < total;
    const long long u = act ? s : 0;
    const int t = (int)(u % T32), q = (int)(u / T32 % rows), k = (int)(u / T32 / rows % K);
    const long long b = u / T32 / rows / K;
    float w[3];
    cell_weights<true>(w, D + b * n, R + b * n, t * rows + q, k, Ta, Tb, gamma, inv, act);
    if (act) {
      float* dst = W + ((b * K + k) * 3 * rows + q) * T32 + t;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[(size_t)c * rows * T32] = w[c];
    }
  }
}

// Two launches, the second: the chain of table b by its `warps` warps
// (several tables a block only when warps == 1), weights through the ring.
// Blocks: up to 4 warps (one a table), up to 9 warps with a ring of 8, up
// to 32 with a ring of 2, where the bound holds a thread to 64 registers.
template <int ROWS, bool MULTI, int DEPTH>
__global__ void __launch_bounds__(!MULTI ? 128 : DEPTH == 8 ? 288 : 1024)
    backward_chain_kernel(const float* __restrict__ D, const float* __restrict__ W,
                                      float* __restrict__ E, int B, int Ta, int Tb, int warps,
                                      int tables) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / warps, wt = warp % warps;
  const int b = blockIdx.x * tables + slot;
  if (b >= B) return;  // only when one warp per table: no block barrier below
  const int n = Ta * Tb, K = Ta + Tb - 1, T32 = 32 * warps;
  float* bnd = smem + tables * warps * DEPTH * 3 * 32 * ROWS;
  RingWeights<ROWS, DEPTH> src{W + (size_t)b * K * 3 * ROWS * T32 + 32 * wt,
                               smem + warp * DEPTH * 3 * 32 * ROWS, T32, lane, K, 0};
  src.prime();
  float* Eb = E + (size_t)b * n;
  const float corner = __ldg(D + (size_t)b * n + n - 1) < kInf ? 1.0f : 0.0f;
  const int row0 = (32 * wt + lane) * ROWS;
  run_chain<ROWS, MULTI>(
      src,
      [Eb, Ta, Tb, row0](int k, int q, float v) {
        const int i = row0 + q, j = k - i;
        if (i < Ta && j >= 0 && j < Tb) Eb[i * Tb + j] = v;
      },
      Ta, Tb, row0, lane, wt, warps, corner, bnd);
  cp_async_wait<0>();  // drain the empty trailing groups before the block exits
}

const void* pick_fit(int rows) {
  switch (rows) {
    case 1: return (const void*)&backward_fit_kernel<1>;
    case 2: return (const void*)&backward_fit_kernel<2>;
    case 4: return (const void*)&backward_fit_kernel<4>;
    default: return nullptr;  // 8 rows a lane never fit: 3 * 257 * 256 weights alone

  }
}

template <int ROWS>
const void* pick_single(int ring) {
  if (ring == 32) return (const void*)&backward_chain_kernel<ROWS, false, 32>;
  if (ring == 8) return (const void*)&backward_chain_kernel<ROWS, false, 8>;
  return nullptr;
}

// One warp a table: a ring of 32 diagonals, or 8 where 32 do not fit.  A
// table of several warps always has ROWS = 8, a ring of 8 (up to 9 warps)
// or 2.
const void* pick_chain(int rows, int warps, int ring) {
  if (warps > 1) {
    if (rows != 8) return nullptr;
    if (ring == 8 && warps <= 9) return (const void*)&backward_chain_kernel<8, true, 8>;
    if (ring == 2) return (const void*)&backward_chain_kernel<8, true, 2>;
    return nullptr;
  }
  switch (rows) {
    case 1: return pick_single<1>(ring);
    case 2: return pick_single<2>(ring);
    case 4: return pick_single<4>(ring);
    case 8: return pick_single<8>(ring);
    default: return nullptr;
  }
}

int threads_of(int warps, int tables, int fits) { return fits ? kFitThreads : 32 * warps * tables; }

}  // namespace

// Shared memory in bytes a block of this geometry asks for.
extern "C" int softdtw_backward_smem(int Ta, int Tb, int rows, int warps, int tables, int fits,
                                     int ring) {
  return smem_bytes(Ta, Tb, rows, warps, tables, fits, ring);
}

// Blocks of this geometry (the one-launch kernel, or the chain kernel) one
// SM holds at once (negative: a CUDA error).
extern "C" int softdtw_backward_blocks_per_sm(int Ta, int Tb, int rows, int warps, int tables,
                                              int fits, int ring) {
  const void* fn = fits ? pick_fit(rows) : pick_chain(rows, warps, ring);
  if (!fn) return -1;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return -(int)rc;
  int nb = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, fn, threads_of(warps, tables, fits), smem_bytes(Ta, Tb, rows, warps, tables, fits, ring));
  return rc == cudaSuccess ? nb : -(int)rc;
}

// D, R, E [B, Ta, Tb] float32; gamma > 0.  `rows` per lane, `warps` per
// table (Ta <= 32 * rows * warps, warps <= 32), `tables` per block (1 when
// warps > 1); `fits`: the one-launch layout (warps == 1), else the weights go
// through W, a device buffer of B * (Ta + Tb - 1) * 3 * 32 * rows * warps
// floats, and a ring of `ring` (8 or 2) diagonals; `vec`: D, R and E
// 16-byte aligned with Ta * Tb % 4 == 0.
extern "C" int softdtw_backward_launch(const void* D, const void* R, void* E, void* W, int B,
                                       int Ta, int Tb, float gamma, int rows, int warps,
                                       int tables, int fits, int ring, int vec, void* stream) {
  if (!(gamma > 0.0f) || Ta > 32 * rows * warps || warps > 32 || tables < 1 ||
      (warps > 1 && tables != 1) || (fits && (warps != 1 || tables > kFitThreads / 32)) ||
      (!fits && !W))
    return (int)cudaErrorInvalidValue;
  const void* fn = fits ? pick_fit(rows) : pick_chain(rows, warps, ring);
  if (!fn) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(Ta, Tb, rows, warps, tables, fits, ring);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return (int)rc;
  float inv = reciprocal(gamma);
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((B + tables - 1) / tables), block(threads_of(warps, tables, fits));
  if (fits) {
    void* args[] = {&D, &R, &E, &B, &Ta, &Tb, &gamma, &inv, &tables, &vec};
    rc = cudaLaunchKernel(fn, grid, block, args, (size_t)smem, s);
    if (rc != cudaSuccess) return (int)rc;
    return (int)cudaGetLastError();
  }
  const int T32 = 32 * warps;
  const long long slots = (long long)B * (Ta + Tb - 1) * rows * T32;
  const long long wblocks = (slots + 255) / 256;
  weights_kernel<<<(unsigned)(wblocks < (1 << 20) ? wblocks : (1 << 20)), 256, 0, s>>>(
      (const float*)D, (const float*)R, (float*)W, B, Ta, Tb, gamma, inv, rows, T32);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  void* args[] = {&D, &W, &E, &B, &Ta, &Tb, &warps, &tables};
  rc = cudaLaunchKernel(fn, grid, block, args, (size_t)smem, s);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
