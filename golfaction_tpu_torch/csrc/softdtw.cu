// Kernel C: soft-DTW (gamma > 0) / hard-DTW (gamma == 0) forward wavefront.
//
// Replaces golfaction_tpu/ops/pallas/softdtw_kernel.py (_wavefront_batch_jit,
// body _wavefront_kernel).  The TPU kernel walks a pre-skewed [K, Ta] copy of
// the cost matrix with the rows of a diagonal across its vector lanes; here
// no skewed copy exists and a table belongs to one warp:
//
//   * lane l holds ROWS consecutive rows (ROWS in {1, 2, 4, 8}: Ta <= 256 in
//     one warp); anti-diagonals k-1 (each row's "left") and k-2 live in
//     registers, the latter as the previous step's "up";
//   * "up" of a lane's first row comes from lane l-1 by __shfl_up_sync; the
//     lane's other rows take theirs from the lane's own registers;
//   * for Ta > 256 a block of ceil(Ta / 256) warps hands the boundary row
//     from warp w-1 to warp w through shared memory, with one barrier a step:
//     the only case that keeps a barrier;
//   * D is off the critical path.  Where the table fits (`staged`), the
//     warps stage its D in shared memory with coalesced 16-byte loads before
//     the first step, each step overwrites the cell of D it consumed with R,
//     and the table goes back to device memory coalesced at the end.  Where
//     it does not fit, each lane prefetches its rows' D a few diagonals ahead
//     into a register ring and writes R straight to device memory.
//
// One warp per table; several tables share a block only when B outnumbers
// the SMs (a block is cut by ops/softdtw.py, wavefront_geometry).  The staged
// table, which writes R from shared memory at the end, is the default:
// chip_smoke.py times the register ring, which writes R cell by cell, beside
// it at [4, 64, 64] (`ring_graph_ms`), and PERF.md has which was faster.
//
// Bound: latency.  The Ta + Tb - 1 diagonals are a chain of dependent steps;
// a step is one shuffle and a soft-min (three expf, a logf, three divisions)
// per row, with nothing else on the chain.  The divisions by gamma are the
// IEEE quotient by a reciprocal and one correction (quick_div): plain `/`
// fences each division's slow path with convergence barriers, which
// serialized a step's six divisions.
//
// Conventions kept from the reference: cells out of the table are +INF
// (1e10) and stay so (d >= INF -> INF); a virtual R[-1, -1] = 0 feeds cell
// (0, 0).  expf/logf (not the fast intrinsics) and the division by gamma
// keep parity with the reference's float32 soft-min.
// tests/test_torch_softdtw_schedule.py transcribes the lane/row schedule.

#include <cuda_runtime.h>

#include <cmath>

#include "softdtw_common.cuh"

namespace {

constexpr int kRing = 4;            // diagonals of D a lane prefetches (ring path)

// The reference's soft-min: m - gamma * log(sum exp(-(v - m) / gamma)).
template <bool QUICK>
__device__ __forceinline__ float softmin3(float a, float b, float c, float gamma, float inv) {
  const float m = fminf(fminf(a, b), c);
  const float xa = -(a - m), xb = -(b - m), xc = -(c - m);
  const float s = QUICK ? expf(quick_div(xa, gamma, inv)) + expf(quick_div(xb, gamma, inv)) +
                              expf(quick_div(xc, gamma, inv))
                        : expf(xa / gamma) + expf(xb / gamma) + expf(xc / gamma);
  return m - gamma * logf(s);
}

// The staged tables, then the boundary hand-over [2][warps].
__host__ __device__ inline int smem_bytes(int Ta, int Tb, int warps, int tables, int staged) {
  return 4 * ((staged ? tables * slot_floats(Ta, Tb) : 0) + 2 * warps);
}

// D of a lane's rows at diagonal k (+INF outside the table), from the
// staged table in shared memory or from device memory.
template <int ROWS>
__device__ __forceinline__ void d_at(float (&d)[ROWS], const float* src, int row0, int k, int Ta,
                                     int Tb, bool global) {
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int i = row0 + q, j = k - i;
    const bool in = i < Ta && j >= 0 && j < Tb;
    const float* p = src + i * Tb + j;
    d[q] = in ? (global ? __ldg(p) : *p) : kInf;
  }
}

// One diagonal for a lane's rows: row q's "left" is its own value at k-1,
// its "up" row q-1's (up0, from lane l-1, for the first row), its "diag" the
// previous step's "up".  `origin`: the lane holds cell (0, 0) and k == 0.
template <int ROWS, bool SOFT>
__device__ __forceinline__ void step_rows(float (&left)[ROWS], float (&upprev)[ROWS],
                                          const float (&d)[ROWS], float up0, float gamma,
                                          float inv, bool origin) {
  float up[ROWS], diag[ROWS], sm[ROWS];
  bool quick = inv != 0.0f;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    up[q] = q > 0 ? left[q - 1] : up0;
    diag[q] = upprev[q];
    upprev[q] = up[q];
    if (SOFT) {
      sm[q] = softmin3<true>(left[q], up[q], diag[q], gamma, inv);
      const float m = fminf(fminf(left[q], up[q]), diag[q]);
      quick = quick && quick_ok(m - left[q]) && quick_ok(m - up[q]) && quick_ok(m - diag[q]);
    } else {
      sm[q] = fminf(fminf(left[q], up[q]), diag[q]);
    }
  }
  // A dividend outside quick_div's range anywhere in the warp (rare: a
  // difference of two costs under 2^-60): the step again with `/`.
  if (SOFT && !__all_sync(0xffffffffu, quick)) {
#pragma unroll
    for (int q = 0; q < ROWS; ++q) sm[q] = softmin3<false>(left[q], up[q], diag[q], gamma, inv);
  }
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    if (q == 0 && origin) sm[q] = 0.0f;
    left[q] = d[q] >= kInf ? kInf : d[q] + sm[q];
  }
}

// MULTI: a table of several warps (Ta > 32 * ROWS), which hand their
// boundary rows over through shared memory with a block barrier a step.
template <int ROWS, bool STAGED, bool SOFT, bool MULTI>
__global__ void wavefront_kernel(const float* __restrict__ D,  // [B, Ta, Tb]
                                 float* __restrict__ R,        // [B, Ta, Tb]
                                 int B, int Ta, int Tb, float gamma, float inv, int warps,
                                 int tables, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = warp / warps, wt = warp % warps;  // table slot, warp within the table
  const int b = blockIdx.x * tables + slot;
  if (b >= B) return;  // only when one warp per table: no block barrier below
  const int n = Ta * Tb;
  const float* Db = D + (size_t)b * n;
  float* Rb = R + (size_t)b * n;
  float* tab = smem + slot * slot_floats(Ta, Tb);
  float* bnd = smem + (STAGED ? tables * slot_floats(Ta, Tb) : 0);  // [2][warps]
  const int tthreads = 32 * warps, tt = wt * 32 + lane;

  if (STAGED) {
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(Db);
      float4* dst = reinterpret_cast<float4*>(tab);
      for (int e = tt; e < n / 4; e += tthreads) dst[e] = __ldg(src + e);
    } else {
      for (int e = tt; e < n; e += tthreads) tab[e] = __ldg(Db + e);
    }
    if (MULTI) __syncthreads(); else __syncwarp();
  }

  const int row0 = tt * ROWS;  // the lane's first row
  float left[ROWS], upprev[ROWS], ring[kRing][ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    left[q] = kInf;
    upprev[q] = kInf;
  }
  // D a step ahead (staged: the next diagonal, read before this step's
  // cells are overwritten; else kRing diagonals in the register ring).
  constexpr int kAhead = STAGED ? 1 : kRing;
  const float* dsrc = STAGED ? tab : Db;
#pragma unroll
  for (int p = 0; p < kAhead; ++p) d_at<ROWS>(ring[p], dsrc, row0, p, Ta, Tb, !STAGED);
  float* out = STAGED ? tab : Rb;
  const int K = Ta + Tb - 1;
  for (int k0 = 0; k0 < K; k0 += kRing) {
#pragma unroll
    for (int p = 0; p < kRing; ++p) {
      const int k = k0 + p;
      if (k >= K) break;
      const int slot_now = STAGED ? 0 : p;
      float d[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) d[q] = ring[slot_now][q];
      d_at<ROWS>(ring[slot_now], dsrc, row0, k + kAhead, Ta, Tb, !STAGED);
      float up0 = __shfl_up_sync(0xffffffffu, left[ROWS - 1], 1);
      if (MULTI) {
        const float handed = bnd[((k - 1) & 1) * warps + (wt > 0 ? wt - 1 : 0)];
        if (lane == 0) up0 = wt > 0 && k > 0 ? handed : kInf;
      } else if (lane == 0) {
        up0 = kInf;
      }
      step_rows<ROWS, SOFT>(left, upprev, d, up0, gamma, inv, k == 0 && row0 == 0);
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const int i = row0 + q, j = k - i;
        if (i < Ta && j >= 0 && j < Tb) out[i * Tb + j] = left[q];
      }
      if (MULTI) {
        if (lane == 31) bnd[(k & 1) * warps + wt] = left[ROWS - 1];
        __syncthreads();
      }
    }
  }
  if (STAGED) {
    if (MULTI) __syncthreads(); else __syncwarp();
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(tab);
      float4* dst = reinterpret_cast<float4*>(Rb);
      for (int e = tt; e < n / 4; e += tthreads) dst[e] = src[e];
    } else {
      for (int e = tt; e < n; e += tthreads) Rb[e] = tab[e];
    }
  }
}

template <int ROWS, bool MULTI>
const void* pick_of(bool staged, bool soft) {
  if (staged) {
    return soft ? (const void*)&wavefront_kernel<ROWS, true, true, MULTI>
                : (const void*)&wavefront_kernel<ROWS, true, false, MULTI>;
  }
  return soft ? (const void*)&wavefront_kernel<ROWS, false, true, MULTI>
              : (const void*)&wavefront_kernel<ROWS, false, false, MULTI>;
}

// A table of several warps always has ROWS = 8.
const void* pick(int rows, int warps, int staged, int soft) {
  if (warps > 1) return rows == 8 ? pick_of<8, true>(staged, soft) : nullptr;
  switch (rows) {
    case 1: return pick_of<1, false>(staged, soft);
    case 2: return pick_of<2, false>(staged, soft);
    case 4: return pick_of<4, false>(staged, soft);
    case 8: return pick_of<8, false>(staged, soft);
    default: return nullptr;
  }
}

// Counts x in [first, first + count) (float bit patterns) where quick_ok
// holds and quick_div(x) is another value than x / gamma (a zero may differ
// in sign: expf does not see it).
__global__ void division_check_kernel(unsigned first, unsigned count, float gamma, float inv,
                                      unsigned long long* mismatches) {
  unsigned long long bad = 0;
  for (unsigned long long e = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       e < count; e += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float(first + (unsigned)e);
    if (quick_ok(x) && !(quick_div(x, gamma, inv) == x / gamma)) ++bad;
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

// The kernel's quick division against IEEE division over `count` float bit
// patterns from `first`, at this gamma; the mismatches land in *mismatches
// (device memory).  Returns 1 when gamma takes no quick division.
extern "C" int softdtw_division_check(unsigned first, unsigned count, float gamma,
                                      void* mismatches, void* stream) {
  const float inv = reciprocal(gamma);
  if (inv == 0.0f) return 1;
  division_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
      first, count, gamma, inv, (unsigned long long*)mismatches);
  return (int)cudaGetLastError();
}

// Shared memory in bytes a block of this geometry asks for.
extern "C" int softdtw_wavefront_smem(int Ta, int Tb, int warps, int tables, int staged) {
  return smem_bytes(Ta, Tb, warps, tables, staged);
}

// Blocks of this geometry one SM holds at once (negative: a CUDA error).
extern "C" int softdtw_wavefront_blocks_per_sm(int Ta, int Tb, int rows, int warps, int tables,
                                               int staged, int soft) {
  const void* fn = pick(rows, warps, staged, soft);
  if (!fn) return -1;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return -(int)rc;
  int n = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, 32 * warps * tables,
                                                     smem_bytes(Ta, Tb, warps, tables, staged));
  return rc == cudaSuccess ? n : -(int)rc;
}

// D, R [B, Ta, Tb] float32.  `rows` per lane, `warps` per table (Ta <= 32 *
// rows * warps), `tables` per block (1 when warps > 1), `staged`: D in shared
// memory; `vec`: D and R 16-byte aligned with Ta * Tb % 4 == 0.
extern "C" int softdtw_wavefront_launch(const void* D, void* R, int B, int Ta, int Tb,
                                        float gamma, int rows, int warps, int tables,
                                        int staged, int vec, void* stream) {
  if (Ta > 32 * rows * warps || (warps > 1 && tables != 1) || tables < 1)
    return (int)cudaErrorInvalidValue;
  const void* fn = pick(rows, warps, staged, gamma > 0.0f);
  if (!fn) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(Ta, Tb, warps, tables, staged);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return (int)rc;
  float inv = reciprocal(gamma);
  const void* d = D;
  void* r = R;
  void* args[] = {&d, &r, &B, &Ta, &Tb, &gamma, &inv, &warps, &tables, &vec};
  rc = cudaLaunchKernel(fn, dim3((B + tables - 1) / tables), dim3(32 * warps * tables), args,
                        (size_t)smem, (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
