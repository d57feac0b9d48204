// What kernels C (softdtw.cu) and E (softdtw_bwd.cu) share: the +INF
// padding, the shared-memory limit, the division by gamma (quick_div), the
// table slot in shared memory and the one-time opt-in to more than 48 KB of
// dynamic shared memory.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float kInf = 1e10f;
constexpr int kMaxSmem = 232448;    // 227 KB, the most a block may ask for

// x / gamma as IEEE division rounds it, given inv = RN(1 / gamma): the
// product, its exact remainder by FMA and one correction (Markstein).  Exact
// where no step overflows or leaves the normal range: `quick_ok` holds and
// 2^-40 <= gamma <= 2^40 (the host passes inv = 0 otherwise).  Plain `/`
// compiles to a reciprocal, a range check and a call to a slow path fenced
// by convergence barriers, which serialize the six divisions of a step.
__device__ __forceinline__ float quick_div(float x, float gamma, float inv) {
  const float q = __fmul_rn(x, inv);
  return __fmaf_rn(__fmaf_rn(-q, gamma, x), inv, q);
}

__device__ __forceinline__ bool quick_ok(float x) {
  const float a = fabsf(x);
  return x == 0.0f || (a >= 0x1p-60f && a <= 0x1p60f);
}

// Floats of shared memory a table slot takes (a multiple of 4, so every
// slot starts 16-byte aligned).
__host__ __device__ inline int slot_floats(int Ta, int Tb) { return (Ta * Tb + 3) / 4 * 4; }

// RN(1 / gamma), the float nearest the reciprocal, for quick_div; 0 where
// gamma is outside [2^-40, 2^40] (every division then takes plain `/`).
float reciprocal(float gamma) {
  if (!(gamma >= 0x1p-40f && gamma <= 0x1p40f)) return 0.0f;
  const float r = (float)(1.0 / (double)gamma);
  float best = r;
  double err = fabs((double)r * gamma - 1.0);  // exact: a float product fits a double
  for (float c : {nextafterf(r, 0.0f), nextafterf(r, 2.0f * r)}) {
    const double e = fabs((double)c * gamma - 1.0);
    if (e < err) {
      best = c;
      err = e;
    }
  }
  return best;
}

// Raises the kernel's dynamic shared-memory limit to kMaxSmem, once.
cudaError_t prepare(const void* fn) {
  static const void* done[32] = {};
  for (const void* d : done) {
    if (d == fn) return cudaSuccess;
  }
  const cudaError_t rc =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (rc != cudaSuccess) return rc;
  for (const void*& d : done) {
    if (!d) {
      d = fn;
      break;
    }
  }
  return cudaSuccess;
}

}  // namespace
