// Kernel E: soft-DTW backward, the E-recursion as a reverse wavefront.
//
// Replaces golfaction_tpu/ops/pallas/softdtw_kernel.py (_backward_batch_jit,
// body _backward_kernel).  E[i, j] = d cost / d D[i, j] is
//   E[i, j] = sum over the successors s in {(i+1, j), (i, j+1), (i+1, j+1)}
//             of exp((R[s] - R[i, j] - D[s]) / gamma) * E[s],
// seeded with E[Ta-1, Tb-1] = 1; a successor outside the table weighs 0.
// The TPU kernel walks pre-skewed [K, Ta] copies of D and R and masks the
// out-of-band lanes after sanitising their exponents; here each block reads
// D and R [Ta, Tb] directly at the successors' cells, and a successor
// outside the table is skipped by an index test before any expf, so no
// INF - INF can form.  One block per table, one thread per row i (a thread
// loops over rows when Ta exceeds the block), anti-diagonals k = Ta+Tb-2
// down to 0.  E diagonals k+1 and k+2 live in shared memory in a ring of
// three buffers of Ta+1 floats (slot Ta stays 0: the row below the table),
// one __syncthreads() per diagonal.
//
// Bound: latency, as the forward wavefront (csrc/softdtw.cu): Ta+Tb-1
// dependent steps of three expf per row and a block-wide barrier, and B
// tables fill only B SMs.  Every step stays on chip; D, R are read and E is
// written once.
//
// The exponent is <= 0 in exact arithmetic and may sit a few ulp above 0 in
// float32; it is not clamped, as in the plain version.  A cell whose own
// cost is the +INF padding (1e10) gets E = 0, as in the reference.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e10f;

__global__ void backward_kernel(const float* __restrict__ D,  // [B, Ta, Tb]
                                const float* __restrict__ R,  // [B, Ta, Tb]
                                float* __restrict__ E,        // [B, Ta, Tb]
                                int Ta, int Tb, float gamma) {
  extern __shared__ float ring[];  // 3 x (Ta + 1)
  const size_t table = (size_t)blockIdx.x * Ta * Tb;
  const float* Db = D + table;
  const float* Rb = R + table;
  float* Eb = E + table;
  const int stride = Ta + 1;
  float* e0 = ring;               // diagonal k (written)
  float* e1 = ring + stride;      // diagonal k+1
  float* e2 = ring + 2 * stride;  // diagonal k+2
  for (int i = threadIdx.x; i < 3 * stride; i += blockDim.x) ring[i] = 0.0f;
  __syncthreads();

  const int K = Ta + Tb - 1;
  for (int k = K - 1; k >= 0; --k) {
    for (int i = threadIdx.x; i < Ta; i += blockDim.x) {
      const int j = k - i;
      float e = 0.0f;
      if (j >= 0 && j < Tb) {
        const size_t cell = (size_t)i * Tb + j;
        if (k == K - 1) {
          e = 1.0f;  // the corner (Ta-1, Tb-1) is alone on its diagonal
        } else if (Db[cell] < kInf) {
          const float r = Rb[cell];
          const bool down = i + 1 < Ta, right = j + 1 < Tb;
          if (down) {
            const size_t s = cell + Tb;
            e += expf((Rb[s] - r - Db[s]) / gamma) * e1[i + 1];
          }
          if (right) {
            const size_t s = cell + 1;
            e += expf((Rb[s] - r - Db[s]) / gamma) * e1[i];
          }
          if (down && right) {
            const size_t s = cell + Tb + 1;
            e += expf((Rb[s] - r - Db[s]) / gamma) * e2[i + 1];
          }
        }
        Eb[cell] = e;
      }
      e0[i] = e;
    }
    __syncthreads();
    float* t = e2;
    e2 = e1;
    e1 = e0;
    e0 = t;
  }
}

}  // namespace

extern "C" int softdtw_backward_launch(const void* D, const void* R, void* E,
                                       int B, int Ta, int Tb, float gamma,
                                       void* stream) {
  int threads = ((Ta + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  const size_t smem = 3 * (size_t)(Ta + 1) * sizeof(float);
  backward_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)D, (const float*)R, (float*)E, Ta, Tb, gamma);
  return (int)cudaGetLastError();
}
