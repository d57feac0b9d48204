// Kernel C: soft-DTW (gamma > 0) / hard-DTW (gamma == 0) forward wavefront.
//
// Replaces golfaction_tpu/ops/pallas/softdtw_kernel.py (_wavefront_batch_jit,
// body _wavefront_kernel).  The TPU kernel walks a pre-skewed [K, Ta] copy of
// the cost matrix; here each block reads D [Ta, Tb] directly at (i, k - i),
// so no skewed copy exists.  One block per pair, one thread per row i (a
// thread loops over rows when Ta exceeds the block).  Anti-diagonals k-1 and
// k-2 live in shared memory in a ring of three buffers, with one
// __syncthreads() per diagonal.
//
// Bound: latency.  The Ta + Tb - 1 diagonals are a chain of dependent steps,
// each a handful of FLOPs per row followed by a block-wide barrier, and a
// batch of B pairs fills only B SMs.  The design keeps every step on chip
// (shared memory, no global round trip between diagonals); filling the card
// with more pairs per launch is later work.
//
// Conventions kept from the reference: cells out of the table are +INF
// (1e10) and stay so (d >= INF -> INF); a virtual R[-1, -1] = 0 feeds cell
// (0, 0).  expf/logf (not the fast intrinsics) keep parity with the
// reference's float32 soft-min.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e10f;

__global__ void wavefront_kernel(const float* __restrict__ D,  // [B, Ta, Tb]
                                 float* __restrict__ R,        // [B, Ta, Tb]
                                 int Ta, int Tb, float gamma) {
  extern __shared__ float ring[];  // 3 x Ta
  const int b = blockIdx.x;
  const float* Db = D + (size_t)b * Ta * Tb;
  float* Rb = R + (size_t)b * Ta * Tb;
  float* r0 = ring;           // diagonal k (written)
  float* r1 = ring + Ta;      // diagonal k-1
  float* r2 = ring + 2 * Ta;  // diagonal k-2
  for (int i = threadIdx.x; i < Ta; i += blockDim.x) {
    r1[i] = kInf;
    r2[i] = kInf;
  }
  __syncthreads();

  const int K = Ta + Tb - 1;
  for (int k = 0; k < K; ++k) {
    for (int i = threadIdx.x; i < Ta; i += blockDim.x) {
      const int j = k - i;
      const bool in_band = (j >= 0) && (j < Tb);
      const float d = in_band ? Db[(size_t)i * Tb + j] : kInf;
      const float left = r1[i];                     // (i, j-1)
      const float up = i > 0 ? r1[i - 1] : kInf;    // (i-1, j)
      const float diag = i > 0 ? r2[i - 1] : kInf;  // (i-1, j-1)
      float sm;
      if (gamma > 0.0f) {
        const float m = fminf(fminf(left, up), diag);
        const float s = expf(-(left - m) / gamma) + expf(-(up - m) / gamma) +
                        expf(-(diag - m) / gamma);
        sm = m - gamma * logf(s);
      } else {
        sm = fminf(fminf(left, up), diag);
      }
      if (k == 0 && i == 0) sm = 0.0f;
      const float r = d >= kInf ? kInf : d + sm;
      r0[i] = r;
      if (in_band) Rb[(size_t)i * Tb + j] = r;
    }
    __syncthreads();
    float* t = r2;
    r2 = r1;
    r1 = r0;
    r0 = t;
  }
}

}  // namespace

extern "C" int softdtw_wavefront_launch(const void* D, void* R, int B, int Ta,
                                        int Tb, float gamma, void* stream) {
  int threads = ((Ta + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  const size_t smem = 3 * (size_t)Ta * sizeof(float);
  wavefront_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const float*)D, (float*)R, Ta, Tb, gamma);
  return (int)cudaGetLastError();
}
