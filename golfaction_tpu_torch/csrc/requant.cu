// Kernel F: fused int8 epilogue between two integer convolutions.
//
//   y_i32 --dequant--> GroupNorm --> [+ residual] --> [relu] --> int8 | bf16
//
// Replaces golfaction_tpu/ops/pallas/requant_kernel.py (requant_epilogue_pallas,
// body _epilogue_kernel).  The TPU kernel holds one sample's whole [R, C] slab
// in its scratch memory and takes the GroupNorm sums with ones-vector and
// one-hot matrix products, to feed its matrix unit; a slab that does not fit
// there goes to another implementation.  None of that carries over.  Here
// the rows [N, R, C] (channels innermost, as an im2col product leaves them)
// are cut into chunks of rows, and three launches walk them:
//
//   1. stats     grid (chunks, N, sources): every thread owns one channel
//                and a row offset, so a warp reads consecutive addresses; it
//                sums y and y*y over its rows, the block folds the threads'
//                sums into per-group partial sums, in a fixed order;
//   2. finalize  grid (N, sources): adds the chunks' partial sums in order
//                and writes mean and 1/sqrt(var + eps) per (sample, group);
//   3. apply     grid (chunks, N): reads the same chunk again (from L2 where
//                the tensor fits), normalizes, adds the residual, clamps and
//                writes int8 or bf16.
//
// "sources" is 2 when the residual is itself an int32 convolution output
// with its own GroupNorm (the projection shortcut): its statistics are taken
// in the same launches.  Any R and any size run through the same three
// launches; C is limited to 1024 (one thread per channel).
//
// Bound: bytes.  Each element is read as 4 bytes (plus 1 or 4 of residual)
// and written as 1 or 2, against about twenty float operations.  The second
// read of the input is the price of statistics that span the whole slab.
//
// Parity with the plain version: sums are taken in another order, so mean
// and rstd differ in the last bits; everything after them is written with
// the round-to-nearest intrinsics so that nvcc contracts no product and sum
// into one fused operation, and rintf rounds half to even as torch.round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-6f;  // flax.linen.GroupNorm's epsilon

__global__ void stats_kernel(const int* __restrict__ y, const float* __restrict__ sy,
                             const int* __restrict__ res, const float* __restrict__ res_sy,
                             float* __restrict__ partial,  // [S, N, chunks, G, 2]
                             int R, int C, int G, int rows_per_chunk) {
  extern __shared__ float sh[];  // [2, T]
  const int src = blockIdx.z, n = blockIdx.y, chunk = blockIdx.x;
  const int chunks = gridDim.x, N = gridDim.y, T = blockDim.x;
  const int* in = src ? res : y;
  const float scale = (src ? res_sy : sy)[threadIdx.x % C];
  const int c = threadIdx.x % C, ro = threadIdx.x / C, rpi = T / C;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  const int* base = in + (size_t)n * R * C + c;
  float sum = 0.0f, sq = 0.0f;
  for (int row = r0 + ro; row < r1; row += rpi) {
    const float v = __fmul_rn((float)base[(size_t)row * C], scale);
    sum += v;
    sq += v * v;
  }
  sh[threadIdx.x] = sum;
  sh[T + threadIdx.x] = sq;
  __syncthreads();
  if (threadIdx.x < G) {
    const int cpg = C / G;
    float a = 0.0f, b = 0.0f;
    for (int o = 0; o < rpi; ++o) {
      for (int k = 0; k < cpg; ++k) {
        const int i = o * C + threadIdx.x * cpg + k;
        a += sh[i];
        b += sh[T + i];
      }
    }
    float* p = partial + ((((size_t)src * N + n) * chunks + chunk) * G + threadIdx.x) * 2;
    p[0] = a;
    p[1] = b;
  }
}

__global__ void finalize_kernel(const float* __restrict__ partial,  // [S, N, chunks, G, 2]
                                float* __restrict__ stats,          // [S, N, G, 2]
                                int chunks, int G, float count) {
  const int n = blockIdx.x, src = blockIdx.y, N = gridDim.x;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float* p = partial + (((size_t)src * N + n) * chunks * G + g) * 2;
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      a += p[(size_t)k * G * 2];
      b += p[(size_t)k * G * 2 + 1];
    }
    const float mu = __fdiv_rn(a, count);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(b, count), __fmul_rn(mu, mu)), 0.0f);
    float* s = stats + (((size_t)src * N + n) * G + g) * 2;
    s[0] = mu;
    s[1] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, kEps)));
  }
}

// res_mode: 0 none, 1 int8 with one scale, 2 int32 with its own GroupNorm.
template <typename Out>
__global__ void apply_kernel(const int* __restrict__ y, const float* __restrict__ sy,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const void* __restrict__ res, const float* __restrict__ res_sy,
                             const float* __restrict__ res_gamma,
                             const float* __restrict__ res_beta, float res_scale,
                             int res_mode, int relu, float inv_out_scale,
                             const float* __restrict__ stats,  // [S, N, G, 2]
                             Out* __restrict__ out, int R, int C, int G,
                             int rows_per_chunk) {
  const int n = blockIdx.y, chunk = blockIdx.x, N = gridDim.y, T = blockDim.x;
  const int c = threadIdx.x % C, ro = threadIdx.x / C, rpi = T / C;
  const int g = c / (C / G);
  const float* st = stats + ((size_t)n * G + g) * 2;
  const float mu = st[0], rstd = st[1];
  const float s = sy[c], ga = gamma[c], be = beta[c];
  float rmu = 0.0f, rrstd = 0.0f, rs = 0.0f, rga = 0.0f, rbe = 0.0f;
  if (res_mode == 2) {
    const float* rst = stats + (((size_t)N + n) * G + g) * 2;
    rmu = rst[0];
    rrstd = rst[1];
    rs = res_sy[c];
    rga = res_gamma[c];
    rbe = res_beta[c];
  }
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(R, r0 + rows_per_chunk);
  const size_t base = (size_t)n * R * C + c;
  for (int row = r0 + ro; row < r1; row += rpi) {
    const size_t i = base + (size_t)row * C;
    const float v = __fmul_rn((float)y[i], s);
    float x = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rstd), ga), be);
    if (res_mode == 1) {
      x = __fadd_rn(x, __fmul_rn((float)((const int8_t*)res)[i], res_scale));
    } else if (res_mode == 2) {
      const float rv = __fmul_rn((float)((const int*)res)[i], rs);
      x = __fadd_rn(
          x, __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(rv, rmu), rrstd), rga), rbe));
    }
    if (relu) x = fmaxf(x, 0.0f);
    if constexpr (sizeof(Out) == 1) {
      const float q = fminf(fmaxf(rintf(__fmul_rn(x, inv_out_scale)), -127.0f), 127.0f);
      out[i] = (Out)(int)q;
    } else {
      out[i] = __float2bfloat16_rn(x);
    }
  }
}

}  // namespace

// y [N, R, C] int32; out [N, R, C] int8 (out_int8 != 0) or bf16.  `threads`
// is C * max(1, 256 / C); `rows_per_chunk` a multiple of threads / C.
// partial [S, N, chunks, G, 2] and stats [S, N, G, 2] are float scratch,
// S = 2 when res_mode == 2, else 1.
extern "C" int requant_epilogue_launch(
    const void* y, const void* sy, const void* gamma, const void* beta, const void* res,
    const void* res_sy, const void* res_gamma, const void* res_beta, float res_scale,
    int res_mode, int relu, int out_int8, float inv_out_scale, void* partial, void* stats,
    void* out, int N, int R, int C, int G, int threads, int rows_per_chunk, int chunks,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int sources = res_mode == 2 ? 2 : 1;
  const dim3 grid_s(chunks, N, sources), grid_a(chunks, N);
  stats_kernel<<<grid_s, threads, 2 * threads * sizeof(float), st>>>(
      (const int*)y, (const float*)sy, (const int*)res, (const float*)res_sy,
      (float*)partial, R, C, G, rows_per_chunk);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  finalize_kernel<<<dim3(N, sources), 32, 0, st>>>(
      (const float*)partial, (float*)stats, chunks, G, (float)R * (float)(C / G));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  if (out_int8) {
    apply_kernel<int8_t><<<grid_a, threads, 0, st>>>(
        (const int*)y, (const float*)sy, (const float*)gamma, (const float*)beta, res,
        (const float*)res_sy, (const float*)res_gamma, (const float*)res_beta, res_scale,
        res_mode, relu, inv_out_scale, (const float*)stats, (int8_t*)out, R, C, G,
        rows_per_chunk);
  } else {
    apply_kernel<__nv_bfloat16><<<grid_a, threads, 0, st>>>(
        (const int*)y, (const float*)sy, (const float*)gamma, (const float*)beta, res,
        (const float*)res_sy, (const float*)res_gamma, (const float*)res_beta, res_scale,
        res_mode, relu, inv_out_scale, (const float*)stats, (__nv_bfloat16*)out, R, C, G,
        rows_per_chunk);
  }
  return (int)cudaGetLastError();
}
