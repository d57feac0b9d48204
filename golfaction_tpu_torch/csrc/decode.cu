// Kernel D: single-peak heatmap decode with the DARK/UDP sub-pixel step.
//
// Replaces golfaction_tpu/ops/pallas/decode_kernel.py (decode_heatmaps_pallas,
// body _decode_block).  The TPU kernel takes blocks of rows through lane-wide
// reductions and reads the 3x3 neighbourhood with nine one-hot masked sums,
// because it cannot gather; here one block owns one heatmap: a strided max
// with the index carried, a warp-shuffle then shared-memory reduction, and
// one thread that reads the nine clamped neighbours directly and writes
// (x, y, score).  No padded output, no second pass over the row.
//
// Bound: bytes.  Each heatmap is read once (H*W floats) and three floats are
// written; the arithmetic is one compare per element.  The design reads the
// row coalesced, once; the neighbour reads hit L1/L2.
//
// Parity with the plain version: ties go to the lower flat index (the first
// maximum, as torch.argmax and jnp.argmax give); the Taylor step is written
// with the round-to-nearest intrinsics so that nvcc cannot contract a
// product and a sum into one fused operation, which would move `det` across
// the 1e-12 threshold of the `safe` test; logf and IEEE division, no
// fast-math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-10f;

__device__ __forceinline__ bool better(float v, int i, float best, int bi) {
  return v > best || (v == best && i < bi);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__global__ void decode_kernel(const float* __restrict__ hm,  // [M, H*W]
                              float* __restrict__ out,       // [M, 3]
                              int H, int W) {
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int HW = H * W;
  const float* h = hm + (size_t)blockIdx.x * HW;

  // Each thread walks its elements in ascending order, so a strict > keeps
  // the first maximum it sees.
  int bi = threadIdx.x < HW ? threadIdx.x : 0;
  float best = h[bi];
  for (int p = threadIdx.x + blockDim.x; p < HW; p += blockDim.x) {
    const float v = h[p];
    if (v > best) {
      best = v;
      bi = p;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, best, bi)) {
      best = ov;
      bi = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) {
    if (better(s_val[w], s_idx[w], best, bi)) {
      best = s_val[w];
      bi = s_idx[w];
    }
  }

  const int x = bi % W, y = bi / W;
  auto lg = [&](int dx, int dy) {
    const int xx = min(max(x + dx, 0), W - 1);
    const int yy = min(max(y + dy, 0), H - 1);
    return logf(fmaxf(h[yy * W + xx], kEps));
  };
  const float c = lg(0, 0);
  const float xp = lg(1, 0), xm = lg(-1, 0), yp = lg(0, 1), ym = lg(0, -1);
  const float xpyp = lg(1, 1), xpym = lg(1, -1), xmyp = lg(-1, 1), xmym = lg(-1, -1);
  const float gx = __fmul_rn(0.5f, __fsub_rn(xp, xm));
  const float gy = __fmul_rn(0.5f, __fsub_rn(yp, ym));
  const float dxx = __fadd_rn(__fsub_rn(xp, __fmul_rn(2.0f, c)), xm);
  const float dyy = __fadd_rn(__fsub_rn(yp, __fmul_rn(2.0f, c)), ym);
  const float dxy = __fmul_rn(
      0.25f, __fadd_rn(__fsub_rn(__fsub_rn(xpyp, xpym), xmyp), xmym));
  float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
  const bool safe = fabsf(det) > 1e-12f && dxx < 0.0f && dyy < 0.0f;
  float off_x = 0.0f, off_y = 0.0f;
  if (safe) {
    const float nx = -__fsub_rn(__fmul_rn(dyy, gx), __fmul_rn(dxy, gy));
    const float ny = -__fsub_rn(__fmul_rn(dxx, gy), __fmul_rn(dxy, gx));
    off_x = clampf(__fdiv_rn(nx, det), -0.5f, 0.5f);
    off_y = clampf(__fdiv_rn(ny, det), -0.5f, 0.5f);
  }
  float* o = out + (size_t)blockIdx.x * 3;
  o[0] = __fadd_rn((float)x, off_x);
  o[1] = __fadd_rn((float)y, off_y);
  o[2] = best;
}

}  // namespace

extern "C" int decode_heatmaps_launch(const void* hm, void* out, int M, int H,
                                      int W, void* stream) {
  decode_kernel<<<M, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)hm, (float*)out, H, W);
  return (int)cudaGetLastError();
}
