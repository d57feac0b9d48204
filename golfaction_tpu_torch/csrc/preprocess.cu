// Kernel A: fused crop / bilinear resize / normalize of uint8 NHWC frames.
//
// Replaces golfaction_tpu/ops/pallas/preprocess_kernel.py
// (crop_resize_normalize_pallas).  That kernel computes the separable warp
// Wy @ frame @ Wx^T as two dense matrix products.  Each row of the
// hat-kernel matrices has at most two non-zeros, so the same function is a
// 4-tap bilinear gather with zero border: this kernel does the gather, one
// thread per output pixel, all three channels, in float32.
//
// The sample coordinates (one row per box along x and along y) come in from
// the wrapper, computed by the same torch expression as the plain versions,
// so kernel and plain versions sample the same points: at 1080p one ulp of a
// coordinate (1.2e-4 px) times a 255-level pixel step is already 5e-4 after
// normalization.
//
// Bound: bytes.  Each output pixel reads 4 x 3 source bytes and writes 12
// bytes of float32; the arithmetic is a few dozen FLOPs per pixel.  Threads
// of a warp cover neighbouring output pixels, so their source taps fall on
// neighbouring (or the same) source pixels and the reads coalesce through L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tap(const uint8_t* __restrict__ f, int x, int y,
                                     int H, int W, int c) {
  if (x < 0 || x >= W || y < 0 || y >= H) return 0.0f;
  return (float)f[((size_t)y * W + x) * 3 + c];
}

__global__ void crop_resize_normalize_kernel(
    const uint8_t* __restrict__ frames,  // [B, H, W, 3]
    const float* __restrict__ xs,        // [B, ow] source x of each output column
    const float* __restrict__ ys,        // [B, oh] source y of each output row
    float* __restrict__ out,             // [B, oh, ow, 3]
    int H, int W, int oh, int ow,
    float m0, float m1, float m2, float s0, float s1, float s2) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= oh * ow) return;
  const int oy = p / ow;
  const int ox = p - oy * ow;

  const float sx = xs[(size_t)b * ow + ox];
  const float sy = ys[(size_t)b * oh + oy];
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float fx = sx - x0f;
  const float fy = sy - y0f;
  // Clamp before the int conversion: a far-off box must not overflow it.
  const int x0 = (int)fmaxf(fminf(x0f, (float)W), -2.0f);
  const int y0 = (int)fmaxf(fminf(y0f, (float)H), -2.0f);
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy;
  const float w11 = fx * fy;

  const uint8_t* f = frames + (size_t)b * H * W * 3;
  float* o = out + ((size_t)b * oh * ow + p) * 3;
  const float mean[3] = {m0, m1, m2};
  const float stdv[3] = {s0, s1, s2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = tap(f, x0, y0, H, W, c) * w00;
    v += tap(f, x0 + 1, y0, H, W, c) * w10;
    v += tap(f, x0, y0 + 1, H, W, c) * w01;
    v += tap(f, x0 + 1, y0 + 1, H, W, c) * w11;
    o[c] = (v / 255.0f - mean[c]) / stdv[c];
  }
}

}  // namespace

extern "C" int crop_resize_normalize_launch(
    const void* frames, const void* xs, const void* ys, void* out,
    int B, int H, int W, int oh, int ow,
    float m0, float m1, float m2, float s0, float s1, float s2,
    void* stream) {
  const int threads = 256;
  dim3 grid((oh * ow + threads - 1) / threads, B);
  crop_resize_normalize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)xs, (const float*)ys, (float*)out,
      H, W, oh, ow, m0, m1, m2, s0, s1, s2);
  return (int)cudaGetLastError();
}
