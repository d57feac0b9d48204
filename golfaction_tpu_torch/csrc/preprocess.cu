// Kernel A: fused crop / bilinear resize / normalize of uint8 NHWC frames.
//
// Replaces golfaction_tpu/ops/pallas/preprocess_kernel.py
// (crop_resize_normalize_pallas).  That kernel computes the separable warp
// Wy @ frame @ Wx^T as two dense matrix products.  Each row of the
// hat-kernel matrices has at most two non-zeros, so the same function is a
// 4-tap bilinear gather with zero border: this kernel does the gather in
// float32, in one launch with nothing before it.
//
// The kernel computes its own sample coordinates from the boxes:
//   step = s / (n - 1),  start = c - s / 2,  coord(i) = start + i * step
// with every operation rounded on its own (__fdiv_rn, __fmul_rn, __fadd_rn:
// no reciprocal, no contraction into an FMA), exactly as the plain versions
// compute them (ops/preprocess.py:_sample_coords, ops/affine.py:crop_transform,
// which divide by a tensor so that the card divides too).  That matters: at
// 1080p one ulp of a coordinate (1.2e-4 px) times a 255-level pixel step is
// already 5e-4 after normalization.
//
// Bound: bytes.  Each output pixel reads 4 x 3 source bytes and writes 12
// bytes of float32.  Two things kept earlier versions of this kernel from
// the bound, and the design answers both:
//   * instructions.  A version that computed the whole coordinate arithmetic
//     and three IEEE divisions per output float spent longer executing
//     instructions than moving bytes.  Here a thread owns one output column in four
//     neighbouring rows: the column's x terms are computed once per thread,
//     a row's y terms once per pixel, and a pixel is then four tap offsets
//     (clamped into the frame), four weights (zero for a tap outside the
//     frame, so no load is ever out of bounds) and, per channel, 4 one-byte
//     loads through the read-only path, 4 multiply-adds and one more for the
//     normalization, folded on the host into v * 1/(255 std) - mean/std.  A
//     byte becomes a float by an OR into 2^23's mantissa and a subtraction:
//     integer-to-float conversions run at an eighth of the rate;
//   * lines per load.  The lanes of a warp take 32 neighbouring columns, so
//     one load instruction touches about 32 x 3.8 x 3 = 365 source bytes at
//     the main path's downscale: 3 or 4 cache lines.  With four neighbouring
//     pixels to a thread it was 12 lines, and L1 takes one line a cycle.
// The 4 x 384 bytes a warp produces go through shared memory, so that each
// row's 384 contiguous bytes leave as 16-byte stores of neighbouring lanes.
// Source rows are not staged in shared memory: at the main path's 3.8x
// downscale a source byte is used at most once per output row.  An output
// width that is not a multiple of 4 (8 for the bfloat16 variant below) takes
// scalar stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;   // output rows per thread: a warp's tile is 32 columns x 4 rows

struct Norm {
  float scale[3], shift[3];   // out = v * scale + shift
};

// Source coordinate of output index i along an axis of n samples over a box
// of center c and size s.
__device__ __forceinline__ float sample_coord(float c, float s, int n, int i) {
  const float step = __fdiv_rn(s, (float)(n - 1));
  const float start = __fsub_rn(c, __fmul_rn(s, 0.5f));
  return __fadd_rn(start, __fmul_rn((float)i, step));
}

// One axis of a bilinear tap pair: the two source indices clamped into
// [0, size) for addressing, whether each lies in the frame, and the fraction.
struct Axis {
  int i0, i1;
  bool ok0, ok1;
  float frac;
};

__device__ __forceinline__ Axis make_axis(float s, int size) {
  const float f = floorf(s);
  // Clamp before the int conversion: a far-off box must not overflow it.
  const int i = (int)fmaxf(fminf(f, (float)size), -2.0f);
  Axis a;
  a.frac = s - f;
  a.ok0 = i >= 0 && i < size;
  a.ok1 = i + 1 >= 0 && i + 1 < size;
  a.i0 = a.ok0 ? i : 0;
  a.i1 = a.ok1 ? i + 1 : 0;
  return a;
}

__device__ __forceinline__ float byte_to_float(uint8_t b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.0f;   // 2^23 + b, exactly
}

// The three floats of one output pixel.
__device__ __forceinline__ void sample_pixel(const uint8_t* __restrict__ f, int W, const Axis& y,
                                             const Axis& x, const Norm& nm, float* out3) {
  const int off[4] = {(y.i0 * W + x.i0) * 3, (y.i0 * W + x.i1) * 3, (y.i1 * W + x.i0) * 3,
                      (y.i1 * W + x.i1) * 3};
  const float fx = x.frac, fy = y.frac;
  const float w[4] = {y.ok0 && x.ok0 ? (1.0f - fx) * (1.0f - fy) : 0.0f,
                      y.ok0 && x.ok1 ? fx * (1.0f - fy) : 0.0f,
                      y.ok1 && x.ok0 ? (1.0f - fx) * fy : 0.0f,
                      y.ok1 && x.ok1 ? fx * fy : 0.0f};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float v = byte_to_float(__ldg(f + off[0] + ch)) * w[0];
    v += byte_to_float(__ldg(f + off[1] + ch)) * w[1];
    v += byte_to_float(__ldg(f + off[2] + ch)) * w[2];
    v += byte_to_float(__ldg(f + off[3] + ch)) * w[3];
    out3[ch] = v * nm.scale[ch] + nm.shift[ch];
  }
}

// The bfloat16 variant (crop_resize_normalize_bf16_kernel): the crops of
// golfaction_tpu/ops/preprocess.py:crop_resize_normalize at dtype=bfloat16,
// whose separable warp rounds where the Pallas kernel's bfloat16 inner
// arithmetic (ops/pallas/preprocess_kernel.py:49-63) rounds: hat weights
// and the W-contracted row values in bfloat16, sums in float32.  Each of
// its sums has at most two non-zero terms and every product of two
// bfloat16 values, or of one and a byte, is exact in float32, so the gather
// below gives the same bits: each tap's weight max(0, 1 - |c - s|) (not
// frac and 1 - frac, which part for c in (0, 0.5)) rounded to bfloat16,
// per y-tap the row value
// wx0*f[y,x0] + wx1*f[y,x1] rounded to bfloat16, the column sum in float32,
// then /255, -mean, /std one IEEE operation each (no folded multiply-add)
// and a round to bfloat16, as ops/preprocess.py:
// crop_resize_normalize_bf16_reference computes them.  6 bytes a pixel
// leave instead of 12; the extra rounding and the two divisions a value make
// it more instructions per byte than the float32 kernel.

// One axis of the bfloat16 variant's tap pair: make_axis's clamped indices
// and each tap's hat weight rounded to bfloat16, zero outside the axis.
struct HatAxis {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float hat_bf16(float c, float s) {
  return round_bf16(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, s)))));
}

__device__ __forceinline__ HatAxis make_hat_axis(float c, int size) {
  const Axis a = make_axis(c, size);
  const float lo = floorf(c);
  HatAxis h;
  h.i0 = a.i0;
  h.i1 = a.i1;
  h.w0 = a.ok0 ? hat_bf16(c, lo) : 0.0f;
  h.w1 = a.ok1 ? hat_bf16(c, __fadd_rn(lo, 1.0f)) : 0.0f;
  return h;
}

struct NormBf16 {
  float mean[3], stdv[3];
};

// The three bfloat16 values of one output pixel.
__device__ __forceinline__ void sample_pixel_bf16(const uint8_t* __restrict__ f, int W,
                                                  const HatAxis& y, const HatAxis& x,
                                                  const NormBf16& nm, __nv_bfloat16* out3) {
  const int off[4] = {(y.i0 * W + x.i0) * 3, (y.i0 * W + x.i1) * 3, (y.i1 * W + x.i0) * 3,
                      (y.i1 * W + x.i1) * 3};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float t0 = round_bf16(__fadd_rn(__fmul_rn(x.w0, byte_to_float(__ldg(f + off[0] + ch))),
                                          __fmul_rn(x.w1, byte_to_float(__ldg(f + off[1] + ch)))));
    const float t1 = round_bf16(__fadd_rn(__fmul_rn(x.w0, byte_to_float(__ldg(f + off[2] + ch))),
                                          __fmul_rn(x.w1, byte_to_float(__ldg(f + off[3] + ch)))));
    const float v = __fadd_rn(__fmul_rn(y.w0, t0), __fmul_rn(y.w1, t1));
    out3[ch] = __float2bfloat16_rn(
        __fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), nm.mean[ch]), nm.stdv[ch]));
  }
}

struct Float32Crop {
  using T = float;
  Norm nm;
  __device__ __forceinline__ static Axis axis(float c, int size) { return make_axis(c, size); }
  __device__ __forceinline__ void pixel(const uint8_t* __restrict__ f, int W, const Axis& y,
                                        const Axis& x, T* out3) const {
    sample_pixel(f, W, y, x, nm, out3);
  }
};

struct Bf16Crop {
  using T = __nv_bfloat16;
  NormBf16 nm;
  __device__ __forceinline__ static HatAxis axis(float c, int size) {
    return make_hat_axis(c, size);
  }
  __device__ __forceinline__ void pixel(const uint8_t* __restrict__ f, int W, const HatAxis& y,
                                        const HatAxis& x, T* out3) const {
    sample_pixel_bf16(f, W, y, x, nm, out3);
  }
};

// One warp's tile of 32 columns x kRows rows of image b, staged in
// stage[kRows][96] and stored row by row as 16-byte stores of neighbouring
// lanes where rows and tiles start on 16-byte boundaries.
template <class Crop>
__device__ __forceinline__ void crop_tile(const uint8_t* __restrict__ frames,
                                          const float* __restrict__ boxes,
                                          typename Crop::T* __restrict__ out, int H, int W,
                                          int oh, int ow, const Crop& crop,
                                          typename Crop::T (*stage)[96]) {
  using T = typename Crop::T;
  constexpr int kVec = 16 / sizeof(T);             // values of one 16-byte store
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int ncg = (ow + 31) / 32;                  // column groups of a row
  const int tile = blockIdx.x * kWarps + warp;     // the warp's tile in the image
  if (tile >= ncg * ((oh + kRows - 1) / kRows)) return;   // the whole warp leaves
  const int rg = tile / ncg, cg = tile - rg * ncg;
  const int ox = cg * 32 + lane, oy0 = rg * kRows;
  const float cx = __ldg(boxes + 4 * b), cy = __ldg(boxes + 4 * b + 1);
  const float bw = __ldg(boxes + 4 * b + 2), bh = __ldg(boxes + 4 * b + 3);
  const uint8_t* f = frames + (size_t)b * H * W * 3;

  if (ox < ow) {
    const auto x = Crop::axis(sample_coord(cx, bw, ow, ox), W);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (oy0 + k < oh)
        crop.pixel(f, W, Crop::axis(sample_coord(cy, bh, oh, oy0 + k), H), x,
                   &stage[k][3 * lane]);
    }
  }
  __syncwarp();
  const int nv = 3 * min(32, ow - cg * 32);        // values of the tile's rows
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (oy0 + k >= oh) break;
    T* o = out + (((size_t)b * oh + oy0 + k) * ow + cg * 32) * 3;
    if ((3 * ow) % kVec == 0) {   // rows and tiles start on 16-byte boundaries
      if (kVec * lane < nv)
        reinterpret_cast<uint4*>(o)[lane] = reinterpret_cast<const uint4*>(stage[k])[lane];
    } else {
      for (int i = lane; i < nv; i += 32) o[i] = stage[k][i];
    }
  }
}

__global__ void __launch_bounds__(kThreads) crop_resize_normalize_kernel(
    const uint8_t* __restrict__ frames,  // [B, H, W, 3]
    const float* __restrict__ boxes,     // [B, 4] cx, cy, w, h
    float* __restrict__ out,             // [B, oh, ow, 3]
    int H, int W, int oh, int ow, Float32Crop crop) {
  __shared__ __align__(16) float stage[kWarps][kRows][96];
  crop_tile(frames, boxes, out, H, W, oh, ow, crop, stage[threadIdx.x / 32]);
}

__global__ void __launch_bounds__(kThreads) crop_resize_normalize_bf16_kernel(
    const uint8_t* __restrict__ frames,  // [B, H, W, 3]
    const float* __restrict__ boxes,     // [B, 4] cx, cy, w, h
    __nv_bfloat16* __restrict__ out,     // [B, oh, ow, 3]
    int H, int W, int oh, int ow, Bf16Crop crop) {
  __shared__ __align__(16) __nv_bfloat16 stage[kWarps][kRows][96];
  crop_tile(frames, boxes, out, H, W, oh, ow, crop, stage[threadIdx.x / 32]);
}

}  // namespace

// One warp a tile of 32 columns x kRows rows, kWarps tiles a block, one grid
// row an image.
static dim3 grid_of(int B, int oh, int ow) {
  const int tiles = ((ow + 31) / 32) * ((oh + kRows - 1) / kRows);
  return dim3((tiles + kWarps - 1) / kWarps, B);
}

extern "C" int crop_resize_normalize_blocks_per_sm(int bf16) {
  int n = 0;
  cudaError_t err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               &n, crop_resize_normalize_bf16_kernel, kThreads, 0)
                         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               &n, crop_resize_normalize_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int crop_resize_normalize_launch(
    const void* frames, const void* boxes, void* out,
    int B, int H, int W, int oh, int ow,
    float m0, float m1, float m2, float s0, float s1, float s2,
    void* stream) {
  const double mean[3] = {m0, m1, m2}, stdv[3] = {s0, s1, s2};
  Float32Crop crop;
  for (int c = 0; c < 3; ++c) {   // (v / 255 - mean) / std as one multiply-add
    crop.nm.scale[c] = (float)(1.0 / (255.0 * stdv[c]));
    crop.nm.shift[c] = (float)(-mean[c] / stdv[c]);
  }
  crop_resize_normalize_kernel<<<grid_of(B, oh, ow), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (float*)out, H, W, oh, ow, crop);
  return (int)cudaGetLastError();
}

extern "C" int crop_resize_normalize_bf16_launch(
    const void* frames, const void* boxes, void* out,
    int B, int H, int W, int oh, int ow,
    float m0, float m1, float m2, float s0, float s1, float s2,
    void* stream) {
  Bf16Crop crop{{{m0, m1, m2}, {s0, s1, s2}}};
  crop_resize_normalize_bf16_kernel<<<grid_of(B, oh, ow), kThreads, 0,
                                      (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (__nv_bfloat16*)out, H, W, oh, ow, crop);
  return (int)cudaGetLastError();
}
