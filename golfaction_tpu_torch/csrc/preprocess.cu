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
// downscale a source byte is used at most once per output row, and the
// read-only path's cache serves the lines neighbouring lanes share (the
// bfloat16 variant below, which reads whole two-pixel windows with 8-byte
// loads, measured a staged build: no faster).  An output width that is not
// a multiple of 4 (8 for the bfloat16 variant) takes scalar stores.

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

struct Float32Crop {
  using T = float;
  Norm nm;
  __device__ __forceinline__ static Axis axis(float c, int size) { return make_axis(c, size); }
  __device__ __forceinline__ void pixel(const uint8_t* __restrict__ f, int W, const Axis& y,
                                        const Axis& x, T* out3) const {
    sample_pixel(f, W, y, x, nm, out3);
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

// ---------------------------------------------------------------------------
// The bfloat16 variant (crop_resize_normalize_bf16_kernel): the crops of
// golfaction_tpu/ops/preprocess.py:crop_resize_normalize at dtype=bfloat16,
// whose separable warp rounds where the Pallas kernel's bfloat16 inner
// arithmetic (ops/pallas/preprocess_kernel.py:49-63) rounds.  Each of its
// sums has at most two non-zero terms, and every product of two bfloat16
// values, or of one and a byte, is exact in float32, so this gather gives
// the same bits as ops/preprocess.py:crop_resize_normalize_bf16_reference:
//   1. each tap's hat weight max(0, 1 - |c - s|) rounded to bfloat16 (not
//      frac and 1 - frac, which part for c in (0, 0.5));
//   2. per y-tap the row value wx0*f[y,x0] + wx1*f[y,x1] in float32,
//      rounded to bfloat16;
//   3. the column sum wy0*t0 + wy1*t1 in float32;
//   4. /255, -mean, /std, each one IEEE float32 operation;
//   5. a round to bfloat16.
// 6 bytes a pixel leave instead of the float32 kernel's 12, so the variant
// is bound by the source bytes its taps touch.  Its first design shared
// crop_tile and ran at 0.40 of that bound: per value two __fdiv_rn (a
// reciprocal, a Newton step, a correction and a range check), three
// roundings and six unfused operations, per pixel the row's hat weights
// with three conversions and twelve one-byte loads, in 40 registers (6
// blocks an SM against the float32 kernel's 8).  This design cuts each of
// those and keeps every bit:
//   * divisions.  x / d is q = x*r, e = fma(q, d, -x), q - e*r in one FMA,
//     with r = RN(1/d) passed by the host (ops/preprocess.py:
//     division_reciprocals): Markstein's correction step, which gives the
//     correctly rounded quotient when no operand, remainder or result
//     leaves the normal range; -e instead of the usual e keeps the sign of
//     a zero quotient.  /std keeps __fdiv_rn for dividends under 2^-100,
//     which no crop reaches; the host refuses divisors for which the rest
//     could fail; chip_smoke.py enumerates every float32 of the two
//     divisions' domains at the ImageNet constants against __fdiv_rn
//     (division_check below);
//   * roundings.  The two row values of a channel are rounded by one
//     cvt.rn.bf16x2.f32 and widened back by a shift and a mask;
//   * pixels.  A tap's byte b becomes the float 2^23 + b by one byte
//     permute; the second tap's product is fma(w, 2^23 + b, -w * 2^23),
//     exact, and the row value one more FMA, so no multiply stands alone;
//   * loads.  The two x-taps of a row are neighbouring pixels, 6 bytes:
//     the column's window [s, s + 1] always lies in the frame (at an edge
//     the tap inside moves to the window slot it falls in, with its
//     weight), and two aligned 8-byte loads and two funnel shifts read it:
//     4 load instructions a pixel, not 12;
//   * rows.  The first kRows lanes of a warp compute the hat axis of the
//     tile's kRows rows (all 32 lanes read the same rows) into shared
//     memory, and each pixel reads its row's two byte offsets and weights
//     back with one 16-byte broadcast load.
// 32 registers a thread (__launch_bounds__(256, 8)), the occupancy of the
// float32 kernel.  The 4 x 192 bytes a warp produces go through shared
// memory and leave as 16-byte stores, as in crop_tile.
// What bounds it now (tools/kernel_a_breakdown.py at the main path's
// shape; PERF.md): a build without its arithmetic takes as long, and a
// build that reads one tap row instead of two a fifth less.  The card
// serves the sectors of the gather's source rows at about 0.85 of the
// rate of a plain copy of the frames; staging the rows through shared
// memory (cp.async, an output row ahead) did not change that.

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float hat_bf16(float c, float s) {
  return round_bf16(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(c, s)))));
}

// The x axis of a column: the byte offset in a row of the two-pixel window
// [s, s + 1] that holds its taps inside [0, size), each window pixel's
// bfloat16 hat weight (zero for a pixel that is no tap) and -wb * 2^23.
// The window never leaves the frame where size >= 2; where size == 1 its
// second pixel is read from the bytes after the first and weighted zero.
struct Window {
  unsigned off;
  float wa, wb, cb;
};

__device__ __forceinline__ Window make_window(float c, int size) {
  const float lo = floorf(c);
  // Clamp before the int conversion: a far-off box must not overflow it.
  const int i = (int)fmaxf(fminf(lo, (float)size), -2.0f);
  const float w0 = i >= 0 && i < size ? hat_bf16(c, lo) : 0.0f;
  const float w1 = i + 1 >= 0 && i + 1 < size ? hat_bf16(c, __fadd_rn(lo, 1.0f)) : 0.0f;
  const int s = min(max(i, 0), max(size - 2, 0));
  Window x;
  x.off = 3u * (unsigned)s;
  x.wa = s == i ? w0 : (s == i + 1 ? w1 : 0.0f);
  x.wb = s + 1 == i ? w0 : (s == i ? w1 : 0.0f);
  x.cb = -x.wb * 8388608.0f;   // exact: a power-of-two scale
  return x;
}

// The y axis of a row: the byte offsets of its two tap rows (clamped into
// the frame) and their bfloat16 hat weights (zero outside it); 16 bytes, one
// shared-memory load.
struct __align__(16) RowTaps {
  unsigned off0, off1;
  float w0, w1;
};

__device__ __forceinline__ RowTaps make_row_taps(float c, int size, unsigned row_bytes) {
  const Axis a = make_axis(c, size);
  const float lo = floorf(c);
  RowTaps r;
  r.off0 = (unsigned)a.i0 * row_bytes;
  r.off1 = (unsigned)a.i1 * row_bytes;
  r.w0 = a.ok0 ? hat_bf16(c, lo) : 0.0f;
  r.w1 = a.ok1 ? hat_bf16(c, __fadd_rn(lo, 1.0f)) : 0.0f;
  return r;
}

struct NormBf16 {
  float mean[3], stdv[3], rstd[3], r255;   // rstd, r255: RN(1 / stdv), RN(1 / 255)
};

// x / d for d > 0 and r = RN(1 / d), rounded as IEEE division rounds it
// where x, x / d and the remainder stay in the normal range or x is zero:
// for /255 every x in [0, 255] (255 is an integer, so the remainder is a
// multiple of the smallest subnormal and exact).
__device__ __forceinline__ float divide(float x, float d, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(-__fmaf_rn(q, d, -x), r, q);
}

// divide for a divisor with bits below its unit in the last place, as std's
// are: below |x| = 2^-100 the remainder q*d - x is subnormal and could lose
// bits, so IEEE division takes those x.  No u = x / 255 - mean of the crops
// comes near: it is zero or at least 2^-79 in size.
__device__ __forceinline__ float divide_guarded(float x, float d, float r) {
  return fabsf(x) < 0x1p-100f ? __fdiv_rn(x, d) : divide(x, d, r);
}

// The six bytes of a window at byte j of the frame (counted from `base`, the
// 8-byte boundary at or below its first byte): the first pixel in bytes 0-2
// of lo, the second in byte 3 of lo and bytes 0-1 of hi.  Two 8-byte loads:
// the word that holds byte j and the next one, or `last`, the last word that
// holds a byte of the frame, where the next holds none.
__device__ __forceinline__ void load_window(const uint8_t* __restrict__ base, unsigned j,
                                            unsigned last, unsigned& lo, unsigned& hi) {
  const unsigned w = j & ~7u;
  const uint2 a = __ldg(reinterpret_cast<const uint2*>(base + w));
  const uint2 b = __ldg(reinterpret_cast<const uint2*>(base + min(w + 8, last)));
  const bool up = j & 4;   // the window starts in a's second half
  const unsigned w0 = up ? a.y : a.x, w1 = up ? b.x : a.y, w2 = up ? b.y : b.x;
  lo = __funnelshift_r(w0, w1, j << 3);   // the shift is taken mod 32: 8 * (j % 4)
  hi = __funnelshift_r(w1, w2, j << 3);
}

// 2^23 + byte k of w, as a float.
__device__ __forceinline__ float big(unsigned w, unsigned k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + k));
}

// wa * a + wb * b in float32, one rounding, from a = 2^23 + byte and b the same.
__device__ __forceinline__ float row_value(float a, float b, const Window& x) {
  return __fmaf_rn(x.wa, __fadd_rn(a, -8388608.0f), __fmaf_rn(x.wb, b, x.cb));
}

// RN_bf16(lo) in the low half, RN_bf16(hi) in the high half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The three bfloat16 values of one output pixel.
__device__ __forceinline__ void pixel_bf16(const uint8_t* __restrict__ base, unsigned last,
                                           const Window& x, const RowTaps& y,
                                           const NormBf16& nm, __nv_bfloat16* out3) {
  unsigned lo0, hi0, lo1, hi1;
  load_window(base, y.off0 + x.off, last, lo0, hi0);
  load_window(base, y.off1 + x.off, last, lo1, hi1);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float t0 = row_value(big(lo0, ch), ch == 0 ? big(lo0, 3) : big(hi0, ch - 1), x);
    const float t1 = row_value(big(lo1, ch), ch == 0 ? big(lo1, 3) : big(hi1, ch - 1), x);
    const unsigned t = pack_bf16x2(t0, t1);
    const float v = __fmaf_rn(y.w0, __uint_as_float(t << 16),
                              __fmul_rn(y.w1, __uint_as_float(t & 0xFFFF0000u)));
    out3[ch] = __float2bfloat16_rn(
        divide_guarded(__fsub_rn(divide(v, 255.0f, nm.r255), nm.mean[ch]), nm.stdv[ch],
                       nm.rstd[ch]));
  }
}

// One warp a tile of 32 columns x kRows rows of image blockIdx.y, as in
// crop_tile.
__global__ void __launch_bounds__(kThreads, 8) crop_resize_normalize_bf16_kernel(
    const uint8_t* __restrict__ frames,  // [B, H, W, 3]
    const float* __restrict__ boxes,     // [B, 4] cx, cy, w, h
    __nv_bfloat16* __restrict__ out,     // [B, oh, ow, 3]
    int H, int W, int oh, int ow, NormBf16 nm) {
  __shared__ __align__(16) __nv_bfloat16 stage[kWarps][kRows][96];
  __shared__ RowTaps rows[kWarps][kRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int ncg = (ow + 31) / 32;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= ncg * ((oh + kRows - 1) / kRows)) return;
  const int rg = tile / ncg, cg = tile - rg * ncg;
  const int ox = cg * 32 + lane, oy0 = rg * kRows;
  const float cx = __ldg(boxes + 4 * b), cy = __ldg(boxes + 4 * b + 1);
  const float bw = __ldg(boxes + 4 * b + 2), bh = __ldg(boxes + 4 * b + 3);
  const unsigned frame_bytes = 3u * (unsigned)H * (unsigned)W;
  const uint8_t* f = frames + (size_t)b * frame_bytes;
  const unsigned lead = (unsigned)(reinterpret_cast<uintptr_t>(f) & 7);
  const uint8_t* base = f - lead;
  const unsigned last = (lead + frame_bytes - 1) & ~7u;

  if (lane < kRows && oy0 + lane < oh)
    rows[warp][lane] = make_row_taps(sample_coord(cy, bh, oh, oy0 + lane), H, 3u * W);
  __syncwarp();
  if (ox < ow) {
    Window x = make_window(sample_coord(cx, bw, ow, ox), W);
    x.off += lead;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (oy0 + k < oh) pixel_bf16(base, last, x, rows[warp][k], nm, &stage[warp][k][3 * lane]);
    }
  }
  __syncwarp();
  const int nv = 3 * min(32, ow - cg * 32);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (oy0 + k >= oh) break;
    __nv_bfloat16* o = out + (((size_t)b * oh + oy0 + k) * ow + cg * 32) * 3;
    if ((3 * ow) % 8 == 0) {   // rows and tiles start on 16-byte boundaries
      if (8 * lane < nv)
        reinterpret_cast<uint4*>(o)[lane] = reinterpret_cast<const uint4*>(stage[warp][k])[lane];
    } else {
      for (int i = lane; i < nv; i += 32) o[i] = stage[warp][k][i];
    }
  }
}

// Counts x in [first + i * stride for i < count] (float bit patterns) where
// divide (divide_guarded if `guarded`) has other bits than __fdiv_rn(x, d).
__global__ void division_check_kernel(unsigned first, unsigned count, unsigned stride, float d,
                                      float r, int guarded, unsigned long long* mismatches) {
  unsigned long long bad = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < count; i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float(first + (unsigned)(i * stride));
    const float q = guarded ? divide_guarded(x, d, r) : divide(x, d, r);
    if (__float_as_uint(q) != __float_as_uint(__fdiv_rn(x, d))) ++bad;
  }
  if (bad) atomicAdd(mismatches, bad);
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
    float r0, float r1, float r2, float r255, void* stream) {
  if (H < 1 || W < 1 || 3LL * H * W > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const NormBf16 nm{{m0, m1, m2}, {s0, s1, s2}, {r0, r1, r2}, r255};
  crop_resize_normalize_bf16_kernel<<<grid_of(B, oh, ow), kThreads, 0,
                                      (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (__nv_bfloat16*)out, H, W, oh, ow, nm);
  return (int)cudaGetLastError();
}

// The variant's division (guarded: as it divides by std) against IEEE
// division over `count` float bit patterns first, first + stride, ..., at
// divisor d with r = RN(1 / d); the mismatches are added to *mismatches
// (device memory).
extern "C" int preprocess_division_check(unsigned first, unsigned count, unsigned stride,
                                         float d, float r, int guarded, void* mismatches,
                                         void* stream) {
  division_check_kernel<<<1024, 256, 0, (cudaStream_t)stream>>>(
      first, count, stride, d, r, guarded, (unsigned long long*)mismatches);
  return (int)cudaGetLastError();
}
