// Kernel F: fused int8 epilogue between two integer convolutions.
//
//   y_i32 --dequant--> GroupNorm --> [+ residual] --> [relu] --> int8 | bf16
//
// Replaces golfaction_tpu/ops/pallas/requant_kernel.py (requant_epilogue_pallas,
// body _epilogue_kernel).  The TPU kernel holds one sample's whole [R, C] slab
// in its scratch memory and takes the GroupNorm sums with ones-vector and
// one-hot matrix products, to feed its matrix unit.  Here one launch walks
// the rows [N, R, C] (channels innermost, as an im2col product leaves them)
// with one thread-block cluster per sample:
//
//   1. each block of the cluster owns a contiguous run of `rpb` rows of its
//      sample.  Where the run fits in shared memory (`staged`), one thread
//      puts all of it in flight at once as bulk copies (the Tensor Memory
//      Accelerator's 1-D form, kChunks of them, each with an mbarrier);
//      elsewhere the threads read it 16 bytes at a time;
//   2. it sums y * s and its square per channel (each thread over its rows in
//      row order), writing y * s over the staged int32, folds the threads'
//      sums with a fixed tree in shared memory and the channels of a group
//      in channel order;
//   3. it publishes those [G, 2] partial sums and waits on the cluster
//      barrier;
//   4. every block reads all ranks' partial sums through distributed shared
//      memory, in rank order, and computes mean and 1/sqrt(var + eps) itself:
//      every block gets the same bits and none waits on another for them; it
//      arrives on a second cluster barrier, and waits on it only before it
//      exits, which keeps its partial sums alive while its peers read them;
//   5. it normalizes its rows (from shared memory, or read again from device
//      memory where they were not staged), adds the residual, relus and
//      writes int8 (16 a thread) or bf16 (8 a thread), one loop per residual
//      mode and staging.
//
// "sources" is 2 when the residual is itself an int32 convolution output
// with its own GroupNorm (the projection shortcut): its statistics are taken
// in the same pass and its rows staged beside y's.  The wrapper
// (ops/requant.py, launch_geometry) cuts the call: one wave of blocks
// (cluster 2 at batch 64), each staging its run where it fits; several waves
// of staged blocks only where a re-read would come from device memory
// rather than L2 (the stem, cluster 16; the last deconvolution, cluster 8).
// C % 4 != 0, or a tensor off a 16-byte boundary, takes 4-byte accesses; C
// is at most 1024.
//
// Bound: bytes.  Each element is read as 4 bytes (plus 1 or 4 of residual)
// and written as 1 or 2, against about twenty float operations; staged, no
// byte is read twice.  What keeps it from the bound is the instruction rate of
// the apply pass (a conversion and a dozen operations an element) and, with
// one block an SM, passes that do not overlap (PERF.md, kernel F).
//
// Parity with the plain version: sums are taken in another order, so mean
// and rstd differ in the last bits; every operation of the statistics and
// of the normalization is written with the round-to-nearest intrinsics so
// that nvcc contracts no product and sum into one fused operation, and the
// rounding to int8 is half to even as torch.round.
// tests/test_torch_requant_geometry.py transcribes this summation order to
// numpy.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-6f;        // flax.linen.GroupNorm's epsilon
constexpr int kThreadsTarget = 512;  // threads of a block, about
constexpr int kLoadBatch = 4;        // vectors each thread has in flight per source
constexpr int kMaxSmem = 232448;     // 227 KB, the most a block may ask for
constexpr int kChunks = 8;           // bulk copies (each with its barrier) a staged run takes

struct Args {
  const int* y;
  const float* sy;
  const float* gamma;
  const float* beta;
  const void* res;
  const float* res_sy;
  const float* res_gamma;
  const float* res_beta;
  void* out;
  float res_scale;
  float inv_out_scale;
  int res_mode;  // 0 none, 1 int8 with one scale, 2 int32 with its own GroupNorm
  int relu;
  int R, C, G;
  int rpb;     // rows a block owns
  int rpi;     // rows one pass of the block's threads covers (statistics)
  int staged;  // the block's rows are kept in shared memory
};

// Shared memory, in bytes, as the kernel lays it out:
//   bars     [kChunks] mbarriers of the bulk copies
//   vecs     [sources][3][C] f32: s, gamma, beta (read at the start)
//   stage    [sources][rpb][C]: int32 as copied, float y * s once summed
//            (only when staged)
//   scratch  max(tree [sources][2][rpi][C] f32, consts [sources][C] f4)
//   partial  [sources][G][2] f32            (read by the cluster's peers)
struct Layout {
  size_t vecs, stage, scratch, partial, total;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int C, int G, int sources, int rpb, int rpi,
                                         int staged) {
  Layout L;
  L.vecs = round16((size_t)sources * 3 * C * 4);
  L.stage = staged ? round16((size_t)sources * rpb * C * 4) : 0;
  const size_t tree = (size_t)sources * 2 * rpi * C * 4;
  const size_t consts = (size_t)sources * C * 16;
  L.scratch = tree > consts ? tree : consts;
  L.partial = (size_t)sources * G * 2 * 4;
  L.total = kChunks * 8 + L.vecs + L.stage + L.scratch + L.partial;
  return L;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// One bulk copy (the Tensor Memory Accelerator's 1-D form) from device to
// this block's shared memory, reported to `bar` as bytes arrive.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// VEC consecutive int32 of one row (VEC 4: one 16-byte load).
template <int VEC>
__device__ __forceinline__ void load_i32(const int* p, int (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

// x = y * s for VEC channels, added with its square to a thread's sums.
template <int VEC>
__device__ __forceinline__ void accumulate(float (&s)[VEC], float (&q)[VEC],
                                           const float (&scale)[VEC], const int (&v)[VEC],
                                           float (&x)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    x[i] = __fmul_rn((float)v[i], scale[i]);
    s[i] = __fadd_rn(s[i], x[i]);
    q[i] = __fadd_rn(q[i], __fmul_rn(x[i], x[i]));
  }
}

// ((x - mean) * rstd) * gamma + beta, k = (mean, rstd, gamma, beta).
__device__ __forceinline__ float normalize(float x, float4 k) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, k.x), k.y), k.z), k.w);
}

// clamp(rint(x * inv), -127, 127) as the low byte of a float: clamped
// first (the same for integer bounds), then rounded half to even by adding
// 1.5 * 2^23, whose bit pattern then ends in the integer's two's complement.
__device__ __forceinline__ uint32_t quantize_bits(float x, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(x, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

__device__ __forceinline__ uint32_t pack_i8x4(const float (&x)[4], float inv) {
  const uint32_t lo = __byte_perm(quantize_bits(x[0], inv), quantize_bits(x[1], inv), 0x0040);
  const uint32_t hi = __byte_perm(quantize_bits(x[2], inv), quantize_bits(x[3], inv), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int N>
__device__ __forceinline__ uint32_t pick_word(const uint32_t (&w)[N], int j) {
  uint32_t r = w[0];
#pragma unroll
  for (int i = 1; i < N; ++i) r = j == i ? w[i] : r;
  return r;
}

// What the apply pass reads and writes, from the block's first row.
template <typename Out>
struct RowsOf {
  const float* stage_x;  // staged y * s: [sources][rpb][C]
  const int* y;          // or the rows in device memory
  const int* res32;
  const int8_t* res8;
  Out* out;
  const float* vecs;     // [sources][3][C]: s, gamma, beta
  const float4* consts;  // [sources][C]: mean, rstd, gamma, beta
  float res_scale, inv_out_scale, floor;  // floor: 0 with relu, else -inf
  int C, rpb, nrows;
};

// WA int8 of the identity residual at row k (nothing past the last row),
// packed four to a word.
template <int WA>
__device__ __forceinline__ void load_r8(const int8_t* res8, int k, int nrows, int C, int c0,
                                        uint32_t (&r8)[WA == 1 ? 1 : WA / 4]) {
  if (k >= nrows) return;
  const int8_t* q = res8 + k * C + c0;
  if constexpr (WA == 16) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(q));
    r8[0] = w.x; r8[1] = w.y; r8[2] = w.z; r8[3] = w.w;
  } else if constexpr (WA == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(q));
    r8[0] = w.x; r8[1] = w.y;
  } else if constexpr (WA == 4) {
    r8[0] = __ldg(reinterpret_cast<const unsigned int*>(q));
  } else {
    r8[0] = (uint32_t)(uint8_t)__ldg(q);
  }
}

// 5. The apply pass of one residual mode RES and staging.  A thread's row of
// WA channels is NCH 16-byte chunks, taken in an order rotated by its column
// and row so that a warp's shared-memory reads hit every bank evenly; its
// output goes out in one store.
template <int WA, typename Out, int RES, bool STAGED>
__device__ __forceinline__ void apply_rows(const RowsOf<Out>& p) {
  constexpr int NCH = WA == 1 ? 1 : WA / 4;
  constexpr int W = WA == 1 ? 1 : 4;  // channels of a chunk
  const int C = p.C, T = blockDim.x, t = threadIdx.x;
  const int cw = C / WA, rpa = T / cw;
  const int c0 = (t % cw) * WA, ro = t / cw;
  const int rot = (t % cw) + ro;
  // The identity residual, WA int8 in one load, a row ahead.
  uint32_t r8next[NCH] = {};
  if (RES == 1) load_r8<WA>(p.res8, ro, p.nrows, C, c0, r8next);
  for (int k = ro; k < p.nrows; k += rpa) {
    const int e = k * C + c0;
    uint32_t r8[NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i) r8[i] = r8next[i];
    if (RES == 1) load_r8<WA>(p.res8, k + rpa, p.nrows, C, c0, r8next);
    uint32_t words[NCH * sizeof(Out)] = {};  // the row's output, 4 bytes a word
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int j = NCH > 1 ? (i + rot) % NCH : 0;
      const int cj = c0 + W * j, ej = e + W * j;
      float v[W], rv[W];
      if (STAGED) {
        if constexpr (W == 4) {
          const float4 w = *reinterpret_cast<const float4*>(p.stage_x + ej);
          v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
          if (RES == 2) {
            const float4 r = *reinterpret_cast<const float4*>(p.stage_x + p.rpb * C + ej);
            rv[0] = r.x; rv[1] = r.y; rv[2] = r.z; rv[3] = r.w;
          }
        } else {
          v[0] = p.stage_x[ej];
          if (RES == 2) rv[0] = p.stage_x[p.rpb * C + ej];
        }
      } else {
        int y[W], yr[W];
        if constexpr (W == 4) {
          const int4 w = __ldg(reinterpret_cast<const int4*>(p.y + ej));
          y[0] = w.x; y[1] = w.y; y[2] = w.z; y[3] = w.w;
          if (RES == 2) {
            const int4 r = __ldg(reinterpret_cast<const int4*>(p.res32 + ej));
            yr[0] = r.x; yr[1] = r.y; yr[2] = r.z; yr[3] = r.w;
          }
        } else {
          y[0] = __ldg(p.y + ej);
          if (RES == 2) yr[0] = __ldg(p.res32 + ej);
        }
#pragma unroll
        for (int m = 0; m < W; ++m) {
          v[m] = __fmul_rn((float)y[m], p.vecs[cj + m]);
          if (RES == 2) rv[m] = __fmul_rn((float)yr[m], p.vecs[3 * C + cj + m]);
        }
      }
      const uint32_t rw = pick_word<NCH>(r8, j);
      float x[4];
#pragma unroll
      for (int m = 0; m < W; ++m) {
        x[m] = normalize(v[m], p.consts[cj + m]);
        if (RES == 1)
          x[m] = __fadd_rn(x[m], __fmul_rn((float)(int8_t)(rw >> (8 * m)), p.res_scale));
        if (RES == 2) x[m] = __fadd_rn(x[m], normalize(rv[m], p.consts[C + cj + m]));
        x[m] = fmaxf(x[m], p.floor);
      }
      if constexpr (WA == 1) {
        if constexpr (sizeof(Out) == 1)
          words[0] = quantize_bits(x[0], p.inv_out_scale) & 0xffu;
        else
          words[0] = __bfloat16_as_ushort(__float2bfloat16_rn(x[0]));
      } else if constexpr (sizeof(Out) == 1) {
        const uint32_t w = pack_i8x4(x, p.inv_out_scale);
#pragma unroll
        for (int o = 0; o < NCH; ++o) words[o] = j == o ? w : words[o];
      } else {
        const uint32_t w0 = pack_bf16x2(x[0], x[1]), w1 = pack_bf16x2(x[2], x[3]);
#pragma unroll
        for (int o = 0; o < NCH; ++o) {
          words[2 * o] = j == o ? w0 : words[2 * o];
          words[2 * o + 1] = j == o ? w1 : words[2 * o + 1];
        }
      }
    }
    void* dst = p.out + e;
    if constexpr (WA * sizeof(Out) == 16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    } else if constexpr (WA * sizeof(Out) == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
    } else if constexpr (WA * sizeof(Out) == 4) {
      *reinterpret_cast<uint32_t*>(dst) = words[0];
    } else if constexpr (WA * sizeof(Out) == 2) {
      *reinterpret_cast<uint16_t*>(dst) = (uint16_t)words[0];
    } else {
      *reinterpret_cast<uint8_t*>(dst) = (uint8_t)words[0];
    }
  }
}

// WA: channels a thread writes per row (16 int8 or 8 bf16 where C allows,
// else 4, or 1 where C % 4 != 0); the statistics read 4 channels a thread
// (1 when WA is 1).
template <int WA, typename Out>
__global__ void __launch_bounds__(kThreadsTarget, 1) requant_kernel(Args a) {
  constexpr int VEC = WA == 1 ? 1 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int n = blockIdx.y, T = blockDim.x, t = threadIdx.x;
  const int R = a.R, C = a.C, G = a.G, cpg = C / G;
  const int sources = a.res_mode == 2 ? 2 : 1;
  const Layout L = layout(C, G, sources, a.rpb, a.rpi, a.staged);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* vecs = reinterpret_cast<float*>(smem + kChunks * 8);
  int* stage = reinterpret_cast<int*>(smem + kChunks * 8 + L.vecs);
  float* stage_x = reinterpret_cast<float*>(stage);
  float* scratch = reinterpret_cast<float*>(smem + kChunks * 8 + L.vecs + L.stage);
  float* partial = scratch + L.scratch / 4;

  const int r0 = min(R, rank * a.rpb);
  const int nrows = min(R, r0 + a.rpb) - r0;
  const size_t base = ((size_t)n * R + r0) * C;  // first element of the block's run
  const int* src[2] = {a.y + base, a.res_mode == 2 ? (const int*)a.res + base : nullptr};

  // The per-channel vectors, needed after the statistics: read now.
  for (int e = t; e < sources * 3 * C; e += T) {
    const int w = e / C, c = e % C;  // w: s, gamma, beta, then the residual's
    const float* v = w == 0 ? a.sy : w == 1 ? a.gamma : w == 2 ? a.beta
                   : w == 3 ? a.res_sy : w == 4 ? a.res_gamma : a.res_beta;
    vecs[e] = __ldg(v + c);
  }

  // 1-2. Read the run once (staging y * s in its place), per-thread sums in
  // row order.
  {
    const int cv = C / VEC, rpi = a.rpi;
    const int c0 = (t % cv) * VEC, ro = t / cv;
    float s[2][VEC], q[2][VEC], scale[2][VEC];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[u][i] = 0.0f;
        q[u][i] = 0.0f;
        scale[u][i] = u == 0 ? __ldg(a.sy + c0 + i)
                             : (sources == 2 ? __ldg(a.res_sy + c0 + i) : 0.0f);
      }
    }
    bool bulk = false;
    if constexpr (VEC == 4) {
      bulk = a.staged;
      if (bulk) {
        // The whole run in flight at once: kChunks bulk copies of whole
        // passes, started by one thread; the sums start on a chunk as soon as
        // it has landed.
        const int passes = (nrows + rpi - 1) / rpi;
        const int rpc = (passes + kChunks - 1) / kChunks * rpi;  // rows a chunk
        const int chunks = nrows ? (nrows + rpc - 1) / rpc : 0;
        if (t == 0) {
          for (int c = 0; c < chunks; ++c) mbar_init(&bars[c], 1);
          asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
        if (t == 0) {
          for (int c = 0; c < chunks; ++c) {
            const int k0 = c * rpc, kn = min(nrows, k0 + rpc) - k0;
            const unsigned bytes = (unsigned)kn * C * 4;
            mbar_expect_tx(&bars[c], bytes * sources);
            for (int u = 0; u < sources; ++u)
              bulk_load(stage + ((size_t)u * a.rpb + k0) * C, src[u] + (size_t)k0 * C, bytes,
                        &bars[c]);
          }
        }
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&bars[c], 0);
          const int kn = min(nrows, (c + 1) * rpc);
          for (int k = c * rpc + ro; k < kn; k += rpi) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (u < sources) {
                int* p = stage + ((size_t)u * a.rpb + k) * C + c0;
                const int4 w = *reinterpret_cast<const int4*>(p);
                const int v[4] = {w.x, w.y, w.z, w.w};
                float x[4];
                accumulate<VEC>(s[u], q[u], scale[u], v, x);
                *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
              }
            }
          }
        }
      }
    }
    if (!bulk) {
      for (int k0 = ro; k0 < nrows; k0 += kLoadBatch * rpi) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u < sources) {
            int v[kLoadBatch][VEC];
#pragma unroll
            for (int b = 0; b < kLoadBatch; ++b) {
              const int k = k0 + b * rpi;
              if (k < nrows) load_i32<VEC>(src[u] + (size_t)k * C + c0, v[b]);
            }
#pragma unroll
            for (int b = 0; b < kLoadBatch; ++b) {
              const int k = k0 + b * rpi;
              if (k < nrows) {
                float x[VEC];
                accumulate<VEC>(s[u], q[u], scale[u], v[b], x);
                if (a.staged) {
#pragma unroll
                  for (int i = 0; i < VEC; ++i)
                    stage_x[((size_t)u * a.rpb + k) * C + c0 + i] = x[i];
                }
              }
            }
          }
        }
      }
    }
    // The tree over the threads' row offsets: scratch [sources][2][rpi][C].
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u < sources) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          scratch[((u * 2 + 0) * rpi + ro) * C + c0 + i] = s[u][i];
          scratch[((u * 2 + 1) * rpi + ro) * C + c0 + i] = q[u][i];
        }
      }
    }
    for (int stride = rpi / 2; stride > 0; stride /= 2) {
      __syncthreads();
      if (ro < stride) {
        for (int w = 0; w < 2 * sources; ++w) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            float* lo = scratch + ((size_t)w * rpi + ro) * C + c0 + i;
            *lo = __fadd_rn(*lo, lo[(size_t)stride * C]);
          }
        }
      }
    }
    __syncthreads();
    // The channels of each group in channel order.
    for (int g = t; g < G * sources; g += T) {
      const int u = g / G, gg = g % G;
      const float* sum = scratch + (size_t)(u * 2 + 0) * rpi * C + gg * cpg;
      const float* sq = scratch + (size_t)(u * 2 + 1) * rpi * C + gg * cpg;
      float x = 0.0f, x2 = 0.0f;
      for (int k = 0; k < cpg; ++k) {
        x = __fadd_rn(x, sum[k]);
        x2 = __fadd_rn(x2, sq[k]);
      }
      partial[2 * g] = x;
      partial[2 * g + 1] = x2;
    }
  }

  // 3-4. Every block adds all ranks' partial sums in rank order, and writes
  // each channel's constants (mean, rstd, gamma, beta) over the tree's
  // scratch.
  cluster_arrive();
  cluster_wait();
  float4* consts = reinterpret_cast<float4*>(scratch);  // [sources][C]
  const float count = (float)R * (float)cpg;
  for (int g = t; g < G * sources; g += T) {
    float x = 0.0f, x2 = 0.0f;
    for (int r = 0; r < ranks; r += 4) {
      float2 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r + i < ranks)
          p[i] = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(partial, (unsigned)(r + i)) + 2 * g);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r + i < ranks) {
          x = __fadd_rn(x, p[i].x);
          x2 = __fadd_rn(x2, p[i].y);
        }
      }
    }
    const float mu = __fdiv_rn(x, count);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(x2, count), __fmul_rn(mu, mu)), 0.0f);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, kEps)));
    const int u = g / G, c0 = (g % G) * cpg;
    const float* v = vecs + u * 3 * C;
    for (int c = c0; c < c0 + cpg; ++c)
      consts[u * C + c] = make_float4(mu, rstd, v[C + c], v[2 * C + c]);
  }
  cluster_arrive();  // done with the peers' shared memory; waited on at the end
  __syncthreads();

  // 5. Normalize, add the residual, relu, requantize: one loop per residual
  // mode and staging, so that each keeps only its own values in registers.
  const float floor = a.relu ? 0.0f : __int_as_float(0xff800000);  // -inf: no relu
  const RowsOf<Out> rows{stage_x, src[0], src[1],
                         a.res_mode == 1 ? (const int8_t*)a.res + base : nullptr,
                         reinterpret_cast<Out*>(a.out) + base, vecs, consts, a.res_scale,
                         a.inv_out_scale, floor, C, a.rpb, nrows};
  switch (a.res_mode * 2 + (a.staged ? 1 : 0)) {
    case 0: apply_rows<WA, Out, 0, false>(rows); break;
    case 1: apply_rows<WA, Out, 0, true>(rows); break;
    case 2: apply_rows<WA, Out, 1, false>(rows); break;
    case 3: apply_rows<WA, Out, 1, true>(rows); break;
    case 4: apply_rows<WA, Out, 2, false>(rows); break;
    default: apply_rows<WA, Out, 2, true>(rows); break;
  }
  cluster_wait();
}

const void* pick(int wa, int out_int8) {
  switch (wa) {
    case 16: return (const void*)&requant_kernel<16, int8_t>;
    case 8: return (const void*)&requant_kernel<8, __nv_bfloat16>;
    case 4: return out_int8 ? (const void*)&requant_kernel<4, int8_t>
                            : (const void*)&requant_kernel<4, __nv_bfloat16>;
    case 1: return out_int8 ? (const void*)&requant_kernel<1, int8_t>
                            : (const void*)&requant_kernel<1, __nv_bfloat16>;
    default: return nullptr;
  }
}

// Threads of a block and rows of one statistics pass: (C / VEC) * rpi, rpi
// the largest power of two that keeps the block at about kThreadsTarget.
void threads_of(int C, int wa, int* threads, int* rpi) {
  const int cv = wa == 1 ? C : C / 4;
  int r = 1;
  while (2 * r * cv <= kThreadsTarget) r *= 2;
  *threads = cv * r;
  *rpi = r;
}

// Lets a kernel take up to kMaxSmem of shared memory and clusters of 16;
// once per kernel.
cudaError_t prepare(const void* fn) {
  static const void* done[8] = {};
  for (const void* d : done) {
    if (d == fn) return cudaSuccess;
  }
  cudaError_t rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != cudaSuccess) return rc;
  for (const void*& d : done) {
    if (!d) {
      d = fn;
      break;
    }
  }
  return cudaSuccess;
}

cudaLaunchConfig_t config_of(int N, int cluster, int threads, int smem, cudaStream_t st,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, N, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// What the kernel expects for a call the wrapper has laid out as (wa,
// cluster, rpb, staged): out[0] threads, out[1] rows per statistics pass,
// out[2] shared memory in bytes.  Returns 0, or 1 when the layout asks for
// more shared memory than a block may have.
extern "C" int requant_layout(int C, int G, int res_mode, int wa, int rpb, int staged,
                              int* out) {
  int threads, rpi;
  threads_of(C, wa, &threads, &rpi);
  const Layout L = layout(C, G, res_mode == 2 ? 2 : 1, rpb, rpi, staged);
  out[0] = threads;
  out[1] = rpi;
  out[2] = (int)L.total;
  return L.total > (size_t)kMaxSmem ? 1 : 0;
}

// How many clusters of `cluster` blocks of this geometry the card holds at
// once (cudaOccupancyMaxActiveClusters); a negative CUDA error code if the
// query fails.  0 means the geometry cannot be placed.
extern "C" int requant_max_active_clusters(int wa, int out_int8, int cluster, int threads,
                                           int smem) {
  const void* fn = pick(wa, out_int8);
  if (!fn) return -1;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return -(int)rc;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config_of(1, cluster, threads, smem, 0, attr);
  cfg.gridDim = dim3(cluster, 1, 1);
  int n = 0;
  rc = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return rc == cudaSuccess ? n : -(int)rc;
}

// Blocks of this geometry one SM holds at once.
extern "C" int requant_blocks_per_sm(int wa, int out_int8, int threads, int smem) {
  const void* fn = pick(wa, out_int8);
  if (!fn) return -1;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return -(int)rc;
  int n = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem);
  return rc == cudaSuccess ? n : -(int)rc;
}

// y [N, R, C] int32; out [N, R, C] int8 (out_int8 != 0) or bf16.  One launch:
// a grid of N clusters of `cluster` blocks, block `rank` of sample n owning
// rows [rank * rpb, (rank + 1) * rpb).  wa: 16 (int8) or 8 (bf16) when C
// allows, else 4 (C % 4 == 0) or 1; with wa > 1 every tensor must be 16-byte
// aligned.
extern "C" int requant_epilogue_launch(
    const void* y, const void* sy, const void* gamma, const void* beta, const void* res,
    const void* res_sy, const void* res_gamma, const void* res_beta, float res_scale,
    int res_mode, int relu, int out_int8, float inv_out_scale, void* out, int N, int R,
    int C, int G, int wa, int cluster, int rpb, int staged, void* stream) {
  int geo[3];
  if (requant_layout(C, G, res_mode, wa, rpb, staged, geo)) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > 16 || (long long)cluster * rpb < R)
    return (int)cudaErrorInvalidValue;
  const void* fn = pick(wa, out_int8);
  if (!fn || (wa == 16 && !out_int8) || (wa == 8 && out_int8)) return (int)cudaErrorInvalidValue;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return (int)rc;
  Args a;
  a.y = (const int*)y;
  a.sy = (const float*)sy;
  a.gamma = (const float*)gamma;
  a.beta = (const float*)beta;
  a.res = res;
  a.res_sy = (const float*)res_sy;
  a.res_gamma = (const float*)res_gamma;
  a.res_beta = (const float*)res_beta;
  a.out = out;
  a.res_scale = res_scale;
  a.inv_out_scale = inv_out_scale;
  a.res_mode = res_mode;
  a.relu = relu;
  a.R = R;
  a.C = C;
  a.G = G;
  a.rpb = rpb;
  a.rpi = geo[1];
  a.staged = staged;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config_of(N, cluster, geo[0], geo[2], (cudaStream_t)stream, attr);
  void* params[] = {&a};
  rc = cudaLaunchKernelExC(&cfg, fn, params);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
