// Kernel G: the pose net's bfloat16 GroupNorm with what follows it.
//
//   x (bf16) --GroupNorm--> bf16 --[+ bf16 residual | + GroupNorm(x2) as bf16]--> [relu] --> bf16
//
// Replaces no Pallas kernel: the JAX package leaves this GroupNorm to XLA,
// which fuses it with the ReLU and the residual add on the TPU.  In PyTorch
// the same arithmetic (models/precision.py) is about fourteen ATen kernels a
// GroupNorm (an upcast, two means, the variance, rsqrt, four elementwise
// passes, a downcast) plus one for the ReLU and two for a residual: a
// dozen float32 passes over the activations and some 15 launches a site,
// 23 sites a pose-net call.  G is one launch a site that reads each
// element from device memory once and writes it once.
//
// x is [N, R, C] bfloat16, channels innermost (the NHWC memory of the pose
// net's channels-last activations), groups of C / G contiguous channels.
// One launch, one thread-block cluster per sample (kernel F's design,
// csrc/requant.cu):
//
//   1. each block of the cluster owns a contiguous run of `rpb` rows of its
//      sample.  Where the run fits in shared memory (`staged`), one thread
//      puts all of it in flight at once as bulk copies (the Tensor Memory
//      Accelerator's 1-D form, kChunks of them, each with an mbarrier);
//      elsewhere the threads read it 16 bytes at a time and read it again
//      in step 5 (from L2: the wrapper stages every call whose rows would
//      not stay there, ops/group_norm.py:launch_geometry);
//   2. it sums x and x * x per channel in float32 (each thread over its rows
//      in row order, 8 channels a thread), folds the threads' sums with a
//      fixed tree in shared memory and the channels of a group in channel
//      order;
//   3. it publishes those [G, 2] partial sums and waits on the cluster
//      barrier;
//   4. every block reads all ranks' partial sums through distributed shared
//      memory, in rank order, and computes each group's mean and rstd
//      itself; it arrives on a second cluster barrier and waits on it only
//      before it exits, which keeps its partial sums alive while its peers
//      read them;
//   5. it normalizes its rows, rounds to bfloat16, adds the residual (an
//      identity residual read from device memory, or the second source
//      normalized the same way and rounded), rounds again, relus and writes
//      8 channels a thread in one 16-byte store.
//
// Arithmetic: that of precision.group_norm on the card, operation for
// operation: mean = sum * factor and mean of squares the same, factor the
// host's float(N * G) / float(numel) as torch's CUDA mean takes it; var =
// max(E[x^2] - mean^2, 0); rstd = rsqrtf(var + 1e-6); a = rstd * gamma;
// y = (x - mean) * a + beta, each step rounded to float32 with the
// round-to-nearest intrinsics so that nvcc contracts no product and sum
// into one fused operation; y rounded once to bfloat16; a sum of two
// bfloat16 values taken in float32 and rounded once, as torch adds two
// bfloat16 tensors.  Only the order of the statistics' sums differs from
// torch's, so an output differs from the plain version's by a bfloat16 ulp
// where a sum's last bit tips a rounding.
//
// Bound: bytes.  Each element is read as 2 bytes (plus 2 of residual or of
// the second source) and written as 2, against about a dozen float
// operations.  Staged, no byte is read twice.  C is a multiple of 8 and
// every tensor 16-byte aligned (the wrapper, ops/group_norm.py, checks),
// C at most 4096.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-6f;        // flax.linen.GroupNorm's epsilon
constexpr int kThreadsTarget = 512;  // threads of a block, about
constexpr int kVec = 8;              // channels a thread reads and writes (16 bytes)
constexpr int kLoadBatch = 4;        // rows each thread has in flight per source, unstaged
constexpr int kMaxSmem = 232448;     // 227 KB, the most a block may ask for
constexpr int kChunks = 8;           // bulk copies (each with its barrier) a staged run takes

struct Args {
  const __nv_bfloat16* x[2];  // the sources: x, and for RES 2 the shortcut's
  const float* gamma[2];
  const float* beta[2];
  const __nv_bfloat16* res;   // the identity residual (RES 1)
  __nv_bfloat16* out;
  float factor;               // 1 / (R * C / G) as the card's mean takes it
  int relu;
  int R, C, G;
  int rpb;     // rows a block owns
  int rpi;     // rows one pass of the block's threads covers
  int staged;  // the block's rows are kept in shared memory
};

// Shared memory, in bytes, as the kernel lays it out:
//   bars     [kChunks] mbarriers of the bulk copies
//   stage    [sources][rpb][C] bf16, as copied (only when staged)
//   scratch  tree [sources][2][rpi][C] f32; then stats [sources][G] f2
//   partial  [sources][G][2] f32            (read by the cluster's peers)
struct Layout {
  size_t stage, scratch, partial, total;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int C, int G, int sources, int rpb, int rpi,
                                         int staged) {
  Layout L;
  L.stage = staged ? round16((size_t)sources * rpb * C * 2) : 0;
  const size_t tree = (size_t)sources * 2 * rpi * C * 4;
  const size_t stats = (size_t)sources * G * 8;
  L.scratch = round16(tree > stats ? tree : stats);
  L.partial = (size_t)sources * G * 2 * 4;
  L.total = kChunks * 8 + L.stage + L.scratch + L.partial;
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

// 8 bfloat16 from a 16-byte word, as float32 (exact).
__device__ __forceinline__ void unpack8(uint4 w, float (&v)[kVec]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x rounded to bfloat16, as float32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void accumulate(float (&s)[kVec], float (&q)[kVec], uint4 w) {
  float v[kVec];
  unpack8(w, v);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    s[i] = __fadd_rn(s[i], v[i]);
    q[i] = __fadd_rn(q[i], __fmul_rn(v[i], v[i]));
  }
}

// A thread's 8 channels of one source: (x - mean) * a + beta, a = rstd * gamma.
struct Consts {
  float mean[kVec], a[kVec], beta[kVec];
};

__device__ __forceinline__ float normalize(float x, const Consts& k, int i) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, k.mean[i]), k.a[i]), k.beta[i]);
}

// 5. The apply pass of one residual mode RES and staging: a thread's 8
// channels of rows ro, ro + rpi, ... of the block's run.
template <int RES, bool STAGED>
__device__ __forceinline__ void apply_rows(const Args& a, const __nv_bfloat16* x0,
                                           const __nv_bfloat16* x1, const __nv_bfloat16* stage,
                                           const __nv_bfloat16* res, __nv_bfloat16* out,
                                           const Consts (&k)[2], int nrows, int c0, int ro) {
  const int C = a.C, rpi = a.rpi;
  const float floor = a.relu ? 0.0f : __int_as_float(0xff800000);  // -inf: no relu
  for (int r = ro; r < nrows; r += rpi) {
    const size_t e = (size_t)r * C + c0;
    uint4 w0, w1, wr;
    if (STAGED) {
      w0 = *reinterpret_cast<const uint4*>(stage + e);
      if (RES == 2) w1 = *reinterpret_cast<const uint4*>(stage + (size_t)a.rpb * C + e);
    } else {
      w0 = __ldg(reinterpret_cast<const uint4*>(x0 + e));
      if (RES == 2) w1 = __ldg(reinterpret_cast<const uint4*>(x1 + e));
    }
    if (RES == 1) wr = __ldg(reinterpret_cast<const uint4*>(res + e));
    float v[kVec], v1[kVec], rv[kVec], y[kVec];
    unpack8(w0, v);
    if (RES == 2) unpack8(w1, v1);
    if (RES == 1) unpack8(wr, rv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      y[i] = normalize(v[i], k[0], i);
      if (RES == 1) y[i] = __fadd_rn(round_bf16(y[i]), rv[i]);
      if (RES == 2) y[i] = __fadd_rn(round_bf16(y[i]), round_bf16(normalize(v1[i], k[1], i)));
      y[i] = fmaxf(y[i], floor);
    }
    *reinterpret_cast<uint4*>(out + e) =
        make_uint4(pack_bf16x2(y[0], y[1]), pack_bf16x2(y[2], y[3]), pack_bf16x2(y[4], y[5]),
                   pack_bf16x2(y[6], y[7]));
  }
}

// RES: 0 none, 1 a bfloat16 identity residual, 2 a second source with its
// own GroupNorm (the projection shortcut).
template <int RES>
__global__ void __launch_bounds__(kThreadsTarget, 1) group_norm_kernel(Args a) {
  constexpr int S = RES == 2 ? 2 : 1;  // sources
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int n = blockIdx.y, T = blockDim.x, t = threadIdx.x;
  const int R = a.R, C = a.C, G = a.G, cpg = C / G, rpi = a.rpi;
  const Layout L = layout(C, G, S, a.rpb, rpi, a.staged);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + kChunks * 8);
  float* scratch = reinterpret_cast<float*>(smem + kChunks * 8 + L.stage);
  float* partial = scratch + L.scratch / 4;

  const int r0 = min(R, rank * a.rpb);
  const int nrows = min(R, r0 + a.rpb) - r0;
  const size_t base = ((size_t)n * R + r0) * C;  // first element of the block's run
  const __nv_bfloat16* src[2] = {a.x[0] + base, S == 2 ? a.x[1] + base : nullptr};
  const int cv = C / kVec;
  const int c0 = (t % cv) * kVec, ro = t / cv;

  // 1-2. Read the run once, per-thread sums in row order.
  {
    float s[S][kVec], q[S][kVec];
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) s[u][i] = q[u][i] = 0.0f;
    }
    if (a.staged) {
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
          const unsigned bytes = (unsigned)kn * C * 2;
          mbar_expect_tx(&bars[c], bytes * S);
          for (int u = 0; u < S; ++u)
            bulk_load(stage + ((size_t)u * a.rpb + k0) * C, src[u] + (size_t)k0 * C, bytes,
                      &bars[c]);
        }
      }
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(&bars[c], 0);
        const int kn = min(nrows, (c + 1) * rpc);
        for (int k = c * rpc + ro; k < kn; k += rpi) {
#pragma unroll
          for (int u = 0; u < S; ++u)
            accumulate(s[u], q[u], *reinterpret_cast<const uint4*>(
                                       stage + ((size_t)u * a.rpb + k) * C + c0));
        }
      }
    } else {
      for (int k0 = ro; k0 < nrows; k0 += kLoadBatch * rpi) {
#pragma unroll
        for (int u = 0; u < S; ++u) {
          uint4 w[kLoadBatch];
#pragma unroll
          for (int b = 0; b < kLoadBatch; ++b) {
            const int k = k0 + b * rpi;
            if (k < nrows) w[b] = __ldg(reinterpret_cast<const uint4*>(src[u] + (size_t)k * C + c0));
          }
#pragma unroll
          for (int b = 0; b < kLoadBatch; ++b) {
            if (k0 + b * rpi < nrows) accumulate(s[u], q[u], w[b]);
          }
        }
      }
    }
    // The tree over the threads' row offsets: scratch [sources][2][rpi][C].
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        scratch[((u * 2 + 0) * rpi + ro) * C + c0 + i] = s[u][i];
        scratch[((u * 2 + 1) * rpi + ro) * C + c0 + i] = q[u][i];
      }
    }
    for (int stride = rpi / 2; stride > 0; stride /= 2) {
      __syncthreads();
      if (ro < stride) {
        for (int w = 0; w < 2 * S; ++w) {
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            float* lo = scratch + ((size_t)w * rpi + ro) * C + c0 + i;
            *lo = __fadd_rn(*lo, lo[(size_t)stride * C]);
          }
        }
      }
    }
    __syncthreads();
    // The channels of each group in channel order.
    for (int g = t; g < G * S; g += T) {
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

  // 3-4. Every block adds all ranks' partial sums in rank order and writes
  // each group's (mean, rstd) over the tree's scratch.
  cluster_arrive();
  cluster_wait();
  float2* stats = reinterpret_cast<float2*>(scratch);  // [sources][G]
  for (int g = t; g < G * S; g += T) {
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
    const float mean = __fmul_rn(x, a.factor);
    const float var = fmaxf(__fsub_rn(__fmul_rn(x2, a.factor), __fmul_rn(mean, mean)), 0.0f);
    stats[g] = make_float2(mean, rsqrtf(__fadd_rn(var, kEps)));
  }
  cluster_arrive();  // done with the peers' shared memory; waited on at the end
  __syncthreads();

  // The thread's 8 channels' constants, in registers.
  Consts k[2];
#pragma unroll
  for (int u = 0; u < S; ++u) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = c0 + i;
      const float2 st = stats[u * G + c / cpg];
      k[u].mean[i] = st.x;
      k[u].a[i] = __fmul_rn(st.y, __ldg(a.gamma[u] + c));
      k[u].beta[i] = __ldg(a.beta[u] + c);
    }
  }
  const __nv_bfloat16* res = RES == 1 ? a.res + base : nullptr;
  __nv_bfloat16* out = a.out + base;
  if (a.staged)
    apply_rows<RES, true>(a, src[0], src[1], stage, res, out, k, nrows, c0, ro);
  else
    apply_rows<RES, false>(a, src[0], src[1], stage, res, out, k, nrows, c0, ro);
  cluster_wait();
}

const void* pick(int res_mode) {
  switch (res_mode) {
    case 0: return (const void*)&group_norm_kernel<0>;
    case 1: return (const void*)&group_norm_kernel<1>;
    case 2: return (const void*)&group_norm_kernel<2>;
    default: return nullptr;
  }
}

// Threads of a block and rows of one pass: (C / 8) * rpi, rpi the largest
// power of two that keeps the block at about kThreadsTarget.
void threads_of(int C, int* threads, int* rpi) {
  const int cv = C / kVec;
  int r = 1;
  while (2 * r * cv <= kThreadsTarget) r *= 2;
  *threads = cv * r;
  *rpi = r;
}

// Lets a kernel take up to kMaxSmem of shared memory and clusters of 16;
// once per kernel.
cudaError_t prepare(const void* fn) {
  static const void* done[3] = {};
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

// What the kernel expects for a call the wrapper has laid out as (rpb,
// staged): out[0] threads, out[1] rows per pass, out[2] shared memory in
// bytes.  Returns 0, or 1 when the layout asks for more shared memory than a
// block may have.
extern "C" int group_norm_layout(int C, int G, int res_mode, int rpb, int staged, int* out) {
  int threads, rpi;
  threads_of(C, &threads, &rpi);
  const Layout L = layout(C, G, res_mode == 2 ? 2 : 1, rpb, rpi, staged);
  out[0] = threads;
  out[1] = rpi;
  out[2] = (int)L.total;
  return L.total > (size_t)kMaxSmem ? 1 : 0;
}

// How many clusters of `cluster` blocks of this geometry the card holds at
// once (cudaOccupancyMaxActiveClusters); a negative CUDA error code if the
// query fails.  0 means the geometry cannot be placed.
extern "C" int group_norm_max_active_clusters(int res_mode, int cluster, int threads, int smem) {
  const void* fn = pick(res_mode);
  if (!fn) return -1;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return -(int)rc;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config_of(1, cluster, threads, smem, 0, attr);
  int n = 0;
  rc = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return rc == cudaSuccess ? n : -(int)rc;
}

// Blocks of this geometry one SM holds at once.
extern "C" int group_norm_blocks_per_sm(int res_mode, int threads, int smem) {
  const void* fn = pick(res_mode);
  if (!fn) return -1;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return -(int)rc;
  int n = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem);
  return rc == cudaSuccess ? n : -(int)rc;
}

// x, x2, res, out [N, R, C] bf16; gamma, beta, gamma2, beta2 [C] f32.  One
// launch: a grid of N clusters of `cluster` blocks, block `rank` of sample n
// owning rows [rank * rpb, (rank + 1) * rpb).  res_mode 0: out = act(gn(x));
// 1: act(bf16(gn(x)) + res); 2: act(bf16(gn(x)) + bf16(gn2(x2))); act is
// relu when `relu`, else nothing.  C % 8 == 0, every tensor 16-byte aligned.
extern "C" int group_norm_launch(const void* x, const void* gamma, const void* beta,
                                 const void* x2, const void* gamma2, const void* beta2,
                                 const void* res, int res_mode, int relu, float factor, void* out,
                                 int N, int R, int C, int G, int cluster, int rpb, int staged,
                                 void* stream) {
  int geo[3];
  if (C % kVec || G < 1 || C % G) return (int)cudaErrorInvalidValue;
  if (group_norm_layout(C, G, res_mode, rpb, staged, geo)) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > 16 || (long long)cluster * rpb < R)
    return (int)cudaErrorInvalidValue;
  const void* fn = pick(res_mode);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t rc = prepare(fn);
  if (rc != cudaSuccess) return (int)rc;
  Args a;
  a.x[0] = (const __nv_bfloat16*)x;
  a.x[1] = (const __nv_bfloat16*)x2;
  a.gamma[0] = (const float*)gamma;
  a.gamma[1] = (const float*)gamma2;
  a.beta[0] = (const float*)beta;
  a.beta[1] = (const float*)beta2;
  a.res = (const __nv_bfloat16*)res;
  a.out = (__nv_bfloat16*)out;
  a.factor = factor;
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
