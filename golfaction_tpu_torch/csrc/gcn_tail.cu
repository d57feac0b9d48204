// Kernel B: the GCN block tail — everything between two spatial graph convs.
//
// Replaces golfaction_tpu/ops/pallas/gcn_kernel.py (gcn_block_tail_pallas,
// body _tail_kernel).  Per clip it computes, on x [T, V, C] (post spatial
// conv, pre LayerNorm), with frames t >= la masked:
//   y  = relu(LN0(x))
//   h_s = branch 1x1 product, LN, relu (no relu on the max-pool branch)
//   z  = relu(LNf(concat(depthwise dilated taps of h_s, temporal max of h_mp)))
//   SE channel gate g_c from the masked mean of z; ST-joint gates g_t, g_v
//   from the frame and joint pools of z * g_c
//   out = z * g_c * g_t[t] * g_v[v]
//
// The TPU kernel holds one whole clip ([T*V, C] rows, up to 8.9 MB here) in
// VMEM.  That does not fit 227 KB of shared memory, and the two attention
// gates need reductions over the whole clip, so the work is three launches:
//   1. tail_frames_kernel, grid (frame tile, clip): recomputes a halo of
//      `halo` frames at each tile edge so the dilated taps and the max-pool
//      need no neighbour block; the 1x1 products are shared-memory-staged
//      float32 FMA loops.  It writes z, the per-frame joint means of z, and
//      per-tile per-joint sums of z (the pools are linear, so
//      pool(z * g_c) = g_c * pool(z) and the gate can come later).
//   2. tail_gates_kernel, grid (clip): reduces the per-tile sums, computes
//      the SE gate g_c and the joint gate g_v.
//   3. tail_apply_kernel, grid (frame tile, clip): the frame gate g_t for its
//      frames, then out = z * g_c * g_t * g_v.
//
// Bound: operations.  The C x C branch product (2 C^2 FLOPs per row) outweighs
// the traffic of about three reads and two writes of [B, T*V, C] float32 at
// C >= 64.  In practice the product loop is held back by the latency of its
// weight reads: shared memory bounds the frame tile (larger C, shorter tile,
// chosen by the wrapper), so at C = 256 one block fills an SM and the halo
// rows are recomputed.
//
// LayerNorm follows flax: var = E[x^2] - E[x]^2 (clamped at 0), eps 1e-6.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageRows = 16;
constexpr int kMaxSeg = 16;
constexpr int kApplyFrames = 8;
constexpr float kEps = 1e-6f;

// Float offsets of the packed weights; mirrored by
// golfaction_tpu_torch/ops/gcn_tail.py:tail_layout.
struct Layout {
  int ln0s, ln0b, w1, blns, blnb, taps, lnfs, lnfb;
  int caw1, cab1, caw2, cab2, wf, slns, slnb, wt, bt, wv, bv, total;
};

__host__ __device__ inline Layout make_layout(int C, int M) {
  Layout L;
  int o = 0;
  L.ln0s = o; o += C;
  L.ln0b = o; o += C;
  L.w1 = o; o += C * C;
  L.blns = o; o += C;
  L.blnb = o; o += C;
  L.taps = o; o += 3 * C;
  L.lnfs = o; o += C;
  L.lnfb = o; o += C;
  L.caw1 = o; o += C * M;
  L.cab1 = o; o += M;
  L.caw2 = o; o += M * C;
  L.cab2 = o; o += C;
  L.wf = o; o += C * M;
  L.slns = o; o += M;
  L.slnb = o; o += M;
  L.wt = o; o += M * C;
  L.bt = o; o += C;
  L.wv = o; o += M * C;
  L.bv = o; o += C;
  L.total = o;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// meta = [nseg, bounds[0..nseg], dil[0..nseg-1]]; dil < 0 marks the
// max-pool segment.
__global__ void __launch_bounds__(kThreads) tail_frames_kernel(
    const float* __restrict__ x, const int* __restrict__ la_arr,
    const float* __restrict__ P, const int* __restrict__ meta,
    float* z, float* __restrict__ tpool, float* __restrict__ vpart,
    int T, int V, int C, int M, int TT, int halo) {
  extern __shared__ float smem[];
  int* chseg = reinterpret_cast<int*>(smem);  // [C]
  int* segdil = chseg + C;                    // [kMaxSeg]
  int* bounds = segdil + kMaxSeg;             // [kMaxSeg + 1]
  float* stage = smem + C + 64;               // [kStageRows, C]
  float* Hs = stage + kStageRows * C;         // [(TT + 2 halo) V, C]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x, b = blockIdx.y;
  const int ntiles = gridDim.x;
  const int t0 = tile * TT;
  const int la = la_arr[b];
  const int Rext = (TT + 2 * halo) * V;
  const Layout L = make_layout(C, M);
  const float* xb = x + (size_t)b * T * V * C;

  const int nseg = meta[0];
  if (tid <= nseg) bounds[tid] = meta[1 + tid];
  if (tid < nseg) segdil[tid] = meta[2 + nseg + tid];
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    int s = 0;
    while (c >= bounds[s + 1]) ++s;
    chseg[c] = s;
  }

  // ---- Phase A: y = mask(relu(LN0(x))) and h = y @ W1 for the extended tile.
  const int G = kThreads / C;  // row groups of the product (C <= kThreads)
  const int o = tid % C, g = tid / C;
  for (int r0 = 0; r0 < Rext; r0 += kStageRows) {
    for (int q = warp; q < kStageRows; q += kWarps) {
      const int r = r0 + q;
      float* st = stage + q * C;
      const int f = t0 - halo + r / V, v = r % V;
      if (r >= Rext || f < 0 || f >= T) {
        for (int c = lane; c < C; c += 32) st[c] = 0.0f;
        continue;
      }
      const float* xr = xb + ((size_t)f * V + v) * C;
      float s1 = 0.0f, s2 = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float a = xr[c];
        s1 += a;
        s2 += a * a;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const float mean = s1 / C;
      const float rs = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + kEps);
      const bool valid = f < la;
      for (int c = lane; c < C; c += 32) {
        const float yv = (xr[c] - mean) * rs * P[L.ln0s + c] + P[L.ln0b + c];
        st[c] = valid ? fmaxf(yv, 0.0f) : 0.0f;
      }
    }
    __syncthreads();
    if (g < G) {
      float acc[kStageRows];
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) acc[i] = 0.0f;
      const float* W1 = P + L.w1;
      for (int c = 0; c < C; ++c) {
        const float w = W1[(size_t)c * C + o];
#pragma unroll
        for (int i = 0; i < kStageRows; ++i) {
          const int q = g + G * i;
          if (q < kStageRows) acc[i] += stage[q * C + c] * w;
        }
      }
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) {
        const int q = g + G * i;
        if (q < kStageRows && r0 + q < Rext) Hs[(size_t)(r0 + q) * C + o] = acc[i];
      }
    }
    __syncthreads();
  }

  // ---- Phase A2: per-branch LayerNorm, relu, mask; the max-pool branch
  // takes -1e4 on masked frames and -inf past the clip edge.
  for (int r = warp; r < Rext; r += kWarps) {
    const int f = t0 - halo + r / V;
    float* hr = Hs + (size_t)r * C;
    const bool inside = f >= 0 && f < T;
    const bool valid = inside && f < la;
    for (int s = 0; s < nseg; ++s) {
      const int a = bounds[s], e = bounds[s + 1];
      const bool mp = segdil[s] < 0;
      if (!valid) {
        const float fill = mp ? (inside ? -1e4f : -INFINITY) : 0.0f;
        for (int c = a + lane; c < e; c += 32) hr[c] = fill;
        continue;
      }
      float s1 = 0.0f, s2 = 0.0f;
      for (int c = a + lane; c < e; c += 32) {
        const float h = hr[c];
        s1 += h;
        s2 += h * h;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      const int n = e - a;
      const float mean = s1 / n;
      const float rs = rsqrtf(fmaxf(s2 / n - mean * mean, 0.0f) + kEps);
      for (int c = a + lane; c < e; c += 32) {
        const float h = (hr[c] - mean) * rs * P[L.blns + c] + P[L.blnb + c];
        hr[c] = mp ? h : fmaxf(h, 0.0f);
      }
    }
  }
  __syncthreads();

  // ---- Phase B: taps / max-pool, concat, LNf, relu, mask -> z.
  const int TTe = min(TT, T - t0);
  const float* taps = P + L.taps;
  for (int rr = warp; rr < TTe * V; rr += kWarps) {
    const int fl = rr / V, v = rr % V;
    const int f = t0 + fl;
    const int r = (fl + halo) * V + v;
    float* st = stage + warp * C;  // lane-private entries c = lane + 32k
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const int d = segdil[chseg[c]];
      float val;
      if (d < 0) {
        val = fmaxf(fmaxf(Hs[(size_t)r * C + c], Hs[(size_t)(r - V) * C + c]),
                    Hs[(size_t)(r + V) * C + c]);
      } else {
        val = taps[c] * Hs[(size_t)(r - d * V) * C + c];
        val += taps[C + c] * Hs[(size_t)r * C + c];
        val += taps[2 * C + c] * Hs[(size_t)(r + d * V) * C + c];
      }
      st[c] = val;
      s1 += val;
      s2 += val * val;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mean = s1 / C;
    const float rs = rsqrtf(fmaxf(s2 / C - mean * mean, 0.0f) + kEps);
    const bool valid = f < la;
    float* zr = z + (((size_t)b * T + f) * V + v) * C;
    for (int c = lane; c < C; c += 32) {
      const float zz = (st[c] - mean) * rs * P[L.lnfs + c] + P[L.lnfb + c];
      zr[c] = valid ? fmaxf(zz, 0.0f) : 0.0f;
    }
  }
  __syncthreads();  // this block's z rows are visible to the whole block

  // ---- Phase C: per-frame joint means and per-tile joint sums of z.
  for (int idx = tid; idx < TTe * C; idx += kThreads) {
    const int fl = idx / C, c = idx % C;
    const float* zf = z + (((size_t)b * T + t0 + fl) * V) * C + c;
    float s = 0.0f;
    for (int v = 0; v < V; ++v) s += zf[(size_t)v * C];
    tpool[((size_t)b * T + t0 + fl) * C + c] = s / V;
  }
  for (int idx = tid; idx < V * C; idx += kThreads) {
    const int v = idx / C, c = idx % C;
    float s = 0.0f;
    for (int fl = 0; fl < TTe; ++fl) s += z[(((size_t)b * T + t0 + fl) * V + v) * C + c];
    vpart[(((size_t)b * ntiles + tile) * V + v) * C + c] = s;
  }
}

__global__ void __launch_bounds__(kThreads) tail_gates_kernel(
    const int* __restrict__ la_arr, const float* __restrict__ P,
    const float* __restrict__ vpart, float* __restrict__ gate_c,
    float* __restrict__ gate_v, int V, int C, int M, int ntiles) {
  extern __shared__ float smem[];
  float* vs = smem;        // [V, C]
  float* s = vs + V * C;   // [C]
  float* h1 = s + C;       // [M]
  float* gc = h1 + M;      // [C]
  float* emb = gc + C;     // [V, M]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x;
  const float la = fmaxf((float)la_arr[b], 1.0f);
  const Layout L = make_layout(C, M);

  for (int idx = tid; idx < V * C; idx += kThreads) {
    float a = 0.0f;
    for (int t = 0; t < ntiles; ++t) a += vpart[((size_t)b * ntiles + t) * V * C + idx];
    vs[idx] = a;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float a = 0.0f;
    for (int v = 0; v < V; ++v) a += vs[v * C + c];
    s[c] = a / (la * V);
  }
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    float a = P[L.cab1 + m];
    for (int c = 0; c < C; ++c) a += s[c] * P[L.caw1 + c * M + m];
    h1[m] = fmaxf(a, 0.0f);
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float a = P[L.cab2 + c];
    for (int m = 0; m < M; ++m) a += h1[m] * P[L.caw2 + m * C + c];
    gc[c] = sigmoidf_(a);
    gate_c[(size_t)b * C + c] = gc[c];
  }
  __syncthreads();
  for (int idx = tid; idx < V * C; idx += kThreads) vs[idx] = vs[idx] * gc[idx % C] / la;
  __syncthreads();
  for (int idx = tid; idx < V * M; idx += kThreads) {
    const int v = idx / M, m = idx % M;
    float a = 0.0f;
    for (int c = 0; c < C; ++c) a += vs[v * C + c] * P[L.wf + c * M + m];
    emb[idx] = a;
  }
  __syncthreads();
  for (int v = warp; v < V; v += kWarps) {
    float* e = emb + v * M;
    float s1 = 0.0f, s2 = 0.0f;
    for (int m = lane; m < M; m += 32) {
      s1 += e[m];
      s2 += e[m] * e[m];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mean = s1 / M;
    const float rs = rsqrtf(fmaxf(s2 / M - mean * mean, 0.0f) + kEps);
    for (int m = lane; m < M; m += 32) {
      const float u = (e[m] - mean) * rs * P[L.slns + m] + P[L.slnb + m];
      e[m] = fminf(fmaxf(u, -1.0f), 1.0f);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < V * C; idx += kThreads) {
    const int v = idx / C, c = idx % C;
    float a = P[L.bv + c];
    for (int m = 0; m < M; ++m) a += emb[v * M + m] * P[L.wv + m * C + c];
    gate_v[(size_t)b * V * C + idx] = sigmoidf_(a);
  }
}

__global__ void __launch_bounds__(kThreads) tail_apply_kernel(
    const float* __restrict__ P, const float* __restrict__ z,
    const float* __restrict__ tpool, const float* __restrict__ gate_c,
    const float* __restrict__ gate_v, float* __restrict__ out,
    int T, int V, int C, int M) {
  extern __shared__ float smem[];
  float* gc = smem;                  // [C]
  float* tp = gc + C;                // [kApplyFrames, C]; later the frame gate
  float* emb = tp + kApplyFrames * C;  // [kApplyFrames, M]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kApplyFrames;
  const int TTe = min(kApplyFrames, T - t0);
  const Layout L = make_layout(C, M);

  for (int c = tid; c < C; c += kThreads) gc[c] = gate_c[(size_t)b * C + c];
  __syncthreads();
  for (int idx = tid; idx < TTe * C; idx += kThreads) {
    const int fl = idx / C, c = idx % C;
    tp[idx] = tpool[((size_t)b * T + t0 + fl) * C + c] * gc[c];
  }
  __syncthreads();
  for (int idx = tid; idx < TTe * M; idx += kThreads) {
    const int fl = idx / M, m = idx % M;
    float a = 0.0f;
    for (int c = 0; c < C; ++c) a += tp[fl * C + c] * P[L.wf + c * M + m];
    emb[idx] = a;
  }
  __syncthreads();
  for (int fl = warp; fl < TTe; fl += kWarps) {
    float* e = emb + fl * M;
    float s1 = 0.0f, s2 = 0.0f;
    for (int m = lane; m < M; m += 32) {
      s1 += e[m];
      s2 += e[m] * e[m];
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float mean = s1 / M;
    const float rs = rsqrtf(fmaxf(s2 / M - mean * mean, 0.0f) + kEps);
    for (int m = lane; m < M; m += 32) {
      const float u = (e[m] - mean) * rs * P[L.slns + m] + P[L.slnb + m];
      e[m] = fminf(fmaxf(u, -1.0f), 1.0f);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < TTe * C; idx += kThreads) {
    const int fl = idx / C, c = idx % C;
    float a = P[L.bt + c];
    for (int m = 0; m < M; ++m) a += emb[fl * M + m] * P[L.wt + m * C + c];
    tp[idx] = sigmoidf_(a);
  }
  __syncthreads();
  const size_t base = ((size_t)b * T + t0) * V * C;
  for (int idx = tid; idx < TTe * V * C; idx += kThreads) {
    const int c = idx % C;
    const int v = (idx / C) % V;
    const int fl = idx / (V * C);
    out[base + idx] = z[base + idx] * gc[c] * tp[fl * C + c] * gate_v[((size_t)b * V + v) * C + c];
  }
}

}  // namespace

extern "C" int gcn_tail_layout_total(int C, int M) { return make_layout(C, M).total; }

extern "C" int gcn_tail_launch(const void* x, const void* la, const void* P,
                               const void* meta, void* z, void* tpool,
                               void* vpart, void* gate_c, void* gate_v,
                               void* out, int B, int T, int V, int C, int M,
                               int TT, int halo, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ntiles = (T + TT - 1) / TT;
  const size_t smem1 =
      sizeof(float) * ((size_t)C + 64 + (size_t)kStageRows * C + (size_t)(TT + 2 * halo) * V * C);
  cudaError_t err = cudaFuncSetAttribute(
      tail_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  tail_frames_kernel<<<dim3(ntiles, B), kThreads, smem1, st>>>(
      (const float*)x, (const int*)la, (const float*)P, (const int*)meta,
      (float*)z, (float*)tpool, (float*)vpart, T, V, C, M, TT, halo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem2 = sizeof(float) * ((size_t)V * C + 2 * C + M + (size_t)V * M);
  tail_gates_kernel<<<B, kThreads, smem2, st>>>(
      (const int*)la, (const float*)P, (const float*)vpart, (float*)gate_c,
      (float*)gate_v, V, C, M, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem3 = sizeof(float) * ((size_t)C + (size_t)kApplyFrames * (C + M));
  tail_apply_kernel<<<dim3((T + kApplyFrames - 1) / kApplyFrames, B), kThreads, smem3, st>>>(
      (const float*)P, (const float*)z, (const float*)tpool, (const float*)gate_c,
      (const float*)gate_v, (float*)out, T, V, C, M);
  return (int)cudaGetLastError();
}
