// GroupNorm (+ optional SiLU) over channels-last (B, N, C) bf16 rows.
//
// Replaces the Pallas TPU kernels in ladi_vton_tpu/ops/group_norm.py:
// _group_norm_pallas_one_pass (_one_pass_kernel) and the two-pass
// group_norm_pallas (_stats_kernel + _apply_kernel).  Same arithmetic as
// both and as the group_norm_xla oracle: per-channel fp32 sum and sum of
// squares, combined per group, single-pass variance E[x^2] - mean^2,
// then x * a + b per channel (a = rstd * weight, b = bias - mean * a)
// and optionally SiLU.  Weight and bias are read as stored, bf16 or fp32.
//
// What bounds it on the H100: bytes.  A few operations per element against
// 2 bytes read and 2 written, so the floor is one read and one write of x
// at 3.35 TB/s (4.7 us for the UNet's (4, 3072, 320)).  The TPU kernel kept
// a whole (N, C) slab in VMEM, read it once and wrote it once.  A block has
// 227 KB of shared memory, and most UNet calls move 0.5-8 MB, so on this
// card the cost to beat is latency: the launch, dependent loads and every
// barrier between the read and the write (a cluster barrier with release
// semantics most of all).
//
// Cluster form, one launch (every tensor one wave of clusters can hold:
// the whole UNet, the VAE below 256x192).  Distributed shared memory
// stands in for VMEM.  A unit of work is one batch element and a range of
// whole groups (a multiple of lcm(8, C/G) channels, so 16-byte vectors never
// straddle a range or a group); a cluster of up to 8 CTAs splits the unit's
// rows.  Each CTA
//   1. copies its rows into shared memory with cp.async, 16 bytes a
//      thread, every copy in flight at once (four commit groups, summed as
//      they land); each thread keeps its own vector column and reads back
//      only what it copied, so no block barrier waits for the copies;
//   2. reduces per-channel sums and sums of squares: a shuffle tree over
//      the lanes of each column in the warp, then the warps in order;
//   3. pushes its partials into a slot of every cluster CTA's shared memory
//      (st.async, completing bytes on the receiver's mbarrier: no release
//      barrier on the path), then sums the slots in rank order (fixed, no
//      atomics; every CTA gets the same totals) into group mean and rstd;
//   4. normalises the rows it holds with weight and bias staged in shared
//      memory as stored, applies SiLU (see silu(): with one CTA a SM this
//      phase is bound by instructions) and writes them.
// So x is read once and written once, and no workspace is touched.
//
// Split form, two launches (the VAE's 512x384 and 256x192 slabs of up to
// 100 MB, and (4, 3072, 960), which no wave of clusters holds).  K3's
// counterpart:
//   1. statistics: grid (chunks of rows, B), four CTAs per SM in clusters
//      of 4 chunks; each thread keeps 8 loads in flight; per-CTA partials
//      are added across the cluster over DSMEM into a (B, chunks / 4, 2, C)
//      workspace; the last CTA of a batch element to finish (a counter it
//      resets) adds the cluster partials in a fixed order and writes the
//      (B, 2, C) affine;
//   2. apply: x * a + b (+ SiLU) with 4 loads in flight a thread, each
//      block walking its chunk backwards, so the rows the statistics pass
//      read last, still in L2, are read first.
// The second read of x is the third pass over memory; the floor of this
// form is 3 passes against the 2 of the bound.  Two split launches that
// share counters must not run concurrently: ops/group_norm.py keeps one
// set per stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// the most dynamic shared memory a block may take on sm_90
constexpr int kMaxSmem = 232448;

constexpr int kSplitCluster = 4;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// arrive without ordering memory: what follows reads nothing a peer wrote
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of `local`'s offset in the shared memory of cluster CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* local,
                                              uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(hopper::smem_addr(local)), "r"(rank));
  return remote;
}

__device__ __forceinline__ float ld_peer(const float* local, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(peer_addr(local, rank)) : "memory");
  return v;
}

// store v into a peer's shared memory, completing 4 bytes on its barrier
__device__ __forceinline__ void push_peer(uint32_t remote, float v,
                                          uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n"
      :: "r"(remote), "r"(__float_as_uint(v)), "r"(remote_bar) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
}

__device__ __forceinline__ float param(const void* p, int i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

__device__ __forceinline__ void accumulate(const uint4& u, float (&s)[8],
                                           float (&q)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    s[2 * j] += f.x;
    q[2 * j] = fmaf(f.x, f.x, q[2 * j]);
    s[2 * j + 1] += f.y;
    q[2 * j + 1] = fmaf(f.y, f.y, q[2 * j + 1]);
  }
}

// the oracle's x * sigmoid(x) = x / (1 + exp(-x)) in fp32, on the special
// function unit: __expf (2 + 1.173 |x| ulp) and __fdividef (2 ulp), so the
// result is within ~3e-6 relative of the exact value for |x| < 20 (and 0
// below -88, where exp(-x) overflows), against bf16's half ulp of 2^-9.
// expf and an IEEE division are some 20 instructions more an element,
// which the normalise phase of one CTA a SM cannot hide.
__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

__device__ __forceinline__ uint4 normalise(uint4 u, const float (&a)[8],
                                           const float (&b)[8], int act) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    float y0 = fmaf(f.x, a[2 * j], b[2 * j]);
    float y1 = fmaf(f.y, a[2 * j + 1], b[2 * j + 1]);
    if (act) {
      y0 = silu(y0);
      y1 = silu(y1);
    }
    h[j] = __floats2bfloat162_rn(y0, y1);
  }
  return u;
}

// Sums the per-thread s[8], q[8] of a block whose thread t owns vector
// column t % V and row lane t / V, over the lanes in a fixed order, into
// out[0, 8V) (sums) and out[8V, 16V) (squares), channel-major.  red holds
// 16 * T floats, red2 max(T, 16 V).
__device__ __forceinline__ void block_channel_sums(const float (&s)[8],
                                                   const float (&q)[8],
                                                   int V, float* red,
                                                   float* red2, float* out) {
  const int T = blockDim.x, tid = threadIdx.x, lanes = T / V;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[j * T + tid] = s[j];
    red[(8 + j) * T + tid] = q[j];
  }
  __syncthreads();
  const int K = 16 * V;
  const int P = max(1, T / K);  // lane slices summed side by side
  for (int i = tid; i < P * K; i += T) {
    const int k = i % K, p = i / K;
    const int j = k / V, v = k % V;
    const float* src = red + j * T + v;
    float acc = 0.0f;
    for (int l = p; l < lanes; l += P) acc += src[l * V];
    red2[p * K + k] = acc;
  }
  __syncthreads();
  for (int k = tid; k < K; k += T) {
    float acc = 0.0f;
    for (int p = 0; p < P; ++p) acc += red2[p * K + k];
    const int j = k / V, v = k % V;
    out[(j >= 8 ? 8 * V : 0) + v * 8 + (j & 7)] = acc;
  }
}

// Group mean and rstd from per-channel totals tot[0, n) (sums) and
// tot[n, 2n) (squares) of n / cg whole groups.
__device__ __forceinline__ void group_stats(const float* tot, int n, int cg,
                                            float count, float eps,
                                            float* mean, float* rstd) {
  for (int g = threadIdx.x; g < n / cg; g += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    for (int j = 0; j < cg; ++j) {
      s += tot[g * cg + j];
      q += tot[n + g * cg + j];
    }
    const float m = s / count;
    mean[g] = m;
    rstd[g] = 1.0f / sqrtf(q / count - m * m + eps);
  }
}

// Thread (warp w, lane l) of the cluster form owns vector column v = l % V
// of row lane l / V of its warp (lanes past (32 / V) * V hold nothing),
// so the lanes of one column sit V apart in the warp; V = rc / 8 is a
// template parameter, so no index needs a division at run time.  Shared
// memory (bytes), as ops/group_norm.py's plan computes it: rows * rc * 2
// (the rows) + 16 (the barrier) + 2 * rc * (2 or 4) (weight and bias as
// stored) + 4 * (cluster * 2 rc gathered partials + 2 * rc / cg group
// stats + warps * 2 rc).
template <int V>
__global__ void __launch_bounds__(512, 2)
gn_cluster_kernel(const bf16* __restrict__ x, const void* __restrict__ weight,
                  const void* __restrict__ bias, int w_f32,
                  bf16* __restrict__ out, int N, int C, int cg, float eps,
                  int act, int ranges, int rows_per_cta, int cluster) {
  constexpr int rc = 8 * V;
  constexpr int per_warp = 32 / V;  // rows a warp covers in one step
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool active = lane < per_warp * V;
  const int v = lane % V;
  const int first = warp * per_warp + lane / V;
  const int step = warps * per_warp;
  const uint32_t rank = cluster_rank();
  const int unit = blockIdx.x / cluster;
  const int b = unit / ranges;
  const int c0 = (unit - b * ranges) * rc;
  const int r0 = rank * rows_per_cta;
  const int rows = max(0, min(N - r0, rows_per_cta));
  const int gpr = rc / cg;

  uint4* data = reinterpret_cast<uint4*>(smem);  // [rows_per_cta][V]
  uint64_t* bar = reinterpret_cast<uint64_t*>(data + (size_t)rows_per_cta * V);
  uint4* params = reinterpret_cast<uint4*>(bar + 2);  // weight, then bias
  float* gather = reinterpret_cast<float*>(params + (w_f32 ? 4 : 2) * V);
  float* gmean = gather + cluster * 2 * rc;  // [gpr]
  float* grstd = gmean + gpr;                // [gpr]
  float* wpart = grstd + gpr;                // [warps][16][V]
  if (cluster > 1) {
    if (threadIdx.x == 0) {
      hopper::mbar_init(bar, 1);
      hopper::mbar_fence_init();
    }
    cluster_arrive_relaxed();  // waited for before the first push
  }

  const int64_t base = ((int64_t)b * N + r0) * C + c0 + v * 8;
  const bf16* src = x + base;
  const int mine = active && rows > first ? (rows - first + step - 1) / step : 0;
  const int per = (mine + 3) / 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i1 = min(mine, (k + 1) * per);
    for (int i = k * per; i < i1; ++i) {
      const int r = first + i * step;
      cp_async16(data + r * V + v, src + (int64_t)r * C);
    }
    if (k == 0) {
      // weight and bias of the range, as stored, in the first group
      const int n = (w_f32 ? 2 : 1) * V;
      for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
        const unsigned char* p = static_cast<const unsigned char*>(
            i < n ? weight : bias);
        cp_async16(params + i, p + (size_t)c0 * (w_f32 ? 4 : 2) +
                                   16 * (i < n ? i : i - n));
      }
    }
    cp_async_commit();
  }
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.0f;
  auto sum_part = [&](int k) {
    const int i1 = min(mine, (k + 1) * per);
    for (int i = k * per; i < i1; ++i)
      accumulate(data[(first + i * step) * V + v], s, q);
  };
  cp_async_wait<3>();
  sum_part(0);
  cp_async_wait<2>();
  sum_part(1);
  cp_async_wait<1>();
  sum_part(2);
  cp_async_wait<0>();
  sum_part(3);

  // the warp's lanes of one column, V apart, summed in a fixed tree
#pragma unroll
  for (int off = V; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float so = __shfl_down_sync(0xffffffffu, s[j], off);
      const float qo = __shfl_down_sync(0xffffffffu, q[j], off);
      if (lane + off < 32) {
        s[j] += so;
        q[j] += qo;
      }
    }
  }
  if (lane < V) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wpart[(warp * 16 + j) * V + lane] = s[j];
      wpart[(warp * 16 + 8 + j) * V + lane] = q[j];
    }
  }
  __syncthreads();
  // the CTA's partial of value k (sums, then squares, channel-major) goes
  // to slot `rank` of every CTA of the cluster, this one included
  if (cluster > 1) cluster_wait();  // every peer's barrier is initialised
  for (int k = threadIdx.x; k < 16 * V; k += blockDim.x) {
    const int j = k / V, col = k % V;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < 16; ++w)
      if (w < warps) acc += wpart[w * 16 * V + k];
    float* slot =
        gather + rank * 2 * rc + (j >= 8 ? rc : 0) + col * 8 + (j & 7);
    if (cluster == 1) {
      *slot = acc;
      continue;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (p < cluster) push_peer(peer_addr(slot, p), acc, peer_addr(bar, p));
  }
  if (cluster > 1) {
    cluster_arrive_relaxed();  // waited for at exit: peers push into us
    if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, cluster * 2 * rc * 4);
    hopper::mbar_wait(bar, 0);
  } else {
    __syncthreads();
  }
  // warp g: group g's channels over every CTA of the cluster, in rank order
  const float count = (float)N * (float)cg;
  for (int g = warp; g < gpr; g += warps) {
    float gs = 0.0f, gq = 0.0f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (p < cluster) {
          gs += gather[p * 2 * rc + c];
          gq += gather[p * 2 * rc + rc + c];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      gs += __shfl_xor_sync(0xffffffffu, gs, off);
      gq += __shfl_xor_sync(0xffffffffu, gq, off);
    }
    if (lane == 0) {
      const float m = gs / count;
      gmean[g] = m;
      grstd[g] = 1.0f / sqrtf(gq / count - m * m + eps);
    }
  }
  __syncthreads();
  float a[8], sh[8];
  {
    const float* w32 = reinterpret_cast<const float*>(params);
    const bf16* w16 = reinterpret_cast<const bf16*>(params);
    int g = v * 8 / cg, left = cg - v * 8 % cg;  // channels left in group g
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = v * 8 + j;
      const float wj = w_f32 ? w32[c] : __bfloat162float(w16[c]);
      const float bj = w_f32 ? w32[rc + c] : __bfloat162float(w16[rc + c]);
      a[j] = grstd[g] * wj;
      sh[j] = bj - gmean[g] * a[j];
      if (--left == 0) {
        ++g;
        left = cg;
      }
    }
  }
  bf16* dst = out + base;
  for (int i = 0; i < mine; ++i) {
    const int r = first + i * step;
    *reinterpret_cast<uint4*>(dst + (int64_t)r * C) =
        normalise(data[r * V + v], a, sh, act);
  }
  if (cluster > 1) cluster_wait();  // no CTA leaves while a peer pushes
}

// Shared memory (bytes): 4 * (2C partials + 2C totals + 2G group stats +
// 16 T + max(T, 2C) reduction scratch).
__global__ void __launch_bounds__(512)
gn_split_stats_kernel(const bf16* __restrict__ x,
                      const void* __restrict__ weight,
                      const void* __restrict__ bias, int w_f32,
                      float* __restrict__ ws, unsigned* __restrict__ counters,
                      float* __restrict__ coeffs, int N, int C, int G,
                      float eps, int chunks, int rows_per_chunk) {
  extern __shared__ __align__(16) float sm[];
  const int TC = C / 8;
  const int T = blockDim.x;
  const int TR = T / TC;
  const int tid = threadIdx.x;
  const int tc = tid % TC;
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const uint32_t rank = cluster_rank();
  float* part = sm;            // [2C]
  float* tot = part + 2 * C;   // [2C]
  float* gmean = tot + 2 * C;  // [G]
  float* grstd = gmean + G;    // [G]
  float* red = grstd + G;      // [16][T]
  float* red2 = red + 16 * T;  // [max(T, 2C)]

  const int r1 = min(N, (chunk + 1) * rows_per_chunk);
  const bf16* src = x + (int64_t)b * N * C + tc * 8;
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.0f;
  int r = chunk * rows_per_chunk + tid / TC;
  for (; r + 7 * TR < r1; r += 8 * TR) {
    uint4 u[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      u[k] = __ldg(reinterpret_cast<const uint4*>(src + (int64_t)(r + k * TR) * C));
#pragma unroll
    for (int k = 0; k < 8; ++k) accumulate(u[k], s, q);
  }
  for (; r < r1; r += TR)
    accumulate(__ldg(reinterpret_cast<const uint4*>(src + (int64_t)r * C)), s,
               q);

  block_channel_sums(s, q, TC, red, red2, part);
  cluster_arrive();
  cluster_wait();
  // CTA `rank` adds slice `rank` of the 2C values over the cluster
  const int slice = 2 * C / kSplitCluster;
  const int clusters = chunks / kSplitCluster;
  float* wsb = ws + ((int64_t)b * clusters + chunk / kSplitCluster) * 2 * C;
  for (int k = rank * slice + tid; k < (int)(rank + 1) * slice; k += T) {
    float acc = 0.0f;
    for (int p = 0; p < kSplitCluster; ++p) acc += ld_peer(part + k, p);
    wsb[k] = acc;
  }
  cluster_arrive_relaxed();  // done reading the peers; waited for at exit
  __threadfence();
  int* last = reinterpret_cast<int*>(red);  // free since the cluster barrier
  __syncthreads();
  if (tid == 0) *last = atomicAdd(counters + b, 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (*last) {
    __threadfence();
    const float* w0 = ws + (int64_t)b * clusters * 2 * C;
    for (int k = tid; k < 2 * C; k += T) {
      // eight loads in flight, added in a fixed order
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
      for (int p0 = 0; p0 < clusters; p0 += 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (p0 + e < clusters)
            acc[e] += __ldcg(w0 + (int64_t)(p0 + e) * 2 * C + k);
      }
      float t = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) t += acc[e];
      tot[k] = t;
    }
    __syncthreads();
    const int cg = C / G;
    group_stats(tot, C, cg, (float)N * (float)cg, eps, gmean, grstd);
    __syncthreads();
    float* cb = coeffs + (int64_t)b * 2 * C;
    for (int c = tid; c < C; c += T) {
      const int g = c / cg;
      const float a = grstd[g] * param(weight, c, w_f32);
      cb[c] = a;
      cb[C + c] = param(bias, c, w_f32) - gmean[g] * a;
    }
    if (tid == 0) counters[b] = 0u;
  }
  cluster_wait();
}

__global__ void __launch_bounds__(512)
gn_split_apply_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ coeffs, bf16* __restrict__ out,
                      int N, int C, int act, int rows_per_chunk) {
  const int TC = C / 8;
  const int TR = blockDim.x / TC;
  const int tc = threadIdx.x % TC;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_chunk;
  const float* cb = coeffs + (int64_t)b * 2 * C + tc * 8;
  float a[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = cb[j];
    sh[j] = cb[C + j];
  }
  const int64_t off = (int64_t)b * N * C + tc * 8;
  const bf16* src = x + off;
  bf16* dst = out + off;
  // backwards through the chunk: the statistics pass read its end last
  int r = min(N, r0 + rows_per_chunk) - 1 - (int)(threadIdx.x / TC);
  for (; r - 3 * TR >= r0; r -= 4 * TR) {
    uint4 u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      u[k] = __ldg(reinterpret_cast<const uint4*>(src + (int64_t)(r - k * TR) * C));
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<uint4*>(dst + (int64_t)(r - k * TR) * C) =
          normalise(u[k], a, sh, act);
  }
  for (; r >= r0; r -= TR)
    *reinterpret_cast<uint4*>(dst + (int64_t)r * C) = normalise(
        __ldg(reinterpret_cast<const uint4*>(src + (int64_t)r * C)), a, sh,
        act);
}

cudaLaunchAttribute cluster_attr(int size) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = size;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

typedef void (*ClusterKernel)(const bf16*, const void*, const void*, int,
                              bf16*, int, int, int, float, int, int, int,
                              int);

// the vector counts (channels per range / 8) the cluster form is built for;
// ops/group_norm.py's CLUSTER_VECTORS lists the same (a CPU test reads
// these cases and compares)
ClusterKernel cluster_kernel(int V) {
  switch (V) {
    case 1: return gn_cluster_kernel<1>;
    case 2: return gn_cluster_kernel<2>;
    case 10: return gn_cluster_kernel<10>;
    case 15: return gn_cluster_kernel<15>;
    case 30: return gn_cluster_kernel<30>;
    default: return nullptr;
  }
}

uint64_t cluster_smem_set[64] = {}, split_smem_set = 0;

}  // namespace

// x, out: (B, N, C) bf16; weight, bias: C values, fp32 if w_f32 else bf16,
// 16-byte aligned.  One launch of B * (C / rc) * cluster CTAs of `threads`
// threads (whole warps, at most 512) and `smem` bytes of dynamic shared
// memory; rc / 8 must be one of the vector counts instantiated below.
extern "C" int ladi_group_norm_cluster(const void* x, const void* weight,
                                       const void* bias, int w_f32, void* out,
                                       int B, int N, int C, int G, float eps,
                                       int act, int cluster, int rc,
                                       int rows_per_cta, int threads, int smem,
                                       void* stream) {
  if (C % G || C % rc || rc % 8 || rc % (C / G) || threads % 32 ||
      threads > 512 || smem > kMaxSmem || cluster < 1 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  ClusterKernel kern = cluster_kernel(rc / 8);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = hopper::allow_smem(kern, kMaxSmem,
                                       cluster_smem_set[rc / 8 % 64]);
  if (err != cudaSuccess) return (int)err;
  const int ranges = C / rc;
  cudaLaunchAttribute attr = cluster_attr(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * ranges * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const bf16*>(x), weight,
                           bias, w_f32, static_cast<bf16*>(out), N, C, C / G,
                           eps, act, ranges, rows_per_cta, cluster);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ws: (B, chunks / 4, 2, C) fp32; counters: B zeros, left zero; coeffs:
// (B, 2, C) fp32.  Two launches: statistics (chunks x B CTAs in clusters of
// 4) and apply.
extern "C" int ladi_group_norm_split(const void* x, const void* weight,
                                     const void* bias, int w_f32, void* ws,
                                     void* counters, void* coeffs, void* out,
                                     int B, int N, int C, int G, float eps,
                                     int act, int chunks, int rows_per_chunk,
                                     int threads, int smem, void* stream) {
  if (C % G || C % 8 || chunks % kSplitCluster || threads % (C / 8) ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      hopper::allow_smem(gn_split_stats_kernel, kMaxSmem, split_smem_set);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr = cluster_attr(kSplitCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_split_stats_kernel,
                           static_cast<const bf16*>(x), weight, bias, w_f32,
                           static_cast<float*>(ws),
                           static_cast<unsigned*>(counters),
                           static_cast<float*>(coeffs), N, C, G, eps, chunks,
                           rows_per_chunk);
  if (err != cudaSuccess) return (int)err;
  gn_split_apply_kernel<<<dim3(chunks, B), threads, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(coeffs),
      static_cast<bf16*>(out), N, C, act, rows_per_chunk);
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs (threads, smem bytes each) of the
// cluster-form kernel for rc channels (split = 0) or of the split
// statistics kernel (split = 1) the current device can hold at once; a
// negative CUDA error code on failure.
extern "C" int ladi_group_norm_max_clusters(int split, int rc, int cluster,
                                            int threads, int smem) {
  cudaLaunchAttribute attr = cluster_attr(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t err;
  if (split) {
    err = hopper::allow_smem(gn_split_stats_kernel, kMaxSmem, split_smem_set);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, gn_split_stats_kernel, &cfg);
  } else {
    ClusterKernel kern = cluster_kernel(rc / 8);
    if (kern == nullptr) return -(int)cudaErrorInvalidValue;
    err = hopper::allow_smem(kern, kMaxSmem, cluster_smem_set[rc / 8 % 64]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  }
  return err != cudaSuccess ? -(int)err : n;
}
