// GroupNorm (+ optional SiLU) over channels-last (B, N, C) bf16 rows.
//
// Replaces the Pallas TPU kernels in ladi_vton_tpu/ops/group_norm.py:
// _group_norm_pallas_one_pass (_one_pass_kernel) and the two-pass
// group_norm_pallas (_stats_kernel + _apply_kernel).  Same arithmetic as
// both and as the group_norm_xla oracle: per-channel fp32 sum and sum of
// squares, combined per group, single-pass variance E[x^2] - mean^2,
// then x * a + b per channel (a = rstd * weight, b = bias - mean * a)
// and optionally SiLU.
//
// What bounds it on the H100: bytes.  It does a few operations per
// element, so the floor is one read for the statistics plus one read and
// one write for the normalisation at 3.35 TB/s.  The TPU kernel kept a
// whole (N, C) slab in VMEM for one read; a 320-channel UNet slab is
// 2 MB and the VAE's 128 x 512 x 384 slab is 50 MB, far beyond a block's
// 227 KB of shared memory, and Hopper blocks run in no order, so the TPU's
// sequential-grid accumulation does not carry over.
//
// Design: three launches, no atomics, so results are deterministic.
//   1. stats: grid (row chunks, B).  Threads own 8 channels each (16-byte
//      loads along C) and stride over the chunk's rows; per-channel fp32
//      partial sums go to a (B, chunks, 2, C) workspace.
//   2. finalize: one block per batch element reduces the chunks, combines
//      channels into groups (C/G need not be a power of two: 10 at C=320)
//      and writes the per-channel affine (a, b) to (B, 2, C).
//   3. apply: an elementwise grid over 16-byte vectors, x * a + b, SiLU.
// The chunk count is chosen by the wrapper so stats has enough blocks to
// fill the card; the second read of x mostly hits the 50 MB L2 at UNet
// sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kStatsThreads = 256;

__global__ void gn_stats_kernel(const bf16* __restrict__ x,
                                float* __restrict__ ws, int N, int C,
                                int chunks) {
  extern __shared__ float red[];  // [2][TR][C]
  const int TC = C / 8;
  const int TR = blockDim.x / TC;
  const int tc = threadIdx.x % TC;
  const int tr = threadIdx.x / TC;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int rows = (N + chunks - 1) / chunks;
  const int r0 = chunk * rows;
  const int r1 = min(N, r0 + rows);
  const bf16* xb = x + (int64_t)b * N * C + tc * 8;

  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.0f;
  for (int r = r0 + tr; r < r1; r += TR) {
    uint4 v = *reinterpret_cast<const uint4*>(xb + (int64_t)r * C);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      s[j] += f;
      q[j] += f * f;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[tr * C + tc * 8 + j] = s[j];
    red[(TR + tr) * C + tc * 8 + j] = q[j];
  }
  __syncthreads();
  float* out = ws + ((int64_t)b * chunks + chunk) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float ss = 0.0f, qq = 0.0f;
    for (int t = 0; t < TR; ++t) {
      ss += red[t * C + c];
      qq += red[(TR + t) * C + c];
    }
    out[c] = ss;
    out[C + c] = qq;
  }
}

__global__ void gn_finalize_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ weight,
                                   const float* __restrict__ bias,
                                   float* __restrict__ coeffs, int N, int C,
                                   int G, int chunks, float eps) {
  extern __shared__ float sh[];  // [2][C] channel totals, [2][G] group stats
  const int b = blockIdx.x;
  const float* wb = ws + (int64_t)b * chunks * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      s += wb[(int64_t)k * 2 * C + c];
      q += wb[(int64_t)k * 2 * C + C + c];
    }
    sh[c] = s;
    sh[C + c] = q;
  }
  __syncthreads();
  const int cg = C / G;
  const float count = (float)N * (float)cg;
  float* g_mean = sh + 2 * C;
  float* g_rstd = g_mean + G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s = 0.0f, q = 0.0f;
    for (int j = 0; j < cg; ++j) {
      s += sh[g * cg + j];
      q += sh[C + g * cg + j];
    }
    const float mean = s / count;
    const float var = q / count - mean * mean;
    g_mean[g] = mean;
    g_rstd[g] = 1.0f / sqrtf(var + eps);
  }
  __syncthreads();
  float* cb = coeffs + (int64_t)b * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float a = g_rstd[g] * weight[c];
    cb[c] = a;
    cb[C + c] = bias[c] - g_mean[g] * a;
  }
}

__global__ void gn_apply_kernel(const bf16* __restrict__ x,
                                const float* __restrict__ coeffs,
                                bf16* __restrict__ out, int64_t total_vec,
                                int64_t NC, int C, int silu) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < total_vec; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e0 = i * 8;
    const int64_t b = e0 / NC;
    const int c0 = (int)(e0 % C);
    const float* a = coeffs + b * 2 * C + c0;
    const float* sh = a + C;
    uint4 v = *reinterpret_cast<const uint4*>(x + e0);
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __bfloat162float(e[j]) * a[j] + sh[j];
      if (silu) f = f * (1.0f / (1.0f + expf(-f)));
      e[j] = __float2bfloat16(f);
    }
    *reinterpret_cast<uint4*>(out + e0) = v;
  }
}

}  // namespace

extern "C" int ladi_group_norm_stats(const void* x, void* ws, int B, int N,
                                     int C, int chunks, void* stream) {
  const int TC = C / 8;
  const int TR = TC >= kStatsThreads ? 1 : kStatsThreads / TC;
  const size_t smem = sizeof(float) * 2 * TR * C;
  dim3 grid(chunks, B);
  gn_stats_kernel<<<grid, TC * TR, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float*>(ws), N, C, chunks);
  return (int)cudaGetLastError();
}

extern "C" int ladi_group_norm_finalize(const void* ws, const void* weight,
                                        const void* bias, void* coeffs, int B,
                                        int N, int C, int G, int chunks,
                                        float eps, void* stream) {
  const size_t smem = sizeof(float) * (2 * C + 2 * G);
  gn_finalize_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(coeffs), N, C, G,
      chunks, eps);
  return (int)cudaGetLastError();
}

extern "C" int ladi_group_norm_apply(const void* x, const void* coeffs,
                                     void* out, int B, int N, int C, int silu,
                                     void* stream) {
  const int64_t NC = (int64_t)N * C;
  const int64_t total_vec = (int64_t)B * NC / 8;
  const int threads = 256;
  int64_t blocks = (total_vec + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  gn_apply_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(coeffs),
      static_cast<bf16*>(out), total_vec, NC, C, silu);
  return (int)cudaGetLastError();
}
