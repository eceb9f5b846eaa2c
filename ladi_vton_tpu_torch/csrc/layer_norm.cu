// LayerNorm over the last axis of bf16 rows, fp32 statistics.
//
// Replaces the Pallas TPU kernel in ladi_vton_tpu/ops/layer_norm.py:
// layer_norm_pallas (_ln_kernel).  Same arithmetic as it and as the
// layer_norm_xla oracle: fp32 mean, then the centred variance
// mean((x - mean)^2), out = (x - mean) * rsqrt(var + eps) * w + b, one
// rounding to bf16 at the end.
//
// What bounds it on the H100: bytes.  A handful of operations per
// element against 2 bytes read and 2 written, so the floor is one read and
// one write of the rows at 3.35 TB/s (12288 x 320 at the UNet's level 0:
// 15.7 MB, about 4.7 us).  The TPU kernel took (T, C) row tiles into VMEM
// and fell back to XLA when the row count was not a multiple of its tile.
//
// Design: one warp per row, eight rows per 256-thread block.  Each lane
// holds up to VPT 16-byte vectors (8 bf16 each) of its row in registers,
// so the row is read once: warp-shuffle sums give the mean, then the
// centred variance from the same registers, then the normalised row is
// written with 16-byte stores.  Lanes past C/8 vectors and warps past the
// last row are masked, so any row count works (no fallback).  Weight and
// bias are read as the towers store them, bf16, and widened in registers:
// no per-call fp32 copies of the parameters.  Rows may have a stride (the
// adapter's CLS slice x[:, 0, :]); the last axis must be contiguous and
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
}

template <int VPT>
__global__ void __launch_bounds__(kThreads)
ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
          const bf16* __restrict__ b, bf16* __restrict__ out, int rows, int C,
          int64_t x_stride, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nvec = C / 8;
  const bf16* xr = x + (int64_t)row * x_stride;

  float v[VPT][8];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      load8(xr + vi * 8, v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[i][j];
    }
  }
  const float inv_c = 1.0f / (float)C;
  const float mean = warp_sum(sum) * inv_c;

  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    if (lane + i * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] -= mean;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_c + eps);

  bf16* orow = out + (int64_t)row * C;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = lane + i * 32;
    if (vi < nvec) {
      float wf[8], bf[8];
      load8(w + vi * 8, wf);
      load8(b + vi * 8, bf);
      uint4 u;
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(v[i][j] * rstd * wf[j] + bf[j]);
      *reinterpret_cast<uint4*>(orow + vi * 8) = u;
    }
  }
}

}  // namespace

// x: rows of C bf16 at a stride of x_stride elements; w, b: C bf16
// values; out: contiguous (rows, C) bf16.  C must be a multiple of 8 and
// at most 1280.
extern "C" int ladi_layer_norm_fwd(const void* x, const void* w,
                                   const void* b, void* out, int rows, int C,
                                   int64_t x_stride, float eps,
                                   void* stream) {
  if (rows == 0) return 0;
  const int vpt = (C / 8 + 31) / 32;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* bp = static_cast<const bf16*>(b);
  bf16* op = static_cast<bf16*>(out);
#define LN_CASE(N)                                                          \
  case N:                                                                   \
    ln_kernel<N><<<grid, kThreads, 0, s>>>(xp, wp, bp, op, rows, C, x_stride, \
                                           eps);                            \
    break;
  switch (vpt) {
    LN_CASE(1)
    LN_CASE(2)
    LN_CASE(3)
    LN_CASE(4)
    LN_CASE(5)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LN_CASE
  return (int)cudaGetLastError();
}
