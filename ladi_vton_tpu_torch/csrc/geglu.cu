// GEGLU feed-forward for Hopper: y = (h * gelu(g)) @ W2 + b2, where
// [h, g] = x @ W1 + b1 is split in halves along the columns.
//
// Replaces the Pallas TPU kernel ladi_vton_tpu/ops/geglu.py
// _geglu_fwd_impl -> pl.pallas_call (_kernel).  Same arithmetic as that
// kernel's body: both products take bf16 operands with fp32
// accumulation, the biases and the gate run in fp32, and the gated
// activation is cast to bf16 before the second product.  The gate uses
// the exact erff, as the geglu_xla oracle does; the TPU kernel carried an
// Abramowitz-Stegun polynomial only because Pallas TPU has no erf.
//
// What bounds it on the H100: operations.  At the UNet's widths (rows x
// C -> 2I -> C with I = 4C) it is 2 * rows * C * 3I multiply-adds against
// a (rows, I) intermediate, well above the ~295 op/byte ridge, so the
// tensor cores bound it.
//
// Design: two tiled GEMM kernels whose products are nvcuda::wmma bf16
// 16x16x16 tiles in the kernel body (no cuBLAS).
//   A (proj): a 64 x 64 tile of the activation a = h * gelu(g).  Each
//     block accumulates the h columns [n0, n0+64) and the matching g
//     columns [I+n0, I+n0+64) side by side, so the epilogue finds h and g
//     of one column in the same thread with no reordering of W1; it adds
//     b1 in fp32, applies the gate and writes a in bf16.
//   B (out): y = a @ W2 + b2, 64 x 64 tiles, b2 added in fp32.
// Weights are used in PyTorch's Linear layout (out, in), read as
// column-major B operands.  The (rows, I) intermediate goes through
// device memory in this version.  Tiles step 32 deep along the
// contraction, so C = 320 (5 x 64) needs no multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDK = BK + 8;  // bf16 pitch of the shared tiles
constexpr int NW = 4;        // 2 x 2 warps, 32 x 32 each
constexpr int NT = NW * 32;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;

// ROWS x BK tile of a row-major (rows, K) matrix at (row0, k0); rows at or
// past `limit` are zero
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int K,
                                          int row0, int k0, int limit) {
  constexpr int VPR = BK / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * K
                                            + k0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDK + c) = val;
  }
}

__global__ void __launch_bounds__(NT)
geglu_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, bf16* __restrict__ a, int M,
                  int C, int I) {
  __shared__ __align__(128) bf16 Xs[BM * LDK];
  __shared__ __align__(128) bf16 Wh[BN * LDK];
  __shared__ __align__(128) bf16 Wg[BN * LDK];
  __shared__ __align__(128) float scratch[NW][2][16 * 16];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  Acc hacc[2][2], gacc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(hacc[i][j], 0.0f);
      wmma::fill_fragment(gacc[i][j], 0.0f);
    }

  for (int k0 = 0; k0 < C; k0 += BK) {
    load_rows<BM>(Xs, x, C, m0, k0, M);
    load_rows<BN>(Wh, w1, C, n0, k0, 2 * I);
    load_rows<BN>(Wg, w1, C, I + n0, k0, 2 * I);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA fa[2];
      FragB fh[2], fg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Xs + (wm * 32 + i * 16) * LDK + kk * 16,
                               LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fh[j], Wh + (wn * 32 + j * 16) * LDK + kk * 16,
                               LDK);
        wmma::load_matrix_sync(fg[j], Wg + (wn * 32 + j * 16) * LDK + kk * 16,
                               LDK);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(hacc[i][j], fa[i], fh[j], hacc[i][j]);
          wmma::mma_sync(gacc[i][j], fa[i], fg[j], gacc[i][j]);
        }
    }
    __syncthreads();
  }

  float* hs = scratch[warp][0];
  float* gs = scratch[warp][1];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(hs, hacc[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(gs, gacc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm * 32 + i * 16 + e / 16;
        const int col = n0 + wn * 32 + j * 16 + e % 16;
        if (row < M) {
          const float hv = hs[e] + b1[col];
          const float gv = gs[e] + b1[I + col];
          const float gelu = 0.5f * gv * (1.0f + erff(gv * 0.70710678118654752f));
          a[(int64_t)row * I + col] = __float2bfloat16(hv * gelu);
        }
      }
      __syncwarp();
    }
}

__global__ void __launch_bounds__(NT)
geglu_out_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ y, int M,
                 int I, int C) {
  __shared__ __align__(128) bf16 As[BM * LDK];
  __shared__ __align__(128) bf16 Ws[BN * LDK];
  __shared__ __align__(128) float scratch[NW][16 * 16];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < I; k0 += BK) {
    load_rows<BM>(As, a, I, m0, k0, M);
    load_rows<BN>(Ws, w2, I, n0, k0, C);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDK + kk * 16,
                               LDK);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ws + (wn * 32 + j * 16) * LDK + kk * 16,
                               LDK);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ys = scratch[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(ys, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm * 32 + i * 16 + e / 16;
        const int col = n0 + wn * 32 + j * 16 + e % 16;
        if (row < M)
          y[(int64_t)row * C + col] = __float2bfloat16(ys[e] + b2[col]);
      }
      __syncwarp();
    }
}

}  // namespace

extern "C" int ladi_geglu_proj(const void* x, const void* w1, const void* b1,
                               void* a, int M, int C, int I, void* stream) {
  dim3 grid(I / BN, (M + BM - 1) / BM);
  geglu_proj_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<bf16*>(a), M, C, I);
  return (int)cudaGetLastError();
}

extern "C" int ladi_geglu_out(const void* a, const void* w2, const void* b2,
                              void* y, int M, int I, int C, void* stream) {
  dim3 grid(C / BN, (M + BM - 1) / BM);
  geglu_out_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(y), M, I, C);
  return (int)cudaGetLastError();
}
