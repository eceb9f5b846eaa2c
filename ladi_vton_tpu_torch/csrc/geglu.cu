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
// tensor cores bound it; at the mid block (192 rows) the weights' bytes
// do.
//
// Design (hopper.cuh has the PTX pieces): one persistent GEMM kernel,
// instantiated per product, tile width and mode, then (for split-K) a
// small reduction.  A block has three warpgroups: a producer whose one
// thread keeps TMA copies of the A and B tiles (64 of the contraction
// deep) in flight through a ring of 128-byte-swizzled shared-memory stages
// (full/empty mbarriers), and two consumers that accumulate in registers
// with m64nBNk16 wgmma, one step's products in flight while the previous
// stage is released.  Blocks walk the output tiles with a stride of the
// grid, n fastest, so the blocks in flight share A rows in L2, and the
// producer runs ahead into the next tile.  Two modes:
//   ping-pong: the consumers take the block's 64-row tiles in turn (0, 2,
//     4, ... and 1, 3, 5, ...), and their main loops alternate (done
//     barriers), so one consumer's epilogue (the gate's erff, the stores)
//     overlaps the other's main loop.  Small row counts still fill the
//     card.
//   cooperative: both consumers share each 128-row tile, 64 rows each, so
//     a B tile feeds twice the rows; no epilogue overlap.  Measured faster
//     for the first product where its 128 x 256 tiles fill the card.
// The two products:
//   proj: A = x (rows, C), B = W1's rows [n0, n0 + BN/2) and
//     [I + n0, I + n0 + BN/2) side by side, so one accumulator holds h
//     and g of the same BN/2 columns, and in the accumulator layout
//     column j and j + BN/2 sit in the same thread: b1 is added in fp32,
//     the gate runs in registers and a = h * gelu(g) is stored in bf16,
//     with no scratch and no reordering of W1.
//   out: A = a (rows, I), B = W2 (C, I), ping-pong; b2 is added in fp32.
//     Where the output tiles would keep fewer than half the SMs busy
//     (rows <= 768 at C = 1280) the contraction is split: each split
//     writes fp32 partials and geglu_reduce_kernel adds them and b2 in a
//     fixed order.
// Tile widths and splits come from ops/geglu.py (geglu_proj_tiling,
// geglu_out_tiling).  Both operands are K-major, PyTorch's Linear layout
// (out, in), so no weight is repacked.  Biases are read in their stored
// dtype (bf16 or fp32) and widened in registers.  Ragged rows: TMA fills
// rows past the end with zeros and the epilogues store only rows < M.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int BK = 64;  // contraction per stage: one 128-byte swizzle row
constexpr int kThreads = 384;

enum Mode { PROJ = 0, OUT = 1 };

// BN: wgmma N, the B tile's rows.  COOP: both consumers share each
// 128-row tile (64 rows each) instead of taking 64-row tiles in turn.
template <int BN, bool COOP>
struct Cfg {
  static constexpr int BM = COOP ? 128 : 64;  // rows per tile
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // as many stages as 200 KB hold, at most 8
  static constexpr int ST = 200 * 1024 / STAGE < 8 ? 200 * 1024 / STAGE : 8;
  static constexpr int BAR_OFF = ST * STAGE;
  static constexpr int SMEM = BAR_OFF + (2 * ST + 2) * 8 + 1024;
  static_assert(STAGE % 1024 == 0, "stages start on swizzle atoms");
};

struct Args {
  int M;        // rows
  int N;        // output columns (proj: I; out: C)
  int I;        // proj: the first g row of W1
  int n_tiles;  // output tiles along N
  int m_tiles;
  int splits;   // contraction splits (out only)
  int k_steps;  // BK-deep steps per split
  const void* bias;
  int bias_fp32;
  bf16* out;
  float* partial;  // (splits, M, N) fp32 when splits > 1
};

__device__ __forceinline__ float load_bias(const void* b, int fp32, int i) {
  return fp32 ? static_cast<const float*>(b)[i]
              : __bfloat162float(static_cast<const bf16*>(b)[i]);
}

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
}

template <int MODE, int BN, bool COOP>
__global__ void __launch_bounds__(kThreads, 1)
geglu_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, Args g) {
  using C = Cfg<BN, COOP>;
  constexpr int ST = C::ST;
  constexpr int BM = C::BM;
  constexpr int A_BYTES = C::A_BYTES;
  constexpr int HALF = BN / 2;  // proj: a columns per tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* empty = full + ST;
  uint64_t* done = empty + ST;  // consumer c finished a main loop

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int total = g.m_tiles * g.n_tiles * g.splits;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], COOP ? 2 : 1);  // one per consumer of a tile
    }
    mbar_init(&done[0], 1);
    mbar_init(&done[1], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<40>();
    if (tid == 0) {
      prefetch_map(&ta);
      prefetch_map(&tb);
      int it = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int n = tile % g.n_tiles;
        const int m = (tile / g.n_tiles) % g.m_tiles;
        const int ks = tile / (g.n_tiles * g.m_tiles);
        for (int kk = 0; kk < g.k_steps; ++kk, ++it) {
          const int s = it % ST;
          if (it >= ST) mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
          const int kc = (ks * g.k_steps + kk) * BK;
          unsigned char* As = smem + s * C::STAGE;
          unsigned char* Bs = As + A_BYTES;
          mbar_expect_tx(&full[s], C::STAGE);
          tma_load_2d(As, &ta, &full[s], kc, m * BM);
          if constexpr (MODE == PROJ) {
            tma_load_2d(Bs, &tb, &full[s], kc, n * HALF);
            tma_load_2d(Bs + HALF * 128, &tb, &full[s], kc, g.I + n * HALF);
          } else {
            tma_load_2d(Bs, &tb, &full[s], kc, n * BN);
          }
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int c = wg - 1;
    const int t = tid % 128;
    const int lane = t % 32;
    const int cq = 2 * (lane % 4);
    // The block's tiles alternate between the consumers (q % 2 == c), and
    // so do their main loops: consumer c starts its n-th only after the
    // other finished the one before (done barriers).  The epilogue of one
    // thus overlaps the other's main loop, and every ring position before
    // a main loop's first has been consumed, so each full barrier is at
    // most one phase behind the position waited for.
    int q = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x, ++q) {
      if (!COOP) {
        if ((q & 1) != c) continue;
        const int nth = q / 2;
        if (c == 1) mbar_wait(&done[0], nth & 1);
        else if (nth > 0) mbar_wait(&done[1], (nth - 1) & 1);
      }
      const int n = tile % g.n_tiles;
      const int m = (tile / g.n_tiles) % g.m_tiles;
      const int ks = tile / (g.n_tiles * g.m_tiles);
      const int it0 = q * g.k_steps;  // the tile's first ring position
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int kk = 0; kk < g.k_steps; ++kk) {
        const int it = it0 + kk;
        const int s = it % ST;
        mbar_wait(&full[s], (it / ST) & 1);
        unsigned char* As = smem + s * C::STAGE;
        const uint64_t da = desc(As + (COOP ? c * 64 * 128 : 0), 0, 1024);
        const uint64_t db = desc(As + A_BYTES, 0, 1024);
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < BK / 16; ++k16)  // 32 bytes per step
          wgmma_ss<0>(acc, da + 2 * k16, db + 2 * k16, 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done
        if (kk > 0 && t == 0) mbar_arrive(&empty[prev]);
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) {
        mbar_arrive(&empty[prev]);
        if (!COOP) mbar_arrive(&done[c]);
      }

      const int r0 = m * BM + (COOP ? 64 * c : 0) + 16 * (t / 32) +
                     lane / 4;
      if constexpr (MODE == PROJ) {
        // h in accumulator columns [0, HALF), g in [HALF, BN)
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          const int col = n * HALF + 8 * j + cq;
          const float bh0 = load_bias(g.bias, g.bias_fp32, col);
          const float bh1 = load_bias(g.bias, g.bias_fp32, col + 1);
          const float bg0 = load_bias(g.bias, g.bias_fp32, g.I + col);
          const float bg1 = load_bias(g.bias, g.bias_fp32, g.I + col + 1);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r0 + 8 * r;
            if (row >= g.M) continue;
            const int jg = j + HALF / 8;
            const float a0 = (acc[4 * j + 2 * r] + bh0) *
                             gelu_erf(acc[4 * jg + 2 * r] + bg0);
            const float a1 = (acc[4 * j + 2 * r + 1] + bh1) *
                             gelu_erf(acc[4 * jg + 2 * r + 1] + bg1);
            *reinterpret_cast<__nv_bfloat162*>(
                g.out + (int64_t)row * g.N + col) =
                __floats2bfloat162_rn(a0, a1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n * BN + 8 * j + cq;
          if (g.splits == 1) {
            const float b0 = load_bias(g.bias, g.bias_fp32, col);
            const float b1 = load_bias(g.bias, g.bias_fp32, col + 1);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = r0 + 8 * r;
              if (row < g.M)
                *reinterpret_cast<__nv_bfloat162*>(
                    g.out + (int64_t)row * g.N + col) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r] + b0,
                                          acc[4 * j + 2 * r + 1] + b1);
            }
          } else {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = r0 + 8 * r;
              if (row < g.M)
                *reinterpret_cast<float2*>(
                    g.partial + ((int64_t)ks * g.M + row) * g.N + col) =
                    make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
            }
          }
        }
      }
    }
  }
}

// y = the splits' partials, added in split order, + b2; 4 columns a thread
__global__ void geglu_reduce_kernel(const float* __restrict__ partial,
                                    const void* __restrict__ bias,
                                    int bias_fp32, bf16* __restrict__ y,
                                    int M, int N, int splits) {
  const int64_t i =
      4 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  const int64_t count = (int64_t)M * N;
  if (i >= count) return;
  float4 sum = *reinterpret_cast<const float4*>(partial + i);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(partial + s * count + i);
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  const int col = (int)(i % N);
  __nv_bfloat162 lo = __floats2bfloat162_rn(
      sum.x + load_bias(bias, bias_fp32, col),
      sum.y + load_bias(bias, bias_fp32, col + 1));
  __nv_bfloat162 hi = __floats2bfloat162_rn(
      sum.z + load_bias(bias, bias_fp32, col + 2),
      sum.w + load_bias(bias, bias_fp32, col + 3));
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y + i) = packed;
}

// 2-D map over a row-major (rows, cols) bf16 matrix, box 64 x box_rows
cudaError_t make_matrix_map(CUtensorMap* map, const void* base, int rows,
                            int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return make_map(map, base, 2, dims, strides, box);
}

// A (a_rows, K) against B (b_rows, K), B boxes of b_box rows
template <int MODE, int BN, bool COOP>
cudaError_t launch_gemm(const void* a, int a_rows, int K, const void* b,
                        int b_rows, int b_box, Args& g, cudaStream_t stream) {
  using C = Cfg<BN, COOP>;
  CUtensorMap ta, tb;
  cudaError_t err = make_matrix_map(&ta, a, a_rows, K, C::BM);
  if (err != cudaSuccess) return err;
  err = make_matrix_map(&tb, b, b_rows, K, b_box);
  if (err != cudaSuccess) return err;
  auto kern = geglu_gemm_kernel<MODE, BN, COOP>;
  static uint64_t smem_set = 0;
  err = allow_smem(kern, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  g.m_tiles = (g.M + C::BM - 1) / C::BM;
  const int total = g.m_tiles * g.n_tiles * g.splits;
  const int grid = total < sm_count() ? total : sm_count();
  kern<<<grid, kThreads, C::SMEM, stream>>>(ta, tb, g);
  return cudaGetLastError();
}

}  // namespace

// a = h * gelu(g) with [h, g] = x @ w1^T + b1; x (M, C), w1 (2I, C),
// b1 (2I,) bf16 or fp32 (bias_fp32), a (M, I); C a multiple of 64; bn the
// accumulator width, bn / 2 columns of a per tile: 256 with 128-row
// tiles shared by both consumers, 128 with 64-row tiles taken in turn
extern "C" int ladi_geglu_proj(const void* x, const void* w1, const void* b1,
                               int bias_fp32, void* a, int M, int C, int I,
                               int bn, void* stream) {
  if (C % BK || (bn != 128 && bn != 256) || I % (bn / 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args g{M, I, I, I / (bn / 2), 0, 1, C / BK, b1, bias_fp32,
         static_cast<bf16*>(a), nullptr};
  return (int)(bn == 256
                   ? launch_gemm<PROJ, 256, true>(x, M, C, w1, 2 * I, 128, g, s)
                   : launch_gemm<PROJ, 128, false>(x, M, C, w1, 2 * I, 64, g,
                                                   s));
}

// y = a @ w2^T + b2; a (M, I), w2 (C, I), b2 (C,) bf16 or fp32, y (M, C);
// 64-row tiles taken in turn, bn (64, 128, 160 or 256) columns wide, bn
// dividing C; splits divides I / 64, and `partial` holds (splits, M, C)
// fp32 when splits > 1
extern "C" int ladi_geglu_out(const void* a, const void* w2, const void* b2,
                              int bias_fp32, void* y, void* partial, int M,
                              int I, int C, int bn, int splits,
                              void* stream) {
  if (I % BK || C % bn || splits < 1 || (I / BK) % splits ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args g{M, C, 0, C / bn, 0, splits, I / BK / splits, b2, bias_fp32,
         static_cast<bf16*>(y), static_cast<float*>(partial)};
  cudaError_t err;
  switch (bn) {
    case 64: err = launch_gemm<OUT, 64, false>(a, M, I, w2, C, 64, g, s); break;
    case 128:
      err = launch_gemm<OUT, 128, false>(a, M, I, w2, C, 128, g, s);
      break;
    case 160:
      err = launch_gemm<OUT, 160, false>(a, M, I, w2, C, 160, g, s);
      break;
    case 256:
      err = launch_gemm<OUT, 256, false>(a, M, I, w2, C, 256, g, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t quads = (int64_t)M * C / 4;
  geglu_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), b2, bias_fp32,
      static_cast<bf16*>(y), M, C, splits);
  return (int)cudaGetLastError();
}
