// Flash attention forward (non-causal) for Hopper, bf16 in and out.
//
// Replaces the Pallas TPU kernel ladi_vton_tpu/ops/flash_attention.py
// _flash_fwd_impl -> pl.pallas_call (_fwd_kernel): softmax(q k^T * scale) v
// over (batch*head, S, D) with an online softmax, so the (Sq, Sk) score
// matrix never reaches device memory.  As there, q is scaled in bf16
// before the first product (exact at D = 64, where the scale is 1/8), both
// products take bf16 operands with fp32 accumulation, and P is rounded to
// bf16 for the second product.
//
// What bounds it on the H100: at the UNet's self-attention shapes
// (S = 3072/768/192, D = 64) the two products are 4*S*S*D operations
// against 4*S*D bytes per head, far above the card's ~295 op/byte ridge,
// so the tensor cores bound it, and next to them the softmax's
// exponentials (one per score, on the 16-per-clock special-function
// units); at Sk = 77 (cross-attention) and S = 48 (mid block) the launch
// and the tile loads do.  At D = 512 (the VAE's single-head mid block) the
// problem is capacity: a 64-row fp32 output tile is 128 KB.
//
// Design (hopper.cuh has the PTX pieces): blocks of three warpgroups.
// Warpgroup 0 is the producer: one thread issues TMA copies of Q and of
// K/V tiles into rings of 128-byte-swizzled shared memory guarded by
// full/empty mbarriers, and the warpgroup gives its registers to the
// consumers (setmaxnreg).  The two consumer warpgroups run both products
// as wgmma with the accumulators in registers:
//   D = 64: persistent, at most one block per SM, each walking work items
//     (a 128-row q tile of one batch * head, q tiles fastest) with a
//     two-stage Q ring and a three-stage K/V ring (128-row tiles) that
//     runs on across items, so an item's loads overlap the previous one's
//     products and epilogue.  Each consumer owns 64 q rows.  S = Q K^T is
//     m64n128k16 from shared memory (K is K-major, wgmma's native B); the
//     online softmax runs on the accumulator registers (each thread holds
//     parts of two rows: two quad shuffles per row statistic, exp2 with a
//     prescaled max); P is packed to bf16 in registers and is the A
//     operand of O += P V (m64n64k16, V read MN-major with the transpose
//     bit); O (32 fp32 per thread) is rescaled in registers.  S of tile i
//     is issued before P V of tile i-1, so the softmax of one tile runs
//     while the tensor cores finish the other's product.  A power-of-two
//     scale (1/8 here) is folded into the softmax's exponent, which gives
//     the bits of pre-scaling q in bf16; another scale pre-scales q in
//     shared memory.
//   D = 512: one block per 64-row q tile, a two-stage ring of 32-row K/V
//     tiles; each consumer owns one 256-wide half of D, for O (m64n256k16,
//     128 fp32 per thread) and for its part of S: each computes the
//     partial Q K^T over its half of D (m64n32k16), the two swap partials
//     through shared memory (double-buffered, one named barrier per tile)
//     and both run the same softmax on the full S, so neither recomputes
//     the other's product.  q is pre-scaled in shared memory.
// Ragged Sq and Sk need no padding: TMA fills rows past the end with
// zeros, the last K/V tile's columns past Sk are masked to -inf in S, and
// rows past Sq are not stored.  The tensor maps address q, k and v through
// their (batch, head, seq) strides (4-D maps over (B, S, H, D) views), so
// the projections' outputs need no copy; D must be contiguous and the
// strides multiples of 16 bytes.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInit = -1e30f;
constexpr int kThreads = 384;  // producer + two consumer warpgroups

struct OutStrides {
  int64_t b, h, s;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// q scaled in its own dtype (bf16 product, rounded), as the TPU kernel;
// `bytes` of the tile, by one warpgroup
__device__ __forceinline__ void prescale(unsigned char* tile, int bytes,
                                         int t, float scale) {
  const float s = __bfloat162float(__float2bfloat16(scale));
  for (int i = t * 16; i < bytes; i += 128 * 16) {
    uint4 val = *reinterpret_cast<uint4*>(tile + i);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * s);
    *reinterpret_cast<uint4*>(tile + i) = val;
  }
}

// Online softmax over one S tile in accumulator registers (R per thread,
// two rows): columns at or past `valid` are masked; m (raw max), l (this
// thread's partial row sum) and the rescale factor alpha are per row; k2
// takes a raw score to the exponent base 2 (log2(e), times the scale
// where it was not applied to q).
template <int R>
__device__ __forceinline__ void online_softmax(float (&s)[R], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2], int valid,
                                               int lane, float k2) {
  if (valid < 2 * R) {  // the tile has 2 * R columns
    const int cq = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (8 * (i / 4) + cq + (i & 1) >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < R; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2((m[r] - mx[r]) * k2);
    m[r] = mx[r];
    mx[r] *= k2;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s[i] = fast_exp2(fmaf(s[i], k2, -mx[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// P (bf16) of k-step kk as the A operand of an RS wgmma
template <int R>
__device__ __forceinline__ void pack_p(const float (&s)[R], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// O / l of a consumer's 64 rows, columns [col0, col0 + R / 2), as bf16
template <int R>
__device__ __forceinline__ void store_o(const float (&o)[R], float (&l)[2],
                                        bf16* ob, const OutStrides& os,
                                        int row0, int col0, int Sq, int t) {
  const int lane = t % 32;
  const int r0 = row0 + 16 * (t / 32) + lane / 4;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    bf16* dst = ob + (int64_t)row * os.s + col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
  }
}

// ------------------------------------------------------------ D = 64

namespace d64 {
constexpr int BQ = 128, BK = 128, ST = 3, QST = 2;
constexpr int Q_BYTES = 64 * 128;   // one consumer's 64 rows
constexpr int KV_BYTES = BK * 128;  // one K or V tile
constexpr int K_OFF = QST * 2 * Q_BYTES;
constexpr int V_OFF = K_OFF + ST * KV_BYTES;
constexpr int BAR_OFF = V_OFF + ST * KV_BYTES;
constexpr int SMEM = BAR_OFF + 128 + 1024;
}  // namespace d64

// Block j takes the work items (q tile, batch * head) j, j + grid, ...
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d64_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, OutStrides os, int H, int Sq,
                     int Sk, int items, float scale) {
  using namespace d64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + K_OFF;
  unsigned char* Vs = smem + V_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + QST;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const int n_tiles = (Sk + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < QST; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<40>();
    if (tid == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      int kv = 0;  // K/V tiles issued so far
      int j = 0;   // items issued so far
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int q0 = (item % q_tiles) * BQ;
        const int b = item / q_tiles / H;
        const int h = item / q_tiles % H;
        const int qs = j % QST;
        if (j >= QST) mbar_wait(&qempty[qs], ((j / QST) & 1) ^ 1);
        unsigned char* Qj = Qs + qs * 2 * Q_BYTES;
        mbar_expect_tx(&qfull[qs], 2 * Q_BYTES);
        tma_load_4d(Qj, &tq, &qfull[qs], 0, q0, h, b);
        tma_load_4d(Qj + Q_BYTES, &tq, &qfull[qs], 0, q0 + 64, h, b);
        for (int i = 0; i < n_tiles; ++i, ++kv) {
          const int s = kv % ST;
          if (kv >= ST) mbar_wait(&empty[s], ((kv / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * KV_BYTES);
          tma_load_4d(Ks + s * KV_BYTES, &tk, &full[s], 0, i * BK, h, b);
          tma_load_4d(Vs + s * KV_BYTES, &tv, &full[s], 0, i * BK, h, b);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int c = wg - 1;
    const int t = tid % 128;
    const int lane = t % 32;
    // A power-of-two scale (1/8 at D = 64) commutes exactly with the bf16
    // rounding of q and the fp32 sums, so it is applied to the scores in
    // the softmax instead, with the same bits; any other scale is applied
    // to q in shared memory first.
    const bool fold =
        scale > 0.0f && (__float_as_uint(scale) & 0x7FFFFFu) == 0;
    const float k2 = fold ? scale * kLog2e : kLog2e;
    float acc[32], sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    uint32_t p[BK / 16][4];
    int kv = 0;
    int j = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
      const int q0 = (item % q_tiles) * BQ;
      const int b = item / q_tiles / H;
      const int h = item / q_tiles % H;
      const int qs = j % QST;
      unsigned char* Qw = Qs + qs * 2 * Q_BYTES + c * Q_BYTES;
      mbar_wait(&qfull[qs], (j / QST) & 1);
      if (!fold) {
        prescale(Qw, Q_BYTES, t, scale);
        fence_proxy_async();
        bar_sync(1 + c, 128);
      }

#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      float m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f}, alpha[2];
      const uint64_t dq = desc(Qw, 0, 1024);

      // S of the item's K/V tile i, one wgmma group (32 bytes a step)
      auto issue_s = [&](int i) {
        const uint64_t dk = desc(Ks + ((kv + i) % ST) * KV_BYTES, 0, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
        wgmma_commit();
      };
      // O += P V of tile i (16 K rows = 2048 bytes a step)
      auto issue_pv = [&](int i) {
        const uint64_t dv =
            desc(Vs + ((kv + i) % ST) * KV_BYTES, KV_BYTES, 1024);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<1>(acc, p[kk], dv + 128 * kk, 1);
        wgmma_commit();
      };
      auto release = [&](int i) {
        if (t == 0) mbar_arrive(&empty[(kv + i) % ST]);
      };

      mbar_wait(&full[kv % ST], (kv / ST) & 1);
      wgmma_fence();
      issue_s(0);
      wgmma_wait<0>();
      fence_regs(sc);
      online_softmax(sc, m, l, alpha, Sk, lane, k2);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) pack_p(sc, kk, p[kk]);

      // Tile i's scores and softmax overlap tile i-1's P V on the tensor
      // cores: S_i is issued, then P_{i-1} V_{i-1}; the softmax of S_i
      // runs once S_i is done, while P V still runs; O is rescaled after.
      for (int i = 1; i < n_tiles; ++i) {
        mbar_wait(&full[(kv + i) % ST], ((kv + i) / ST) & 1);
        wgmma_fence();
        issue_s(i);
        issue_pv(i - 1);
        wgmma_wait<1>();
        fence_regs(sc);
        online_softmax(sc, m, l, alpha, Sk - i * BK, lane, k2);
        wgmma_wait<0>();
        fence_regs(acc);
        keep_regs(p);  // P_{i-1} stays live until its product is done
        release(i - 1);
#pragma unroll
        for (int jj = 0; jj < 32; ++jj) acc[jj] *= alpha[(jj >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) pack_p(sc, kk, p[kk]);
      }
      wgmma_fence();
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      keep_regs(p);
      release(n_tiles - 1);
      if (t == 0) mbar_arrive(&qempty[qs]);
      kv += n_tiles;
      store_o(acc, l, o + b * os.b + h * os.h, os, q0 + 64 * c, 0, Sq, t);
    }
  }
}

// ------------------------------------------------------------ D = 512

namespace d512 {
constexpr int BQ = 64, BK = 32, ST = 2;
constexpr int Q_PANEL = 64 * 128;   // 64 rows x 64 columns
constexpr int KV_PANEL = BK * 128;  // BK rows x 64 columns
constexpr int KV_BYTES = 8 * KV_PANEL;
constexpr int K_OFF = 8 * Q_PANEL;
constexpr int V_OFF = K_OFF + ST * KV_BYTES;
constexpr int X_OFF = V_OFF + ST * KV_BYTES;  // partial-S exchange
constexpr int X_FLOATS = 128 * BK / 2;        // one warpgroup's partial
constexpr int BAR_OFF = X_OFF + 4 * X_FLOATS * 4;
constexpr int SMEM = BAR_OFF + 64 + 1024;
}  // namespace d512

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, OutStrides os, int H, int Sq,
                      int Sk, int items, float scale) {
  using namespace d512;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + K_OFF;
  unsigned char* Vs = smem + V_OFF;
  float* Xs = reinterpret_cast<float*>(smem + X_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // one item (q tile, batch * head) per block
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const int q0 = (blockIdx.x % q_tiles) * BQ;
  const int b = blockIdx.x / q_tiles / H;
  const int h = blockIdx.x / q_tiles % H;
  const int n_tiles = (Sk + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<40>();
    if (tid == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      mbar_expect_tx(qbar, 8 * Q_PANEL);
      for (int p = 0; p < 8; ++p)
        tma_load_4d(Qs + p * Q_PANEL, &tq, qbar, 64 * p, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        for (int p = 0; p < 8; ++p) {
          tma_load_4d(Ks + s * KV_BYTES + p * KV_PANEL, &tk, &full[s], 64 * p,
                      i * BK, h, b);
          tma_load_4d(Vs + s * KV_BYTES + p * KV_PANEL, &tv, &full[s], 64 * p,
                      i * BK, h, b);
        }
      }
    }
  } else {
    reg_alloc<232>();
    const int hw = wg - 1;  // which half of D this warpgroup owns
    const int t = tid % 128;
    const int lane = t % 32;
    mbar_wait(qbar, 0);
    prescale(Qs + hw * 4 * Q_PANEL, 4 * Q_PANEL, t, scale);
    fence_proxy_async();
    bar_sync(1 + hw, 128);

    float acc[128], sc[16];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.0f;
    float m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f}, alpha[2];

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      mbar_wait(&full[s], (i / ST) & 1);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int panel = 4 * hw + p;
        const uint64_t dq = desc(Qs + panel * Q_PANEL, 0, 1024);
        const uint64_t dk =
            desc(Ks + s * KV_BYTES + panel * KV_PANEL, 0, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(sc, dq + 2 * kk, dk + 2 * kk, (p | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // S = the sum of the two halves' partial products (the same bits in
      // both warpgroups: one addition, which commutes); thread t of each
      // warpgroup holds the same elements, so the swap needs no reordering
      float* mine = Xs + ((i & 1) * 2 + hw) * X_FLOATS;
      const float* other = Xs + ((i & 1) * 2 + 1 - hw) * X_FLOATS;
#pragma unroll
      for (int e = 0; e < 16; ++e) mine[e * 128 + t] = sc[e];
      bar_sync(3, 256);
#pragma unroll
      for (int e = 0; e < 16; ++e) sc[e] += other[e * 128 + t];

      online_softmax(sc, m, l, alpha, Sk - i * BK, lane, kLog2e);
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] *= alpha[(j >> 1) & 1];

      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) pack_p(sc, kk, p[kk]);
      const uint64_t dv =
          desc(Vs + s * KV_BYTES + 4 * hw * KV_PANEL, KV_PANEL, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<1>(acc, p[kk], dv + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(&empty[s]);
    }
    store_o(acc, l, o + b * os.b + h * os.h, os, q0, 256 * hw, Sq, t);
  }
}

// 4-D map over a (B, S, H, 64 * panels) view, strides in elements
cudaError_t make_qkv_map(CUtensorMap* map, const void* base, int B, int S,
                         int H, int D, int64_t sb, int64_t sh, int64_t ss,
                         int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)S, (uint64_t)H,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, (uint32_t)rows, 1, 1};
  return make_map(map, base, 4, dims, strides, box);
}

// one block per (q tile, batch * head) item, or, when `persistent`, at
// most one block per SM walking the items
template <typename Kernel>
cudaError_t launch(Kernel kern, int smem, uint64_t& smem_set, bool persistent,
                   int block_q, int rows_kv, const void* q, const void* k,
                   const void* v, bf16* o, int B, int H, int Sq, int Sk,
                   int D, const int64_t* st, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_qkv_map(&tq, q, B, Sq, H, D, st[0], st[1], st[2], 64)))
    return err;
  if ((err = make_qkv_map(&tk, k, B, Sk, H, D, st[3], st[4], st[5], rows_kv)))
    return err;
  if ((err = make_qkv_map(&tv, v, B, Sk, H, D, st[6], st[7], st[8], rows_kv)))
    return err;
  if ((err = allow_smem(kern, smem, smem_set))) return err;
  const OutStrides os{st[9], st[10], st[11]};
  const int q_tiles = (Sq + block_q - 1) / block_q;
  const int items = q_tiles * B * H;
  const int grid = persistent && items > sm_count() ? sm_count() : items;
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, o, os, H, Sq, Sk, items,
                                         scale);
  return cudaGetLastError();
}

}  // namespace

// strides: (batch, head, seq) of q, k, v and o in elements; block_q and
// block_k must be the tiling compiled for D (ops/flash_attention.py
// flash_tiling)
extern "C" int ladi_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int D, int64_t qb, int64_t qh, int64_t qs, int64_t kb,
    int64_t kh, int64_t ks, int64_t vb, int64_t vh, int64_t vs, int64_t ob,
    int64_t oh, int64_t os, float scale, int block_q, int block_k,
    void* stream) {
  const int64_t st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static uint64_t set64 = 0, set512 = 0;
  if (D == 64 && block_q == d64::BQ && block_k == d64::BK)
    return (int)launch(flash_fwd_d64_kernel, d64::SMEM, set64, true, d64::BQ,
                       d64::BK, q, k, v, op, B, H, Sq, Sk, D, st, scale, s);
  if (D == 512 && block_q == d512::BQ && block_k == d512::BK)
    return (int)launch(flash_fwd_d512_kernel, d512::SMEM, set512, false,
                       d512::BQ, d512::BK, q, k, v, op, B, H, Sq, Sk, D, st,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}
