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
// What bounds it on the H100: at the UNet's self-attention shapes the two
// products are 4*S*S*D operations against 4*S*D bytes per head, far above
// the card's ~295 op/byte ridge, so the tensor cores bound it, and next to
// them the softmax: one exponential a score on the special-function units,
// 16 a clock an SM (3.9e12 a second), which at D = 40 needs more time than
// the products.  At Sk = 77 (cross-attention) and S <= 192 the launch, the
// tile loads and how many SMs get work do.  At D = 512 (the VAE's
// single-head mid block) the problem is capacity: a 64-row fp32 output
// tile is 128 KB.
//
// Blocks of three warpgroups (hopper.cuh has the PTX pieces).  Warpgroup
// 0 is the producer: one thread issues TMA copies of Q and of K/V tiles
// into rings of swizzled shared memory guarded by full/empty mbarriers,
// and the warpgroup gives its registers to the consumers (setmaxnreg).
// The two consumer warpgroups run both products as wgmma with the
// accumulators in registers.  Three designs, by head dim:
//   D = 64 (flash_fwd_kernel): persistent, at most one block per SM, each
//     walking work items (a 128-row q tile of one batch * head, q tiles
//     fastest) with a two-stage Q ring and a three-stage ring of 128-row
//     K/V tiles that runs on across items.  Each consumer owns 64 q rows.
//     S = Q K^T is m64n128k16 from shared memory (K is K-major, wgmma's
//     native B); the online softmax runs on the accumulator registers
//     (each thread holds parts of two rows: two quad shuffles per row
//     statistic, exp2 with a prescaled max); P is packed to bf16 in
//     registers and is the A operand of O += P V (m64n64k16, V read
//     MN-major with the transpose bit).  S of tile i is issued before P V
//     of tile i-1, so the softmax of one tile runs while the tensor cores
//     finish the other's product.  The scale (1/8) is a power of two,
//     folded into the softmax's exponent, which gives the bits of
//     pre-scaling q in bf16.
//   D = 40, 80, 160 (flash_fwd_small_kernel, the SD-1.5 UNet's eight
//     heads at widths 320, 640, 1280): the same pipeline, fitted to these
//     widths (the plan: ops/flash_attention.py flash_plan).
//     - Columns: q, k and v arrive in 64-wide panels under the 128-byte
//       swizzle, then a narrow last panel of the rest: 16 columns under
//       the 32-byte swizzle at D = 80, 32 under the 64-byte one at D =
//       160 (D = 40: one 64-wide panel, its columns past 40 zero-filled
//       by TMA).  Q K^T's 16-deep k-steps stop at ceil(D / 16).
//     - P V at N = D: one product over the 64-wide panels (n40 at D = 40,
//       reading 40 of its panel's 64 columns; n64; n128 over two panels
//       at D = 160) and one n16 or n32 over the narrow panel, so O holds
//       D / 2 fp32 a thread (20, 40, 80), and D = 160 keeps 128-row K/V
//       tiles.
//     - Two consumers take turns on the tensor cores (two named
//       barriers; the three of D = 40's 192-row items do not): each
//       issues its S and P V in its turn and hands the turn over, so
//       one's softmax runs while the other's products do.
//       Of every 16 exponentials, kPolyShare run on the FMA pipes
//       (poly_exp2) and the rest on the special-function units.
//     - Sk <= 80 (the 77-token context) takes one S tile of n80, so a row
//       exponentiates 80 scores, not 128.
//     - Where 128-row items would leave SMs idle (the plan compares the
//       rounds of items over SMs), an item is 64 q rows: the two
//       consumers split its K/V tiles (every other one) and meet in
//       shared memory at the end, where consumer 0 merges (m, l, O).
//     - A scale that is not a power of two (40^-1/2, 80^-1/2, 160^-1/2)
//       pre-scales q in shared memory.
//   D = 512 (flash_fwd_d512_kernel): one block per 64-row q tile, a
//     two-stage ring of 32-row K/V tiles; each consumer owns one 256-wide
//     half of D, for O (m64n256k16, 128 fp32 per thread) and for its part
//     of S: each computes the partial Q K^T over its half of D
//     (m64n32k16), the two swap partials through shared memory
//     (double-buffered, one named barrier per tile) and both run the same
//     softmax on the full S, so neither recomputes the other's product.
//     q is pre-scaled in shared memory.
// Ragged Sq and Sk need no padding: TMA fills rows past the end with
// zeros, the last K/V tile's columns past Sk are masked to -inf in S, and
// rows past Sq are not stored.  Only the D columns of a head are stored
// (the 8 x 40 heads interleave in the output).  The tensor maps address
// q, k and v through their (batch, head, seq) strides (4-D maps over
// (B, S, H, D) views), so the projections' outputs need no copy; D must
// be contiguous and the strides multiples of 16 bytes.

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

// 2^x on the FMA pipes: 2^floor(x) built in the exponent bits times
// 1 + f (C1 + f (C2 + f C3)), f = x - floor(x) in [0, 1), the minimax
// cubic with p(0) = 1 (relative error 8.6e-5 = 2^-13.5 over [-126, 0] in
// fp32, far under bf16's half ulp of 2^-9).  floor(x) comes from adding
// 1.5 * 2^23 rounded down: the sum's low mantissa bits hold it, and a
// shift by 23 moves it into the exponent field.  x is clamped to -127, so
// -inf (a masked column) gives +0: f = 0 and p = 1 exactly.
constexpr float kExp2C1 = 0x1.63e66ap-1f;
constexpr float kExp2C2 = 0x1.d236c6p-3f;
constexpr float kExp2C3 = 0x1.3babb0p-4f;
constexpr float kExp2Shift = 0x1.8p23f;
constexpr float kExp2Min = -127.0f;

__device__ __forceinline__ float poly_exp2(float x) {
  x = fmaxf(x, kExp2Min);
  const float t = __fadd_rd(x, kExp2Shift);
  const float f = x - (t - kExp2Shift);
  const float p = fmaf(fmaf(fmaf(kExp2C3, f, kExp2C2), f, kExp2C1), f, 1.0f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
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

// 1 / l of a thread's two rows, from the quad's partial sums
__device__ __forceinline__ void row_inverse(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / l[r];
  }
}

// O / l of a consumer's 64 rows, columns [col0, col0 + min(R / 2,
// valid)), as bf16 (valid is a multiple of 8, so a column pair is whole)
template <int R>
__device__ __forceinline__ void store_o(const float (&o)[R],
                                        const float (&inv)[2], bf16* ob,
                                        const OutStrides& os, int row0,
                                        int col0, int valid, int Sq, int t) {
  const int lane = t % 32;
  const int r0 = row0 + 16 * (t / 32) + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    bf16* dst = ob + (int64_t)row * os.s + col0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      if (8 * j < valid)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r],
                                  o[4 * j + 2 * r + 1] * inv[r]);
  }
}

// ------------------------------------------------------------- D = 64

// The tiling of the D = 64 kernel: one 64-wide panel, 128 q rows (64 a
// consumer) against 128-row K/V tiles in a three-stage ring.
template <int D>
struct Panels {
  static_assert(D == 64, "D = 40, 80 and 160 take flash_fwd_small_kernel");
  static constexpr int NP = 1;      // 64-column panels
  static constexpr int KSTEPS = 4;  // 16-deep steps of Q K^T
  static constexpr int BQ = 128;
  static constexpr int BK = 128;
  static constexpr int ST = 3;                // K/V ring stages
  static constexpr int QST = 2;               // Q ring stages
  static constexpr int Q_PANEL = 64 * 128;    // one consumer's 64 rows
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_PANEL = BK * 128;
  static constexpr int KV_BYTES = NP * KV_PANEL;  // one K or V tile
  static constexpr int K_OFF = QST * 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + ST * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 128 + 1024;
};

// Block j takes the work items (q tile, batch * head) j, j + grid, ...
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, OutStrides os, int H, int Sq, int Sk,
                 int items, float scale) {
  using P = Panels<D>;
  constexpr int NP = P::NP, BQ = P::BQ, BK = P::BK, ST = P::ST,
                QST = P::QST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + P::K_OFF;
  unsigned char* Vs = smem + P::V_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
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
        unsigned char* Qj = Qs + qs * 2 * P::Q_BYTES;
        mbar_expect_tx(&qfull[qs], 2 * P::Q_BYTES);
        for (int c = 0; c < 2; ++c)
          for (int pn = 0; pn < NP; ++pn)
            tma_load_4d(Qj + c * P::Q_BYTES + pn * P::Q_PANEL, &tq,
                        &qfull[qs], 64 * pn, q0 + 64 * c, h, b);
        for (int i = 0; i < n_tiles; ++i, ++kv) {
          const int s = kv % ST;
          if (kv >= ST) mbar_wait(&empty[s], ((kv / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * P::KV_BYTES);
          for (int pn = 0; pn < NP; ++pn) {
            const int off = s * P::KV_BYTES + pn * P::KV_PANEL;
            tma_load_4d(Ks + off, &tk, &full[s], 64 * pn, i * BK, h, b);
            tma_load_4d(Vs + off, &tv, &full[s], 64 * pn, i * BK, h, b);
          }
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
    // the softmax instead, with the same bits; any other scale (D = 40,
    // 80, 160) is applied to q in shared memory first.
    const bool fold =
        scale > 0.0f && (__float_as_uint(scale) & 0x7FFFFFu) == 0;
    const float k2 = fold ? scale * kLog2e : kLog2e;
    float acc[NP][32], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    uint32_t p[BK / 16][4];
    int kv = 0;
    int j = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
      const int q0 = (item % q_tiles) * BQ;
      const int b = item / q_tiles / H;
      const int h = item / q_tiles % H;
      const int qs = j % QST;
      unsigned char* Qw = Qs + qs * 2 * P::Q_BYTES + c * P::Q_BYTES;
      mbar_wait(&qfull[qs], (j / QST) & 1);
      if (!fold) {
        prescale(Qw, P::Q_BYTES, t, scale);
        fence_proxy_async();
        bar_sync(1 + c, 128);
      }

#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[pn][i] = 0.0f;
      float m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f}, alpha[2];

      // S of the item's K/V tile i, one wgmma group (32 bytes a step
      // within a panel)
      auto issue_s = [&](int i) {
        const unsigned char* Kt = Ks + ((kv + i) % ST) * P::KV_BYTES;
#pragma unroll
        for (int ks = 0; ks < P::KSTEPS; ++ks) {
          const int pn = ks / 4, kk = ks % 4;
          wgmma_ss<0>(sc, desc(Qw + pn * P::Q_PANEL, 0, 1024) + 2 * kk,
                      desc(Kt + pn * P::KV_PANEL, 0, 1024) + 2 * kk, ks > 0);
        }
        wgmma_commit();
      };
      // O += P V of tile i, panel by panel (16 K rows = 2048 bytes a step)
      auto issue_pv = [&](int i) {
        const unsigned char* Vt = Vs + ((kv + i) % ST) * P::KV_BYTES;
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          const uint64_t dv = desc(Vt + pn * P::KV_PANEL, P::KV_PANEL, 1024);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs<1>(acc[pn], p[kk], dv + 128 * kk, 1);
        }
        wgmma_commit();
      };
      auto release = [&](int i) {
        if (t == 0) mbar_arrive(&empty[(kv + i) % ST]);
      };
      auto fence_acc = [&]() {
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) fence_regs(acc[pn]);
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
        fence_acc();
        keep_regs(p);  // P_{i-1} stays live until its product is done
        release(i - 1);
#pragma unroll
        for (int pn = 0; pn < NP; ++pn)
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) acc[pn][jj] *= alpha[(jj >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) pack_p(sc, kk, p[kk]);
      }
      wgmma_fence();
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      fence_acc();
      keep_regs(p);
      release(n_tiles - 1);
      if (t == 0) mbar_arrive(&qempty[qs]);
      kv += n_tiles;
      float inv[2];
      row_inverse(l, inv);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        store_o(acc[pn], inv, o + b * os.b + h * os.h, os, q0 + 64 * c,
                64 * pn, D - 64 * pn, Sq, t);
    }
  }
}

// ------------------------------------------------------ D = 40, 80, 160

constexpr int kSmemLimit = 232448;  // 227 KB of shared memory a block

constexpr int up1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// Of every 16 exponentials a consumer thread takes, the number that run on
// the FMA pipes (poly_exp2) beside the special-function units: fitted on
// the card (tools/sweep_k1_measures.py times 0, 2 and 4)
constexpr int kPolyShare = 2;

// The small kernel's online softmax: online_softmax's arithmetic, with
// each row's max and sum taken over four partial chains (short dependent
// chains: a tile's reductions are latency, not throughput)
template <int POLY, int R>
__device__ __forceinline__ void softmax_tile(float (&s)[R], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2], int valid,
                                             int lane, float k2) {
  if (valid < 2 * R) {  // the tile has 2 * R columns
    const int cq = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (8 * (i / 4) + cq + (i & 1) >= valid) s[i] = -INFINITY;
  }
  // register i is row (i >> 1) & 1; partial chain ((i >> 2) & 1) * 2 + (i & 1)
  float pm[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) pm[r][k] = m[r];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float& x = pm[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)];
    x = fmaxf(x, s[i]);
  }
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(pm[r][0], pm[r][1]), fmaxf(pm[r][2], pm[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2((m[r] - mx[r]) * k2);
    m[r] = mx[r];
    mx[r] *= k2;
  }
  float ps[2][4] = {};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float x = fmaf(s[i], k2, -mx[(i >> 1) & 1]);
    s[i] = i % 16 < POLY ? poly_exp2(x) : fast_exp2(x);
    ps[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
}

// Named barriers (0 is __syncthreads): 1 to 3 each consumer's prescaled
// Q; 4 both consumers' (split items); 5 and 6 the two consumers' turns on
// the special-function units; 7 the exchange of an item's key halves.
constexpr int kBarQ = 1, kBarQBoth = 4, kBarTurn = 5, kBarX = 7;

// The column panels of q, k and v at head dim D: 64-wide panels under the
// 128-byte swizzle, then a narrow last panel of the rest: 16 columns
// under the 32-byte swizzle at D = 80, 32 under the 64-byte one at D =
// 160.  D = 40 takes one 64-wide panel, its columns past 40 zero-filled by
// TMA.  Panel p of an R-row tile starts R * 128 * p bytes in.
template <int D>
struct Cols {
  static_assert(D == 40 || D == 80 || D == 160, "D = 40, 80 or 160");
  static constexpr int NP = (D + 63) / 64;
  static constexpr int LAST = D == 40 ? 64 : D % 64;  // last panel's columns
  static constexpr int ROW = 128 * (NP - 1) + 2 * LAST;  // bytes of a row
  static constexpr uint32_t LAST_SWIZZLE =
      LAST == 64 ? kSwizzle128 : LAST == 32 ? kSwizzle64 : kSwizzle32;
  static constexpr int LAST_SBO = 16 * LAST;  // 8 rows of the last panel
  static constexpr int KSTEPS = (D + 15) / 16;  // 16-deep steps of Q K^T
  // P V at N = D: one product over the 64-wide panels (n40 reads the
  // first 40 columns of D = 40's panel), one over the narrow last panel
  static constexpr int N0 = D == 40 ? 40 : 64 * (NP - 1);
  static constexpr int N1 = D == 40 ? 0 : LAST;
};

// One instantiation's tiling: BQ q rows an item, 64 a consumer (NC = 2 or
// 3 consumer warpgroups), or BQ = 64 split between two consumers by K/V
// tiles.  Shared memory: the Q ring, the K and V rings of BK-row tiles (as
// many stages as fit, at most 4), the split form's exchange of (O, m, l),
// the barriers.  Mirrored by ops/flash_attention.py flash_plan; a CPU
// test compiles Cols and Fit from this file and holds the two alike.
template <int D, int BK, int BQ>
struct Fit {
  using C = Cols<D>;
  static constexpr bool SPLIT = BQ == 64;
  static constexpr int NC = SPLIT ? 2 : BQ / 64;  // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);
  // registers a thread: the producer gives its own to the consumers
  static constexpr int PRODUCER_REGS = NC == 3 ? 32 : 40;
  static constexpr int CONSUMER_REGS = NC == 3 ? 160 : 232;
  // fp32 accumulators a consumer thread holds: S (BK / 2), O (D / 2) and
  // P packed to bf16 (BK / 4); at least 40 more registers stay for
  // addresses, row statistics and loop state
  static constexpr int ACC_REGS = BK / 2 + D / 2 + BK / 4;
  static_assert(ACC_REGS + 40 <= CONSUMER_REGS, "accumulator registers");
  // two consumers take turns on the softmax (on the card that gained at
  // items of one 80-row tile and at 128-row items, and cost nothing in
  // the split form: tools/sweep_k1_measures.py); three in a ring would
  // serialize three softmaxes a round
  static constexpr bool TURNS = NC == 2;
  // Q ring stages: items of one 80-row tile are short, so the producer
  // fetches four items ahead where they fit (two at D = 160)
  static constexpr int QST = D == 160 ? (BK == 80 ? 2 : 1) : BK == 80 ? 4 : 2;
  static constexpr int Q_BLOCK = 64 * C::ROW;   // one consumer's 64 rows
  static constexpr int Q_ITEM = (SPLIT ? 1 : NC) * Q_BLOCK;
  static constexpr int KV_BOX = BK * C::ROW;  // bytes TMA writes a tile
  static constexpr int KV_TILE = up1024(KV_BOX);
  static constexpr int X_BYTES = SPLIT ? 128 * (D / 2 + 4) * 4 : 0;
  static constexpr int FIXED = QST * Q_ITEM + X_BYTES + 128 + 1024;
  static constexpr int ST_FIT = (kSmemLimit - FIXED) / (2 * KV_TILE);
  static constexpr int ST = ST_FIT < 4 ? ST_FIT : 4;  // K/V ring stages
  static constexpr int K_OFF = QST * Q_ITEM;
  static constexpr int V_OFF = K_OFF + ST * KV_TILE;
  static constexpr int X_OFF = V_OFF + ST * KV_TILE;
  static constexpr int BAR_OFF = X_OFF + X_BYTES;
  static constexpr int SMEM = BAR_OFF + 128 + 1024;
  // a split consumer waits for its tile i while its tile i - 1 is still in
  // use: its tiles are two apart, so the ring needs more than two stages
  static_assert(ST >= (SPLIT ? 3 : 2), "K/V ring too shallow");
  static_assert(SMEM <= kSmemLimit, "shared memory");
};

// Block j takes the work items (q tile, batch * head) j, j + grid, ...: a
// BQ-row q tile (64 rows a consumer) or, SPLIT, a 64-row one whose K/V
// tiles the consumers share out.  Maps t*_last are the narrow last panel
// (at D = 40 the one 64-wide panel).
template <int D, int BK, int BQ>
__global__ void __launch_bounds__(Fit<D, BK, BQ>::THREADS, 1)
flash_fwd_small_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tq_last,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tk_last,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tv_last,
                       bf16* __restrict__ o, OutStrides os, int H, int Sq,
                       int Sk, int items, float scale) {
  using C = Cols<D>;
  using L = Fit<D, BK, BQ>;
  constexpr int NP = C::NP, ST = L::ST, QST = L::QST, NC = L::NC;
  constexpr bool kPingPong = L::TURNS;
  constexpr bool SPLIT = L::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + L::K_OFF;
  unsigned char* Vs = smem + L::V_OFF;
  float* X = reinterpret_cast<float*>(smem + L::X_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
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
      mbar_init(&empty[s], SPLIT ? 1 : NC);  // the consumers reading it
    }
    for (int s = 0; s < QST; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<L::PRODUCER_REGS>();
    if (tid == 0) {
      prefetch_map(&tq);
      prefetch_map(&tq_last);
      prefetch_map(&tk);
      prefetch_map(&tk_last);
      prefetch_map(&tv);
      prefetch_map(&tv_last);
      int kv = 0;  // K/V tiles issued so far
      int j = 0;   // items issued so far
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int q0 = (item % q_tiles) * BQ;
        const int b = item / q_tiles / H;
        const int h = item / q_tiles % H;
        const int qs = j % QST;
        if (j >= QST) mbar_wait(&qempty[qs], ((j / QST) & 1) ^ 1);
        unsigned char* Qj = Qs + qs * L::Q_ITEM;
        mbar_expect_tx(&qfull[qs], L::Q_ITEM);
        for (int c = 0; c < BQ / 64; ++c)
          for (int pn = 0; pn < NP; ++pn)
            tma_load_4d(Qj + c * L::Q_BLOCK + pn * 64 * 128,
                        pn < NP - 1 ? &tq : &tq_last, &qfull[qs], 64 * pn,
                        q0 + 64 * c, h, b);
        for (int i = 0; i < n_tiles; ++i, ++kv) {
          const int s = kv % ST;
          if (kv >= ST) mbar_wait(&empty[s], ((kv / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * L::KV_BOX);
          for (int pn = 0; pn < NP; ++pn) {
            const int off = s * L::KV_TILE + pn * BK * 128;
            tma_load_4d(Ks + off, pn < NP - 1 ? &tk : &tk_last, &full[s],
                        64 * pn, i * BK, h, b);
            tma_load_4d(Vs + off, pn < NP - 1 ? &tv : &tv_last, &full[s],
                        64 * pn, i * BK, h, b);
          }
        }
      }
    }
  } else {
    reg_alloc<L::CONSUMER_REGS>();
    const int c = wg - 1;
    const int t = tid % 128;
    const int lane = t % 32;
    // a power-of-two scale is folded into the softmax's exponent (the
    // same bits as scaling q in bf16); any other pre-scales q
    const bool fold =
        scale > 0.0f && (__float_as_uint(scale) & 0x7FFFFFu) == 0;
    const float k2 = fold ? scale * kLog2e : kLog2e;
    float o0[C::N0 / 2], o1[C::N1 > 0 ? C::N1 / 2 : 4], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    uint32_t p[BK / 16][4];
    // this consumer's K/V tiles of an item: all, or every other one from
    // the c-th (SPLIT, where the two take `rounds` turns an item)
    const int first = SPLIT ? c : 0, step = SPLIT ? 2 : 1;
    const int mine = SPLIT ? (n_tiles - c + 1) / 2 : n_tiles;
    const int rounds = SPLIT ? (n_tiles + 1) / 2 : n_tiles;
    if (kPingPong && c == 1) bar_arrive(kBarTurn, 256);  // 0 goes first
    int kv = 0;
    int j = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
      const int q0 = (item % q_tiles) * BQ;
      const int b = item / q_tiles / H;
      const int h = item / q_tiles % H;
      const int qs = j % QST;
      unsigned char* Qw = Qs + qs * L::Q_ITEM + (SPLIT ? 0 : c * L::Q_BLOCK);
      mbar_wait(&qfull[qs], (j / QST) & 1);
      if (!fold) {
        if (SPLIT) {  // the two scale halves of their shared 64 rows
          prescale(Qw + c * (L::Q_BLOCK / 2), L::Q_BLOCK / 2, t, scale);
          fence_proxy_async();
          bar_sync(kBarQBoth, 256);
        } else {
          prescale(Qw, L::Q_BLOCK, t, scale);
          fence_proxy_async();
          bar_sync(kBarQ + c, 128);
        }
      }

#pragma unroll
      for (int i = 0; i < C::N0 / 2; ++i) o0[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < C::N1 / 2; ++i) o1[i] = 0.0f;
      float m[2] = {kNegInit, kNegInit}, l[2] = {0.0f, 0.0f}, alpha[2];
      // the ring index of this consumer's i-th tile of the item
      auto tile = [&](int i) { return kv + first + step * i; };

      // S of tile i, one wgmma group (32 bytes a k-step within a panel)
      auto issue_s = [&](int i) {
        const unsigned char* Kt = Ks + (tile(i) % ST) * L::KV_TILE;
#pragma unroll
        for (int ks = 0; ks < C::KSTEPS; ++ks) {
          const int pn = ks / 4, kk = ks % 4;
          const bool last = pn == NP - 1;
          const uint32_t sbo = last ? C::LAST_SBO : 1024;
          const uint32_t swz = last ? C::LAST_SWIZZLE : kSwizzle128;
          wgmma_ss<0>(sc, desc(Qw + pn * 64 * 128, 16, sbo, swz) + 2 * kk,
                      desc(Kt + pn * BK * 128, 16, sbo, swz) + 2 * kk,
                      ks > 0);
        }
        wgmma_commit();
      };
      // O += P V of tile i: N0 columns over the 64-wide panels (LBO the
      // distance between them), N1 over the narrow one; a 16-deep step is
      // 16 V rows, twice SBO
      auto issue_pv = [&](int i) {
        const unsigned char* Vt = Vs + (tile(i) % ST) * L::KV_TILE;
        const uint64_t d0 = desc(Vt, BK * 128, 1024);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<1>(o0, p[kk], d0 + 128 * kk, 1);
        if constexpr (C::N1 > 0) {
          const uint64_t d1 = desc(Vt + (NP - 1) * BK * 128, BK * 128,
                                   C::LAST_SBO, C::LAST_SWIZZLE);
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs<1>(o1, p[kk], d1 + C::LAST_SBO / 8 * kk, 1);
        }
        wgmma_commit();
      };
      auto fence_o = [&]() {
        fence_regs(o0);
        if constexpr (C::N1 > 0) fence_regs(o1);
      };

      // the softmax of S_i in this consumer's turn on the special-function
      // units (two consumers, L::TURNS): they alternate, so one's
      // exponentials run while the other's products are on the tensor cores
      auto softmax = [&](int i) {
        fence_regs(sc);
        if (kPingPong) bar_sync(kBarTurn + c, 256);
        softmax_tile<kPolyShare>(sc, m, l, alpha,
                                 Sk - (first + step * i) * BK, lane, k2);
        if (kPingPong) bar_arrive(kBarTurn + 1 - c, 256);
      };
      auto pack = [&]() {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) pack_p(sc, kk, p[kk]);
      };
      auto release = [&](int i) {
        if (t == 0) mbar_arrive(&empty[tile(i) % ST]);
      };

      // S of tile i is issued before P V of tile i - 1, so the softmax of
      // S_i overlaps that product; O is rescaled once it is done.  Both
      // consumers take `rounds` turns an item.
      if (mine > 0) {
        mbar_wait(&full[tile(0) % ST], (tile(0) / ST) & 1);
        wgmma_fence();
        issue_s(0);
        wgmma_wait<0>();
        softmax(0);
        pack();
      }
      for (int i = 1; i < mine; ++i) {
        mbar_wait(&full[tile(i) % ST], (tile(i) / ST) & 1);
        wgmma_fence();
        issue_s(i);
        issue_pv(i - 1);
        wgmma_wait<1>();
        softmax(i);
        wgmma_wait<0>();
        fence_o();
        keep_regs(p);  // P_{i-1} stays live until its product is done
        release(i - 1);
#pragma unroll
        for (int e = 0; e < C::N0 / 2; ++e) o0[e] *= alpha[(e >> 1) & 1];
#pragma unroll
        for (int e = 0; e < C::N1 / 2; ++e) o1[e] *= alpha[(e >> 1) & 1];
        pack();
      }
      if (mine > 0) {
        wgmma_fence();
        issue_pv(mine - 1);
        wgmma_wait<0>();
        fence_o();
        keep_regs(p);
        release(mine - 1);
      }
      // a split consumer with a tile fewer still takes its turns
      for (int i = mine; kPingPong && i < rounds; ++i) {
        bar_sync(kBarTurn + c, 256);
        bar_arrive(kBarTurn + 1 - c, 256);
      }
      if (t == 0) mbar_arrive(&qempty[qs]);
      kv += n_tiles;

      if constexpr (SPLIT) {
        // the key halves meet: thread t of each consumer holds the same
        // rows and columns; consumer 0 merges and stores
        constexpr int XM = D / 2;  // (m, l) after O's D / 2 floats
        if (c == 1) {
#pragma unroll
          for (int e = 0; e < C::N0 / 2; ++e) X[e * 128 + t] = o0[e];
#pragma unroll
          for (int e = 0; e < C::N1 / 2; ++e)
            X[(C::N0 / 2 + e) * 128 + t] = o1[e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            X[(XM + r) * 128 + t] = m[r];
            X[(XM + 2 + r) * 128 + t] = l[r];
          }
        }
        bar_sync(kBarX, 256);
        if (c == 0) {
          float a0[2], a1[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m1 = X[(XM + r) * 128 + t];
            const float mx = fmaxf(m[r], m1);
            a0[r] = fast_exp2((m[r] - mx) * k2);
            a1[r] = fast_exp2((m1 - mx) * k2);
            l[r] = l[r] * a0[r] + X[(XM + 2 + r) * 128 + t] * a1[r];
          }
#pragma unroll
          for (int e = 0; e < C::N0 / 2; ++e)
            o0[e] = o0[e] * a0[(e >> 1) & 1] + X[e * 128 + t] * a1[(e >> 1) & 1];
#pragma unroll
          for (int e = 0; e < C::N1 / 2; ++e)
            o1[e] = o1[e] * a0[(e >> 1) & 1] +
                    X[(C::N0 / 2 + e) * 128 + t] * a1[(e >> 1) & 1];
        }
        bar_sync(kBarX, 256);  // X is free for the next item
        if (c == 1) continue;
      }
      float inv[2];
      row_inverse(l, inv);
      bf16* ob = o + b * os.b + h * os.h;
      const int row0 = q0 + (SPLIT ? 0 : 64 * c);
      // only the D columns of each head: at D = 40 the next head's
      // columns follow the 40th
      store_o(o0, inv, ob, os, row0, 0, C::N0, Sq, t);
      if constexpr (C::N1 > 0)
        store_o(o1, inv, ob, os, row0, C::N0, C::N1, Sq, t);
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
    float inv[2];
    row_inverse(l, inv);
    store_o(acc, inv, o + b * os.b + h * os.h, os, q0, 256 * hw, 256, Sq,
            t);
  }
}

// 4-D map over a (B, S, H, D) view, strides in elements: boxes of
// `width` columns (64, 32 or 16: the span of the 128-, 64- or 32-byte
// swizzle) by `rows`
cudaError_t make_qkv_map(CUtensorMap* map, const void* base, int B, int S,
                         int H, int D, int64_t sb, int64_t sh, int64_t ss,
                         int rows, int width = 64) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)S, (uint64_t)H,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)ss * 2, (uint64_t)sh * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {(uint32_t)width, (uint32_t)rows, 1, 1};
  return make_map(map, base, 4, dims, strides, box,
                  width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                  : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : CU_TENSOR_MAP_SWIZZLE_32B);
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

// the D = 64 kernel, persistent
int d64(uint64_t& smem_set, const void* q, const void* k, const void* v,
        bf16* o, int B, int H, int Sq, int Sk, const int64_t* st,
        float scale, int block_q, int block_k, cudaStream_t stream) {
  using P = Panels<64>;
  if (block_q != P::BQ || block_k != P::BK) return (int)cudaErrorInvalidValue;
  return (int)launch(flash_fwd_kernel<64>, P::SMEM, smem_set, true, P::BQ,
                     P::BK, q, k, v, o, B, H, Sq, Sk, 64, st, scale, stream);
}

// flash_fwd_small_kernel<D, BK, BQ>, persistent: the 64-wide and the
// last panel's maps of q (64 rows), k and v (BK rows)
template <int D, int BK, int BQ>
int small_launch(uint64_t& smem_set, const void* q, const void* k,
                 const void* v, bf16* o, int B, int H, int Sq, int Sk,
                 const int64_t* st, float scale, cudaStream_t stream) {
  using L = Fit<D, BK, BQ>;
  CUtensorMap maps[6];
  const void* base[3] = {q, k, v};
  const int seq[3] = {Sq, Sk, Sk}, rows[3] = {64, BK, BK};
  cudaError_t err;
  for (int x = 0; x < 3; ++x)
    for (int last = 0; last < 2; ++last)
      if ((err = make_qkv_map(&maps[2 * x + last], base[x], B, seq[x], H, D,
                              st[3 * x], st[3 * x + 1], st[3 * x + 2],
                              rows[x], last ? Cols<D>::LAST : 64)))
        return (int)err;
  auto kern = flash_fwd_small_kernel<D, BK, BQ>;
  if ((err = allow_smem(kern, L::SMEM, smem_set))) return (int)err;
  const OutStrides os{st[9], st[10], st[11]};
  const int items = (Sq + BQ - 1) / BQ * B * H;
  const int grid = items > sm_count() ? sm_count() : items;
  kern<<<grid, L::THREADS, L::SMEM, stream>>>(maps[0], maps[1], maps[2],
                                            maps[3], maps[4], maps[5], o, os,
                                            H, Sq, Sk, items, scale);
  return (int)cudaGetLastError();
}

// the plan's (block_q, block_k) at D = 40, 80, 160: 128-row items (192 at
// D = 40: three consumers) against 128- or (Sk <= 80) 80-row K/V tiles,
// or split 64-row items (64-row tiles at D = 160, whose four-stage ring
// then fits beside the exchange)
template <int D>
int small(uint64_t (&set)[3], const void* q, const void* k, const void* v,
          bf16* o, int B, int H, int Sq, int Sk, const int64_t* st,
          float scale, int block_q, int block_k, cudaStream_t stream) {
  constexpr int BQ = D == 40 ? 192 : 128;
  constexpr int SPLIT_BK = D == 160 ? 64 : 128;
  if (block_q == BQ && block_k == 128)
    return small_launch<D, 128, BQ>(set[0], q, k, v, o, B, H, Sq, Sk, st,
                                    scale, stream);
  if (block_q == 128 && block_k == 80)
    return small_launch<D, 80, 128>(set[1], q, k, v, o, B, H, Sq, Sk, st,
                                    scale, stream);
  if (block_q == 64 && block_k == SPLIT_BK)
    return small_launch<D, SPLIT_BK, 64>(set[2], q, k, v, o, B, H, Sq, Sk,
                                         st, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: (batch, head, seq) of q, k, v and o in elements; block_q and
// block_k must be a tiling compiled for D (ops/flash_attention.py
// flash_plan)
extern "C" int ladi_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int D, int64_t qb, int64_t qh, int64_t qs, int64_t kb,
    int64_t kh, int64_t ks, int64_t vb, int64_t vh, int64_t vs, int64_t ob,
    int64_t oh, int64_t os, float scale, int block_q, int block_k,
    void* stream) {
  const int64_t st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static uint64_t set64 = 0, set512 = 0, set_small[3][3] = {};
  switch (D) {
    case 40:
      return small<40>(set_small[0], q, k, v, op, B, H, Sq, Sk, st, scale,
                       block_q, block_k, s);
    case 64:
      return d64(set64, q, k, v, op, B, H, Sq, Sk, st, scale, block_q,
                 block_k, s);
    case 80:
      return small<80>(set_small[1], q, k, v, op, B, H, Sq, Sk, st, scale,
                       block_q, block_k, s);
    case 160:
      return small<160>(set_small[2], q, k, v, op, B, H, Sq, Sk, st, scale,
                        block_q, block_k, s);
  }
  if (D == 512 && block_q == d512::BQ && block_k == d512::BK)
    return (int)launch(flash_fwd_d512_kernel, d512::SMEM, set512, false,
                       d512::BQ, d512::BK, q, k, v, op, B, H, Sq, Sk, D, st,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}
