// Flash attention forward (non-causal) for Hopper, bf16 in and out.
//
// Replaces the Pallas TPU kernel ladi_vton_tpu/ops/flash_attention.py
// _flash_fwd_impl -> pl.pallas_call (_fwd_kernel): softmax(q k^T * scale) v
// over (batch*head, S, D) with an online softmax, so the (Sq, Sk) score
// matrix never reaches device memory.
//
// What bounds it on the H100: at the UNet's self-attention shapes
// (S = 3072/768/192, D = 64) the two products are 4*S*S*D operations
// against 4*S*D bytes per head, far above the card's ~295 op/byte ridge,
// so the tensor cores bound it; at Sk = 77 (cross-attention) and S = 48
// (mid block) the launch and the tile loads do.  At D = 512 (the VAE's
// single-head mid block) the problem is capacity: a 64-row fp32 output
// accumulator is 128 KB, more than a 4-warp block's registers.
//
// Design: one block of 4 warps per (batch*head, q tile).  K and V stream
// through shared memory in BK-row tiles.  Both products are
// nvcuda::wmma bf16 16x16x16 tiles with fp32 accumulation.  The score
// tile S, the probabilities P (bf16) and the running output O (fp32) sit
// in dynamic shared memory, where the softmax threads can address rows:
// wmma fragments have no row layout a thread could rescale.  The ragged
// KV tail is masked inside the kernel (no padding to 128 as on the TPU),
// and q is scaled in bf16 before the first product, like the Pallas
// kernel (exact at D = 64, where the scale is 1/8).  D = 512 uses 32-row
// q tiles and keeps O in shared memory (~170 KB, set with
// cudaFuncSetAttribute).  The TPU's full-KV single pass is a VMEM design
// and is not carried over.  Inputs are addressed through (batch, head,
// seq) strides, so (B, S, H, D) views straight out of the projections
// need no copy; D must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int D, int BQ, int BK, int NW>
struct FlashCfg {
  static constexpr int NT = NW * 32;
  static constexpr int TPR = NT / BQ;  // softmax threads per q row
  static constexpr int LDB = D + 8;    // bf16 pitch of the Q/K/V tiles
  static constexpr int LDO = D + 4;    // fp32 pitch of O
  static constexpr int LDS = BK + 4;   // fp32 pitch of S
  static constexpr int LDP = BK + 8;   // bf16 pitch of P
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + align128(sizeof(bf16) * BQ * LDB);
  static constexpr size_t V_OFF = K_OFF + align128(sizeof(bf16) * BK * LDB);
  static constexpr size_t O_OFF = V_OFF + align128(sizeof(bf16) * BK * LDB);
  static constexpr size_t S_OFF = O_OFF + align128(sizeof(float) * BQ * LDO);
  static constexpr size_t P_OFF = S_OFF + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t M_OFF = P_OFF + align128(sizeof(bf16) * BQ * LDP);
  static constexpr size_t L_OFF = M_OFF + align128(sizeof(float) * BQ);
  static constexpr size_t BYTES = L_OFF + align128(sizeof(float) * BQ);
  static_assert(NT % BQ == 0 && TPR <= 32 && (TPR & (TPR - 1)) == 0,
                "softmax rows must map onto power-of-two lane groups");
  static_assert(D % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "wmma tiles");
};

// rows [row0, row0 + rows) of one (batch, head) slice into a shared tile,
// 16 bytes per thread per step; rows past `limit` are zero
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int64_t stride, int row0,
                                          int limit, float scale) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride
                                            + c);
      if (scale != 1.0f) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <int D, int BQ, int BK, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                 int Sq, int Sk, Strides st, float scale) {
  using C = FlashCfg<D, BQ, BK, NW>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + C::Q_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + C::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + C::V_OFF);
  float* Os = reinterpret_cast<float*>(smem + C::O_OFF);
  float* Ss = reinterpret_cast<float*>(smem + C::S_OFF);
  bf16* Ps = reinterpret_cast<bf16*>(smem + C::P_OFF);
  float* m_s = reinterpret_cast<float*>(smem + C::M_OFF);
  float* l_s = reinterpret_cast<float*>(smem + C::L_OFF);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  bf16* ob = o + b * st.ob + h * st.oh;

  // q scaled in its own dtype (bf16 product, rounded), as the TPU kernel
  const float scale_bf = __bfloat162float(__float2bfloat16(scale));
  load_tile<D, BQ, C::NT>(Qs, C::LDB, qb, st.qs, q0, Sq, scale_bf);
  for (int i = tid; i < BQ * C::LDO; i += C::NT) Os[i] = 0.0f;
  for (int i = tid; i < BQ; i += C::NT) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile's K/V/P/O reads are done
    load_tile<D, BK, C::NT>(Ks, C::LDB, kb, st.ks, k0, Sk, 1.0f);
    load_tile<D, BK, C::NT>(Vs, C::LDB, vb, st.vs, k0, Sk, 1.0f);
    __syncthreads();

    // S = Q K^T: K rows read as a column-major B operand
    for (int t = warp; t < (BQ / 16) * (BK / 16); t += NW) {
      const int tr = t / (BK / 16);
      const int tc = t % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + tr * 16 * C::LDB + kk * 16, C::LDB);
        wmma::load_matrix_sync(fb, Ks + tc * 16 * C::LDB + kk * 16, C::LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ss + tr * 16 * C::LDS + tc * 16, acc, C::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax: TPR neighbouring lanes share one q row
    {
      const int r = tid / C::TPR;
      const int sub = tid % C::TPR;
      const int valid = min(BK, Sk - k0);
      const float m_old = m_s[r];
      float mx = kNegInf;
      for (int c = sub; c < valid; c += C::TPR)
        mx = fmaxf(mx, Ss[r * C::LDS + c]);
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f;
      for (int c = sub; c < BK; c += C::TPR) {
        const float p = c < valid ? expf(Ss[r * C::LDS + c] - m_new) : 0.0f;
        Ps[r * C::LDP + c] = __float2bfloat16(p);
        sum += p;
      }
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int c = sub; c < D; c += C::TPR) Os[r * C::LDO + c] *= alpha;
      if (sub == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    // O += P V
    for (int t = warp; t < (BQ / 16) * (D / 16); t += NW) {
      const int tr = t / (D / 16);
      const int tc = t % (D / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      float* o_tile = Os + tr * 16 * C::LDO + tc * 16;
      wmma::load_matrix_sync(acc, o_tile, C::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Ps + tr * 16 * C::LDP + kk * 16, C::LDP);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * C::LDB + tc * 16, C::LDB);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(o_tile, acc, C::LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = tid; i < BQ * D; i += C::NT) {
    const int r = i / D;
    const int c = i % D;
    if (q0 + r < Sq)
      ob[(int64_t)(q0 + r) * st.os + c] =
          __float2bfloat16(Os[r * C::LDO + c] / l_s[r]);
  }
}

template <int D, int BQ, int BK, int NW>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int B, int H, int Sq, int Sk, const Strides& st,
                   float scale, cudaStream_t stream) {
  using C = FlashCfg<D, BQ, BK, NW>;
  auto kern = flash_fwd_kernel<D, BQ, BK, NW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, C::NT, C::BYTES, stream>>>(q, k, v, o, H, Sq, Sk, st, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ladi_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int D, int64_t qb, int64_t qh, int64_t qs, int64_t kb,
    int64_t kh, int64_t ks, int64_t vb, int64_t vh, int64_t vs, int64_t ob,
    int64_t oh, int64_t os, float scale, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64, 64, 64, 4>(qp, kp, vp, op, B, H, Sq, Sk, st,
                                        scale, s);
    case 512:
      return (int)launch<512, 32, 32, 4>(qp, kp, vp, op, B, H, Sq, Sk, st,
                                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
