// LayerNorm over the last axis of bf16 rows, fp32 statistics.
//
// Replaces the Pallas TPU kernel in ladi_vton_tpu/ops/layer_norm.py:
// layer_norm_pallas (_ln_kernel).  Same arithmetic as it and as the
// layer_norm_xla oracle: fp32 mean, then the centred variance
// mean((x - mean)^2), out = (x - mean) * rsqrt(var + eps) * w + b, one
// rounding to bf16 at the end.
//
// What bounds it on the H100: bytes, and below a few MB the fixed cost of
// a launch.  A handful of operations per element against 2 bytes read and
// 2 written, so the floor is one read and one write of the rows at
// 3.35 TB/s (12288 x 320 at the UNet's level 0: 15.7 MB, about 4.7 us).
// The TPU kernel took (T, C) row tiles into VMEM and fell back to XLA when
// the row count was not a multiple of its tile.
//
// Design (ops/layer_norm.py layer_norm_plan picks every number):
// - L lanes per row (a power of two), V 16-byte vectors per lane, so a
//   warp holds 32 / L rows at once (a "row group").  Lane l of a row
//   takes vectors l, l + L, ..., l + (V-1) L: every load instruction
//   reads whole 128-byte lines, and at the path's widths L * V = C / 8
//   leaves no lane idle (C = 320: 8 x 5; 640: 16 x 5; 1024: 32 x 4;
//   1280: 32 x 5).  A statistic costs log2(L) shuffle rounds.
// - A lane covers the same columns of every row it handles, so it loads
//   its V vectors of weight and bias once, before the grid-dependency
//   wait, and keeps them packed (bf16 pairs) in registers across rows.
// - The row is read once into registers, as packed bf16, and widened to
//   fp32 in each of the three passes (sum, centred squares, affine).
//   Empty register barriers (opaque) between the passes keep the
//   compiler from holding widened copies instead: with weight and bias
//   that leaves 12 V registers of data, and ptxas fits every (L, V) in
//   the 128 registers of __launch_bounds__(256, 2) without spills (two
//   CTAs of 8 warps an SM; at three, V = 5 spilled and ran slower).
// - The grid is at most one resident wave; each warp walks the row groups
//   with a stride of all the grid's warps.
// - Programmatic dependent launch: the host launches with
//   cudaLaunchAttributeProgrammaticStreamSerialization, so the launch and
//   the prologue overlap the drain of the kernel before it;
//   griddepcontrol.wait comes before the first read of x, and
//   griddepcontrol.launch_dependents after the warp's last read of x.
//   Kernels after this one that are not launched that way keep stream
//   order.  Weight and bias are read before the wait: they must not be
//   written by the kernel just before this one on the stream (the towers
//   write their parameters only when they load them).
// Rows may have a stride (the adapter's CLS slice x[:, 0, :]); the last
// axis must be contiguous and 16-byte aligned.  Lanes past C / 8 vectors
// and rows past the last are masked, so any row count and any multiple
// of 8 up to 1280 channels work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxWarps = 8;
// CTAs of kMaxWarps warps that the launch bound keeps resident on an SM
// (layer_norm_plan's WARPS_PER_SM is their product)
constexpr int kMinBlocks = 2;

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// the low and high bf16 of a packed pair, widened to fp32 exactly
__device__ __forceinline__ float lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// round a pair to bf16 (nearest even), a in the low half
__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// An empty register barrier: the compiler must take v as changed here, so
// it neither keeps fp32 values widened from v before this point nor moves
// the widening of v above it.  Only the packed words stay live.
__device__ __forceinline__ void opaque(uint4& v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
}

template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int L, int V>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
ln_kernel(const bf16* x, const bf16* __restrict__ w,
          const bf16* __restrict__ b, bf16* out, int rows, int C,
          int64_t x_stride, float eps) {
  constexpr int R = 32 / L;  // rows a warp holds at once
  const int lane = threadIdx.x & 31;
  const int col = lane % L;  // the lane's first vector in its row
  const int slot = lane / L;  // the lane's row within the row group
  const int nvec = C >> 3;
  const float inv_c = 1.0f / (float)C;

  // prologue: this lane's columns of weight and bias, kept for every row
  uint4 wv[V], bv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = col + i * L;
    if (vi < nvec) {
      wv[i] = __ldg(reinterpret_cast<const uint4*>(w) + vi);
      bv[i] = __ldg(reinterpret_cast<const uint4*>(b) + vi);
    } else {
      wv[i] = bv[i] = make_uint4(0, 0, 0, 0);
    }
  }
  const int warps = gridDim.x * (blockDim.x >> 5);
  const int groups = (rows + R - 1) / R;
  int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);

  grid_dependency_wait();  // x is the output of the kernel before
  for (; g < groups; g += warps) {
    const int row = g * R + slot;
    const bool live = row < rows;
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + (int64_t)row * x_stride);
    uint4 xv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = col + i * L;
      xv[i] = (live && vi < nvec) ? xr[vi] : make_uint4(0, 0, 0, 0);
    }
    if (g + warps >= groups) launch_dependents();  // the last read of x

    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint32_t* u = reinterpret_cast<const uint32_t*>(&xv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += lo(u[j]) + hi(u[j]);
    }
    const float mean = row_sum<L>(sum) * inv_c;

#pragma unroll
    for (int i = 0; i < V; ++i) opaque(xv[i]);
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (col + i * L < nvec) {
        const uint32_t* u = reinterpret_cast<const uint32_t*>(&xv[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float d0 = lo(u[j]) - mean, d1 = hi(u[j]) - mean;
          sq += d0 * d0;
          sq += d1 * d1;
        }
      }
    }
    const float rstd = rsqrtf(row_sum<L>(sq) * inv_c + eps);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      opaque(xv[i]);
      opaque(wv[i]);
      opaque(bv[i]);
    }

    if (live) {
      uint4* orow = reinterpret_cast<uint4*>(out + (int64_t)row * C);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int vi = col + i * L;
        if (vi < nvec) {
          const uint32_t* u = reinterpret_cast<const uint32_t*>(&xv[i]);
          const uint32_t* uw = reinterpret_cast<const uint32_t*>(&wv[i]);
          const uint32_t* ub = reinterpret_cast<const uint32_t*>(&bv[i]);
          uint4 o;
          uint32_t* uo = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            uo[j] = pack((lo(u[j]) - mean) * rstd * lo(uw[j]) + lo(ub[j]),
                         (hi(u[j]) - mean) * rstd * hi(uw[j]) + hi(ub[j]));
          orow[vi] = o;
        }
      }
    }
  }
}

typedef void (*LnKernel)(const bf16*, const bf16*, const bf16*, bf16*, int,
                         int, int64_t, float);

// The (L, V) instantiations: every pair layer_norm_plan can pick for a
// multiple of 8 up to 1280 channels (the least L with V <= 5);
// tests/test_torch_port_ops.py holds the two to each other.
LnKernel ln_kernel_for(int lanes, int vectors) {
#define LN_CASE(L, V) \
  if (lanes == L && vectors == V) return ln_kernel<L, V>;
  LN_CASE(1, 1)
  LN_CASE(1, 2)
  LN_CASE(1, 3)
  LN_CASE(1, 4)
  LN_CASE(1, 5)
  LN_CASE(2, 3)
  LN_CASE(2, 4)
  LN_CASE(2, 5)
  LN_CASE(4, 3)
  LN_CASE(4, 4)
  LN_CASE(4, 5)
  LN_CASE(8, 3)
  LN_CASE(8, 4)
  LN_CASE(8, 5)
  LN_CASE(16, 3)
  LN_CASE(16, 4)
  LN_CASE(16, 5)
  LN_CASE(32, 3)
  LN_CASE(32, 4)
  LN_CASE(32, 5)
#undef LN_CASE
  return nullptr;
}

}  // namespace

// What stays the same between the calls of one LayerNorm: weight and bias
// (C bf16 values each, 16-byte aligned), C, eps, and whether to launch
// with programmatic stream serialization.  Prepared once by the wrapper.
struct LadiLnParams {
  const void* w;
  const void* b;
  int C;
  float eps;
  int pdl;
};

// x: rows of C bf16 at a stride of x_stride elements; out: contiguous
// (rows, C) bf16.  plan = lanes | vectors << 8 | warps << 16, with grid,
// from layer_norm_plan.  rows > 0.
extern "C" int ladi_layer_norm_fwd(const void* x, void* out, int rows,
                                   int64_t x_stride, const LadiLnParams* p,
                                   int plan, int grid, void* stream) {
  const LnKernel kernel = ln_kernel_for(plan & 0xff, (plan >> 8) & 0xff);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(32 * (plan >> 16));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p->pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x),
      static_cast<const bf16*>(p->w), static_cast<const bf16*>(p->b),
      static_cast<bf16*>(out), rows, p->C, x_stride, p->eps);
}
