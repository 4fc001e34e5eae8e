// RMSNorm over the last axis with fp32 statistics: the forward and the
// backward (dx, and per-block partials of the scale's gradient).
//
// Replaces renderformer_tpu/ops/fused_norm.py:_fwd_kernel and :_bwd_kernel
// (reached through _fwd2d / _bwd2d).  Semantics are those of the Pallas
// kernels, on x [R, D] in bf16 or fp32 and the scale [D] in bf16 or fp32 (a
// template parameter of its own, read as it is given and widened to fp32 in
// registers, exactly: no cast of the scale before a launch):
//   * inv = rsqrt(sum(x*x)/D + eps), the sum in fp32;
//   * fp32: y = x*inv*s; bf16: y = bf16(bf16(x * bf16(inv)) * bf16(s)), two
//     roundings with inv cast first, the order of the XLA path;
//   * backward, with inv recomputed from x and gs = g*s, in fp32:
//     dx = gs*inv - x*(inv^3 * sum(gs*x)/D), cast to x's dtype, and
//     ds_part[block] = sum over the block's rows of g*(x*inv); the caller
//     sums the [n_blocks, D] partials, so no atomics and a deterministic ds.
// Rows past R in the last block are skipped by bounds, with no padding.
//
// Bound on this card: a few flops per element against 2 (forward) or 3
// (backward) passes over [R, D], far below the ~295 flop/byte ridge: memory
// bound.  Design: one warp per row, each lane reading 16 bytes at a time at
// columns (c*32 + lane)*VEC, so a warp's loads are contiguous; the row stays
// in registers between the sum of squares and the rescale, so x is read once.
// The forward issues its lane's scale loads (16 bytes at a time) with the
// row's, so that they are in flight together and not after the reduction.
// Blocks of 8 warps; the backward's warps walk rows_per_block/8 rows each,
// keep their columns' ds sums in registers, and add them across the block in
// shared memory in warp order.
#include <type_traits>

#include "common.cuh"

using namespace rf;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// N consecutive elements at p as fp32, by 16-byte loads, or one 8-byte load
// where N elements take 8 bytes (a bf16 scale beside fp32 x)
template <typename T, int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const T* p) {
  constexpr int PER = 16 / sizeof(T);
  if constexpr (N % PER == 0) {
#pragma unroll
    for (int c = 0; c < N / PER; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_float(e[i]);
    }
  } else {
    static_assert(N * sizeof(T) == 8, "a 16- or 8-byte multiple");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// MAXC: 16-byte chunks of x a lane holds, covering D <= MAXC * 32 * VEC; S
// the scale's type
template <typename T, typename S, int MAXC>
__global__ void __launch_bounds__(NTHREADS)
rms_norm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ y, int R, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * NWARPS + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + (size_t)row * D;
  float v[MAXC][VEC], sc[MAXC][VEC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < D) {
      load_vec<T, VEC>(v[c], xr + col);
      load_vec<S, VEC>(sc[c], scale + col);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if ((c * 32 + lane) * VEC < D) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(v[c][i], v[c][i], ss);
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)D + eps);
  const float inv_b = round_bf16(inv);
  T* yr = y + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < D) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (std::is_same<T, float>::value)
          o[i] = __fmul_rn(__fmul_rn(v[c][i], inv), sc[c][i]);
        else  // x and bf16(inv) are bf16 values: each product rounds once
          o[i] = __fmul_rn(round_bf16(__fmul_rn(v[c][i], inv_b)), round_bf16(sc[c][i]));
      }
      store_vec<T, VEC>(yr + col, o);
    }
  }
}

template <typename T, typename S, int MAXC>
__global__ void __launch_bounds__(NTHREADS)
rms_norm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ ds_part,
                    int R, int D, int rows_per_block, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float red[];  // [D]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float acc[MAXC][VEC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[c][i] = 0.f;

  const int row0 = blockIdx.x * rows_per_block;
  for (int rr = warp; rr < rows_per_block; rr += NWARPS) {
    const int row = row0 + rr;
    if (row >= R) break;
    const T* xr = x + (size_t)row * D;
    const T* gr = g + (size_t)row * D;
    float xv[MAXC][VEC], gv[MAXC][VEC];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < D) {
        load_vec<T, VEC>(xv[c], xr + col);
        load_vec<T, VEC>(gv[c], gr + col);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          ss = fmaf(xv[c][i], xv[c][i], ss);
          dot = fmaf(gv[c][i] * to_float(scale[col + i]), xv[c][i], dot);
        }
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float inv = rsqrtf(ss / (float)D + eps);
    const float coef = inv * inv * inv * (dot / (float)D);
    T* dxr = dx + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < D) {
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float gs = gv[c][i] * to_float(scale[col + i]);
          o[i] = __fsub_rn(__fmul_rn(gs, inv), __fmul_rn(xv[c][i], coef));
          acc[c][i] = fmaf(gv[c][i], __fmul_rn(xv[c][i], inv), acc[c][i]);
        }
        store_vec<T, VEC>(dxr + col, o);
      }
    }
  }

  // the block's ds partial: warps add their columns in turn
  for (int w = 0; w < NWARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int col = (c * 32 + lane) * VEC;
        if (col < D) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            red[col + i] = w == 0 ? acc[c][i] : red[col + i] + acc[c][i];
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < D; col += NTHREADS)
    ds_part[(size_t)blockIdx.x * D + col] = red[col];
}

// launch kernel K<T, S, MAXC> for the smallest MAXC in {1, 2, 4, 8, 16}
// whose registers hold a row
#define RF_DISPATCH_MAXC(T, S, LAUNCH)                                  \
  do {                                                                  \
    constexpr int VEC_ = 16 / sizeof(T);                                \
    if (D <= 1 * 32 * VEC_) { LAUNCH(T, S, 1); }                        \
    else if (D <= 2 * 32 * VEC_) { LAUNCH(T, S, 2); }                   \
    else if (D <= 4 * 32 * VEC_) { LAUNCH(T, S, 4); }                   \
    else if (D <= 8 * 32 * VEC_) { LAUNCH(T, S, 8); }                   \
    else if (D <= 16 * 32 * VEC_) { LAUNCH(T, S, 16); }                 \
    else return cudaErrorInvalidValue;                                  \
  } while (0)

// the four (x, scale) dtype pairs
#define RF_DISPATCH_DTYPES(LAUNCH)                                                  \
  do {                                                                              \
    if (dtype == kBF16 && scale_dtype == kBF16)                                     \
      RF_DISPATCH_MAXC(__nv_bfloat16, __nv_bfloat16, LAUNCH);                       \
    else if (dtype == kBF16 && scale_dtype == kF32)                                 \
      RF_DISPATCH_MAXC(__nv_bfloat16, float, LAUNCH);                               \
    else if (dtype == kF32 && scale_dtype == kBF16)                                 \
      RF_DISPATCH_MAXC(float, __nv_bfloat16, LAUNCH);                               \
    else if (dtype == kF32 && scale_dtype == kF32)                                  \
      RF_DISPATCH_MAXC(float, float, LAUNCH);                                       \
    else                                                                            \
      return cudaErrorInvalidValue;                                                 \
  } while (0)

}  // namespace

// x, y [R, D] (dtype), scale [D] (scale_dtype); D a multiple of 8
extern "C" int rf_rms_norm_fwd(const void* x, const void* scale, void* y, int dtype,
                               int scale_dtype, int R, int D, float eps, void* stream) {
  if (R <= 0 || D <= 0 || D % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + NWARPS - 1) / NWARPS);
#define RF_FWD(T, S, M)                                                                \
  rms_norm_fwd_kernel<T, S, M><<<grid, NTHREADS, 0, s>>>(                              \
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), R, D, eps)
  RF_DISPATCH_DTYPES(RF_FWD);
#undef RF_FWD
  return cudaGetLastError();
}

// x, g, dx [R, D] (dtype), scale [D] (scale_dtype), ds_part
// [ceil(R / rows_per_block), D] fp32; rows_per_block a multiple of 8
extern "C" int rf_rms_norm_bwd(const void* x, const void* scale, const void* g, void* dx,
                               void* ds_part, int dtype, int scale_dtype, int R, int D,
                               int rows_per_block, float eps, void* stream) {
  if (R <= 0 || D <= 0 || D % 8 || rows_per_block <= 0 || rows_per_block % NWARPS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + rows_per_block - 1) / rows_per_block);
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
#define RF_BWD(T, S, M)                                                                  \
  rms_norm_bwd_kernel<T, S, M><<<grid, NTHREADS, smem, s>>>(                             \
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(g),  \
      static_cast<T*>(dx), static_cast<float*>(ds_part), R, D, rows_per_block, eps)
  RF_DISPATCH_DTYPES(RF_BWD);
#undef RF_BWD
  return cudaGetLastError();
}
