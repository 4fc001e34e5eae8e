// Bilinear resize with align_corners=True, NHWC [B,IH,IW,C] -> [B,OH,OW,C]
// (K4), and the same resize written in space-to-depth layout
// [B,OH/2,OW/2,4C] (K5).
//
// K4 replaces renderformer_tpu/ops/fused_resize.py:_kernel (reached through
// _apply2d); K5 replaces :_kernel_s2d (reached through _apply2d_s2d), which
// feeds the composed DPT output tail.  The TPU kernels wrote the resize as
// banded matrix products (Mh . x . Mw^T) for their matrix unit and rounded
// the H-pass intermediate to bf16; these kernels compute the function
// itself: each output element is the 2x2-tap lerp with the (i0, i1, frac)
// tables of nn/conv.py:_interp_gather, H pass then W pass, in fp32, rounded
// once to the output dtype.  The tables are recomputed in float64 from the
// same closed form numpy uses (coord = o * (n_in - 1) / (n_out - 1), frac
// rounded to fp32), so they are bit-identical and need no device copy.  K5
// differs from K4 only in where it stores: output pixel (2i + a, 2j + c2)
// goes to s2d pixel (i, j), channels [(2a + c2) * C, (2a + c2 + 1) * C).
//
// Bound on this card: 8 flops per output element against its 2 or 4 bytes
// written and ~1/4 of that read, so memory bandwidth bounds it.  Design: one
// thread per output pixel and 16 bytes of channels (8 bf16 or 4 fp32),
// consecutive threads on consecutive output vectors, so the stores are
// 16-byte accesses coalesced across the warp (for K5 a warp walks the 4C
// channels of one s2d pixel, i.e. the C channels of two or four output
// pixels); the four taps are 16-byte loads along C, and the input pixels
// are re-read by the neighbouring outputs through L2 rather than staged in
// shared memory.
#include "common.cuh"

using namespace rf;

namespace {

__device__ __forceinline__ void axis_tap(int o, int n_in, int n_out, int& i0, int& i1,
                                         float& f) {
  if (n_out == 1 || n_in == 1) {
    i0 = i1 = 0;
    f = 0.f;
    return;
  }
  const double coord = (double)o * (double)(n_in - 1) / (double)(n_out - 1);
  int lo = (int)floor(coord);
  lo = lo < 0 ? 0 : (lo > n_in - 1 ? n_in - 1 : lo);
  i0 = lo;
  i1 = lo + 1 < n_in ? lo + 1 : n_in - 1;
  f = __double2float_rn(coord - (double)lo);
}

// the VEC channels [c, c + VEC) of output pixel (oy, ox) of image b
template <typename T>
__device__ __forceinline__ uint4 lerp_vec(const T* __restrict__ x, long long b, int oy,
                                          int ox, int c, int IH, int IW, int OH, int OW,
                                          int C) {
  constexpr int VEC = 16 / sizeof(T);
  int y0, y1, x0, x1;
  float fy, fx;
  axis_tap(oy, IH, OH, y0, y1, fy);
  axis_tap(ox, IW, OW, x0, x1, fx);
  const T* base = x + (size_t)b * IH * IW * C + c;
  const uint4 u00 = *reinterpret_cast<const uint4*>(base + ((size_t)y0 * IW + x0) * C);
  const uint4 u10 = *reinterpret_cast<const uint4*>(base + ((size_t)y1 * IW + x0) * C);
  const uint4 u01 = *reinterpret_cast<const uint4*>(base + ((size_t)y0 * IW + x1) * C);
  const uint4 u11 = *reinterpret_cast<const uint4*>(base + ((size_t)y1 * IW + x1) * C);
  const T* p00 = reinterpret_cast<const T*>(&u00);
  const T* p10 = reinterpret_cast<const T*>(&u10);
  const T* p01 = reinterpret_cast<const T*>(&u01);
  const T* p11 = reinterpret_cast<const T*>(&u11);
  uint4 ur;
  T* r = reinterpret_cast<T*>(&ur);
  const float gy = 1.f - fy, gx = 1.f - fx;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float t0 =
        __fadd_rn(__fmul_rn(to_float(p00[e]), gy), __fmul_rn(to_float(p10[e]), fy));
    const float t1 =
        __fadd_rn(__fmul_rn(to_float(p01[e]), gy), __fmul_rn(to_float(p11[e]), fy));
    r[e] = from_float<T>(__fadd_rn(__fmul_rn(t0, gx), __fmul_rn(t1, fx)));
  }
  return ur;
}

template <typename T>
__global__ void resize_kernel(const T* __restrict__ x, T* __restrict__ out, int IH, int IW,
                              int OH, int OW, int C, long long total) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = C / VEC;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * VEC;
    long long t = i / cv;
    const int ox = (int)(t % OW);
    t /= OW;
    const int oy = (int)(t % OH);
    const long long b = t / OH;
    *reinterpret_cast<uint4*>(out + (((size_t)b * OH + oy) * OW + ox) * C + c) =
        lerp_vec<T>(x, b, oy, ox, c, IH, IW, OH, OW, C);
  }
}

// out [B, OH/2, OW/2, 4C]: vector i of the output is channel range
// [(i % cv4) * VEC, +VEC) of s2d pixel (i / cv4), which holds quadrant
// q = 2a + c2 of output pixels (2*iy + a, 2*ix + c2)
template <typename T>
__global__ void resize_s2d_kernel(const T* __restrict__ x, T* __restrict__ out, int IH,
                                  int IW, int OH, int OW, int C, long long total) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv4 = 4 * C / VEC;
  const int OW2 = OW / 2, OH2 = OH / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int ch = (int)(i % cv4) * VEC;
    long long t = i / cv4;
    const int ix = (int)(t % OW2);
    t /= OW2;
    const int iy = (int)(t % OH2);
    const long long b = t / OH2;
    const int q = ch / C, c = ch % C;
    const int oy = 2 * iy + (q >> 1), ox = 2 * ix + (q & 1);
    *reinterpret_cast<uint4*>(out + (size_t)i * VEC) =
        lerp_vec<T>(x, b, oy, ox, c, IH, IW, OH, OW, C);
  }
}

template <typename T, bool S2D>
cudaError_t launch(const void* x, void* out, int B, int IH, int IW, int OH, int OW, int C,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC) return cudaErrorInvalidValue;
  if (S2D && (OH % 2 || OW % 2)) return cudaErrorInvalidValue;
  const long long total = (long long)B * OH * OW * (C / VEC);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if constexpr (S2D)
    resize_s2d_kernel<T><<<blocks, threads, 0, stream>>>(xp, op, IH, IW, OH, OW, C, total);
  else
    resize_kernel<T><<<blocks, threads, 0, stream>>>(xp, op, IH, IW, OH, OW, C, total);
  return cudaGetLastError();
}

template <bool S2D>
int dispatch(const void* x, void* out, int dtype, int B, int IH, int IW, int OH, int OW,
             int C, void* stream) {
  if (B <= 0 || IH <= 0 || IW <= 0 || OH <= 0 || OW <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16, S2D>(x, out, B, IH, IW, OH, OW, C, s);
  if (dtype == kF32) return launch<float, S2D>(x, out, B, IH, IW, OH, OW, C, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [B, IH, IW, C] -> out [B, OH, OW, C]
extern "C" int rf_resize_bilinear(const void* x, void* out, int dtype, int B, int IH,
                                  int IW, int OH, int OW, int C, void* stream) {
  return dispatch<false>(x, out, dtype, B, IH, IW, OH, OW, C, stream);
}

// x [B, IH, IW, C] -> out [B, OH/2, OW/2, 4C] (OH, OW even)
extern "C" int rf_resize_s2d(const void* x, void* out, int dtype, int B, int IH, int IW,
                             int OH, int OW, int C, void* stream) {
  return dispatch<true>(x, out, dtype, B, IH, IW, OH, OW, C, stream);
}
