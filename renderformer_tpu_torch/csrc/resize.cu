// Bilinear resize with align_corners=True, NHWC [B,IH,IW,C] -> [B,OH,OW,C]
// (K4), the same resize written in space-to-depth layout [B,OH/2,OW/2,4C]
// (K5), and K4's adjoint [B,OH,OW,C] -> [B,IH,IW,C] (K4^T, the VJP of both).
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
// written and ~1/4 of that read, so memory bandwidth bounds it.  K4's
// design: one thread per output pixel and 16 bytes of channels (8 bf16 or 4
// fp32), consecutive threads on consecutive output vectors, so the stores
// are 16-byte accesses coalesced across the warp; the four taps are 16-byte
// loads along C, and the input pixels are re-read by the neighbouring
// outputs through L2 rather than staged in shared memory; each vector
// computes its indices and taps afresh (64-bit divisions, float64 taps).
//
// K5 runs at one site, the DPT head's last upsample (x [8, 256, 256, 128]
// bf16 in a 512^2 render: 537 MB written, 134 MB read).  There, K4's design
// spends more than the bytes on its per-vector index work and on four tap
// loads a vector.  K5's kernel (below) tiles the output by s2d rows,
// computes its taps once a block into shared memory, and leaves each vector
// 32-bit offsets and additions only; its stores stream past L2, which the
// output never fits.

// K4^T replaces _kernel run with transpose=True (_resize_bwd, and after a
// depth_to_space _resize_s2d_bwd), which applied the adjoint interpolation
// matrices of _axis_matrices as banded matmuls and rounded the H pass to the
// dtype.  Here each input pixel gathers the output pixels that read it: per
// axis a table gives, for input index i, the first output index, their count
// and their weights (the nonzeros of column i of _interp_matrix(n_in, n_out)),
// built once and cached on the card; the sums run in fp32, H inside W, and
// round once, with no atomics, so the result is deterministic.  Memory bounds
// it as it does K4: each output vector is written once, and its ~16 taps are
// 16-byte loads that neighbouring input pixels share through L2.
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

// the lerp of four 16-byte vectors of taps (rows y0, y1 at columns x0, x1),
// H pass at each column, then W pass, in fp32, rounded once to T
template <typename T>
__device__ __forceinline__ uint4 lerp_taps(const uint4& u00, const uint4& u10,
                                           const uint4& u01, const uint4& u11, float fy,
                                           float fx) {
  constexpr int VEC = 16 / sizeof(T);
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

// the VEC channels [c, c + VEC) of output pixel (oy, ox) of image b
template <typename T>
__device__ __forceinline__ uint4 lerp_vec(const T* __restrict__ x, long long b, int oy,
                                          int ox, int c, int IH, int IW, int OH, int OW,
                                          int C) {
  int y0, y1, x0, x1;
  float fy, fx;
  axis_tap(oy, IH, OH, y0, y1, fy);
  axis_tap(ox, IW, OW, x0, x1, fx);
  const T* base = x + (size_t)b * IH * IW * C + c;
  const uint4 u00 = *reinterpret_cast<const uint4*>(base + ((size_t)y0 * IW + x0) * C);
  const uint4 u10 = *reinterpret_cast<const uint4*>(base + ((size_t)y1 * IW + x0) * C);
  const uint4 u01 = *reinterpret_cast<const uint4*>(base + ((size_t)y0 * IW + x1) * C);
  const uint4 u11 = *reinterpret_cast<const uint4*>(base + ((size_t)y1 * IW + x1) * C);
  return lerp_taps<T>(u00, u10, u01, u11, fy, fx);
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

// K5.  out [B, OH/2, OW/2, 4C]: s2d pixel (iy, px) holds quadrant
// q = 2a + c2, channels [q*C, (q+1)*C), of output pixel (2*iy + a, 2*px + c2).
// A block's threads are a whole number of s2d pixels' cv4 = 4C/VEC 16-byte
// vectors, so that thread t always stores vector j = t % cv4 (quadrant q =
// j / cvc, channels cj*VEC within it) of every blockDim.x / cv4-th pixel:
// its row taps, its rows and its quadrant are fixed, and a pixel costs it a
// tap read from shared memory, four 16-byte loads, the lerp and a store at
// 32-bit offsets.  Block (chunk, iy, b) stores S2D_VPT such pixels a
// thread, [chunk * ppb, (chunk + 1) * ppb) of s2d row iy, and computes
// their columns' taps (as element offsets into an input row) once into
// shared memory.  A warp stores 512 contiguous bytes; its tap loads go
// through L1 and L2, where the block's 2-4 input rows stay.
constexpr int S2D_THREADS = 256;  // threads a block, rounded down to whole pixels
constexpr int S2D_VPT = 16;       // pixels (16-byte vectors) a thread stores

struct ColTap {
  int o0, o1;  // x0 * C, x1 * C
  float f;
  int pad;
};

// MAXT: the most threads a block, S2D_THREADS or, where a pixel's vectors
// need more, 1024 (a bound of 1024 everywhere gave the renders' site more
// registers a thread and fewer blocks an SM)
template <typename T, int MAXT>
__global__ void __launch_bounds__(MAXT)
resize_s2d_kernel(const T* __restrict__ x, T* __restrict__ out, int IH, int IW, int OH,
                  int OW, int C) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ ColTap taps[];
  const int iy = blockIdx.y, b = blockIdx.z;
  const int cvc = C / VEC, cv4 = 4 * cvc;
  const int dpx = blockDim.x / cv4;  // pixels a step of the block
  const int p0 = blockIdx.x * dpx * S2D_VPT, p1 = min(OW / 2, p0 + dpx * S2D_VPT);
  for (int i = threadIdx.x; i < 2 * (p1 - p0); i += blockDim.x) {
    int x0, x1;
    float f;
    axis_tap(2 * p0 + i, IW, OW, x0, x1, f);
    taps[i] = ColTap{x0 * C, x1 * C, f, 0};
  }
  // the thread's output row 2*iy + a and its two input rows
  const int j = threadIdx.x % cv4, q = j / cvc, cj = j - q * cvc;
  int y0, y1;
  float fy;
  axis_tap(2 * iy + (q >> 1), IH, OH, y0, y1, fy);
  const T* img = x + (size_t)b * IH * IW * C + cj * VEC;
  const T* in0 = img + y0 * IW * C;
  const T* in1 = img + y1 * IW * C;
  // the thread's first pixel: its column tap and its output vector, each
  // stepped by dpx pixels
  const int px = p0 + threadIdx.x / cv4;
  const ColTap* tp = taps + 2 * (px - p0) + (q & 1);
  T* op = out + (((size_t)b * (OH / 2) + iy) * (OW / 2) + px) * cv4 * VEC + j * VEC;
  __syncthreads();
#pragma unroll 4
  for (int n = (p1 - px + dpx - 1) / dpx; n > 0; --n) {
    const ColTap t = *tp;
    const uint4 u00 = __ldg(reinterpret_cast<const uint4*>(in0 + t.o0));
    const uint4 u10 = __ldg(reinterpret_cast<const uint4*>(in1 + t.o0));
    const uint4 u01 = __ldg(reinterpret_cast<const uint4*>(in0 + t.o1));
    const uint4 u11 = __ldg(reinterpret_cast<const uint4*>(in1 + t.o1));
    // the output (537 MB at the renders' site) never fits in L2: stream it
    __stcs(reinterpret_cast<uint4*>(op), lerp_taps<T>(u00, u10, u01, u11, fy, t.f));
    tp += 2 * dpx;
    op += dpx * cv4 * VEC;
  }
}

// out [B, IH, IW, C] = K4's adjoint applied to g [B, OH, OW, C]; span_* [n_in][2]
// = (first output index, count), w_* [n_in][taps] the weights
template <typename T>
__global__ void resize_t_kernel(const T* __restrict__ g, T* __restrict__ out,
                                const int* __restrict__ span_h, const float* __restrict__ w_h,
                                int taps_h, const int* __restrict__ span_w,
                                const float* __restrict__ w_w, int taps_w, int IH, int IW,
                                int OH, int OW, int C, long long total) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = C / VEC;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * VEC;
    long long t = i / cv;
    const int ix = (int)(t % IW);
    t /= IW;
    const int iy = (int)(t % IH);
    const long long b = t / IH;
    const int y0 = span_h[2 * iy], ny = span_h[2 * iy + 1];
    const int x0 = span_w[2 * ix], nx = span_w[2 * ix + 1];
    const T* base = g + (size_t)b * OH * OW * C + c;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int bx = 0; bx < nx; ++bx) {
      float col[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) col[e] = 0.f;
      for (int ay = 0; ay < ny; ++ay) {
        const float wy = w_h[iy * taps_h + ay];
        const uint4 u =
            *reinterpret_cast<const uint4*>(base + ((size_t)(y0 + ay) * OW + x0 + bx) * C);
        const T* p = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < VEC; ++e) col[e] = __fadd_rn(col[e], __fmul_rn(wy, to_float(p[e])));
      }
      const float wx = w_w[ix * taps_w + bx];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wx, col[e]));
    }
    uint4 ur;
    T* r = reinterpret_cast<T*>(&ur);
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = from_float<T>(acc[e]);
    *reinterpret_cast<uint4*>(out + (((size_t)b * IH + iy) * IW + ix) * C + c) = ur;
  }
}

int blocks_for(long long total, int threads) {
  const long long want = (total + threads - 1) / threads;
  return (int)(want < 132 * 64 ? want : 132 * 64);
}

template <typename T>
cudaError_t launch_t(const void* g, void* out, const void* span_h, const void* w_h, int taps_h,
                     const void* span_w, const void* w_w, int taps_w, int B, int IH, int IW,
                     int OH, int OW, int C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC || taps_h <= 0 || taps_w <= 0) return cudaErrorInvalidValue;
  const long long total = (long long)B * IH * IW * (C / VEC);
  resize_t_kernel<T><<<blocks_for(total, 256), 256, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(out), static_cast<const int*>(span_h),
      static_cast<const float*>(w_h), taps_h, static_cast<const int*>(span_w),
      static_cast<const float*>(w_w), taps_w, IH, IW, OH, OW, C, total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int IH, int IW, int OH, int OW, int C,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC) return cudaErrorInvalidValue;
  const long long total = (long long)B * OH * OW * (C / VEC);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  resize_kernel<T><<<blocks, threads, 0, stream>>>(static_cast<const T*>(x),
                                                   static_cast<T*>(out), IH, IW, OH, OW, C,
                                                   total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_s2d(const void* x, void* out, int B, int IH, int IW, int OH, int OW,
                       int C, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv4 = 4 * C / VEC;
  // 32-bit offsets within an image and within an s2d row; a block holds a
  // pixel's vectors; a grid of (chunks, OH/2, B)
  if (C % VEC || cv4 > 1024 || OH % 2 || OW % 2 || (long long)IH * IW * C >= (1LL << 31) ||
      (long long)OW * 2 * C >= (1LL << 31) || OH / 2 > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const int threads = cv4 < S2D_THREADS ? S2D_THREADS / cv4 * cv4 : cv4;
  const int ppb = threads / cv4 * S2D_VPT;
  const dim3 grid((OW / 2 + ppb - 1) / ppb, OH / 2, B);
  const size_t smem = sizeof(ColTap) * 2 * ppb;  // at most 32 KB (cv4 >= 4)
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (threads <= S2D_THREADS)
    resize_s2d_kernel<T, S2D_THREADS>
        <<<grid, threads, smem, stream>>>(xp, op, IH, IW, OH, OW, C);
  else
    resize_s2d_kernel<T, 1024><<<grid, threads, smem, stream>>>(xp, op, IH, IW, OH, OW, C);
  return cudaGetLastError();
}

template <bool S2D>
int dispatch(const void* x, void* out, int dtype, int B, int IH, int IW, int OH, int OW,
             int C, void* stream) {
  if (B <= 0 || IH <= 0 || IW <= 0 || OH <= 0 || OW <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return S2D ? launch_s2d<__nv_bfloat16>(x, out, B, IH, IW, OH, OW, C, s)
               : launch<__nv_bfloat16>(x, out, B, IH, IW, OH, OW, C, s);
  if (dtype == kF32)
    return S2D ? launch_s2d<float>(x, out, B, IH, IW, OH, OW, C, s)
               : launch<float>(x, out, B, IH, IW, OH, OW, C, s);
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

// g [B, OH, OW, C] -> out [B, IH, IW, C], the adjoint of rf_resize_bilinear
// from [IH, IW] to [OH, OW]; span_h [IH][2], w_h [IH][taps_h] (and _w over W)
// int32 / fp32 on the card
extern "C" int rf_resize_bilinear_t(const void* g, void* out, const void* span_h,
                                    const void* w_h, int taps_h, const void* span_w,
                                    const void* w_w, int taps_w, int dtype, int B, int IH,
                                    int IW, int OH, int OW, int C, void* stream) {
  if (B <= 0 || IH <= 0 || IW <= 0 || OH <= 0 || OW <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(g, out, span_h, w_h, taps_h, span_w, w_w, taps_w, B, IH,
                                   IW, OH, OW, C, s);
  if (dtype == kF32)
    return launch_t<float>(g, out, span_h, w_h, taps_h, span_w, w_w, taps_w, B, IH, IW, OH,
                           OW, C, s);
  return cudaErrorInvalidValue;
}
