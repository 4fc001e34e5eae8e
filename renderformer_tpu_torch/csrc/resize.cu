// Bilinear resize with align_corners=True, NHWC [B,IH,IW,C] -> [B,OH,OW,C]
// (K4), the same resize written in space-to-depth layout [B,OH/2,OW/2,4C]
// (K5), and K4's adjoint [B,OH,OW,C] -> [B,IH,IW,C] (K4^T, the VJP of both),
// which reads its cotangent in either of the two layouts.
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
// written and ~1/4 of that read, so memory bandwidth bounds all three, and
// the design is about bytes and index work.  K4 and K5 are one kernel,
// resize_rows_kernel, with the store layout a template parameter: a block
// covers a chunk of one row of stored pixels (an output pixel for K4, an s2d
// pixel, two output rows, for K5), computes its column taps once into shared
// memory as element offsets and fp32 fractions, and leaves each 16-byte
// vector 32-bit offset additions, four tap loads through L1, the lerp and a
// streaming store (__stcs: L2 evicts the line first).  The host
// (ops/fused_resize.py:row_plan) sizes the chunk so that the grid keeps at
// least two blocks an SM.  Cached stores were no faster at any site, and
// 1.25x slower at the renders' 64 -> 128 (33.5 MB, within L2): the kernel
// that reads the output next runs after convolutions on as large tensors.
//
// K4^T replaces _kernel run with transpose=True (_resize_bwd, and after a
// depth_to_space _resize_s2d_bwd), which applied the adjoint interpolation
// matrices of _axis_matrices as banded matmuls and rounded the H pass to the
// dtype.  Here each input pixel gathers the output pixels that read it: per
// axis a table gives, for input index i, the first output index, their count
// and their weights (the nonzeros of column i of _interp_matrix(n_in, n_out)),
// built once and cached on the card; the sums run in fp32, H inside W, and
// round once, with no atomics, so the result is deterministic.  A block
// covers a chunk of one input row: its row taps go to registers and its
// columns' taps to shared memory once, as element offsets into an image of
// g, so that the inner loop is a fixed 4 x 4 taps (every 2x site has at most
// 4 an axis; wider tables take a loop over the table instead).  A tap past
// its index's count loads a valid address all the same and a select drops
// its sum (a zero weight would turn an inf of g into NaN): with no branch
// between them, a vector's 16 loads issue together (with a branch a tap,
// ptxas kept two in flight, and the kernel took 1.2x as long at 256 -> 128).
// The block's <= 4 rows of g are read through
// L1, where the two input columns that share an output column meet; the two
// input rows that share an output row are neighbouring blocks.  g is read in
// NHWC or, for K5's VJP, in s2d layout straight from the cotangent, with no
// depth_to_space copy first: only the offsets differ.
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

constexpr int ROW_THREADS = 256;  // threads a block, rounded down to whole pixels
constexpr int TAP_SMEM = 32 << 10;  // the most shared memory a block's taps take

// threads a block of the row-tiled kernels for pv 16-byte vectors a pixel
// (ops/fused_resize.py:row_plan mirrors it)
int row_threads(int pv) { return pv < ROW_THREADS ? ROW_THREADS / pv * pv : pv; }

struct ColTap {
  int o0, o1;  // x0 * C, x1 * C
  float f;
  int pad;
};

// the lerp of output vector op from rows in0, in1 at element offsets o0, o1,
// stored streaming
template <typename T>
__device__ __forceinline__ void lerp_store(T* op, const T* in0, const T* in1, int o0, int o1,
                                           float fy, float fx) {
  const uint4 u00 = __ldg(reinterpret_cast<const uint4*>(in0 + o0));
  const uint4 u10 = __ldg(reinterpret_cast<const uint4*>(in1 + o0));
  const uint4 u01 = __ldg(reinterpret_cast<const uint4*>(in0 + o1));
  const uint4 u11 = __ldg(reinterpret_cast<const uint4*>(in1 + o1));
  __stcs(reinterpret_cast<uint4*>(op), lerp_taps<T>(u00, u10, u01, u11, fy, fx));
}

// K4 (S2D false) and K5 (S2D true).  A stored pixel is S x S output pixels
// (S = 2 for K5), pv = S*S*C/VEC 16-byte vectors.  A block's threads are a
// whole number of stored pixels' vectors, so that thread t always stores
// vector j = t % pv (quadrant q = j / cvc, channels cj*VEC within it) of
// every blockDim.x / pv-th pixel: its output row, its row taps and its
// quadrant are fixed, and a pixel costs it a tap read from shared memory,
// four 16-byte loads, the lerp and a store at 32-bit offsets.  Block (chunk,
// r, b) stores pixels [chunk * ppb, (chunk + 1) * ppb) of stored row r, and
// computes their columns' taps (as element offsets into an input row) once
// into shared memory.  A warp stores 512 contiguous bytes; its tap loads go
// through L1 and L2, where the block's 2-4 input rows stay.  Where the plan
// gives a thread one pixel (ppb == dpx, the small grids), the thread computes
// its own column tap instead, and the block shares nothing.
// MAXT: the most threads a block, ROW_THREADS or, where a pixel's vectors
// need more, 1024 (a bound of 1024 everywhere gave K5's render site more
// registers a thread and fewer blocks an SM)
template <typename T, bool S2D, int MAXT>
__global__ void __launch_bounds__(MAXT)
resize_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int IH, int IW, int OH,
                   int OW, int C, int ppb) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int S = S2D ? 2 : 1;
  extern __shared__ ColTap taps[];
  const int r = blockIdx.y, b = blockIdx.z;
  const int cvc = C / VEC, pv = S * S * cvc;
  const int dpx = blockDim.x / pv;  // pixels a step of the block
  const int row_px = OW / S;
  const int p0 = blockIdx.x * ppb, p1 = min(row_px, p0 + ppb);
  // the thread's output row S*r + a and its two input rows
  const int j = threadIdx.x % pv, q = j / cvc, cj = j - q * cvc;
  int y0, y1;
  float fy;
  axis_tap(S * r + (q >> 1), IH, OH, y0, y1, fy);
  const T* img = x + (size_t)b * IH * IW * C + cj * VEC;
  const T* in0 = img + y0 * IW * C;
  const T* in1 = img + y1 * IW * C;
  // the thread's first pixel and its output vector, stepped by dpx pixels
  const int px = p0 + threadIdx.x / pv;
  T* op = out + (((size_t)b * (OH / S) + r) * row_px + px) * pv * VEC + j * VEC;
  if (ppb == dpx) {
    if (px < p1) {
      int x0, x1;
      float fx;
      axis_tap(S * px + (q & 1), IW, OW, x0, x1, fx);
      lerp_store<T>(op, in0, in1, x0 * C, x1 * C, fy, fx);
    }
    return;
  }
  for (int i = threadIdx.x; i < S * (p1 - p0); i += blockDim.x) {
    int x0, x1;
    float f;
    axis_tap(S * p0 + i, IW, OW, x0, x1, f);
    taps[i] = ColTap{x0 * C, x1 * C, f, 0};
  }
  const ColTap* tp = taps + S * (px - p0) + (q & 1);
  __syncthreads();
#pragma unroll 4
  for (int n = (p1 - px + dpx - 1) / dpx; n > 0; --n) {
    const ColTap t = *tp;
    lerp_store<T>(op, in0, in1, t.o0, t.o1, fy, t.f);
    tp += S * dpx;
    op += dpx * pv * VEC;
  }
}

// One tap of K4^T along an axis: the element offset of an output row or
// column in an image of g (-1 past the input index's count), and its weight.
struct Tap {
  int off;
  float w;
};

// offset of output row oy (column ox) in an image of g: NHWC [OH, OW, C], or
// s2d [OH/2, OW/2, 4C], where (oy, ox, c) sits at s2d pixel (oy/2, ox/2),
// channel ((oy%2)*2 + ox%2)*C + c (ops/s2d_conv.py's packing)
template <bool S2D>
__device__ __forceinline__ int g_row(int oy, int OW, int C) {
  return S2D ? (oy >> 1) * (OW * 2 * C) + (oy & 1) * (2 * C) : oy * (OW * C);
}
template <bool S2D>
__device__ __forceinline__ int g_col(int ox, int C) {
  return S2D ? (ox >> 1) * (4 * C) + (ox & 1) * C : ox * C;
}

// tap k of input index i from an axis table (span [n_in][2], w [n_in][taps])
template <bool S2D, bool ROW>
__device__ __forceinline__ Tap adj_tap(const int* __restrict__ span,
                                       const float* __restrict__ w, int taps, int i, int k,
                                       int OW, int C) {
  if (k >= __ldg(span + 2 * i + 1)) return Tap{-1, 0.f};
  const int o = __ldg(span + 2 * i) + k;
  return Tap{ROW ? g_row<S2D>(o, OW, C) : g_col<S2D>(o, C), __ldg(w + i * taps + k)};
}

// out [B, IH, IW, C] = K4's adjoint applied to g (NHWC, or with S2D in s2d
// layout).  Block (chunk, iy, b) writes input pixels [chunk * ppb, (chunk +
// 1) * ppb) of row iy, thread t channel vector t % cv of every dpx-th pixel.
// TAPS 4: both tables hold at most 4 taps, unrolled; TAPS 0: the tables'
// own widths, read from them in the loop.  MAXT as resize_rows_kernel's (a
// bound of 1024 capped bf16's 16 loads, 8 sums and 8 partial sums a thread
// at 64 registers, and spilled).
template <typename T, bool S2D, int TAPS, int MAXT>
__global__ void __launch_bounds__(MAXT)
resize_t_kernel(const T* __restrict__ g, T* __restrict__ out, const int* __restrict__ span_h,
                const float* __restrict__ w_h, int taps_h, const int* __restrict__ span_w,
                const float* __restrict__ w_w, int taps_w, int IH, int IW, int OH, int OW,
                int C, int ppb) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ Tap col_taps[];  // TAPS > 0: [pixel of the chunk][TAPS]
  const int iy = blockIdx.y, b = blockIdx.z;
  const int cv = C / VEC, dpx = blockDim.x / cv;
  const int p0 = blockIdx.x * ppb, p1 = min(IW, p0 + ppb);
  const int nty = TAPS > 0 ? TAPS : taps_h, ntx = TAPS > 0 ? TAPS : taps_w;
  Tap row[TAPS > 0 ? TAPS : 1];
  if constexpr (TAPS > 0) {
    for (int i = threadIdx.x; i < (p1 - p0) * TAPS; i += blockDim.x)
      col_taps[i] = adj_tap<S2D, false>(span_w, w_w, taps_w, p0 + i / TAPS, i % TAPS, OW, C);
#pragma unroll
    for (int k = 0; k < TAPS; ++k)
      row[k] = adj_tap<S2D, true>(span_h, w_h, taps_h, iy, k, OW, C);
  }
  const int j = threadIdx.x % cv;
  const int px = p0 + threadIdx.x / cv;
  const T* img = g + (size_t)b * OH * OW * C + j * VEC;
  T* op = out + (((size_t)b * IH + iy) * IW + px) * C + j * VEC;
  __syncthreads();
  for (int ix = px; ix < p1; ix += dpx, op += dpx * C) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
    for (int bx = 0; bx < ntx; ++bx) {
      Tap tx;
      if constexpr (TAPS > 0)
        tx = col_taps[(ix - p0) * TAPS + bx];
      else
        tx = adj_tap<S2D, false>(span_w, w_w, taps_w, ix, bx, OW, C);
      float col[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) col[e] = 0.f;
#pragma unroll
      for (int ay = 0; ay < nty; ++ay) {
        Tap ty;
        if constexpr (TAPS > 0)
          ty = row[ay];
        else
          ty = adj_tap<S2D, true>(span_h, w_h, taps_h, iy, ay, OW, C);
        // a tap past the count loads an address of the image and is dropped
        const bool on = ty.off >= 0;
        const uint4 u =
            __ldg(reinterpret_cast<const uint4*>(img + max(ty.off, 0) + max(tx.off, 0)));
        const T* p = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = __fadd_rn(col[e], __fmul_rn(ty.w, to_float(p[e])));
          col[e] = on ? c : col[e];
        }
      }
      const bool on = tx.off >= 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a = __fadd_rn(acc[e], __fmul_rn(tx.w, col[e]));
        acc[e] = on ? a : acc[e];
      }
    }
    uint4 ur;
    T* res = reinterpret_cast<T*>(&ur);
#pragma unroll
    for (int e = 0; e < VEC; ++e) res[e] = from_float<T>(acc[e]);
    *reinterpret_cast<uint4*>(op) = ur;
  }
}

// the checks both row-tiled launches share: pv vectors a pixel, ppb pixels
// a block (a whole number of the block's steps), at most max_ppb
bool bad_plan(int pv, int ppb, int max_ppb) {
  if (pv <= 0 || pv > 1024) return true;
  const int dpx = row_threads(pv) / pv;
  return ppb < dpx || ppb % dpx || ppb > max_ppb;
}

// K4^T's instantiation for the tables' width (four: at most 4 taps an axis)
// and g's layout
template <typename T, int MAXT>
auto pick_t(bool four, bool s2d) {
  return four ? (s2d ? resize_t_kernel<T, true, 4, MAXT> : resize_t_kernel<T, false, 4, MAXT>)
              : (s2d ? resize_t_kernel<T, true, 0, MAXT> : resize_t_kernel<T, false, 0, MAXT>);
}

template <typename T>
cudaError_t launch_t(const void* g, void* out, const void* span_h, const void* w_h, int taps_h,
                     const void* span_w, const void* w_w, int taps_w, bool s2d, int B, int IH,
                     int IW, int OH, int OW, int C, int ppb, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = C / VEC;
  // 32-bit offsets within an image of g; a grid of (chunks, IH, B)
  if (C % VEC || taps_h <= 0 || taps_w <= 0 || (s2d && (OH % 2 || OW % 2)) ||
      (long long)OH * OW * C >= (1LL << 31) || IH > 65535 || B > 65535 ||
      bad_plan(cv, ppb, TAP_SMEM / (4 * (int)sizeof(Tap))))
    return cudaErrorInvalidValue;
  const int threads = row_threads(cv);
  const dim3 grid((IW + ppb - 1) / ppb, IH, B);
  const bool four = taps_h <= 4 && taps_w <= 4;
  const size_t smem = four ? sizeof(Tap) * 4 * (ppb < IW ? ppb : IW) : 0;
  const T* gp = static_cast<const T*>(g);
  T* op = static_cast<T*>(out);
  const int* sh = static_cast<const int*>(span_h);
  const int* sw = static_cast<const int*>(span_w);
  const float* wh = static_cast<const float*>(w_h);
  const float* ww = static_cast<const float*>(w_w);
  auto kernel = threads <= ROW_THREADS ? pick_t<T, ROW_THREADS>(four, s2d)
                                       : pick_t<T, 1024>(four, s2d);
  kernel<<<grid, threads, smem, stream>>>(gp, op, sh, wh, taps_h, sw, ww, taps_w, IH, IW, OH,
                                          OW, C, ppb);
  return cudaGetLastError();
}

template <typename T, bool S2D>
cudaError_t launch_rows(const void* x, void* out, int B, int IH, int IW, int OH, int OW, int C,
                        int ppb, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int S = S2D ? 2 : 1;
  const int pv = S * S * C / VEC;
  // 32-bit offsets within an image of x and within a stored row; a grid of
  // (chunks, OH/S, B)
  if (C % VEC || OH % S || OW % S || (long long)IH * IW * C >= (1LL << 31) ||
      (long long)OW * S * C >= (1LL << 31) || OH / S > 65535 || B > 65535 ||
      bad_plan(pv, ppb, TAP_SMEM / (S * (int)sizeof(ColTap))))
    return cudaErrorInvalidValue;
  const int threads = row_threads(pv);
  const int row_px = OW / S;
  const dim3 grid((row_px + ppb - 1) / ppb, OH / S, B);
  // (a pixel a thread: no shared taps)
  const size_t smem =
      ppb == threads / pv ? 0 : sizeof(ColTap) * S * (ppb < row_px ? ppb : row_px);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  auto kernel = threads <= ROW_THREADS ? resize_rows_kernel<T, S2D, ROW_THREADS>
                                       : resize_rows_kernel<T, S2D, 1024>;
  kernel<<<grid, threads, smem, stream>>>(xp, op, IH, IW, OH, OW, C, ppb);
  return cudaGetLastError();
}

template <bool S2D>
int dispatch(const void* x, void* out, int dtype, int B, int IH, int IW, int OH, int OW,
             int C, int ppb, void* stream) {
  if (B <= 0 || IH <= 0 || IW <= 0 || OH <= 0 || OW <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_rows<__nv_bfloat16, S2D>(x, out, B, IH, IW, OH, OW, C, ppb, s);
  if (dtype == kF32) return launch_rows<float, S2D>(x, out, B, IH, IW, OH, OW, C, ppb, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [B, IH, IW, C] -> out [B, OH, OW, C]; ppb output pixels a block
// (ops/fused_resize.py:row_plan)
extern "C" int rf_resize_bilinear(const void* x, void* out, int dtype, int B, int IH,
                                  int IW, int OH, int OW, int C, int ppb, void* stream) {
  return dispatch<false>(x, out, dtype, B, IH, IW, OH, OW, C, ppb, stream);
}

// x [B, IH, IW, C] -> out [B, OH/2, OW/2, 4C] (OH, OW even); ppb s2d pixels
// a block
extern "C" int rf_resize_s2d(const void* x, void* out, int dtype, int B, int IH, int IW,
                             int OH, int OW, int C, int ppb, void* stream) {
  return dispatch<true>(x, out, dtype, B, IH, IW, OH, OW, C, ppb, stream);
}

// g [B, OH, OW, C] (s2d 0) or [B, OH/2, OW/2, 4C] (s2d 1) -> out [B, IH, IW,
// C], the adjoint of rf_resize_bilinear from [IH, IW] to [OH, OW]; span_h
// [IH][2], w_h [IH][taps_h] (and _w over W) int32 / fp32 on the card; ppb
// input pixels a block
extern "C" int rf_resize_bilinear_t(const void* g, void* out, const void* span_h,
                                    const void* w_h, int taps_h, const void* span_w,
                                    const void* w_w, int taps_w, int dtype, int s2d, int B,
                                    int IH, int IW, int OH, int OW, int C, int ppb,
                                    void* stream) {
  if (B <= 0 || IH <= 0 || IW <= 0 || OH <= 0 || OW <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(g, out, span_h, w_h, taps_h, span_w, w_w, taps_w, s2d != 0,
                                   B, IH, IW, OH, OW, C, ppb, s);
  if (dtype == kF32)
    return launch_t<float>(g, out, span_h, w_h, taps_h, span_w, w_w, taps_w, s2d != 0, B, IH,
                           IW, OH, OW, C, ppb, s);
  return cudaErrorInvalidValue;
}
