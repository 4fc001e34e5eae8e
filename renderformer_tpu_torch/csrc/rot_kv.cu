// K broadcast-rotate: out[b] = (k32 * cos[b] + rotate_half(k32) * sin[b]).to(T)
// with k32 = k[b / reps] in fp32 (HF rotate-half RoPE, per-view tables over
// per-scene K rows).
//
// Replaces renderformer_tpu/ops/flash_attention.py:_rot_kv_kernel (reached
// through _rot_kv_broadcast).  The TPU version padded the head axis to 8 for
// its sublane tiling; here there is no pad, and the port calls this kernel at
// every RoPE attention site (reps = 1 included) so that there is one path.
//
// Bound on this card: pure streaming, 3 flops an element against 2 bytes of K
// read (once for all the views of a scene), 8 bytes of tables per (row, d)
// shared by the heads and 2 bytes written, so memory bandwidth bounds it.
// Design: one thread a (scene row s, 16-byte chunk c of the first half of a
// head) of one scene batch (blockIdx.y); it loads the chunk and the matching
// chunk of the second half for every head once (16-byte loads, H <= 8 heads
// at a time in registers), then loops over the scene's reps views, two at a
// time so that both views' table loads are in flight together: the view's
// fp32 table chunks are loaded once and serve all the heads, and each head's
// two rotated chunks are written by 16-byte stores.  Neighbouring threads
// take neighbouring chunks of a row, so every access is coalesced.  The grid
// is sized to the rows (one 32-bit division a thread, none an element).
// Products and the sum are rounded separately (no FMA contraction), as the
// plain version computes them.  A head dim whose half is no whole number of
// 16-byte chunks, or a base that is not 16-byte aligned, takes the same
// kernel one element a chunk.
#include <type_traits>

#include "common.cuh"

using namespace rf;

namespace {

constexpr int THREADS = 128;
constexpr int HG = 8;  // heads a thread keeps in registers at a time

// VEC elements of T: one 16-byte access where they span 16 bytes, else VEC
// scalar ones
template <typename T, int VEC>
struct Chunk {
  static constexpr bool kWide = VEC * sizeof(T) == 16;
  typename std::conditional<kWide, uint4, T[VEC]>::type raw;

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWide) {
      raw = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) raw[e] = p[e];
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kWide) {
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) p[e] = raw[e];
    }
  }
  __device__ __forceinline__ T* elems() { return reinterpret_cast<T*>(&raw); }
  __device__ __forceinline__ const T* elems() const { return reinterpret_cast<const T*>(&raw); }
};

// VEC fp32 table values, by 16-byte loads where VEC allows
template <int VEC>
__device__ __forceinline__ void load_f32(float (&f)[VEC], const float* p) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(f + e) = *reinterpret_cast<const float4*>(p + e);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = p[e];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rot_kv_kernel(const T* __restrict__ k, const float* __restrict__ cosk,
              const float* __restrict__ sink, T* __restrict__ out, int reps, int Sk, int H,
              int D, int chunks) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= Sk * chunks) return;
  const int s = i / chunks, e0 = (i - s * chunks) * VEC;  // row, first element of the chunk
  const int half = D / 2, bk = blockIdx.y;
  for (int h0 = 0; h0 < H; h0 += HG) {
    const int nh = H - h0 < HG ? H - h0 : HG;
    Chunk<T, VEC> x1[HG], x2[HG];
    const T* kp = k + ((bk * Sk + s) * H + h0) * D + e0;
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
      if (hh < nh) {
        x1[hh].load(kp + hh * D);
        x2[hh].load(kp + hh * D + half);
      }
    // rotate this thread's heads for view b with its table chunks
    auto rotate = [&](int b, const float (&c1)[VEC], const float (&c2)[VEC],
                      const float (&s1)[VEC], const float (&s2)[VEC]) {
      T* op = out + ((b * Sk + s) * H + h0) * D + e0;
#pragma unroll
      for (int hh = 0; hh < HG; ++hh)
        if (hh < nh) {
          Chunk<T, VEC> o1, o2;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float a1 = to_float(x1[hh].elems()[e]), a2 = to_float(x2[hh].elems()[e]);
            o1.elems()[e] = from_float<T>(__fadd_rn(__fmul_rn(a1, c1[e]), __fmul_rn(-a2, s1[e])));
            o2.elems()[e] = from_float<T>(__fadd_rn(__fmul_rn(a2, c2[e]), __fmul_rn(a1, s2[e])));
          }
          o1.store(op + hh * D);
          o2.store(op + hh * D + half);
        }
    };
    for (int r = 0; r < reps; r += 2) {
      const int b0 = bk * reps + r;
      const bool two = r + 1 < reps;
      float c1[2][VEC], c2[2][VEC], s1[2][VEC], s2[2][VEC];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (u == 0 || two) {
          const int t = ((b0 + u) * Sk + s) * D + e0;
          load_f32(c1[u], cosk + t);
          load_f32(c2[u], cosk + t + half);
          load_f32(s1[u], sink + t);
          load_f32(s2[u], sink + t + half);
        }
      rotate(b0, c1[0], c2[0], s1[0], s2[0]);
      if (two) rotate(b0 + 1, c1[1], c2[1], s1[1], s2[1]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* k, const void* cosk, const void* sink, void* out, int B,
                   int reps, int Sk, int H, int D, cudaStream_t stream) {
  constexpr int WIDE = 16 / (int)sizeof(T);
  const bool wide = (D / 2) % WIDE == 0 && ((reinterpret_cast<uintptr_t>(k) |
                                             reinterpret_cast<uintptr_t>(cosk) |
                                             reinterpret_cast<uintptr_t>(sink) |
                                             reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int chunks = wide ? D / 2 / WIDE : D / 2;
  const dim3 grid((Sk * chunks + THREADS - 1) / THREADS, B / reps);
  if (wide)
    rot_kv_kernel<T, WIDE><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(k), static_cast<const float*>(cosk),
        static_cast<const float*>(sink), static_cast<T*>(out), reps, Sk, H, D, chunks);
  else
    rot_kv_kernel<T, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(k), static_cast<const float*>(cosk),
        static_cast<const float*>(sink), static_cast<T*>(out), reps, Sk, H, D, chunks);
  return cudaGetLastError();
}

}  // namespace

// k [B/reps,Sk,H,D], cos/sin [B,Sk,D] fp32, out [B,Sk,H,D]; offsets are
// 32-bit, so out and the tables hold fewer than 2^31 elements.
extern "C" int rf_rot_kv_broadcast(const void* k, const void* cosk, const void* sink,
                                   void* out, int dtype, int B, int reps, int Sk, int H,
                                   int D, void* stream) {
  if (B <= 0 || Sk <= 0 || H <= 0 || reps <= 0 || D <= 0 || D % 2 || B % reps ||
      (long long)B * Sk * H * D >= (1LL << 31) || B / reps > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(k, cosk, sink, out, B, reps, Sk, H, D, s);
  if (dtype == kF32) return launch<float>(k, cosk, sink, out, B, reps, Sk, H, D, s);
  return cudaErrorInvalidValue;
}
