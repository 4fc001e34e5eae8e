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
// read (once per view), 8 bytes of tables per (row, d) shared by the heads and
// 2 bytes written, so memory bandwidth bounds it.  Design: one thread per
// (b, row, head, d < D/2) pair, which reads x[d] and x[d + D/2] and writes both
// rotated values; neighbouring threads touch neighbouring d, so every load and
// store is coalesced, and the per-view fan-out of K is read straight from the
// scene's rows without a broadcast copy.  Products and the sum are rounded
// separately (no FMA contraction), as the plain version computes them.
#include "common.cuh"

using namespace rf;

namespace {

template <typename T>
__global__ void rot_kv_kernel(const T* __restrict__ k, const float* __restrict__ cosk,
                              const float* __restrict__ sink, T* __restrict__ out,
                              int reps, int Sk, int H, int D, long long total) {
  const int half = D / 2;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int d = (int)(i % half);
    long long t = i / half;
    const int hh = (int)(t % H);
    t /= H;
    const int s = (int)(t % Sk);
    const long long b = t / Sk;
    const size_t kb = (((size_t)(b / reps) * Sk + s) * H + hh) * D;
    const size_t ob = (((size_t)b * Sk + s) * H + hh) * D;
    const size_t tb = ((size_t)b * Sk + s) * D;
    const float x1 = to_float(k[kb + d]), x2 = to_float(k[kb + d + half]);
    const float o1 = __fadd_rn(__fmul_rn(x1, cosk[tb + d]), __fmul_rn(-x2, sink[tb + d]));
    const float o2 =
        __fadd_rn(__fmul_rn(x2, cosk[tb + d + half]), __fmul_rn(x1, sink[tb + d + half]));
    out[ob + d] = from_float<T>(o1);
    out[ob + d + half] = from_float<T>(o2);
  }
}

template <typename T>
cudaError_t launch(const void* k, const void* cosk, const void* sink, void* out, int B,
                   int reps, int Sk, int H, int D, cudaStream_t stream) {
  const long long total = (long long)B * Sk * H * (D / 2);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  rot_kv_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const float*>(cosk),
      static_cast<const float*>(sink), static_cast<T*>(out), reps, Sk, H, D, total);
  return cudaGetLastError();
}

}  // namespace

// k [B/reps,Sk,H,D], cos/sin [B,Sk,D] fp32, out [B,Sk,H,D].
extern "C" int rf_rot_kv_broadcast(const void* k, const void* cosk, const void* sink,
                                   void* out, int dtype, int B, int reps, int Sk, int H,
                                   int D, void* stream) {
  if (B <= 0 || Sk <= 0 || H <= 0 || reps <= 0 || D <= 0 || D % 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(k, cosk, sink, out, B, reps, Sk, H, D, s);
  if (dtype == kF32) return launch<float>(k, cosk, sink, out, B, reps, Sk, H, D, s);
  return cudaErrorInvalidValue;
}
