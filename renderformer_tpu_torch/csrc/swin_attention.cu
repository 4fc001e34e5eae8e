// Swin window self-attention: 64-token windows, one 64 x 64 score tile per
// (window, head), with the shifted-window mask.
//
// Replaces renderformer_tpu/ops/swin_attention.py:_swin_kernel (reached
// through _swin_fwd).  The TPU kernel paired two windows into one 128-row
// tile with a block-diagonal -1e30 bias to fill its 128x128 matrix unit;
// here each window is computed alone.  Masked entries underflow to exactly 0
// in exp2 either way, so the function is the same.  Numerics are the TPU
// kernel's:
//   * q is pre-scaled by D^-0.5 * log2(e) in fp32 and rounded to q's dtype;
//   * scores accumulate in fp32; a masked pair adds -1e30;
//   * e = exp2(s - rowmax), p = e / sum(e) (normalised before the P.V
//     product), p rounded to v's dtype, P.V accumulated in fp32 and the
//     output rounded once.
// The shifted mask is mask[w, i, j] = (region[w, i] == region[w, j])
// (nn/attention.py:swin_attn_mask), so the kernel reads the [nW, 64] uint8
// region table of the window grid instead of a [nW, 64, 64] mask; windows
// run view-major, so window bw uses region row bw % nW.
//
// Bound on this card: per (window, head) 64x128 of q, k, v and o (64 KB in
// bf16) against 2 x 64x64x128 x 2 = 2.1 MFLOP, ~32 flop/byte, far below
// the H100's ~295 flop/byte ridge: memory bandwidth bounds it.  Design: one
// block of 4 warps per (window, head); k and v tiles stream into shared
// memory with cp.async while the q tile is scaled on its way in; each warp
// owns 16 query rows and runs S = Q K^T and O = P V as bf16 mma.sync
// m16n8k16 with fp32 accumulators (ldmatrix for K, ldmatrix.trans for V);
// the whole key set is resident, so the softmax is one straight pass in
// registers; the output is staged in shared memory and written with 16-byte
// stores.  fp32 (precision='fp32', the train step's view stage) takes
// swin_attention_f32.cu: split TF32 on the tensor cores, a persistent grid.
#include <type_traits>

#include "common.cuh"
#include "swin_attention_f32.cuh"

using namespace rf;

namespace {

constexpr int S = 64;  // tokens per window (8 x 8)
constexpr int D = 128;  // head dim
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_BIG = -1e30f;

// padded shared-memory row stride of a tile, in elements
template <typename T>
constexpr int LD_OF = D + 16 / (int)sizeof(T);

// q, k and v tiles, the window's region row
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)3 * S * LD_OF<T> * sizeof(T) + S;
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: {row g, cols 2t..2t+1}, {row g+8, cols 2t..}, {row g, cols 2t+8..},
//           {row g+8, cols 2t+8..};
//   B regs: {k rows 2t..2t+1, col g}, {k rows 2t+8..2t+9, col g};
//   C:      c0,c1 at row g, cols 2t, 2t+1; c2,c3 at row g+8.
template <typename T, bool HAS_MASK>
__global__ void __launch_bounds__(NTHREADS)
swin_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const uint8_t* __restrict__ regions, T* __restrict__ out, int nW, int H,
            float qscale) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "fp32 takes swin_attention_f32.cu");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = LD_OF<T>;
  constexpr int NT = S / 8;  // n8 tiles over the keys
  constexpr int DT = D / 8;  // n8 tiles over the head dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + S * LD;
  T* Vs = Ks + S * LD;
  uint8_t* reg = reinterpret_cast<uint8_t*>(Vs + S * LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  const long long wi = blockIdx.x;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)wi * S * row_stride + (size_t)h * D;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  for (int i = tid; i < S * (D / VEC); i += NTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    const size_t off = base + (size_t)r * row_stride + c;
    cp_async16(&Ks[r * LD + c], k + off, true);
    cp_async16(&Vs[r * LD + c], v + off, true);
  }
  cp_async_commit();
  // q scaled by D^-0.5 * log2(e) in fp32 and rounded to T on its way in
  for (int i = tid; i < S * (D / VEC); i += NTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    const uint4 u = *reinterpret_cast<const uint4*>(q + base + (size_t)r * row_stride + c);
    const T* p = reinterpret_cast<const T*>(&u);
    uint4 o;
    T* po = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int e = 0; e < VEC; ++e) po[e] = from_float<T>(__fmul_rn(to_float(p[e]), qscale));
    *reinterpret_cast<uint4*>(&Qs[r * LD + c]) = o;
  }
  if (HAS_MASK && tid < S) reg[tid] = regions[(size_t)(wi % nW) * S + tid];
  cp_async_wait<0>();
  __syncthreads();

  // S = Q K^T, log2 units
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  {
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      const int c0 = kk * 16 + 2 * t4;
      qa[0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + c0]);
      qa[1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + c0]);
      qa[2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + c0 + 8]);
      qa[3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + c0 + 8]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // B fragments of key tiles j, j+1: matrices (j, k lo), (j, k hi),
        // (j+1, k lo), (j+1, k hi) of the row-major K tile
        uint32_t kb[4];
        ldmatrix_x4(kb, &Ks[((j + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8]);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
      }
    }
  }

  // mask, then the softmax of the whole row in the exp2 domain
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (HAS_MASK) {
        const int row = r0 + (e >> 1) * 8, key = j * 8 + 2 * t4 + (e & 1);
        s[j][e] += reg[row] == reg[key] ? 0.f : NEG_BIG;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
      l[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fdiv_rn(s[j][e], l[e >> 1]);

  // O = P V
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  {
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < S / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        // B fragments of head-dim tiles dt, dt+1 from the row-major V tile,
        // transposed by ldmatrix: matrices (k lo, dt), (k hi, dt),
        // (k lo, dt+1), (k hi, dt+1)
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[(kk * 16 + (lm & 1) * 8 + lr) * LD + (dt + (lm >> 1)) * 8]);
        mma_bf16(o[dt], pa, vb[0], vb[1]);
        mma_bf16(o[dt + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // epilogue: round once into the q buffer (each warp reads only its own
  // q rows above), then 16-byte stores of whole rows
  __syncwarp();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t4;
      Qs[(r0 + hh * 8) * LD + c] = from_float<T>(o[dt][2 * hh]);
      Qs[(r0 + hh * 8) * LD + c + 1] = from_float<T>(o[dt][2 * hh + 1]);
    }
  __syncthreads();
  for (int i = tid; i < S * (D / VEC); i += NTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    *reinterpret_cast<uint4*>(out + base + (size_t)r * row_stride + c) =
        *reinterpret_cast<const uint4*>(&Qs[r * LD + c]);
  }
}

template <typename T, bool HAS_MASK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* regions,
                   void* out, int BW, int nW, int H, float qscale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  auto kern = swin_kernel<T, HAS_MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BW, H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(regions), static_cast<T*>(out), nW, H, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mask(int has_mask, const void* q, const void* k, const void* v,
                        const void* regions, void* out, int BW, int nW, int H,
                        float qscale, cudaStream_t stream) {
  if (has_mask)
    return launch<T, true>(q, k, v, regions, out, BW, nW, H, qscale, stream);
  return launch<T, false>(q, k, v, regions, out, BW, nW, H, qscale, stream);
}

}  // namespace

// q, k, v, out [BW, 64, H*128]; regions [nW, 64] uint8 (read only when
// has_mask), window bw using row bw % nW.
extern "C" int rf_swin_window_attention(const void* q, const void* k, const void* v,
                                        const void* regions, void* out, int dtype,
                                        int has_mask, int BW, int nW, int H, float qscale,
                                        void* stream) {
  if (BW <= 0 || nW <= 0 || H <= 0 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_mask<__nv_bfloat16>(has_mask, q, k, v, regions, out, BW, nW, H, qscale,
                                      s);
  if (dtype == kF32)
    return swin_fwd_f32(has_mask != 0, static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const uint8_t*>(regions),
                        static_cast<float*>(out), BW, nW, H, qscale, s);
  return cudaErrorInvalidValue;
}
