// Backward of Swin window self-attention (K6^T): dQ, dK and dV of one
// 64-token window and one head per block, the shifted-window mask included.
//
// The TPU package has no kernel here: renderformer_tpu/ops/swin_attention.py
// :_swin_op_bwd takes the VJP of the jnp reference _ref_paired, computed by
// XLA.  This kernel computes the gradient of K6's own function
// (csrc/swin_attention.cu; ops/swin_attention.py:swin_window_attention_plain),
// in the order of rounding of swin_window_attention_bwd_plain:
//   * the forward is recomputed as K6 computes it: q scaled by
//     D^-0.5 * log2(e) in fp32 and rounded to its dtype, fp32 scores plus
//     -1e30 on masked pairs, P = exp2(s - rowmax) / rowsum in fp32;
//   * dV = P^T dO with P rounded to v's dtype, as the forward's P.V used it;
//   * dP = dO V^T in fp32;
//   * dS = (P o (dP - rowsum(P o dP))) * ln 2, rounded to v's dtype: the
//     softmax's gradient with the whole row resident, so no logsumexp and no
//     o are needed; ln 2 brings the exp2 domain's scores back to q's units;
//   * dQ = (dS K) * D^-0.5 * log2(e) and dK = dS^T (q scaled and rounded),
//     each accumulated in fp32 and rounded once.
//
// Bound on this card: per (window, head) it reads q, k, v and dO (64x128
// each) and writes dq, dk and dv: 7 x 16 KB in bf16 against five 64x64x128
// products, 5.24 MFLOP, ~47 flop/byte, so on the tensor cores the bytes
// bound it.  fp32 takes swin_attention_f32.cu (split TF32 on the tensor
// cores, a persistent grid whose next tile loads under this one's
// products).  Design of the bf16 kernel, simple first: one
// block of 4 warps per (window, head); the four input tiles go to shared
// memory (cp.async, q scaled on its way in); each warp recomputes S and
// P for its 16 query rows, forms dP and dS in registers and writes P, then
// dS, into one shared tile; each warp then owns 16 key rows for dV = P^T dO
// and dK = dS^T Q (the tile read transposed) and its 16 query rows for
// dQ = dS K.  Every output element is written once by one thread: no
// atomics, the same bits every run.  The outputs are staged in the input
// tiles that are no longer read, then stored as 16-byte rows.  The products
// run as mma.sync m16n8k16 with fp32 accumulators (ldmatrix, .trans for the
// transposed operands), the forward's fragment layout; the tiles take 79 KB
// of shared memory, two blocks an SM.
#include <type_traits>

#include "common.cuh"
#include "swin_attention_f32.cuh"

using namespace rf;

namespace {

constexpr int S = 64;   // tokens per window (8 x 8)
constexpr int D = 128;  // head dim
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NT = S / 8;  // n8 tiles over the keys
constexpr int DT = D / 8;  // n8 tiles over the head dim
constexpr float NEG_BIG = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// padded shared-memory row strides, in elements: the four [64][D] tiles, and
// the [64][64] P / dS tile
template <typename T>
constexpr int LD_OF = D + 16 / (int)sizeof(T);
template <typename T>
constexpr int LDP_OF = S + 16 / (int)sizeof(T);

// q, k, v and dO tiles, the P / dS tile (in T), the window's region row
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)4 * S * LD_OF<T> * sizeof(T) + (size_t)S * LDP_OF<T> * sizeof(T) + S;
}

// acc[j] (rows r0, r0 + 8; keys j*8 + 2t, +1) = A[rows] . B[keys]^T over
// the head dim, A and B [64][D] tiles in shared memory
template <typename T>
__device__ __forceinline__ void rows_by_keys(float (&acc)[NT][4], const T* A, const T* B,
                                             int r0, int lane) {
  constexpr int LD = LD_OF<T>;
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  {
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      const int c0 = kk * 16 + 2 * t4;
      a[0] = *reinterpret_cast<const uint32_t*>(&A[r0 * LD + c0]);
      a[1] = *reinterpret_cast<const uint32_t*>(&A[(r0 + 8) * LD + c0]);
      a[2] = *reinterpret_cast<const uint32_t*>(&A[r0 * LD + c0 + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&A[(r0 + 8) * LD + c0 + 8]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, &B[((j + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8]);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[dt] (key rows k0, k0 + 8; head-dim cols dt*8 + 2t, +1) =
// P[:, keys]^T . B over the 64 query rows: P the [64][64] tile (rows = query,
// cols = key), B a [64][D] tile; k0 = warp * 16 + lane / 4
template <typename T>
__device__ __forceinline__ void keys_by_dim(float (&acc)[DT][4], const T* P, const T* B,
                                            int warp, int lane) {
  constexpr int LD = LD_OF<T>;
  constexpr int LDP = LDP_OF<T>;
  const int t4 = lane & 3;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  {
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < S / 16; ++kk) {
      // A = P^T [16 keys][16 queries]: the transposes of the P blocks
      // (q lo, keys lo), (q lo, keys hi), (q hi, keys lo), (q hi, keys hi)
      uint32_t a[4];
      ldmatrix_x4_trans(a, &P[(kk * 16 + (lm >> 1) * 8 + lr) * LDP + warp * 16 + (lm & 1) * 8]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        // B fragments of head-dim tiles dt, dt+1 from the row-major tile,
        // transposed by ldmatrix, as the forward reads V
        uint32_t b[4];
        ldmatrix_x4_trans(b, &B[(kk * 16 + (lm & 1) * 8 + lr) * LD + (dt + (lm >> 1)) * 8]);
        mma_bf16(acc[dt], a, b[0], b[1]);
        mma_bf16(acc[dt + 1], a, b[2], b[3]);
      }
    }
  }
}

// rows r and r + 8 of acc, times `scale`, rounded into the tile X
template <typename T>
__device__ __forceinline__ void stage_rows(T* X, const float (&acc)[DT][4], int r, int t4,
                                           float scale) {
  constexpr int LD = LD_OF<T>;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t4;
      X[(r + hh * 8) * LD + c] = from_float<T>(__fmul_rn(acc[dt][2 * hh], scale));
      X[(r + hh * 8) * LD + c + 1] = from_float<T>(__fmul_rn(acc[dt][2 * hh + 1], scale));
    }
}

// the [64][64] register fragments x (rows r0, r0 + 8) rounded into the tile P
template <typename T>
__device__ __forceinline__ void store_tile(T* P, const float (&x)[NT][4], int r0, int t4) {
  constexpr int LDP = LDP_OF<T>;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      P[(r0 + (e >> 1) * 8) * LDP + j * 8 + 2 * t4 + (e & 1)] = from_float<T>(x[j][e]);
}

template <typename T, bool HAS_MASK>
__global__ void __launch_bounds__(NTHREADS)
swin_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const uint8_t* __restrict__ regions,
                T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int nW, int H,
                float qscale) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "fp32 takes swin_attention_f32.cu");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LD = LD_OF<T>;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + S * LD;
  T* Vs = Ks + S * LD;
  T* Os = Vs + S * LD;  // dO
  T* Ps = Os + S * LD;  // P, then dS
  uint8_t* reg = reinterpret_cast<uint8_t*>(Ps + S * LDP_OF<T>);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y;
  const long long wi = blockIdx.x;
  const size_t row_stride = (size_t)H * D;
  const size_t base = (size_t)wi * S * row_stride + (size_t)h * D;
  const int r0 = warp * 16 + g;  // this thread's query rows, and key rows: r0, r0 + 8

  for (int i = tid; i < S * (D / VEC); i += NTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    const size_t off = base + (size_t)r * row_stride + c;
    cp_async16(&Ks[r * LD + c], k + off, true);
    cp_async16(&Vs[r * LD + c], v + off, true);
    cp_async16(&Os[r * LD + c], dout + off, true);
  }
  cp_async_commit();
  // q scaled by D^-0.5 * log2(e) in fp32 and rounded to T on its way in, as
  // the forward's scores use it
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

  // P: the forward's softmax, recomputed as K6 computes it
  float p[NT][4];
  rows_by_keys<T>(p, Qs, Ks, r0, lane);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (HAS_MASK) {
        const int row = r0 + (e >> 1) * 8, key = j * 8 + 2 * t4 + (e & 1);
        p[j][e] += reg[row] == reg[key] ? 0.f : NEG_BIG;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], p[j][e]);
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
      p[j][e] = exp2f(p[j][e] - mx[e >> 1]);
      l[e >> 1] += p[j][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = __fdiv_rn(p[j][e], l[e >> 1]);

  // dP = dO V^T, then dS = (P o (dP - rowsum(P o dP))) * ln 2 in place
  float ds[NT][4];
  rows_by_keys<T>(ds, Os, Vs, r0, lane);
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(p[j][e], ds[j][e], delta[e >> 1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
    delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ds[j][e] = __fmul_rn(__fmul_rn(p[j][e], __fsub_rn(ds[j][e], delta[e >> 1])), LN2);

  store_tile<T>(Ps, p, r0, t4);  // P in v's dtype, as the forward's P.V takes it
  __syncthreads();               // P whole; V is read no more

  // dV = P^T dO for this warp's key rows, staged in the V tile
  {
    float acc[DT][4];
    keys_by_dim<T>(acc, Ps, Os, warp, lane);
    stage_rows<T>(Vs, acc, r0, t4, 1.f);
  }
  __syncthreads();  // P and dO are read no more
  store_tile<T>(Ps, ds, r0, t4);
  __syncthreads();

  // dK = dS^T (q scaled) for this warp's key rows, staged in the dO tile
  {
    float acc[DT][4];
    keys_by_dim<T>(acc, Ps, Qs, warp, lane);
    stage_rows<T>(Os, acc, r0, t4, 1.f);
  }

  // dQ = (dS K) * D^-0.5 * log2(e) for this warp's query rows
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  {
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < S / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(ds[2 * kk][0], ds[2 * kk][1]);
      a[1] = pack_bf16(ds[2 * kk][2], ds[2 * kk][3]);
      a[2] = pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
      a[3] = pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, &Ks[(kk * 16 + (lm & 1) * 8 + lr) * LD + (dt + (lm >> 1)) * 8]);
        mma_bf16(acc[dt], a, b[0], b[1]);
        mma_bf16(acc[dt + 1], a, b[2], b[3]);
      }
    }
  }
  __syncthreads();  // the q tile is read no more
  stage_rows<T>(Qs, acc, r0, t4, qscale);
  __syncthreads();

  for (int i = tid; i < S * (D / VEC); i += NTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    const size_t off = base + (size_t)r * row_stride + c;
    *reinterpret_cast<uint4*>(dq + off) = *reinterpret_cast<const uint4*>(&Qs[r * LD + c]);
    *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(&Os[r * LD + c]);
    *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(&Vs[r * LD + c]);
  }
}

template <typename T, bool HAS_MASK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* regions, void* dq, void* dk, void* dv, int BW, int nW, int H,
                   float qscale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  auto kern = swin_bwd_kernel<T, HAS_MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BW, H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const uint8_t*>(regions), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), nW, H, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mask(int has_mask, const void* q, const void* k, const void* v,
                        const void* dout, const void* regions, void* dq, void* dk, void* dv,
                        int BW, int nW, int H, float qscale, cudaStream_t stream) {
  if (has_mask)
    return launch<T, true>(q, k, v, dout, regions, dq, dk, dv, BW, nW, H, qscale, stream);
  return launch<T, false>(q, k, v, dout, regions, dq, dk, dv, BW, nW, H, qscale, stream);
}

}  // namespace

// q, k, v, dout, dq, dk, dv [BW, 64, H*128] (q unscaled, as the forward got
// it); regions [nW, 64] uint8 (read only when has_mask), window bw using row
// bw % nW; qscale = D^-0.5 * log2(e).
extern "C" int rf_swin_window_attention_bwd(const void* q, const void* k, const void* v,
                                            const void* dout, const void* regions, void* dq,
                                            void* dk, void* dv, int dtype, int has_mask, int BW,
                                            int nW, int H, float qscale, void* stream) {
  if (BW <= 0 || nW <= 0 || H <= 0 || H > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_mask<__nv_bfloat16>(has_mask, q, k, v, dout, regions, dq, dk, dv, BW, nW, H,
                                      qscale, s);
  if (dtype == kF32)
    return swin_bwd_f32(has_mask != 0, static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(dout),
                        static_cast<const uint8_t*>(regions), static_cast<float*>(dq),
                        static_cast<float*>(dk), static_cast<float*>(dv), BW, nW, H, qscale, s);
  return cudaErrorInvalidValue;
}
