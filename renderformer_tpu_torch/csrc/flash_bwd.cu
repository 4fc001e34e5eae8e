// Flash-attention backward: the fused one-pass dQ/dK/dV kernel (K8) and the
// deterministic two-kernel form (K9: a dQ kernel and a dK/dV kernel).
//
// Replaces renderformer_tpu/ops/flash_attention.py:_bwd_fused_kernel (K8,
// through _flash_bwd_fused) and :_bwd_dq_kernel / :_bwd_dkv_kernel (K9,
// through _flash_bwd_twokernel).  Semantics are those of the Pallas kernels,
// on q and k already rotated (the caller recomputes them):
//   * q is scaled by D^-0.5 * log2(e) in fp32 and rounded to the input dtype;
//   * P is recomputed as exp2(s2 - lse * log2(e)), s2 = q.k in fp32 plus -1e30
//     on a masked key (keys past Sk add -inf; rows past Sq take lse = +inf);
//   * dP = dO.V^T in fp32, dS = (dP - delta) * P rounded to the input dtype
//     before its products, P rounded to it before dV = P^T.dO;
//   * dK = dS^T.q_scaled accumulates in fp32 and takes 1/log2(e) in the
//     epilogue, dV in fp32 too, both cast to the input dtype; dQ = dS.K
//     takes D^-0.5.
// delta = rowsum(dO * O) arrives computed (torch ops, as the JAX package
// computes it in XLA); lse and delta are fp32 [B, H, Sq].
//
// Bound on this card: five products of Sq x Sk x D per (b, h), 10*Sq*Sk*D
// flops (K9 recomputes S and dP in its dQ kernel: 14*Sq*Sk*D) against
// ~4*(Sq+Sk)*D elements moved, far above the ~295 flop/byte ridge, so the
// tensor cores bound it.  Design: the TPU's sequential q-block grid with dK/dV
// resident in VMEM has no GPU counterpart (blocks run in parallel, in no
// order).  Here one block of 4 warps owns a 64-key tile of one (head, batch)
// and loops over 32-row q tiles: K and V stay in shared memory, dK and dV
// stay in registers (each warp 16 keys x D in mma C layout), P^T and dS^T are
// reused from the C layout of S^T as A fragments of dV += P^T.dO and
// dK += dS^T.q.  K8 also multiplies dQ = dS.K for the tile (dS^T staged in
// shared memory, read back transposed by ldmatrix.trans) and adds it into an
// fp32 scratch with atomics, so its sums run in a run-dependent order.  K9's
// dK/dV kernel is the same kernel without dQ; its dQ kernel owns a 64-row q
// tile and loops over key tiles, recomputing P, with dQ in registers: no
// atomics, a deterministic result.  bf16 products are mma.sync m16n8k16 with
// fp32 accumulators (common.cuh); the fp32 instantiation keeps the layouts and
// multiplies with scalar FMAs, exact fp32 like the plain version.  No TMA,
// wgmma or pipelined q tiles yet.
#include <math.h>

#include <type_traits>

#include "common.cuh"

using namespace rf;

namespace {

constexpr int D = 128;       // the head dim of the released models
constexpr int KV_BK = 64;    // keys a block owns (dK/dV kernels)
constexpr int KV_BQ = 32;    // q rows a loop step (dK/dV kernels)
constexpr int DQ_BQ = 64;    // q rows a block owns (K9 dQ kernel)
constexpr int DQ_BK = 64;    // keys a loop step (K9 dQ kernel)
constexpr int NTHREADS = 128;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr int DT = D / 8;    // n8 tiles over the head dim

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);
template <typename T>
constexpr int kLd = D + kVec<T>;  // padded row stride of a [rows][D] tile

template <typename T, bool WITH_DQ>
constexpr size_t kv_smem_bytes() {
  return (size_t)(2 * KV_BK + 2 * KV_BQ) * kLd<T> * sizeof(T) +
         (size_t)(2 * KV_BQ + KV_BK) * sizeof(float) +
         (std::is_same<T, float>::value
              ? (size_t)2 * KV_BK * (KV_BQ + 4) * sizeof(float)
              : (WITH_DQ ? (size_t)KV_BK * (KV_BQ + 8) * sizeof(T) : 0));
}

template <typename T>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * DQ_BQ + 2 * DQ_BK) * kLd<T> * sizeof(T) +
         (size_t)(2 * DQ_BQ + DQ_BK) * sizeof(float) +
         (std::is_same<T, float>::value ? (size_t)DQ_BQ * (DQ_BK + 4) * sizeof(float) : 0);
}

// copy rows [r0, r0 + rows) of a [*, H, D] tensor at (batch bb, head h) into a
// [rows][LD] shared tile, zero-filling rows at or past n
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int bb, int h, int H, int r0,
                                          int rows, int n, int tid) {
  constexpr int VEC = kVec<T>, LD = kLd<T>;
  for (int i = tid; i < rows * (D / VEC); i += NTHREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC, ri = r0 + r;
    const bool ok = ri < n;
    cp_async16(&dst[r * LD + c], src + (((size_t)bb * n + (ok ? ri : 0)) * H + h) * D + c, ok);
  }
}

// the key bias of keys [k0, k0 + n): -inf past Sk, -1e30 where masked, else 0
template <bool HAS_MASK>
__device__ __forceinline__ float key_bias(const uint8_t* mask, int b, int kj, int Sk) {
  if (kj >= Sk) return -INFINITY;
  if (HAS_MASK && mask[(size_t)b * Sk + kj] == 0) return NEG_BIG;
  return 0.f;
}

// ---------------------------------------------------------------------------
// dK/dV (and, for K8, dQ by atomics): one block per (64-key tile, head, batch)
// ---------------------------------------------------------------------------
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: {row g, cols 2t..2t+1}, {row g+8, ..}, {row g, cols 2t+8..}, {row g+8, ..};
//   B regs: {k rows 2t..2t+1, col g}, {k rows 2t+8.., col g};
//   C:      c0,c1 at row g, cols 2t, 2t+1; c2,c3 at row g+8.
// Here the rows of S^T, dP^T, dK and dV are keys (warp w: keys 16w..16w+15) and
// the columns of S^T and dP^T are the q rows of the loop step.
template <typename T, bool HAS_MASK, bool WITH_DQ>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                    float* __restrict__ dq_acc, T* __restrict__ dk, T* __restrict__ dv,
                    int reps, int Sq, int Sk, int H, float qscale, float dqscale,
                    float dkscale) {
  constexpr bool kBF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = kLd<T>;
  constexpr int NT = KV_BQ / 8;      // n8 tiles over a q step
  constexpr int LDS = KV_BQ + 8;     // bf16 dS^T stage stride
  constexpr int LDP = KV_BQ + 4;     // fp32 P^T / dS^T stage stride

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + KV_BK * LD;
  T* Qs = Vs + KV_BK * LD;
  T* dOs = Qs + KV_BQ * LD;
  float* lse2s = reinterpret_cast<float*>(dOs + KV_BQ * LD);
  float* deltas = lse2s + KV_BQ;
  float* kbias = deltas + KV_BQ;
  float* Ps = kbias + KV_BK;           // fp32: [KV_BK][LDP] P^T, then dS^T
  float* DSf = Ps + KV_BK * LDP;
  T* dSs = reinterpret_cast<T*>(kbias + KV_BK);  // bf16 with dQ: [KV_BK][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int k0 = blockIdx.x * KV_BK, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8 of the tile

  // the block's K and V tiles, resident for the whole loop
  {
    const int rows = Sk - k0 < KV_BK ? Sk - k0 : KV_BK;
    constexpr int VEC = kVec<T>;
    for (int i = tid; i < KV_BK * (D / VEC); i += NTHREADS) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      const bool ok = r < rows;
      const size_t kr = (size_t)k0 + (ok ? r : 0);
      cp_async16(&Ks[r * LD + c], k + (((size_t)b * Sk + kr) * H + h) * D + c, ok);
      cp_async16(&Vs[r * LD + c], v + (((size_t)(b / reps) * Sk + kr) * H + h) * D + c, ok);
    }
    cp_async_commit();
    if (tid < KV_BK) kbias[tid] = key_bias<HAS_MASK>(mask, b, k0 + tid, Sk);
  }

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += KV_BQ) {
    load_rows(Qs, q, b, h, H, q0, KV_BQ, Sq, tid);
    load_rows(dOs, dout, b, h, H, q0, KV_BQ, Sq, tid);
    cp_async_commit();
    if (tid < KV_BQ) {
      const int qi = q0 + tid;
      const size_t o = ((size_t)b * H + h) * Sq + qi;
      lse2s[tid] = qi < Sq ? lse[o] * LOG2E_F : INFINITY;
      deltas[tid] = qi < Sq ? delta[o] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    // q scaled by D^-0.5 * log2(e) in fp32, rounded to the input dtype
    for (int i = tid; i < KV_BQ * D; i += NTHREADS) {
      T* p = &Qs[(i / D) * LD + i % D];
      *p = from_float<T>(to_float(*p) * qscale);
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, [16 keys x KV_BQ] a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if constexpr (kBF) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        const int ar = warp * 16 + (lane & 15), ac = kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(ka, &Ks[ar * LD + ac]);
        ldmatrix_x4(va, &Vs[ar * LD + ac]);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t qb[4], ob[4];
          const int br = (j + (lm >> 1)) * 8 + lr, bc = kk * 16 + (lm & 1) * 8;
          ldmatrix_x4(qb, &Qs[br * LD + bc]);
          ldmatrix_x4(ob, &dOs[br * LD + bc]);
          mma_bf16(s[j], ka, qb[0], qb[1]);
          mma_bf16(s[j + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[j], va, ob[0], ob[1]);
          mma_bf16(dp[j + 1], va, ob[2], ob[3]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float k0v = to_float(Ks[r0 * LD + d]), k1v = to_float(Ks[(r0 + 8) * LD + d]);
        const float v0v = to_float(Vs[r0 * LD + d]), v1v = to_float(Vs[(r0 + 8) * LD + d]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * 8 + 2 * t4 + e;
            const float qv = to_float(Qs[c * LD + d]), ov = to_float(dOs[c * LD + d]);
            s[j][e] = fmaf(k0v, qv, s[j][e]);
            s[j][2 + e] = fmaf(k1v, qv, s[j][2 + e]);
            dp[j][e] = fmaf(v0v, ov, dp[j][e]);
            dp[j][2 + e] = fmaf(v1v, ov, dp[j][2 + e]);
          }
      }
    }

    // P^T = exp2(s2 - lse2) and dS^T = (dP^T - delta) * P^T; s keeps P^T,
    // dp keeps dS^T rounded to the input dtype
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        const float p = exp2f((s[j][e] + kbias[r0 + (e >> 1) * 8]) - lse2s[c]);
        s[j][e] = p;
        dp[j][e] = to_float(from_float<T>((dp[j][e] - deltas[c]) * p));
      }

    if constexpr (kBF) {
      // dV += P^T dO and dK += dS^T Q, A fragments straight from the C layout
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t ob[4], qb[4];
          const int br = kk * 16 + (lm & 1) * 8 + lr, bc = (dt + (lm >> 1)) * 8;
          ldmatrix_x4_trans(ob, &dOs[br * LD + bc]);
          ldmatrix_x4_trans(qb, &Qs[br * LD + bc]);
          mma_bf16(dva[dt], pa, ob[0], ob[1]);
          mma_bf16(dva[dt + 1], pa, ob[2], ob[3]);
          mma_bf16(dka[dt], sa, qb[0], qb[1]);
          mma_bf16(dka[dt + 1], sa, qb[2], qb[3]);
        }
      }
      if constexpr (WITH_DQ) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<uint32_t*>(&dSs[(r0 + hh * 8) * LDS + j * 8 + 2 * t4]) =
                pack_bf16(dp[j][2 * hh], dp[j][2 * hh + 1]);
      }
    } else {
      // stage P^T and dS^T (fp32) for the scalar products of this warp's keys
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = (r0 + (e >> 1) * 8) * LDP + j * 8 + 2 * t4 + (e & 1);
          Ps[o] = s[j][e];
          DSf[o] = dp[j][e];
        }
      __syncwarp();
      for (int c = 0; c < KV_BQ; ++c) {
        const float p0 = Ps[r0 * LDP + c], p1 = Ps[(r0 + 8) * LDP + c];
        const float d0 = DSf[r0 * LDP + c], d1 = DSf[(r0 + 8) * LDP + c];
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = dt * 8 + 2 * t4 + e;
            const float ov = to_float(dOs[c * LD + col]), qv = to_float(Qs[c * LD + col]);
            dva[dt][e] = fmaf(p0, ov, dva[dt][e]);
            dva[dt][2 + e] = fmaf(p1, ov, dva[dt][2 + e]);
            dka[dt][e] = fmaf(d0, qv, dka[dt][e]);
            dka[dt][2 + e] = fmaf(d1, qv, dka[dt][2 + e]);
          }
      }
    }

    if constexpr (WITH_DQ) {
      // dQ[q, :] += scale * sum over the tile's keys of dS^T[key, q] K[key, :];
      // warp w: q rows 16 (w & 1) .., head-dim columns 64 (w >> 1) ..
      __syncthreads();  // every warp's dS^T is staged
      const int mt = warp & 1, dh = warp >> 1;
      float acc[DT / 2][4];
#pragma unroll
      for (int dt = 0; dt < DT / 2; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
      if constexpr (kBF) {
#pragma unroll
        for (int kk = 0; kk < KV_BK / 16; ++kk) {
          uint32_t a[4];
          // A = dS (rows q, k-dim keys) read transposed from dS^T [key][q]
          ldmatrix_x4_trans(a, &dSs[(kk * 16 + (lm >> 1) * 8 + lr) * LDS + mt * 16 +
                                    (lm & 1) * 8]);
#pragma unroll
          for (int dt = 0; dt < DT / 2; dt += 2) {
            uint32_t kb[4];
            ldmatrix_x4_trans(kb, &Ks[(kk * 16 + (lm & 1) * 8 + lr) * LD + dh * 64 +
                                      (dt + (lm >> 1)) * 8]);
            mma_bf16(acc[dt], a, kb[0], kb[1]);
            mma_bf16(acc[dt + 1], a, kb[2], kb[3]);
          }
        }
      } else {
        const int qr = mt * 16 + g;
        for (int kj = 0; kj < KV_BK; ++kj) {
          const float a0 = DSf[kj * LDP + qr], a1 = DSf[kj * LDP + qr + 8];
#pragma unroll
          for (int dt = 0; dt < DT / 2; ++dt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float kv = to_float(Ks[kj * LD + dh * 64 + dt * 8 + 2 * t4 + e]);
              acc[dt][e] = fmaf(a0, kv, acc[dt][e]);
              acc[dt][2 + e] = fmaf(a1, kv, acc[dt][2 + e]);
            }
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = q0 + mt * 16 + g + hh * 8;
        if (qi < Sq) {
          float* dst = dq_acc + (((size_t)b * Sq + qi) * H + h) * D + dh * 64;
#pragma unroll
          for (int dt = 0; dt < DT / 2; ++dt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              atomicAdd(dst + dt * 8 + 2 * t4 + e, acc[dt][2 * hh + e] * dqscale);
        }
      }
    }
    __syncthreads();  // the q, dO and stage buffers are free for the next step
  }

  // epilogue: dK takes 1/log2(e), both cast to the input dtype
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kj = k0 + r0 + hh * 8;
    if (kj < Sk) {
      const size_t o = (((size_t)b * Sk + kj) * H + h) * D;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = dt * 8 + 2 * t4 + e;
          dk[o + c] = from_float<T>(dka[dt][2 * hh + e] * dkscale);
          dv[o + c] = from_float<T>(dva[dt][2 * hh + e]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// K9 dQ: one block per (64-row q tile, head, batch), a loop over key tiles
// ---------------------------------------------------------------------------
template <typename T, bool HAS_MASK>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                    T* __restrict__ dq, int reps, int Sq, int Sk, int H, float qscale,
                    float dqscale) {
  constexpr bool kBF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int LD = kLd<T>;
  constexpr int NT = DQ_BK / 8;
  constexpr int LDP = DQ_BK + 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + DQ_BQ * LD;
  T* Ks = dOs + DQ_BQ * LD;
  T* Vs = Ks + DQ_BK * LD;
  float* lse2s = reinterpret_cast<float*>(Vs + DQ_BK * LD);
  float* deltas = lse2s + DQ_BQ;
  float* kbias = deltas + DQ_BQ;
  float* DSf = kbias + DQ_BK;  // fp32 only: [DQ_BQ][LDP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3, lm = lane >> 3, lr = lane & 7;
  const int q0 = blockIdx.x * DQ_BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * 16 + g;  // this thread's q rows: r0 and r0 + 8 of the tile

  load_rows(Qs, q, b, h, H, q0, DQ_BQ, Sq, tid);
  load_rows(dOs, dout, b, h, H, q0, DQ_BQ, Sq, tid);
  cp_async_commit();
  if (tid < DQ_BQ) {
    const int qi = q0 + tid;
    const size_t o = ((size_t)b * H + h) * Sq + qi;
    lse2s[tid] = qi < Sq ? lse[o] * LOG2E_F : INFINITY;
    deltas[tid] = qi < Sq ? delta[o] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < DQ_BQ * D; i += NTHREADS) {
    T* p = &Qs[(i / D) * LD + i % D];
    *p = from_float<T>(to_float(*p) * qscale);
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += DQ_BK) {
    __syncthreads();  // the last step is done with Ks and Vs (and the q scaling)
    {
      const int rows = Sk - k0 < DQ_BK ? Sk - k0 : DQ_BK;
      constexpr int VEC = kVec<T>;
      for (int i = tid; i < DQ_BK * (D / VEC); i += NTHREADS) {
        const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
        const bool ok = r < rows;
        const size_t kr = (size_t)k0 + (ok ? r : 0);
        cp_async16(&Ks[r * LD + c], k + (((size_t)b * Sk + kr) * H + h) * D + c, ok);
        cp_async16(&Vs[r * LD + c], v + (((size_t)(b / reps) * Sk + kr) * H + h) * D + c, ok);
      }
      cp_async_commit();
      if (tid < DQ_BK) kbias[tid] = key_bias<HAS_MASK>(mask, b, k0 + tid, Sk);
      cp_async_wait<0>();
      __syncthreads();
    }

    // S = Q K^T and dP = dO V^T, [16 q rows x DQ_BK keys] a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if constexpr (kBF) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], oa[4];
        const int ar = warp * 16 + (lane & 15), ac = kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(qa, &Qs[ar * LD + ac]);
        ldmatrix_x4(oa, &dOs[ar * LD + ac]);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kb[4], vb[4];
          const int br = (j + (lm >> 1)) * 8 + lr, bc = kk * 16 + (lm & 1) * 8;
          ldmatrix_x4(kb, &Ks[br * LD + bc]);
          ldmatrix_x4(vb, &Vs[br * LD + bc]);
          mma_bf16(s[j], qa, kb[0], kb[1]);
          mma_bf16(s[j + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[j], oa, vb[0], vb[1]);
          mma_bf16(dp[j + 1], oa, vb[2], vb[3]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float q0v = to_float(Qs[r0 * LD + d]), q1v = to_float(Qs[(r0 + 8) * LD + d]);
        const float o0v = to_float(dOs[r0 * LD + d]), o1v = to_float(dOs[(r0 + 8) * LD + d]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = j * 8 + 2 * t4 + e;
            const float kv = to_float(Ks[c * LD + d]), vv = to_float(Vs[c * LD + d]);
            s[j][e] = fmaf(q0v, kv, s[j][e]);
            s[j][2 + e] = fmaf(q1v, kv, s[j][2 + e]);
            dp[j][e] = fmaf(o0v, vv, dp[j][e]);
            dp[j][2 + e] = fmaf(o1v, vv, dp[j][2 + e]);
          }
      }
    }

    // dS = (dP - delta) * exp2(s2 - lse2), rounded to the input dtype
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >> 1) * 8;
        const float p = exp2f((s[j][e] + kbias[j * 8 + 2 * t4 + (e & 1)]) - lse2s[row]);
        dp[j][e] = to_float(from_float<T>((dp[j][e] - deltas[row]) * p));
      }

    // dQ += dS K
    if constexpr (kBF) {
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        a[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        a[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        a[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, &Ks[(kk * 16 + (lm & 1) * 8 + lr) * LD + (dt + (lm >> 1)) * 8]);
          mma_bf16(acc[dt], a, kb[0], kb[1]);
          mma_bf16(acc[dt + 1], a, kb[2], kb[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          DSf[(r0 + (e >> 1) * 8) * LDP + j * 8 + 2 * t4 + (e & 1)] = dp[j][e];
      __syncwarp();
      for (int kj = 0; kj < DQ_BK; ++kj) {
        const float a0 = DSf[r0 * LDP + kj], a1 = DSf[(r0 + 8) * LDP + kj];
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kv = to_float(Ks[kj * LD + dt * 8 + 2 * t4 + e]);
            acc[dt][e] = fmaf(a0, kv, acc[dt][e]);
            acc[dt][2 + e] = fmaf(a1, kv, acc[dt][2 + e]);
          }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + r0 + hh * 8;
    if (qi < Sq) {
      T* dst = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dst[dt * 8 + 2 * t4 + e] = from_float<T>(acc[dt][2 * hh + e] * dqscale);
    }
  }
}

template <typename T, bool HAS_MASK, bool WITH_DQ>
cudaError_t launch_kv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* mask, void* dq_acc,
                      void* dk, void* dv, int B, int reps, int Sq, int Sk, int H, float qscale,
                      float dqscale, float dkscale, cudaStream_t stream) {
  constexpr size_t smem = kv_smem_bytes<T, WITH_DQ>();
  auto kern = flash_bwd_kv_kernel<T, HAS_MASK, WITH_DQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + KV_BK - 1) / KV_BK, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dq_acc), static_cast<T*>(dk), static_cast<T*>(dv), reps, Sq, Sk, H,
      qscale, dqscale, dkscale);
  return cudaGetLastError();
}

template <typename T, bool HAS_MASK>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* mask, void* dq, int B,
                      int reps, int Sq, int Sk, int H, float qscale, float dqscale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<T>();
  auto kern = flash_bwd_dq_kernel<T, HAS_MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask), static_cast<T*>(dq),
      reps, Sq, Sk, H, qscale, dqscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t kv_variant(int has_mask, const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta, const void* mask,
                       void* dq_acc, void* dk, void* dv, int B, int reps, int Sq, int Sk, int H,
                       float qscale, float dqscale, float dkscale, cudaStream_t s) {
#define RF_KV(M, Q)                                                                       \
  launch_kv<T, M, Q>(q, k, v, dout, lse, delta, mask, dq_acc, dk, dv, B, reps, Sq, Sk, H, \
                     qscale, dqscale, dkscale, s)
  if (has_mask) return dq_acc ? RF_KV(true, true) : RF_KV(true, false);
  return dq_acc ? RF_KV(false, true) : RF_KV(false, false);
#undef RF_KV
}

bool bad_shape(int B, int reps, int Sq, int Sk, int H, int Dh) {
  return B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || reps <= 0 || B % reps || Dh != D;
}

}  // namespace

// q, dout [B,Sq,H,D] (q rotated, unscaled); k (rotated) [B,Sk,H,D]; v
// [B/reps,Sk,H,D]; lse, delta [B,H,Sq] fp32; mask [B,Sk] uint8 (ignored unless
// has_mask); dk, dv [B,Sk,H,D] in the input dtype.  dq_acc [B,Sq,H,D] fp32,
// zeroed by the caller, receives dQ by atomics (K8); null gives K9's dK/dV
// kernel alone.
extern "C" int rf_flash_bwd_kv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* mask,
                               void* dq_acc, void* dk, void* dv, int dtype, int has_mask,
                               int B, int reps, int Sq, int Sk, int H, int Dh, float qscale,
                               float dqscale, float dkscale, void* stream) {
  if (bad_shape(B, reps, Sq, Sk, H, Dh)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return kv_variant<__nv_bfloat16>(has_mask, q, k, v, dout, lse, delta, mask, dq_acc, dk,
                                     dv, B, reps, Sq, Sk, H, qscale, dqscale, dkscale, s);
  if (dtype == kF32)
    return kv_variant<float>(has_mask, q, k, v, dout, lse, delta, mask, dq_acc, dk, dv, B,
                             reps, Sq, Sk, H, qscale, dqscale, dkscale, s);
  return cudaErrorInvalidValue;
}

// K9's dQ kernel: the same inputs, dq [B,Sq,H,D] in the input dtype.
extern "C" int rf_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* mask, void* dq,
                               int dtype, int has_mask, int B, int reps, int Sq, int Sk, int H,
                               int Dh, float qscale, float dqscale, void* stream) {
  if (bad_shape(B, reps, Sq, Sk, H, Dh)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RF_DQ(T, M) \
  launch_dq<T, M>(q, k, v, dout, lse, delta, mask, dq, B, reps, Sq, Sk, H, qscale, dqscale, s)
  if (dtype == kBF16) return has_mask ? RF_DQ(__nv_bfloat16, true) : RF_DQ(__nv_bfloat16, false);
  if (dtype == kF32) return has_mask ? RF_DQ(float, true) : RF_DQ(float, false);
#undef RF_DQ
  return cudaErrorInvalidValue;
}
