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
// tensor cores bound it; in fp32 at a third of the TF32 rate, as split TF32.
// bf16 K8 and K9's bf16 dK/dV kernel run flash_bwd_sm90.cu, K9's bf16 dQ
// kernel flash_bwd_dq_sm90.cu (TMA and wgmma); this file holds the fp32 dK/dV
// kernel (K8 and K9's), K9's fp32 dQ kernel and the C entry points.
// Design: the TPU's sequential q-block grid with dK/dV resident in VMEM has no
// GPU counterpart (blocks run in parallel, in no order).  Here one block of 4
// warps owns a 64-key tile of one (head, batch) and loops over 16-row q steps:
// K and V stay in shared memory, dK and dV stay in registers (each warp 16
// keys x D in mma C layout), P^T and dS^T are reused from the C layout of S^T
// as A fragments of dV += P^T.dO and dK += dS^T.q.  The q and dO tiles are
// double-buffered: step i+1's cp.async copies run while step i multiplies,
// and each thread scales the q chunks it copied once they land, so a step
// costs one barrier (two with dQ).  Where the key tiles fill less than two
// waves of the card (the train step's sites: 96 and 198 tiles against 264
// resident blocks), a tile's q steps split over the two blocks of a thread
// block cluster, which sum their partial dK and dV through distributed shared
// memory (kv_splits).  K8 also multiplies dQ = dS.K for the tile (dS^T staged
// in shared memory) and adds it into an fp32 scratch with atomics, a float2
// atomicAdd for the two adjacent columns a thread holds (sm_90), so its sums
// run in a run-dependent order.  K9's dK/dV kernel is the same kernel without
// dQ; its dQ kernel owns a q tile and loops over key steps, recomputing P,
// with dQ in registers: no atomics, a deterministic result.
//
// The fp32 dK/dV kernel takes all five products on the tensor cores as split
// TF32 (x = hi + lo with hi truncated to TF32, common.cuh's split_tf32_trunc;
// three mma.m16n8k8.tf32 a product, the small ones first, fp32 accumulators), with
// the operands split in registers as their fragments are loaded: S^T and dP^T
// keep the large products and the small ones in accumulators of their own,
// added before the bias; each q step's dV and dK products go to a fresh
// accumulator that one FADD adds to the running sum; dQ's 24 products of a
// tile share one accumulator.  The C layout of S^T becomes the A layout of dV
// and dK by naming the q columns 8j+2t and 8j+2t+1 of s[j] the k indices t and
// t+4; dO's and q's B fragments read those two rows, and dQ reads dS from the
// fp32 stage.  Row strides of D+4 (K, V, q, dO) and BQ+8 (the stage) keep every
// fragment load free of bank conflicts.  16-row q steps hold the block at
// 105.5 KB of shared memory, so two blocks share an SM.
//
// K9's fp32 dQ kernel takes its three products (S, dP, dQ = dS.K; 6*Sq*Sk*D
// flops) the same way: a block of 4 warps owns 64 q rows (q scaled in place
// and dO resident, 16 rows a warp), and loops over 16-key steps whose K and V
// are double-buffered, step j+1's cp.async copies running under step j's
// products, one barrier a step; dS stays in registers, its C layout renamed
// into dQ's A layout as above, and each step's dQ products go to a fresh
// accumulator added by one FADD.  Tiles of 16 keys hold the block at 99.1 KB,
// so two share an SM.  The train step's grids (96 q tiles) fill less than
// two waves of the 264 resident blocks, so a q tile's key steps split over
// the 2 or 4 blocks of a thread block cluster (dq_splits); the partial dQs are
// summed through distributed shared memory in cluster-rank order, the same
// sums in the same order on every run.
#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "flash_bwd_dq_sm90.cuh"
#include "flash_bwd_sm90.cuh"

using namespace rf;
namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;       // the head dim of the released models
constexpr int KV_BK = 64;    // keys a block owns (dK/dV kernels)
constexpr int DQ_BQ = 64;    // q rows a block owns (K9's fp32 dQ kernel)
constexpr int DQ_BK = 16;    // keys a loop step (K9's fp32 dQ kernel)
constexpr int DQ_MAX_SPLITS = 4;  // blocks of a cluster that share a q tile's keys
constexpr int NTHREADS = 128;
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E_F = 1.4426950408889634f;
constexpr int DT = D / 8;    // n8 tiles over the head dim

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);
template <typename T>
constexpr int kLd = D + kVec<T>;  // padded row stride of a [rows][D] tile

// q rows a loop step of the fp32 dK/dV kernel: 16, which keeps the block at
// 105.5 KB of shared memory, so two fit on an SM
template <typename T>
constexpr int kKvBq = std::is_same<T, float>::value ? 16 : 32;

// K and V; two buffers each of q and dO; two of the q rows' lse * log2(e)
// and delta; the key bias; with dQ the dS^T stage, [KV_BK][BQ + 8] in the
// input dtype
template <typename T, bool WITH_DQ>
constexpr size_t kv_smem_bytes() {
  return (size_t)(2 * KV_BK + 4 * kKvBq<T>) * kLd<T> * sizeof(T) +
         (size_t)(4 * kKvBq<T> + KV_BK) * sizeof(float) +
         (WITH_DQ ? (size_t)KV_BK * (kKvBq<T> + 8) * sizeof(T) : 0);
}

// q and dO; two buffers each of K and V and of the key bias (K9's fp32 dQ
// kernel): 99.1 KB, two blocks an SM
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * DQ_BQ + 4 * DQ_BK) * kLd<float> * sizeof(float) +
         (size_t)2 * DQ_BK * sizeof(float);
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
// and of mma.m16n8k8.tf32 (common.cuh): A a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C as above.
// Here the rows of S^T, dP^T, dK and dV are keys (warp w: keys 16w..16w+15) and
// the columns of S^T and dP^T are the q rows of the loop step.
template <typename T, bool HAS_MASK, bool WITH_DQ>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                    float* __restrict__ dq_acc, T* __restrict__ dk, T* __restrict__ dv,
                    int reps, int Sq, int Sk, int H, int splits, float qscale,
                    float dqscale, float dkscale) {
  static_assert(std::is_same<T, float>::value, "bf16 takes flash_bwd_sm90.cu");
  constexpr int LD = kLd<T>, VEC = kVec<T>;
  constexpr int BQ = kKvBq<T>;
  constexpr int NT = BQ / 8;   // n8 tiles over a q step
  constexpr int LDS = BQ + 8;  // dS^T stage stride

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + KV_BK * LD;
  T* Qs = Vs + KV_BK * LD;  // [2][BQ][LD]
  T* dOs = Qs + 2 * BQ * LD;
  float* lse2s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* deltas = lse2s + 2 * BQ;
  float* kbias = deltas + 2 * BQ;
  T* dSs = reinterpret_cast<T*>(kbias + KV_BK);  // with dQ: [KV_BK][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int part = blockIdx.x % splits;  // the block's rank in its cluster
  const int k0 = (blockIdx.x / splits) * KV_BK, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8 of the tile
  // the block's q steps: a contiguous part of the key tile's, split over the
  // blocks of its cluster
  const int nsteps = (Sq + BQ - 1) / BQ;
  const int s0 = nsteps * part / splits, s1 = nsteps * (part + 1) / splits;

  // the block's K and V tiles, resident for the whole loop
  {
    const int rows = Sk - k0 < KV_BK ? Sk - k0 : KV_BK;
    for (int i = tid; i < KV_BK * (D / VEC); i += NTHREADS) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      const bool ok = r < rows;
      const size_t kr = (size_t)k0 + (ok ? r : 0);
      cp_async16(&Ks[r * LD + c], k + (((size_t)b * Sk + kr) * H + h) * D + c, ok);
      cp_async16(&Vs[r * LD + c], v + (((size_t)(b / reps) * Sk + kr) * H + h) * D + c, ok);
    }
    if (tid < KV_BK) kbias[tid] = key_bias<HAS_MASK>(mask, b, k0 + tid, Sk);
  }
  // q and dO of a step into buffer buf, one commit group; the step's lse
  // (times log2 e) and delta into registers of the first BQ threads
  float lse2_next = 0.f, delta_next = 0.f;
  auto load_step = [&](int it, int buf) {
    load_rows(Qs + buf * BQ * LD, q, b, h, H, it * BQ, BQ, Sq, tid);
    load_rows(dOs + buf * BQ * LD, dout, b, h, H, it * BQ, BQ, Sq, tid);
    cp_async_commit();
    if (tid < BQ) {
      const int qi = it * BQ + tid;
      const size_t o = ((size_t)b * H + h) * Sq + qi;
      lse2_next = qi < Sq ? lse[o] * LOG2E_F : INFINITY;
      delta_next = qi < Sq ? delta[o] : 0.f;
    }
  };
  load_step(s0, 0);
  if (tid < BQ) {
    lse2s[tid] = lse2_next;
    deltas[tid] = delta_next;
  }

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  for (int it = s0; it < s1; ++it) {
    const int buf = (it - s0) & 1, q0 = it * BQ;
    T* Qb = Qs + buf * BQ * LD;
    const T* dOb = dOs + buf * BQ * LD;
    const float* lse2b = lse2s + buf * BQ;
    const float* deltab = deltas + buf * BQ;
    // this step's copies by this thread have landed (at step 0 K and V's
    // too); q is scaled by D^-0.5 * log2(e) in fp32 and rounded to the input
    // dtype in the 16-byte chunks this thread copied, so the scaling needs
    // no pass and no barrier of its own
    cp_async_wait<0>();
    for (int i = tid; i < BQ * (D / VEC); i += NTHREADS) {
      T* p = &Qb[(i / (D / VEC)) * LD + (i % (D / VEC)) * VEC];
      float4 x = *reinterpret_cast<float4*>(p);
      x = make_float4(x.x * qscale, x.y * qscale, x.z * qscale, x.w * qscale);
      *reinterpret_cast<float4*>(p) = x;

    }
    __syncthreads();  // the step's tiles are in place, and every thread is done with step it - 1
    // the next step's copies run while this one multiplies; its buffer was
    // last read in step it - 1
    if (it + 1 < s1) load_step(it + 1, buf ^ 1);

    // S^T = K Q^T and dP^T = V dO^T, [16 keys x BQ] a warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // split TF32: the hi*hi products in s and dp, the two small products
    // of each k step (lo*hi first) in sl and dpl, added before the bias.
    // Row stride D+4 keeps these 32-bit fragment loads free of bank
    // conflicts (rows g: banks 4g + t)
    float sl[NT][4], dpl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sl[j][e] = dpl[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = kk * 8 + t4;
      uint32_t kh[4], kl[4], vh[4], vl[4];
      split_tf32_trunc(Ks[r0 * LD + c], kh[0], kl[0]);
      split_tf32_trunc(Ks[(r0 + 8) * LD + c], kh[1], kl[1]);
      split_tf32_trunc(Ks[r0 * LD + c + 4], kh[2], kl[2]);
      split_tf32_trunc(Ks[(r0 + 8) * LD + c + 4], kh[3], kl[3]);
      split_tf32_trunc(Vs[r0 * LD + c], vh[0], vl[0]);
      split_tf32_trunc(Vs[(r0 + 8) * LD + c], vh[1], vl[1]);
      split_tf32_trunc(Vs[r0 * LD + c + 4], vh[2], vl[2]);
      split_tf32_trunc(Vs[(r0 + 8) * LD + c + 4], vh[3], vl[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = (j * 8 + g) * LD + c;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_trunc(Qb[o], bh0, bl0);
        split_tf32_trunc(Qb[o + 4], bh1, bl1);
        mma_tf32(sl[j], kl, bh0, bh1);
        mma_tf32(sl[j], kh, bl0, bl1);
        mma_tf32(s[j], kh, bh0, bh1);
        split_tf32_trunc(dOb[o], bh0, bl0);
        split_tf32_trunc(dOb[o + 4], bh1, bl1);
        mma_tf32(dpl[j], vl, bh0, bh1);
        mma_tf32(dpl[j], vh, bl0, bl1);
        mma_tf32(dp[j], vh, bh0, bh1);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += sl[j][e];
        dp[j][e] += dpl[j][e];
      }

    // P^T = exp2(s2 - lse2) and dS^T = (dP^T - delta) * P^T; s keeps P^T,
    // dp keeps dS^T rounded to the input dtype
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        const float p = exp2f((s[j][e] + kbias[r0 + (e >> 1) * 8]) - lse2b[c]);
        s[j][e] = p;
        dp[j][e] = to_float(from_float<T>((dp[j][e] - deltab[c]) * p));
      }
    // dS^T staged for dQ, [key][q]
    if constexpr (WITH_DQ) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(&dSs[(r0 + hh * 8) * LDS + j * 8 + 2 * t4]) =
              make_float2(dp[j][2 * hh], dp[j][2 * hh + 1]);
    }

    // dV += P^T dO and dK += dS^T Q, A fragments straight from the C layout
    // the k step j takes q rows 8j + 2t (index t) and 8j + 2t + 1 (index
    // t + 4), the columns of s[j] and dp[j] this thread holds; dO's and
    // q's B fragments read those two rows (banks 8t + g).  A step's
    // products, the small ones first, go to a fresh accumulator that one
    // FADD adds to dV or dK, so the tensor cores' additions never run
    // over the whole q range
    uint32_t ph[NT][4], pl[NT][4], dsh[NT][4], dsl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32_trunc(s[j][0], ph[j][0], pl[j][0]);
      split_tf32_trunc(s[j][2], ph[j][1], pl[j][1]);
      split_tf32_trunc(s[j][1], ph[j][2], pl[j][2]);
      split_tf32_trunc(s[j][3], ph[j][3], pl[j][3]);
      split_tf32_trunc(dp[j][0], dsh[j][0], dsl[j][0]);
      split_tf32_trunc(dp[j][2], dsh[j][1], dsl[j][1]);
      split_tf32_trunc(dp[j][1], dsh[j][2], dsl[j][2]);
      split_tf32_trunc(dp[j][3], dsh[j][3], dsl[j][3]);
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = (j * 8 + 2 * t4) * LD + dt * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_trunc(dOb[o], bh0, bl0);
        split_tf32_trunc(dOb[o + LD], bh1, bl1);
        mma_3xtf32(tv, ph[j], pl[j], bh0, bh1, bl0, bl1);
        split_tf32_trunc(Qb[o], bh0, bl0);
        split_tf32_trunc(Qb[o + LD], bh1, bl1);
        mma_3xtf32(tk, dsh[j], dsl[j], bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dva[dt][e] += tv[e];
        dka[dt][e] += tk[e];
      }
    }

    if constexpr (WITH_DQ) {
      __syncthreads();  // every warp's dS^T is staged
      // dQ of the step's q rows in split TF32, 16 at a time, warp w:
      // head-dim columns 32w ..; A = dS [q][key] read from the dS^T stage
      // (banks 24t + g at BQ 16), K's B fragment at keys 8kk + t and + 4
      // (banks 4t + g); the 24 products of the tile in one accumulator,
      // the small ones of each k step first
      constexpr int NB = DT / 4;
#pragma unroll 1
      for (int mt = 0; mt < BQ / 16; ++mt) {
        float acc[NB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
        for (int kk = 0; kk < KV_BK / 8; ++kk) {
          const float* a = &dSs[(kk * 8 + t4) * LDS + mt * 16 + g];
          uint32_t ah[4], al[4];
          split_tf32_trunc(a[0], ah[0], al[0]);
          split_tf32_trunc(a[8], ah[1], al[1]);
          split_tf32_trunc(a[4 * LDS], ah[2], al[2]);
          split_tf32_trunc(a[4 * LDS + 8], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const float* kb = &Ks[(kk * 8 + t4) * LD + warp * 32 + n * 8 + g];
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32_trunc(kb[0], bh0, bl0);
            split_tf32_trunc(kb[4 * LD], bh1, bl1);
            mma_3xtf32(acc[n], ah, al, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qi = q0 + mt * 16 + g + hh * 8;
          if (qi < Sq) {
            float* dst = dq_acc + (((size_t)b * Sq + qi) * H + h) * D + warp * 32;
#pragma unroll
            for (int n = 0; n < NB; ++n)
              atomicAdd(reinterpret_cast<float2*>(dst + n * 8 + 2 * t4),
                        make_float2(acc[n][2 * hh] * dqscale, acc[n][2 * hh + 1] * dqscale));
          }
        }
      }

    }
    // the next step's lse and delta land in the buffer step it - 1 used
    if (it + 1 < s1 && tid < BQ) {
      lse2s[(buf ^ 1) * BQ + tid] = lse2_next;
      deltas[(buf ^ 1) * BQ + tid] = delta_next;
    }
  }

  if (splits > 1) {
    // the q split: each block leaves its partial dK and dV in its own shared
    // memory, and after a cluster barrier each block sums a slice of the
    // keys over every block's partials, in rank order, through distributed
    // shared memory
    constexpr int LDM = D + 4;
    float* pk = reinterpret_cast<float*>(smem_raw);  // [KV_BK][LDM] dK, then dV
    float* pv = pk + KV_BK * LDM;
    __syncthreads();  // every warp is done with K, V and the q tiles
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int o = (r0 + hh * 8) * LDM + dt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(&pk[o]) = make_float2(dka[dt][2 * hh], dka[dt][2 * hh + 1]);
        *reinterpret_cast<float2*>(&pv[o]) = make_float2(dva[dt][2 * hh], dva[dt][2 * hh + 1]);
      }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rows = KV_BK / splits;
    for (int i = tid; i < rows * (D / 4); i += NTHREADS) {
      const int r = part * rows + i / (D / 4), c = (i % (D / 4)) * 4, kj = k0 + r;
      if (kj >= Sk) continue;
      float4 sk4 = make_float4(0.f, 0.f, 0.f, 0.f), sv4 = sk4;
      for (int cr = 0; cr < splits; ++cr) {
        const float4 a = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pk, cr) +
                                                          r * LDM + c);
        const float4 bv = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pv, cr) +
                                                           r * LDM + c);
        sk4 = make_float4(sk4.x + a.x, sk4.y + a.y, sk4.z + a.z, sk4.w + a.w);
        sv4 = make_float4(sv4.x + bv.x, sv4.y + bv.y, sv4.z + bv.z, sv4.w + bv.w);
      }
      const size_t o = (((size_t)b * Sk + kj) * H + h) * D + c;
      dk[o] = from_float<T>(sk4.x * dkscale);
      dk[o + 1] = from_float<T>(sk4.y * dkscale);
      dk[o + 2] = from_float<T>(sk4.z * dkscale);
      dk[o + 3] = from_float<T>(sk4.w * dkscale);
      dv[o] = from_float<T>(sv4.x);
      dv[o + 1] = from_float<T>(sv4.y);
      dv[o + 2] = from_float<T>(sv4.z);
      dv[o + 3] = from_float<T>(sv4.w);
    }
    cluster.sync();  // no block leaves while another reads its shared memory
    return;
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
// K9 dQ in fp32: one block per (64-row q tile, head, batch, key part)
// ---------------------------------------------------------------------------
// Warp w owns q rows 16w..16w+15 of the tile; each loop step takes DQ_BK
// keys.  S = q_s K^T and dP = dO V^T run as split TF32 (mma.m16n8k8 layouts
// above: A the q or dO rows, B the step's keys), P and dS on the
// accumulators; the C layout of dS becomes the A layout of dQ += dS K by
// naming the keys 8j+2t and 8j+2t+1 of ds[j] the k indices t and t+4, with
// K's B fragment read at those two keys (banks 8t + g).  dQ stays in
// registers (16 rows x D a warp); each step's products, the small ones of
// each k step first, go to a fresh accumulator that one FADD adds to it.
template <bool HAS_MASK>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const uint8_t* __restrict__ mask, float* __restrict__ dq, int reps, int Sq,
                        int Sk, int H, int splits, float qscale, float dqscale) {
  constexpr int LD = kLd<float>, VEC = kVec<float>;
  constexpr int NT = DQ_BK / 8;  // n8 tiles (S, dP) and k steps (dQ) over a key step

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [DQ_BQ][LD], scaled in place
  float* dOs = Qs + DQ_BQ * LD;
  float* Ks = dOs + DQ_BQ * LD;  // [2][DQ_BK][LD]
  float* Vs = Ks + 2 * DQ_BK * LD;
  float* kbias = Vs + 2 * DQ_BK * LD;  // [2][DQ_BK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int part = blockIdx.x % splits;  // the block's rank in its cluster
  const int q0 = (blockIdx.x / splits) * DQ_BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * 16 + g;  // this thread's q rows: r0 and r0 + 8 of the tile
  // the block's key steps: a contiguous part of the q tile's, split over the
  // blocks of its cluster (dq_splits keeps every part non-empty)
  const int nkt = (Sk + DQ_BK - 1) / DQ_BK;
  const int kt0 = (int)((long)nkt * part / splits), kt1 = (int)((long)nkt * (part + 1) / splits);

  load_rows(Qs, q, b, h, H, q0, DQ_BQ, Sq, tid);
  load_rows(dOs, dout, b, h, H, q0, DQ_BQ, Sq, tid);
  cp_async_commit();
  // K and V of key step kt into buffer buf, one commit group, and its key bias
  auto load_step = [&](int kt, int buf) {
    const int k0 = kt * DQ_BK;
    for (int i = tid; i < DQ_BK * (D / VEC); i += NTHREADS) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      const bool ok = k0 + r < Sk;
      const size_t kr = ok ? (size_t)k0 + r : 0;
      cp_async16(&Ks[(buf * DQ_BK + r) * LD + c], k + (((size_t)b * Sk + kr) * H + h) * D + c,
                 ok);
      cp_async16(&Vs[(buf * DQ_BK + r) * LD + c],
                 v + (((size_t)(b / reps) * Sk + kr) * H + h) * D + c, ok);
    }
    cp_async_commit();
    if (tid < DQ_BK) kbias[buf * DQ_BK + tid] = key_bias<HAS_MASK>(mask, b, k0 + tid, Sk);
  };
  load_step(kt0, 0);
  // this thread's rows' lse * log2(e) (+inf past Sq) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    const size_t o = ((size_t)b * H + h) * Sq + qi;
    lse2[i] = qi < Sq ? lse[o] * LOG2E_F : INFINITY;
    dlt[i] = qi < Sq ? delta[o] : 0.f;
  }
  // q and dO have landed for this thread: q is scaled by D^-0.5 * log2(e) in
  // the 16-byte chunks this thread copied, so the scaling needs no barrier of
  // its own
  cp_async_wait<1>();
  for (int i = tid; i < DQ_BQ * (D / VEC); i += NTHREADS) {
    float4* p = reinterpret_cast<float4*>(&Qs[(i / (D / VEC)) * LD + (i % (D / VEC)) * VEC]);
    const float4 x = *p;
    *p = make_float4(__fmul_rn(x.x, qscale), __fmul_rn(x.y, qscale), __fmul_rn(x.z, qscale),
                     __fmul_rn(x.w, qscale));
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    cp_async_wait<0>();
    __syncthreads();  // step kt's tiles are in place, and every warp is done with step kt - 1
    // the next step's copies run while this one multiplies; its buffer was
    // last read in step kt - 1
    if (kt + 1 < kt1) load_step(kt + 1, buf ^ 1);
    const float* Kb = Ks + buf * DQ_BK * LD;
    const float* Vb = Vs + buf * DQ_BK * LD;
    const float* kb = kbias + buf * DQ_BK;

    // S = q_s K^T and dP = dO V^T, [16 q rows x DQ_BK keys] a warp: the
    // hi*hi products in s and dp, the two small products of each k step
    // (lo*hi first) in sl and dpl, added before the bias.  Row stride D+4:
    // A reads rows g (banks 4g + t), B reads keys g (banks 4g + t)
    float s[NT][4], sl[NT][4], dp[NT][4], dpl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = dp[j][e] = dpl[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = kk * 8 + t4;
      uint32_t ah[4], al[4];
      split_tf32_trunc(Qs[r0 * LD + c], ah[0], al[0]);
      split_tf32_trunc(Qs[(r0 + 8) * LD + c], ah[1], al[1]);
      split_tf32_trunc(Qs[r0 * LD + c + 4], ah[2], al[2]);
      split_tf32_trunc(Qs[(r0 + 8) * LD + c + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = (j * 8 + g) * LD + c;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_trunc(Kb[o], bh0, bl0);
        split_tf32_trunc(Kb[o + 4], bh1, bl1);
        mma_tf32(sl[j], al, bh0, bh1);
        mma_tf32(sl[j], ah, bl0, bl1);
        mma_tf32(s[j], ah, bh0, bh1);
      }
      split_tf32_trunc(dOs[r0 * LD + c], ah[0], al[0]);
      split_tf32_trunc(dOs[(r0 + 8) * LD + c], ah[1], al[1]);
      split_tf32_trunc(dOs[r0 * LD + c + 4], ah[2], al[2]);
      split_tf32_trunc(dOs[(r0 + 8) * LD + c + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = (j * 8 + g) * LD + c;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_trunc(Vb[o], bh0, bl0);
        split_tf32_trunc(Vb[o + 4], bh1, bl1);
        mma_tf32(dpl[j], al, bh0, bh1);
        mma_tf32(dpl[j], ah, bl0, bl1);
        mma_tf32(dp[j], ah, bh0, bh1);
      }
    }

    // P = exp2(s2 + bias - lse2) and dS = (dP - delta) * P, split into the
    // A fragments of dQ += dS K (k index t: key 8j + 2t, t + 4: 8j + 2t + 1)
    uint32_t dsh[NT][4], dsl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(&kb[j * 8 + 2 * t4]);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(((s[j][e] + sl[j][e]) + ((e & 1) ? bb.y : bb.x)) - lse2[e >> 1]);
        ds[e] = ((dp[j][e] + dpl[j][e]) - dlt[e >> 1]) * p;
      }
      split_tf32_trunc(ds[0], dsh[j][0], dsl[j][0]);
      split_tf32_trunc(ds[2], dsh[j][1], dsl[j][1]);
      split_tf32_trunc(ds[1], dsh[j][2], dsl[j][2]);
      split_tf32_trunc(ds[3], dsh[j][3], dsl[j][3]);
    }
    // dQ += dS K: for each 8 head-dim columns, the step's NT k steps in a
    // fresh accumulator, added to dQ by one FADD, so the tensor cores'
    // additions never run over the whole key range
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float tq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* kr = Kb + (j * 8 + 2 * t4) * LD + dt * 8 + g;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32_trunc(kr[0], bh0, bl0);
        split_tf32_trunc(kr[LD], bh1, bl1);
        mma_3xtf32(tq, dsh[j], dsl[j], bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] += tq[e];
    }
  }

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r0 + 8 * i;
      if (qi < Sq) {
        float* dst = dq + (((size_t)b * Sq + qi) * H + h) * D + 2 * t4;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
          *reinterpret_cast<float2*>(dst + dt * 8) =
              make_float2(acc[dt][2 * i] * dqscale, acc[dt][2 * i + 1] * dqscale);
      }
    }
    return;
  }

  // the key split: each block leaves its partial dQ in its own shared memory
  // (the q and dO tiles' place), and after a cluster barrier each block sums
  // a slice of the q rows over every block's partial, in rank order, through
  // distributed shared memory: the same sums in the same order on every run
  constexpr int LDM = D + 4;
  float* pq = Qs;  // [DQ_BQ][LDM]
  __syncthreads();  // every warp is done with the q and dO tiles
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(&pq[(r0 + 8 * i) * LDM + dt * 8 + 2 * t4]) =
          make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = DQ_BQ / splits;
  for (int i = tid; i < rows * (D / 4); i += NTHREADS) {
    const int r = part * rows + i / (D / 4), c = (i % (D / 4)) * 4, qi = q0 + r;
    if (qi >= Sq) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cr = 0; cr < splits; ++cr) {
      const float4 a =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(pq, cr) + r * LDM + c);
      sum = make_float4(sum.x + a.x, sum.y + a.y, sum.z + a.z, sum.w + a.w);
    }
    *reinterpret_cast<float4*>(dq + (((size_t)b * Sq + qi) * H + h) * D + c) =
        make_float4(sum.x * dqscale, sum.y * dqscale, sum.z * dqscale, sum.w * dqscale);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Clusters of `splits` blocks of the dK/dV kernel that the current device
// holds at once (cached per instantiation and device), or 0 where the query
// fails.
template <typename T, bool HAS_MASK, bool WITH_DQ>
int kv_cluster_capacity(int splits) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  static int cache[64][2] = {};
  const int slot = splits == 1 ? 0 : 1;
  if (cache[dev][slot]) return cache[dev][slot];
  const int n = cluster_capacity(flash_bwd_kv_kernel<T, HAS_MASK, WITH_DQ>, NTHREADS,
                                 kv_smem_bytes<T, WITH_DQ>(), splits);
  if (n <= 0) return 0;
  cache[dev][slot] = n;
  return n;
}

// Blocks a key tile's q steps split across: 2 where the key tiles fill less
// than two waves of the blocks the card holds at once, else 1.  Below two
// waves some SMs run one block while others run two, or sit idle; halves
// of a tile even that out, at the cost of loading K and V twice and one
// merge.  Forced at the train step's fp32 sites (tools/torch_flash_ab.py
// --bwd, H100): cross, 198 key tiles on 264 resident blocks, 1 / 2 / 4
// ways 0.50 / 0.44 / 0.48 ms; ray self, 96 tiles, 0.36 / 0.26 / 0.27.
template <typename T, bool HAS_MASK, bool WITH_DQ>
int kv_splits(int B, int Sq, int Sk, int H) {
  const long tiles = (long)((Sk + KV_BK - 1) / KV_BK) * H * B;
  const int nsteps = (Sq + kKvBq<T> - 1) / kKvBq<T>;
  const int cap1 = kv_cluster_capacity<T, HAS_MASK, WITH_DQ>(1);
  if (nsteps < 2 || cap1 <= 0 || tiles >= 2L * cap1) return 1;
  return kv_cluster_capacity<T, HAS_MASK, WITH_DQ>(2) > 0 ? 2 : 1;
}

template <typename T, bool HAS_MASK, bool WITH_DQ>
cudaError_t launch_kv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* mask, void* dq_acc,
                      void* dk, void* dv, int B, int reps, int Sq, int Sk, int H, float qscale,
                      float dqscale, float dkscale, cudaStream_t stream) {
  constexpr size_t smem = kv_smem_bytes<T, WITH_DQ>();
  static_assert(smem >= (size_t)2 * KV_BK * (D + 4) * sizeof(float),
                "the q split's partial dK and dV reuse the tiles' shared memory");
  auto kern = flash_bwd_kv_kernel<T, HAS_MASK, WITH_DQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int splits = kv_splits<T, HAS_MASK, WITH_DQ>(B, Sq, Sk, H);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sk + KV_BK - 1) / KV_BK * splits, H, B);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dq_acc), static_cast<T*>(dk), static_cast<T*>(dv), reps, Sq, Sk, H,
      splits, qscale, dqscale, dkscale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of `splits` blocks of the fp32 dQ kernel that the current device
// holds at once (cached per device), or 0 where the query fails.
int dq_cluster_capacity(int splits) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  static int cache[64][3] = {};
  const int slot = splits == 1 ? 0 : splits == 2 ? 1 : 2;
  if (cache[dev][slot]) return cache[dev][slot];
  const int n =
      cluster_capacity(flash_bwd_dq_f32_kernel<true>, NTHREADS, dq_smem_bytes(), splits);
  if (n <= 0) return 0;
  cache[dev][slot] = n;
  return n;
}

// Blocks a q tile of the fp32 dQ kernel splits its key steps across: where
// the q tiles fill less than two waves of the blocks the card holds at once,
// of 2 and 4 (at most the key steps) the count whose grid takes the fewest
// waves of the card's clusters per unit of work, ceil(tiles / capacity(s))
// / s; 4 must win by more than 10 %, for the wider merge; else 1.
int dq_splits(int B, int Sq, int Sk, int H) {
  const long tiles = (long)((Sq + DQ_BQ - 1) / DQ_BQ) * H * B;
  const int nkt = (Sk + DQ_BK - 1) / DQ_BK;
  const int cap1 = dq_cluster_capacity(1);
  if (cap1 <= 0 || tiles >= 2L * cap1 || nkt < 2) return 1;
  int best = 1;
  double best_cost = 0.0;
  for (int s = 2; s <= DQ_MAX_SPLITS && s <= nkt; s *= 2) {
    const int cap = dq_cluster_capacity(s);
    if (cap <= 0) break;
    const double cost = (double)((tiles + cap - 1) / cap) / s;
    if (best == 1 || cost < 0.9 * best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <bool HAS_MASK>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const void* mask, void* dq, int B,
                          int reps, int Sq, int Sk, int H, float qscale, float dqscale,
                          cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes();
  static_assert(smem >= (size_t)DQ_BQ * (D + 4) * sizeof(float),
                "the key split's partial dQ reuses the q tile's shared memory");
  auto kern = flash_bwd_dq_f32_kernel<HAS_MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int splits = dq_splits(B, Sq, Sk, H);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sq + DQ_BQ - 1) / DQ_BQ * splits, H, B);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), static_cast<float*>(dq), reps, Sq, Sk, H, splits,
      qscale, dqscale);
  if (err != cudaSuccess) return err;
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
    return flash_bwd_sm90(q, k, v, dout, lse, delta, has_mask ? mask : nullptr, dq_acc, dk, dv,
                          B, reps, Sq, Sk, H, qscale, dqscale, dkscale, s);
  if (dtype == kF32)
    return kv_variant<float>(has_mask, q, k, v, dout, lse, delta, mask, dq_acc, dk, dv, B,
                             reps, Sq, Sk, H, qscale, dqscale, dkscale, s);
  return cudaErrorInvalidValue;
}

// K9's dQ kernel: the same inputs, dq [B,Sq,H,D] in the input dtype; bf16
// runs flash_bwd_dq_sm90.cu.
extern "C" int rf_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* mask, void* dq,
                               int dtype, int has_mask, int B, int reps, int Sq, int Sk, int H,
                               int Dh, float qscale, float dqscale, void* stream) {
  if (bad_shape(B, reps, Sq, Sk, H, Dh)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return flash_bwd_dq_sm90(q, k, v, dout, lse, delta, has_mask ? mask : nullptr, dq, B, reps,
                             Sq, Sk, H, qscale, dqscale, s);
  if (dtype != kF32) return cudaErrorInvalidValue;
  // 16-byte copies of q, dO, K and V, and stores of the merged rows
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return cudaErrorMisalignedAddress;
  if (has_mask)
    return launch_dq_f32<true>(q, k, v, dout, lse, delta, mask, dq, B, reps, Sq, Sk, H, qscale,
                               dqscale, s);
  return launch_dq_f32<false>(q, k, v, dout, lse, delta, mask, dq, B, reps, Sq, Sk, H, qscale,
                              dqscale, s);
}

// Rows of q one block of K9's dQ kernel takes at this grid on the current
// device: the bf16 kernel's plan (128 or 64), the fp32 kernel's 64.
extern "C" int rf_flash_bwd_dq_rows(int dtype, int B, int Sq, int H) {
  if (dtype == kBF16) return flash_bwd_dq_sm90_rows(B, Sq, H);
  if (dtype == kF32) return DQ_BQ;
  return 0;
}

// Blocks (one thread block cluster) that share the keys of a q tile of K9's
// dQ kernel at this grid on the current device: the fp32 kernel's 1, 2 or
// 4, their partial dQ summed in rank order; 1 in bf16.
extern "C" int rf_flash_bwd_dq_splits(int dtype, int B, int Sq, int Sk, int H) {
  if (dtype == kBF16) return 1;
  if (dtype == kF32) return dq_splits(B, Sq, Sk, H);
  return 0;
}

// Blocks (one thread block cluster) that share a key tile's q steps in the
// dK/dV kernel at this grid on the current device (K8's masked
// instantiation; K9's dK/dV kernel has the same shared memory and grid); the
// bf16 kernel does not split.
extern "C" int rf_flash_bwd_splits(int dtype, int B, int Sq, int Sk, int H) {
  if (dtype == kBF16) return 1;
  if (dtype == kF32) return kv_splits<float, true, true>(B, Sq, Sk, H);
  return 0;
}

// Keys a block of the dK/dV kernel owns.
extern "C" int rf_flash_bwd_keys(int dtype) {
  if (dtype == kBF16) return FLASH_BWD_SM90_KEYS;
  if (dtype == kF32) return KV_BK;
  return 0;
}
