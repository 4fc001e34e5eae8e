// K9's dQ kernel in bf16 for Hopper: dQ of the deterministic two-kernel
// flash backward, masked and unmasked.
//
// Replaces renderformer_tpu/ops/flash_attention.py:323 _bwd_dq_kernel
// (through _flash_bwd_twokernel) in bf16; the fp32 dQ kernel stays in
// flash_bwd.cu.  The semantics are those listed at the top of flash_bwd.cu:
// q scaled by D^-0.5*log2(e) in fp32 and rounded to bf16; P = exp2(s2 + bias
// - lse*log2(e)) with -1e30 on a masked key, -inf past Sk, lse = +inf on rows
// past Sq; dS = (dP - delta)*P rounded to bf16 before dQ = dS.K, which takes
// D^-0.5 at the end; V at batch b / reps.
//
// Bound on this card: three products of Sq x Sk x D per (b, h), 6*Sq*Sk*D
// flops against ~(4*Sq + 2*Sk)*D*2 bytes, far above the ~295 flop/byte
// ridge, so the tensor cores bound it and only wgmma reaches their rate.
// Design (the bf16 forward's, flash_fwd_sm90.cu, with a third product):
//   * one block a (q tile, head, batch) of one or two warpgroups, 64 q rows
//     each: 128 rows (one block an SM) or 64 (two blocks an SM) as the
//     forward's plan picks them (flash_fwd_sm90_rows);
//   * the prologue scales q in fp32, rounds it to bf16 and writes it, and
//     dO, once into 128-byte-swizzled K-major shared memory;
//   * K and V tiles of BK keys arrive by TMA (4-D tensor maps over [B, S, H,
//     D], 128-byte swizzle, keys past Sk zero-filled, V at b / reps) into a
//     ring of two stages, each with a full and an empty mbarrier.  Thread 0
//     issues the loads of tile j+2 once every warp has released tile j: no
//     producer warp, since a fifth warp of a 64-row block (or a third
//     warpgroup) caps every thread at 168 registers (flash_bwd_sm90.cu), and
//     this kernel holds dQ's 64 accumulators beside S's and dP's 32 each;
//   * S = q K^T and dP = dO V^T are wgmma m64n64k16 with both operands in
//     shared memory, in two commit groups, so P is computed on S's registers
//     while dP is on the tensor cores; dS = (dP - delta)*P is packed into bf16
//     A fragments, and dQ += dS K is wgmma m64n128k16 with A from registers
//     and K MN-major in shared memory (the forward's P.V);
//   * dQ stays in registers through the key loop and is written once: no
//     atomics, the same sums in the same order on every run.
#include <cuda.h>

#include "common.cuh"
#include "flash_bwd_dq_sm90.cuh"
#include "flash_fwd_sm90.cuh"
#include "sm90.cuh"

using namespace rf;

namespace {

constexpr int D = 128;
constexpr int BK = 64;                  // keys a stage
constexpr int STAGES = 2;
constexpr int HALF_BYTES = 64 * 128;    // one warpgroup's 64 q rows, one 64-column half
constexpr int TILE_BYTES = BK * D * 2;  // one K or V stage, two boxes
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E_F = 1.4426950408889634f;

// Shared memory: q and dO of each warpgroup (two 64-column halves each),
// the K and V rings, then the barriers (full, then empty, a stage each).
template <int NWG>
struct Smem {
  static constexpr int Q_OFF = 0;
  static constexpr int DO_OFF = NWG * 2 * HALF_BYTES;
  static constexpr int K_OFF = 2 * NWG * 2 * HALF_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
};

// Accumulator layout of wgmma m64nN (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): register 4j + e holds row 16w + g + 8(e / 2), column
// 8j + 2t + e % 2.  For S and dP the columns are the tile's keys; the A
// fragment of dQ's k step kk (keys 16kk..16kk+15) takes the pairs of
// registers 4(2kk) + {0,1}, + {2,3}, 4(2kk+1) + {0,1}, + {2,3}.  For dQ the
// columns are the head dim.
template <int NWG, bool HAS_MASK>
__global__ void __launch_bounds__(NWG * 128, NWG == 1 ? 2 : 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                         __nv_bfloat16* __restrict__ dq, int reps, int Sq, int Sk, int H,
                         float qscale, float dqscale) {
  using S = Smem<NWG>;
  constexpr int KS = BK / 16;  // k steps of dQ += dS K a tile

  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it (an
  // offset from smem_raw, so that the compiler keeps shared-memory accesses)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + S::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, ct = tid % 128;  // warpgroup, thread in it
  const int w = ct / 32, g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * (64 * NWG) + wg * 64;  // first q row of this warpgroup
  const int nkt = (Sk + BK - 1) / BK;
  const size_t row_stride = (size_t)H * D;

  // K and V of tile kt into its stage by TMA (thread 0), completing on the
  // stage's full barrier
  auto load_tile = [&](int kt) {
    const int s = kt % STAGES, k0 = kt * BK, bkv = b / reps;
    const uint32_t kd = base + S::K_OFF + s * TILE_BYTES, vd = base + S::V_OFF + s * TILE_BYTES;
    mbar_expect_tx(full(s), 2 * TILE_BYTES);
    tma_load_4d(kd, &tmk, full(s), 0, h, k0, b);
    tma_load_4d(kd + BK * 128, &tmk, full(s), 64, h, k0, b);
    tma_load_4d(vd, &tmv, full(s), 0, h, k0, bkv);
    tma_load_4d(vd + BK * 128, &tmv, full(s), 64, h, k0, bkv);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NWG * 4);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < STAGES && kt < nkt; ++kt) load_tile(kt);

  // prologue: q scaled by D^-0.5 * log2(e) in fp32 and rounded to bf16, and
  // dO, into this warpgroup's tiles in the 128-byte-swizzled K-major layout
  // (16-byte chunk c of row r at chunk c ^ (r % 8)), zeros past Sq
  unsigned char* qs = smem + S::Q_OFF + wg * 2 * HALF_BYTES;
  unsigned char* dos = smem + S::DO_OFF + wg * 2 * HALF_BYTES;
  for (int item = ct; item < 64 * 16; item += 128) {
    const int r = item >> 4, c16 = item & 15, qi = row0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0), ov = qv;
    if (qi < Sq) {
      const size_t o = ((size_t)b * Sq + qi) * row_stride + (size_t)h * D + c16 * 8;
      const uint4 xv = *reinterpret_cast<const uint4*>(q + o);
      ov = *reinterpret_cast<const uint4*>(dout + o);
      const uint32_t* x32 = reinterpret_cast<const uint32_t*>(&xv);
      uint32_t* q32 = reinterpret_cast<uint32_t*>(&qv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x32[e]));
        q32[e] = pack_bf16(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
      }
    }
    const int off = (c16 >> 3) * HALF_BYTES + r * 128 + (((c16 & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(qs + off) = qv;
    *reinterpret_cast<uint4*>(dos + off) = ov;
  }
  // this thread's rows' lse * log2(e) (+inf past Sq) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + w * 16 + g + 8 * i;
    const size_t o = ((size_t)b * H + h) * Sq + qi;
    lse2[i] = qi < Sq ? lse[o] * LOG2E_F : INFINITY;
    dl[i] = qi < Sq ? delta[o] : 0.f;
  }
  // the generic-proxy stores must be visible to wgmma (the async proxy)
  fence_async_smem();
  bar_sync(1 + wg, 128);

  float dqa[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dqa[i] = 0.f;
  float sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  uint32_t sa[KS][4];

  // k step kk of a K-major operand: 32 bytes (2 in 16-byte units) into a
  // 64-column half; the second half HALF_BYTES (q, dO) or BK * 128 bytes (K,
  // V) further
  const uint32_t q_lo = desc_lo(base + S::Q_OFF + wg * 2 * HALF_BYTES, 16);
  const uint32_t do_lo = desc_lo(base + S::DO_OFF + wg * 2 * HALF_BYTES, 16);
  auto a_k = [&](uint32_t lo, int kk) {
    return lo + (kk >> 2) * (HALF_BYTES >> 4) + (kk & 3) * 2;
  };
  auto b_k = [&](uint32_t lo, int kk) { return lo + (kk >> 2) * (BK * 128 >> 4) + (kk & 3) * 2; };

  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt % STAGES, k0 = kt * BK;
    const uint32_t k_addr = base + S::K_OFF + s * TILE_BYTES;
    const uint32_t v_lo = desc_lo(base + S::V_OFF + s * TILE_BYTES, 16);
    const uint32_t k_lo = desc_lo(k_addr, 16);
    mbar_wait(full(s), (kt / STAGES) & 1);
    // S = q K^T, then dP = dO V^T: eight k steps of 16 over D each, the
    // first overwriting the accumulator; one commit group each
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(sc, a_k(q_lo, kk), b_k(k_lo, kk), DESC_HI, kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(dp, a_k(do_lo, kk), b_k(v_lo, kk), DESC_HI, kk > 0);
    wgmma_commit();

    // the key bias of this thread's 16 keys, 8j + 2t + e: -inf past Sk,
    // -1e30 where masked, read while the products run
    float kb[16];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * j + 2 * t4 + e;
        kb[2 * j + e] = kj >= Sk                                            ? -INFINITY
                        : (HAS_MASK && mask[(size_t)b * Sk + kj] == 0) ? NEG_BIG
                                                                         : 0.f;
      }

    // P = exp2(s2 + bias - lse2) on S's registers while dP runs
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = exp2f((sc[4 * j + e] + kb[2 * j + (e & 1)]) - lse2[e >> 1]);
    // dS = (dP - delta) * P, packed to bf16 into the A fragments of dQ
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * kk + u;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = __fmul_rn(__fsub_rn(dp[4 * j + e], dl[e >> 1]), sc[4 * j + e]);
        sa[kk][2 * u] = pack_bf16(ds[0], ds[1]);
        sa[kk][2 * u + 1] = pack_bf16(ds[2], ds[3]);
      }

    // dQ += dS K: A from registers, K MN-major (its two 64-column boxes
    // BK * 128 bytes apart), 16 keys (2048 B) a k step
    fence_regs(dqa);
    fence_regs(sa);
    wgmma_fence();
    const uint32_t k_mn = desc_lo(k_addr, BK * 128);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_rs_mn(dqa, sa[kk], k_mn + kk * (2048 >> 4), DESC_HI);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);

    // every warp releases the stage once it is done with it; thread 0 then
    // loads tile kt + STAGES into it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    if (tid == 0 && kt + STAGES < nkt) {
      mbar_wait(empty(s), (kt / STAGES) & 1);
      load_tile(kt + STAGES);
    }
    __syncwarp();
  }

  // epilogue: dQ times D^-0.5, rounded to bf16, written once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + w * 16 + g + 8 * i;
    if (qi < Sq) {
      __nv_bfloat16* dst = dq + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D + 2 * t4;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(dqa[4 * j + 2 * i] * dqscale, dqa[4 * j + 2 * i + 1] * dqscale);
    }
  }
}

// ---- host side ----

template <int NWG, bool HAS_MASK>
cudaError_t launch(const CUtensorMap& tmk, const CUtensorMap& tmv, const void* q,
                   const void* dout, const void* lse, const void* delta, const void* mask,
                   void* dq, int B, int reps, int Sq, int Sk, int H, float qscale, float dqscale,
                   cudaStream_t stream) {
  constexpr int smem = Smem<NWG>::BYTES;
  auto kern = flash_bwd_dq_sm90_kernel<NWG, HAS_MASK>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + 64 * NWG - 1) / (64 * NWG), H, B);
  kern<<<grid, NWG * 128, smem, stream>>>(
      tmk, tmv, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(dq), reps, Sq, Sk, H,
      qscale, dqscale);
  return cudaGetLastError();
}

template <int NWG>
cudaError_t launch_rows(const CUtensorMap& tmk, const CUtensorMap& tmv, const void* q,
                        const void* dout, const void* lse, const void* delta, const void* mask,
                        void* dq, int B, int reps, int Sq, int Sk, int H, float qscale,
                        float dqscale, cudaStream_t stream) {
  if (mask)
    return launch<NWG, true>(tmk, tmv, q, dout, lse, delta, mask, dq, B, reps, Sq, Sk, H,
                             qscale, dqscale, stream);
  return launch<NWG, false>(tmk, tmv, q, dout, lse, delta, mask, dq, B, reps, Sq, Sk, H, qscale,
                            dqscale, stream);
}

}  // namespace

namespace rf {

int flash_bwd_dq_sm90_rows(int B, int Sq, int H) { return flash_fwd_sm90_rows(B, Sq, H); }

int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* mask, void* dq, int B,
                      int reps, int Sq, int Sk, int H, float qscale, float dqscale,
                      cudaStream_t stream) {
  // 16-byte loads of q and dO and stores' rows, the TMA boxes' bases
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return cudaErrorMisalignedAddress;
  CUtensorMap tmk, tmv;
  cudaError_t err = kv_map(&tmk, k, B, Sk, H, BK);
  if (err == cudaSuccess) err = kv_map(&tmv, v, B / reps, Sk, H, BK);
  if (err != cudaSuccess) return err;
  if (flash_bwd_dq_sm90_rows(B, Sq, H) == 64)
    return launch_rows<1>(tmk, tmv, q, dout, lse, delta, mask, dq, B, reps, Sq, Sk, H, qscale,
                          dqscale, stream);
  return launch_rows<2>(tmk, tmv, q, dout, lse, delta, mask, dq, B, reps, Sq, Sk, H, qscale,
                        dqscale, stream);
}

}  // namespace rf
