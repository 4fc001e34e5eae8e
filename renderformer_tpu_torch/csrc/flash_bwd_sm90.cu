// The bf16 flash-attention backward for Hopper: K8 (dQ, dK and dV in one
// pass, dQ by fp32 atomics) and K9's dK/dV kernel (the same code without
// dQ), masked and unmasked.
//
// Replaces renderformer_tpu/ops/flash_attention.py:425 _bwd_fused_kernel
// (through _flash_bwd_fused) and :368 _bwd_dkv_kernel (through
// _flash_bwd_twokernel) in bf16; the fp32 kernels and K9's dQ kernel stay in
// flash_bwd.cu.  The semantics are those listed at the top of flash_bwd.cu:
// q scaled by D^-0.5*log2(e) in fp32 and rounded to bf16 before S and dK;
// P = exp2(s2 + bias - lse*log2(e)) with -1e30 on a masked key, -inf past
// Sk, lse = +inf on rows past Sq; dS = (dP - delta)*P and P rounded to bf16
// before their products; dK times 1/log2(e) and dQ times D^-0.5 at the end;
// V at batch b / reps.
//
// Bound on this card: five products of Sq x Sk x D per (b, h), 10*Sq*Sk*D
// flops against ~4*(Sq+Sk)*D*2 bytes, far above the ~295 flop/byte ridge, so
// the tensor cores bound it and only wgmma reaches their rate.  Design (the
// forward's, flash_fwd_sm90.cu, turned around the key tile):
//   * one block of two warpgroups a (128-key tile, head, batch); warpgroup w
//     owns keys 64w.. of the tile;
//   * K and V of the tile arrive once by TMA (4-D tensor maps over
//     [B, S, H, D], 128-byte swizzle, keys past Sk zero-filled, V at b / reps)
//     and stay in shared memory;
//   * the q and dO tiles of each 64-row q step, with the rows' lse*log2(e)
//     and delta, stream through a ring of two stages: thread 0 issues the
//     TMA loads of step i+1 once every warp is done with step i-1, each
//     stage completing on a full mbarrier; TMA zero-fills rows past Sq.
//     There is no producer warp: a ninth warp puts three warps on one of the
//     SM's four schedulers, which caps every thread at 168 registers, and
//     with one ptxas serialised the wgmmas and spilled whatever setmaxnreg
//     asked for (24 or 40 against 232 or 240); with 256 threads each may
//     hold 255;
//   * the warps scale the landed q tile in place (an elementwise pass, free
//     of the swizzle), then, for each 32-row half of the step, each
//     warpgroup runs S^T = K q^T and dP^T = V dO^T as wgmma m64n32k16 with
//     both operands in shared memory, computes P^T and dS^T on the
//     accumulators' registers, and runs dV += P^T dO and dK += dS^T q as
//     wgmma m64n128k16 with A packed from those registers and B MN-major in
//     shared memory (the forward's P.V); dK and dV stay in registers
//     through the whole q loop.  Half steps keep S^T and dP^T at 16
//     registers each beside dK and dV's 128 (230 a thread in all; a whole
//     64-row step would need 32 more);
//   * K8 stages dS^T in shared memory (the 128-byte-swizzled MN-major
//     layout), and warpgroup w multiplies dQ[:, 64w:64w+64] = dS K over all
//     the tile's keys as wgmma m64n64k16 with both operands MN-major (A read
//     transposed), added to the fp32 scratch by float2 atomics (a TMA bulk
//     reduce-add of each row from shared memory read 7 % slower on an H100
//     80GB HBM3 at 700 W, tools/torch_flash_ab.py --bwd);
//   * the epilogue writes dK and dV through shared memory by TMA stores,
//     which drop the keys past Sk.
// 17 key tiles a head at the train step's 2064 keys: 102 blocks, one an SM
// (230 registers x 256 threads).  Tiles of 64 keys, two blocks an SM (198
// blocks), read 40 % slower there (the same card and tool).
#include "common.cuh"
#include "flash_bwd_sm90.cuh"
#include "sm90.cuh"

using namespace rf;

namespace {

constexpr int D = 128;
constexpr int BKB = FLASH_BWD_SM90_KEYS;  // keys a block
constexpr int NC = 2 * 128;               // threads: two warpgroups of 64 keys
constexpr int BQ = 64;                    // q rows a loop step (a stage; dQ's rows)
constexpr int BH = 32;                    // q rows a half step (S^T, dP^T, dV, dK)
constexpr int KS = BH / 16;               // k steps of dV and dK a half step
constexpr int STAGES = 2;
constexpr int TILE_Q = BQ * D * 2;        // one q or dO stage, two 64-column boxes
constexpr int KV_TILE = BKB * D * 2;      // K or V, two boxes
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E_F = 1.4426950408889634f;

// Shared memory: K and V of the tile, the q and dO rings, the dS^T stage
// [keys][BQ] bf16, the rows' lse*log2(e) and delta of each stage, and the
// barriers (K/V, then each stage).  The epilogue reuses the q and dO rings
// for dK and dV.
constexpr int K_OFF = 0;
constexpr int V_OFF = K_OFF + KV_TILE;
constexpr int Q_OFF = V_OFF + KV_TILE;
constexpr int DO_OFF = Q_OFF + STAGES * TILE_Q;
constexpr int DS_OFF = DO_OFF + STAGES * TILE_Q;
constexpr int LSE_OFF = DS_OFF + BKB * BQ * 2;
constexpr int DELTA_OFF = LSE_OFF + STAGES * BQ * 4;
constexpr int BAR_OFF = DELTA_OFF + STAGES * BQ * 4;
constexpr int SMEM_BYTES = BAR_OFF + (1 + STAGES) * 8 + 1024;  // + alignment slack
static_assert(2 * STAGES * TILE_Q >= 2 * 4 * 64 * 128,
              "the epilogue stages each warpgroup's dK and dV in the q and dO rings");

// Accumulator layout of wgmma m64nN (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): register 4j + e holds row 16w + g + 8(e / 2), column
// 8j + 2t + e % 2.  For S^T and dP^T the rows are the warpgroup's keys and
// the columns the half step's q rows; the A fragment of dV and dK for q rows
// 16kk..16kk+15 takes the pairs of registers 4(2kk) + {0,1}, + {2,3},
// 4(2kk+1) + {0,1}, + {2,3}.  For dQ the rows are q rows and the columns
// head-dim columns of the warpgroup's half.
template <bool WITH_DQ>
__global__ void __launch_bounds__(NC, 1)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmdo,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __grid_constant__ CUtensorMap tmdk,
                      const __grid_constant__ CUtensorMap tmdv, const float* __restrict__ lse,
                      const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                      float* __restrict__ dq_acc, int reps, int Sq, int Sk, int H,
                      float qscale, float dqscale, float dkscale) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it (an
  // offset from smem_raw, so that the compiler keeps shared-memory accesses)
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* lse2s = reinterpret_cast<float*>(smem + LSE_OFF);
  float* deltas = reinterpret_cast<float*>(smem + DELTA_OFF);
  const uint32_t kv_full = base + BAR_OFF;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128, ct = tid % 128;  // warpgroup, thread in it
  const int w = ct / 32, g = lane >> 2, t4 = lane & 3;
  const int kl0 = wg * 64 + w * 16 + g;  // this thread's keys: kl0 and kl0 + 8 of the tile
  const int k0 = blockIdx.x * BKB, h = blockIdx.y, b = blockIdx.z;
  const int nsteps = (Sq + BQ - 1) / BQ;

  // q and dO of step it into its stage by TMA (thread 0), and the step's
  // rows' lse * log2(e) (+inf past Sq) and delta
  auto load_step = [&](int it) {
    const int s = it % STAGES, q0 = it * BQ;
    if (tid == 0) {
      const uint32_t qt = base + Q_OFF + s * TILE_Q, dot = base + DO_OFF + s * TILE_Q;
      mbar_expect_tx(full(s), 2 * TILE_Q);
      tma_load_4d(qt, &tmq, full(s), 0, h, q0, b);
      tma_load_4d(qt + BQ * 128, &tmq, full(s), 64, h, q0, b);
      tma_load_4d(dot, &tmdo, full(s), 0, h, q0, b);
      tma_load_4d(dot + BQ * 128, &tmdo, full(s), 64, h, q0, b);
    }
    if (tid < BQ) {
      const int qi = q0 + tid;
      const size_t o = ((size_t)b * H + h) * Sq + qi;
      lse2s[s * BQ + tid] = qi < Sq ? lse[o] * LOG2E_F : INFINITY;
      deltas[s * BQ + tid] = qi < Sq ? delta[o] : 0.f;
    }
  };

  if (tid == 0) {
    for (int s = 0; s <= STAGES; ++s) mbar_init(kv_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const int bkv = b / reps;
    mbar_expect_tx(kv_full, 2 * KV_TILE);
    tma_load_4d(base + K_OFF, &tmk, kv_full, 0, h, k0, b);
    tma_load_4d(base + K_OFF + BKB * 128, &tmk, kv_full, 64, h, k0, b);
    tma_load_4d(base + V_OFF, &tmv, kv_full, 0, h, k0, bkv);
    tma_load_4d(base + V_OFF + BKB * 128, &tmv, kv_full, 64, h, k0, bkv);
  }
  for (int it = 0; it < STAGES && it < nsteps; ++it) load_step(it);

  // the key bias of this thread's two keys: -inf past Sk, -1e30 masked
  float kb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + kl0 + 8 * i;
    kb[i] = kj >= Sk ? -INFINITY : (mask && mask[(size_t)b * Sk + kj] == 0) ? NEG_BIG : 0.f;
  }

  float dva[64], dka[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dva[i] = dka[i] = 0.f;
  float sc[16], dp[16], dq[32];
  uint32_t pa[KS][4], sa[KS][4];

  // K-major A of S^T and dP^T: this warpgroup's 64 key rows of each box
  const uint32_t k_lo = desc_lo(base + K_OFF + wg * 64 * 128, 16);
  const uint32_t v_lo = desc_lo(base + V_OFF + wg * 64 * 128, 16);
  // k step kk of a K-major operand: 32 bytes (2 in 16-byte units) into a
  // 64-column box; the second box BKB (K, V) or BQ (q, dO) rows of 128
  // bytes further
  auto kv_k = [&](uint32_t lo, int kk) {
    return lo + (kk >> 2) * (BKB * 128 >> 4) + (kk & 3) * 2;
  };
  auto q_k = [&](uint32_t lo, int kk) {
    return lo + (kk >> 2) * (BQ * 128 >> 4) + (kk & 3) * 2;
  };

  mbar_wait(kv_full, 0);
  for (int it = 0; it < nsteps; ++it) {
    const int s = it % STAGES, q0 = it * BQ;
    const uint32_t q_addr = base + Q_OFF + s * TILE_Q;
    const uint32_t do_addr = base + DO_OFF + s * TILE_Q;
    mbar_wait(full(s), (it / STAGES) & 1);
    // q scaled by D^-0.5 * log2(e) in fp32 and rounded to bf16 in place,
    // the threads sharing the tile's 16-byte chunks
    {
      uint4* qt = reinterpret_cast<uint4*>(smem + Q_OFF + s * TILE_Q);
#pragma unroll
      for (int i = tid; i < TILE_Q / 16; i += NC) {
        uint4 x = qt[i];
        uint32_t* x32 = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x32[e]));
          x32[e] = pack_bf16(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
        }
        qt[i] = x;
      }
    }
    // visible to wgmma; every warp is done with the last step: its dS^T and
    // its stage, which takes the next step's q and dO (a whole step for the
    // load to land)
    fence_async_smem();
    __syncthreads();
    if (it >= 1 && it + 1 < nsteps) load_step(it + 1);

    // two half steps of BH q rows: S^T, dP^T, P^T, dS^T, dV and dK of one
    // half at a time
#pragma unroll
    for (int hs = 0; hs < BQ / BH; ++hs) {
      // S^T = K q^T and dP^T = V dO^T: eight k steps of 16 over D each, the
      // first overwriting the accumulator; B the half's rows
      const uint32_t q_lo = desc_lo(q_addr + hs * BH * 128, 16);
      const uint32_t do_lo = desc_lo(do_addr + hs * BH * 128, 16);
      wgmma_fence();
      wgmma_64x32<false>(sc, k_lo, q_lo, DESC_HI);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_64x32<true>(sc, kv_k(k_lo, kk), q_k(q_lo, kk), DESC_HI);
      wgmma_64x32<false>(dp, v_lo, do_lo, DESC_HI);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_64x32<true>(dp, kv_k(v_lo, kk), q_k(do_lo, kk), DESC_HI);
      wgmma_commit();

      // P^T = exp2(s2 + bias - lse2) and dS^T = (dP^T - delta) * P^T on the
      // accumulators, packed to bf16 into the A fragments of dV and dK 16 q
      // rows (two j) at a time (this wait also retires the last half step's
      // dV and dK, which read the fragments)
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const float* l2 = lse2s + s * BQ + hs * BH;
      const float* dl = deltas + s * BQ + hs * BH;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 2 * kk + u;
          const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * t4);
          const float2 dd = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4);
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2f((sc[4 * j + e] + kb[e >> 1]) - ((e & 1) ? l.y : l.x));
            ds[e] = __fmul_rn(__fsub_rn(dp[4 * j + e], (e & 1) ? dd.y : dd.x), p[e]);
          }
          pa[kk][2 * u] = pack_bf16(p[0], p[1]);
          pa[kk][2 * u + 1] = pack_bf16(p[2], p[3]);
          sa[kk][2 * u] = pack_bf16(ds[0], ds[1]);
          sa[kk][2 * u + 1] = pack_bf16(ds[2], ds[3]);
        }
      }
      if constexpr (WITH_DQ) {
        // dS^T into its stage, [key][q] in 128-byte rows, 16-byte chunk c of
        // row r at c ^ (r % 8) (r % 8 = g): conflict-free 32-bit stores of
        // the packed fragments (q rows 8j + 2t, + 1 of the half, keys kl0
        // and kl0 + 8)
        unsigned char* dst = smem + DS_OFF;
#pragma unroll
        for (int j = 0; j < BH / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<uint32_t*>(dst + (kl0 + 8 * i) * 128 +
                                         (((hs * BH / 8 + j) ^ g) << 4) + 4 * t4) =
                sa[j >> 1][2 * (j & 1) + i];
      }

      // dV += P^T dO and dK += dS^T q: A from registers, B MN-major (the two
      // 64-column boxes BQ * 128 bytes apart), 16 q rows (2048 B) a k step
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(sa);
      wgmma_fence();
      const uint32_t do_mn = desc_lo(do_addr + hs * BH * 128, BQ * 128);
      const uint32_t q_mn = desc_lo(q_addr + hs * BH * 128, BQ * 128);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_rs_mn(dva, pa[kk], do_mn + kk * (2048 >> 4), DESC_HI);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_rs_mn(dka, sa[kk], q_mn + kk * (2048 >> 4), DESC_HI);
      wgmma_commit();
    }
    if constexpr (WITH_DQ) {
      // dQ[:, 64 wg ..] of the step's q rows = dS K over the tile's keys: A
      // the dS^T stage, B K's column box wg, both MN-major, 16 keys (2048 B)
      // a k step
      fence_async_smem();
      bar_sync(1, NC);  // every warp's dS^T is staged
      const uint32_t ds_lo = desc_lo(base + DS_OFF, BQ * 128);
      const uint32_t kt_lo = desc_lo(base + K_OFF + wg * BKB * 128, BKB * 128);
      wgmma_fence();
      wgmma_64x64_mn<false>(dq, ds_lo, kt_lo, DESC_HI);
#pragma unroll
      for (int kk = 1; kk < BKB / 16; ++kk)
        wgmma_64x64_mn<true>(dq, ds_lo + kk * (2048 >> 4), kt_lo + kk * (2048 >> 4), DESC_HI);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    if constexpr (WITH_DQ) {
      fence_regs(dq);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + w * 16 + g + 8 * i;
        if (qi < Sq) {
          float* dst = dq_acc + (((size_t)b * Sq + qi) * H + h) * D + wg * 64 + 2 * t4;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                      make_float2(dq[4 * j + 2 * i] * dqscale, dq[4 * j + 2 * i + 1] * dqscale));
        }
      }
    }
  }

  // epilogue: dK (times 1/log2(e)) and dV cast to bf16 into this
  // warpgroup's part of the q and dO rings, in the swizzled layout of the
  // output boxes (64 keys x 64 columns, two a tensor), then TMA stores
  __syncthreads();  // every warp is done with the rings
  unsigned char* st = smem + Q_OFF + wg * 4 * (64 * 128);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = w * 16 + g + 8 * i;
      const int off = (j >> 3) * (64 * 128) + r * 128 + (((j & 7) ^ g) << 4) + 4 * t4;
      *reinterpret_cast<uint32_t*>(st + off) =
          pack_bf16(dka[4 * j + 2 * i] * dkscale, dka[4 * j + 2 * i + 1] * dkscale);
      *reinterpret_cast<uint32_t*>(st + 2 * (64 * 128) + off) =
          pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
    }
  fence_async_smem();
  bar_sync(2 + wg, 128);
  const int kw0 = k0 + wg * 64;
  if (ct == 0 && kw0 < Sk) {
    const uint32_t sa0 = base + Q_OFF + wg * 4 * (64 * 128);
    tma_store_4d(&tmdk, sa0, 0, h, kw0, b);
    tma_store_4d(&tmdk, sa0 + 64 * 128, 64, h, kw0, b);
    tma_store_4d(&tmdv, sa0 + 2 * (64 * 128), 0, h, kw0, b);
    tma_store_4d(&tmdv, sa0 + 3 * (64 * 128), 64, h, kw0, b);
    bulk_commit();
    bulk_wait_read();
  }
}

// ---- host side ----

template <bool WITH_DQ>
cudaError_t launch(const CUtensorMap (&maps)[6], const void* lse, const void* delta,
                   const void* mask, void* dq_acc, int B, int reps, int Sq, int Sk, int H,
                   float qscale, float dqscale, float dkscale, cudaStream_t stream) {
  auto kern = flash_bwd_sm90_kernel<WITH_DQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BKB - 1) / BKB, H, B);
  kern<<<grid, NC, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(mask),
      static_cast<float*>(dq_acc), reps, Sq, Sk, H, qscale, dqscale, dkscale);
  return cudaGetLastError();
}

}  // namespace

namespace rf {

int flash_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* mask, void* dq_acc, void* dk,
                   void* dv, int B, int reps, int Sq, int Sk, int H, float qscale, float dqscale,
                   float dkscale, cudaStream_t stream) {
  // the TMA boxes need 16-byte aligned bases; dq_acc's float2 atomics 8 bytes
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dk) ||
      !aligned16(dv) || (reinterpret_cast<uintptr_t>(dq_acc) & 7))
    return cudaErrorMisalignedAddress;
  // q, dO, K, V, dK, dV: q and dO a box of a step's rows, K and V of the
  // block's keys, dK and dV of one warpgroup's 64
  CUtensorMap maps[6];
  cudaError_t err = kv_map(&maps[0], q, B, Sq, H, BQ);
  if (err == cudaSuccess) err = kv_map(&maps[1], dout, B, Sq, H, BQ);
  if (err == cudaSuccess) err = kv_map(&maps[2], k, B, Sk, H, BKB);
  if (err == cudaSuccess) err = kv_map(&maps[3], v, B / reps, Sk, H, BKB);
  if (err == cudaSuccess) err = kv_map(&maps[4], dk, B, Sk, H, 64);
  if (err == cudaSuccess) err = kv_map(&maps[5], dv, B, Sk, H, 64);
  if (err != cudaSuccess) return err;
  if (dq_acc)
    return launch<true>(maps, lse, delta, mask, dq_acc, B, reps, Sq, Sk, H, qscale, dqscale,
                        dkscale, stream);
  return launch<false>(maps, lse, delta, mask, dq_acc, B, reps, Sq, Sk, H, qscale, dqscale,
                       dkscale, stream);
}

}  // namespace rf
