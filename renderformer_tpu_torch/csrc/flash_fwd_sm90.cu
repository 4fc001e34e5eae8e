// The bf16 flash-attention forward for Hopper: K1/K2 (q rotated by RoPE in
// the prologue) and K10 (q scaled), masked and unmasked, with and without the
// logsumexp.
//
// Replaces renderformer_tpu/ops/flash_attention.py:876 _fwd_qrope_kernel,
// :888 _fwd_qrope_kernel_nomask, :202 _fwd_kernel and :217
// _fwd_kernel_nomask in bf16 (the fp32 forward stays in flash_attention.cu).
// The semantics are those listed at the top of flash_attention.cu: q rotated
// (or scaled) in fp32 by tables times D^-0.5*log2(e) and rounded to bf16;
// fp32 logits; -1e30 on masked keys, -inf (and zeros) past Sk; the online
// softmax in the exp2 domain; P rounded to bf16 before P.V; O summed in
// fp32, divided by l and cast; the logsumexp m*ln2 + ln(l) [B, H, Sq]; K at
// the q batch b and V at b / reps.
//
// Bound on this card: the two products, ~4*Sq*Sk*D flops for every (b, h),
// against ~2*(Sq+Sk)*D bytes, far above the H100's ~295 flop/byte ridge, so
// the tensor cores bound it and only wgmma reaches their rate.  Design:
//   * one block a (q tile, head, batch): warpgroup 0 is the producer (one
//     warp issues the TMA loads) and gives its registers to the NWG consumer
//     warpgroups by setmaxnreg (24 registers a thread against 240, or 232
//     with one consumer), which own 64 q rows each; the role is read from a
//     warp-uniform warpgroup index, as setmaxnreg needs;
//   * K and V tiles of BK keys arrive by TMA (4-D tensor maps over [B, S, H,
//     D], a box of BK keys x 1 head x 64 columns, two boxes a 128-wide tile,
//     128-byte swizzle) into a ring of two stages each, with full and empty
//     mbarriers; TMA zero-fills keys past Sk and reads V at batch b / reps;
//   * the q prologue rotates (or scales) q in fp32 and writes it into shared
//     memory in the same 128-byte-swizzled K-major layout;
//   * S = Q K^T is wgmma m64nBKk16 with both operands in shared memory; the
//     key bias and the online softmax run on the accumulator's registers, P
//     is packed into bf16 A fragments, and O += P V is wgmma m64n128k16 with
//     A from registers and V MN-major (transposed) in shared memory;
//   * a warpgroup runs S, the softmax and P.V of a tile in turn; the two
//     consumer warpgroups of a block interleave, so one's softmax runs while
//     the other's products are on the tensor cores.  (Issuing S of tile j
//     with P.V of tile j-1 inside a warpgroup needs S, P and O live at once,
//     160 registers a thread: ptxas spilled and serialised the wgmmas, and
//     that form ran 13 % slower on the H100);
//   * 128 q rows a block (two consumers, one block an SM), or 64 (one
//     consumer, two blocks an SM) where the grid would otherwise leave a
//     second, nearly empty wave: flash_fwd_sm90_rows picks it.
#include <cuda.h>

#include "common.cuh"
#include "flash_fwd_sm90.cuh"
#include "sm90.cuh"

using namespace rf;

namespace {

constexpr int D = 128;
constexpr int STAGES = 2;
constexpr int HALF_BYTES = 64 * 128;  // one consumer's q rows, one 64-column half
constexpr float NEG_BIG = -1e30f;

// ---- the kernel ----

// Accumulator layout of wgmma m64nN (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): register 4j + e holds row 16w + g + 8(e / 2), column
// 8j + 2t + e % 2.  The A fragment of rows 16w.. and k 16kk..16kk+15 takes
// the pairs of S registers 4(2kk) + {0,1}, + {2,3}, 4(2kk+1) + {0,1}, + {2,3}.
template <int NWG, int BK>
struct Smem {
  static constexpr int Q_BYTES = NWG * 2 * HALF_BYTES;
  static constexpr int TILE_BYTES = BK * D * 2;  // one K or V stage, two boxes
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int BIAS_OFF = V_OFF + STAGES * TILE_BYTES;
  static constexpr int BAR_OFF = BIAS_OFF + STAGES * BK * 4;
  // full K, empty K, full V, empty V: STAGES each
  static constexpr int BYTES = BAR_OFF + 4 * STAGES * 8 + 1024;  // + alignment slack
};

template <int NWG, int BK, bool ROPE, bool HAS_MASK, bool WITH_LSE>
__global__ void __launch_bounds__((NWG + 1) * 128, NWG == 1 ? 2 : 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, const __nv_bfloat16* __restrict__ q,
                      const uint8_t* __restrict__ mask, const float* __restrict__ cosq,
                      const float* __restrict__ sinq, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int reps, int Sq, int Sk, int H, float qscale) {
  using S = Smem<NWG, BK>;
  constexpr int NS = BK / 2;   // S registers a thread
  constexpr int KS = BK / 16;  // k steps of P.V
  constexpr uint32_t TX = S::TILE_BYTES;

  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  float* bias = reinterpret_cast<float*>(smem + S::BIAS_OFF);
  const uint32_t bar = base + S::BAR_OFF;
  auto full_k = [&](int s) { return bar + 8 * s; };
  auto empty_k = [&](int s) { return bar + 8 * (STAGES + s); };
  auto full_v = [&](int s) { return bar + 8 * (2 * STAGES + s); };
  auto empty_v = [&](int s) { return bar + 8 * (3 * STAGES + s); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nkt = (Sk + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 32);        // the producer warp (bias rows, TMA bytes)
      mbar_init(empty_k(s), NWG * 4);  // every consumer warp
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, uniform across the warp (setmaxnreg needs the
  // compiler to see that each warp takes one branch)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 0) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (__shfl_sync(0xffffffffu, warp, 0) != 0) return;
    const int bkv = b / reps;
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t par = ((kt / STAGES) & 1) ^ 1;
      const int k0 = kt * BK;
      mbar_wait(empty_k(s), par);
      if constexpr (HAS_MASK) {
        for (int c = lane; c < BK; c += 32) {
          const int kj = k0 + c;
          bias[s * BK + c] = kj >= Sk ? -INFINITY
                             : mask[(size_t)b * Sk + kj] == 0 ? NEG_BIG
                                                              : 0.f;
        }
      }
      if (lane == 0) {
        const uint32_t dst = base + S::K_OFF + s * S::TILE_BYTES;
        mbar_expect_tx(full_k(s), TX);
        tma_load_4d(dst, &tmk, full_k(s), 0, h, k0, b);
        tma_load_4d(dst + BK * 128, &tmk, full_k(s), 64, h, k0, b);
      } else {
        mbar_arrive(full_k(s));
      }
      mbar_wait(empty_v(s), par);
      if (lane == 0) {
        const uint32_t dst = base + S::V_OFF + s * S::TILE_BYTES;
        mbar_expect_tx(full_v(s), TX);
        tma_load_4d(dst, &tmv, full_v(s), 0, h, k0, bkv);
        tma_load_4d(dst + BK * 128, &tmv, full_v(s), 64, h, k0, bkv);
      }
      __syncwarp();
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    if constexpr (NWG == 1) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    }
    const int wg = wgi - 1;               // consumer index
    const int ct = tid - (wg + 1) * 128;  // thread in the warpgroup
    const int w = ct / 32, g = lane >> 2, t4 = lane & 3;
    const int row0 = blockIdx.x * (64 * NWG) + wg * 64;  // first q row of this warpgroup
    const size_t row_stride = (size_t)H * D;
    unsigned char* qs = smem + wg * 2 * HALF_BYTES;
    const uint32_t qs_addr = base + wg * 2 * HALF_BYTES;

    // prologue: q rotated (or scaled) in fp32, rounded to bf16, written in
    // the 128-byte-swizzled K-major layout (16-byte chunk c of row r at
    // chunk c ^ (r % 8)), one 64-column half after the other
    if constexpr (ROPE) {
      for (int item = ct; item < 64 * 8; item += 128) {
        const int r = item >> 3, c = item & 7, qi = row0 + r;
        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
        if (qi < Sq) {
          const __nv_bfloat16* qp = q + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
          const float* cp = cosq + ((size_t)b * Sq + qi) * D;
          const float* sp = sinq + ((size_t)b * Sq + qi) * D;
          const uint4 x1v = *reinterpret_cast<const uint4*>(qp + c * 8);
          const uint4 x2v = *reinterpret_cast<const uint4*>(qp + 64 + c * 8);
          const __nv_bfloat16* x1 = reinterpret_cast<const __nv_bfloat16*>(&x1v);
          const __nv_bfloat16* x2 = reinterpret_cast<const __nv_bfloat16*>(&x2v);
          float c1[8], c2[8], s1[8], s2[8];
          *reinterpret_cast<float4*>(c1) = *reinterpret_cast<const float4*>(cp + c * 8);
          *reinterpret_cast<float4*>(c1 + 4) = *reinterpret_cast<const float4*>(cp + c * 8 + 4);
          *reinterpret_cast<float4*>(c2) = *reinterpret_cast<const float4*>(cp + 64 + c * 8);
          *reinterpret_cast<float4*>(c2 + 4) =
              *reinterpret_cast<const float4*>(cp + 64 + c * 8 + 4);
          *reinterpret_cast<float4*>(s1) = *reinterpret_cast<const float4*>(sp + c * 8);
          *reinterpret_cast<float4*>(s1 + 4) = *reinterpret_cast<const float4*>(sp + c * 8 + 4);
          *reinterpret_cast<float4*>(s2) = *reinterpret_cast<const float4*>(sp + 64 + c * 8);
          *reinterpret_cast<float4*>(s2 + 4) =
              *reinterpret_cast<const float4*>(sp + 64 + c * 8 + 4);
          uint32_t* lo32 = reinterpret_cast<uint32_t*>(&lo);
          uint32_t* hi32 = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            float o1[2], o2[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float a1 = to_float(x1[e + u]), a2 = to_float(x2[e + u]);
              o1[u] = __fadd_rn(__fmul_rn(a1, __fmul_rn(c1[e + u], qscale)),
                                __fmul_rn(-a2, __fmul_rn(s1[e + u], qscale)));
              o2[u] = __fadd_rn(__fmul_rn(a2, __fmul_rn(c2[e + u], qscale)),
                                __fmul_rn(a1, __fmul_rn(s2[e + u], qscale)));
            }
            lo32[e / 2] = pack_bf16(o1[0], o1[1]);
            hi32[e / 2] = pack_bf16(o2[0], o2[1]);
          }
        }
        const int off = r * 128 + ((c ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(qs + off) = lo;
        *reinterpret_cast<uint4*>(qs + HALF_BYTES + off) = hi;
      }
    } else {
      for (int item = ct; item < 64 * 16; item += 128) {
        const int r = item >> 4, c16 = item & 15, qi = row0 + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (qi < Sq) {
          const uint4 xv = *reinterpret_cast<const uint4*>(
              q + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D + c16 * 8);
          const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&xv);
          uint32_t* v32 = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
          for (int e = 0; e < 8; e += 2)
            v32[e / 2] = pack_bf16(__fmul_rn(to_float(x[e]), qscale),
                                   __fmul_rn(to_float(x[e + 1]), qscale));
        }
        const int c = c16 & 7;
        *reinterpret_cast<uint4*>(qs + (c16 >> 3) * HALF_BYTES + r * 128 +
                                  ((c ^ (r & 7)) << 4)) = val;
      }
    }
    // the generic-proxy stores must be visible to wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    uint32_t pa[KS][4];
    float m_r[2] = {NEG_BIG, NEG_BIG};
    float l_r[2] = {0.f, 0.f};  // per-thread partial row sums

    // S = Q K^T for key tile kt: eight k steps of 16 over D, the first
    // overwriting the accumulator
    const uint32_t q_lo = desc_lo(qs_addr, 16);
    auto issue_qk = [&](int kt) {
      const uint32_t k_lo = desc_lo(base + S::K_OFF + (kt % STAGES) * S::TILE_BYTES, 16);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 2;  // 32 bytes a k step, in 16-byte units
        wgmma_ss<BK>(sc, q_lo + (kk >> 2) * (HALF_BYTES >> 4) + off,
                     k_lo + (kk >> 2) * (BK * 128 >> 4) + off, DESC_HI, kk > 0);
      }
      wgmma_commit();
    };
    // O += P V for key tile kt: BK / 16 k steps of 16 keys; V is MN-major,
    // its two 64-column boxes BK * 128 bytes apart
    auto issue_pv = [&](int kt) {
      const uint32_t v_lo =
          desc_lo(base + S::V_OFF + (kt % STAGES) * S::TILE_BYTES, BK * 128);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_rs_mn(o, pa[kk], v_lo + kk * (2048 >> 4), DESC_HI);  // 16 keys = 2048 B
      wgmma_commit();
    };
    // key bias and the online softmax of tile kt on the accumulator; P
    // replaces S; returns alpha of both rows
    auto softmax = [&](int kt, float (&alpha)[2]) {
      const int k0 = kt * BK;
      if constexpr (HAS_MASK) {
        const float* kbias = bias + (kt % STAGES) * BK;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float2 bb = *reinterpret_cast<const float2*>(kbias + j * 8 + 2 * t4);
          sc[4 * j] += bb.x;
          sc[4 * j + 1] += bb.y;
          sc[4 * j + 2] += bb.x;
          sc[4 * j + 3] += bb.y;
        }
      } else if (k0 + BK > Sk) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + 2 * t4 + (e & 1) >= Sk) sc[4 * j + e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        alpha[i] = exp2f(m_r[i] - m_new);
        m_r[i] = m_new;
        l_r[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = exp2f(sc[4 * j + e] - m_r[e >> 1]);
          l_r[e >> 1] += sc[4 * j + e];
        }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    // one lane of each consumer warp releases a stage once the warp is done
    auto release = [&](uint32_t b_empty) {
      __syncwarp();
      if (lane == 0) mbar_arrive(b_empty);
    };

    float alpha[2];
    for (int kt = 0; kt < nkt; ++kt) {
      mbar_wait(full_k(kt % STAGES), (kt / STAGES) & 1);
      wgmma_fence();
      issue_qk(kt);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(kt, alpha);
      release(empty_k(kt % STAGES));
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      pack_p();
      mbar_wait(full_v(kt % STAGES), (kt / STAGES) & 1);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(kt);
      wgmma_wait<0>();
      fence_regs(o);
      release(empty_v(kt % STAGES));
    }

    // epilogue: full row sums across the quad, divide, cast, store
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + w * 16 + g + 8 * i;
      if (qi < Sq) {
        __nv_bfloat16* op = out + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(op + j * 8 + 2 * t4) =
              pack_bf16(o[4 * j + 2 * i] / l_r[i], o[4 * j + 2 * i + 1] / l_r[i]);
        if (WITH_LSE && t4 == 0)
          lse[((size_t)b * H + h) * Sq + qi] = m_r[i] * 0.6931471805599453f + logf(l_r[i]);
      }
    }
  }
}

// ---- host side ----

template <int NWG, int BK, bool ROPE, bool HAS_MASK, bool WITH_LSE>
cudaError_t launch(const CUtensorMap& tmk, const CUtensorMap& tmv, const void* q,
                   const void* mask, const void* cosq, const void* sinq, void* out, void* lse,
                   int B, int reps, int Sq, int Sk, int H, float qscale, cudaStream_t stream) {
  constexpr int smem = Smem<NWG, BK>::BYTES;
  auto kern = flash_fwd_sm90_kernel<NWG, BK, ROPE, HAS_MASK, WITH_LSE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + 64 * NWG - 1) / (64 * NWG), H, B);
  kern<<<grid, (NWG + 1) * 128, smem, stream>>>(
      tmk, tmv, static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(cosq), static_cast<const float*>(sinq),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), reps, Sq, Sk, H, qscale);
  return cudaGetLastError();
}

template <int NWG, int BK, bool ROPE>
cudaError_t launch_plan(bool has_mask, const void* q, const void* k, const void* v,
                        const void* mask, const void* cosq, const void* sinq, void* out,
                        void* lse, int B, int reps, int Sq, int Sk, int H, float qscale,
                        cudaStream_t stream) {
  CUtensorMap tmk, tmv;
  cudaError_t err = kv_map(&tmk, k, B, Sk, H, BK);
  if (err == cudaSuccess) err = kv_map(&tmv, v, B / reps, Sk, H, BK);
  if (err != cudaSuccess) return err;
#define RF_LAUNCH(M, L)                                                                       \
  launch<NWG, BK, ROPE, M, L>(tmk, tmv, q, mask, cosq, sinq, out, lse, B, reps, Sq, Sk, H, \
                              qscale, stream)
  if (has_mask) return lse ? RF_LAUNCH(true, true) : RF_LAUNCH(true, false);
  return lse ? RF_LAUNCH(false, true) : RF_LAUNCH(false, false);
#undef RF_LAUNCH
}

template <bool ROPE>
cudaError_t launch_rope(bool has_mask, const void* q, const void* k, const void* v,
                        const void* mask, const void* cosq, const void* sinq, void* out,
                        void* lse, int B, int reps, int Sq, int Sk, int H, float qscale,
                        cudaStream_t stream) {
  if (flash_fwd_sm90_rows(B, Sq, H) == 64)
    return launch_plan<1, 64, ROPE>(has_mask, q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq,
                                    Sk, H, qscale, stream);
  return launch_plan<2, 128, ROPE>(has_mask, q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq,
                                   Sk, H, qscale, stream);
}

}  // namespace

namespace rf {

int flash_fwd_sm90_rows(int B, int Sq, int H) {
  const long sms = sm_count();
  if (sms <= 0) return 128;
  const long blocks128 = (long)((Sq + 127) / 128) * H * B;
  const long blocks64 = (long)((Sq + 63) / 64) * H * B;
  const long waves128 = (blocks128 + sms - 1) / sms;
  const long waves64 = (blocks64 + 2 * sms - 1) / (2 * sms);
  return waves64 < waves128 ? 64 : 128;
}

int flash_fwd_sm90(bool rope, bool has_mask, const void* q, const void* k, const void* v,
                   const void* mask, const void* cosq, const void* sinq, void* out, void* lse,
                   int B, int reps, int Sq, int Sk, int H, float qscale, cudaStream_t stream) {
  // 16-byte vector loads of q, the tables and the TMA boxes
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      (rope && (!aligned16(cosq) || !aligned16(sinq))))
    return cudaErrorMisalignedAddress;
  if (rope)
    return launch_rope<true>(has_mask, q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq,
                             Sk, H, qscale, stream);
  return launch_rope<false>(has_mask, q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq,
                            Sk, H, qscale, stream);
}

}  // namespace rf
