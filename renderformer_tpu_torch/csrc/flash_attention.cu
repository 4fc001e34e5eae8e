// Masked and unmasked flash-attention forward, with the q-side RoPE rotation
// fused into the prologue (K1/K2) or without RoPE (K10): the C entry points
// of both dtypes and the fp32 kernel.  bf16 goes to the Hopper kernel of
// flash_fwd_sm90.cu (TMA, warp-specialised wgmma).
//
// Replaces renderformer_tpu/ops/flash_attention.py:_fwd_qrope_kernel (masked)
// and :_fwd_qrope_kernel_nomask (unmasked), both reached through
// _flash_fwd_rope, and :_fwd_kernel / :_fwd_kernel_nomask, reached through
// _flash_fwd.  Semantics are those of the Pallas kernels:
//   * RoPE (K1/K2): q is rotated in fp32 with cos/sin multiplied by
//     D^-0.5 * log2(e), then rounded to the input dtype, so the logits come
//     out in log2 units; without RoPE (K10) q is multiplied in fp32 by the
//     scalar D^-0.5 * log2(e) and rounded to its dtype;
//   * logits accumulate in fp32; a masked key adds -1e30 (not -inf), so a
//     fully masked row gives uniform weights, not NaN;
//   * the online softmax runs in the exp2 domain, P is rounded to v's dtype
//     before P.V, the output accumulates in fp32, is divided by l and cast;
//   * K arrives at the full batch B (K1/K2: already rotated, rot_kv.cu); V is
//     read at batch b / reps, so the view fan-out never exists in memory
//     (K10 takes K and V at the q batch, reps = 1, as the JAX kernel does);
//   * a ragged Sk is masked inside the kernel (keys past Sk add -inf and are
//     zero-filled), with no padded copies: the unmasked form gives the same
//     result on a key count that is not a tile multiple;
//   * with an lse pointer (the training forward, _fwd_epilogue with_lse) the
//     epilogue also writes the natural-log logsumexp m2 * ln2 + ln(l) of each
//     row, fp32, laid out [B, H, Sq]; a template flag, so the render's
//     instantiation does no extra work.
// ROPE is a template flag too: K10 is its own instantiation, with no
// rotation and no cos/sin reads.
//
// The fp32 kernel (precision='fp32', the train step's view stage): at the
// main-path shapes (Sq = 4096 or 1024, D = 128) the two products are
// ~4*Sq*Sk*D flops per (b, h), far above the ridge, but exact fp32 has no
// tensor-core path, so the fp32 FMA rate bounds it.  Design: one block of 4
// warps per (64-row q tile, head, batch); a loop over 64-key tiles streams K
// and V into two shared-memory buffers with cp.async, so the copy of tile
// kt+1 overlaps the math on tile kt; each warp owns 16 q rows in the C
// fragment layout of mma.m16n8k16 and multiplies with scalar fp32 FMAs, so
// its products are exact fp32 like the plain version's; the online softmax
// never leaves registers.
#include "common.cuh"
#include "flash_fwd_sm90.cuh"

using namespace rf;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_BIG = -1e30f;

// q tile, two K and two V tile buffers, two key-bias rows and the P tile
template <int D>
constexpr size_t smem_bytes() {
  constexpr int LD = D + 16 / (int)sizeof(float);
  return (size_t)(BQ + 4 * BK) * LD * sizeof(float) + 2 * BK * sizeof(float) +
         (size_t)BQ * (BK + 4) * sizeof(float);
}

// C fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): c0,c1 at
// row g, cols 2t, 2t+1; c2,c3 at row g+8.
template <int D, bool ROPE, bool HAS_MASK, bool WITH_LSE>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ mask, const float* __restrict__ cosq,
                 const float* __restrict__ sinq, float* __restrict__ out, float* __restrict__ lse,
                 int reps, int Sq, int Sk, int H, float qscale) {
  constexpr int VEC = 16 / sizeof(float);  // elements per 16-byte load
  constexpr int LD = D + VEC;               // padded shared-memory row stride
  constexpr int DT = D / 8;                 // n8 tiles over the head dim
  constexpr int NT = BK / 8;                // n8 tiles over a key tile
  constexpr int HALF = D / 2;
  constexpr int LDP = BK + 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * LD;       // [2][BK][LD]
  float* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
  float* bias = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // [2][BK]
  float* Ps = bias + 2 * BK;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int bkv = b / reps;
  const size_t row_stride = (size_t)H * D;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int nkt = (Sk + BK - 1) / BK;

  // start the copies of key tile kt into buffer buf (zero rows past Sk) and
  // write its key bias
  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * BK;
    float* Kb = Ks + buf * BK * LD;
    float* Vb = Vs + buf * BK * LD;
    for (int i = tid; i < BK * (D / VEC); i += NTHREADS) {
      const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC, kj = k0 + r;
      const bool ok = kj < Sk;
      const int kc = ok ? kj : 0;
      cp_async16(&Kb[r * LD + c],
                 k + ((size_t)b * Sk + kc) * row_stride + (size_t)h * D + c, ok);
      cp_async16(&Vb[r * LD + c],
                 v + ((size_t)bkv * Sk + kc) * row_stride + (size_t)h * D + c, ok);
    }
    cp_async_commit();
    if (tid < BK) {
      const int kj = k0 + tid;
      float bb = 0.f;
      if (kj >= Sk) {
        bb = -INFINITY;
      } else if (HAS_MASK && mask[(size_t)b * Sk + kj] == 0) {
        bb = NEG_BIG;
      }
      bias[buf * BK + tid] = bb;
    }
  };
  load_tile(0, 0);  // overlaps the q prologue

  if constexpr (ROPE) {
    // prologue: rotate the q tile in fp32 with the pre-scaled tables
    for (int i = tid; i < BQ * HALF; i += NTHREADS) {
      const int r = i / HALF, d = i % HALF, qi = q0 + r;
      float o1 = 0.f, o2 = 0.f;
      if (qi < Sq) {
        const float* qp = q + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
        const float* cp = cosq + ((size_t)b * Sq + qi) * D;
        const float* sp = sinq + ((size_t)b * Sq + qi) * D;
        const float x1 = qp[d], x2 = qp[d + HALF];
        const float c1 = __fmul_rn(cp[d], qscale), c2 = __fmul_rn(cp[d + HALF], qscale);
        const float s1 = __fmul_rn(sp[d], qscale), s2 = __fmul_rn(sp[d + HALF], qscale);
        o1 = __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1));
        o2 = __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2));
      }
      Qs[r * LD + d] = o1;
      Qs[r * LD + d + HALF] = o2;
    }
  } else {
    // prologue: q times D^-0.5 * log2(e) in fp32
    for (int i = tid; i < BQ * D; i += NTHREADS) {
      const int r = i / D, d = i % D, qi = q0 + r;
      float o = 0.f;
      if (qi < Sq)
        o = __fmul_rn(q[((size_t)b * Sq + qi) * row_stride + (size_t)h * D + d], qscale);
      Qs[r * LD + d] = o;
    }
  }
  __syncthreads();

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {NEG_BIG, NEG_BIG};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) {
      load_tile(kt + 1, buf ^ 1);  // its buffer was released by the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    const float* Kb = Ks + buf * BK * LD;
    const float* Vb = Vs + buf * BK * LD;
    const float* kbias = bias + buf * BK;

    // S = Q K^T, log2 units
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qa0 = Qs[r0 * LD + d];
      const float qa1 = Qs[(r0 + 8) * LD + d];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float kv = Kb[(j * 8 + 2 * t4 + e) * LD + d];
          s[j][e] = fmaf(qa0, kv, s[j][e]);
          s[j][2 + e] = fmaf(qa1, kv, s[j][2 + e]);
        }
      }
    }

    // key bias, then the online softmax in the exp2 domain
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += kbias[j * 8 + 2 * t4 + (e & 1)];
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
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
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e >> 1];

    // O += P V
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Ps[(r0 + (e >> 1) * 8) * LDP + j * 8 + 2 * t4 + (e & 1)] = s[j][e];
    __syncwarp();
    for (int kj = 0; kj < BK; ++kj) {
      const float p0 = Ps[r0 * LDP + kj], p1 = Ps[(r0 + 8) * LDP + kj];
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vv = Vb[kj * LD + dt * 8 + 2 * t4 + e];
          o[dt][e] = fmaf(p0, vv, o[dt][e]);
          o[dt][2 + e] = fmaf(p1, vv, o[dt][2 + e]);
        }
    }
    __syncwarp();
    __syncthreads();  // buffer buf is free for tile kt + 2
  }

  // epilogue: full row sums across the quad, divide, cast, store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + r0 + hh * 8;
    if (qi < Sq) {
      float* op = out + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int c = dt * 8 + 2 * t4;
        op[c] = o[dt][2 * hh] / l_r[hh];
        op[c + 1] = o[dt][2 * hh + 1] / l_r[hh];
      }
      if (WITH_LSE && t4 == 0)
        lse[((size_t)b * H + h) * Sq + qi] = m_r[hh] * 0.6931471805599453f + logf(l_r[hh]);
    }
  }
}

template <int D, bool ROPE, bool HAS_MASK, bool WITH_LSE>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   const void* cosq, const void* sinq, void* out, void* lse, int B,
                   int reps, int Sq, int Sk, int H, float qscale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<D, ROPE, HAS_MASK, WITH_LSE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(cosq),
      static_cast<const float*>(sinq), static_cast<float*>(out), static_cast<float*>(lse),
      reps, Sq, Sk, H, qscale);
  return cudaGetLastError();
}

template <int D, bool ROPE>
cudaError_t launch_variant(int has_mask, const void* q, const void* k, const void* v,
                           const void* mask, const void* cosq, const void* sinq, void* out,
                           void* lse, int B, int reps, int Sq, int Sk, int H, float qscale,
                           cudaStream_t stream) {
#define RF_LAUNCH(M, L) \
  launch<D, ROPE, M, L>(q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq, Sk, H, qscale, \
                           stream)
  if (has_mask) return lse ? RF_LAUNCH(true, true) : RF_LAUNCH(true, false);
  return lse ? RF_LAUNCH(false, true) : RF_LAUNCH(false, false);
#undef RF_LAUNCH
}

template <bool ROPE>
int launch_dtype(int dtype, int has_mask, const void* q, const void* k, const void* v,
                 const void* mask, const void* cosq, const void* sinq, void* out, void* lse,
                 int B, int reps, int Sq, int Sk, int H, int D, float qscale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || reps <= 0) return cudaErrorInvalidValue;
  if (D != 128) return cudaErrorInvalidValue;  // the head dim of the released models
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return flash_fwd_sm90(ROPE, has_mask, q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq, Sk,
                          H, qscale, s);
  if (dtype == kF32)
    return launch_variant<128, ROPE>(has_mask, q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq,
                                     Sk, H, qscale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// K1/K2: q [B,Sq,H,D], k (rotated) [B,Sk,H,D], v [B/reps,Sk,H,D], mask [B,Sk]
// uint8 (ignored unless has_mask), cos/sin [B,Sq,D] fp32, out [B,Sq,H,D], lse
// [B,H,Sq] fp32 or null (no logsumexp written).
extern "C" int rf_flash_fwd_rope(const void* q, const void* k, const void* v,
                                 const void* mask, const void* cosq, const void* sinq,
                                 void* out, void* lse, int dtype, int has_mask, int B,
                                 int reps, int Sq, int Sk, int H, int D, float qscale,
                                 void* stream) {
  return launch_dtype<true>(dtype, has_mask, q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq,
                            Sk, H, D, qscale, stream);
}

// K10: q [B,Sq,H,D], k and v [B,Sk,H,D], mask [B,Sk] uint8 (ignored unless
// has_mask), out [B,Sq,H,D], lse [B,H,Sq] fp32 or null.
extern "C" int rf_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                            void* out, void* lse, int dtype, int has_mask, int B, int Sq,
                            int Sk, int H, int D, float qscale, void* stream) {
  return launch_dtype<false>(dtype, has_mask, q, k, v, mask, nullptr, nullptr, out, lse, B, 1,
                             Sq, Sk, H, D, qscale, stream);
}

// Rows of q one block of the flash forward takes at this grid: the bf16
// kernel's tile plan, the fp32 kernel's 64.
extern "C" int rf_flash_fwd_rows(int dtype, int B, int Sq, int H) {
  return dtype == kBF16 ? flash_fwd_sm90_rows(B, Sq, H) : BQ;
}
