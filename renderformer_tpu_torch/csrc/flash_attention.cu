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
//     in fp32 both products are split TF32 (below), within a few ulps of an
//     fp32 sum;
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
// The fp32 kernel (precision='fp32', the train step's view stage and the
// fp32 render).  At the main-path shapes (D = 128) the two products are
// ~4*Sq*Sk*D flops per (b, h), far above the ridge.  Exact fp32 has no
// tensor-core path, so both products run as split TF32 (common.cuh: three
// mma.m16n8k8.tf32 a product, fp32 accumulators; in S the two small
// products of each k step go to an accumulator of their own, added to the
// large one's before the bias; in P.V a tile's products, the small ones of
// each k step first, go to a fresh accumulator that one FFMA adds to O):
// 3x the flops at the 495 TFLOP/s TF32 rate, against 67 for scalar fp32
// FMAs, within a few ulps of an fp32 sum.  Design: one block of 4 warps per
// (64-row q tile, head, batch, key chunk), two blocks an SM; a loop over
// 32-key tiles streams K and V into two shared-memory buffers with
// cp.async, so the copy of tile kt+1 overlaps the math on tile kt; each
// warp owns 16 q rows.  Operands are split in registers as their fragments
// are loaded (four integer and float ops a value, common.cuh; cvt.rna would
// take some ten): q (rotated or scaled once into shared memory by 16-byte
// loads) and K by 64-bit loads, the d order within each 8-wide k step
// permuted so that a thread's two values are adjacent (a dot product does
// not depend on it); P straight from the S accumulators,
// whose C layout becomes P.V's A layout by taking keys 8j+2t and 8j+2t+1 as
// its k indices t and t+4, with V's B fragment read at the same two keys.
// No P tile in shared memory, and the online softmax never leaves registers.
// Row strides of D+8 (q, K: 64-bit loads) and D+4 (V: two key rows a
// thread) keep every fragment load free of bank conflicts.
//
// The grid: a train step's 1 x 1024 rays x 6 heads is 96 q tiles, fewer
// than the 132 SMs, so the keys are split across the blocks of a thread
// block cluster (2, 4 or 8; f32_splits picks the count that fills the card
// in the fewest waves).  Each block runs the loop over its contiguous
// chunk of key tiles, leaves its unnormalised O, m and l in its own shared
// memory, and after a cluster barrier each block merges a slice of the q
// rows from all of them through distributed shared memory: M = max m_c,
// w_c = exp2(m_c - M), out = sum w_c O_c / sum w_c l_c, lse = M ln2 +
// ln(sum w_c l_c).  A chunk whose keys are all masked has m = -1e30 and
// weight 0 beside one with a real key, so a row keeps the single pass's
// semantics, and a fully masked row stays uniform over the Sk real keys.
#include <cooperative_groups.h>

#include "common.cuh"
#include "flash_fwd_sm90.cuh"

using namespace rf;
namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDQ = D + 8;   // q and K rows
constexpr int LDV = D + 4;   // V rows, and the partial O of the merge
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr float NEG_BIG = -1e30f;

struct Smem {
  float q[BQ * LDQ];
  float k[2][BK * LDQ];
  float v[2][BK * LDV];
  float bias[2][BK];
  float m[BQ], l[BQ];  // the block's row statistics, for the merge
};
static_assert(sizeof(float) * 2 * BK * LDQ >= sizeof(float) * BQ * LDV,
              "the partial O of the merge reuses K's buffers");

template <bool ROPE, bool HAS_MASK, bool WITH_LSE>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ mask,
                     const float* __restrict__ cosq, const float* __restrict__ sinq,
                     float* __restrict__ out, float* __restrict__ lse, int reps, int Sq, int Sk,
                     int H, int splits, float qscale) {
  constexpr int DT = D / 8;   // n8 tiles over the head dim
  constexpr int NT = BK / 8;  // n8 tiles over a key tile
  constexpr int HALF = D / 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int part = blockIdx.x % splits;  // the block's rank in its cluster
  const int q0 = (blockIdx.x / splits) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int bkv = b / reps;
  const size_t row_stride = (size_t)H * D;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int nkt = (Sk + BK - 1) / BK;
  const int kt0 = (int)((long)nkt * part / splits);
  const int kt1 = (int)((long)nkt * (part + 1) / splits);

  // start the copies of key tile kt into buffer buf (zero rows past Sk) and
  // write its key bias
  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * BK;
    for (int i = tid; i < BK * (D / 4); i += NTHREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4, kj = k0 + r;
      const bool ok = kj < Sk;
      const int kc = ok ? kj : 0;
      cp_async16(&sm.k[buf][r * LDQ + c],
                 k + ((size_t)b * Sk + kc) * row_stride + (size_t)h * D + c, ok);
      cp_async16(&sm.v[buf][r * LDV + c],
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
      sm.bias[buf][tid] = bb;
    }
  };
  if (kt0 < kt1) load_tile(kt0, 0);  // overlaps the q prologue

  // prologue: the q tile, rotated in fp32 with the pre-scaled tables, or
  // times D^-0.5 * log2(e), into shared memory, four columns a thread
  constexpr int QV = HALF / 4;  // float4 columns of half a row
  for (int i = tid; i < BQ * QV; i += NTHREADS) {
    const int r = i / QV, d = (i % QV) * 4, qi = q0 + r;
    float4 o1 = make_float4(0.f, 0.f, 0.f, 0.f), o2 = o1;
    if (qi < Sq) {
      const float* qp = q + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
      const float4 x1 = *reinterpret_cast<const float4*>(qp + d);
      const float4 x2 = *reinterpret_cast<const float4*>(qp + d + HALF);
      if constexpr (ROPE) {
        const float* cp = cosq + ((size_t)b * Sq + qi) * D;
        const float* sp = sinq + ((size_t)b * Sq + qi) * D;
        const float4 c1 = *reinterpret_cast<const float4*>(cp + d);
        const float4 c2 = *reinterpret_cast<const float4*>(cp + d + HALF);
        const float4 s1 = *reinterpret_cast<const float4*>(sp + d);
        const float4 s2 = *reinterpret_cast<const float4*>(sp + d + HALF);
        auto rot = [&](float a1, float a2, float cc1, float cc2, float ss1, float ss2,
                       float& r1, float& r2) {
          const float k1 = __fmul_rn(cc1, qscale), k2 = __fmul_rn(cc2, qscale);
          const float n1 = __fmul_rn(ss1, qscale), n2 = __fmul_rn(ss2, qscale);
          r1 = __fadd_rn(__fmul_rn(a1, k1), __fmul_rn(-a2, n1));
          r2 = __fadd_rn(__fmul_rn(a2, k2), __fmul_rn(a1, n2));
        };
        rot(x1.x, x2.x, c1.x, c2.x, s1.x, s2.x, o1.x, o2.x);
        rot(x1.y, x2.y, c1.y, c2.y, s1.y, s2.y, o1.y, o2.y);
        rot(x1.z, x2.z, c1.z, c2.z, s1.z, s2.z, o1.z, o2.z);
        rot(x1.w, x2.w, c1.w, c2.w, s1.w, s2.w, o1.w, o2.w);
      } else {
        o1 = make_float4(__fmul_rn(x1.x, qscale), __fmul_rn(x1.y, qscale),
                         __fmul_rn(x1.z, qscale), __fmul_rn(x1.w, qscale));
        o2 = make_float4(__fmul_rn(x2.x, qscale), __fmul_rn(x2.y, qscale),
                         __fmul_rn(x2.z, qscale), __fmul_rn(x2.w, qscale));
      }
    }
    *reinterpret_cast<float4*>(&sm.q[r * LDQ + d]) = o1;
    *reinterpret_cast<float4*>(&sm.q[r * LDQ + d + HALF]) = o2;
  }
  __syncthreads();

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {NEG_BIG, NEG_BIG};
  float l_r[2] = {0.f, 0.f};  // per-thread partial row sums

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_tile(kt + 1, buf ^ 1);  // its buffer was released by the last sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    const float* Kb = sm.k[buf];
    const float* Vb = sm.v[buf];
    const float* kbias = sm.bias[buf];

    // S = Q K^T, log2 units; the k step kk takes d = 8kk + 2t (index t) and
    // 8kk + 2t + 1 (index t + 4).  The large products (hi*hi) and the two
    // small ones of each k step go to accumulators of their own, so the
    // small terms are summed among themselves before they meet the large
    float s[NT][4], sl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = kk * 8 + 2 * t4;
      const float2 qa = *reinterpret_cast<const float2*>(&sm.q[r0 * LDQ + c]);
      const float2 qb = *reinterpret_cast<const float2*>(&sm.q[(r0 + 8) * LDQ + c]);
      uint32_t ah[4], al[4];
      split_tf32(qa.x, ah[0], al[0]);
      split_tf32(qb.x, ah[1], al[1]);
      split_tf32(qa.y, ah[2], al[2]);
      split_tf32(qb.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(&Kb[(j * 8 + g) * LDQ + c]);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kv.x, bh0, bl0);
        split_tf32(kv.y, bh1, bl1);
        mma_tf32(sl[j], al, bh0, bh1);
        mma_tf32(sl[j], ah, bl0, bl1);
        mma_tf32(s[j], ah, bh0, bh1);
      }
    }

    // key bias, then the online softmax in the exp2 domain
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (s[j][e] + sl[j][e]) + kbias[j * 8 + 2 * t4 + (e & 1)];
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

    // P V of this tile into an accumulator of its own: the k step j takes
    // keys 8j + 2t (index t) and 8j + 2t + 1 (index t + 4), which are the
    // columns of s[j] this thread holds.  Its 3 * BK / 8 tensor-core sums
    // start from zero, and O = O * alpha + (P V) rounds once, in an FFMA, so
    // the tensor cores' additions never run over the whole key range
    float ot[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ot[dt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* v0 = Vb + (j * 8 + 2 * t4) * LDV + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[dt * 8], bh0, bl0);
        split_tf32(v0[LDV + dt * 8], bh1, bl1);
        mma_3xtf32(ot[dt], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = fmaf(o[dt][e], alpha[e >> 1], ot[dt][e]);
    __syncthreads();  // buffer buf is free for tile kt + 2
  }

  // full row sums across the quad
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }

  if (splits == 1) {
    // divide, store
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
    return;
  }

  // the key split: leave this chunk's unnormalised O, m and l in shared
  // memory (O in K's buffers, free after the loop's last sync), then merge
  // rows [part * BQ / splits, (part + 1) * BQ / splits) of every chunk
  float* opart = sm.k[0];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + hh * 8;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(&opart[r * LDV + dt * 8 + 2 * t4]) =
          make_float2(o[dt][2 * hh], o[dt][2 * hh + 1]);
    if (t4 == 0) {
      sm.m[r] = m_r[hh];
      sm.l[r] = l_r[hh];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = BQ / splits;
  for (int rr = warp; rr < rows; rr += NWARPS) {
    const int r = part * rows + rr, qi = q0 + r;
    if (qi >= Sq) continue;
    float mc[MAX_SPLITS], big = NEG_BIG;
    for (int c = 0; c < splits; ++c) {
      mc[c] = cluster.map_shared_rank(sm.m, c)[r];
      big = fmaxf(big, mc[c]);
    }
    float lsum = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < splits; ++c) {
      const float w = exp2f(mc[c] - big);
      lsum += w * cluster.map_shared_rank(sm.l, c)[r];
      const float4 oc =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(opart, c) + r * LDV)[lane];
      acc.x += w * oc.x;
      acc.y += w * oc.y;
      acc.z += w * oc.z;
      acc.w += w * oc.w;
    }
    float* op = out + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
    reinterpret_cast<float4*>(op)[lane] =
        make_float4(acc.x / lsum, acc.y / lsum, acc.z / lsum, acc.w / lsum);
    if (WITH_LSE && lane == 0)
      lse[((size_t)b * H + h) * Sq + qi] = big * 0.6931471805599453f + logf(lsum);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  static int cache[64] = {};
  if (dev < 64 && cache[dev]) return cache[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) cache[dev] = n;
  return n;
}

// Clusters of `splits` blocks of the fp32 kernel that the current device
// holds at once (cached), or 0 where the query fails.
int f32_cluster_capacity(int splits) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  static int cache[64][4] = {};
  const int slot = splits == 1 ? 0 : splits == 2 ? 1 : splits == 4 ? 2 : 3;
  if (cache[dev][slot]) return cache[dev][slot];
  const int n = cluster_capacity(flash_fwd_f32_kernel<true, true, true>, NTHREADS,
                                 sizeof(Smem), splits);
  if (n <= 0) return 0;
  cache[dev][slot] = n;
  return n;
}

// Blocks a q tile of the fp32 kernel splits its keys across: of 1, 2, 4 and
// 8 (at most the key tiles), the count whose grid takes the fewest waves of
// the card's clusters per unit of work, ceil(tiles * s / capacity(s)) / s;
// a larger split must win by more than 10 %, for the merge it adds.
int f32_splits(int B, int Sq, int Sk, int H) {
  const long tiles = (long)((Sq + BQ - 1) / BQ) * H * B;
  const int nkt = (Sk + BK - 1) / BK;
  int best = 1;
  double best_cost = 1.0;  // waves per unit of work at s = 1, normalised below
  const int cap1 = f32_cluster_capacity(1);
  if (cap1 <= 0) return 1;
  const double waves1 = (double)((tiles + cap1 - 1) / cap1);
  for (int s = 2; s <= MAX_SPLITS && s <= nkt; s *= 2) {
    const int cap = f32_cluster_capacity(s);
    if (cap <= 0) break;
    const double cost = (double)((tiles + cap - 1) / cap) / s / waves1;
    if (cost < 0.9 * best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <bool ROPE, bool HAS_MASK, bool WITH_LSE>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* mask,
                       const void* cosq, const void* sinq, void* out, void* lse, int B,
                       int reps, int Sq, int Sk, int H, float qscale, cudaStream_t stream) {
  auto kern = flash_fwd_f32_kernel<ROPE, HAS_MASK, WITH_LSE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  const int splits = f32_splits(B, Sq, Sk, H);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sq + BQ - 1) / BQ * splits, H, B);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(q),
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<const uint8_t*>(mask), static_cast<const float*>(cosq),
                           static_cast<const float*>(sinq), static_cast<float*>(out),
                           static_cast<float*>(lse), reps, Sq, Sk, H, splits, qscale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool ROPE>
cudaError_t launch_variant(int has_mask, const void* q, const void* k, const void* v,
                           const void* mask, const void* cosq, const void* sinq, void* out,
                           void* lse, int B, int reps, int Sq, int Sk, int H, float qscale,
                           cudaStream_t stream) {
  // 16-byte loads of q, the tables, K and V, and stores of the merged rows
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
      (ROPE && (!aligned16(cosq) || !aligned16(sinq))))
    return cudaErrorMisalignedAddress;
#define RF_LAUNCH(M, L) \
  launch_f32<ROPE, M, L>(q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq, Sk, H, qscale, stream)
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
    return launch_variant<ROPE>(has_mask, q, k, v, mask, cosq, sinq, out, lse, B, reps, Sq, Sk,
                                H, qscale, s);
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

// Blocks (one thread block cluster) that share a q tile's keys at this grid
// on the current device: the fp32 kernel's key split, 1 for bf16.
extern "C" int rf_flash_fwd_splits(int dtype, int B, int Sq, int Sk, int H) {
  return dtype == kF32 ? f32_splits(B, Sq, Sk, H) : 1;
}
