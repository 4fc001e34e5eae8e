// Masked and unmasked flash-attention forward with the q-side RoPE rotation
// fused into the prologue.
//
// Replaces renderformer_tpu/ops/flash_attention.py:_fwd_qrope_kernel (masked)
// and :_fwd_qrope_kernel_nomask (unmasked), both reached through
// _flash_fwd_rope.  Semantics are those of the Pallas kernels:
//   * q is rotated in fp32 with cos/sin multiplied by D^-0.5 * log2(e), then
//     rounded to the input dtype, so the logits come out in log2 units;
//   * logits accumulate in fp32; a masked key adds -1e30 (not -inf), so a
//     fully masked row gives uniform weights, not NaN;
//   * the online softmax runs in the exp2 domain, P is rounded to v's dtype
//     before P.V, the output accumulates in fp32, is divided by l and cast;
//   * K arrives already rotated at the full batch B (rot_kv.cu); V is read at
//     batch b / reps, so the view fan-out never exists in memory;
//   * a ragged Sk is masked inside the kernel (keys past Sk add -inf and are
//     zero-filled), with no padded copies.
//
// Bound on this card: at the main-path shapes (Sq = 4096 or 2064, D = 128)
// the two products are ~4*Sq*Sk*D flops per (b, h) against ~2*(Sq+Sk)*D
// bytes, far above the H100's ~295 flop/byte ridge, so the tensor cores
// bound it.  Design: one block of 4 warps per (64-row q tile, head, batch);
// the rotated q tile goes to registers as mma.sync A fragments once; a loop
// over 64-key tiles streams K and V into two shared-memory buffers with
// cp.async, so the copy of tile kt+1 overlaps the math on tile kt; each warp
// owns 16 q rows and runs S = Q K^T and O += P V as bf16 mma.sync m16n8k16
// with fp32 accumulators, B fragments fetched by ldmatrix (.trans for V);
// the C layout of S is reused as P's A layout, so the online softmax never
// leaves registers.  The fp32 instantiation (precision='fp32') keeps the same
// register layout but multiplies with scalar fp32 FMAs, so its products are
// exact fp32 like the plain version's.  No TMA, wgmma or warp specialisation
// yet: mma.sync reaches a fraction of the wgmma rate.
#include <type_traits>

#include "common.cuh"

using namespace rf;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8, fp32) += A(16x16, bf16, row-major) * B(16x8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0 fills
// the 16 bytes with zeros (keys past Sk)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and register i receives matrix i in mma layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// q tile, two K and two V tile buffers, two key-bias rows, and (fp32 only)
// the P tile
template <typename T, int D>
constexpr size_t smem_bytes() {
  constexpr int LD = D + 16 / (int)sizeof(T);
  return (size_t)(BQ + 4 * BK) * LD * sizeof(T) + 2 * BK * sizeof(float) +
         (std::is_same<T, float>::value ? (size_t)BQ * (BK + 4) * sizeof(float) : 0);
}

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: {row g, cols 2t..2t+1}, {row g+8, cols 2t..}, {row g, cols 2t+8..},
//           {row g+8, cols 2t+8..};
//   B regs: {k rows 2t..2t+1, col g}, {k rows 2t+8..2t+9, col g};
//   C:      c0,c1 at row g, cols 2t, 2t+1; c2,c3 at row g+8.
template <typename T, int D, bool HAS_MASK>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const uint8_t* __restrict__ mask,
                      const float* __restrict__ cosq, const float* __restrict__ sinq,
                      T* __restrict__ out, int reps, int Sq, int Sk, int H,
                      float qscale) {
  constexpr bool kBF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LD = D + VEC;          // padded shared-memory row stride
  constexpr int DT = D / 8;            // n8 tiles over the head dim
  constexpr int NT = BK / 8;           // n8 tiles over a key tile
  constexpr int HALF = D / 2;
  constexpr int LDP = BK + 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;       // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
  float* bias = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // [2][BK]
  float* Ps = bias + 2 * BK;  // fp32 instantiation only

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
    T* Kb = Ks + buf * BK * LD;
    T* Vb = Vs + buf * BK * LD;
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

  // prologue: rotate the q tile in fp32 with the pre-scaled tables
  for (int i = tid; i < BQ * HALF; i += NTHREADS) {
    const int r = i / HALF, d = i % HALF, qi = q0 + r;
    float o1 = 0.f, o2 = 0.f;
    if (qi < Sq) {
      const T* qp = q + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
      const float* cp = cosq + ((size_t)b * Sq + qi) * D;
      const float* sp = sinq + ((size_t)b * Sq + qi) * D;
      const float x1 = to_float(qp[d]), x2 = to_float(qp[d + HALF]);
      const float c1 = __fmul_rn(cp[d], qscale), c2 = __fmul_rn(cp[d + HALF], qscale);
      const float s1 = __fmul_rn(sp[d], qscale), s2 = __fmul_rn(sp[d + HALF], qscale);
      o1 = __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(-x2, s1));
      o2 = __fadd_rn(__fmul_rn(x2, c2), __fmul_rn(x1, s2));
    }
    Qs[r * LD + d] = from_float<T>(o1);
    Qs[r * LD + d + HALF] = from_float<T>(o2);
  }
  __syncthreads();

  uint32_t qa[kBF ? D / 16 : 1][4];
  if constexpr (kBF) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t4;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + c0]);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + c0]);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + c0 + 8]);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + c0 + 8]);
    }
  }

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
    const T* Kb = Ks + buf * BK * LD;
    const T* Vb = Vs + buf * BK * LD;
    const float* kbias = bias + buf * BK;

    // S = Q K^T, log2 units
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kBF) {
      const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          // B fragments of key tiles j, j+1: matrices (j, k lo), (j, k hi),
          // (j+1, k lo), (j+1, k hi) of the row-major K tile
          uint32_t kb[4];
          ldmatrix_x4(kb, &Kb[((j + (lm >> 1)) * 8 + lr) * LD + kk * 16 + (lm & 1) * 8]);
          mma_bf16(s[j], qa[kk], kb[0], kb[1]);
          mma_bf16(s[j + 1], qa[kk], kb[2], kb[3]);
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float qa0 = to_float(Qs[r0 * LD + d]);
        const float qa1 = to_float(Qs[(r0 + 8) * LD + d]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kv = to_float(Kb[(j * 8 + 2 * t4 + e) * LD + d]);
            s[j][e] = fmaf(qa0, kv, s[j][e]);
            s[j][2 + e] = fmaf(qa1, kv, s[j][2 + e]);
          }
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
    if constexpr (kBF) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          // B fragments of head-dim tiles dt, dt+1 from the row-major V tile,
          // transposed by ldmatrix: matrices (k lo, dt), (k hi, dt),
          // (k lo, dt+1), (k hi, dt+1)
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, &Vb[(kk * 16 + (lm & 1) * 8 + lr) * LD + (dt + (lm >> 1)) * 8]);
          mma_bf16(o[dt], pa, vb[0], vb[1]);
          mma_bf16(o[dt + 1], pa, vb[2], vb[3]);
        }
      }
    } else {
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
            const float vv = to_float(Vb[kj * LD + dt * 8 + 2 * t4 + e]);
            o[dt][e] = fmaf(p0, vv, o[dt][e]);
            o[dt][2 + e] = fmaf(p1, vv, o[dt][2 + e]);
          }
      }
      __syncwarp();
    }
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
      T* op = out + ((size_t)b * Sq + qi) * row_stride + (size_t)h * D;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int c = dt * 8 + 2 * t4;
        op[c] = from_float<T>(o[dt][2 * hh] / l_r[hh]);
        op[c + 1] = from_float<T>(o[dt][2 * hh + 1] / l_r[hh]);
      }
    }
  }
}

template <typename T, int D, bool HAS_MASK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   const void* cosq, const void* sinq, void* out, int B, int reps,
                   int Sq, int Sk, int H, float qscale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  auto kern = flash_fwd_rope_kernel<T, D, HAS_MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(cosq),
      static_cast<const float*>(sinq), static_cast<T*>(out), reps, Sq, Sk, H, qscale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mask(int has_mask, const void* q, const void* k, const void* v,
                        const void* mask, const void* cosq, const void* sinq, void* out,
                        int B, int reps, int Sq, int Sk, int H, float qscale,
                        cudaStream_t stream) {
  if (has_mask)
    return launch<T, D, true>(q, k, v, mask, cosq, sinq, out, B, reps, Sq, Sk, H, qscale,
                              stream);
  return launch<T, D, false>(q, k, v, mask, cosq, sinq, out, B, reps, Sq, Sk, H, qscale,
                             stream);
}

}  // namespace

// q [B,Sq,H,D], k (rotated) [B,Sk,H,D], v [B/reps,Sk,H,D], mask [B,Sk] uint8
// (ignored unless has_mask), cos/sin [B,Sq,D] fp32, out [B,Sq,H,D].
extern "C" int rf_flash_fwd_rope(const void* q, const void* k, const void* v,
                                 const void* mask, const void* cosq, const void* sinq,
                                 void* out, int dtype, int has_mask, int B, int reps,
                                 int Sq, int Sk, int H, int D, float qscale,
                                 void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || reps <= 0) return cudaErrorInvalidValue;
  if (D != 128) return cudaErrorInvalidValue;  // the head dim of the released models
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_mask<__nv_bfloat16, 128>(has_mask, q, k, v, mask, cosq, sinq, out, B,
                                           reps, Sq, Sk, H, qscale, s);
  if (dtype == kF32)
    return launch_mask<float, 128>(has_mask, q, k, v, mask, cosq, sinq, out, B, reps, Sq,
                                   Sk, H, qscale, s);
  return cudaErrorInvalidValue;
}
