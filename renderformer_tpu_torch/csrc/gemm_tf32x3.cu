// The float32 matrix product of a linear in split TF32 on Hopper's tensor
// cores: C[M, N] = A[M, K] B[N, K]^T (+ bias[N]), fp32 in, fp32 out, fp32
// accumulation; the forward, dX and dW of every fp32 linear of the port
// whose caller leaves TF32 off (ops/gemm_tf32x3.py, nn/core.py:linear).
//
// Replaces no TPU kernel: the JAX package leaves its fp32 products to XLA,
// which runs them on the TPU's matrix unit at fp32 accuracy.  On the H100
// torch has two ways to run an fp32 product, SIMT FFMA (cuBLAS's
// sm80_xmma_gemm_f32f32 and CUTLASS SIMT sgemm, 67 TFLOP/s at most) or
// single-pass TF32 (10-bit products, which the fine-tune step's view stage
// cannot take); this kernel is the third: three TF32 products a term,
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, each product of two TF32 values exact
// in fp32, a_lo*b_lo (below 2^-22 |a*b|) dropped.  x = hi + lo as
// common.cuh's split_tf32 (hi rounded to nearest, ties away from zero; lo
// = x - hi truncated; |x - hi - lo| < 2^-21 |x| for normal x), with inf
// and NaN passed through in hi and a zero lo.
//
// Bound on this card: 2*M*N*K flops a product, three TF32 products on the
// tensor cores at 494.7 TFLOP/s dense, so 165 TFLOP/s of fp32 work; the
// bytes (A once, B's hi and lo once, C once) are far below the ridge at
// the step's shapes.  Design:
//   * one persistent block an SM walks the output tiles (BM x BN = 128 x
//     128) in turn, each, where the tiles are too few to fill the card, cut
//     into `splits` slices of the reduction whose partials a second pass
//     adds in slice order (no atomics: the same bits every run);
//   * a producer warpgroup (one warp issues TMA loads, the warpgroup gives
//     its registers to the consumers by setmaxnreg: 24 a thread against
//     240; ptxas still allocates within the 12-warp block's 168 and spills
//     a few words) keeps a ring of STAGES stages of BK = 32 (one 128-byte
//     swizzled row of fp32) full, with full and empty mbarriers; two
//     consumer warpgroups own 64 rows of the tile each;
//   * wgmma reads a 32-bit B from shared memory K-major only, so B arrives
//     split: tf32x3_split_kernel writes B's hi and lo (K-major, transposed
//     where B is wT for dX or the layer's input for dW) before the product;
//   * A arrives raw, K-major (forward, dX) or MN-major (dW: A = dY^T read
//     from dY as it lies), and each consumer thread loads its m64k8 A
//     fragments from shared memory, splits them in registers and issues
//     wgmma m64n128k8 with A from registers: lo*B_hi, hi*B_lo, hi*B_hi a k
//     step.  The fragments of the next stage are loaded while a stage's
//     products run (two fragment sets);
//   * the tensor cores add each product into their accumulator with the
//     sum truncated, so over a long reduction the error grows with the
//     number of wgmmas that touch one accumulator (3 K / 8 of them: 12-25
//     times torch's fp32 product's error at K = 1024-4096 on the H100).
//     A stage's 12 products go into a fresh accumulator, which is then
//     added into the fp32 sum in registers, rounded to nearest: one
//     truncating chain of 12 a stage, and an error below cuBLAS fp32's.
// At the fine-tune step's shapes the kernel runs at 56-68 % of its bound
// (PERF.md, kernel G1).
#include <cuda.h>

#include "common.cuh"
#include "sm90.cuh"

using namespace rf;

namespace {

constexpr int BM = 128;                               // rows a tile
constexpr int BN = 128;                               // columns a tile
constexpr int BK = 32;                                // reduction a stage
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 4;                  // 16 KB
constexpr int B_BYTES = BN * BK * 4;                  // 16 KB, each of hi and lo
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;    // 48 KB
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
constexpr int CONSUMERS = 2;                          // warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;        // + the producer warpgroup

// x = hi + lo (see the note above); hi and lo as TF32 bit patterns
__device__ __forceinline__ void split_x3(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t u = __float_as_uint(x);
  hi = (u & 0x7F800000u) == 0x7F800000u ? u : (u + 0x1000u) & 0xFFFFE000u;
  lo = (hi & 0x7F800000u) == 0x7F800000u
           ? 0u
           : __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xFFFFE000u;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

#define RF_W64 RF_W32, RF_W8(32), RF_W8(40), RF_W8(48), RF_W8(56)

// D[64 x 128] (+)= A[64 x 8] (TF32, registers) B[8 x 128] (TF32, K-major in
// shared memory: low descriptor word b, high word hi).  ACC false overwrites
// D without reading it.
template <bool ACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint32_t b,
                                           uint32_t hi) {
  if constexpr (ACC) {
    asm volatile(
        "{\n.reg .b64 db;\nmov.b64 db, {%68, %69};\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " RF_R64
        ", {%64, %65, %66, %67}, db, 1, 1, 1;\n}\n"
        : RF_F64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(hi));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nmov.b64 db, {%68, %69};\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " RF_R64
        ", {%64, %65, %66, %67}, db, p, 1, 1;\n}\n"
        : RF_W64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(hi));
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&h)[4][4], uint32_t (&l)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(h[i][e]), "+r"(l[i][e])::"memory");
}

// A fragment of m64k8 for warp w of a warpgroup (g = lane / 4, t = lane % 4):
// a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), rows
// 16w.. of the warpgroup's 64.  A stage's A tile is K-major, [BM rows][32 k]
// with 16-byte chunk c of row r at chunk c ^ (r % 8), or MN-major, four
// boxes [32 k][32 rows] 4 KB apart with chunk c of k row j at c ^ (j % 8).
template <bool A_MN>
struct AFrag {
  // byte offset of the thread's element (row r0 + 8i, k t + 4k4) of k step
  // 0; k step kk adds a constant (MN-major) or moves the chunk (K-major)
  uint32_t off[2][2];
  uint32_t g;

  __device__ __forceinline__ AFrag(int row0, int lane) {
    g = lane >> 2;
    const uint32_t t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t r = row0 + g + 8 * i;
#pragma unroll
      for (int k4 = 0; k4 < 2; ++k4) {
        if constexpr (A_MN) {
          const uint32_t k = t + 4 * k4;  // k % 8 of every k step
          off[i][k4] = (r >> 5) * 4096 + k * 128 + ((((r & 31) >> 2) ^ k) << 4) + (r & 3) * 4;
        } else {
          off[i][k4] = r * 128 + t * 4;
        }
      }
    }
  }

  // the split fragments of k steps 0..3 of the stage's A tile at `tile`
  __device__ __forceinline__ void load(const unsigned char* tile, uint32_t (&h)[4][4],
                                       uint32_t (&l)[4][4]) const {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e & 1, k4 = e >> 1;  // a0 (r0, t), a1 (r0+8, t), a2 (r0, t+4), a3
        uint32_t addr;
        if constexpr (A_MN) {
          addr = off[i][k4] + kk * 8 * 128;  // k rows 8kk.. of the box
        } else {
          addr = off[i][k4] + (((uint32_t)(2 * kk + k4) ^ g) << 4);  // row r: r % 8 = g
        }
        x[e] = *reinterpret_cast<const float*>(tile + addr);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) split_x3(x[e], h[kk][e], l[kk][e]);
    }
  }
};

struct Unit {
  int tm, tn, kb0, kb1, split;
};

__device__ __forceinline__ Unit unit_of(int u, int tiles_n, int splits, int nkb) {
  Unit w;
  w.split = u % splits;
  const int tile = u / splits;
  w.tm = tile / tiles_n;
  w.tn = tile % tiles_n;
  w.kb0 = (int)((long long)w.split * nkb / splits);
  w.kb1 = (int)((long long)(w.split + 1) * nkb / splits);
  return w;
}

template <bool A_MN>
__global__ void __launch_bounds__(THREADS, 1)
tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmh,
                   const __grid_constant__ CUtensorMap tml, const float* __restrict__ bias,
                   float* __restrict__ c, int M, int N, int K, int splits) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + BN - 1) / BN;
  const int nkb = (K + BK - 1) / BK;
  const int units = ((M + BM - 1) / BM) * tiles_n * splits;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);                // the producer's expect_tx
      mbar_init(empty(s), CONSUMERS * 4);   // every consumer warp
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
    if (warp == 0 && lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, tiles_n, splits, nkb);
        for (int kb = w.kb0; kb < w.kb1; ++kb, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          const uint32_t dst = base + s * STAGE_BYTES;
          mbar_expect_tx(full(s), STAGE_BYTES);
          if constexpr (A_MN) {
#pragma unroll
            for (int j = 0; j < BM / 32; ++j)
              tma_load_2d(dst + j * 4096, &tma, full(s), w.tm * BM + 32 * j, kb * BK);
          } else {
            tma_load_2d(dst, &tma, full(s), kb * BK, w.tm * BM);
          }
          tma_load_2d(dst + A_BYTES, &tmh, full(s), kb * BK, w.tn * BN);
          tma_load_2d(dst + A_BYTES + B_BYTES, &tml, full(s), kb * BK, w.tn * BN);
        }
      }
    }
    return;
  }

  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = wgi - 1, w4 = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const AFrag<A_MN> frag(wg * 64 + 16 * w4, lane);
  const uint32_t bh_lo = desc_lo(base + A_BYTES, 16);
  const uint32_t bl_lo = desc_lo(base + A_BYTES + B_BYTES, 16);

  float acc[64], part[64];
  uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];

  auto wait_load = [&](int it, uint32_t (&h)[4][4], uint32_t (&l)[4][4]) {
    const int s = it % STAGES;
    mbar_wait(full(s), (it / STAGES) & 1);
    frag.load(smem + s * STAGE_BYTES, h, l);
  };
  // the stage's 12 products into a fresh accumulator: for each k step of 8,
  // lo*B_hi, hi*B_lo, hi*B_hi
  auto issue = [&](int it, const uint32_t (&h)[4][4], const uint32_t (&l)[4][4]) {
    const uint32_t so = (uint32_t)((it % STAGES) * STAGE_BYTES) >> 4;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ko = so + 2 * kk;  // 32 bytes a k step, in 16-byte units
      if (kk == 0)
        wgmma_tf32<false>(part, l[kk], bh_lo + ko, DESC_HI);
      else
        wgmma_tf32<true>(part, l[kk], bh_lo + ko, DESC_HI);
      wgmma_tf32<true>(part, h[kk], bl_lo + ko, DESC_HI);
      wgmma_tf32<true>(part, h[kk], bh_lo + ko, DESC_HI);
    }
    wgmma_commit();
  };
  // the stage's products are done: free its slot and add them to the sum
  auto finish = [&](int it) {
    wgmma_wait<0>();
    fence_regs(part);
    if (lane == 0) mbar_arrive(empty(it % STAGES));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  };

  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_of(u, tiles_n, splits, nkb);
    const int n = w.kb1 - w.kb0;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    wait_load(it, h0, l0);
    for (int i = 0;; i += 2) {
      issue(it + i, h0, l0);
      if (i + 1 < n) wait_load(it + i + 1, h1, l1);  // while the products run
      finish(it + i);
      fence_frags(h0, l0);
      if (i + 1 >= n) break;
      issue(it + i + 1, h1, l1);
      if (i + 2 < n) wait_load(it + i + 2, h0, l0);
      finish(it + i + 1);
      fence_frags(h1, l1);
      if (i + 2 >= n) break;
    }
    it += n;

    // epilogue: register 4j + e holds row 16w + g + 8(e / 2), column 8j +
    // 2t + e % 2 of the warpgroup's 64 x 128
    float* out = c + (size_t)w.split * M * N;
    const int row = w.tm * BM + wg * 64 + 16 * w4 + g;
    const bool add_bias = bias != nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = w.tn * BN + 8 * j + 2 * t4;
      if (col >= N) continue;
      float b0 = 0.f, b1 = 0.f;
      if (add_bias) {
        b0 = bias[col];
        b1 = bias[col + 1];
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row + 8 * hf;
        if (r < M)
          *reinterpret_cast<float2*>(out + (size_t)r * N + col) =
              make_float2(acc[4 * j + 2 * hf] + b0, acc[4 * j + 2 * hf + 1] + b1);
      }
    }
  }
}

// hi and lo of x [rows, cols] (row stride ldx) into [rows, cols] (row
// stride ldo), or, transposed, into [cols, rows] (row stride ldo)
__global__ void tf32x3_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                    float* __restrict__ lo, int rows, int cols, int ldx,
                                    int ldo) {
  const int vc = cols / 4;
  const size_t n = (size_t)rows * vc;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / vc), c4 = (int)(i % vc) * 4;
    const float4 v = *reinterpret_cast<const float4*>(x + (size_t)r * ldx + c4);
    uint4 h, l;
    split_x3(v.x, h.x, l.x);
    split_x3(v.y, h.y, l.y);
    split_x3(v.z, h.z, l.z);
    split_x3(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + (size_t)r * ldo + c4) = h;
    *reinterpret_cast<uint4*>(lo + (size_t)r * ldo + c4) = l;
  }
}

__global__ void tf32x3_split_t_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                      float* __restrict__ lo, int rows, int cols, int ldx,
                                      int ldo) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < 32; i += 8) {
    const int r = r0 + ty + i, cc = c0 + tx;
    tile[ty + i][tx] = (r < rows && cc < cols) ? x[(size_t)r * ldx + cc] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 32; i += 8) {
    const int cc = c0 + ty + i, r = r0 + tx;
    if (cc < cols && r < rows) {
      uint32_t h, l;
      split_x3(tile[tx][ty + i], h, l);
      hi[(size_t)cc * ldo + r] = __uint_as_float(h);
      lo[(size_t)cc * ldo + r] = __uint_as_float(l);
    }
  }
}

// out [rows, cols] = the sum of part [splits, rows, cols] in slice order
// (+ bias [cols]); cols a multiple of 4
__global__ void tf32x3_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ bias, float* __restrict__ out,
                                     size_t n4, int cols, int splits) {
  const size_t n = n4 * 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 acc = reinterpret_cast<const float4*>(part)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = reinterpret_cast<const float4*>(part + s * n)[i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    if (bias != nullptr) {
      const float4 b = *reinterpret_cast<const float4*>(bias + (i * 4) % cols);
      acc.x += b.x;
      acc.y += b.y;
      acc.z += b.z;
      acc.w += b.w;
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
}

// [outer, inner] fp32 with row stride ld elements as a 2-D map, a box of 32
// x box_outer with the 128-byte swizzle; out-of-range elements read zeros
cudaError_t map_2d(CUtensorMap* map, const float* ptr, int inner, int outer, int ld,
                   int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool A_MN>
cudaError_t launch_gemm(const float* a, const float* bhi, const float* blo, const float* bias,
                        float* c, int M, int N, int K, int lda, int ldb, int splits, int grid,
                        cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        tf32x3_gemm_kernel<A_MN>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  CUtensorMap ta, th, tl;
  cudaError_t e = A_MN ? map_2d(&ta, a, M, K, lda, 32) : map_2d(&ta, a, K, M, lda, BM);
  if (e == cudaSuccess) e = map_2d(&th, bhi, K, N, ldb, BN);
  if (e == cudaSuccess) e = map_2d(&tl, blo, K, N, ldb, BN);
  if (e != cudaSuccess) return e;
  tf32x3_gemm_kernel<A_MN><<<grid, THREADS, SMEM_BYTES, stream>>>(ta, th, tl, bias, c, M, N, K,
                                                                 splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// C = A B^T (+ bias) in split TF32 (see the note at the top).  A is [M, K]
// with row stride lda (a_mn 0) or [K, M] with row stride lda (a_mn 1); bhi
// and blo are B's split halves, [N, K] with row stride ldb; C is [M, N]
// contiguous, or, with splits > 1, [splits, M, N] partials for
// rf_gemm_tf32x3_reduce, which adds the bias then.  grid blocks walk the tiles.  Pointers 16-byte
// aligned, lda and ldb multiples of 4.
int rf_gemm_tf32x3(const float* a, const float* bhi, const float* blo, const float* bias,
                   float* c, int a_mn, int M, int N, int K, int lda, int ldb, int splits,
                   int grid, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || grid <= 0 || (lda & 3) || (ldb & 3) ||
      (N & 1) || !aligned16(a) || !aligned16(bhi) || !aligned16(blo) || !aligned16(c) ||
      (splits > 1 && bias != nullptr) || splits > (K + BK - 1) / BK)
    return cudaErrorInvalidValue;
  return a_mn ? launch_gemm<true>(a, bhi, blo, bias, c, M, N, K, lda, ldb, splits, grid, stream)
              : launch_gemm<false>(a, bhi, blo, bias, c, M, N, K, lda, ldb, splits, grid,
                                   stream);
}

// hi and lo of x [rows, cols] (row stride ldx): [rows, cols] with row stride
// ldo, or with transpose [cols, rows] with row stride ldo
int rf_tf32x3_split(const float* x, float* hi, float* lo, int rows, int cols, int ldx, int ldo,
                    int transpose, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
  if (transpose) {
    const dim3 grid((cols + 31) / 32, (rows + 31) / 32);
    tf32x3_split_t_kernel<<<grid, dim3(32, 8), 0, stream>>>(x, hi, lo, rows, cols, ldx, ldo);
  } else {
    if ((cols & 3) || (ldx & 3) || (ldo & 3) || !aligned16(x) || !aligned16(hi) ||
        !aligned16(lo))
      return cudaErrorInvalidValue;
    const size_t n = (size_t)rows * (cols / 4);
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    tf32x3_split_kernel<<<blocks, 256, 0, stream>>>(x, hi, lo, rows, cols, ldx, ldo);
  }
  return cudaGetLastError();
}

// out [rows, cols] = the sum of part [splits, rows, cols] in slice order
// (+ bias [cols], or nullptr); cols a multiple of 4
int rf_gemm_tf32x3_reduce(const float* part, const float* bias, float* out, int rows, int cols,
                          int splits, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || (cols & 3) || splits <= 0 || !aligned16(part) ||
      !aligned16(out) || (bias != nullptr && !aligned16(bias)))
    return cudaErrorInvalidValue;
  const size_t n4 = (size_t)rows * cols / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  tf32x3_reduce_kernel<<<blocks, 256, 0, stream>>>(part, bias, out, n4, cols, splits);
  return cudaGetLastError();
}

}  // extern "C"
