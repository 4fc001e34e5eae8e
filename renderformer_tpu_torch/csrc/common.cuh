// Shared helpers of the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rf {

// dtype codes passed from Python (_build.DTYPE_CODES)
enum DType : int { kBF16 = 0, kF32 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---- mma.sync / ldmatrix / cp.async helpers (flash and swin attention) ----

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

// ---- split TF32 ("3xTF32"): fp32 products on the tensor cores ----
//
// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits) to nearest, ties
// away from zero, which is cvt.rna's result for every finite x, in two
// integer ops (half a TF32 ulp added to the magnitude bits, the low 13 bits
// cleared; cvt.rna itself compiles to some ten instructions); lo = x - hi is
// exact in fp32 and is truncated to TF32, so |x - hi - lo| < 2^-21 |x|.
// a*b is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, the small products
// first, each product of two TF32 values exact in fp32; a_lo*b_lo (below
// 2^-22 |a*b|) is dropped.

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xFFFFE000u;
}

// x = hi + lo in two instructions: hi is x truncated to TF32 (its low 13
// bits cleared, exact as a TF32 operand), lo = x - hi is exact in fp32 and
// is passed as it is, the tensor cores reading a .tf32 operand's upper 19
// bits.  |x - hi - lo| < 2^-20 |x|, twice split_tf32's (hi rounded to
// nearest, two instructions more), which the emulations in
// tests/test_torch_flash_bwd_fp32.py and tests/test_torch_swin_fp32.py hold
// to the fp32 bars of the flash backward and of K6 and K6^T.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// D(16x8, fp32) += A(16x8, tf32, row-major) * B(8x8, tf32, col-major).
// Fragments (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g); C as mma.m16n8k16.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A*B in split TF32, A as (hi, lo) fragments, B as (hi, lo) pairs
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0 fills
// the 16 bytes with zeros (rows past the end of a ragged tile)
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

// Clusters of `splits` blocks of `threads` threads and `smem` bytes of
// dynamic shared memory that the current device holds of `kern` at once, or
// 0 where a query fails; sets the kernel's shared-memory limit on the way.
template <typename Kernel>
int cluster_capacity(Kernel kern, int threads, size_t smem, int splits) {
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * 1024, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

}  // namespace rf
