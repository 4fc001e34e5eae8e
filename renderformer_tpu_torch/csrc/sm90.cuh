// PTX wrappers and host helpers of the port's Hopper (sm_90a) kernels: the
// bf16 flash forward (flash_fwd_sm90.cu) and backward (flash_bwd_sm90.cu),
// and the mbarrier of the fused RMSNorm backward (fused_norm.cu).
// mbarriers, TMA loads and stores of 4-D tensor maps, wgmma shared-memory
// descriptors with the 128-byte swizzle, and the wgmma shapes the two
// kernels issue.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rf {

// ---- PTX wrappers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity; a wait
// that never ends traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// one box of shared memory into a 4-D tensor map (out-of-range rows are not
// written), in the issuing thread's bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the issuing thread's bulk groups have read their shared-memory sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory become visible to the async proxy
// (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barrier `id` over `threads` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving register reads or writes across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle, as two words:
// the low word holds the start address and the leading byte offset (K-major:
// unused; MN-major: between 64-element MN atoms), the high word the stride
// byte offset (between 8-row groups) and the swizzle mode, all in 16-byte
// units.  The high word is one constant for every descriptor of an operand,
// so each descriptor costs one register.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr >> 4) & 0x3FFF) | (((lbo >> 4) & 0x3FFF) << 16);
}
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);  // 8-row groups 1024 B apart; B128

#define RF_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define RF_F32 RF_F8(0), RF_F8(8), RF_F8(16), RF_F8(24)
#define RF_F64 RF_F32, RF_F8(32), RF_F8(40), RF_F8(48), RF_F8(56)
#define RF_R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define RF_R64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "     \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory;
// a and b are the low descriptor words, hi their shared high word
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint32_t a, uint32_t b, uint32_t hi,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint32_t a, uint32_t b,
                                             uint32_t hi, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\nsetp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RF_R32
      ", da, db, p, 1, 1, 0, 0;\n}\n"
      : RF_F32
      : "r"(a), "r"(b), "r"(hi), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint32_t a, uint32_t b,
                                              uint32_t hi, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "mov.b64 da, {%64, %66};\nmov.b64 db, {%65, %66};\nsetp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RF_R64
      ", da, db, p, 1, 1, 0, 0;\n}\n"
      : RF_F64
      : "r"(a), "r"(b), "r"(hi), "r"(accumulate));
}
#define RF_W8(i)                                                                          \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), "=f"(d[i + 4]), "=f"(d[i + 5]), \
      "=f"(d[i + 6]), "=f"(d[i + 7])
#define RF_W32 RF_W8(0), RF_W8(8), RF_W8(16), RF_W8(24)
#define RF_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B K-major in shared memory.
// ACC false overwrites D without reading it, so that the compiler keeps no
// earlier value of D alive across the product.
template <bool ACC>
__device__ __forceinline__ void wgmma_64x32(float (&d)[16], uint32_t a, uint32_t b, uint32_t hi) {
  if constexpr (ACC) {
    asm volatile(
        "{\n.reg .b64 da, db;\n"
        "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " RF_R16
        ", da, db, 1, 1, 1, 0, 0;\n}\n"
        : RF_F8(0), RF_F8(8)
        : "r"(a), "r"(b), "r"(hi));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "mov.b64 da, {%16, %18};\nmov.b64 db, {%17, %18};\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " RF_R16
        ", da, db, p, 1, 1, 0, 0;\n}\n"
        : RF_W8(0), RF_W8(8)
        : "r"(a), "r"(b), "r"(hi));
  }
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64] with both operands MN-major in
// shared memory (A read transposed); ACC as wgmma_64x32's.
template <bool ACC>
__device__ __forceinline__ void wgmma_64x64_mn(float (&d)[32], uint32_t a, uint32_t b,
                                               uint32_t hi) {
  if constexpr (ACC) {
    asm volatile(
        "{\n.reg .b64 da, db;\n"
        "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RF_R32
        ", da, db, 1, 1, 1, 1, 1;\n}\n"
        : RF_F32
        : "r"(a), "r"(b), "r"(hi));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "mov.b64 da, {%32, %34};\nmov.b64 db, {%33, %34};\nsetp.ne.b32 p, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RF_R32
        ", da, db, p, 1, 1, 1, 1;\n}\n"
        : RF_W32
        : "r"(a), "r"(b), "r"(hi));
  }
}
// D[64 x 128] += A[64 x 16] (registers) B[16 x 128], B MN-major in shared
// memory (low descriptor word b, high word hi)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[64], const uint32_t (&a)[4], uint32_t b,
                                            uint32_t hi) {
  asm volatile(
      "{\n.reg .b64 db;\nmov.b64 db, {%68, %69};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RF_R64
      ", {%64, %65, %66, %67}, db, 1, 1, 1, 1;\n}\n"
      : RF_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(hi));
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime so that
// the library needs no link to libcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// [nb, S, H, 128] bf16 as a 4-D map (innermost first), a box of BK rows x 1
// head x 64 columns with the 128-byte swizzle; out-of-range rows read zeros
inline cudaError_t kv_map(CUtensorMap* map, const void* ptr, int nb, int S, int H, int BK) {
  constexpr int D = 128;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// streaming multiprocessors of the current device (cached), 0 where the
// query fails
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  static int cache[64] = {};
  if (dev < 64 && cache[dev]) return cache[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) cache[dev] = n;
  return n;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace rf
