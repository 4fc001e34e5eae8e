// RMSNorm over the last axis with fp32 statistics: the forward, and the
// backward (dx and the scale's gradient ds, in one launch).
//
// Replaces renderformer_tpu/ops/fused_norm.py:_fwd_kernel and :_bwd_kernel
// (reached through _fwd2d / _bwd2d, the backward's ds sum and cast through
// _fused_vjp_bwd).  Semantics are those of the Pallas kernels, on x [R, D]
// in bf16 or fp32 and the scale [D] in bf16 or fp32 (a template parameter of
// its own, read as it is given and widened to fp32 in registers, exactly: no
// cast of the scale before a launch):
//   * inv = rsqrt(sum(x*x)/D + eps), the sum in fp32;
//   * fp32: y = x*inv*s; bf16: y = bf16(bf16(x * bf16(inv)) * bf16(s)), two
//     roundings with inv cast first, the order of the XLA path;
//   * backward, with inv recomputed from x and gs = g*s, in fp32:
//     dx = gs*inv - x*(inv^3 * sum(gs*x)/D), cast to x's dtype, and
//     ds = sum over the rows of g*(x*inv) in fp32, written in the scale's
//     dtype (as the VJP returns it).
// Rows past R are skipped by bounds, with no padding.
//
// Bound on this card: a few flops per element against 2 (forward) or 3
// (backward) passes over [R, D], far below the ~295 flop/byte ridge: memory
// bound.  Both kernels run a warp per row, each lane reading 16 bytes at a
// time at columns (c*32 + lane)*VEC, so a warp's loads are contiguous; the
// row stays in registers between its reductions and its rescale, so x (and
// g) are read once.  The forward issues its lane's scale loads (16 bytes at
// a time) with the row's, so that they are in flight together and not after
// the reduction; blocks of 8 warps, a row each.
//
// The backward at the train step's sites (R ~ 1-2 thousand rows of 768) is
// a few microseconds of bytes, so its launch, its reduction of ds across
// the card and its tail decide its time.  Design:
//   * one launch writes dx and the finished ds, with no atomics on values,
//     so ds is the same bits from run to run;
//   * a grid of about the blocks the card holds at once (the wrapper's plan
//     from rf_rms_norm_bwd_capacity, the occupancy API's count): block b
//     owns rows [b*rows_per_block, (b+1)*rows_per_block), its warps take
//     every 8th row of them, and a warp's next row is loaded before the
//     current row's math;
//   * the scale is loaded once a warp into registers, by 16-byte loads;
//     gs = g*s once an element, kept between the two passes over the row;
//   * ds in three stages, each summing in a fixed order: (1) each warp keeps
//     its columns' sums in registers and sends them (st.async) into the
//     shared memory of the block of its thread block cluster (8 blocks)
//     that owns their slice of D/8 columns, counted on that block's
//     mbarrier, so no cluster-wide barrier waits for the dx stores in
//     flight; (2) each block adds its slice over the cluster's 64 warps and
//     writes it to a workspace [clusters, D]; (3) the last cluster to write
//     slice r (an acquire-release atomic ticket a slice) sums the slice over
//     the clusters in cluster order, 8 loads a thread in flight, writes ds,
//     and sets its ticket back to 0, so the next launch in stream order (or
//     the next replay of a CUDA graph) finds it at 0.  The tickets are a
//     device variable of this module, zero when it loads and never freed:
//     the wrapper gives each stream a slot of its own, so no allocation's
//     lifetime (a graph's, a stream's) is tied to them.  Stage 3 reads
//     clusters * D/8 values a slice, not one block every block's partial;
//     its chain (a store, the ticket, a load) is what keeps the kernel
//     above its bytes bound at these sizes.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

using namespace rf;
namespace cg = cooperative_groups;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CLUSTER = 8;  // blocks of the backward that add their ds sums together
constexpr int TICKET_SLOTS = 256;  // streams that may run the backward, a slot each

// the backward's tickets, a slot of CLUSTER a stream: 0 between launches
__device__ unsigned g_tickets[TICKET_SLOTS][CLUSTER];

// N consecutive elements at p as fp32, by 16-byte loads, or one 8-byte load
// where N elements take 8 bytes (a bf16 scale beside fp32 x)
template <typename T, int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const T* p) {
  constexpr int PER = 16 / sizeof(T);
  if constexpr (N % PER == 0) {
#pragma unroll
    for (int c = 0; c < N / PER; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_float(e[i]);
    }
  } else {
    static_assert(N * sizeof(T) == 8, "a 16- or 8-byte multiple");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// MAXC: 16-byte chunks of x a lane holds, covering D <= MAXC * 32 * VEC; S
// the scale's type
template <typename T, typename S, int MAXC>
__global__ void __launch_bounds__(NTHREADS)
rms_norm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    T* __restrict__ y, int R, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * NWARPS + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + (size_t)row * D;
  float v[MAXC][VEC], sc[MAXC][VEC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < D) {
      load_vec<T, VEC>(v[c], xr + col);
      load_vec<S, VEC>(sc[c], scale + col);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if ((c * 32 + lane) * VEC < D) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(v[c][i], v[c][i], ss);
    }
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)D + eps);
  const float inv_b = round_bf16(inv);
  T* yr = y + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < D) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (std::is_same<T, float>::value)
          o[i] = __fmul_rn(__fmul_rn(v[c][i], inv), sc[c][i]);
        else  // x and bf16(inv) are bf16 values: each product rounds once
          o[i] = __fmul_rn(round_bf16(__fmul_rn(v[c][i], inv_b)), round_bf16(sc[c][i]));
      }
      store_vec<T, VEC>(yr + col, o);
    }
  }
}

// element i of a 16-byte vector of T, as fp32
template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int i) {
  return to_float(reinterpret_cast<const T*>(&raw)[i]);
}

// shared::cluster address of this block's shared address `a` in block `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// 16 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async16(uint32_t addr, const float* v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(__float_as_uint(v[2])),
      "r"(__float_as_uint(v[3])), "r"(bar)
      : "memory");
}

// atomicAdd(p, 1) with acquire-release semantics at the card's scope
__device__ __forceinline__ unsigned ticket(unsigned* p) {
  unsigned t;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(t) : "l"(p) : "memory");
  return t;
}

// NC: 16-byte chunks of x a lane holds (D <= NC * 32 * VEC); D a multiple of
// 64, so that slice r of the columns, [r * D/8, (r + 1) * D/8), holds whole
// 16-byte chunks.  ds_part [gridDim.x / CLUSTER, D] fp32 workspace; slot,
// the stream's row of g_tickets; ds [D] in the scale's dtype.
// Dynamic shared memory: the block's slice from every warp of its cluster,
// [CLUSTER][NWARPS][D / 8] floats.
template <typename T, typename S, int NC>
__global__ void __launch_bounds__(NTHREADS, 1)
rms_norm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                    const T* __restrict__ g, T* __restrict__ dx, S* __restrict__ ds,
                    float* __restrict__ ds_part, int slot, int R, int D,
                    int rows_per_block, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int SOURCES = CLUSTER * NWARPS;  // the warps that send a block its slice
  extern __shared__ __align__(16) float recv[];  // [SOURCES][sw]
  __shared__ float comb[NTHREADS];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rank = (int)cg::this_cluster().block_rank();
  const int sw = D / CLUSTER;
  unsigned* tickets = g_tickets[slot];

  // the barrier that counts the block's slice as it arrives, initialised
  // before the cluster's blocks may send (the barrier's wait, below)
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float sc[NC][VEC], acc[NC][VEC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * 32 + lane) * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[c][i] = sc[c][i] = 0.f;
    if (col < D) load_vec<S, VEC>(sc[c], scale + col);
  }

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(R, row0 + rows_per_block);
  int row = row0 + warp;
  uint4 xn[NC], gn[NC];  // the warp's next row, in flight during the current one's math
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * 32 + lane) * VEC;
    xn[c] = gn[c] = make_uint4(0u, 0u, 0u, 0u);
    if (row < row_end && col < D) {
      xn[c] = *reinterpret_cast<const uint4*>(x + (size_t)row * D + col);
      gn[c] = *reinterpret_cast<const uint4*>(g + (size_t)row * D + col);
    }
  }
  for (; row < row_end; row += NWARPS) {
    uint4 xc[NC], gc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      xc[c] = xn[c];
      gc[c] = gn[c];
    }
    const int next = row + NWARPS;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (next < row_end && col < D) {
        xn[c] = *reinterpret_cast<const uint4*>(x + (size_t)next * D + col);
        gn[c] = *reinterpret_cast<const uint4*>(g + (size_t)next * D + col);
      }
    }
    float gs[NC][VEC];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if ((c * 32 + lane) * VEC < D) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xv = elem<T>(xc[c], i);
          gs[c][i] = __fmul_rn(elem<T>(gc[c], i), sc[c][i]);
          ss = fmaf(xv, xv, ss);
          dot = fmaf(gs[c][i], xv, dot);
        }
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float inv = rsqrtf(ss / (float)D + eps);
    const float coef = inv * inv * inv * (dot / (float)D);
    T* dxr = dx + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = (c * 32 + lane) * VEC;
      if (col < D) {
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xv = elem<T>(xc[c], i);
          o[i] = __fsub_rn(__fmul_rn(gs[c][i], inv), __fmul_rn(xv, coef));
          acc[c][i] = fmaf(elem<T>(gc[c], i), __fmul_rn(xv, inv), acc[c][i]);
        }
        store_vec<T, VEC>(dxr + col, o);
      }
    }
  }

  // ds, stage 1: each warp sends each column's sum to the block of the
  // cluster that owns the column's slice (st.async, counted on that block's
  // barrier), at [this block's rank][warp]
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const uint32_t recv_u32 = smem_u32(recv);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * 32 + lane) * VEC;
    if (col < D) {
      const int owner = col / sw;
      const uint32_t dst = cluster_addr(
          recv_u32 + 4u * (uint32_t)((rank * NWARPS + warp) * sw + col - owner * sw), owner);
      const uint32_t rbar = cluster_addr(smem_u32(&bar), owner);
#pragma unroll
      for (int i = 0; i < VEC; i += 4) st_async16(dst + 4u * i, &acc[c][i], rbar);
    }
  }
  if (threadIdx.x == 0) mbar_expect_tx(smem_u32(&bar), 4u * SOURCES * sw);
  mbar_wait(smem_u32(&bar), 0);

  // stage 2: the block adds its slice over the 64 warps in order (G groups
  // of threads take 64/G warps each, then the groups add in order) and
  // writes the cluster's sum of the slice to the workspace
  const int c0 = rank * sw;
  const int nclusters = gridDim.x / CLUSTER;
  const int groups = sw < NTHREADS ? NTHREADS / sw : 1;
  const int per_group = (SOURCES + groups - 1) / groups;
  for (int i = threadIdx.x; i < groups * sw; i += NTHREADS) {
    const int j = i / sw, k = i - j * sw;
    const int s0 = j * per_group, s1 = min(SOURCES, s0 + per_group);
    float s = 0.f;
    for (int src = s0; src < s1; ++src) s += recv[src * sw + k];
    if (groups > 1)
      comb[i] = s;
    else
      ds_part[(size_t)(blockIdx.x / CLUSTER) * D + c0 + k] = s;
  }
  if (groups > 1) {
    __syncthreads();
    for (int k = threadIdx.x; k < sw; k += NTHREADS) {
      float s = comb[k];
      for (int j = 1; j < groups; ++j) s += comb[j * sw + k];
      ds_part[(size_t)(blockIdx.x / CLUSTER) * D + c0 + k] = s;
    }
  }
  // the barrier orders the block's stores before thread 0's ticket, an
  // acquire-release atomic at the card's scope: its release makes them
  // visible to the block that takes the last ticket, whose acquire (and the
  // barrier after it) orders its reads after every cluster's stores (the
  // pattern of a grid-wide barrier)
  __syncthreads();
  if (threadIdx.x == 0) last = ticket(&tickets[rank]) == (unsigned)(nclusters - 1);
  __syncthreads();
  if (!last) return;

  // stage 3: the last cluster to write slice r sums it over the clusters
  // (from L2): G groups of threads take every G-th cluster of a column, QB
  // loads in flight at a time, then add the groups' sums in group order
  constexpr int QB = 8;
  for (int i = threadIdx.x; i < groups * sw; i += NTHREADS) {
    const int j = i / sw, k = i - j * sw;
    const float* p = ds_part + c0 + k;
    float s = 0.f;
    for (int q0 = j; q0 < nclusters; q0 += groups * QB) {
      float v[QB];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int q = q0 + u * groups;
        v[u] = q < nclusters ? __ldcg(p + (size_t)q * D) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) s += v[u];
    }
    if (groups > 1)
      comb[i] = s;
    else
      ds[c0 + k] = from_float<S>(s);
  }
  if (groups > 1) {
    __syncthreads();
    for (int k = threadIdx.x; k < sw; k += NTHREADS) {
      float s = comb[k];
      for (int j = 1; j < groups; ++j) s += comb[j * sw + k];
      ds[c0 + k] = from_float<S>(s);
    }
  }
  if (threadIdx.x == 0) tickets[rank] = 0;
}

// launch kernel K<T, S, MAXC> for the smallest MAXC in {1, 2, 4, 8, 16}
// whose registers hold a row
#define RF_DISPATCH_MAXC(T, S, LAUNCH)                                  \
  do {                                                                  \
    constexpr int VEC_ = 16 / sizeof(T);                                \
    if (D <= 1 * 32 * VEC_) { LAUNCH(T, S, 1); }                        \
    else if (D <= 2 * 32 * VEC_) { LAUNCH(T, S, 2); }                   \
    else if (D <= 4 * 32 * VEC_) { LAUNCH(T, S, 4); }                   \
    else if (D <= 8 * 32 * VEC_) { LAUNCH(T, S, 8); }                   \
    else if (D <= 16 * 32 * VEC_) { LAUNCH(T, S, 16); }                 \
    else return cudaErrorInvalidValue;                                  \
  } while (0)

// the backward's chunk counts: also 6, so that D = 768 in fp32 holds no idle
// registers (4.6 % less device time than 8 at the nerf train step's two fp32
// sites, tools/torch_norm_ab.py on an H100 80GB HBM3 at 700.00 W; 3 for bf16
// against 4 gained nothing there)
#define RF_DISPATCH_NC(T, S, LAUNCH)                                    \
  do {                                                                  \
    constexpr int VEC_ = 16 / sizeof(T);                                \
    if (D <= 1 * 32 * VEC_) { LAUNCH(T, S, 1); }                        \
    else if (D <= 2 * 32 * VEC_) { LAUNCH(T, S, 2); }                   \
    else if (D <= 4 * 32 * VEC_) { LAUNCH(T, S, 4); }                   \
    else if (D <= 6 * 32 * VEC_) { LAUNCH(T, S, 6); }                   \
    else if (D <= 8 * 32 * VEC_) { LAUNCH(T, S, 8); }                   \
    else if (D <= 16 * 32 * VEC_) { LAUNCH(T, S, 16); }                 \
    else return cudaErrorInvalidValue;                                  \
  } while (0)

// the four (x, scale) dtype pairs
#define RF_DISPATCH_DTYPES(DISPATCH, LAUNCH)                                        \
  do {                                                                              \
    if (dtype == kBF16 && scale_dtype == kBF16)                                     \
      DISPATCH(__nv_bfloat16, __nv_bfloat16, LAUNCH);                               \
    else if (dtype == kBF16 && scale_dtype == kF32)                                 \
      DISPATCH(__nv_bfloat16, float, LAUNCH);                                       \
    else if (dtype == kF32 && scale_dtype == kBF16)                                 \
      DISPATCH(float, __nv_bfloat16, LAUNCH);                                       \
    else if (dtype == kF32 && scale_dtype == kF32)                                  \
      DISPATCH(float, float, LAUNCH);                                               \
    else                                                                            \
      return cudaErrorInvalidValue;                                                 \
  } while (0)

size_t bwd_smem(int D) { return (size_t)NWARPS * D * sizeof(float); }  // 64 x D/8

// blocks of the backward kernel the current device holds at once, in whole
// clusters, or 0 where the query fails; leaves the kernel's shared-memory
// limit at its largest D, so that a launch at any D it takes needs no call
template <typename T, typename S, int NC>
int bwd_capacity(int D) {
  auto kern = rms_norm_bwd_kernel<T, S, NC>;
  const int n = cluster_capacity(kern, NTHREADS, bwd_smem(D), CLUSTER);
  const size_t most = bwd_smem(NC * 32 * (16 / sizeof(T)));
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most) !=
      cudaSuccess)
    return 0;
  return n * CLUSTER;
}

}  // namespace

// x, y [R, D] (dtype), scale [D] (scale_dtype); D a multiple of 8
extern "C" int rf_rms_norm_fwd(const void* x, const void* scale, void* y, int dtype,
                               int scale_dtype, int R, int D, float eps, void* stream) {
  if (R <= 0 || D <= 0 || D % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + NWARPS - 1) / NWARPS);
#define RF_FWD(T, S, M)                                                                \
  rms_norm_fwd_kernel<T, S, M><<<grid, NTHREADS, 0, s>>>(                              \
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(y), R, D, eps)
  RF_DISPATCH_DTYPES(RF_DISPATCH_MAXC, RF_FWD);
#undef RF_FWD
  return cudaGetLastError();
}

// Blocks of the backward kernel that the current device holds at once for x
// in dtype and rows of D, a multiple of the cluster size: the least over the
// two scale dtypes, so that the grid, and with it ds's order of sums, does
// not depend on the scale's dtype.  Returns 0 where the query fails.
extern "C" int rf_rms_norm_bwd_capacity(int dtype, int D) {
  if ((dtype != kBF16 && dtype != kF32) || D <= 0 || D % 64 ||
      D > 16 * 32 * (dtype == kBF16 ? 8 : 4))
    return 0;
  int n = 1 << 30;
  const int scale_dtypes[2] = {kBF16, kF32};
  for (int scale_dtype : scale_dtypes) {
    int cap = 0;
#define RF_CAP(T, S, NC) cap = bwd_capacity<T, S, NC>(D)
    RF_DISPATCH_DTYPES(RF_DISPATCH_NC, RF_CAP);
#undef RF_CAP
    n = cap < n ? cap : n;
  }
  return n > 0 ? n : 0;
}

// x, g, dx [R, D] (dtype), scale and ds [D] (scale_dtype),
// ds_part [blocks / 8, D] fp32, slot in [0, 256) the stream's tickets (no
// two launches that may run at once share one); blocks a multiple of 8 with
// blocks * rows_per_block >= R; D a multiple of 64.  Above D = 1536 (48 KB
// of shared memory), rf_rms_norm_bwd_capacity at that dtype and D, called
// once on the device beforehand, lifts the kernel's shared-memory limit.
extern "C" int rf_rms_norm_bwd(const void* x, const void* scale, const void* g, void* dx,
                               void* ds, void* ds_part, int slot, int dtype,
                               int scale_dtype, int R, int D, int blocks, int rows_per_block,
                               float eps, void* stream) {
  if (R <= 0 || D <= 0 || D % 64 || blocks <= 0 || blocks % CLUSTER || rows_per_block <= 0 ||
      (long long)blocks * rows_per_block < R || slot < 0 || slot >= TICKET_SLOTS)
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#define RF_BWD(T, S, NC)                                                                   \
  do {                                                                                     \
    const cudaError_t err = cudaLaunchKernelEx(                                            \
                             &cfg, rms_norm_bwd_kernel<T, S, NC>, static_cast<const T*>(x), \
                             static_cast<const S*>(scale), static_cast<const T*>(g),       \
                             static_cast<T*>(dx), static_cast<S*>(ds),                     \
                             static_cast<float*>(ds_part), slot,                           \
                             R, D, rows_per_block, eps);                                   \
    if (err != cudaSuccess) return err;                                                    \
  } while (0)
  RF_DISPATCH_DTYPES(RF_DISPATCH_NC, RF_BWD);
#undef RF_BWD
  return cudaGetLastError();
}
