// Swin window self-attention in fp32, forward (K6) and backward (K6^T), as
// split TF32 on the tensor cores.  The C entry points of swin_attention.cu
// and swin_attention_bwd.cu send fp32 inputs here; bf16 stays in those
// files.
//
// Replaces renderformer_tpu/ops/swin_attention.py:_swin_kernel (through
// _swin_fwd) in fp32 and, for the backward, the XLA VJP of _ref_paired that
// _swin_op_bwd takes.  The functions are those of the notes at the top of
// swin_attention.cu and swin_attention_bwd.cu, in their order of rounding:
// q scaled by D^-0.5 * log2(e) and rounded, fp32 scores plus -1e30 on masked
// pairs, P = exp2(s - rowmax) / rowsum with the window's 64 keys resident;
// dS = (P o (dP - rowsum(P o dP))) * ln 2; dQ takes D^-0.5 * log2(e).
//
// Bound on this card: bytes.  At the swin-large train step (64 windows x 8
// heads: 512 (window, head) tiles) K6 reads q, k and v and writes out, 4 x
// 16.8 MB, 0.0200 ms at 3.35 TB/s; K6^T reads q, k, v and dO and writes dq,
// dk and dv, 7 x 16.8 MB, 0.0350 ms.  Their products (2 and 5 of 64x64x128
// a tile) as split TF32, three TF32 products each at 495 TFLOP/s, take
// 0.0065 and 0.0163 ms, below the bytes.
//
// What the first fp32 design lost (the bf16 kernels' layout, one block of 4
// warps a tile, scalar FMAs): its products were fed from shared memory, 2
// loads of A and 16 of B a warp against 32 FMAs, so shared memory's one
// wavefront a clock set about half of its time; and its tiles (119 KB for
// K6 with a P tile, 153 KB for K6^T) held one block an SM, which waited for
// all its loads, then multiplied, then stored.  Nothing overlapped the
// loads, and 4 warps an SM could not hide their latency: on an H100 SXM, K6
// took 0.080 ms a call in the step, slower than SDPA, and K6^T 0.168, 0.21
// of its bound.
//
// This design:
//  * Every product is split TF32 on mma.sync.m16n8k8 (common.cuh): hi
//    truncated to TF32 (split_tf32_trunc), three products, the small ones
//    first.  S and dP keep the hi*hi products and the small ones in
//    accumulators of their own, added before the mask; P V, dQ, dK and dV
//    take one accumulator over the window.  tests/test_torch_swin_fp32.py
//    emulates this arithmetic within 0.2 of the 2^-16 bar.
//  * Operands are split in registers as their fragments are loaded.  Every
//    [64][128] tile has a row stride of 132 floats, so the B fragments read
//    with the head dim as k (K for S, V for dP: banks 4g + t) and those read
//    with the window's tokens as k (rows 8j + 2t and 8j + 2t + 1: V for P V,
//    K for dQ, dO for dV, q for dK: banks 8t + g) are free of bank
//    conflicts.  The C layout of S (so P) becomes the A layout of P V by
//    naming tokens 8j + 2t and 8j + 2t + 1 the k indices t and t + 4, as the
//    fp32 flash kernels do: K6 keeps no P tile.
//  * A persistent grid of the blocks the card holds at once: each block
//    walks the tiles blockIdx.x, + gridDim.x, ..., and loads the next
//    tile's rows (16-byte cp.async) into each shared tile as soon as the
//    current tile is done with it, so they arrive under this tile's
//    products and stores.  The outputs go from registers to device memory
//    by 8-byte stores (a quad's 32 bytes of a row: one sector).
//  * With a mask, P = e / l skips the division where e is 0: a masked key's
//    zero dividend sent every such division down its slow path, and the
//    shifted layers ran 15-20 % slower than the unshifted ones.
//  * K6: q, k and v tiles, 101 KB, two blocks of 4 warps an SM, each warp
//    16 query rows; q and k are refilled after S, v after P V.  Two blocks
//    an SM measured faster than one block with a two-stage ring (8 warps an
//    SM hide the products' latency; 4 do not).
//  * K6^T: 8 warps a block, one block an SM (200 KB): q and k in two
//    stages, so the next tile's q and k load during the whole of this one;
//    dO, refilled after dV; v, whose buffer takes the P and dS tiles
//    ([64 queries][68]) once every warp has formed dP, refilled at the end.
//    The two warps of a 16-row group split the keys in S, P, dP and dS
//    (their row max, row sum and rowsum(P o dP) meet in shared memory, half
//    0's first) and the head dim in dQ = dS K (query rows), dK = dS^T q and
//    dV = P^T dO (key rows, P and dS read transposed).  No logsumexp, no o:
//    the window's 64 keys are resident.  Every output element is written
//    once by one thread: no atomics, the same bits on every run.
#include <algorithm>
#include <climits>

#include "common.cuh"
#include "sm90.cuh"
#include "swin_attention_f32.cuh"

using namespace rf;

namespace {

constexpr int S = 64;          // tokens per window (8 x 8)
constexpr int D = 128;         // head dim
constexpr int LD = D + 4;      // row stride of a [64][D] tile
constexpr int LDP = S + 4;     // row stride of K6^T's P and dS tiles (banks 8t + g read transposed)
constexpr int NT = S / 8;      // n8 tiles over the keys
constexpr int DT = D / 8;      // n8 tiles over the head dim
constexpr int FWD_THREADS = 128;  // K6: 4 warps of 16 query rows
constexpr int BWD_THREADS = 256;  // K6^T: 8 warps, two to a 16-row group
constexpr float NEG_BIG = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// Fragment layouts of mma.m16n8k8.tf32 (g = lane / 4, t = lane % 4): A a0
// (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B b0 (k t, n g), b1
// (k t+4, n g); C c0, c1 at row g, cols 2t, 2t+1; c2, c3 at row g+8.

// offset of (window, head) tile `tile` in a [BW, 64, H*D] tensor
__device__ __forceinline__ size_t tile_base(int tile, int H) {
  return (size_t)(tile / H) * S * H * D + (size_t)(tile % H) * D;
}

// start the 16-byte copies of a tile's [64][D] rows into a shared tile, by
// `threads` threads
template <int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t base, int H,
                                          int tid) {
  const size_t row_stride = (size_t)H * D;
  for (int i = tid; i < S * (D / 4); i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    cp_async16(&dst[r * LD + c], src + base + r * row_stride + c, true);
  }
}

// start the copy of a tile's window's region row (64 bytes)
template <bool HAS_MASK>
__device__ __forceinline__ void load_regions(uint8_t* reg, const uint8_t* regions, int tile,
                                             int H, int nW, int tid) {
  if (HAS_MASK && tid < S / 16)
    cp_async16(reg + tid * 16, regions + (size_t)((tile / H) % nW) * S + tid * 16, true);
}

// q times D^-0.5 * log2(e) in place, in the 16-byte chunks this thread
// copied (load_tile's), once they have landed
template <int THREADS>
__device__ __forceinline__ void scale_q(float* Qs, float qscale, int tid) {
  for (int i = tid; i < S * (D / 4); i += THREADS) {
    float4* p = reinterpret_cast<float4*>(&Qs[(i / (D / 4)) * LD + (i % (D / 4)) * 4]);
    const float4 x = *p;
    *p = make_float4(__fmul_rn(x.x, qscale), __fmul_rn(x.y, qscale), __fmul_rn(x.z, qscale),
                     __fmul_rn(x.w, qscale));
  }
}

// acc[j] (rows r0, r0 + 8; keys 8j + 2t, + 1 of B) = A[rows] . B[keys]^T
// over the head dim, A and B [*][LD] tiles (B from its first key): the hi*hi
// products in acc, the two small ones of each k step (lo*hi first) in an
// accumulator of their own, added at the end
template <int NJ>
__device__ __forceinline__ void rows_by_keys(float (&acc)[NJ][4], const float* A, const float* B,
                                             int r0, int g, int t4) {
  float small[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = small[j][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = kk * 8 + t4;
    uint32_t ah[4], al[4];
    split_tf32_trunc(A[r0 * LD + c], ah[0], al[0]);
    split_tf32_trunc(A[(r0 + 8) * LD + c], ah[1], al[1]);
    split_tf32_trunc(A[r0 * LD + c + 4], ah[2], al[2]);
    split_tf32_trunc(A[(r0 + 8) * LD + c + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* b = &B[(j * 8 + g) * LD + c];
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32_trunc(b[0], bh0, bl0);
      split_tf32_trunc(b[4], bh1, bl1);
      mma_tf32(small[j], al, bh0, bh1);
      mma_tf32(small[j], ah, bl0, bl1);
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// the A fragment of k step j from registers in rows_by_keys's C layout:
// tokens 8j + 2t (index t) and 8j + 2t + 1 (index t + 4), the columns of
// x[j] this thread holds
__device__ __forceinline__ void a_from_regs(uint32_t (&ah)[4], uint32_t (&al)[4],
                                            const float (&xj)[4]) {
  split_tf32_trunc(xj[0], ah[0], al[0]);
  split_tf32_trunc(xj[2], ah[1], al[1]);
  split_tf32_trunc(xj[1], ah[2], al[2]);
  split_tf32_trunc(xj[3], ah[3], al[3]);
}

// acc[dt] += the k step's three products with B's rows k0 and k0 + 1 of a
// [*][LD] tile (B from its first head-dim column): the fragment that reads
// tokens 8j + 2t and 8j + 2t + 1 with k0 = 8j + 2t (banks 8t + g)
template <int NDT>
__device__ __forceinline__ void step_by_rows(float (&acc)[NDT][4], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], const float* B, int k0,
                                             int g) {
  const float* b = B + k0 * LD + g;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32_trunc(b[dt * 8], bh0, bl0);
    split_tf32_trunc(b[LD + dt * 8], bh1, bl1);
    mma_3xtf32(acc[dt], ah, al, bh0, bh1, bl0, bl1);
  }
}

template <int NDT>
__device__ __forceinline__ void zero(float (&acc)[NDT][4]) {
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
}

// acc[dt] (key rows r0, r0 + 8; head-dim cols 8dt + 2t, + 1 of B) = X^T B
// over the 64 queries, X a [64 queries][LDP] tile (P or dS) read
// transposed, B a [64][LD] tile from its first column: the k step kk takes
// queries 8kk + 2t (index t) and 8kk + 2t + 1 (index t + 4)
template <int NDT>
__device__ __forceinline__ void keys_by_dim(float (&acc)[NDT][4], const float* X, const float* B,
                                            int r0, int g, int t4) {
  zero(acc);
#pragma unroll 2
  for (int kk = 0; kk < S / 8; ++kk) {
    const float* a = X + (kk * 8 + 2 * t4) * LDP + r0;
    uint32_t ah[4], al[4];
    split_tf32_trunc(a[0], ah[0], al[0]);
    split_tf32_trunc(a[8], ah[1], al[1]);
    split_tf32_trunc(a[LDP], ah[2], al[2]);
    split_tf32_trunc(a[LDP + 8], ah[3], al[3]);
    step_by_rows(acc, ah, al, B, kk * 8 + 2 * t4, g);
  }
}

// -1e30 on the pairs of rows r0, r0 + 8 and the thread's keys (key0 + 8j +
// 2t, + 1) whose regions differ
template <bool HAS_MASK, int NJ>
__device__ __forceinline__ void mask_rows(float (&s)[NJ][4], const uint8_t* reg, int r0,
                                          int key0, int t4) {
  if (!HAS_MASK) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8, key = key0 + j * 8 + 2 * t4 + (e & 1);
      s[j][e] += reg[row] == reg[key] ? 0.f : NEG_BIG;
    }
}

// max (MAX) or sum of rows r0 and r0 + 8 over the quad's keys: the thread's
// own in turn, then the quad's partials by the xor-1 and xor-2 shuffles
template <bool MAX, int NJ>
__device__ __forceinline__ void quad_reduce(float (&r)[2], const float (&x)[NJ][4]) {
  r[0] = r[1] = MAX ? -INFINITY : 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e >> 1] = MAX ? fmaxf(r[e >> 1], x[j][e]) : r[e >> 1] + x[j][e];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, r[i], m);
      r[i] = MAX ? fmaxf(r[i], o) : r[i] + o;
    }
}

// e <- exp2(s - mx)
template <int NJ>
__device__ __forceinline__ void exp_rows(float (&s)[NJ][4], const float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
}
// p <- e / l; with a mask, the division is skipped where e is 0 (a masked
// key): 0 / l is 0, and a zero dividend takes the division's slow path
template <bool HAS_MASK, int NJ>
__device__ __forceinline__ void divide_rows(float (&s)[NJ][4], const float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!HAS_MASK || s[j][e] != 0.f) s[j][e] = __fdiv_rn(s[j][e], l[e >> 1]);
}

// rows r and r + 8 of acc (head-dim cols 8dt + 2t, + 1 from dst's first),
// times scale, into a tile of device memory
template <int NDT>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[NDT][4], int H, int r,
                                           int t4, float scale) {
  const size_t row_stride = (size_t)H * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float* p = dst + (size_t)(r + hh * 8) * row_stride + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<float2*>(p + dt * 8) =
          make_float2(__fmul_rn(acc[dt][2 * hh], scale), __fmul_rn(acc[dt][2 * hh + 1], scale));
  }
}

template <bool HAS_MASK>
__global__ void __launch_bounds__(FWD_THREADS, 2)
swin_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const uint8_t* __restrict__ regions,
                    float* __restrict__ out, int ntiles, int nW, int H, float qscale) {
  constexpr int T = FWD_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + S * LD;
  float* Vs = Ks + S * LD;
  uint8_t* reg = reinterpret_cast<uint8_t*>(Vs + S * LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's query rows: r0 and r0 + 8

  // the first tile's q, k and region row, then its v: two commit groups, in
  // the order the loop refills them
  int tile = blockIdx.x;
  load_tile<T>(Qs, q, tile_base(tile, H), H, tid);
  load_tile<T>(Ks, k, tile_base(tile, H), H, tid);
  load_regions<HAS_MASK>(reg, regions, tile, H, nW, tid);
  cp_async_commit();
  load_tile<T>(Vs, v, tile_base(tile, H), H, tid);
  cp_async_commit();

  for (; tile < ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    cp_async_wait<1>();  // this tile's q, k and region row (its v may be in flight)
    scale_q<T>(Qs, qscale, tid);
    __syncthreads();

    // S = Q K^T, log2 units, masked
    float s[NT][4];
    rows_by_keys(s, Qs, Ks, r0, g, t4);
    mask_rows<HAS_MASK>(s, reg, r0, 0, t4);
    __syncthreads();  // q, k and the region row are read no more
    if (next < ntiles) {
      load_tile<T>(Qs, q, tile_base(next, H), H, tid);
      load_tile<T>(Ks, k, tile_base(next, H), H, tid);
      load_regions<HAS_MASK>(reg, regions, next, H, nW, tid);
    }
    cp_async_commit();
    // P = exp2(S - rowmax) / rowsum
    float mx[2], l[2];
    quad_reduce<true>(mx, s);
    exp_rows(s, mx);
    quad_reduce<false>(l, s);
    divide_rows<HAS_MASK>(s, l);

    // O = P V
    cp_async_wait<1>();  // this tile's v
    __syncthreads();
    float o[DT][4];
    zero(o);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      a_from_regs(ah, al, s[j]);
      step_by_rows(o, ah, al, Vs, j * 8 + 2 * t4, g);
    }
    __syncthreads();  // v is read no more
    if (next < ntiles) load_tile<T>(Vs, v, tile_base(next, H), H, tid);
    cp_async_commit();
    store_rows(out + tile_base(tile, H), o, H, r0, t4, 1.f);
  }
}

// K6^T's shared memory: q and k (and the region row) in two stages by tile
// parity, so that the next tile's load while this one runs; dO; the row
// partials that the two warps of a row group exchange; v, whose buffer (a
// little longer than v) takes P and dS once dP is formed
constexpr int V_FLOATS = 2 * S * LDP > S * LD ? 2 * S * LDP : S * LD;
struct BwdSmem {
  float q[2][S * LD], k[2][S * LD];
  float o[S * LD];  // dO
  float part[3][2][S];  // row max, row sum, rowsum(P o dP) of each key half
  uint8_t reg[2][S];
  float v[V_FLOATS];  // v, then P [64][LDP] and dS [64][LDP]
};

template <bool HAS_MASK>
__global__ void __launch_bounds__(BWD_THREADS, 1)
swin_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const uint8_t* __restrict__ regions, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv, int ntiles, int nW, int H,
                    float qscale) {
  constexpr int T = BWD_THREADS;
  constexpr int NJ = NT / 2;    // n8 tiles over a key half
  constexpr int NDT = DT / 2;   // n8 tiles over a head-dim half
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  float* Ps = sm.v;             // P [query][key], once v is read no more
  float* dSs = sm.v + S * LDP;  // dS [query][key]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // warp w takes the 16 rows r0 = 16 (w % 4) + g, + 8 (query rows in S, dP
  // and dQ; key rows in dK and dV) and half hf = w / 4 of the keys (in S
  // and dP) or of the head dim (in dQ, dK and dV)
  const int r0 = (warp & 3) * 16 + g, hf = warp >> 2;
  const int key0 = hf * (S / 2), d0 = hf * (D / 2);
  const int pair_bar = 1 + (warp & 3);  // the named barrier of the row group's two warps

  // the first tile's q, k and region row, then its dO, then its v: three
  // commit groups, in the order the loop issues them for the next tile
  const int step = gridDim.x;
  {
    const size_t base = tile_base(blockIdx.x, H);
    load_tile<T>(sm.q[0], q, base, H, tid);
    load_tile<T>(sm.k[0], k, base, H, tid);
    load_regions<HAS_MASK>(sm.reg[0], regions, blockIdx.x, H, nW, tid);
    cp_async_commit();
    load_tile<T>(sm.o, dout, base, H, tid);
    cp_async_commit();
    load_tile<T>(sm.v, v, base, H, tid);
    cp_async_commit();
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += step, ++it) {
    const int cur = it & 1, next = tile + step;
    const size_t base = tile_base(tile, H), next_base = tile_base(next, H);
    const float* Qs = sm.q[cur];
    const float* Ks = sm.k[cur];
    cp_async_wait<2>();  // this tile's q, k and region row
    scale_q<T>(sm.q[cur], qscale, tid);
    __syncthreads();  // and the last tile is done with the other stage: the next tile's go in
    if (next < ntiles) {
      load_tile<T>(sm.q[cur ^ 1], q, next_base, H, tid);
      load_tile<T>(sm.k[cur ^ 1], k, next_base, H, tid);
      load_regions<HAS_MASK>(sm.reg[cur ^ 1], regions, next, H, nW, tid);
    }
    cp_async_commit();

    // S and dP = dO V^T over this warp's key half
    float p[NJ][4];
    rows_by_keys(p, Qs, Ks + key0 * LD, r0, g, t4);
    mask_rows<HAS_MASK>(p, sm.reg[cur], r0, key0, t4);
    cp_async_wait<1>();  // this tile's dO and v
    __syncthreads();
    float ds[NJ][4];
    rows_by_keys(ds, sm.o, sm.v + key0 * LD, r0, g, t4);

    // P: the forward's softmax, recomputed as K6 computes it, each row's
    // max and sum taken over the key halves of its two warps (half 0's
    // first)
    float mx[2], l[2], delta[2];
    quad_reduce<true>(mx, p);
    if (t4 == 0) {
      sm.part[0][hf][r0] = mx[0];
      sm.part[0][hf][r0 + 8] = mx[1];
    }
    bar_sync(pair_bar, 64);
    mx[0] = fmaxf(sm.part[0][0][r0], sm.part[0][1][r0]);
    mx[1] = fmaxf(sm.part[0][0][r0 + 8], sm.part[0][1][r0 + 8]);
    exp_rows(p, mx);
    quad_reduce<false>(l, p);
    if (t4 == 0) {
      sm.part[1][hf][r0] = l[0];
      sm.part[1][hf][r0 + 8] = l[1];
    }
    bar_sync(pair_bar, 64);
    l[0] = sm.part[1][0][r0] + sm.part[1][1][r0];
    l[1] = sm.part[1][0][r0 + 8] + sm.part[1][1][r0 + 8];
    divide_rows<HAS_MASK>(p, l);

    // dS = (P o (dP - rowsum(P o dP))) * ln 2
#pragma unroll
    for (int i = 0; i < 2; ++i) delta[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[e >> 1] = fmaf(p[j][e], ds[j][e], delta[e >> 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
    if (t4 == 0) {
      sm.part[2][hf][r0] = delta[0];
      sm.part[2][hf][r0 + 8] = delta[1];
    }
    __syncthreads();  // and every warp is done with v
    delta[0] = sm.part[2][0][r0] + sm.part[2][1][r0];
    delta[1] = sm.part[2][0][r0 + 8] + sm.part[2][1][r0 + 8];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = __fmul_rn(__fmul_rn(p[j][e], __fsub_rn(ds[j][e], delta[e >> 1])), LN2);
    // P and dS of this warp's rows and key half into v's buffer
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = (r0 + hh * 8) * LDP + key0 + j * 8 + 2 * t4;
        *reinterpret_cast<float2*>(&Ps[o]) = make_float2(p[j][2 * hh], p[j][2 * hh + 1]);
        *reinterpret_cast<float2*>(&dSs[o]) = make_float2(ds[j][2 * hh], ds[j][2 * hh + 1]);
      }
    __syncthreads();

    // dV = P^T dO and dK = dS^T (q scaled) for this warp's key rows and
    // head-dim half
    float acc[NDT][4];
    keys_by_dim(acc, Ps, sm.o + d0, r0, g, t4);
    store_rows(dv + base + d0, acc, H, r0, t4, 1.f);
    __syncthreads();  // dO is read no more
    if (next < ntiles) load_tile<T>(sm.o, dout, next_base, H, tid);
    cp_async_commit();

    keys_by_dim(acc, dSs, Qs + d0, r0, g, t4);
    store_rows(dk + base + d0, acc, H, r0, t4, 1.f);

    // dQ = (dS K) * D^-0.5 * log2(e) for this warp's query rows and
    // head-dim half, dS read from its tile: the k step j takes keys 8j + 2t
    // and 8j + 2t + 1
    zero(acc);
#pragma unroll 2
    for (int j = 0; j < NT; ++j) {
      const float2 x0 = *reinterpret_cast<const float2*>(&dSs[r0 * LDP + j * 8 + 2 * t4]);
      const float2 x1 = *reinterpret_cast<const float2*>(&dSs[(r0 + 8) * LDP + j * 8 + 2 * t4]);
      const float xj[4] = {x0.x, x0.y, x1.x, x1.y};
      uint32_t ah[4], al[4];
      a_from_regs(ah, al, xj);
      step_by_rows(acc, ah, al, Ks + d0, j * 8 + 2 * t4, g);
    }
    store_rows(dq + base + d0, acc, H, r0, t4, qscale);
    __syncthreads();  // P and dS are read no more
    if (next < ntiles) load_tile<T>(sm.v, v, next_base, H, tid);
    cp_async_commit();
  }
}

// the persistent grid: the blocks of `kern` the card holds at once, at most
// one a tile; 0 where a query fails
template <typename Kernel>
int persistent_grid(Kernel kern, int threads, size_t smem, int ntiles) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem) !=
          cudaSuccess)
    return 0;
  return std::min(ntiles, sms * per_sm);
}

template <bool HAS_MASK>
cudaError_t launch_fwd(const float* q, const float* k, const float* v, const uint8_t* regions,
                       float* out, int ntiles, int nW, int H, float qscale,
                       cudaStream_t stream) {
  auto kern = swin_fwd_f32_kernel<HAS_MASK>;
  constexpr size_t smem = 3 * (size_t)S * LD * sizeof(float) + S;
  const int grid = persistent_grid(kern, FWD_THREADS, smem, ntiles);
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  kern<<<grid, FWD_THREADS, smem, stream>>>(q, k, v, regions, out, ntiles, nW, H, qscale);
  return cudaGetLastError();
}

template <bool HAS_MASK>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* dout,
                       const uint8_t* regions, float* dq, float* dk, float* dv, int ntiles,
                       int nW, int H, float qscale, cudaStream_t stream) {
  auto kern = swin_bwd_f32_kernel<HAS_MASK>;
  constexpr size_t smem = sizeof(BwdSmem);
  const int grid = persistent_grid(kern, BWD_THREADS, smem, ntiles);
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  kern<<<grid, BWD_THREADS, smem, stream>>>(q, k, v, dout, regions, dq, dk, dv, ntiles, nW,
                                             H, qscale);
  return cudaGetLastError();
}

}  // namespace

namespace rf {

int swin_fwd_f32(bool has_mask, const float* q, const float* k, const float* v,
                 const uint8_t* regions, float* out, int BW, int nW, int H, float qscale,
                 cudaStream_t stream) {
  if ((long long)BW * H > INT_MAX) return cudaErrorInvalidValue;
  if (has_mask)
    return launch_fwd<true>(q, k, v, regions, out, BW * H, nW, H, qscale, stream);
  return launch_fwd<false>(q, k, v, regions, out, BW * H, nW, H, qscale, stream);
}

int swin_bwd_f32(bool has_mask, const float* q, const float* k, const float* v,
                 const float* dout, const uint8_t* regions, float* dq, float* dk, float* dv,
                 int BW, int nW, int H, float qscale, cudaStream_t stream) {
  if ((long long)BW * H > INT_MAX) return cudaErrorInvalidValue;
  if (has_mask)
    return launch_bwd<true>(q, k, v, dout, regions, dq, dk, dv, BW * H, nW, H, qscale, stream);
  return launch_bwd<false>(q, k, v, dout, regions, dq, dk, dv, BW * H, nW, H, qscale, stream);
}

}  // namespace rf
