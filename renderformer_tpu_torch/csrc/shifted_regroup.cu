// Shifted-window regroup of a window-ordered token stream: a pure permutation
// of [B, nW, ws, ws] token rows of `row_bytes` bytes each.
//
// Replaces renderformer_tpu/ops/shifted_regroup.py:_copy_kernel (reached
// through _regroup_call).  With the shift s = ws/2, destination token (i, j)
// of window w reads source window tbl[w, 2*(i >= s) + (j >= s)] at in-window
// position ((i + s) % ws, (j + s) % ws); tbl is _window_table's [nW, 4] int32
// table (forward or inverse), read from device memory.  The TPU kernel copied
// whole quadrant blocks per grid step with scalar-prefetched indices; here
// every thread moves 16 bytes of one token row.
//
// Bound on this card: no arithmetic, every byte is read once and written
// once, so memory bandwidth bounds it (2 x 64 MiB at [8, 4096, 1024] bf16).
// Design: one thread per 16-byte vector of the output, the vector index
// fastest, so a warp reads and writes 512 contiguous bytes of token rows;
// a row's source is computed from the table once per vector, no shared
// memory.  Dtype-agnostic: rows are moved as bytes.
#include "common.cuh"

namespace {

__global__ void regroup_kernel(const uint4* __restrict__ x, const int* __restrict__ tbl,
                               uint4* __restrict__ out, int nW, int ws, int vecs,
                               long long total) {
  const int s = ws / 2;
  const int tok = ws * ws;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(idx % vecs);
    long long t = idx / vecs;
    const int j = (int)(t % ws);
    t /= ws;
    const int i = (int)(t % ws);
    t /= ws;
    const int w = (int)(t % nW);
    const long long b = t / nW;
    const int q = 2 * (i >= s) + (j >= s);
    const int src_w = tbl[w * 4 + q];
    const int si = i < s ? i + s : i - s;
    const int sj = j < s ? j + s : j - s;
    const long long src_row = (b * nW + src_w) * tok + si * ws + sj;
    out[idx] = x[src_row * vecs + v];
  }
}

}  // namespace

// x, out [B, nW*ws*ws, row_bytes / itemsize]; tbl [nW, 4] int32 on the device.
extern "C" int rf_shifted_regroup(const void* x, const void* tbl, void* out, int B, int nW,
                                  int ws, int row_bytes, void* stream) {
  if (B <= 0 || nW <= 0 || ws < 2 || ws % 2 || row_bytes <= 0 || row_bytes % 16)
    return cudaErrorInvalidValue;
  const int vecs = row_bytes / 16;
  const long long total = (long long)B * nW * ws * ws * vecs;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  regroup_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(tbl), static_cast<uint4*>(out),
      nW, ws, vecs, total);
  return cudaGetLastError();
}
