// The fp32 Swin window attention kernels (swin_attention_f32.cu), called by
// the C entry points of swin_attention.cu (K6) and swin_attention_bwd.cu
// (K6^T) for fp32 inputs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rf {

// q, k, v, out [BW, 64, H*128] fp32; regions [nW, 64] uint8, read when
// has_mask, window bw using row bw % nW.  Returns a cudaError_t.
int swin_fwd_f32(bool has_mask, const float* q, const float* k, const float* v,
                 const uint8_t* regions, float* out, int BW, int nW, int H, float qscale,
                 cudaStream_t stream);

// q, k, v, dout, dq, dk, dv [BW, 64, H*128] fp32 (q unscaled, as the
// forward got it); regions as above.  Returns a cudaError_t.
int swin_bwd_f32(bool has_mask, const float* q, const float* k, const float* v,
                 const float* dout, const uint8_t* regions, float* dq, float* dk, float* dv,
                 int BW, int nW, int H, float qscale, cudaStream_t stream);

}  // namespace rf
