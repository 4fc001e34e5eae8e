// The bf16 flash-attention forward for Hopper (flash_fwd_sm90.cu), called by
// the C entry points of flash_attention.cu for bf16 inputs.
#pragma once

#include <cuda_runtime.h>

namespace rf {

// q [B,Sq,H,128], k [B,Sk,H,128], v [B/reps,Sk,H,128] bf16; mask [B,Sk]
// uint8, read when has_mask; cos/sin [B,Sq,128] fp32 when rope, else ignored; out
// [B,Sq,H,128]; lse [B,H,Sq] fp32 or null.  Returns a cudaError_t.
int flash_fwd_sm90(bool rope, bool has_mask, const void* q, const void* k, const void* v,
                   const void* mask, const void* cosq, const void* sinq, void* out, void* lse,
                   int B, int reps, int Sq, int Sk, int H, float qscale, cudaStream_t stream);

// Rows of q one block takes at this grid on the current device: 128 (two
// consumer warpgroups, one block an SM) or 64 (one consumer warpgroup, two
// blocks an SM, where that fills the card in fewer waves).
int flash_fwd_sm90_rows(int B, int Sq, int H);

}  // namespace rf
