// K9's bf16 dQ kernel for Hopper (flash_bwd_dq_sm90.cu), called by the C
// entry point rf_flash_bwd_dq of flash_bwd.cu for bf16 inputs.
#pragma once

#include <cuda_runtime.h>

namespace rf {

// q, dout [B,Sq,H,128] bf16 (q rotated, unscaled); k (rotated) [B,Sk,H,128];
// v [B/reps,Sk,H,128]; lse, delta [B,H,Sq] fp32; mask [B,Sk] uint8 or null;
// dq [B,Sq,H,128] bf16, written once.  Returns a cudaError_t.
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* mask, void* dq, int B,
                      int reps, int Sq, int Sk, int H, float qscale, float dqscale,
                      cudaStream_t stream);

// Rows of q one block takes at this grid on the current device: 128 (two
// warpgroups, one block an SM) or 64 (one warpgroup, two blocks an SM), as
// the bf16 flash forward's plan (flash_fwd_sm90_rows) picks them.
int flash_bwd_dq_sm90_rows(int B, int Sq, int H);

}  // namespace rf
