// The bf16 flash-attention backward for Hopper (flash_bwd_sm90.cu), called by
// the C entry point rf_flash_bwd_kv of flash_bwd.cu for bf16 inputs.
#pragma once

#include <cuda_runtime.h>

namespace rf {

// keys one block of the kernel owns (two warpgroups of 64)
constexpr int FLASH_BWD_SM90_KEYS = 128;

// q, dout [B,Sq,H,128] bf16 (q rotated, unscaled); k (rotated) [B,Sk,H,128];
// v [B/reps,Sk,H,128]; lse, delta [B,H,Sq] fp32; mask [B,Sk] uint8 or null;
// dq_acc [B,Sq,H,128] fp32, zeroed by the caller, receives dQ by atomics
// (K8), or null for dK and dV alone (K9's dK/dV kernel); dk, dv
// [B,Sk,H,128] bf16.  Returns a cudaError_t.
int flash_bwd_sm90(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* mask, void* dq_acc, void* dk,
                   void* dv, int B, int reps, int Sq, int Sk, int H, float qscale, float dqscale,
                   float dkscale, cudaStream_t stream);

}  // namespace rf
