// Device helpers shared by the attention kernels of this directory
// (block_causal_attention.cu, packed_flash_attention.cu and their bf16
// core, flash_sm90.cuh): the softmax's initial running max, -inf, bf16
// packing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdvt_attn {

constexpr float kNegInit = -1e30f;   // running max before any visible key

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace mdvt_attn
