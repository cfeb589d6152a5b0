// Shared by the attention kernels, K1 (attention.cu, attention_bf16.cu) and
// K3 (attention_bwd.cu, attention_bwd_bf16.cu), all on wgmma and TMA: the
// head dim, the mask value, the masked score, the quad reductions over the
// four lanes that share an accumulator row, the stores and the shared
// memory opt-in.  The TF32 split and the bfloat16 rounding come from
// tf32_mma.cuh, which K2 and K4 use too; the float32 instances' tiles and
// score contract are in attention_f32.cuh, the bfloat16 ones' in
// attention_bf16.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace fs2_attn {

using fs2_tc::pack_bf16;
using fs2_tc::split;
using fs2_tc::tf32_rna;

using bf16 = __nv_bfloat16;

constexpr int kDh = 128;           // head dim
constexpr float kMaskValue = -1e9f;
constexpr float kInitMax = -1e30f;  // below any score, finite

// The scaled, masked score: the scale before the mask, and a multiply the
// compiler may not fuse into a later subtraction (K1 and K3 must agree)
__device__ __forceinline__ float masked_score(float s, bool padded,
                                              float scale) {
  return padded ? kMaskValue : __fmul_rn(s, scale);
}

// two (store2) or four (store4) consecutive outputs as float, or as
// bfloat16 rounded to nearest even
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 w;
  w.x = pack_bf16(v.x, v.y);
  w.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = w;
}

// ---- reductions over the 4 lanes that share a row of a C fragment --------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a kernel's dynamic shared memory opt-in, with the carveout that leaves
// the most of it to shared memory
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace fs2_attn
