// The float32 split for 3xTF32 and the bfloat16 rounding the port's kernels
// share: K1 and K3 (attention_f32.cuh, attention_common.cuh), K2
// (conv_ffn_f32.cu, conv_ffn.cu) and K4 (resblock.cu), all of whose
// products are wgmma (hopper.cuh).
//
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): each float32 operand x is split
// into big = tf32(x) and small = tf32(x - big), both rounded as
// cvt.rna.tf32.f32 rounds (to nearest, ties away from zero, 10 mantissa
// bits), and a product is accumulated in float32 as big*small + small*big
// + big*big, small terms first.  The dropped small*small term is ~2^-22 of
// the product, so the split alone keeps float32 accuracy, at three TF32
// products' cost (the tensor cores' 495 TFLOP/s TF32 peak, i.e. 165 TFLOP/s
// of float32-accurate work, against 67 TFLOP/s on the CUDA cores).  The
// rounding is done on the bit pattern (add half a TF32 unit, clear the 13
// low bits): for every finite float it is cvt.rna's result, in two integer
// instructions where sm_90a's SASS spends about five on the cvt and its
// NaN and infinity cases.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fs2_tc {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite float
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// (lo, hi) rounded to bfloat16 to nearest even (as JAX's astype rounds),
// lo in the low half: two values of a bfloat16 pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace fs2_tc
