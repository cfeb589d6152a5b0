// Float32 products on Hopper's tensor cores within ~1e-5 of float32
// (3xTF32), the bfloat16 product of the kernels' bfloat16 instances, and
// asynchronous copies into shared memory: the generic pieces that K1 and
// K3 (attention_common.cuh), K2 (conv_ffn.cu, conv_ffn_f32.cu) and K4
// (resblock.cu) share.  The kernels on wgmma take only the split and the
// rounding from here.
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
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32 for lane
// (g, t) = (lane / 4, lane % 4):
//   A (16 x 8):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8):   b0 (k=t, n=g)  b1 (k=t+4, n=g)
//   C (16 x 8):  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (the
// bfloat16 instances; a product of two bfloat16 values is exact in float32,
// so one product per k-step, accumulated in float32), each register two
// bfloat16 values, the lower column (or k) in the low half:
//   A (16 x 16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..2t+1)  a2 (g, 2t+8..2t+9)
//                a3 (g+8, 2t+8..2t+9)
//   B (16 x 8):  b0 (k=2t..2t+1, n=g)  b1 (k=2t+8..2t+9, n=g)
//   C (16 x 8):  as for TF32

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

// d += a b, one m16n8k8 TF32 product accumulated in float32
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, one m16n8k16 bfloat16 product accumulated in float32
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (lo, hi) rounded to bfloat16 to nearest even (as JAX's astype rounds),
// lo in the low half: one register of an A or B fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a bfloat16 value as the float32 (and TF32) bit pattern it is exactly
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 h) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&h)) << 16;
}

// ---- asynchronous copies ---------------------------------------------------

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fs2_tc
