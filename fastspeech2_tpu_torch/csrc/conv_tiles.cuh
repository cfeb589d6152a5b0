// K2's convolutions (conv_ffn.cu): a 1-D convolution as an implicit GEMM
// on the tensor cores, 3xTF32 (tf32_mma.cuh) on mma.sync.  K4 (resblock.cu)
// takes only sm_count from here: its product is wgmma (hopper.cuh).
//
// A conv with T taps of dilation d over C_in input channels is the product
// of M = C_out by K = C_in * T with K by N = positions: tap j of output
// position n reads input position n + j * d - pad.  The A operand is the
// weights, the B operand the input:
//
// - Weights are split into TF32 big and small planes once, when they are
//   packed (pack_fragments in ops/cuda_ffn.py), in the order the A
//   fragments are read: [M/16][T][C_in/8][32 lanes][8], the 8 words of a
//   lane being a0..a3 big, then a0..a3 small.  A warp reads one fragment
//   pair as two 16-byte loads per lane, 1 KB contiguous per warp; the
//   kernels split nothing on the weight side.  The weights are not staged
//   in shared memory: the warps of a block read the same fragments, and the
//   L1 cache serves all but the first.
// - The input is staged in shared memory one slice of input channels at a
//   time, with its halo of (T - 1) * d positions, and split into big and
//   small planes once per staged element; every tap reuses the split
//   element with a shifted read.  Positions outside [0, L) are staged as
//   zeros, which is each conv's SAME padding.
//
// Accumulation order (the CPU model: tests/test_torch_conv_tiles.py):
// slices of input channels in order; within a slice, taps in order; within
// a tap, the slice's k-steps of 8 channels in order; each k-step adds
// a_big b_small, a_small b_big and a_big b_big.  K2 sums each slice's
// products from 0 on the tensor cores and adds them to its running sum on
// the CUDA cores (conv_ffn.cu says why).  No atomics: two launches on the
// same inputs agree bit for bit.
//
// Staged planes are channels-last ([L][C] activations): element (c, row)
// at row * stride + c, stride = 4 mod 32 (20 for 16 channels, 68 for 64),
// so that a B fragment load (lane (g, t) reads c = t, row = g) hits 32
// banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace fs2_conv {

using namespace fs2_tc;

// float4s per packed fragment pair of one warp (32 lanes x 8 words)
constexpr int kFrag4 = 64;

// the current device's SM count, read once (grids are sized against it)
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// A fragment pair of one 16 x 8 block of the packed weights
__device__ __forceinline__ void load_a(const float4* p, int lane,
                                       uint32_t big[4], uint32_t small[4]) {
  const float4 b = __ldg(p + 2 * lane);
  const float4 s = __ldg(p + 2 * lane + 1);
  big[0] = __float_as_uint(b.x);
  big[1] = __float_as_uint(b.y);
  big[2] = __float_as_uint(b.z);
  big[3] = __float_as_uint(b.w);
  small[0] = __float_as_uint(s.x);
  small[1] = __float_as_uint(s.y);
  small[2] = __float_as_uint(s.z);
  small[3] = __float_as_uint(s.w);
}

// One tap over KS k-steps of a staged slice:
//   acc[mt][nt] += sum over ks of A(mt, ks) B(ks, nt)
// where B(k = c, n) is the staged element (8 ks + c, row0 + 8 nt + n) of
// the channels-last planes pb (big) and ps (small), and A(mt, ks) the
// packed fragment at wf + mt * wf_mt + ks * kFrag4.
template <int MT, int NT, int KS>
__device__ __forceinline__ void mma_tap(float (&acc)[MT][NT][4],
                                        const uint32_t* pb,
                                        const uint32_t* ps, int stride,
                                        int row0, const float4* wf,
                                        int wf_mt, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int i0 = (row0 + 8 * nt + g) * stride + 8 * ks + t;
      const int i1 = i0 + 4;
      bb[nt][0] = pb[i0];
      bb[nt][1] = pb[i1];
      bs[nt][0] = ps[i0];
      bs[nt][1] = ps[i1];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t ab[4], as[4];
      load_a(wf + mt * wf_mt + ks * kFrag4, lane, ab, as);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ab, bs[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], as, bb[nt]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ab, bb[nt]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// acc += part, in float32 on the CUDA cores
template <int MT, int NT>
__device__ __forceinline__ void add(float (&acc)[MT][NT][4],
                                    const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

}  // namespace fs2_conv
