// What the convolution kernels share: the bfloat16 K2 (conv_ffn.cu) its
// fragment helpers (tf32_mma.cuh) and zero; the float32 K2
// (conv_ffn_f32.cu) and K4 (resblock.cu), whose products are wgmma
// (hopper.cuh), the SM count their persistent grids are sized against.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace fs2_conv {

using namespace fs2_tc;

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

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

}  // namespace fs2_conv
