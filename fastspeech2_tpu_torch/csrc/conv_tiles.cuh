// What the convolution kernels share: the SM count the persistent grids of
// K2 (conv_ffn_f32.cu, conv_ffn.cu) and K4 (resblock.cu) are sized against,
// and the split and rounding of tf32_mma.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace fs2_conv {

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

}  // namespace fs2_conv
