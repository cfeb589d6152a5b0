// Shared by K2 (conv_ffn.cu) and K4 (resblock.cu, resblock_conv.cu): a 1-D
// convolution as an implicit GEMM on the tensor cores, 3xTF32
// (tf32_mma.cuh).
//
// A conv with T taps of dilation d over C_in input channels is the product
// of M = C_out by K = C_in * T with K by N = positions: tap j of output
// position n reads input position n + j * d - pad.  The A operand is the
// weights, the B operand the input:
//
// - Weights are split into TF32 big and small planes once, when they are
//   packed (pack_fragments in ops/cuda_resblock.py and ops/cuda_ffn.py),
//   in the order the A fragments are read: [M/16][T][C_in/8][32 lanes][8],
//   the 8 words of a lane being a0..a3 big, then a0..a3 small.  A warp
//   reads one fragment pair as two 16-byte loads per lane, 1 KB contiguous
//   per warp; the kernels split nothing on the weight side.  The weights
//   are not staged in shared memory: the warps of a block read the same
//   fragments, and the L1 cache serves all but the first.
// - The input is staged in shared memory one slice of input channels at a
//   time, with its halo of (T - 1) * d positions, and split into big and
//   small planes once per staged element; every tap reuses the split
//   element with a shifted read.  Positions outside [0, L) are staged as
//   zeros (cp.async's zero fill), which is each conv's SAME padding.
//
// Accumulation order, the same in every kernel and in the CPU model
// (tests/test_torch_conv_tiles.py): slices of input channels in order;
// within a slice, taps in order; within a tap, the slice's k-steps of 8
// channels in order; each k-step adds a_big b_small, a_small b_big and
// a_big b_big.  K2 sums each slice's products from 0 on the tensor cores
// and adds them to its running sum on the CUDA cores (conv_ffn.cu says
// why); K4 accumulates on the tensor cores throughout.  No atomics: two
// launches on the same inputs agree bit for bit.
//
// Staged planes come in two layouts.  Channels-first (K4, [C][L]
// activations): element (c, col) at c * stride + col, stride = 8 mod 32
// floats, so that a B fragment load (lane (g, t) reads c = t, col = g) hits
// 32 banks.  Channels-last (K2, [L][C] activations): element (c, row) at
// row * stride + c, stride = 4 mod 32 (20 for 16 channels, 68 for 64).

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

// the smallest stride >= n that is 8 mod 32 (channels-first planes)
__host__ __device__ constexpr int cf_stride(int n) {
  return n + ((8 - n) % 32 + 32) % 32;
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
// where B(k = c, n) is the staged element (8 ks + c, col0 + 8 nt + n) of
// planes pb (big) and ps (small), and A(mt, ks) the packed fragment at
// wf + mt * wf_mt + ks * kFrag4.
template <int MT, int NT, int KS, bool kChannelsLast>
__device__ __forceinline__ void mma_tap(float (&acc)[MT][NT][4],
                                        const uint32_t* pb,
                                        const uint32_t* ps, int stride,
                                        int col0, const float4* wf,
                                        int wf_mt, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = col0 + 8 * nt + g;
      const int c = 8 * ks + t;
      const int i0 = kChannelsLast ? col * stride + c : c * stride + col;
      const int i1 = kChannelsLast ? i0 + 4 : i0 + 4 * stride;
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

// ---- channels-first staging (K4) -------------------------------------------

constexpr int kSliceCF = 16;   // input channels per staged slice
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : kSlope * v;
}

// raw[c][col] <- in[c][win0 + col] for c < kSliceCF, col < span; zero
// outside [0, L).  in: the slice's first channel row, rows L floats apart.
template <int THREADS>
__device__ __forceinline__ void stage_cf(float* raw, int stride,
                                         const float* in, int L, int win0,
                                         int span, int tid) {
#pragma unroll 1
  for (int c = 0; c < kSliceCF; ++c) {
    const float* row = in + static_cast<size_t>(c) * L;
    for (int col = tid; col < span; col += THREADS) {
      const int pos = win0 + col;
      const bool ok = pos >= 0 && pos < L;
      cp_async4(raw + c * stride + col, ok ? row + pos : row, ok);
    }
  }
}

// planes <- split(lrelu?(raw)), once per staged element
template <int THREADS, bool kLrelu>
__device__ __forceinline__ void split_cf(const float* raw, uint32_t* pb,
                                         uint32_t* ps, int stride, int span,
                                         int tid) {
#pragma unroll 1
  for (int c = 0; c < kSliceCF; ++c) {
    for (int col = tid; col < span; col += THREADS) {
      float v = raw[c * stride + col];
      if (kLrelu) v = lrelu(v);
      split(v, pb[c * stride + col], ps[c * stride + col]);
    }
  }
}

// A whole conv of K taps, dilation d, over C input channels of a
// channels-first input, for one warp's MT x NT tile:
//   acc[mt][nt] += sum over c, j of W(mt, c, j) in(c, win0 + col0 + 8 nt
//                                                  + n + j d)
// The block stages the window [win0, win0 + span) of every channel slice,
// double-buffered: slice s + 1 is copied by cp.async while slice s is
// split and multiplied.  smem: raw [2][kSliceCF][stride] floats, then the
// planes pb, ps [kSliceCF][stride] each.  wf points at the warp's first
// m-tile, tap 0, k-step 0 of the packed weights; the m-tiles are wf_mt
// float4s apart.  The taps are unrolled by TAP_UNROLL (all of them by
// default; fewer where registers run out).  Ends with a __syncthreads, so
// the caller may reuse the shared memory.
template <int MT, int NT, int K, int THREADS, bool kLrelu,
          int TAP_UNROLL = K>
__device__ __forceinline__ void conv_cf(float (&acc)[MT][NT][4],
                                        const float* in, int C, int L,
                                        int win0, int span, int stride,
                                        int d, const float4* wf, int wf_mt,
                                        int col0, float* smem, int tid,
                                        int lane) {
  float* raw = smem;
  uint32_t* pb = reinterpret_cast<uint32_t*>(smem + 2 * kSliceCF * stride);
  uint32_t* ps = pb + kSliceCF * stride;
  const int slices = C / kSliceCF;
  const int tap4 = (C / 8) * kFrag4;   // float4s between taps
  stage_cf<THREADS>(raw, stride, in, L, win0, span, tid);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<0>();
    __syncthreads();   // slice s landed; slice s - 1's products are done
    if (s + 1 < slices)
      stage_cf<THREADS>(raw + ((s + 1) & 1) * kSliceCF * stride, stride,
                        in + static_cast<size_t>(s + 1) * kSliceCF * L, L,
                        win0, span, tid);
    cp_async_commit();
    split_cf<THREADS, kLrelu>(raw + (s & 1) * kSliceCF * stride, pb, ps,
                              stride, span, tid);
    __syncthreads();
    const float4* ws = wf + s * (kSliceCF / 8) * kFrag4;
#pragma unroll TAP_UNROLL
    for (int j = 0; j < K; ++j)
      mma_tap<MT, NT, kSliceCF / 8, false>(acc, pb, ps, stride, col0 + j * d,
                                           ws + j * tap4, wf_mt, lane);
  }
  __syncthreads();
}

}  // namespace fs2_conv
