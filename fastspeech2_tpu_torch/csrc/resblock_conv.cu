// K4, the two-launch route: one conv of an MRF ResBlock dilation unit,
// float32 on the tensor cores (3xTF32), for sm_90a.  resblock.cu has the
// unit's definition, its TPU original and its bound; this file computes it
// as two launches, t through device memory,
//
//   first:  t   = lrelu(conv_{k,d}(lrelu(x); w1) + b1)
//   second: out = res + conv_{k,1}(t; w2) + b2
//
// for channel counts whose t does not fit one block's shared memory next
// to a useful tile (C = 256 at k = 11 would need 344 KB for 128 positions):
// C = 256 on the parity and iSTFT paths (PERF.md has the measurement of
// both routes at every path shape).
//
// Design (conv_tiles.cuh): a block of 4 warps owns 64 output channels by
// 64 positions of one batch row, each warp 32 channels by 32 positions
// (wider tiles measured slower on an H100 at every path shape: PERF.md).
// It walks the input channels 16 at a time: cp.async stages the next
// slice's window of 64 + (k-1) d positions while the current one is split
// (lrelu first for the first conv) and multiplied.  The epilogue adds the
// bias and stores lrelu (first) or adds the residual (second), guarding
// positions past L.  The second conv's output may alias its residual: each
// element is read and then written by the same thread.  C a multiple of
// 64.

#include <cuda_runtime.h>

#include "conv_tiles.cuh"

namespace {

using namespace fs2_conv;

constexpr int kBM = 64;      // output channels per block
constexpr int kBN = 64;      // positions per block
constexpr int kMT = 2;       // m-tiles per warp: 32 channels
constexpr int kThreads = 128;

// 2 x 2 warps, each 32 channels by 32 positions
template <int K, bool kFirst>
__global__ void __launch_bounds__(kThreads)
resblock_conv_kernel(const float* in, const float4* __restrict__ w,
                     const float* __restrict__ bias, const float* res,
                     float* out, int C, int L, int d) {
  constexpr int MT = kMT;
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kBM;
  const int l0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wf_mt = K * (C / 8) * kFrag4;
  const size_t base = static_cast<size_t>(b) * C * L;

  float acc[MT][4][4];
  zero(acc);
  const int span = kBN + (K - 1) * d;
  conv_cf<MT, 4, K, kThreads, kFirst>(
      acc, in + base, C, L, l0 - (K - 1) / 2 * d, span, cf_stride(span), d,
      w + (co0 / 16 + wm * MT) * wf_mt, wf_mt, wn * 32, smem, tid, lane);

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int co = co0 + 16 * (wm * MT + mt) + g + (i >= 2 ? 8 : 0);
        const int l = l0 + wn * 32 + 8 * nt + 2 * t + (i & 1);
        if (l < L) {
          const size_t at = base + static_cast<size_t>(co) * L + l;
          const float v = acc[mt][nt][i] + __ldg(bias + co);
          out[at] = kFirst ? lrelu(v) : res[at] + v;
        }
      }
}

int smem_bytes(int k, int d) {
  return 4 * 4 * kSliceCF * cf_stride(kBN + (k - 1) * d);
}

template <int K, bool kFirst>
cudaError_t launch(const float* in, const float4* w, const float* bias,
                   const float* res, float* out, int B, int C, int L, int d,
                   cudaStream_t s) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        resblock_conv_kernel<K, kFirst>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int smem = smem_bytes(K, d);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((L + kBN - 1) / kBN, C / kBM, B);
  resblock_conv_kernel<K, kFirst><<<grid, kThreads, smem, s>>>(
      in, w, bias, res, out, C, L, d);
  return cudaGetLastError();
}

template <bool kFirst>
cudaError_t dispatch_k(const float* in, const float4* w, const float* bias,
                       const float* res, float* out, int B, int C, int L,
                       int k, int d, cudaStream_t s) {
  switch (k) {
    case 3: return launch<3, kFirst>(in, w, bias, res, out, B, C, L, d, s);
    case 7: return launch<7, kFirst>(in, w, bias, res, out, B, C, L, d, s);
    case 11: return launch<11, kFirst>(in, w, bias, res, out, B, C, L, d, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One conv of a dilation unit on `stream`.  first != 0: out = lrelu(conv
// dilated by d of lrelu(in) + bias) (res unused); first == 0: out = res +
// conv(in) + bias, dilation d (1 in a ResBlock), out may be res.  in, res,
// out: [B, C, L]; w: the conv's packed fragments ([C/16][k][C/8][32][8]
// floats, conv_tiles.cuh); bias: [C].  All float32, contiguous, 16-byte
// aligned.  C a multiple of 64, k in {3, 7, 11}, 1 <= d <= 64, L >= 1.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int fs2_resblock_conv_f32(const void* in, const void* w,
                                     const void* bias, const void* res,
                                     void* out, int B, int C, int L, int k,
                                     int d, int first, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % kBM != 0 || d <= 0 || d > 64)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* inf = static_cast<const float*>(in);
  const float4* wf = static_cast<const float4*>(w);
  const float* bf = static_cast<const float*>(bias);
  const float* rf = static_cast<const float*>(res);
  float* of = static_cast<float*>(out);
  if (first) return dispatch_k<true>(inf, wf, bf, rf, of, B, C, L, k, d, s);
  return dispatch_k<false>(inf, wf, bf, rf, of, B, C, L, k, d, s);
}
