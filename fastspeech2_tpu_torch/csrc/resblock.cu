// K4: one HiFi-GAN MRF ResBlock dilation unit in one launch, float32 on
// the tensor cores (3xTF32), for sm_90a.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_resblock.py
// (_resblock_kernel via _pallas_forward), which fuses a whole ResBlock
// (3 dilation units) over one L tile and its halo in VMEM.  On channels-first
// [B, C, L] activations, one dilation unit d with k-tap convs is
//
//   t   = lrelu(conv_{k,d}(lrelu(x); w1) + b1)
//   out = x + conv_{k,1}(t; w2) + b2
//
// with lrelu slope 0.1 and SAME zero padding on each conv's own input:
// (k-1)/2 * d positions for the first conv, (k-1)/2 for the second.  Tap j
// of a conv dilated by d reads position l + (j - (k-1)/2) * d; positions
// outside [0, L) read 0.  The first conv's input is lrelu(x), and
// lrelu(0) = 0, so zero-filling the staged x is exact; the second conv's
// input t is set to 0 outside [0, L), never to lrelu(b1 + partial sums).
//
// What bounds it on an H100: 4 k C^2 L operations per unit (594.5 GFLOP for
// the twelve ResBlocks of a 1000-frame parity-vocoder forward), 3xTF32 on
// the tensor cores (3 x operations / 495 TFLOP/s; 3.603 ms for the twelve),
// against 8 C L bytes of activations per unit.  At C = 32 and 64 two
// launches per unit (t through device memory) move 5 activation passes,
// whose time exceeds the 3xTF32 bound of the k = 3 calls; this kernel
// keeps t on chip and moves 2.
//
// Design (conv_tiles.cuh has the implicit GEMM, the packed weights and the
// staging).  A block of 4 warps owns BN output positions of all C channels
// of one batch row:
//   1. the first conv over the BN positions plus a halo of 8 on each side
//      (enough for the second conv's (k-1)/2 <= 8), reading x's window of
//      BN + 16 + (k-1) d positions one 16-channel slice at a time
//      (cp.async, double-buffered, lrelu and the TF32 split once per
//      staged element); each warp takes half the channels and half the
//      BN + 16 columns;
//   2. t = lrelu(acc + b1), 0 outside [0, L), split once into big and small
//      planes of [C][BN + 16] in shared memory (over the staging buffers);
//   3. the second conv from those planes, each warp half the channels and
//      half the BN positions; out = x + (acc + b2), x read again from L2.
// The halo of t is computed by both neighbouring blocks with the same
// arithmetic, so the result does not depend on the tiling.  C = 32, 64 or
// 128 (MT = C / 32 m-tiles per warp); BN = 64 or 128
// (fs2_resblock_unit_tile says which).  `out` must not alias `x`: a block
// reads x's halo from its neighbours' positions.

#include <cuda_runtime.h>

#include "conv_tiles.cuh"

namespace {

using namespace fs2_conv;

constexpr int kThreads = 128;
constexpr int kTHalo = 8;   // t columns on each side of the tile

template <int MT, int BN, int K>
struct Unit {
  static constexpr int C = 32 * MT;
  static constexpr int N1 = BN + 2 * kTHalo;   // t columns per block
  static constexpr int NT1 = N1 / 16;          // per warp: half of them
  static constexpr int NT2 = BN / 16;
  static constexpr int TStride = cf_stride(N1);
  static constexpr int WfMt = K * (C / 8) * kFrag4;   // float4s per m-tile
  // taps unrolled per loop: all, but one at a time for the widest tile at
  // k = 11, which spills otherwise
  static constexpr int TapUnroll = BN == 128 && K == 11 ? 1 : K;
  static_assert(N1 % 16 == 0 && (K - 1) / 2 <= kTHalo, "tile");

  static int smem_bytes(int d) {
    const int staging = 4 * kSliceCF * cf_stride(N1 + (K - 1) * d);
    const int planes = 2 * C * TStride;
    return 4 * (staging > planes ? staging : planes);
  }
};

template <int MT, int BN, int K>
__global__ void __launch_bounds__(kThreads)
resblock_unit_kernel(const float* __restrict__ x,
                     const float4* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float4* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out,
                     int L, int d) {
  using U = Unit<MT, BN, K>;
  constexpr int C = U::C;
  constexpr int H2 = (K - 1) / 2;
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.y;
  const int l0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;    // channels [wm * MT * 16, +MT * 16)
  const int wn = warp >> 1;   // columns of its half
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* xb = x + static_cast<size_t>(b) * C * L;

  // 1. first conv over t's columns [l0 - kTHalo, l0 + BN + kTHalo)
  float acc1[MT][U::NT1][4];
  zero(acc1);
  const int span1 = U::N1 + (K - 1) * d;
  conv_cf<MT, U::NT1, K, kThreads, true, U::TapUnroll>(
      acc1, xb, C, L, l0 - kTHalo - H2 * d, span1, cf_stride(span1), d,
      w1 + wm * MT * U::WfMt, U::WfMt, wn * (U::N1 / 2), smem, tid, lane);

  // 2. t, zero outside [0, L), split into planes over the staging buffers
  uint32_t* tb = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ts = tb + C * U::TStride;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < U::NT1; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int co = 16 * (wm * MT + mt) + g + (i >= 2 ? 8 : 0);
        const int col = wn * (U::N1 / 2) + 8 * nt + 2 * t + (i & 1);
        const int pos = l0 - kTHalo + col;
        const float v = pos >= 0 && pos < L
                            ? lrelu(acc1[mt][nt][i] + __ldg(b1 + co))
                            : 0.f;
        split(v, tb[co * U::TStride + col], ts[co * U::TStride + col]);
      }
  __syncthreads();

  // 3. second conv from the planes, residual from x
  float acc2[MT][U::NT2][4];
  zero(acc2);
  const float4* w2w = w2 + wm * MT * U::WfMt;
  constexpr int tap4 = (C / 8) * kFrag4;
  constexpr int kTapUnroll = U::TapUnroll;
#pragma unroll 1
  for (int s = 0; s < C / kSliceCF; ++s) {
    const int off = s * kSliceCF * U::TStride;
#pragma unroll kTapUnroll
    for (int j = 0; j < K; ++j)
      mma_tap<MT, U::NT2, kSliceCF / 8, false>(
          acc2, tb + off, ts + off, U::TStride,
          wn * (BN / 2) + kTHalo - H2 + j,
          w2w + s * (kSliceCF / 8) * kFrag4 + j * tap4, U::WfMt, lane);
  }
  float* ob = out + static_cast<size_t>(b) * C * L;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < U::NT2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int co = 16 * (wm * MT + mt) + g + (i >= 2 ? 8 : 0);
        const int l = l0 + wn * (BN / 2) + 8 * nt + 2 * t + (i & 1);
        if (l < L) {
          const size_t at = static_cast<size_t>(co) * L + l;
          ob[at] = xb[at] + (acc2[mt][nt][i] + __ldg(b2 + co));
        }
      }
}

template <int MT, int BN, int K>
cudaError_t launch(const float* x, float* out, const float4* w1,
                   const float* b1, const float4* w2, const float* b2, int B,
                   int L, int d, cudaStream_t s) {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        resblock_unit_kernel<MT, BN, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int smem = Unit<MT, BN, K>::smem_bytes(d);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((L + BN - 1) / BN, B);
  resblock_unit_kernel<MT, BN, K><<<grid, kThreads, smem, s>>>(
      x, w1, b1, w2, b2, out, L, d);
  return cudaGetLastError();
}

template <int MT, int BN>
cudaError_t dispatch_k(const float* x, float* out, const float4* w1,
                       const float* b1, const float4* w2, const float* b2,
                       int B, int L, int k, int d, cudaStream_t s) {
  switch (k) {
    case 3: return launch<MT, BN, 3>(x, out, w1, b1, w2, b2, B, L, d, s);
    case 7: return launch<MT, BN, 7>(x, out, w1, b1, w2, b2, B, L, d, s);
    case 11: return launch<MT, BN, 11>(x, out, w1, b1, w2, b2, B, L, d, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int MT>
cudaError_t dispatch_bn(const float* x, float* out, const float4* w1,
                        const float* b1, const float4* w2, const float* b2,
                        int B, int L, int k, int d, int bn, cudaStream_t s) {
  if constexpr (MT <= 2) {   // at C = 128 the 128-wide tile spills
    if (bn == 128)
      return dispatch_k<MT, 128>(x, out, w1, b1, w2, b2, B, L, k, d, s);
  }
  if (bn == 64)
    return dispatch_k<MT, 64>(x, out, w1, b1, w2, b2, B, L, k, d, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The tile width the unit kernel takes at [B, C, L] with k taps: 64
// positions at C = 128 (the 128-wide tile spills there), at k = 3 with
// C = 64, and where 128 gives fewer than two blocks per SM; else 128
// (measured on an H100 at the parity forward's shapes: PERF.md).
extern "C" int fs2_resblock_unit_tile(int B, int C, int L, int k) {
  const long long blocks = static_cast<long long>((L + 127) / 128) * B;
  if (C >= 128 || (C == 64 && k == 3) || blocks < 2LL * sm_count())
    return 64;
  return 128;
}

// One dilation unit of an MRF ResBlock in one launch on `stream`:
// out = x + conv2(lrelu(conv1(lrelu(x)) + b1)) + b2.  x, out: [B, C, L],
// out not aliasing x; w1, w2: the unit's packed fragments
// ([C/16][k][C/8][32][8] floats, conv_tiles.cuh); b1, b2: [C].  All float32,
// contiguous, 16-byte aligned.  C in {32, 64, 128}, k in {3, 7, 11},
// 1 <= d <= 64, L >= 1; bn = 64 (or 128 at C <= 64) positions per block,
// or 0 for fs2_resblock_unit_tile's.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int fs2_resblock_unit_f32(const void* x, void* out,
                                     const void* w1, const void* b1,
                                     const void* w2, const void* b2, int B,
                                     int C, int L, int k, int d, int bn,
                                     void* stream) {
  if (B <= 0 || L <= 0 || d <= 0 || d > 64) return cudaErrorInvalidValue;
  if (bn == 0) bn = fs2_resblock_unit_tile(B, C, L, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const float4* w1f = static_cast<const float4*>(w1);
  const float4* w2f = static_cast<const float4*>(w2);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  switch (C) {
    case 32:
      return dispatch_bn<1>(xf, of, w1f, b1f, w2f, b2f, B, L, k, d, bn, s);
    case 64:
      return dispatch_bn<2>(xf, of, w1f, b1f, w2f, b2f, B, L, k, d, bn, s);
    case 128:
      return dispatch_bn<4>(xf, of, w1f, b1f, w2f, b2f, B, L, k, d, bn, s);
    default:
      return cudaErrorInvalidValue;
  }
}
