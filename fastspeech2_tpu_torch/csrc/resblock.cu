// K4: one HiFi-GAN MRF ResBlock dilation unit, float32, for sm_90a.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_resblock.py
// (_resblock_kernel via _pallas_forward), which fuses a whole ResBlock
// (3 dilation units) over one L tile and its halo in VMEM.  On channels-first
// [B, C, L] activations, one dilation unit d with k-tap convs is
//
//   t   = lrelu(conv_{k,d}(lrelu(x); w1) + b1)      (launch a)
//   out = x + conv_{k,1}(t; w2) + b2                 (launch b)
//
// with lrelu slope 0.1 and SAME zero padding on each conv's own input:
// (k-1)/2 * d positions for the first conv, (k-1)/2 for the second.  Tap j
// of a conv dilated by d reads position l + (j - (k-1)/2) * d; positions
// outside [0, L) read 0.  Zero-filling the staged input is exactly right at
// both sequence edges: the first conv's input is lrelu(x), and lrelu(0) = 0;
// the second conv's input is t, which (b) reads only inside [0, L) and
// otherwise takes as 0, never as lrelu(b1 + partial sums).
//
// What bounds it on an H100: 4 k C^2 L operations per launch (a whole
// ResBlock is 12 k C^2 L: 594.5 GFLOP for the twelve calls of a 1000-frame
// parity-vocoder forward) on the CUDA cores in float32 (67 TFLOP/s; the port
// keeps TF32 off), against 8 C L bytes of activations and 4 k C^2 of
// weights, so operations bound it at every shape of the path.
//
// Design.  The TPU kernel's whole-chain fusion does not fit an SM: one conv's
// weights at C = 256, k = 11 are 2.9 MB (the L2 holds all of a ResBlock's 17
// MB), and its tap packing (G = 128 / C shifted copies along the
// contraction) answers the MXU's 128-row contraction, which an SM does not
// have.  So a unit is two launches and t round-trips through device memory.
// Each launch is a SIMT GEMM of [C_out] x [C_in * k] by [C_in * k] x [L]:
//   - a block owns BM output channels (64, or 32 at C = 32) by BN positions
//     (256, or 512 at C = 32); each of its 256 threads keeps 8 x 8 sums in
//     registers, its positions strided by the block's thread columns so a
//     warp reads consecutive shared-memory words;
//   - it walks the input channels 8 at a time: the 8 input rows of the tile
//     and its halo of (k-1) * d positions are staged in shared memory (lrelu
//     applied on load for launch a), and the weights of those 8 channels,
//     all k taps and the block's BM output channels, from a copy packed once
//     after load as [C_in, k, C_out] so the staging reads are contiguous;
//   - the epilogue adds the bias and stores lrelu (a) or adds the residual
//     (b), guarding the tail positions past L.
// The unit's output may alias its residual input: each element is read and
// then written by the same thread.  A simple first kernel: no tensor cores,
// no TMA, no double buffering.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;   // input channels per shared-memory stage
constexpr int kTM = 8;   // output channels per thread
constexpr int kTN = 8;   // positions per thread
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : kSlope * v;
}

template <int BM>
struct Tile {
  static constexpr int kNY = BM / kTM;          // thread rows
  static constexpr int kNX = kThreads / kNY;    // thread columns
  static constexpr int kBN = kNX * kTN;         // positions per block
};

inline int smem_bytes(int bm, int k, int d) {
  const int bn = kThreads / (bm / kTM) * kTN;
  return (kBK * k * bm + kBK * (bn + (k - 1) * d)) * 4;
}

// kFirst: in = x (lrelu on load), out = lrelu(conv + bias), dilation d.
// !kFirst: in = t, out = res + conv + bias, dilation 1 (d passed as 1).
// w: packed [C_in, K, C_out]; bias: [C_out].
template <int BM, int K, bool kFirst>
__global__ void __launch_bounds__(kThreads)
resblock_conv_kernel(const float* in, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* res,
                     float* out, int C, int L, int d) {
  using T = Tile<BM>;
  extern __shared__ __align__(16) float smem[];
  const int span = T::kBN + (K - 1) * d;
  float* ws = smem;                    // [kBK][K][BM]
  float* xs = smem + kBK * K * BM;     // [kBK][span]

  const int b = blockIdx.z;
  const int co0 = blockIdx.y * BM;
  const int l0 = blockIdx.x * T::kBN;
  const int tid = threadIdx.x;
  const int tx = tid % T::kNX;
  const int ty = tid / T::kNX;
  const int pad = (K - 1) / 2 * d;
  const float* inb = in + static_cast<size_t>(b) * C * L;

  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int i = 0; i < kTN; ++i) acc[m][i] = 0.f;

  for (int ci0 = 0; ci0 < C; ci0 += kBK) {
    // weights of channels ci0 .. ci0 + kBK: kBK * K rows of BM floats
    constexpr int kRow4 = BM / 4;
    for (int idx = tid; idx < kBK * K * kRow4; idx += kThreads) {
      const int row = idx / kRow4;
      const int col = (idx % kRow4) * 4;
      *reinterpret_cast<float4*>(&ws[row * BM + col]) =
          *reinterpret_cast<const float4*>(
              w + (static_cast<size_t>(ci0) * K + row) * C + co0 + col);
    }
    // input rows and their halo, zero outside [0, L)
    for (int r = 0; r < kBK; ++r) {
      const float* src = inb + static_cast<size_t>(ci0 + r) * L;
      for (int s = tid; s < span; s += kThreads) {
        const int pos = l0 - pad + s;
        float v = 0.f;
        if (pos >= 0 && pos < L) {
          v = src[pos];
          if (kFirst) v = lrelu(v);
        }
        xs[r * span + s] = v;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kBK; ++c) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float* wr = ws + (c * K + j) * BM + ty * kTM;
        const float4 wa = *reinterpret_cast<const float4*>(wr);
        const float4 wb = *reinterpret_cast<const float4*>(wr + 4);
        const float wv[kTM] = {wa.x, wa.y, wa.z, wa.w,
                               wb.x, wb.y, wb.z, wb.w};
        const float* xr = xs + c * span + j * d + tx;
        float xv[kTN];
#pragma unroll
        for (int i = 0; i < kTN; ++i) xv[i] = xr[i * T::kNX];
#pragma unroll
        for (int m = 0; m < kTM; ++m)
#pragma unroll
          for (int i = 0; i < kTN; ++i)
            acc[m][i] = fmaf(wv[m], xv[i], acc[m][i]);
      }
    }
    __syncthreads();
  }

  const size_t base = static_cast<size_t>(b) * C * L;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int co = co0 + ty * kTM + m;
    const float bv = bias[co];
    const size_t row = base + static_cast<size_t>(co) * L;
#pragma unroll
    for (int i = 0; i < kTN; ++i) {
      const int l = l0 + tx + i * T::kNX;
      if (l < L) {
        const float v = acc[m][i] + bv;
        if (kFirst)
          out[row + l] = lrelu(v);
        else
          out[row + l] = res[row + l] + v;
      }
    }
  }
}

template <int BM, int K>
cudaError_t launch_unit(const float* x, float* t, float* out, const float* w1,
                        const float* b1, const float* w2, const float* b2,
                        int B, int C, int L, int d, cudaStream_t s) {
  const dim3 grid((L + Tile<BM>::kBN - 1) / Tile<BM>::kBN, C / BM, B);
  resblock_conv_kernel<BM, K, true>
      <<<grid, kThreads, smem_bytes(BM, K, d), s>>>(x, w1, b1, nullptr, t, C,
                                                    L, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  resblock_conv_kernel<BM, K, false>
      <<<grid, kThreads, smem_bytes(BM, K, 1), s>>>(t, w2, b2, x, out, C, L,
                                                    1);
  return cudaGetLastError();
}

template <int BM>
cudaError_t dispatch_k(const float* x, float* t, float* out, const float* w1,
                       const float* b1, const float* w2, const float* b2,
                       int B, int C, int L, int k, int d, cudaStream_t s) {
  switch (k) {
    case 3:
      return launch_unit<BM, 3>(x, t, out, w1, b1, w2, b2, B, C, L, d, s);
    case 7:
      return launch_unit<BM, 7>(x, t, out, w1, b1, w2, b2, B, C, L, d, s);
    case 11:
      return launch_unit<BM, 11>(x, t, out, w1, b1, w2, b2, B, C, L, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One dilation unit of an MRF ResBlock: out = x + conv2(lrelu(conv1(lrelu(x))
// + b1)) + b2, two launches on `stream`.  x, out: [B, C, L]; t: [B, C, L]
// scratch; w1, w2: packed [C, k, C] ([C_in, k, C_out]); b1, b2: [C].  All
// float32, contiguous, 16-byte aligned.  `out` may be `x`.  Takes C a
// multiple of 32, k in {3, 7, 11}, d >= 1, any L >= 1 (the largest shared
// memory use, C = 64 with k = 11 and d = 5, is 32.3 KB, under the 48 KB a
// block gets without opting in).  Returns cudaGetLastError() after each
// launch, or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int fs2_resblock_unit_f32(const void* x, void* t, void* out,
                                     const void* w1, const void* b1,
                                     const void* w2, const void* b2, int B,
                                     int C, int L, int k, int d,
                                     void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % 32 != 0 || d <= 0 || d > 64 ||
      smem_bytes(C % 64 == 0 ? 64 : 32, k, d) > 48 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* tf = static_cast<float*>(t);
  float* of = static_cast<float*>(out);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  if (C % 64 == 0)
    return dispatch_k<64>(xf, tf, of, w1f, b1f, w2f, b2f, B, C, L, k, d, s);
  return dispatch_k<32>(xf, tf, of, w1f, b1f, w2f, b2f, B, C, L, k, d, s);
}
