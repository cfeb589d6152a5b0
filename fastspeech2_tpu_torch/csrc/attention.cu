// K1: fused masked multi-head self-attention forward, float32, for sm_90a.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_attention.py
// (_mha_kernel via _pallas_forward_impl), which holds a whole (batch, head)
// slice and its L x L score matrix in VMEM.
//
// Computes, per (b, h):  softmax(where(pad_key, -1e9, Q K^T / sqrt(Dh))) V
// on [B, H, L, Dh] row-major tensors, Dh = 128.  The mask value is FINITE on
// purpose: a query row whose keys are all padded comes out as the uniform
// mean of V over all L keys (fastspeech2_tpu/ops/attention.py:8-11), so
// padded key tiles are never skipped and no -inf is ever formed.  The scale
// is applied before the mask replaces the score.
//
// What bounds it on an H100: in float32 (the port does not use TF32) the
// two products are 4 L^2 Dh operations per (b, h) on the CUDA cores
// (67 TFLOP/s), against 4 L Dh 4-byte tensors moved; at L = 1000 that is
// ~130 operations per byte, so operations bound it.
//
// Design: the L x L tile that fit VMEM does not fit a block's shared memory,
// so one block owns (b, h, 64 query rows) and loops over 64-key tiles with
// an online softmax (running row max and row sum, rescaled accumulators in
// registers).  256 threads as a 16 x 16 grid; each thread holds a 4 x 4
// score micro-tile and a 4 x 8 slice of the 64 x 128 output accumulator.
// Row statistics are reduced across the 16 threads that share rows with
// warp shuffles.  The ragged edge (L not a multiple of 64) is masked: keys
// at or past L get probability exactly 0 and are loaded as zeros.  Q and K
// rows are padded to 129 floats in shared memory so the inner product loop
// is free of bank conflicts.  A simple first kernel: no tensor cores, no
// TMA, no double buffering.
//
// For training, the kernel also writes each query row's softmax statistics
// (the final running max m and sum l, so that P = exp(s - m) / l) through
// two optional pointers; the backward kernel K3 (attention_bwd.cu) reads
// them instead of recomputing a third product.  They are kept apart, not
// folded into a log-sum-exp: for a fully padded row m = -1e9, and
// -1e9 + log(L) rounds back to -1e9 in float32.  Inference passes null.

#include <cuda_runtime.h>

namespace {

constexpr int kDh = 128;      // head dim
constexpr int kBM = 64;       // query rows per block
constexpr int kBN = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kQS = kDh + 1;  // padded row stride of Q and K in smem
constexpr int kPS = kBN + 1;  // padded row stride of P in smem
constexpr float kMaskValue = -1e9f;
constexpr float kInitMax = -1e30f;  // below any score, finite

constexpr size_t kSmemBytes =
    sizeof(float) * (kBM * kQS + kBN * kQS + kBN * kDh + kBM * kPS);

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
mha_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const unsigned char* __restrict__ key_pad,
                   float* __restrict__ out, float* __restrict__ row_max,
                   float* __restrict__ row_sum, int H, int L, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBM][kQS]
  float* Ks = Qs + kBM * kQS;    // [kBN][kQS]
  float* Vs = Ks + kBN * kQS;    // [kBN][kDh]
  float* Ps = Vs + kBN * kDh;    // [kBM][kPS]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBM;
  const size_t base = static_cast<size_t>(bh) * L * kDh;
  const float* qp = q + base;
  const float* kp = k + base;
  const float* vp = v + base;
  float* op = out + base;
  const unsigned char* pad = key_pad + static_cast<size_t>(b) * L;

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // key / output-column lane
  const int ty = tid / 16;   // owns rows ty*4 .. ty*4+3

  // Q tile; rows past L are zeros (computed on, never stored)
  for (int i = tid; i < kBM * (kDh / 4); i += kThreads) {
    const int r = i / (kDh / 4);
    const int c = (i % (kDh / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < L)
      val = *reinterpret_cast<const float4*>(qp + (size_t)(q0 + r) * kDh + c);
    float* dst = Qs + r * kQS + c;
    dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
  }

  float m_i[4], l_i[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kInitMax;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBN) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < kBN * (kDh / 4); i += kThreads) {
      const int r = i / (kDh / 4);
      const int c = (i % (kDh / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < L) {
        kv = *reinterpret_cast<const float4*>(kp + (size_t)(k0 + r) * kDh + c);
        vv = *reinterpret_cast<const float4*>(vp + (size_t)(k0 + r) * kDh + c);
      }
      float* kd = Ks + r * kQS + c;
      kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
      *reinterpret_cast<float4*>(Vs + r * kDh + c) = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kDh; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * kQS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * kQS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    bool valid[4], padded[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      valid[j] = key < L;
      padded[j] = valid[j] && pad[key] != 0;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m_i[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = padded[j] ? kMaskValue : s[i][j] * scale;
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float alpha = expf(m_i[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - mx) : 0.f;
        Ps[(ty * 4 + i) * kPS + tx + 16 * j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = mx;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float vv = Vs[c * kDh + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < L) {
      const float inv = 1.f / l_i[i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        op[(size_t)r * kDh + tx + 16 * j] = acc[i][j] * inv;
      if (row_max != nullptr && tx == 0) {
        row_max[(size_t)bh * L + r] = m_i[i];
        row_sum[(size_t)bh * L + r] = l_i[i];
      }
    }
  }
}

}  // namespace

// q, k, v, out: [B, H, L, 128] float32, contiguous.  key_pad: [B, L] bytes,
// nonzero = padded key.  row_max, row_sum: [B, H, L] float32, or both null.
// scale = 1/sqrt(D), rounded to float by the caller as the reference rounds
// it.  Launches on `stream`; returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int fs2_mha_fwd_f32(const void* q, const void* k, const void* v,
                               const void* key_pad, void* out, void* row_max,
                               void* row_sum, int B, int H, int L, int D,
                               float scale, void* stream) {
  if (D != kDh || B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  if ((row_max == nullptr) != (row_sum == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBM - 1) / kBM, B * H);
  mha_fwd_f32_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v),
      static_cast<const unsigned char*>(key_pad), static_cast<float*>(out),
      static_cast<float*>(row_max), static_cast<float*>(row_sum), H, L, scale);
  return cudaGetLastError();
}
