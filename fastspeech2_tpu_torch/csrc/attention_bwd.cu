// K3: fused masked multi-head self-attention backward, float32, for sm_90a.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_attention.py
// (_mha_bwd_kernel via _pallas_backward_impl), which recomputes the whole
// L x L probability matrix of one (batch, head) in VMEM and forms
//   dV = P^T G,  dP = G V^T,  dS = P o (dP - rowsum(dP o P)) * scale,
//   dQ = dS K,   dK = dS^T Q
// on [B, H, L, Dh] row-major tensors, Dh = 128, with P recomputed as
// softmax(where(pad_key, -1e9, Q K^T * scale)).
//
// The L x L matrices (4 MB each at L = 1000) do not fit a block's shared
// memory, so the work is split the way flash-attention backwards split it,
// with no atomics:
//   K3a  D = rowsum(G o O), one warp per query row.  In real arithmetic
//        rowsum(dP o P) = rowsum(G o (P V)) = rowsum(G o O); the two differ
//        only by rounding.
//   K3b  one block per (b, h, 64 keys): loops over 64-row query tiles,
//        recomputes the P and dP tiles, and accumulates dV and dK for its
//        keys in registers.
//   K3c  one block per (b, h, 64 query rows): loops over 64-key tiles,
//        recomputes P, dP and dS, and accumulates dQ in registers.
// P is recomputed from the row statistics K1 wrote (row max m and row sum
// l, P = exp(s - m) / l), with s formed in the same order as K1 forms it.
// The mask value is the FINITE -1e9 of the reference: a query row whose
// keys are all padded has the uniform P = 1/L, and its gradient flows as
// in the reference; padded tiles are never skipped.  Keys and query rows at
// or past L (the ragged edge) get P = dS = 0 and are loaded as zeros.
//
// What bounds it on an H100: five L x L x Dh products per (b, h) in the
// reference's count (10 L^2 Dh operations; this design recomputes S and dP
// in K3c, seven products in all) on the float32 CUDA cores (67 TFLOP/s),
// against 8 L Dh 4-byte tensors moved: operations bound it.  A simple first
// kernel: SIMT float32, no tensor cores, no TMA, no double buffering.
// Thread layout as in K1: 256 threads as a 16 x 16 grid, 4 x 4 micro-tiles
// of scores, rows of Q, G, K and V padded to 129 floats in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kDh = 128;
constexpr int kTile = 64;        // query rows or keys per tile
constexpr int kThreads = 256;
constexpr int kRS = kDh + 1;     // padded row stride of Q, G, K, V in smem
constexpr int kPS = kTile + 1;   // padded row stride of P and dS in smem
constexpr float kMaskValue = -1e9f;

// K3b: Ks, Vs, Qs, Gs, Ps, dSs, then m, l, D of the query tile
constexpr size_t kSmemKV =
    sizeof(float) * (4 * kTile * kRS + 2 * kTile * kPS + 3 * kTile);
// K3c: Qs, Gs, Ks, Vs, dSs
constexpr size_t kSmemQ = sizeof(float) * (4 * kTile * kRS + kTile * kPS);

// rows [r0, r0 + 64) of a [L, 128] matrix into smem with row stride kRS;
// rows at or past L are zeros
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int L, int tid) {
  for (int i = tid; i < kTile * (kDh / 4); i += kThreads) {
    const int r = i / (kDh / 4);
    const int c = (i % (kDh / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L)
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * kDh + c);
    float* d = dst + r * kRS + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// s[i][j] = Q[row i] . K[key j] and dp[i][j] = G[row i] . V[key j] for the
// thread's rows ty*4+i and keys tx+16j of the two smem tiles; the d order
// is K1's, so s is K1's score bit for bit
__device__ __forceinline__ void scores_and_dp(const float* Qs, const float* Gs,
                                              const float* Ks, const float* Vs,
                                              int tx, int ty, float s[4][4],
                                              float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kDh; ++d) {
    float a[4], g[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty * 4 + i) * kRS + d];
      g[i] = Gs[(ty * 4 + i) * kRS + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = Ks[(tx + 16 * j) * kRS + d];
      bv[j] = Vs[(tx + 16 * j) * kRS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
      }
  }
}

// P and dS of one score: row_ok = query row < L, key_ok = key < L
__device__ __forceinline__ void prob_and_ds(float s, float dp, bool row_ok,
                                            bool key_ok, bool padded,
                                            float m, float l, float Dr,
                                            float scale, float* p, float* ds) {
  if (!(row_ok && key_ok)) {
    *p = 0.f;
    *ds = 0.f;
    return;
  }
  const float sc = padded ? kMaskValue : s * scale;
  *p = expf(sc - m) / l;
  *ds = *p * (dp - Dr) * scale;
}

__global__ void mha_bwd_rowdot_kernel(const float* __restrict__ g,
                                      const float* __restrict__ o,
                                      float* __restrict__ D, long rows) {
  const long row = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x)
                   / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float4 a = reinterpret_cast<const float4*>(g + row * kDh)[lane];
  const float4 b = reinterpret_cast<const float4*>(o + row * kDh)[lane];
  float acc = a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

__global__ void __launch_bounds__(kThreads)
mha_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const unsigned char* __restrict__ key_pad,
                    const float* __restrict__ g,
                    const float* __restrict__ row_max,
                    const float* __restrict__ row_sum,
                    const float* __restrict__ Drow, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int L, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * kRS;
  float* Qs = Vs + kTile * kRS;
  float* Gs = Qs + kTile * kRS;
  float* Ps = Gs + kTile * kRS;      // [query][key]
  float* dSs = Ps + kTile * kPS;     // [query][key]
  float* ms = dSs + kTile * kPS;
  float* ls = ms + kTile;
  float* Ds = ls + kTile;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * L * kDh;
  const size_t rbase = static_cast<size_t>(bh) * L;
  const unsigned char* pad = key_pad + static_cast<size_t>(b) * L;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  load_tile(Ks, k + base, k0, L, tid);
  load_tile(Vs, v + base, k0, L, tid);

  bool key_ok[4], padded[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + tx + 16 * j;
    key_ok[j] = key < L;
    padded[j] = key_ok[j] && pad[key] != 0;
  }

  float acc_dv[4][8], acc_dk[4][8];   // keys ty*4+i, columns tx+16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_dv[i][j] = acc_dk[i][j] = 0.f;

  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();   // the previous query tile is no longer read
    load_tile(Qs, q + base, q0, L, tid);
    load_tile(Gs, g + base, q0, L, tid);
    if (tid < kTile) {
      const bool ok = q0 + tid < L;
      ms[tid] = ok ? row_max[rbase + q0 + tid] : 0.f;
      ls[tid] = ok ? row_sum[rbase + q0 + tid] : 1.f;
      Ds[tid] = ok ? Drow[rbase + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp(Qs, Gs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const bool row_ok = q0 + r < L;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p, ds;
        prob_and_ds(s[i][j], dp[i][j], row_ok, key_ok[j], padded[j], ms[r],
                    ls[r], Ds[r], scale, &p, &ds);
        Ps[r * kPS + tx + 16 * j] = p;
        dSs[r * kPS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float p[4], ds[4], gc[8], qc[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[r * kPS + ty * 4 + i];
        ds[i] = dSs[r * kPS + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        gc[j] = Gs[r * kRS + tx + 16 * j];
        qc[j] = Qs[r * kRS + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc_dv[i][j] = fmaf(p[i], gc[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(ds[i], qc[j], acc_dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key < L) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dv[base + (size_t)key * kDh + tx + 16 * j] = acc_dv[i][j];
        dk[base + (size_t)key * kDh + tx + 16 * j] = acc_dk[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const unsigned char* __restrict__ key_pad,
                  const float* __restrict__ g,
                  const float* __restrict__ row_max,
                  const float* __restrict__ row_sum,
                  const float* __restrict__ Drow, float* __restrict__ dq,
                  int H, int L, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kTile * kRS;
  float* Ks = Gs + kTile * kRS;
  float* Vs = Ks + kTile * kRS;
  float* dSs = Vs + kTile * kRS;     // [query][key]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * L * kDh;
  const size_t rbase = static_cast<size_t>(bh) * L;
  const unsigned char* pad = key_pad + static_cast<size_t>(b) * L;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  load_tile(Qs, q + base, q0, L, tid);
  load_tile(Gs, g + base, q0, L, tid);

  bool row_ok[4];
  float m[4], l[4], Dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    row_ok[i] = r < L;
    m[i] = row_ok[i] ? row_max[rbase + r] : 0.f;
    l[i] = row_ok[i] ? row_sum[rbase + r] : 1.f;
    Dr[i] = row_ok[i] ? Drow[rbase + r] : 0.f;
  }

  float acc[4][8];   // rows ty*4+i, columns tx+16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();   // the previous key tile is no longer read
    load_tile(Ks, k + base, k0, L, tid);
    load_tile(Vs, v + base, k0, L, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores_and_dp(Qs, Gs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool key_ok = key < L;
      const bool padded = key_ok && pad[key] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p, ds;
        prob_and_ds(s[i][j], dp[i][j], row_ok[i], key_ok, padded, m[i], l[i],
                    Dr[i], scale, &p, &ds);
        dSs[(ty * 4 + i) * kPS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float ds[4], kc[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) kc[j] = Ks[c * kRS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ds[i], kc[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < L) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dq[base + (size_t)r * kDh + tx + 16 * j] = acc[i][j];
    }
  }
}

}  // namespace

// q, k, v, out (K1's output), g (the incoming gradient), dq, dk, dv:
// [B, H, L, 128] float32, contiguous.  key_pad: [B, L] bytes, nonzero =
// padded key.  row_max, row_sum: [B, H, L] from K1.  d_scratch: [B, H, L]
// float32, written.  scale = 1/sqrt(D) as float.  Three launches on
// `stream` (K3a, K3b, K3c); returns the first CUDA error, or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int fs2_mha_bwd_f32(const void* q, const void* k, const void* v,
                               const void* key_pad, const void* out,
                               const void* row_max, const void* row_sum,
                               const void* g, void* dq, void* dk, void* dv,
                               void* d_scratch, int B, int H, int L, int D,
                               float scale, void* stream) {
  if (D != kDh || B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemKV));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemQ));
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  const float* mf = static_cast<const float*>(row_max);
  const float* lf = static_cast<const float*>(row_sum);
  const unsigned char* pad = static_cast<const unsigned char*>(key_pad);
  float* Df = static_cast<float*>(d_scratch);

  const long rows = static_cast<long>(B) * H * L;
  const int warps_per_block = kThreads / 32;
  mha_bwd_rowdot_kernel<<<(rows + warps_per_block - 1) / warps_per_block,
                          kThreads, 0, st>>>(
      gf, static_cast<const float*>(out), Df, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid((L + kTile - 1) / kTile, B * H);
  mha_bwd_dkdv_kernel<<<grid, kThreads, kSmemKV, st>>>(
      qf, kf, vf, pad, gf, mf, lf, Df, static_cast<float*>(dk),
      static_cast<float*>(dv), H, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mha_bwd_dq_kernel<<<grid, kThreads, kSmemQ, st>>>(
      qf, kf, vf, pad, gf, mf, lf, Df, static_cast<float*>(dq), H, L, scale);
  return cudaGetLastError();
}
