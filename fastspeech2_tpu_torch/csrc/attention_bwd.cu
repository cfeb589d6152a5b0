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
// What bounds it on an H100: the reference's five L x L x Dh products (S
// recomputed, dP, dV, dK, dQ: 10 L^2 Dh operations per (b, h)), all on the
// tensor cores as 3xTF32 (attention_common.cuh): within ~1e-5 of float32
// at three TF32 products each, so 3 x 10 L^2 Dh at 495 TFLOP/s, against 8 L Dh
// 4-byte tensors moved.  The tensor cores bound it.
//
// The L x L matrices (4 MB each at L = 1000) do not fit a block's shared
// memory, so the work is tiled the way flash-attention backwards tile it,
// in three launches with no atomics and a fixed order of every sum, so that
// two launches on the same inputs give the same bits:
//   K3a  D = rowsum(G o O), one warp per query row.  In real arithmetic
//        rowsum(dP o P) = rowsum(G o (P V)) = rowsum(G o O); the two differ
//        only by rounding.
//   K3b  one block of 8 warps per (b, h, 64 keys): K and V stay in shared
//        memory; 64-row tiles of Q and G stream through a two-stage
//        cp.async ring.  Per query tile each warp forms a 16 x 32 tile of S
//        and dP in registers and turns them into P and dS; P, then dS, pass
//        through one shared [64][68] tile, from which dV += P^T G and
//        dK += dS^T Q accumulate (each warp owns 16 keys x 64 columns), and
//        this key tile's share of dQ = dS K for the query tile (each warp 16
//        rows x 64 columns) goes to scratch.  So S and dP are formed once,
//        and K3 forms the reference's five products and no more.
//   K3c  dQ = the sum of the key tiles' shares, in the order 0, 1, ...: one
//        pass over ceil(L / 64) * B*H*L*128 floats of scratch, bound by
//        memory.  The scratch grows as L^2: 164 MB at [10, 2, 1000, 128],
//        655 MB at L = 2000, B*H*L^2*8 bytes in general; the recompute of
//        S and dP it replaces would need none.
// K3b's shared memory is 220,160 bytes (K, V, two stages of Q and G, the
// transpose tile), so one block of 8 warps runs per SM: K and V resident
// for the whole query loop, and Q and G double-buffered at 64 rows, take
// that much; 32-row tiles would halve the work per synchronisation.  The
// two-stage ring is what overlaps copies with products.
//
// THE SCORE CONTRACT: every score is recomputed through score_tile and
// masked_score (attention_common.cuh) with Q as A and K as B, in the same
// split and k order as K1 forms it, so s is K1's score bit for bit, and P
// = exp(s - m) / l with the row max m and row sum l K1 wrote.  The mask
// value is the FINITE -1e9 of the reference: a query row whose keys are all
// padded has the uniform P = 1/L, and its gradient flows as in the
// reference; padded tiles are never skipped.  Keys and query rows at or
// past L (the ragged edge) get P = dS = 0 and are loaded as zeros.
//
// The bfloat16 instance is attention_bwd_bf16.cu (wgmma and TMA, no L^2
// scratch); this file's fs2_mha_bwd_scratch_floats answers for both.

#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using namespace fs2_attn;

constexpr int kTile = 64;         // keys (K3b) or query rows (K3c) per block
constexpr int kThreads = 256;     // 8 warps
constexpr int kTS = kTile + 4;    // row stride of the transpose tile

constexpr int kTileFloats = kTile * kStride;
constexpr size_t kSmemKV = sizeof(float) * (6 * kTileFloats + kTile * kTS);

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

// P and dS of one score in place: s <- P, dp <- dS (0 outside the rows and
// keys < L)
__device__ __forceinline__ void prob_and_ds(float& s, float& dp, bool ok,
                                            bool padded, float m, float l,
                                            float Dr, float scale) {
  if (!ok) {
    s = 0.f;
    dp = 0.f;
    return;
  }
  const float p = expf(masked_score(s, padded, scale) - m) / l;
  dp = p * (dp - Dr) * scale;
  s = p;
}

// the row statistics of query row r (neutral values past L)
__device__ __forceinline__ void row_stats(const float* row_max,
                                          const float* row_sum,
                                          const float* Drow, size_t rbase,
                                          int r, int L, float* m, float* l,
                                          float* Dr) {
  const bool ok = r < L;
  *m = ok ? row_max[rbase + r] : 0.f;
  *l = ok ? row_sum[rbase + r] : 1.f;
  *Dr = ok ? Drow[rbase + r] : 0.f;
}

// acc[n] (16 rows x 64 columns as 8 C fragments) += A^T B over 64 k: A^T
// from the transpose tile (p_at = &Ts[0][m0], stride kTS), B from a
// row-major [64][kStride] tile (p_b = &tile[0][c0]); k in the permuted order
__device__ __forceinline__ void mma_at_b(const float* p_at, const float* p_b,
                                         int g, int t, float acc[8][4]) {
#pragma unroll
  for (int k0 = 0; k0 < kTile; k0 += 8) {
    uint32_t ab[4], as[4], bb[8][2], bs[8][2];
    load_at_perm(p_at + k0 * kTS, kTS, g, t, ab, as);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      load_b_perm(p_b + k0 * kStride + 8 * n, kStride, g, t, bb[n], bs[n]);
    mma_3xtf32_n<8>(acc, ab, as, bb, bs);
  }
}

// writes one warp's 16 x 32 C-fragment tile x[j] into the transpose tile at
// rows r0.., columns c0..
__device__ __forceinline__ void store_tile(float* Ts, int r0, int c0, int g,
                                           int t, const float x[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* p = Ts + (r0 + g) * kTS + c0 + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(x[j][0], x[j][1]);
    *reinterpret_cast<float2*>(p + 8 * kTS) = make_float2(x[j][2], x[j][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const unsigned char* __restrict__ key_pad,
                    const float* __restrict__ g,
                    const float* __restrict__ row_max,
                    const float* __restrict__ row_sum,
                    const float* __restrict__ Drow, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dq_part,
                    int H, int L, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [64][kStride]
  float* Vs = Ks + kTileFloats;
  float* ring = Vs + kTileFloats;                // per stage: Q then G
  float* Ts = ring + 4 * kTileFloats;            // [64 queries][kTS]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * L * kDh;
  const size_t rbase = static_cast<size_t>(bh) * L;
  const unsigned char* pad = key_pad + static_cast<size_t>(b) * L;
  const float* qp = q + base;
  const float* gp = g + base;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;   // fragment row group
  const int t = lane % 4;
  // S / dP tile of this warp: query rows 16 rg.., keys 32 kh..
  const int rg = warp & 3, kh = warp >> 2;
  // dV / dK tile of this warp: keys kr.., columns c0..; its dQ partial:
  // query rows kr.. of each query tile, the same columns
  const int kr = 16 * (warp & 3), c0 = 64 * (warp >> 2);
  // this key tile's dQ partials, [B*H*L][128]
  float* dqp = dq_part + static_cast<size_t>(blockIdx.x) * gridDim.y * L * kDh;

  load_tile_async<kTile, kThreads>(Ks, k + base, k0, L, tid);
  load_tile_async<kTile, kThreads>(Vs, v + base, k0, L, tid);
  load_tile_async<kTile, kThreads>(ring, qp, 0, L, tid);
  load_tile_async<kTile, kThreads>(ring + kTileFloats, gp, 0, L, tid);
  cp_async_commit();

  bool key_ok[4][2], padded[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 32 * kh + 8 * j + 2 * t + e;
      key_ok[j][e] = key < L;
      padded[j][e] = key_ok[j][e] && pad[key] != 0;
    }

  float acc_dv[8][4], acc_dk[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dv[n][i] = acc_dk[n][i] = 0.f;

  const int n_tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * kTile;
    float* Qs = ring + (it & 1) * 2 * kTileFloats;
    float* Gs = Qs + kTileFloats;
    if (it + 1 < n_tiles) {
      float* next = ring + ((it + 1) & 1) * 2 * kTileFloats;
      load_tile_async<kTile, kThreads>(next, qp, q0 + kTile, L, tid);
      load_tile_async<kTile, kThreads>(next + kTileFloats, gp, q0 + kTile, L,
                                       tid);
      cp_async_commit();
    }
    float m[2], l[2], Dr[2];
    bool row_ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + 16 * rg + gq + 8 * h;
      row_ok[h] = r < L;
      row_stats(row_max, row_sum, Drow, rbase, r, L, &m[h], &l[h], &Dr[h]);
    }
    if (it + 1 < n_tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tile(Qs + 16 * rg * kStride, Ks + 32 * kh * kStride, lane, s);
    score_tile(Gs + 16 * rg * kStride, Vs + 32 * kh * kStride, lane, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          prob_and_ds(s[j][2 * h + e], dp[j][2 * h + e],
                      row_ok[h] && key_ok[j][e], padded[j][e], m[h], l[h],
                      Dr[h], scale);

    store_tile(Ts, 16 * rg, 32 * kh, gq, t, s);      // P
    __syncthreads();
    mma_at_b(Ts + kr, Gs + c0, gq, t, acc_dv);       // dV += P^T G
    __syncthreads();
    store_tile(Ts, 16 * rg, 32 * kh, gq, t, dp);     // dS
    __syncthreads();
    mma_at_b(Ts + kr, Qs + c0, gq, t, acc_dk);       // dK += dS^T Q

    // this key tile's part of dQ = dS K for query rows kr.. (dS from the
    // tile as A, K as B, both in the permuted key order), to scratch
    float acc_dq[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_dq[n][i] = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += 8) {
      uint32_t ab[4], as[4], bb[8][2], bs[8][2];
      load_a_perm(Ts + kr * kTS + j0, kTS, gq, t, ab, as);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        load_b_perm(Ks + j0 * kStride + c0 + 8 * n, kStride, gq, t, bb[n],
                    bs[n]);
      mma_3xtf32_n<8>(acc_dq, ab, as, bb, bs);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + kr + gq + 8 * h;
      if (r >= L) continue;
      float* out = dqp + (static_cast<size_t>(bh) * L + r) * kDh + c0 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(out + 8 * n) =
            make_float2(acc_dq[n][2 * h], acc_dq[n][2 * h + 1]);
    }
    __syncthreads();   // the stage and the transpose tile are reused
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr + gq + 8 * h;
    if (key >= L) continue;
    const size_t off = base + static_cast<size_t>(key) * kDh + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(acc_dv[n][2 * h], acc_dv[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(acc_dk[n][2 * h], acc_dk[n][2 * h + 1]);
    }
  }
}

// K3c: dQ = the sum of the key tiles' partials, in the order 0, 1, ...;
// one thread per 4 floats
__global__ void __launch_bounds__(kThreads)
mha_bwd_dq_reduce_kernel(const float* __restrict__ dq_part, int n_parts,
                         long n4, float* __restrict__ dq) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4* part = reinterpret_cast<const float4*>(dq_part);
  float4 acc = part[i];
  for (int p = 1; p < n_parts; ++p) {
    const float4 x = part[p * n4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4(dq + 4 * i, acc);
}

}  // namespace

extern "C" long long fs2_mha_bwd_bf16_scratch_floats(int B, int H, int L);

// The float32 scratch fs2_mha_bwd_f32 needs for [B, H, L, 128]: one dQ
// partial per 64-key tile (ceil(L / 64) * B*H*L * 128), then D (B*H*L); with
// bf16 != 0 what fs2_mha_bwd_bf16 needs (attention_bwd_bf16.cu: D alone).
extern "C" long long fs2_mha_bwd_scratch_floats(int B, int H, int L,
                                                int bf16) {
  if (bf16) return fs2_mha_bwd_bf16_scratch_floats(B, H, L);
  if (B <= 0 || H <= 0 || L <= 0) return -1;
  const long long rows = static_cast<long long>(B) * H * L;
  return rows + static_cast<long long>((L + kTile - 1) / kTile) * rows * kDh;
}

// q, k, v, out (K1's output), g (the incoming gradient), dq, dk, dv:
// [B, H, L, 128] float32, contiguous.  key_pad: [B, L] bytes, nonzero =
// padded key.  row_max, row_sum: [B, H, L] from K1.  scratch:
// fs2_mha_bwd_scratch_floats(B, H, L) floats, written.  scale = 1/sqrt(D)
// as float.  Three launches on `stream` (K3a, K3b, K3c);
// returns the first CUDA error, or cudaErrorInvalidValue for a shape the
// kernels do not take.
extern "C" int fs2_mha_bwd_f32(const void* q, const void* k, const void* v,
                               const void* key_pad, const void* out,
                               const void* row_max, const void* row_sum,
                               const void* g, void* dq, void* dk, void* dv,
                               void* scratch, int B, int H, int L, int D,
                               float scale, void* stream) {
  if (D != kDh || B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaError_t err = set_smem(
      reinterpret_cast<const void*>(mha_bwd_dkdv_kernel), kSmemKV);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  const float* mf = static_cast<const float*>(row_max);
  const float* lf = static_cast<const float*>(row_sum);
  const unsigned char* pad = static_cast<const unsigned char*>(key_pad);
  const long rows = static_cast<long>(B) * H * L;
  const int n_tiles = (L + kTile - 1) / kTile;
  float* dq_part = static_cast<float*>(scratch);   // 16-byte aligned
  float* Df = dq_part + n_tiles * rows * kDh;

  const int warps_per_block = kThreads / 32;
  mha_bwd_rowdot_kernel<<<(rows + warps_per_block - 1) / warps_per_block,
                          kThreads, 0, st>>>(
      gf, static_cast<const float*>(out), Df, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mha_bwd_dkdv_kernel<<<dim3(n_tiles, B * H), kThreads, kSmemKV, st>>>(
      qf, kf, vf, pad, gf, mf, lf, Df, static_cast<float*>(dk),
      static_cast<float*>(dv), dq_part, H, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long n4 = rows * kDh / 4;
  mha_bwd_dq_reduce_kernel
      <<<(n4 + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          dq_part, n_tiles, n4, static_cast<float*>(dq));
  return cudaGetLastError();
}

// Resident blocks per SM of K3b, for the build report; -1 on an error.
extern "C" int fs2_mha_bwd_blocks_per_sm() {
  const void* fn = reinterpret_cast<const void*>(mha_bwd_dkdv_kernel);
  int n = 0;
  if (set_smem(fn, kSmemKV) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                    kSmemKV) != cudaSuccess)
    return -1;
  return n;
}
