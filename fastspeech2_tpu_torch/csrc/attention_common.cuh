// Shared by K1 (attention.cu) and K3 (attention_bwd.cu): the score tile
// S = Q K^T on mma.sync, through which K3 recomputes K1's scores bit for
// bit (K1 forms them on wgmma with the same split operands in the same k
// order: attention.cu's score contract), and the fragment loads of K3's
// [rows][128] tiles.  The 3xTF32 product, the TF32 rounding and the
// cp.async wrappers come from tf32_mma.cuh, which K2 and K4 use too.  The
// tensor cores' own float32 accumulation rounds less exactly than an FMA
// chain: on an H100 K3's errors against float64 are ~7x plain float32's,
// where the same split on float32 GEMMs matches plain float32
// (tools/attention_bench.py --errors).
//
// K3 is bound by how fast the tensor cores are fed, so each k-step issues
// its three passes across several independent accumulators (all
// big*small, then all small*big, then all big*big; mma_3xtf32_n) rather
// than three dependent products in a row, and fragments of row-major tiles
// whose rows are 16-byte runs of k come in by ldmatrix (one instruction
// for four 8 x 4 float blocks).
//
// Fragments are those of mma.sync.aligned.m16n8k8.row.col.f32.tf32
// (tf32_mma.cuh).  A product whose k index runs over keys or query rows
// may take its k in any order, as long as A and B agree.  Those products
// use the order k = t <-> row 2t, k = t+4 <-> row 2t+1 of each group of 8,
// so that a C fragment (c0, c2, c1, c3) is an A fragment as it stands (no
// shuffles), and the matching B fragment rows 2t and 2t+1 of a row-major
// tile are free of bank conflicts at a row stride of 4 mod 32 floats.
//
// Shared-memory tiles of [rows][128] floats have a row stride of 132
// floats (4 mod 32 banks): a fragment load by the 32 lanes of a warp then
// touches 32 different banks, and rows stay 16-byte aligned for cp.async.
//
// The kernels on wgmma and TMA (the float32 K1, the bfloat16 instances:
// attention_bf16.cuh, hopper.cuh) share this file's constants, masked
// score, quad reductions and stores.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace fs2_attn {

using fs2_tc::cp_async16;
using fs2_tc::cp_async_commit;
using fs2_tc::cp_async_wait;
using fs2_tc::mma_tf32;
using fs2_tc::pack_bf16;
using fs2_tc::split;
using fs2_tc::tf32_rna;

using bf16 = __nv_bfloat16;

constexpr int kDh = 128;           // head dim
constexpr int kStride = kDh + 4;   // smem row stride of [rows][128] tiles
constexpr float kMaskValue = -1e9f;
constexpr float kInitMax = -1e30f;  // below any score, finite

__device__ __forceinline__ void split_bits(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  split(__uint_as_float(x), big, small);
}

// 3xTF32 for N independent accumulators sharing the A fragment:
// d[i] += a_big b_small[i] + a_small b_big[i] + a_big b_big[i], one pass
// over all N at a time
template <int N>
__device__ __forceinline__ void mma_3xtf32_n(float (*d)[4],
                                             const uint32_t ab[4],
                                             const uint32_t as[4],
                                             const uint32_t (*bb)[2],
                                             const uint32_t (*bs)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, bs[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], as, bb[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, bb[i]);
}

// four 8 x 4 float blocks of shared memory; lane l gives the address of row
// l % 8 of block l / 8 (16-byte aligned) and receives word l % 4 of row
// l / 4 of each block
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// A fragment of a row-major tile (m = row, k = column); p = &tile[m0][k0]
__device__ __forceinline__ void load_a(const float* p, int lane,
                                       uint32_t big[4], uint32_t small[4]) {
  const int blk = lane / 8;
  uint32_t r[4];
  ldmatrix_x4(r, p + (lane % 8 + 8 * (blk & 1)) * kStride + 4 * (blk >> 1));
#pragma unroll
  for (int i = 0; i < 4; ++i) split_bits(r[i], big[i], small[i]);
}

// B fragments of two n-tiles (n0.., n0+8..) of a tile that holds B^T
// row-major (n = row, k = column), as K holds it for S = Q K^T;
// p = &tile[n0][k0]
__device__ __forceinline__ void load_bt2(const float* p, int lane,
                                         uint32_t big[2][2],
                                         uint32_t small[2][2]) {
  const int blk = lane / 8;
  uint32_t r[4];
  ldmatrix_x4(r, p + (lane % 8 + 8 * (blk >> 1)) * kStride + 4 * (blk & 1));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_bits(r[i], big[i / 2][i % 2], small[i / 2][i % 2]);
}

// B fragment of a row-major tile (k = row, n = column) in the permuted k
// order; p = &tile[k0][n0], row stride `stride`
__device__ __forceinline__ void load_b_perm(const float* p, int stride, int g,
                                            int t, uint32_t big[2],
                                            uint32_t small[2]) {
  split(p[(2 * t) * stride + g], big[0], small[0]);
  split(p[(2 * t + 1) * stride + g], big[1], small[1]);
}

// A fragment of a row-major tile (m = row, k = column) in the permuted k
// order; p = &tile[m0][k0], row stride `stride` (even: keys 2t and 2t + 1
// come in one 8-byte load)
__device__ __forceinline__ void load_a_perm(const float* p, int stride, int g,
                                            int t, uint32_t big[4],
                                            uint32_t small[4]) {
  const float2 lo = *reinterpret_cast<const float2*>(p + g * stride + 2 * t);
  const float2 hi =
      *reinterpret_cast<const float2*>(p + (g + 8) * stride + 2 * t);
  split(lo.x, big[0], small[0]);
  split(hi.x, big[1], small[1]);
  split(lo.y, big[2], small[2]);
  split(hi.y, big[3], small[3]);
}

// A fragment of the TRANSPOSE of a row-major tile (m = column, k = row) in
// the permuted k order; p = &tile[k0][m0], row stride `stride`
__device__ __forceinline__ void load_at_perm(const float* p, int stride,
                                             int g, int t, uint32_t big[4],
                                             uint32_t small[4]) {
  split(p[(2 * t) * stride + g], big[0], small[0]);
  split(p[(2 * t) * stride + g + 8], big[1], small[1]);
  split(p[(2 * t + 1) * stride + g], big[2], small[2]);
  split(p[(2 * t + 1) * stride + g + 8], big[3], small[3]);
}

// THE SCORE CONTRACT.  One warp's 16 x 32 tile of raw scores
// s = Q K^T: query rows of the tile at q (row-major [16][128], stride
// kStride) against keys of the tile at k ([32][128]); s[j] is the C
// fragment of keys 8j..8j+7.  The sum over d runs in eight-wide k-steps
// d = 0, 8, ..., 120; each adds a_big b_small, a_small b_big and a_big
// b_big, in that order, to an accumulator that starts at 0, with Q as A
// and K as B.  K3 recomputes every score through this function; K1 forms
// them through score_tile_f32 (attention.cu), wgmma products of the same
// split operands in the same order, which give the same bits on an H100
// (chip_smoke.py checks it through fs2_mha_scores_f32).  So K3's scores,
// and through K1's row max and row sum its probabilities, are K1's bit for
// bit.  K3 also forms dP = G V^T with it.
__device__ __forceinline__ void score_tile(const float* q, const float* k,
                                           int lane, float s[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int d = 0; d < kDh; d += 8) {
    uint32_t ab[4], as[4], bb[4][2], bs[4][2];
    load_a(q + d, lane, ab, as);
    load_bt2(k + d, lane, bb, bs);
    load_bt2(k + 16 * kStride + d, lane, bb + 2, bs + 2);
    mma_3xtf32_n<4>(s, ab, as, bb, bs);
  }
}

// The scaled, masked score: the scale before the mask, and a multiply the
// compiler may not fuse into a later subtraction (K1 and K3 must agree)
__device__ __forceinline__ float masked_score(float s, bool padded,
                                              float scale) {
  return padded ? kMaskValue : __fmul_rn(s, scale);
}

// two (store2) or four (store4) consecutive outputs as float, or as
// bfloat16 rounded to nearest even
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  uint2 w;
  w.x = pack_bf16(v.x, v.y);
  w.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = w;
}

// ---- asynchronous copies ---------------------------------------------------

// rows [r0, r0 + ROWS) of a row-major [L][128] matrix into a smem tile of
// stride kStride, by THREADS threads; rows at or past L are zeros
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src,
                                                int r0, int L, int tid) {
  static_assert((ROWS * kDh / 4) % THREADS == 0, "tile / threads");
#pragma unroll
  for (int it = 0; it < ROWS * kDh / 4 / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / (kDh / 4);
    const int c = (i % (kDh / 4)) * 4;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * kStride + c,
               ok ? src + static_cast<size_t>(r0 + r) * kDh + c : src, ok);
  }
}

// ---- reductions over the 4 lanes that share a row of a C fragment --------

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a kernel's dynamic shared memory opt-in, with the carveout that leaves
// the most of it to shared memory
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace fs2_attn
