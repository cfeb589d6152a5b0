// K1: fused masked multi-head self-attention forward, float32, for sm_90a,
// on wgmma (3xTF32) and TMA.
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
// What bounds it on an H100: the two products, 4 L^2 Dh operations per
// (b, h), run on the tensor cores as 3xTF32 (tf32_mma.cuh), within ~1e-5 of
// float32 at three TF32 products each: 3 x 4 L^2 Dh at 495 TFLOP/s, against
// 4 L Dh 4-byte tensors moved.  At L = 1000 that is ~750 TF32 operations
// per byte (the card's ridge is ~150), so the tensor cores bound it, and
// only wgmma reaches their rate.
//
// Design (the bfloat16 instance's shape, attention_bf16.cu; the split and
// the score routine in attention_f32.cuh, which K3 shares): a block of two
// warpgroups, 64 query rows each, sharing every K and V tile.  Thread 0
// loads Q once and tiles of 32 keys of K and V into a two-stage ring by TMA
// (tensor maps over [B*H, L, 128] in boxes of 32 floats, the 128-byte
// swizzle: rows past L arrive as zeros and never read the next head).
// tf32 wgmma takes K-major operands only, and 3xTF32 needs each operand's
// big and small TF32 parts, so the threads split the tiles in shared
// memory where they land:
//   - Q once: each thread keeps the big parts of its A fragments of the 16
//     k-steps in registers and writes the small parts in place;
//   - each K tile: big parts in place, small parts beside them;
//   - each V tile: transposed into Vt [128 d][32 keys] big and small planes
//     (128-byte swizzle, the keys of each k-step of 8 in the permuted order
//     0, 2, 4, 6, 1, 3, 5, 7), the K-major B operand of P V.
// Per tile a warpgroup forms S = Q K^T by score_tile_f32 (below: 16 k-steps
// of three m64n32k8 products), the online softmax in registers, and
// O += P V by four k-steps of three m64n128k8 products whose A is P from
// registers: S's accumulator of keys 8j..8j+7, read as (c0, c2, c1, c3),
// is the A fragment of k-step j in the permuted key order, split into its
// TF32 parts.  P V's products run x_small w_big, x_big w_small, x_big w_big
// (P as x, V as w; K4's order).  While P V runs, every thread splits its
// share of the next tile (landed a tile earlier), and the block syncs once
// per tile: then thread 0 refills the stage with the tile after next.
// Shared memory: Q 64 KB plus two stages of 80 KB (K, K's small plane, V,
// Vt's two planes) and the barriers: one block of 256 threads per SM, 255
// registers a thread.  The exponential is expf, as K3 takes it.  Nothing
// is summed by atomics: every sum has a fixed order, so every launch gives
// the same bits.
//
// Filling the card: a grid of B*H*ceil(L/128) blocks is 16 at [1, 2, 1000,
// 128] and 160 at [10, 2, 1000, 128] (1.2 waves).  So the keys may be split
// into chunks (a flash-decoding split): each block of the (query tile, b*h,
// chunk) grid writes its unnormalised partial (row max m, row sum l,
// accumulator) to scratch, and a second, small launch combines the chunks
// in the fixed order 0, 1, ... and writes the output and the row
// statistics.  The plan (below) costs each chunk count by its waves and by
// the partials' bytes, so the split pays only where the grid is a fraction
// of a wave or leaves most of a second one idle.  With the row statistics
// (training) the chunks depend on L alone, so that every row's output and
// statistics are the same bits at any batch size and head count: a data-
// or tensor-parallel rank's K1 is the one-process step's.
//
// The ragged edge (L not a multiple of the tiles) is masked: keys at or past
// L get probability exactly 0 (their scores enter as kInitMax) and are
// loaded as zeros.
//
// For training, the kernel also writes each query row's softmax statistics
// (the final row max m and row sum l, so that P = exp(s - m) / l) through
// two optional pointers; K3 (attention_bwd.cu) reads them.  They are kept
// apart, not folded into a log-sum-exp: for a fully padded row m = -1e9,
// and -1e9 + log(L) rounds back to -1e9 in float32.  Inference passes null.
//
// THE SCORE CONTRACT with K3 (attention_f32.cuh): K3 recomputes every score
// with the same split operands in the same k order (per k-step of 8:
// Q_big K_small, Q_small K_big, Q_big K_big, from a zero accumulator; K3a
// with Q's small parts from registers, K3b with K as A), and uses this
// kernel's row max and row sum.  fs2_mha_scores_f32 writes S through each
// routine, so that a run on the card can show them equal bit for bit.
//
// The bfloat16 instance is attention_bf16.cu; this file's fs2_mha_fwd_plan
// answers for both.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>

#include "attention_f32.cuh"

namespace {

using namespace fs2_attn;

constexpr int kWGs = 2;           // warpgroups, 64 query rows each
constexpr int kBM = 64 * kWGs;    // query rows per block
constexpr int kBN = 32;           // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 128 * kWGs;
constexpr int kBlocksPerSM = 1;   // what the shared memory below allows
// shared memory: boxes and planes (each 1,024-byte aligned), then the
// barriers
struct F32Smem {
  float q[kWGs][4 * kQBox];    // Q as loaded, then its small plane in place
  float k[kStages][kTileF];    // K as loaded, then its big plane in place
  float ks[kStages][kTileF];   // K's small plane
  float v[kStages][kTileF];    // V as loaded
  float vt[kStages][2][kTileF];  // Vt [128][32]: big, small
  uint64_t full_q;
  uint64_t full[kStages];
};
constexpr size_t kSmemBytes = sizeof(F32Smem) + 1024;

// The online softmax of one tile's scores x (raw S in, P out): the rows'
// new max m, the factor alpha = exp(m_old - m) their running sums l and the
// output take, and P = exp(x - m) split into the big and small parts of
// the four k-steps' A fragments (keys 2t, 2t + 1 as k = t, t + 4)
__device__ __forceinline__ void softmax_tile32(float (&x)[16], uint32_t f,
                                               int k0, int L, int t,
                                               float scale, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               uint32_t (&pb)[4][4],
                                               uint32_t (&ps)[4][4]) {
  tile_scores32(x, f, k0, L, t, scale);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mx = fmaxf(mx, fmaxf(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]));
    mx = quad_max(mx);
    alpha[h] = expf(m[h] - mx);
    m[h] = mx;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = expf(x[i] - m[(i / 2) % 2]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) rs += x[4 * j + 2 * h] + x[4 * j + 2 * h + 1];
    l[h] = l[h] * alpha[h] + quad_sum(rs);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(x[4 * j], pb[j][0], ps[j][0]);
    split(x[4 * j + 2], pb[j][1], ps[j][1]);
    split(x[4 * j + 1], pb[j][2], ps[j][2]);
    split(x[4 * j + 3], pb[j][3], ps[j][3]);
  }
}

// the producer's step (thread 0): key tile kt into stage s
__device__ __forceinline__ void load_kv(F32Smem& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int s, int kt,
                                        int bh) {
  mbar_expect_tx(&sm.full[s], 2 * kTileF * sizeof(float));
#pragma unroll
  for (int bx = 0; bx < 4; ++bx) {
    tma_load_3d(sm.k[s] + bx * kKBox, tk, &sm.full[s], 32 * bx, kt * kBN, bh);
    tma_load_3d(sm.v[s] + bx * kKBox, tv, &sm.full[s], 32 * bx, kt * kBN, bh);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mha_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const unsigned char* __restrict__ key_pad,
                   float* __restrict__ out, float* __restrict__ row_max,
                   float* __restrict__ row_sum, float* __restrict__ part_o,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   int H, int L, float scale, int tiles_per_chunk) {
  extern __shared__ unsigned char smem_raw[];
  F32Smem& sm = *reinterpret_cast<F32Smem*>(align_smem(smem_raw));

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int n_tiles = (L + kBN - 1) / kBN;
  const int t_begin = blockIdx.z * tiles_per_chunk;
  const int n = min(n_tiles, t_begin + tiles_per_chunk) - t_begin;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = blockIdx.x * kBM + 64 * wg;   // this warpgroup's rows
  const unsigned char* pad = key_pad + static_cast<size_t>(b) * L;

  if (tid == 0) {
    mbar_init(&sm.full_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&sm.full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {   // Q, and the ring filled
    mbar_expect_tx(&sm.full_q, kWGs * 4 * kQBox * sizeof(float));
    for (int w = 0; w < kWGs; ++w)
      for (int bx = 0; bx < 4; ++bx)
        tma_load_3d(sm.q[w] + bx * kQBox, &tq, &sm.full_q, 32 * bx,
                    blockIdx.x * kBM + 64 * w, bh);
    for (int i = 0; i < min(n, kStages); ++i)
      load_kv(sm, &tk, &tv, i, t_begin + i, bh);
  }
  __syncwarp();

  uint32_t qb[16][4];   // Q's big parts: A fragments of the 16 k-steps
  mbar_wait(&sm.full_q, 0);
  split_q(sm.q[wg], warp, lane, qb);
  mbar_wait(&sm.full[0], 0);
  split_kv<kThreads>(sm.k[0], sm.ks[0], sm.v[0], sm.vt[0][0], tid);
  fence_proxy_async();
  __syncthreads();

  // rows g and g + 8 of the warp's 16: running max, running sum; the
  // output accumulator o[4c + 2h + e] at column 8c + 2t + e
  float m[2] = {kInitMax, kInitMax};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float x[16];
  uint32_t pb[4][4], ps[4][4];
  uint32_t f = pad_byte(pad, t_begin * kBN, L, lane);

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int k0 = (t_begin + i) * kBN;
    const uint32_t f_next = pad_byte(pad, k0 + kBN, L, lane);
    // S = Q K^T
    reg_fence(o);
    wgmma_fence();
    score_tile_f32(x, qb, sm.q[wg], sm.k[s], sm.ks[s]);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(x);
    softmax_tile32(x, f, k0, L, t, scale, m, l, alpha, pb, ps);
    f = f_next;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      o[4 * c] *= alpha[0];
      o[4 * c + 1] *= alpha[0];
      o[4 * c + 2] *= alpha[1];
      o[4 * c + 3] *= alpha[1];
    }
    // O += P V: per k-step, P_small Vt_big, P_big Vt_small, P_big Vt_big
    reg_fence(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(pb[j]);
      reg_fence(ps[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t big = make_desc(sm.vt[s][0] + 8 * j, 16, kAtom);
      wgmma_tf32_rs<128>(o, ps[j], big);
      wgmma_tf32_rs<128>(o, pb[j], make_desc(sm.vt[s][1] + 8 * j, 16, kAtom));
      wgmma_tf32_rs<128>(o, pb[j], big);
    }
    wgmma_commit();
    // the next tile's split while P V runs (its stage is free: the block
    // synced after its last use)
    if (i + 1 < n) {
      const int s1 = (i + 1) % kStages;
      mbar_wait(&sm.full[s1], ((i + 1) / kStages) & 1);
      split_kv<kThreads>(sm.k[s1], sm.ks[s1], sm.v[s1], sm.vt[s1][0], tid);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(pb[j]);
      reg_fence(ps[j]);
    }
    __syncthreads();   // stage s is read by no one now
    if (tid == 0 && i + kStages < n)
      load_kv(sm, &tk, &tv, s, t_begin + i + kStages, bh);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= L) continue;
    const size_t row = static_cast<size_t>(bh) * L + r;
    if (part_o == nullptr) {
      const float inv = 1.f / l[h];
      float* op = out + row * kDh + 2 * t;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        store2(op + 8 * c, o[4 * c + 2 * h] * inv, o[4 * c + 2 * h + 1] * inv);
      if (row_max != nullptr && t == 0) {
        row_max[row] = m[h];
        row_sum[row] = l[h];
      }
    } else {
      const size_t rows = static_cast<size_t>(gridDim.y) * L;
      const size_t prow = blockIdx.z * rows + row;
      float* op = part_o + prow * kDh + 2 * t;
#pragma unroll
      for (int c = 0; c < 16; ++c)
        store2(op + 8 * c, o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
      if (t == 0) {
        part_m[prow] = m[h];
        part_l[prow] = l[h];
      }
    }
  }
}

// One warp per row: combines the chunks' partials in the order 0, 1, ...
// and writes the output
__global__ void __launch_bounds__(256)
mha_fwd_combine_kernel(const float* __restrict__ part_o,
                       const float* __restrict__ part_m,
                       const float* __restrict__ part_l, int n_chunks,
                       long rows, float* __restrict__ out,
                       float* __restrict__ row_max,
                       float* __restrict__ row_sum) {
  const long row = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x)
                   / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float mx = kInitMax;
  for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, part_m[c * rows + row]);
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < n_chunks; ++c) {
    const float w = expf(part_m[c * rows + row] - mx);
    lsum += part_l[c * rows + row] * w;
    const float4 a =
        reinterpret_cast<const float4*>(part_o + (c * rows + row) * kDh)[lane];
    acc.x += a.x * w;
    acc.y += a.y * w;
    acc.z += a.z * w;
    acc.w += a.w * w;
  }
  const float inv = 1.f / lsum;
  store4(out + row * kDh + 4 * lane,
         make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  if (row_max != nullptr && lane == 0) {
    row_max[row] = mx;
    row_sum[row] = lsum;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

// The plan's cost model, in microseconds on an H100 (the card's device
// times of this kernel): a key tile of one block (128 query rows), the
// block's Q load, split and epilogue in key tiles, the combining launch's
// fixed cost, and the device memory's rate for the partials (written once,
// read back once)
constexpr double kTileUs = 3.0;
constexpr double kPrologueTiles = 1.5;
constexpr double kCombineUs = 2.0;
constexpr double kBytesPerUs = 3.35e6;

// the launch: grid (query tiles, B*H, key chunks) and key tiles per chunk.
// Blocks run in waves of kBlocksPerSM per SM, and a block takes about one
// key tile's time for each tile of its chunk plus kPrologueTiles; a split
// also writes chunks * B*H*L * 130 floats of partials and reads them back
// in a second launch.  The plan takes the chunk count
// whose modelled time is least, the smallest on a tie.
// FS2_MHA_FWD_CHUNKS, when defined at build time, fixes the count instead
// (tools/attention_bench.py --split-sweep builds such variants).  With
// `stats` the chunks are kStatsChunkTiles key tiles long, or one tile where
// L is at most that many tiles: fixed by L alone.
constexpr int kStatsChunkTiles = 8;

void plan(int B, int H, int L, bool stats, int grid[3],
          int* tiles_per_chunk) {
  const int n_tiles = (L + kBN - 1) / kBN;
  const long blocks = static_cast<long>(B) * H * ((L + kBM - 1) / kBM);
  const long slots = static_cast<long>(kBlocksPerSM) * sm_count();
  const double rows = static_cast<double>(B) * H * L;
  int per = n_tiles;
#ifdef FS2_MHA_FWD_CHUNKS
  per = (n_tiles + FS2_MHA_FWD_CHUNKS - 1) / FS2_MHA_FWD_CHUNKS;
#else
  double best = -1.0;
  for (int c = 1; c <= n_tiles && !stats; ++c) {
    const int tiles = (n_tiles + c - 1) / c;
    const long used = (n_tiles + tiles - 1) / tiles;   // no empty chunk
    double us = static_cast<double>((blocks * used + slots - 1) / slots) *
                (tiles + kPrologueTiles) * kTileUs;
    if (used > 1)
      us += kCombineUs +
            2.0 * used * rows * (kDh + 2) * sizeof(float) / kBytesPerUs;
    if (best < 0.0 || us < best) {
      best = us;
      per = tiles;
    }
  }
  if (stats) per = n_tiles <= kStatsChunkTiles ? 1 : kStatsChunkTiles;
#endif
  per = std::max(per, 1);
  *tiles_per_chunk = per;
  grid[0] = (L + kBM - 1) / kBM;
  grid[1] = B * H;
  grid[2] = (n_tiles + per - 1) / per;
}

// ---- the score contract's check ------------------------------------------

// raw S = Q K^T into s_out ([B*H][L][L]) through K1's routine (route 1:
// split_q, split_kv and score_tile_f32 on one warpgroup, a tile of 64 query
// rows by 32 keys), K3b's (route 2: S^T = K Q^T, score_tile_f32_t, a tile
// of 64 keys by 32 query rows) or K3a's (route 3: score_tile_f32_rr, Q's
// small parts from registers); blockIdx.x the 64-row tile, blockIdx.y the
// 32-row one
__global__ void __launch_bounds__(128)
mha_scores_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      float* __restrict__ s_out, int L, int route) {
  extern __shared__ unsigned char smem_raw[];
  float* sa = reinterpret_cast<float*>(align_smem(smem_raw));   // A: 64 rows
  float* sb = sa + 4 * kQBox;                                   // B: 32 rows
  float* sbs = sb + kTileF;
  const int bh = blockIdx.z;
  const int a0 = blockIdx.x * 64, b0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const float* ap = (route != 2 ? q : k) + static_cast<size_t>(bh) * L * kDh;
  const float* bp = (route != 2 ? k : q) + static_cast<size_t>(bh) * L * kDh;
  for (int i = tid; i < 64 * kDh; i += 128) {
    const int r = i / kDh, d = i % kDh;
    sa[tile_at(r, d, kQBox)] =
        a0 + r < L ? ap[static_cast<size_t>(a0 + r) * kDh + d] : 0.f;
  }
  for (int i = tid; i < kBN * kDh; i += 128) {
    const int r = i / kDh, d = i % kDh;
    sb[tile_at(r, d, kKBox)] =
        b0 + r < L ? bp[static_cast<size_t>(b0 + r) * kDh + d] : 0.f;
  }
  __syncthreads();
  uint32_t ab[16][4], as[16][4];
  if (route == 3)
    split_q_regs(sa, warp, lane, ab, as);
  else
    split_q(sa, warp, lane, ab);
  split_kv<128>(sb, sbs, nullptr, nullptr, tid);
  fence_proxy_async();
  __syncthreads();
  float x[16];
  wgmma_fence();
  if (route == 1)
    score_tile_f32(x, ab, sa, sb, sbs);
  else if (route == 2)
    score_tile_f32_t(x, ab, sa, sb, sbs);
  else
    score_tile_f32_rr(x, ab, as, sb, sbs);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(x);
  // x[4j + 2h + e]: A row 16 w + g + 8 h, B row 8 j + 2 t + e
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ra = a0 + 16 * warp + g + 8 * h, rb = b0 + 8 * j + 2 * t + e;
        const int r = route != 2 ? ra : rb, key = route != 2 ? rb : ra;
        if (r < L && key < L)
          s_out[(static_cast<size_t>(bh) * L + r) * L + key] =
              x[4 * j + 2 * h + e];
      }
}

constexpr size_t kScoresSmem =
    sizeof(float) * (4 * kQBox + 2 * kTileF) + 1024;

}  // namespace

extern "C" long long fs2_mha_fwd_bf16_plan(int B, int H, int L, int* grid);

// The grid K1 launches for [B, H, L, 128] (written to grid[3]: query tiles,
// B*H, key chunks), with the row statistics (stats != 0) or without, and
// the float32 scratch it needs: 0 without a split, else chunks * B*H*L *
// (128 + 2) floats; of the float32 instance, or with bf16 != 0 of the
// bfloat16 one (attention_bf16.cu, its own tiles and plan, the same with
// and without the statistics).
extern "C" long long fs2_mha_fwd_plan(int B, int H, int L, int bf16,
                                      int stats, int* grid) {
  if (bf16) return fs2_mha_fwd_bf16_plan(B, H, L, grid);
  if (B <= 0 || H <= 0 || L <= 0) return -1;
  int tiles_per_chunk;
  plan(B, H, L, stats != 0, grid, &tiles_per_chunk);
  if (grid[2] == 1) return 0;
  return static_cast<long long>(grid[2]) * B * H * L * (kDh + 2);
}

// q, k, v, out: [B, H, L, 128] float32, contiguous, 16-byte aligned.
// key_pad: [B, L] bytes, nonzero = padded key.  row_max, row_sum:
// [B, H, L] float32, or both null.  scratch: fs2_mha_fwd_plan(B, H, L, 0,
// stats) floats, stats = (row_max != null) (null when that is 0).  scale = 1/sqrt(D), rounded to float by the
// caller as the reference rounds it.  Launches on `stream` (a second,
// combining launch when the keys are split); returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take (or when
// cuTensorMapEncodeTiled is missing or refuses the tensor maps).
extern "C" int fs2_mha_fwd_f32(const void* q, const void* k, const void* v,
                               const void* key_pad, void* out, void* row_max,
                               void* row_sum, void* scratch, int B, int H,
                               int L, int D, float scale, void* stream) {
  if (D != kDh || B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  if ((row_max == nullptr) != (row_sum == nullptr)) return cudaErrorInvalidValue;
  int grid[3], tiles_per_chunk;
  plan(B, H, L, row_max != nullptr, grid, &tiles_per_chunk);
  const bool split = grid[2] > 1;
  if (split && scratch == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tensor_map_rows128_f32(&tq, q, L, B * H, 64) ||
      !tensor_map_rows128_f32(&tk, k, L, B * H, kBN) ||
      !tensor_map_rows128_f32(&tv, v, L, B * H, kBN))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = set_smem_once(
      reinterpret_cast<const void*>(mha_fwd_f32_kernel), kSmemBytes, ready);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long rows = static_cast<long>(B) * H * L;
  float* part_o = split ? static_cast<float*>(scratch) : nullptr;
  float* part_m = split ? part_o + grid[2] * rows * kDh : nullptr;
  float* part_l = split ? part_m + grid[2] * rows : nullptr;
  mha_fwd_f32_kernel<<<dim3(grid[0], grid[1], grid[2]), kThreads,
                       kSmemBytes, st>>>(
      tq, tk, tv, static_cast<const unsigned char*>(key_pad),
      static_cast<float*>(out), static_cast<float*>(row_max),
      static_cast<float*>(row_sum), part_o, part_m, part_l, H, L, scale,
      tiles_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const int warps_per_block = 256 / 32;
  mha_fwd_combine_kernel
      <<<(rows + warps_per_block - 1) / warps_per_block, 256, 0, st>>>(
          part_o, part_m, part_l, grid[2], rows, static_cast<float*>(out),
          static_cast<float*>(row_max), static_cast<float*>(row_sum));
  return cudaGetLastError();
}

// The raw scores S = Q K^T of q, k ([B, H, L, 128] float32, contiguous)
// into s ([B, H, L, L] float32) through K1's routine (route 1), K3b's
// (route 2, K as A) or K3a's (route 3, Q's small parts from registers),
// for the check that the routes agree bit for bit (the score contract,
// attention_f32.cuh).  Not on any path:
// chip_smoke.py calls it.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue.
extern "C" int fs2_mha_scores_f32(const void* q, const void* k, void* s,
                                  int B, int H, int L, int route,
                                  void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || route < 1 || route > 3)
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = set_smem_once(
      reinterpret_cast<const void*>(mha_scores_f32_kernel), kScoresSmem,
      ready);
  if (err != cudaSuccess) return err;
  mha_scores_f32_kernel<<<dim3((L + 63) / 64, (L + kBN - 1) / kBN, B * H),
                          128, kScoresSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(s), L, route);
  return cudaGetLastError();
}

// Resident blocks per SM of K1's main kernel, for the build report; -1 on
// an error.
extern "C" int fs2_mha_fwd_blocks_per_sm() {
  const void* fn = reinterpret_cast<const void*>(mha_fwd_f32_kernel);
  int n = 0;
  if (set_smem(fn, kSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}

// Dynamic shared memory of a block of K1's main kernel, for the build
// report.
extern "C" int fs2_mha_fwd_f32_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}
