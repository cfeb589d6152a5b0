// K3: fused masked multi-head self-attention backward, float32, for sm_90a,
// 3xTF32 on wgmma, the tiles fed by TMA.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_attention.py
// (_mha_bwd_kernel via _pallas_backward_impl), which recomputes the whole
// L x L probability matrix of one (batch, head) in VMEM and forms
//   dV = P^T G,  dP = G V^T,  dS = P o (dP - rowsum(dP o P)) * scale,
//   dQ = dS K,   dK = dS^T Q
// on [B, H, L, Dh] row-major tensors, Dh = 128, with P recomputed as
// softmax(where(pad_key, -1e9, Q K^T * scale)).
//
// What bounds it on an H100: the reference's five L x L x Dh products
// (S recomputed, dP, dV, dK, dQ: 10 L^2 Dh operations per (b, h)), on the
// tensor cores as 3xTF32 (attention_f32.cuh; within ~1e-5 of float32 at
// three TF32 products each), so 3 x 10 L^2 Dh at 495 TFLOP/s, against
// 8 L Dh 4-byte tensors moved: the tensor cores.  This design forms S and
// dP twice (14 L^2 Dh; 0.217 ms at [10, 2, 1000, 128]): the price of
// no L^2-sized scratch and no atomics.
//
// Two launches, no atomics and a fixed order of every sum, so two launches
// on the same inputs give the same bits; the only scratch is D, B*H*L
// floats.  Every row's results depend on that row's (b, h) slice alone,
// whatever B and H are (a data- or tensor-parallel rank's K3 is the
// one-process step's):
//   D    (mha_bwd_rowdot_f32_kernel) D = rowsum(G o O) from K1's float32
//        output, one warp a row (in real arithmetic rowsum(dP o P) =
//        rowsum(G o (P V)) = rowsum(G o O); the two differ only by
//        rounding).
//   then one grid (mha_bwd_f32_kernel) of two kinds of block, K3b's first
//   (the longer ones, started first by the block scheduler) and K3a's
//   after them, so that the two fill the card's waves together (as two
//   launches, each left a partial last wave: [10, 2, 1000] is 320 blocks of
//   each on 132 SMs):
//   K3a  one block per (b, h, 64 query rows), two warpgroups, walking the
//        keys in tiles of 32.  Warpgroup 1 forms dP = G V^T (G's big parts
//        in registers, its small plane in shared memory), dS = P o (dP -
//        D) * scale with P from warpgroup 0, and dQ += dS K: dS's
//        accumulator is the A fragment as it stands, K read from Kt's
//        transposed planes.  Warpgroup 0 holds Q's big and small parts in
//        registers and forms S = Q K^T (score_tile_f32_rr) and P = exp(s -
//        m) * (1 / l) per tile; it also splits every K and V tile where
//        TMA lands it (big part in place, small part beside it), and
//        transposes K into Kt while its own S products run.  K and V come
//        through a two-stage ring; P goes from warpgroup 0 to 1 through
//        two buffers; mbarriers order it all.
//   K3b  one block per (b, h, 64 keys), two warpgroups, walking the query
//        rows in tiles of 32 (dkdv_walk): warpgroup 0 holds K's big parts
//        in registers and forms S^T = K Q^T (score_tile_f32_t, the K-as-A
//        route of the score contract), P^T, and dV += P^T G; warpgroup 1
//        holds V's and forms dP^T = V G^T, dS^T from warpgroup 0's P^T
//        (through shared memory, in accumulator order), and dK += dS^T Q.
//        P^T's and dS^T's accumulators are the A fragments as they stand.
//        Warpgroup 0 splits each query tile's Q into its planes and
//        transposes them into Qt, warpgroup 1 G into Gt, each while its
//        own products run (one group in flight a warpgroup: two made ptxas
//        spill, and it ran slower); a tile's copy lands while the tile
//        before it is worked on.
// tf32 wgmma takes K-major operands only, hence the transposed planes; in
// each, the keys (K3a) or query rows (K3b) of every k-step of 8 come in the
// order 0, 2, 4, 6, 1, 3, 5, 7 (attention_f32.cuh: split_t), the order of
// an accumulator's columns read as an A fragment.  Each block is 256
// threads with up to 225 KB of shared memory, one per SM, so each thread
// may hold 255 registers.
//
// THE SCORE CONTRACT (attention_f32.cuh): K3a's S is K1's routine with Q's
// small parts from registers, K3b's the K-as-A route; both take the same
// products of the same split values in the same order as K1, so every
// score is K1's bit for bit (fs2_mha_scores_f32 shows it on the card), and
// P = exp(s - m) * (1 / l) with the row max m and row sum l K1 wrote and
// K1's expf.  The mask value is the FINITE -1e9 of the reference: a query
// row whose keys are all padded has the uniform P = 1/L, and its gradient
// flows as in the reference; padded tiles are never skipped.  Keys and
// query rows at or past L (the ragged edge) get P = dS = 0 and arrive as
// zeros.
//
// The bfloat16 instance is attention_bwd_bf16.cu (wgmma and TMA); this
// file's fs2_mha_bwd_scratch_floats answers for both.

#include <cuda_runtime.h>

#include "attention_f32.cuh"

namespace {

using namespace fs2_attn;

constexpr int kWG = 128;              // threads of a warpgroup
constexpr int kThreads = 2 * kWG;
constexpr int kRows = 64;             // K3a: query rows; K3b: keys
constexpr int kCols = 32;             // K3a: keys per tile; K3b: query rows
constexpr int kAcc = kRows * kCols;   // floats of an m64n32 accumulator
constexpr int kWG0Barrier = 1;        // named barrier of warpgroup 0 alone

// one [rows][128] tile of a tensor map of boxes of `rows` rows by 32 floats
// into dst (four boxes of box floats)
__device__ __forceinline__ void load_rows(float* dst, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh,
                                          int box) {
#pragma unroll
  for (int bx = 0; bx < 4; ++bx)
    tma_load_3d(dst + bx * box, map, bar, 32 * bx, r0, bh);
}

// a warp's arrival at an mbarrier counting warps: its lanes' earlier
// writes ordered before lane 0's arrival
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ---- K3a: D and dQ per 64 query rows -----------------------------------------

struct DqSmem {
  float g[4 * kQBox];         // G as loaded, then its small plane in place
  float kt[2 * kTileF];       // Kt [128][32]: big, small; Q lands here first
  float k[2][kTileF];         // per stage: K as loaded, then its big plane
  float ks[2][kTileF];        // K's small plane
  float v[2][kTileF];         // V as loaded, then its big plane
  float vs[2][kTileF];        // V's small plane
  float p[2][kAcc];           // P, warpgroup 0 to 1, in accumulator order
  uint64_t full_qg;
  uint64_t kv_full[2];        // a K and V tile landed
  uint64_t kv_empty[2];       // ... read by S, Kt's transpose and dP
  uint64_t v_ready[2];        // ... split (warpgroup 0 to 1)
  uint64_t kt_ready;          // Kt written (warpgroup 0 to 1)
  uint64_t kt_free;           // Kt read by dQ (warpgroup 1 to 0)
  uint64_t p_full[2];
  uint64_t p_empty[2];
};
constexpr size_t kDqSmemBytes = sizeof(DqSmem) + 1024;

// the producer's step (thread 0): key tile kt into stage kt % 2, once the
// tile two before it has been read
__device__ __forceinline__ void load_kv(DqSmem& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int kt,
                                        int bh) {
  const int s = kt & 1;
  mbar_wait(&sm.kv_empty[s], ((kt >> 1) & 1) ^ 1);
  mbar_expect_tx(&sm.kv_full[s], 2 * kTileF * sizeof(float));
  load_rows(sm.k[s], tk, &sm.kv_full[s], kt * kCols, bh, kKBox);
  load_rows(sm.v[s], tv, &sm.kv_full[s], kt * kCols, bh, kKBox);
}

// D = rowsum(G o O): one warp per row, each lane its four columns 4 lane ..
// (fma in order), then a butterfly over the warp
__global__ void __launch_bounds__(256)
mha_bwd_rowdot_f32_kernel(const float* __restrict__ g,
                          const float* __restrict__ o, float* __restrict__ D,
                          long rows) {
  const long row = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x)
                   / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;   // warp-uniform
  const float4 a = reinterpret_cast<const float4*>(g + row * kDh)[lane];
  const float4 b = reinterpret_cast<const float4*>(o + row * kDh)[lane];
  float acc = a.x * b.x;
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[row] = acc;
}

// K3a's block: dQ of query rows 64 qt .. of (b, h) = bh
__device__ __forceinline__ void dq_block(
    DqSmem& sm, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tg,
    const unsigned char* __restrict__ key_pad,
    const float* __restrict__ row_max, const float* __restrict__ row_sum,
    const float* __restrict__ Drow, float* __restrict__ dq, int H, int L,
    float scale, int qt, int bh) {
  const int b = bh / H;
  const int n = (L + kCols - 1) / kCols;
  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int wtid = tid % kWG;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const int q0 = qt * kRows;
  const size_t rbase = static_cast<size_t>(bh) * L;

  if (tid == 0) {
    mbar_init(&sm.full_qg, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.kv_empty[s], 8);   // the warps of both warpgroups
      mbar_init(&sm.v_ready[s], 4);
      mbar_init(&sm.p_full[s], 4);
      mbar_init(&sm.p_empty[s], 4);
    }
    mbar_init(&sm.kt_ready, 4);
    mbar_init(&sm.kt_free, 4);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.full_qg, 2 * 4 * kQBox * sizeof(float));
    load_rows(sm.kt, tq, &sm.full_qg, q0, bh, kQBox);
    load_rows(sm.g, tg, &sm.full_qg, q0, bh, kQBox);
    load_kv(sm, tk, tv, 0, bh);
  }
  __syncwarp();

  if (wg == 0) {
    // ---- warpgroup 0: S, P; splits K and V, transposes K ----
    float m[2], inv_l[2];   // rows 16 warp + gq + 8 h (0 and 0 past L)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + 16 * warp + gq + 8 * h;
      m[h] = r < L ? row_max[rbase + r] : 0.f;
      inv_l[h] = r < L ? 1.f / row_sum[rbase + r] : 0.f;
    }
    const unsigned char* pad = key_pad + static_cast<size_t>(b) * L;
    uint32_t qb[16][4], qs[16][4];
    mbar_wait(&sm.full_qg, 0);
    split_q_regs(sm.kt, warp, lane, qb, qs);
    named_barrier(kWG0Barrier, kWG);   // Q read before Kt is written
    uint32_t f = pad_byte(pad, 0, L, lane);
    float x[16];
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int s = i & 1;
      const int k0 = i * kCols;
      if (tid == 0 && i + 1 < n) load_kv(sm, tk, tv, i + 1, bh);
      const uint32_t f_next = pad_byte(pad, k0 + kCols, L, lane);
      mbar_wait(&sm.kv_full[s], (i >> 1) & 1);
      split_kv<kWG>(sm.k[s], sm.ks[s], nullptr, nullptr, wtid);
      split_kv<kWG>(sm.v[s], sm.vs[s], nullptr, nullptr, wtid);
      fence_proxy_async();
      warp_arrive(&sm.v_ready[s], lane);
      named_barrier(kWG0Barrier, kWG);   // K's planes whole
      reg_fence(x);
      wgmma_fence();
      score_tile_f32_rr(x, qb, qs, sm.k[s], sm.ks[s]);
      wgmma_commit();
      // Kt while S runs, once dQ has read the previous one
      mbar_wait(&sm.kt_free, (i & 1) ^ 1);
      transpose_planes<kWG>(sm.k[s], sm.ks[s], sm.kt, wtid);
      fence_proxy_async();
      warp_arrive(&sm.kt_ready, lane);
      wgmma_wait<0>();
      reg_fence(x);
      warp_arrive(&sm.kv_empty[s], lane);
      tile_scores32(x, f, k0, L, t, scale);
      f = f_next;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int h = (e / 2) % 2;
        x[e] = expf(x[e] - m[h]) * inv_l[h];
      }
      const int pb = i & 1;
      mbar_wait(&sm.p_empty[pb], ((i >> 1) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 16; ++e) sm.p[pb][e * kWG + wtid] = x[e];
      warp_arrive(&sm.p_full[pb], lane);
    }
    return;
  }

  // ---- warpgroup 1: dP, dS and dQ ----
  float D[2];   // rows 16 warp + gq + 8 h (0 past L)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + gq + 8 * h;
    D[h] = r < L ? Drow[rbase + r] : 0.f;
  }
  uint32_t gb[16][4];
  mbar_wait(&sm.full_qg, 0);
  split_q(sm.g, warp, lane, gb);
  fence_proxy_async();
  named_barrier(kWG0Barrier + 1, kWG);   // G's small plane whole
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float dp[16];
  uint32_t ab[4][4], as[4][4];
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int s = i & 1;
    mbar_wait(&sm.v_ready[s], (i >> 1) & 1);
    reg_fence(dp);
    wgmma_fence();
    score_tile_f32(dp, gb, sm.g, sm.v[s], sm.vs[s]);   // dP = G V^T
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dp);
    warp_arrive(&sm.kv_empty[s], lane);
    const int pb = i & 1;
    mbar_wait(&sm.p_full[pb], (i >> 1) & 1);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float p = sm.p[pb][e * kWG + wtid];
      dp[e] = p * (dp[e] - D[(e / 2) % 2]) * scale;
    }
    warp_arrive(&sm.p_empty[pb], lane);
    acc_to_a(dp, ab, as);
    mbar_wait(&sm.kt_ready, i & 1);
    reg_fence(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(ab[j]);
      reg_fence(as[j]);
    }
    wgmma_fence();
    product_t(o, ab, as, sm.kt);   // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(ab[j]);
      reg_fence(as[j]);
    }
    warp_arrive(&sm.kt_free, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + gq + 8 * h;
    if (r >= L) continue;
    float* op = dq + (rbase + r) * kDh + 2 * t;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      store2(op + 8 * c, o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
  }
}

// ---- K3b: dV and dK per 64 keys ---------------------------------------------

struct DkdvSmem {
  float k[4 * kQBox];     // K as loaded, then its small plane in place
  float v[4 * kQBox];     // V likewise
  float qraw[kTileF];     // a query tile's Q as TMA lands it
  float graw[kTileF];     // ... and its G
  float q[kTileF];        // Q's big plane
  float qs[kTileF];       // Q's small plane; then P^T, warpgroup 0 to 1
  float g[kTileF];        // G's big plane
  float gs[kTileF];       // G's small plane
  float qt[2 * kTileF];   // Qt [128][32]: big, small
  float gt[2 * kTileF];   // Gt
  uint64_t full_kv;
  uint64_t q_full;        // a query tile's Q landed (G: g_full)
  uint64_t g_full;
  uint64_t qt_ready;      // Qt written (warpgroup 0 to 1)
  uint64_t qt_free;       // ... read by dK (1 to 0)
  uint64_t gt_ready;      // Gt written (1 to 0)
  uint64_t gt_free;       // ... read by dV (0 to 1)
  uint64_t p_full;        // P^T written into qs (0 to 1)
  uint64_t p_empty;       // ... read (1 to 0)
};
constexpr size_t kKvSmemBytes = sizeof(DkdvSmem) + 1024;

// Each warpgroup's walk over the query tiles.  Warpgroup 0 (kG = false)
// splits Q and transposes it into Qt, forms S^T = K Q^T and P^T, and
// accumulates dV += P^T G; warpgroup 1 (kG = true) splits G and transposes
// it into Gt, forms dP^T = V G^T and dS^T from warpgroup 0's P^T, and
// accumulates dK += dS^T Q.  Per tile i each issues its S^T (dP^T) and
// transposes the tile's planes while it runs, forms P^T (dS^T), issues
// its product and splits tile i + 1 (whose copy landed during tile i)
// while that runs; then the copy of tile i + 2 starts.  One group of
// products in flight a warpgroup at a time (the other warpgroup's fill
// the tensor cores meanwhile): two, each over the other's registers, made
// ptxas spill.  Qt, Gt and P^T pass between the warpgroups through
// mbarriers, each completing one phase a tile.
template <bool kG>
__device__ __forceinline__ void dkdv_walk(
    DkdvSmem& sm, const CUtensorMap* traw, const uint32_t (&ab)[16][4],
    const bool (&key_ok)[2], const bool (&key_padded)[2],
    const float* __restrict__ row_max, const float* __restrict__ row_sum,
    const float* __restrict__ Drow, float* __restrict__ dst, int L,
    float scale, int k0, int bh) {
  const int n = (L + kCols - 1) / kCols;
  const int wtid = threadIdx.x % kWG;
  const int warp = wtid / 32;
  const int lane = wtid % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const size_t rbase = static_cast<size_t>(bh) * L;
  const int barrier = kWG0Barrier + (kG ? 1 : 0);
  float* raw = kG ? sm.graw : sm.qraw;      // this warpgroup's tensor
  float* big = kG ? sm.g : sm.q;
  float* small = kG ? sm.gs : sm.qs;
  float* mine_t = kG ? sm.gt : sm.qt;       // ... transposed
  const float* other_t = kG ? sm.qt : sm.gt;   // the other's, its B operand
  const float* a_small = kG ? sm.v : sm.k;  // its A's small plane
  uint64_t* full = kG ? &sm.g_full : &sm.q_full;
  uint64_t* mine_ready = kG ? &sm.gt_ready : &sm.qt_ready;
  uint64_t* mine_free = kG ? &sm.gt_free : &sm.qt_free;
  uint64_t* other_ready = kG ? &sm.qt_ready : &sm.gt_ready;
  uint64_t* other_free = kG ? &sm.qt_free : &sm.gt_free;
  auto copy = [&](int tile) {   // thread 0 of the warpgroup
    mbar_expect_tx(full, kTileF * sizeof(float));
    load_rows(raw, traw, full, tile * kCols, bh, kKBox);
  };

  // tile 0 split; tile 1 on its way
  mbar_wait(full, 0);
  split_planes<kWG>(raw, big, small, wtid);
  fence_proxy_async();
  named_barrier(barrier, kWG);
  if (wtid == 0 && n > 1) copy(1);
  __syncwarp();

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  float x[16];
  uint32_t pb[4][4], ps[4][4];
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int q0 = i * kCols;
    // S^T (dP^T) of tile i
    reg_fence(x);
    wgmma_fence();
    score_tile_f32_t(x, ab, a_small, big, small);
    wgmma_commit();
    // this tile's transposed planes while it runs, once the other
    // warpgroup's product of tile i - 1 has read the previous ones
    mbar_wait(mine_free, (i & 1) ^ 1);
    transpose_planes<kWG>(big, small, mine_t, wtid);
    fence_proxy_async();
    warp_arrive(mine_ready, lane);
    // this thread's query rows q0 + 8 j + 2 t + e (x[4j + 2h + e]) and
    // their statistics: m and l (warpgroup 0; 0 and 0 past L) or D
    float st0[8], st1[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = q0 + 8 * j + 2 * t + e;
        const bool ok = r < L;
        st0[2 * j + e] = ok ? (kG ? Drow : row_max)[rbase + r] : 0.f;
        st1[2 * j + e] = ok && !kG ? row_sum[rbase + r] : 0.f;
      }
    wgmma_wait<0>();
    reg_fence(x);
    named_barrier(barrier, kWG);   // the planes read: free for P^T, tile i + 1
    if (!kG) {
      // P^T: key rows, query columns; 0 for a key at or past L
#pragma unroll
      for (int c = 0; c < 8; ++c) st1[c] = st1[c] > 0.f ? 1.f / st1[c] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int a = 4 * j + 2 * h + e, c = 2 * j + e;
            x[a] = key_ok[h] ? expf(masked_score(x[a], key_padded[h],
                                                 scale) -
                                    st0[c]) *
                                   st1[c]
                             : 0.f;
          }
      // to warpgroup 1 through Q's small plane (read by S^T and the
      // transpose, both done)
#pragma unroll
      for (int e = 0; e < 16; ++e) sm.qs[e * kWG + wtid] = x[e];
      warp_arrive(&sm.p_full, lane);
    } else {
      mbar_wait(&sm.p_full, i & 1);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float p = sm.qs[e * kWG + wtid];
        x[e] = p * (x[e] - st0[2 * (e / 4) + e % 2]) * scale;
      }
      warp_arrive(&sm.p_empty, lane);
    }
    acc_to_a(x, pb, ps);
    // the product of tile i: dV += P^T G (Gt), dK += dS^T Q (Qt)
    mbar_wait(other_ready, i & 1);
    reg_fence(acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(pb[j]);
      reg_fence(ps[j]);
    }
    wgmma_fence();
    product_t(acc, pb, ps, other_t);
    wgmma_commit();
    // tile i + 1's split while it runs (its copy landed during this tile;
    // Q's small plane once P^T is read), then the copy of tile i + 2
    if (i + 1 < n) {
      if (!kG) mbar_wait(&sm.p_empty, i & 1);
      mbar_wait(full, (i + 1) & 1);
      split_planes<kWG>(raw, big, small, wtid);
      fence_proxy_async();
    }
    named_barrier(barrier, kWG);
    if (wtid == 0 && i + 2 < n) copy(i + 2);
    __syncwarp();
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      reg_fence(pb[j]);
      reg_fence(ps[j]);
    }
    warp_arrive(other_free, lane);   // Gt (Qt) read
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + gq + 8 * h;
    if (key >= L) continue;
    float* op = dst + (rbase + key) * kDh + 2 * t;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      store2(op + 8 * c, acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
}

// K3b's block: dK and dV of keys 64 kt .. of (b, h) = bh
__device__ __forceinline__ void dkdv_block(
    DkdvSmem& sm, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tg,
    const unsigned char* __restrict__ key_pad,
    const float* __restrict__ row_max, const float* __restrict__ row_sum,
    const float* __restrict__ Drow, float* __restrict__ dk,
    float* __restrict__ dv, int H, int L, float scale, int kt, int bh) {
  const int b = bh / H;
  const int k0 = kt * kRows;
  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int warp = (tid % kWG) / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;

  if (tid == 0) {
    mbar_init(&sm.full_kv, 1);
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.g_full, 1);
    mbar_init(&sm.qt_ready, 4);
    mbar_init(&sm.qt_free, 4);
    mbar_init(&sm.gt_ready, 4);
    mbar_init(&sm.gt_free, 4);
    mbar_init(&sm.p_full, 4);
    mbar_init(&sm.p_empty, 4);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.full_kv, 2 * 4 * kQBox * sizeof(float));
    load_rows(sm.k, tk, &sm.full_kv, k0, bh, kQBox);
    load_rows(sm.v, tv, &sm.full_kv, k0, bh, kQBox);
    mbar_expect_tx(&sm.q_full, kTileF * sizeof(float));
    mbar_expect_tx(&sm.g_full, kTileF * sizeof(float));
    load_rows(sm.qraw, tq, &sm.q_full, 0, bh, kKBox);
    load_rows(sm.graw, tg, &sm.g_full, 0, bh, kKBox);
  }
  __syncwarp();

  // this thread's keys 16 warp + gq + 8 h: below L, padded
  bool key_ok[2], key_padded[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + gq + 8 * h;
    key_ok[h] = key < L;
    key_padded[h] =
        key_ok[h] && key_pad[static_cast<size_t>(b) * L + key] != 0;
  }
  // K's (warpgroup 0) or V's (1) big parts as A fragments, small plane in
  // place
  uint32_t ab[16][4];
  mbar_wait(&sm.full_kv, 0);
  split_q(wg == 0 ? sm.k : sm.v, warp, lane, ab);
  fence_proxy_async();
  if (wg == 0)
    dkdv_walk<false>(sm, tq, ab, key_ok, key_padded, row_max, row_sum, Drow,
                     dv, L, scale, k0, bh);
  else
    dkdv_walk<true>(sm, tg, ab, key_ok, key_padded, row_max, row_sum, Drow,
                    dk, L, scale, k0, bh);
}

constexpr size_t kSmemBytes =
    kDqSmemBytes > kKvSmemBytes ? kDqSmemBytes : kKvSmemBytes;

// K3a's and K3b's blocks in one grid of (L / 64 tiles, 2 B*H): the first
// B*H rows K3b's (the longer ones, so that the block scheduler starts them
// first), then K3a's
__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_f32_kernel(const __grid_constant__ CUtensorMap tq64,
                   const __grid_constant__ CUtensorMap tk32,
                   const __grid_constant__ CUtensorMap tv32,
                   const __grid_constant__ CUtensorMap tg64,
                   const __grid_constant__ CUtensorMap tq32,
                   const __grid_constant__ CUtensorMap tk64,
                   const __grid_constant__ CUtensorMap tv64,
                   const __grid_constant__ CUtensorMap tg32,
                   const unsigned char* __restrict__ key_pad,
                   const float* __restrict__ row_max,
                   const float* __restrict__ row_sum,
                   const float* __restrict__ Drow, float* __restrict__ dq,
                   float* __restrict__ dk, float* __restrict__ dv, int H,
                   int L, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_smem(smem_raw);
  const int heads = gridDim.y / 2;
  if (static_cast<int>(blockIdx.y) < heads)
    dkdv_block(*reinterpret_cast<DkdvSmem*>(base), &tq32, &tk64, &tv64,
               &tg32, key_pad, row_max, row_sum, Drow, dk, dv, H, L, scale,
               blockIdx.x, blockIdx.y);
  else
    dq_block(*reinterpret_cast<DqSmem*>(base), &tq64, &tk32, &tv32, &tg64,
             key_pad, row_max, row_sum, Drow, dq, H, L, scale, blockIdx.x,
             blockIdx.y - heads);
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  int n = 0;
  if (set_smem(fn, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" long long fs2_mha_bwd_bf16_scratch_floats(int B, int H, int L);

// The float32 scratch fs2_mha_bwd_f32 needs for [B, H, L, 128]: D, one
// float per query row (B*H*L); with bf16 != 0 what fs2_mha_bwd_bf16 needs
// (attention_bwd_bf16.cu: the same).
extern "C" long long fs2_mha_bwd_scratch_floats(int B, int H, int L,
                                                int bf16) {
  if (bf16) return fs2_mha_bwd_bf16_scratch_floats(B, H, L);
  if (B <= 0 || H <= 0 || L <= 0) return -1;
  return static_cast<long long>(B) * H * L;
}

// q, k, v, out (K1's output), g (the incoming gradient), dq, dk, dv:
// [B, H, L, 128] float32, contiguous, 16-byte aligned.  key_pad: [B, L]
// bytes, nonzero = padded key.  row_max, row_sum: [B, H, L] from K1.
// scratch: fs2_mha_bwd_scratch_floats(B, H, L, 0) floats, written.  scale
// = 1/sqrt(D) as float.  Two launches on `stream` (D, then K3a's and K3b's
// blocks); returns the first CUDA error, or cudaErrorInvalidValue for a
// shape the kernels do not take (or a driver without tensor maps).
extern "C" int fs2_mha_bwd_f32(const void* q, const void* k, const void* v,
                               const void* key_pad, const void* out,
                               const void* row_max, const void* row_sum,
                               const void* g, void* dq, void* dk, void* dv,
                               void* scratch, int B, int H, int L, int D,
                               float scale, void* stream) {
  if (D != kDh || B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  CUtensorMap tq64, tg64, tk32, tv32, tq32, tg32, tk64, tv64;
  const int heads = B * H;
  if (!tensor_map_rows128_f32(&tq64, q, L, heads, kRows) ||
      !tensor_map_rows128_f32(&tg64, g, L, heads, kRows) ||
      !tensor_map_rows128_f32(&tk32, k, L, heads, kCols) ||
      !tensor_map_rows128_f32(&tv32, v, L, heads, kCols) ||
      !tensor_map_rows128_f32(&tq32, q, L, heads, kCols) ||
      !tensor_map_rows128_f32(&tg32, g, L, heads, kCols) ||
      !tensor_map_rows128_f32(&tk64, k, L, heads, kRows) ||
      !tensor_map_rows128_f32(&tv64, v, L, heads, kRows))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = set_smem_once(
      reinterpret_cast<const void*>(mha_bwd_f32_kernel), kSmemBytes, ready);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* Df = static_cast<float*>(scratch);
  const long rows = static_cast<long>(heads) * L;
  mha_bwd_rowdot_f32_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(out), Df,
      rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mha_bwd_f32_kernel<<<dim3((L + kRows - 1) / kRows, 2 * heads), kThreads,
                       kSmemBytes, st>>>(
      tq64, tk32, tv32, tg64, tq32, tk64, tv64, tg32,
      static_cast<const unsigned char*>(key_pad),
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum),
      Df, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), H, L, scale);
  return cudaGetLastError();
}

// Resident blocks per SM of the float32 K3's main kernel, for the build
// report; -1 on an error.
extern "C" int fs2_mha_bwd_blocks_per_sm() {
  return blocks_per_sm(mha_bwd_f32_kernel, kSmemBytes);
}

// Dynamic shared memory of a block of the float32 K3's main kernel, for the
// build report.
extern "C" int fs2_mha_bwd_f32_smem_bytes() {
  return static_cast<int>(kSmemBytes);
}
