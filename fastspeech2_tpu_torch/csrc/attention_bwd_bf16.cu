// K3, bfloat16: fused masked multi-head self-attention backward for sm_90a,
// on wgmma and TMA.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_attention.py
// (_mha_bwd_kernel via _pallas_backward_impl) at --dtype bfloat16, and
// computes what it computes on bfloat16 q, k, v and g ([B, H, L, 128]
// row-major): P recomputed in float32, then
//   dV = P^T G,  dP = G V^T,  dS = P o (dP - rowsum(dP o P)) * scale,
//   dQ = dS K,   dK = dS^T Q,
// every product in float32 from the upcast operands, dq, dk and dv rounded
// to bfloat16.  D = rowsum(dP o P) is the TPU kernel's, over all keys with
// float32 P, and not rowsum(G o O) from K1's output: that output is rounded
// to bfloat16 and formed from a rounded P, and the error it puts into D
// reached ~0.8 of an ulp of bfloat16 at the largest |dq| on peaked
// attention (a float64 model of the two at L = 512).
//
// THE SCORE CONTRACT: S and dP come from score_tile_wgmma
// (attention_bf16.cuh) with Q (or G) as A and K (or V) as B, as K1 forms S,
// and tile_scores, so every score is K1's bit for bit; P = exp(s - m) / l
// with the row max m and row sum l K1 wrote and K1's exponential
// (exp_shifted).  The mask value is the finite -1e9 of the
// reference (a fully padded row has the uniform P = 1/L); padded tiles are
// never skipped; keys and query rows at or past L (the ragged edge) get
// P = dS = 0 and arrive as zeros.
//
// The products with P and dS: the TPU kernel multiplies float32 p and ds
// (pallas_attention.py:158-172), so each such product is float32-accurate:
// P and dS are split into three bfloat16 parts, hi + mid + lo exactly
// (attention_bf16.cuh: split3), each times the exact bfloat16 G, Q or K on
// the bfloat16 tensor cores, accumulated in float32 (lo, mid, hi).
//
// What bounds it on an H100: S and dP, 4 L^2 Dh operations per (b, h), as
// single bfloat16 products, and dV, dK and dQ, 6 L^2 Dh, as three each,
// all at 989 TFLOP/s (cheaper than two TF32 passes at 495), against 7 L Dh
// 2-byte tensors: the tensor cores.
//
// Two launches, no atomics and a fixed order of every sum, so two launches
// on the same inputs give the same bits; the only scratch is D (B*H*L
// floats):
//   K3a  (mha_bwd_dq_bf16_kernel) one block per (b, h, 128 query rows), two
//        warpgroups of 64 rows taking turns at the tensor cores
//        (attention_bf16.cuh: turn_wait); Q and G loaded once by TMA, K and
//        V tiles of 64 keys through a four-stage ring, walked twice.  The
//        first walk forms S and dP and sums D over all keys; the second
//        forms them again and dQ += dS K, dS's three parts as the A operand
//        from registers and K read MN-major from shared memory
//        (m64n128k16).  D goes to scratch, dq to its output.
//   K3b  (mha_bwd_dkdv_bf16_kernel) one block per (b, h, 64 keys); K and V
//        loaded once, 64-row tiles of Q and G through a three-stage ring.
//        Warpgroup 0 forms S and P, writes P's three parts to shared memory
//        in the 128-byte swizzle (two tiles' buffers, mbarriers hand them
//        over) and accumulates dV += P^T G; warpgroup 1 forms dP, reads P
//        back from its parts (their sum is P exactly), writes dS's parts
//        and accumulates dK += dS^T Q (m64n128k16, P^T and dS^T read
//        MN-major as A, G and Q MN-major as B).  Each keeps one 64 x 128
//        accumulator; each issues its next tile's S (or dP) beside this
//        tile's product.
// In both one elected thread issues the copies, refilling a stage as soon
// as both warpgroups release it; a block is 256 threads, one per SM (shared
// memory), so each thread may hold 255 registers (a producer warp beside
// them would cap them at 168).  P = exp(s - m) * (1/l): one multiply where
// the formula divides (a float32 rounding, far below bfloat16's; an IEEE
// division is a dozen instructions a score).  S and dP are
// formed three times (14 L^2 Dh operations where the formula needs 10) and
// no L^2-sized array is ever written: the price of no dQ scratch and no
// atomics.

#include <cuda_runtime.h>

#include "attention_bf16.cuh"

namespace {

using namespace fs2_attn;

constexpr int kBM = 64;   // query rows per warpgroup (K3a) and per tile (K3b)
constexpr int kBN = 64;   // keys per tile (K3a) and per warpgroup (K3b)
constexpr int kWGs = 2;
constexpr int kThreads = 128 * kWGs;
constexpr int kWG = 128;

__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh) {
  tma_load_3d(dst, map, bar, 0, r0, bh);
  tma_load_3d(dst + kBoxElems, map, bar, kBox, r0, bh);
}

// a query row's statistics from K1: its max and 1/sum (0 past L, so that
// P = 0 there)
__device__ __forceinline__ void row_stats(const float* row_max,
                                          const float* row_sum, size_t row,
                                          bool ok, float* m, float* inv_l) {
  *m = ok ? row_max[row] : 0.f;
  *inv_l = ok ? 1.f / row_sum[row] : 0.f;
}

// ---- K3a: D and dQ per 128 query rows ---------------------------------------

constexpr int kDqStages = 4;

struct DqSmem {
  bf16 q[kWGs][2 * kBoxElems];
  bf16 g[kWGs][2 * kBoxElems];
  bf16 k[kDqStages][2 * kBoxElems];
  bf16 v[kDqStages][2 * kBoxElems];
  uint64_t full_qg;
  uint64_t full_kv[kDqStages];
  uint64_t empty[kDqStages];
};
constexpr size_t kDqSmemBytes = sizeof(DqSmem) + 1024;

// the producer's step: the i-th of the two walks' 2 n tiles (key tile
// i % n) into stage i % kDqStages once its previous tile is released
__device__ __forceinline__ void load_kv(DqSmem& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int i, int n,
                                        int bh) {
  const int s = i % kDqStages;
  mbar_wait(&sm.empty[s], ((i / kDqStages) & 1) ^ 1);
  mbar_expect_tx(&sm.full_kv[s], 2 * kTileBytes);
  load_tile(sm.k[s], tk, &sm.full_kv[s], (i % n) * kBN, bh);
  load_tile(sm.v[s], tv, &sm.full_kv[s], (i % n) * kBN, bh);
}

__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tg,
                       const unsigned char* __restrict__ key_pad,
                       const float* __restrict__ row_max,
                       const float* __restrict__ row_sum,
                       float* __restrict__ Drow, bf16* __restrict__ dq,
                       int H, int L, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align_smem(smem_raw));

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int n = (L + kBN - 1) / kBN;
  const int tid = threadIdx.x;
  const int wg = tid / kWG;
  const int warp = (tid % kWG) / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const int q0 = blockIdx.x * kWGs * kBM + wg * kBM;   // this WG's rows
  const unsigned char* pad = key_pad + static_cast<size_t>(b) * L;
  const size_t rbase = static_cast<size_t>(bh) * L;

  if (tid == 0) {
    mbar_init(&sm.full_qg, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&sm.full_kv[s], 1);
      mbar_init(&sm.empty[s], kThreads / 32);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {   // the producer's first steps
    mbar_expect_tx(&sm.full_qg, 2 * kWGs * kTileBytes);
    for (int w = 0; w < kWGs; ++w) {
      const int r0 = blockIdx.x * kWGs * kBM + w * kBM;
      load_tile(sm.q[w], &tq, &sm.full_qg, r0, bh);
      load_tile(sm.g[w], &tg, &sm.full_qg, r0, bh);
    }
    for (int i = 0; i < min(2 * n, kDqStages); ++i)
      load_kv(sm, &tk, &tv, i, n, bh);
  }
  __syncwarp();

  // rows gq and gq + 8 of the warp's 16
  float m[2], inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + gq + 8 * h;
    row_stats(row_max, row_sum, rbase + r, r < L, &m[h], &inv_l[h]);
  }
  mbar_wait(&sm.full_qg, 0);

  // ring index j: the walks' 2 n tiles in order (key tile j % n); the
  // producer refills the stage of j - 1 once this warpgroup has released j
  auto wait_kv = [&](int j) {
    mbar_wait(&sm.full_kv[j % kDqStages], (j / kDqStages) & 1);
  };
  auto release = [&](int j) {
    if (lane == 0) mbar_arrive(&sm.empty[j % kDqStages]);
    if (tid == 0 && j >= 1 && j - 1 + kDqStages < 2 * n)
      load_kv(sm, &tk, &tv, j - 1 + kDqStages, n, bh);
    __syncwarp();
  };
  // S and dP of ring index j into (sc, dp), as one group (every register
  // a product touches is tied to a point before its fence, so that the
  // compiler moves no write of one past it: ptxas would serialise)
  auto issue_sdp = [&](float(&sc)[32], float(&dp)[32], int j) {
    const int s = j % kDqStages;
    reg_fence(sc);
    reg_fence(dp);
    wgmma_fence();
    score_tile_wgmma(sc, sm.q[wg], sm.k[s]);
    score_tile_wgmma(dp, sm.g[wg], sm.v[s]);
    wgmma_commit();
  };

  turn_first(wg);
  // walk 1: D = rowsum(dP o P) over all keys, float32 P (one tile's
  // products at a time: a walk that reads one tile's accumulators while the
  // next tile's are in flight made ptxas serialise every product of the
  // kernel, walk 2's with them)
  float acc[2] = {0.f, 0.f};
  float sa[32], da[32];
  TilePad next_pad = tile_pad(pad, 0, L, lane);
  for (int it = 0; it < n; ++it) {
    wait_kv(it);
    turn_wait(wg);
    issue_sdp(sa, da, it);
    turn_pass(wg);
    uint64_t valid, padded;
    tile_mask(next_pad, it * kBN, L, &valid, &padded);
    next_pad = tile_pad(pad, ((it + 1) % n) * kBN, L, lane);
    wgmma_wait<0>();
    reg_fence(sa);
    reg_fence(da);
    release(it);
    tile_scores(sa, valid, padded, t, scale);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      acc[h] += da[i] * (exp_shifted(sa[i] - m[h]) * inv_l[h]);
    }
  }
  float D[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    D[h] = quad_sum(acc[h]);
    const int r = q0 + 16 * warp + gq + 8 * h;
    if (r < L && t == 0) Drow[rbase + r] = D[h];
  }

  // walk 2: dQ = sum over key tiles of dS K, in the order 0, 1, ..., one
  // tile's products at a time (see walk 1)
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  uint32_t a[4][3][4];   // dS's three parts as A fragments (lo, mid, hi)
  for (int it = 0; it < n; ++it) {
    const int j = n + it;
    wait_kv(j);
    turn_wait(wg);
    issue_sdp(sa, da, j);
    turn_pass(wg);
    uint64_t valid, padded;
    tile_mask(next_pad, it * kBN, L, &valid, &padded);
    next_pad = tile_pad(pad, (it + 1) * kBN, L, lane);
    wgmma_wait<0>();
    reg_fence(sa);
    reg_fence(da);
    tile_scores(sa, valid, padded, t, scale);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      const float p = exp_shifted(sa[i] - m[h]) * inv_l[h];
      da[i] = p * (da[i] - D[h]) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(da[8 * kk + 2 * r], da[8 * kk + 2 * r + 1], a[kk][2][r],
               a[kk][1][r], a[kk][0][r]);
    turn_wait(wg);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int part = 0; part < 3; ++part) reg_fence(a[kk][part]);
    reg_fence(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int part = 0; part < 3; ++part)
        wgmma_64x128_rs<1>(o, a[kk][part],
                           mn_major_desc(sm.k[j % kDqStages], kk), 1);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    reg_fence(o);
    release(j);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + gq + 8 * h;
    if (r >= L) continue;
    bf16* op = dq + (rbase + r) * kDh + 2 * t;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      store2(op + 8 * c, o[4 * c + 2 * h], o[4 * c + 2 * h + 1]);
  }
}

// ---- K3b: dV and dK per 64 keys ---------------------------------------------

constexpr int kKvStages = 3;

struct DkdvSmem {
  bf16 k[2 * kBoxElems];           // the block's 64 keys
  bf16 v[2 * kBoxElems];
  bf16 q[kKvStages][2 * kBoxElems];
  bf16 g[kKvStages][2 * kBoxElems];
  bf16 p[2][3][kBoxElems];         // P's parts, [query][key], swizzled, of
                                   // two tiles in turn
  bf16 ds[2][3][kBoxElems];        // dS's parts, the same
  uint64_t full_kv;
  uint64_t full_qg[kKvStages];
  uint64_t empty[kKvStages];
  uint64_t p_full[2];
  uint64_t p_empty[2];
};
constexpr size_t kKvSmemBytes = sizeof(DkdvSmem) + 1024;

// byte offset of (row r, column c, c even) in a 64 x 64 box
__device__ __forceinline__ uint32_t box_offset(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// the sum of three parts as split3 made them: (x0, x1) again, exactly
__device__ __forceinline__ float2 join3(uint32_t hi, uint32_t mid,
                                        uint32_t lo) {
  const float2 h = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&hi));
  const float2 m = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&mid));
  const float2 l = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return make_float2((h.x + m.x) + l.x, (h.y + m.y) + l.y);
}

// stores the pair (x0, x1) of (query row r, keys c, c + 1) as its three
// parts into the part boxes at parts
__device__ __forceinline__ void store_parts(bf16 (*parts)[kBoxElems], int r,
                                            int c, float x0, float x1) {
  uint32_t hi, mid, lo;
  split3(x0, x1, hi, mid, lo);
  const uint32_t off = box_offset(r, c);
  unsigned char* base = reinterpret_cast<unsigned char*>(parts);
  *reinterpret_cast<uint32_t*>(base + 0 * kBoxBytes + off) = hi;
  *reinterpret_cast<uint32_t*>(base + 1 * kBoxBytes + off) = mid;
  *reinterpret_cast<uint32_t*>(base + 2 * kBoxBytes + off) = lo;
}

__device__ __forceinline__ float2 load_parts(bf16 (*parts)[kBoxElems], int r,
                                             int c) {
  const uint32_t off = box_offset(r, c);
  const unsigned char* base = reinterpret_cast<const unsigned char*>(parts);
  return join3(*reinterpret_cast<const uint32_t*>(base + off),
               *reinterpret_cast<const uint32_t*>(base + kBoxBytes + off),
               *reinterpret_cast<const uint32_t*>(base + 2 * kBoxBytes + off));
}

// the producer's step: query tile i into stage i % kKvStages once its
// previous tile is released
__device__ __forceinline__ void load_qg(DkdvSmem& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tg, int i,
                                        int bh) {
  const int s = i % kKvStages;
  mbar_wait(&sm.empty[s], ((i / kKvStages) & 1) ^ 1);
  mbar_expect_tx(&sm.full_qg[s], 2 * kTileBytes);
  load_tile(sm.q[s], tq, &sm.full_qg[s], i * kBM, bh);
  load_tile(sm.g[s], tg, &sm.full_qg[s], i * kBM, bh);
}

// warpgroup 0: S, P (to shared memory as parts) and dV += P^T G; tile
// it + 1's S in flight beside tile it's dV product, then tile it + 1's P
// while that product runs
__device__ __forceinline__ void dv_consume(
    DkdvSmem& sm, const unsigned char* __restrict__ key_pad,
    const float* __restrict__ row_max, const float* __restrict__ row_sum,
    bf16* __restrict__ dv, int H, int L, float scale) {
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int n = (L + kBM - 1) / kBM;
  const int k0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const size_t rbase = static_cast<size_t>(bh) * L;
  uint64_t valid, padded;   // the block's keys
  tile_mask(tile_pad(key_pad + static_cast<size_t>(b) * L, k0, L, lane), k0,
            L, &valid, &padded);

  // query tile it's row statistics (max, sum; 0 and 0 past L), fetched a
  // tile ahead; the reciprocal is taken where the sum is used (taken at the
  // fetch, it stalled the warp on the load)
  float m[2], l[2], m_next[2], l_next[2];
  auto stats = [&](int it, float(&mm)[2], float(&ll)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = it * kBM + 16 * warp + gq + 8 * h;
      mm[h] = r < L ? row_max[rbase + r] : 0.f;
      ll[h] = r < L ? row_sum[rbase + r] : 0.f;
    }
  };
  auto advance = [&](int it) {   // to tile it + 1's statistics
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = m_next[h];
      l[h] = l_next[h];
    }
    stats(it + 2, m_next, l_next);
  };
  float x[32], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto issue_s = [&](int it) {
    const int s = it % kKvStages;
    mbar_wait(&sm.full_qg[s], (it / kKvStages) & 1);
    reg_fence(x);
    reg_fence(acc);
    wgmma_fence();
    score_tile_wgmma(x, sm.q[s], sm.k);
    wgmma_commit();
  };
  // tile it's P from its raw scores in x, to its part buffer
  auto put_p = [&](int it) {
    const int pb = it % 2;
    float inv_l[2];   // 1/l, 0 past L (P = 0 there)
#pragma unroll
    for (int h = 0; h < 2; ++h) inv_l[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    tile_scores(x, valid, padded, t, scale);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      x[i] = exp_shifted(x[i] - m[(i / 2) % 2]) * inv_l[(i / 2) % 2];
    mbar_wait(&sm.p_empty[pb], ((it / 2) & 1) ^ 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_parts(sm.p[pb], 16 * warp + gq + 8 * h, 8 * j + 2 * t,
                    x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
    fence_proxy_async();
    if (lane == 0) mbar_arrive(&sm.p_full[pb]);
    mbar_wait(&sm.p_full[pb], (it / 2) & 1);   // all four warps' parts
  };
  auto issue_dv = [&](int it, bool fence) {   // see issue_s
    const int s = it % kKvStages;
    const int pb = it % 2;
    reg_fence(acc);
    if (fence) wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kBM / 16; ++kq)
#pragma unroll
      for (int part = 2; part >= 0; --part)   // lo, mid, hi
        wgmma_64x128_ss<1, 1>(acc, mn_major_desc(sm.p[pb][part], kq),
                              mn_major_desc(sm.g[s], kq), 1);
    wgmma_commit();
  };
  auto release = [&](int it) {
    if (lane == 0) {
      mbar_arrive(&sm.p_empty[it % 2]);
      mbar_arrive(&sm.empty[it % kKvStages]);
    }
  };

  stats(0, m, l);
  stats(1, m_next, l_next);
  mbar_wait(&sm.full_kv, 0);
  issue_s(0);
  wgmma_wait<0>();
  reg_fence(x);
  put_p(0);
  for (int it = 0; it + 1 < n; ++it) {
    advance(it);
    issue_s(it + 1);
    issue_dv(it, false);
    wgmma_wait<1>();
    reg_fence(x);
    put_p(it + 1);
    wgmma_wait<0>();
    reg_fence(acc);
    release(it);
  }
  issue_dv(n - 1, true);
  wgmma_wait<0>();
  reg_fence(acc);
  release(n - 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + gq + 8 * h;
    if (key >= L) continue;
    bf16* out = dv + (rbase + key) * kDh + 2 * t;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      store2(out + 8 * c, acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
}

// warpgroup 1: dP, dS (from warpgroup 0's P; to shared memory as parts) and
// dK += dS^T Q, overlapped as warpgroup 0's are; its first thread is the
// producer, refilling a stage as soon as this warpgroup, the later of the
// two, releases it
__device__ __forceinline__ void dk_consume(
    DkdvSmem& sm, const CUtensorMap* tq, const CUtensorMap* tg,
    const float* __restrict__ Drow, bf16* __restrict__ dk, int L,
    float scale) {
  const int bh = blockIdx.y;
  const int n = (L + kBM - 1) / kBM;
  const int k0 = blockIdx.x * kBN;
  const int tid = threadIdx.x - kWG;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int t = lane % 4;
  const size_t rbase = static_cast<size_t>(bh) * L;

  float D[2], D_next[2];
  auto stats = [&](int it, float(&d)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = it * kBM + 16 * warp + gq + 8 * h;
      d[h] = r < L ? Drow[rbase + r] : 0.f;
    }
  };
  float x[32], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto issue_dp = [&](int it) {
    const int s = it % kKvStages;
    mbar_wait(&sm.full_qg[s], (it / kKvStages) & 1);
    reg_fence(x);
    reg_fence(acc);
    wgmma_fence();
    score_tile_wgmma(x, sm.g[s], sm.v);
    wgmma_commit();
  };
  // tile it's dS from its dP in x and warpgroup 0's P, to dS's buffer
  auto put_ds = [&](int it) {
    const int pb = it % 2;
    mbar_wait(&sm.p_full[pb], (it / 2) & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 p = load_parts(sm.p[pb], 16 * warp + gq + 8 * h,
                                    8 * j + 2 * t);
        x[4 * j + 2 * h] = p.x * (x[4 * j + 2 * h] - D[h]) * scale;
        x[4 * j + 2 * h + 1] = p.y * (x[4 * j + 2 * h + 1] - D[h]) * scale;
      }
    if (lane == 0) mbar_arrive(&sm.p_empty[pb]);
    named_barrier(2, kWG);   // the buffer's last product is done
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_parts(sm.ds[pb], 16 * warp + gq + 8 * h, 8 * j + 2 * t,
                    x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
    fence_proxy_async();
    named_barrier(2, kWG);   // the parts are written
  };
  auto issue_dk = [&](int it, bool fence) {   // see dv_consume's issue_s
    const int s = it % kKvStages;
    const int pb = it % 2;
    reg_fence(acc);
    if (fence) wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kBM / 16; ++kq)
#pragma unroll
      for (int part = 2; part >= 0; --part)   // lo, mid, hi
        wgmma_64x128_ss<1, 1>(acc, mn_major_desc(sm.ds[pb][part], kq),
                              mn_major_desc(sm.q[s], kq), 1);
    wgmma_commit();
  };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&sm.empty[it % kKvStages]);
    if (tid == 0 && it + kKvStages < n) load_qg(sm, tq, tg, it + kKvStages, bh);
    __syncwarp();
  };

  stats(0, D);
  stats(1, D_next);
  mbar_wait(&sm.full_kv, 0);
  issue_dp(0);
  wgmma_wait<0>();
  reg_fence(x);
  put_ds(0);
  for (int it = 0; it + 1 < n; ++it) {
#pragma unroll
    for (int h = 0; h < 2; ++h) D[h] = D_next[h];
    stats(it + 2, D_next);
    issue_dp(it + 1);
    issue_dk(it, false);
    wgmma_wait<1>();
    reg_fence(x);
    put_ds(it + 1);
    wgmma_wait<0>();
    reg_fence(acc);
    release(it);
  }
  issue_dk(n - 1, true);
  wgmma_wait<0>();
  reg_fence(acc);
  release(n - 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + gq + 8 * h;
    if (key >= L) continue;
    bf16* out = dk + (rbase + key) * kDh + 2 * t;
#pragma unroll
    for (int c = 0; c < 16; ++c)
      store2(out + 8 * c, acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const unsigned char* __restrict__ key_pad,
                         const float* __restrict__ row_max,
                         const float* __restrict__ row_sum,
                         const float* __restrict__ Drow,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int H, int L, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(align_smem(smem_raw));
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&sm.full_kv, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&sm.full_qg[s], 1);
      mbar_init(&sm.empty[s], kThreads / 32);   // one arrival per warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.p_full[b], kWG / 32);    // warpgroup 0's warps
      mbar_init(&sm.p_empty[b], kThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == kWG) {   // the producer's first steps
    const int bh = blockIdx.y;
    const int k0 = blockIdx.x * kBN;
    mbar_expect_tx(&sm.full_kv, 2 * kTileBytes);
    load_tile(sm.k, &tk, &sm.full_kv, k0, bh);
    load_tile(sm.v, &tv, &sm.full_kv, k0, bh);
    for (int i = 0; i < min((L + kBM - 1) / kBM, kKvStages); ++i)
      load_qg(sm, &tq, &tg, i, bh);
  }
  __syncwarp();
  if (tid < kWG)
    dv_consume(sm, key_pad, row_max, row_sum, dv, H, L, scale);
  else
    dk_consume(sm, &tq, &tg, Drow, dk, L, scale);
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  int n = 0;
  if (set_smem(fn, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// The float32 scratch fs2_mha_bwd_bf16 needs for [B, H, L, 128]: D, one
// float per query row (B*H*L).  fs2_mha_bwd_scratch_floats(..., bf16 = 1)
// answers with this.
extern "C" long long fs2_mha_bwd_bf16_scratch_floats(int B, int H, int L) {
  if (B <= 0 || H <= 0 || L <= 0) return -1;
  return static_cast<long long>(B) * H * L;
}

// q, k, v, g, dq, dk, dv: [B, H, L, 128] bfloat16, contiguous, 16-byte
// aligned.  key_pad: [B, L] bytes, nonzero = padded key.  row_max, row_sum:
// [B, H, L] float32 from K1.  scratch: fs2_mha_bwd_bf16_scratch_floats(B,
// H, L) floats, written.  scale = 1/sqrt(D) as float.  Two launches on
// `stream` (K3a, K3b); returns the first CUDA error, or
// cudaErrorInvalidValue for a shape the kernels do not take (or a driver
// without tensor maps).
extern "C" int fs2_mha_bwd_bf16(const void* q, const void* k, const void* v,
                                const void* key_pad, const void* row_max,
                                const void* row_sum, const void* g, void* dq,
                                void* dk, void* dv, void* scratch, int B,
                                int H, int L, int D, float scale,
                                void* stream) {
  if (D != kDh || B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tg;
  if (!tensor_map_rows128(&tq, q, L, B * H) ||
      !tensor_map_rows128(&tk, k, L, B * H) ||
      !tensor_map_rows128(&tv, v, L, B * H) ||
      !tensor_map_rows128(&tg, g, L, B * H))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> dq_ready{0}, kv_ready{0};
  cudaError_t err = set_smem_once(
      reinterpret_cast<const void*>(mha_bwd_dq_bf16_kernel), kDqSmemBytes,
      dq_ready);
  if (err != cudaSuccess) return err;
  err = set_smem_once(reinterpret_cast<const void*>(mha_bwd_dkdv_bf16_kernel),
                      kKvSmemBytes, kv_ready);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* pad = static_cast<const unsigned char*>(key_pad);
  const float* mf = static_cast<const float*>(row_max);
  const float* lf = static_cast<const float*>(row_sum);
  float* Df = static_cast<float*>(scratch);

  const int rows_per_block = kWGs * kBM;
  mha_bwd_dq_bf16_kernel<<<dim3((L + rows_per_block - 1) / rows_per_block,
                                B * H),
                           kThreads, kDqSmemBytes, st>>>(
      tq, tk, tv, tg, pad, mf, lf, Df, static_cast<bf16*>(dq), H, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mha_bwd_dkdv_bf16_kernel<<<dim3((L + kBN - 1) / kBN, B * H),
                             kThreads, kKvSmemBytes, st>>>(
      tq, tk, tv, tg, pad, mf, lf, Df, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, L, scale);
  return cudaGetLastError();
}

// Resident blocks per SM of K3b (dK, dV) and K3a (D, dQ) of the bfloat16
// K3, for the build report; -1 on an error.
extern "C" int fs2_mha_bwd_bf16_blocks_per_sm() {
  return blocks_per_sm(mha_bwd_dkdv_bf16_kernel, kThreads, kKvSmemBytes);
}

extern "C" int fs2_mha_bwd_bf16_dq_blocks_per_sm() {
  return blocks_per_sm(mha_bwd_dq_bf16_kernel, kThreads, kDqSmemBytes);
}
