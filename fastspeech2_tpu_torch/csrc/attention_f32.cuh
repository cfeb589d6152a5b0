// Shared by the float32 K1 (attention.cu) and K3 (attention_bwd.cu), both
// 3xTF32 on wgmma: the layout of [rows][128] float32 tiles as four
// [rows][32] boxes in the 128-byte swizzle (as TMA lands them from a
// tensor map of boxes of 32 floats, hopper.cuh: tensor_map_rows128_f32),
// the split of a tile into its TF32 big and small parts, and THE SCORE
// CONTRACT: the raw scores S = Q K^T, formed by K1 and recomputed by K3
// bit for bit.
//
// tf32 wgmma takes K-major operands only, and 3xTF32 needs each operand's
// big and small parts (tf32_mma.cuh: split), so a tile is split where it
// lands: big parts in place (or into registers, as A fragments), small
// parts into a plane beside it, and where the contraction runs across the
// rows (P V, dS K, P^T G, dS^T Q) the tile is transposed into [128][32]
// big and small planes whose rows hold the 32 keys (or query rows) of
// each d in the order 0, 2, 4, 6, 1, 3, 5, 7 within every k-step of 8, so
// that an accumulator whose columns run over those keys is the A
// fragment of the next product as it stands (split_t).
//
// THE SCORE CONTRACT.  Every score is formed by 16 k-steps d = 8 kk .. 8 kk
// + 7, kk = 0 .. 15, each adding three m64n32k8 products to an
// accumulator that starts at 0: Q_big K_small, Q_small K_big, Q_big K_big
// in that order (score_tile_f32: Q as A, 64 query rows against 32 keys;
// K1, and K3a, which walks the keys per query tile as K1 does).  K3b,
// which walks the query rows per key tile, forms S^T = K Q^T with K as A:
// K_small Q_big, K_big Q_small, K_big Q_big (score_tile_f32_t: 64 keys
// against 32 query rows), the same products of the same values in the
// same order, each term a product of two TF32 values, exact in float32.
// fs2_mha_scores_f32 (attention.cu) writes S through either routine, so
// that a run on the card shows the two routes give the same bits.

#pragma once

#include "attention_bf16.cuh"

namespace fs2_attn {

constexpr int kQBox = 64 * 32;     // floats of a [64][32] box
constexpr int kKBox = 32 * 32;     // floats of a [32][32] box
constexpr int kTileF = 4 * kKBox;  // floats of a [32][128] tile (4096)
constexpr uint32_t kAtom = 1024;   // 8 rows of 128 bytes

// the offset of (row r, column d) of a [rows][128] tile of four [rows][32]
// boxes of `box` floats each
__device__ __forceinline__ int tile_at(int r, int d, int box) {
  return (d >> 5) * box + swz32(r, d & 31);
}

// Q's split (or that of any [64][128] tile taken as the A operand): the
// big parts of this thread's A fragments of the 16 k-steps
// into qb (k-step kk: rows g and g + 8 of the warp's 16 by columns 8 kk + t
// and + 4), the small parts written in place.  q: the warpgroup's [64][128]
// tile as loaded
__device__ __forceinline__ void split_q(float* q, int warp, int lane,
                                        uint32_t (&qb)[16][4]) {
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = tile_at(r0 + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1),
                             kQBox);
      uint32_t small;
      split(q[at], qb[kk][i], small);
      q[at] = __uint_as_float(small);
    }
}

// the transposed planes of a [32][128] tile v (four [32][32] boxes as TMA
// lands them) into vt: [128][32] rows, big then small plane (kTileF floats
// apart), in the 128-byte swizzle, row d's 16-byte chunk c holding rows
// 8 (c / 2) + (c % 2) + 0, 2, 4, 6 of v: the B operand of a product that
// contracts over v's rows, in the permuted order of acc_to_a's A
// fragments.  By THREADS threads (a multiple of 128)
template <int THREADS>
__device__ __forceinline__ void split_t(const float* v, float* vt, int tid) {
  const int d = tid % 128;
#pragma unroll
  for (int c = tid / 128; c < 8; c += THREADS / 128) {
    const int key0 = 8 * (c >> 1) + (c & 1);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = v[tile_at(key0 + 2 * e, d, kKBox)];
    uint32_t b[4], s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], b[e], s[e]);
    const int at = d * 32 + ((c ^ d) & 7) * 4;
    *reinterpret_cast<float4*>(vt + at) =
        make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                    __uint_as_float(b[2]), __uint_as_float(b[3]));
    *reinterpret_cast<float4*>(vt + kTileF + at) =
        make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                    __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

// the same from a tile already split in place (its big plane `big`, its
// small plane `small`): the same values, moved and not split again
template <int THREADS>
__device__ __forceinline__ void transpose_planes(const float* big,
                                                 const float* small,
                                                 float* vt, int tid) {
  const int d = tid % 128;
#pragma unroll
  for (int c = tid / 128; c < 8; c += THREADS / 128) {
    const int key0 = 8 * (c >> 1) + (c & 1);
    float b[4], s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = tile_at(key0 + 2 * e, d, kKBox);
      b[e] = big[at];
      s[e] = small[at];
    }
    const int at = d * 32 + ((c ^ d) & 7) * 4;
    *reinterpret_cast<float4*>(vt + at) = make_float4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<float4*>(vt + kTileF + at) =
        make_float4(s[0], s[1], s[2], s[3]);
  }
}

// the big and small planes of a [32][128] tile src into big and small (big
// may be src: a split in place), by THREADS threads, each on its own
// 16-byte chunks
template <int THREADS>
__device__ __forceinline__ void split_planes(const float* src, float* big,
                                             float* small, int tid) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4* big4 = reinterpret_cast<float4*>(big);
  float4* small4 = reinterpret_cast<float4*>(small);
#pragma unroll
  for (int i = 0; i < kTileF / 4 / THREADS; ++i) {
    const int at = tid + i * THREADS;
    const float4 x = src4[at];
    uint32_t b[4], s[4];
    split(x.x, b[0], s[0]);
    split(x.y, b[1], s[1]);
    split(x.z, b[2], s[2]);
    split(x.w, b[3], s[3]);
    big4[at] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                           __uint_as_float(b[2]), __uint_as_float(b[3]));
    small4[at] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                             __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

// one [32][128] tile of K (big part in place, small part into ks) and of
// V (into Vt's two planes, transposed), by THREADS threads
template <int THREADS>
__device__ __forceinline__ void split_kv(float* k, float* ks, const float* v,
                                         float* vt, int tid) {
  split_planes<THREADS>(k, k, ks, tid);
  if (vt != nullptr) split_t<THREADS>(v, vt, tid);
}

// S = Q K^T of one warpgroup's 64 query rows against a tile of 32 keys (the
// score contract above): per k-step kk of 8 (d = 8 kk ..), Q_big K_small
// (Q's big part from registers), Q_small K_big (from the in-place small
// plane qs) and Q_big K_big, the first into a zero accumulator.
// s[4j + 2h + e]: row 16 w + g + 8 h, key 8 j + 2 t + e.  The caller fences
// before, commits and waits after.
__device__ __forceinline__ void score_tile_f32(float (&s)[16],
                                               const uint32_t (&qb)[16][4],
                                               const float* qs,
                                               const float* kb,
                                               const float* ksm) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int koff = (kk >> 2) * kKBox + (kk & 3) * 8;
    const uint64_t big = make_desc(kb + koff, 16, kAtom);
    const uint64_t small = make_desc(ksm + koff, 16, kAtom);
    if (kk == 0)
      wgmma_tf32_rs_first<32>(s, qb[kk], small);
    else
      wgmma_tf32_rs<32>(s, qb[kk], small);
    wgmma_tf32_ss32(s, make_desc(qs + (kk >> 2) * kQBox + (kk & 3) * 8, 16,
                                 kAtom),
                    big);
    wgmma_tf32_rs<32>(s, qb[kk], big);
  }
}

// the pad bytes lane `lane` reads for the 32-key tile at k0 (0 at or past
// L), fetched a tile ahead of their use
__device__ __forceinline__ uint32_t pad_byte(const unsigned char* pad, int k0,
                                             int L, int lane) {
  return k0 + lane < L ? pad[k0 + lane] : 0u;
}

// The scaled, masked scores of one 32-key tile (x[4j + 2h + e]: key
// 8j + 2t + e) in place, kInitMax for a key at or past L (below every
// score, its exponential exactly 0); f: this lane's pad byte (pad_byte)
__device__ __forceinline__ void tile_scores32(float (&x)[16], uint32_t f,
                                              int k0, int L, int t,
                                              float scale) {
  const uint32_t padded = __ballot_sync(0xffffffffu, f != 0);
  const int below = L - k0;
  const uint32_t valid = below >= 32 ? ~0u : (1u << below) - 1;
  if (padded == 0 && valid == ~0u) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = __fmul_rn(x[i], scale);
    return;
  }
  const uint32_t v = valid >> (2 * t), p = padded >> (2 * t);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = (v >> (8 * j + e)) & 1u;
      const bool masked = (p >> (8 * j + e)) & 1u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        x[i] = ok ? masked_score(x[i], masked, scale) : kInitMax;
      }
    }
}


// S^T = K Q^T of 64 keys (A: K's big parts in registers as split_q made
// them, kb, and its small plane ksm, a [64][128] tile of [64][32] boxes)
// against 32 query rows (B: Q's big plane qb and small plane qsm, [32][128]
// tiles as split_kv makes them), the score contract's K-as-A route: per
// k-step, K_small Q_big, K_big Q_small, K_big Q_big, the first into a zero
// accumulator.  s[4j + 2h + e]: key 16 w + g + 8 h, query row 8 j + 2 t +
// e.  The caller fences before, commits and waits after.
__device__ __forceinline__ void score_tile_f32_t(float (&s)[16],
                                                 const uint32_t (&kb)[16][4],
                                                 const float* ksm,
                                                 const float* qb,
                                                 const float* qsm) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int qoff = (kk >> 2) * kKBox + (kk & 3) * 8;
    const uint64_t big = make_desc(qb + qoff, 16, kAtom);
    const uint64_t ka =
        make_desc(ksm + (kk >> 2) * kQBox + (kk & 3) * 8, 16, kAtom);
    if (kk == 0)
      wgmma_tf32_ss32_first(s, ka, big);
    else
      wgmma_tf32_ss32(s, ka, big);
    wgmma_tf32_rs<32>(s, kb[kk], make_desc(qsm + qoff, 16, kAtom));
    wgmma_tf32_rs<32>(s, kb[kk], big);
  }
}

// The big and small parts of this thread's A fragments of the 16 k-steps
// of a [64][128] tile q (four [64][32] boxes), both into registers (split_q
// writes the small parts back in place instead)
__device__ __forceinline__ void split_q_regs(const float* q, int warp,
                                             int lane, uint32_t (&qb)[16][4],
                                             uint32_t (&qs)[16][4]) {
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split(q[tile_at(r0 + 8 * (i & 1), 8 * kk + t + 4 * (i >> 1), kQBox)],
            qb[kk][i], qs[kk][i]);
}

// score_tile_f32 with Q's small parts from registers too (K3a: no Q plane
// in shared memory): the same products in the same order, every one with
// A from registers
__device__ __forceinline__ void score_tile_f32_rr(float (&s)[16],
                                                  const uint32_t (&qb)[16][4],
                                                  const uint32_t (&qs)[16][4],
                                                  const float* kb,
                                                  const float* ksm) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int koff = (kk >> 2) * kKBox + (kk & 3) * 8;
    const uint64_t big = make_desc(kb + koff, 16, kAtom);
    const uint64_t small = make_desc(ksm + koff, 16, kAtom);
    if (kk == 0)
      wgmma_tf32_rs_first<32>(s, qb[kk], small);
    else
      wgmma_tf32_rs<32>(s, qb[kk], small);
    wgmma_tf32_rs<32>(s, qs[kk], big);
    wgmma_tf32_rs<32>(s, qb[kk], big);
  }
}

// An m64n32 accumulator x (x[4j + 2h + e]: row 16 w + g + 8 h, column 8 j +
// 2 t + e) as the A fragments of the four k-steps of a product contracting
// over its columns, in the permuted order (columns 2t, 2t + 1 of k-step j
// as k = t, t + 4; the B operand from split_t or transpose_planes): x read
// as (c0, c2, c1, c3), split into big and small parts
__device__ __forceinline__ void acc_to_a(const float (&x)[16],
                                         uint32_t (&pb)[4][4],
                                         uint32_t (&ps)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(x[4 * j], pb[j][0], ps[j][0]);
    split(x[4 * j + 2], pb[j][1], ps[j][1]);
    split(x[4 * j + 1], pb[j][2], ps[j][2]);
    split(x[4 * j + 3], pb[j][3], ps[j][3]);
  }
}

// acc (64 x 128) += A B over the 32 rows of the A fragments' k-steps, 3xTF32:
// per k-step j, A_small B_big, A_big B_small, A_big B_big (K4's order, and
// K1's P V); bt: the B operand's [128][32] big plane, its small plane
// kTileF floats after it.  The caller fences before, commits and waits
// after.
__device__ __forceinline__ void product_t(float (&acc)[64],
                                          const uint32_t (&ab)[4][4],
                                          const uint32_t (&as)[4][4],
                                          const float* bt) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t big = make_desc(bt + 8 * j, 16, kAtom);
    wgmma_tf32_rs<128>(acc, as[j], big);
    wgmma_tf32_rs<128>(acc, ab[j], make_desc(bt + kTileF + 8 * j, 16, kAtom));
    wgmma_tf32_rs<128>(acc, ab[j], big);
  }
}

}  // namespace fs2_attn
