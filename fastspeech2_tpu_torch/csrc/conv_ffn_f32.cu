// K2, float32: fused position-wise conv FFN forward for sm_90a, 3xTF32 on
// wgmma, the weights fed by TMA.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_ffn.py (_ffn_kernel via
// _pallas_forward), which keeps one batch row's [L, H] hidden activation in
// VMEM.  Computes, on [B, L, D] row-major activations (D = 256),
//
//   h   = ReLU(conv1d_k1(x; w1 [k1, D, H]) + b1)          (SAME zero padding)
//   y   = conv1d_k2(h; w2 [k2, H, D]) + b2 + x
//   out = (y - mean) / sqrt(E[y^2] - mean^2 + 1e-5) * gamma + beta   (over D)
//
// Each k-tap conv is k shifted products (tap j reads row l + j - (k-1)/2);
// taps that fall outside [0, L) read zero.
//
// What bounds it on an H100: 2 L D H (k1 + k2) operations (5.24 GFLOP at
// L = 1000, D = 256, H = 1024, k = (9, 1)), 3xTF32 on the tensor cores:
// 0.0318 ms at [1, 1000], 0.508 ms at [16, 1000].  At L = 32 the 10.5 MB of
// weights bound it (0.0032 ms at 3.35 TB/s), and the bound asks that many
// SMs pull them at once.
//
// Design: both convs are implicit GEMMs on K4's machinery (resblock.cu):
// positions are M, output channels N, and each tap's input channels K.  A
// conv walks stages of (32 input channels, one tap), slices outer, taps
// inner:
//   - the weights are the B operand, read by wgmma from shared memory: the
//     stage's [N][32] tf32 big and small planes, split and laid out in the
//     128-byte swizzle once, when they are packed (ops/cuda_ffn.py), arrive
//     by two bulk copies into a ring with a full and an empty mbarrier per
//     slot; thread 0 refills a slot the block left a stage or two before;
//   - the activations are the A operand, from registers: each thread loads
//     its 16 values of a stage (channels-last rows, a tap's shift only a
//     start address; zero outside [0, L)) two stages ahead (conv1) or one
//     (conv2), and splits them into their TF32 parts;
//   - per stage, 4 k-steps of 8 channels, each three m64n128k8 products in
//     the order x_small w_big, x_big w_small, x_big w_big;
//   - two levels of sums: the products of a unit of stages (conv1: two
//     slices, all their taps; conv2: one slice) are accumulated by the
//     tensor cores from 0, then added to a float32 running sum on the CUDA
//     cores.  The tensor cores' own accumulation rounds less exactly than
//     float32's round-to-nearest: with one level, over the 3072 terms of a
//     3-tap second conv, the LayerNorm's output drifted ~1.1e-4 from plain
//     float32 on an H100.  So a warpgroup takes 128 output channels and
//     holds two sums of 64 x 128: conv2 both in registers; conv1 its unit's
//     in registers and its running sum in shared memory, because conv1
//     keeps two sets of A fragments, the next stage's split while this
//     stage's products run (a second group in flight, wgmma_wait<1>), and
//     no registers are left for a second sum;
//   - the grid is persistent (at most one block per SM), each block walking
//     its tiles' stages as one sequence, so the ring and the activation
//     loads run on from one tile into the next.
// Launches, h through device memory (65.5 MB at [16, 1000], ~40 us of
// traffic against a 0.508 ms bound):
//   (a) conv1: tiles of 128 positions (two warpgroups of 64) by 128 hidden
//       channels; the k1 taps may be split over S blocks (S divides k1:
//       9 at [1, 32], 3 at [1, 1000], 1 at [16, 1000]), each writing its
//       partial sum of the pre-activation to part[S][B][L][H]; with S > 1
//       a wide elementwise launch sums the partials in order into the
//       first;
//   (b) conv2: tiles of 64 positions by all 256 output channels (warpgroup
//       w takes channels 128 w ..), the A operand h = ReLU(conv1's sum +
//       b1), 0 outside [0, L).  With G = 1 it ends in the LayerNorm: y =
//       (acc + b2) + x, each thread's sums over its 32 values of a row (the
//       square by fma), a butterfly over the quad, the two warpgroups'
//       halves added through shared memory, then E[y^2] - mean^2 + 1e-5.
//       Where its grid would be a fraction of the card (L <= 128 at batch
//       1, [10, 128]) the hidden channels split into G groups of whole
//       slices, each writing its share to ypart[G][B][L][256];
//   (c) with G > 1, a wide elementwise launch forms y = (the shares summed
//       in order + b2) + x, and (d) one takes the LayerNorm of y in the
//       epilogue's order (eight lanes a row).
// So two launches at the large shapes, up to five at the smallest.  The
// plan (fs2_conv_ffn_f32_plan) picks S and G by a cost model fitted to a
// sweep of every plan on an H100.  Accumulation order
// (tests/test_torch_conv_tiles.py models it): slices of 32 input channels,
// taps, k-steps of 8, the three products, each unit added to the running
// sum; the S partials and the G shares in order.  No atomics: two launches
// on the same inputs agree bit for bit.
//
// The bfloat16 instance (conv_ffn.cu) keeps its own design.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace fs2_hopper;
using fs2_conv::sm_count;
using fs2_tc::split;

constexpr int kD = 256;
constexpr int kThreads = 256;          // two warpgroups
constexpr int kSlice = 32;             // input channels per stage (128 B)
constexpr int kKSteps = kSlice / 8;    // k-steps per stage
constexpr int kWN = 128;               // output channels per warpgroup
constexpr uint32_t kAtomBytes = 1024;  // 8 rows of 128 bytes

// kConv2 = false: conv1, tiles of 128 positions by 128 hidden channels
// (the warpgroups split the positions); true: conv2, 64 positions by 256
// output channels (the warpgroups split the channels)
template <bool kConv2>
struct Cfg {
  static constexpr int kBM = kConv2 ? 64 : 128;   // positions per tile
  static constexpr int kNB = kConv2 ? 256 : 128;  // output channels per tile
  static constexpr uint32_t kPlaneBytes = kNB * kSlice * 4;
  static constexpr int kStages = kConv2 ? 3 : 4;
  // the ring, conv2's LayerNorm row sums or conv1's running sums (64
  // values of each of the 256 threads), the barriers
  static constexpr int kSmemBytes = kStages * 2 * kPlaneBytes +
                                    (kConv2 ? 2 * 2 * 64 : 64 * 256) * 4 +
                                    2 * kStages * 8 + 1024;
};

// Both convs.  conv1: in = x [B][L][256], w = w1's pack, out = part[S]
// [B][L][H] (the pre-activation partial of each tap split), K = k1, S =
// splits; b1, b2, x, gamma, beta and G unused.  conv2: in = conv1's sum
// (part[0]), w = w2's pack, out = the output [B][L][256] (G = 1) or
// ypart[G][B][L][256], K = k2; S unused.
template <bool kConv2>
__global__ void __launch_bounds__(kThreads, 1)
ffn_wgmma_kernel(const float* __restrict__ in, const float* __restrict__ w,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 const float* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, float* __restrict__ out,
                 int B, int L, int H, int K, int S, int G) {
  using C = Cfg<kConv2>;
  constexpr int R = C::kStages;
  constexpr int kPlane = C::kNB * kSlice;   // floats
  extern __shared__ unsigned char smem_raw[];
  // the ring (1,024-byte aligned for the swizzle), the row sums or running
  // sums, the barriers
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // conv2: the LayerNorm's row sums [2 wg][64 rows][2]; conv1: the running
  // sums, value r of thread tid at r * 256 + tid
  float* red = ring + R * 2 * kPlane;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(red + (kConv2 ? 2 * 2 * 64 : 64 * 256));
  uint64_t* empty = full + R;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cout = kConv2 ? kD : H;         // the conv's output channels
  const int cin = kConv2 ? H : kD;          // its input channels
  const int l_tiles = (L + C::kBM - 1) / C::kBM;
  const int n_blocks = cout / C::kNB;       // 1 for conv2
  const int parts = kConv2 ? G : S;         // the K split
  const int tiles = l_tiles * n_blocks * B * parts;
  // stages per tile: conv1 (cin / 32 slices) x (K / S taps); conv2
  // (cin / 32 / G slices) x K taps
  const int taps = kConv2 ? K : K / S;
  const int slices = kConv2 ? cin / kSlice / G : cin / kSlice;
  const int T = slices * taps;
  const int N = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * T;
  const int pad = (K - 1) / 2;
  // a tile's K split, batch row, first output channel and first position
  // (positions fastest, then batch rows, then output-channel blocks)
  auto coords = [&](int tile, int& sp, int& b, int& nb0, int& l0) {
    l0 = (tile % l_tiles) * C::kBM;
    int rest = tile / l_tiles;
    b = rest % B;
    rest /= B;
    nb0 = (rest % n_blocks) * C::kNB;
    sp = rest / n_blocks;
  };
  // a place in the block's sequence of stages: the tile, the stage i in
  // it, and what they fix (the tile's coordinates, the stage's slice sl and
  // tap j0 + jt), stepped forward without a division
  struct Cursor {
    int tile, i, sp, b, nb0, l0, sl, j0, jt;
  };
  auto set_tile = [&](Cursor& c, int tile) {
    c.tile = tile;
    c.i = c.jt = 0;
    if (tile >= tiles) return;
    coords(tile, c.sp, c.b, c.nb0, c.l0);
    c.sl = kConv2 ? c.sp * slices : 0;
    c.j0 = kConv2 ? 0 : c.sp * taps;
  };
  auto advance = [&](Cursor& c) {
    if (++c.i == T) {
      set_tile(c, c.tile + gridDim.x);
    } else if (++c.jt == taps) {
      c.jt = 0;
      ++c.sl;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads / 32);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the producer's step (thread 0): the stage at pc, the block's n-th, into
  // slot n % R once the stage before it there is released (a fresh slot
  // passes at once).  The pack is [cin/32][K][2][cout][32]: the stage's two
  // planes, rows nb0 ..
  Cursor pc;   // thread 0's: the next stage load_stage loads
  set_tile(pc, blockIdx.x);
  auto load_stage = [&](int n) {
    const int slot = n % R;
    mbar_wait(&empty[slot], ((n / R) & 1) ^ 1);
    mbar_expect_tx(&full[slot], 2 * C::kPlaneBytes);
    const float* src = w + ((static_cast<size_t>(pc.sl) * K + pc.j0 + pc.jt) *
                                2 * cout + pc.nb0) * kSlice;
#pragma unroll
    for (int p = 0; p < 2; ++p)
      bulk_load(ring + (slot * 2 + p) * kPlane,
                src + static_cast<size_t>(p) * cout * kSlice, C::kPlaneBytes,
                &full[slot]);
    advance(pc);
  };
  if (tid == 0)
    for (int n = 0; n < N && n < R; ++n) load_stage(n);

  // this thread's first row of a tile: rows p0 and p0 + 8 of the A
  // fragments (conv1: warpgroup w takes positions 64 w ..)
  const int row0 = (kConv2 ? 0 : 64 * wg) + 16 * warp + g;
  // the stage at c: raw[4 q + 2 e + h] = the input at position p0 + 8 h
  // + (j - pad), channel 32 sl + 8 q + 4 e + t, 0 outside [0, L): the A
  // fragment's a0..a3 of k-step q.  conv2's input is h: conv1's sum (the S
  // partials summed in order by ffn_sum_kernel), + b1 (ReLU when the
  // stage is split)
  float raw[4 * kKSteps];
  auto load_raw = [&](const Cursor& c) {
    const int pos = c.l0 + row0 + c.j0 + c.jt - pad;
    const int c0 = c.sl * kSlice + t;
    bool ok[2];
    const float* row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pos + 8 * h;
      ok[h] = static_cast<unsigned>(p) < static_cast<unsigned>(L);
      row[h] = in + (static_cast<size_t>(c.b) * L + p) * cin + c0;
    }
    // raw[4 q + 2 e + h] at channel offset 8 q + 4 e of row h
    auto each = [&](auto&& f) {
#pragma unroll
      for (int q = 0; q < kKSteps; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) f(4 * q + 2 * e + h, 8 * q + 4 * e, h);
    };
    each([&](int r, int off, int h) {
      raw[r] = ok[h] ? __ldg(row[h] + off) : 0.f;
    });
    if (kConv2)
      each([&](int r, int off, int h) {
        if (ok[h]) raw[r] += __ldg(b1 + c0 + off);
      });
  };

  float acc[kWN / 2];    // the unit's products, from 0
  // conv2's running sum (conv1's lives in shared memory, `red`: conv1
  // keeps two sets of A fragments, and no registers are left for it)
  float run[kConv2 ? kWN / 2 : 1];
  // the big and small planes of A: two sets for conv1 (the next stage's
  // split while this stage's products run), one for conv2 (its LayerNorm
  // epilogue leaves no registers for a second)
  constexpr bool kDouble = !kConv2;
  uint32_t xb0[kKSteps][4], xs0[kKSteps][4];
  uint32_t xb1[kKSteps][4], xs1[kKSteps][4];
  // this warpgroup's rows of the stage's planes (conv2: channels 128 w ..)
  const int b_off = kConv2 ? wg * kWN * kSlice : 0;
  auto split_raw = [&](uint32_t(&xb)[kKSteps][4], uint32_t(&xs)[kKSteps][4]) {
#pragma unroll
    for (int q = 0; q < kKSteps; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(kConv2 ? fmaxf(raw[4 * q + r], 0.f) : raw[4 * q + r], xb[q][r],
              xs[q][r]);
  };
  auto fence_a = [&](uint32_t(&xb)[kKSteps][4], uint32_t(&xs)[kKSteps][4]) {
#pragma unroll
    for (int q = 0; q < kKSteps; ++q) {
      reg_fence(xb[q]);
      reg_fence(xs[q]);
    }
  };
  Cursor ld;   // the stage whose activations load_raw loads next
  set_tile(ld, blockIdx.x);
  int n = 0;   // the block's stage counter
  // stage n: issue its products (`fresh`: the first stage of a unit of the
  // two-level sum, whose first product starts the accumulator) from the A
  // set (xb, xs); conv1 then waits for stage n - 1's products, releases
  // their weights and splits the next stage's activations into the other
  // set (nb, ns) while stage n's run; conv2 waits for stage n's products,
  // releases their weights and splits the next stage's activations into the
  // same set.  The stage after's activations are loaded meanwhile.
  auto stage = [&](auto fresh, uint32_t(&xb)[kKSteps][4],
                   uint32_t(&xs)[kKSteps][4], uint32_t(&nb)[kKSteps][4],
                   uint32_t(&ns)[kKSteps][4]) {
    const int slot = n % R;
    const float* wb = ring + slot * 2 * kPlane + b_off;   // big plane
    const float* wsm = wb + kPlane;                       // small plane
    mbar_wait(&full[slot], (n / R) & 1);
    // conv1's accumulator may be in flight here (stage n - 1's products):
    // no other instruction touches it then
    if (!kDouble && !decltype(fresh)::value) reg_fence(acc);
    fence_a(xb, xs);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kKSteps; ++q) {
      const uint64_t big = make_desc(wb + 8 * q, 16, kAtomBytes);
      if (decltype(fresh)::value && q == 0)
        wgmma_tf32_rs_first<kWN>(acc, xs[q], big);
      else
        wgmma_tf32_rs<kWN>(acc, xs[q], big);
      wgmma_tf32_rs<kWN>(acc, xb[q], make_desc(wsm + 8 * q, 16, kAtomBytes));
      wgmma_tf32_rs<kWN>(acc, xb[q], big);
    }
    wgmma_commit();
    if constexpr (kDouble) {
      wgmma_wait<1>();   // stage n - 1's products are done
      fence_a(nb, ns);
      // release stage n - 1's slot; thread 0 refills the one the block
      // left a stage before that (both warpgroups are past it by now)
      if (n > 0 && lane == 0) mbar_arrive(&empty[(n - 1) % R]);
      if (tid == 0 && n >= 2 && n - 2 + R < N) load_stage(n - 2 + R);
      __syncwarp();
      split_raw(nb, ns);
      if (ld.tile < tiles) {
        load_raw(ld);
        advance(ld);
      }
    } else {
      if (ld.tile < tiles) {
        load_raw(ld);
        advance(ld);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      fence_a(xb, xs);
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (tid == 0 && n >= 1 && n - 1 + R < N) load_stage(n - 1 + R);
      __syncwarp();
      split_raw(nb, ns);
    }
    ++n;
  };
  // the first stage's activations split, the next ones' loaded
  load_raw(ld);
  advance(ld);
  split_raw(xb0, xs0);
  if (kDouble && ld.tile < tiles) {
    load_raw(ld);
    advance(ld);
  }
  // the units of the two-level sum: conv1 two slices (2 x taps stages, an
  // even count, so that every unit starts on the first A set), conv2 one
  const int unit = kDouble ? 2 * taps : taps;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    if constexpr (kConv2) {
#pragma unroll
      for (int i = 0; i < kWN / 2; ++i) run[i] = 0.f;
    }
#pragma unroll 1
    for (int u = 0; u < T; u += unit) {
      if constexpr (kDouble) {
        stage(std::true_type{}, xb0, xs0, xb1, xs1);
        stage(std::false_type{}, xb1, xs1, xb0, xs0);
#pragma unroll 1
        for (int i = 2; i < unit; i += 2) {
          stage(std::false_type{}, xb0, xs0, xb1, xs1);
          stage(std::false_type{}, xb1, xs1, xb0, xs0);
        }
        wgmma_wait<0>();
        reg_fence(acc);
      } else {
        stage(std::true_type{}, xb0, xs0, xb0, xs0);
#pragma unroll 1
        for (int i = 1; i < unit; ++i)
          stage(std::false_type{}, xb0, xs0, xb0, xs0);
      }
      if constexpr (kConv2) {
#pragma unroll
        for (int r = 0; r < kWN / 2; ++r) run[r] += acc[r];
      } else {
        // 0 + acc = acc: the first unit stores
#pragma unroll
        for (int r = 0; r < kWN / 2; ++r)
          red[r * kThreads + tid] =
              u == 0 ? acc[r] : red[r * kThreads + tid] + acc[r];
      }
    }

    int sp, b, nb0, l0;
    coords(tile, sp, b, nb0, l0);
    const int p0 = l0 + row0;
    if constexpr (!kConv2) {
      // the pre-activation partial of split sp, columns nb0 + 8 c + 2 t
      float* op = out + ((static_cast<size_t>(sp) * B + b) * L) * H + nb0 +
                  2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        if (p >= L) continue;
#pragma unroll
        for (int c = 0; c < kWN / 8; ++c)
          *reinterpret_cast<float2*>(op + static_cast<size_t>(p) * H +
                                     8 * c) =
              make_float2(red[(4 * c + 2 * h) * kThreads + tid],
                          red[(4 * c + 2 * h + 1) * kThreads + tid]);
      }
    } else {
      const int col0 = kWN * wg + 2 * t;   // columns col0 + 8 c + e
      if (G > 1) {
        // this group's share
        float* op =
            out + ((static_cast<size_t>(sp) * B + b) * L) * kD + col0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + 8 * h;
          if (p >= L) continue;
#pragma unroll
          for (int c = 0; c < kWN / 8; ++c)
            *reinterpret_cast<float2*>(op + static_cast<size_t>(p) * kD +
                                       8 * c) =
                make_float2(run[4 * c + 2 * h], run[4 * c + 2 * h + 1]);
        }
        continue;
      }
      // the LayerNorm epilogue: y = (run + b2) + x, in place in run
      float s[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        const float* xr = x + (static_cast<size_t>(b) * L + p) * kD + col0;
#pragma unroll
        for (int c = 0; c < kWN / 8; ++c) {
          const float2 xv = p < L ? *reinterpret_cast<const float2*>(xr + 8 * c)
                                  : make_float2(0.f, 0.f);
          const float2 bv = __ldg(reinterpret_cast<const float2*>(b2 + col0 +
                                                                  8 * c));
          float& y0 = run[4 * c + 2 * h];
          float& y1 = run[4 * c + 2 * h + 1];
          y0 = y0 + bv.x + xv.x;
          y1 = y1 + bv.y + xv.y;
          s[h] += y0;
          sq[h] = fmaf(y0, y0, sq[h]);
          s[h] += y1;
          sq[h] = fmaf(y1, y1, sq[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off <= 2; off *= 2) {
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
          sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], off);
        }
        if (t == 0) {
          const int r = 16 * warp + g + 8 * h;
          red[(wg * 64 + r) * 2] = s[h];
          red[(wg * 64 + r) * 2 + 1] = sq[h];
        }
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const float st = red[r * 2] + red[(64 + r) * 2];
        const float sqt = red[r * 2 + 1] + red[(64 + r) * 2 + 1];
        const float mean = st / kD;
        const float var = sqt / kD - mean * mean;
        const float inv = 1.f / sqrtf(var + 1e-5f);
        const int p = p0 + 8 * h;
        if (p >= L) continue;
        float* op = out + (static_cast<size_t>(b) * L + p) * kD + col0;
#pragma unroll
        for (int c = 0; c < kWN / 8; ++c) {
          const int col = col0 + 8 * c;
          *reinterpret_cast<float2*>(op + 8 * c) = make_float2(
              (run[4 * c + 2 * h] - mean) * inv * gamma[col] + beta[col],
              (run[4 * c + 2 * h + 1] - mean) * inv * gamma[col + 1] +
                  beta[col + 1]);
        }
      }
      __syncthreads();   // the row sums are written again by the next tile
    }
  }
}

// Between the convs when the taps are split (S > 1): conv1's S partial
// sums added in the order 0, 1, ... into the first, in place, four floats
// a thread (n4 float4s a plane)
constexpr int kThreadsSum = 256;
constexpr int kMaxSplits = 16;

__global__ void __launch_bounds__(kThreadsSum)
ffn_sum_kernel(float* __restrict__ part, int S, long n4) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4* p = reinterpret_cast<float4*>(part);
  float4 v[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < S) v[s] = p[s * n4 + i];   // every load issued before a sum
  float4 acc = v[0];
#pragma unroll
  for (int s = 1; s < kMaxSplits; ++s)
    if (s < S) {
      acc.x += v[s].x;
      acc.y += v[s].y;
      acc.z += v[s].z;
      acc.w += v[s].w;
    }
  p[i] = acc;
}

// With G > 1, after conv2: (c) y = (the G shares summed in order + b2) +
// x, in place in the first share, four floats a thread (wide: a few rows'
// shares would take one SM's bandwidth in the LayerNorm's loop), then (d)
// out = LN(y) over D = 256
constexpr int kThreadsShare = 256;
constexpr int kShareAhead = 8;   // shares whose loads are in flight at once

__global__ void __launch_bounds__(kThreadsShare)
ffn_share_sum_kernel(float* __restrict__ ypart, const float* __restrict__ b2,
                     const float* __restrict__ x, int groups, long n4) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4* p = reinterpret_cast<float4*>(ypart);
  float4 acc = p[i];
  for (int g0 = 1; g0 < groups; g0 += kShareAhead) {
    float4 u[kShareAhead];
#pragma unroll
    for (int k = 0; k < kShareAhead; ++k)
      if (g0 + k < groups) u[k] = p[(g0 + k) * n4 + i];
#pragma unroll
    for (int k = 0; k < kShareAhead; ++k)
      if (g0 + k < groups) {
        acc.x += u[k].x;
        acc.y += u[k].y;
        acc.z += u[k].z;
        acc.w += u[k].w;
      }
  }
  const float4 bv = __ldg(reinterpret_cast<const float4*>(b2) + i % (kD / 4));
  const float4 xv = reinterpret_cast<const float4*>(x)[i];
  p[i] = make_float4(acc.x + bv.x + xv.x, acc.y + bv.y + xv.y,
                     acc.z + bv.z + xv.z, acc.w + bv.w + xv.w);
}

// (d): eight lanes per row, four rows per warp: lane (w, t) = ((lane / 4)
// % 2, lane % 4) of a row takes the columns 128 w + 8 c + 2 t + e, c = 0 ..
// 15, so that every sum runs in the conv2 epilogue's order
constexpr int kThreadsLN = 256;
constexpr int kRowsLN = kThreadsLN / 8;

__global__ void __launch_bounds__(kThreadsLN)
ffn_ln_f32_kernel(const float* __restrict__ y_in,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, float* __restrict__ out,
                  int rows) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsLN + threadIdx.x / 8;
  const int t = lane & 3;
  const int col0 = kWN * ((lane >> 2) & 1) + 2 * t;
  const bool ok = r < rows;   // shuffles need the whole warp
  const size_t at = static_cast<size_t>(ok ? r : 0) * kD + col0;
  float y[kWN / 4];
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int c = 0; c < kWN / 8; ++c) {
    const float2 v = *reinterpret_cast<const float2*>(y_in + at + 8 * c);
    y[2 * c] = v.x;
    y[2 * c + 1] = v.y;
    s += y[2 * c];
    sq = fmaf(y[2 * c], y[2 * c], sq);
    s += y[2 * c + 1];
    sq = fmaf(y[2 * c + 1], y[2 * c + 1], sq);
  }
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  // warpgroup 0's half plus warpgroup 1's
  const float s_other = __shfl_xor_sync(0xffffffffu, s, 4);
  const float sq_other = __shfl_xor_sync(0xffffffffu, sq, 4);
  const bool first = ((lane >> 2) & 1) == 0;
  const float st = first ? s + s_other : s_other + s;
  const float sqt = first ? sq + sq_other : sq_other + sq;
  const float mean = st / kD;
  const float var = sqt / kD - mean * mean;
  const float inv = 1.f / sqrtf(var + 1e-5f);
  if (!ok) return;
#pragma unroll
  for (int c = 0; c < kWN / 8; ++c) {
    const int col = col0 + 8 * c;
    *reinterpret_cast<float2*>(out + at + 8 * c) =
        make_float2((y[2 * c] - mean) * inv * gamma[col] + beta[col],
                    (y[2 * c + 1] - mean) * inv * gamma[col + 1] +
                        beta[col + 1]);
  }
}

template <bool kConv2>
cudaError_t launch(const float* in, const float* w, const float* b1,
                   const float* b2, const float* x, const float* gamma,
                   const float* beta, float* out, int B, int L, int H, int K,
                   int S, int G, cudaStream_t st) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ffn_wgmma_kernel<kConv2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<kConv2>::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  using C = Cfg<kConv2>;
  const long long tiles = static_cast<long long>((L + C::kBM - 1) / C::kBM) *
                          ((kConv2 ? kD : H) / C::kNB) * B * (kConv2 ? G : S);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  ffn_wgmma_kernel<kConv2><<<grid, kThreads, C::kSmemBytes, st>>>(
      in, w, b1, b2, x, gamma, beta, out, B, L, H, K, S, G);
  return cudaGetLastError();
}

// The plan's cost model, in microseconds of device time on an H100 (from a
// sweep of every plan at the paths' small shapes): one stage of one block
// (two warpgroups' 12 products), a block's first stages' wait for the ring
// in stages, a small launch (the partials' sum, the shares' sum, the
// LayerNorm), and the device memory's rate for the partials and shares
// (written once, read once)
constexpr double kStageUs = 1.1;
constexpr double kPrologueStages = 2.0;
constexpr double kLaunchUs = 2.0;
constexpr double kBytesPerUs = 3.35e6;

// the modelled time of a conv of `tiles` tiles, `stages` stages each, on a
// persistent grid of one block per SM
double conv_us(long long tiles, int stages) {
  const long long per = (tiles + sm_count() - 1) / sm_count();
  return (static_cast<double>(per) * stages + kPrologueStages) * kStageUs;
}

}  // namespace

// K2's float32 plan at [B, L, 256] -> H with a k1-tap first conv and a
// k2-tap second one:
//   cfg[0] = the tap splits S of conv1, a divisor of k1 (at most 16);
//   cfg[1] = the hidden groups G of conv2, a power of two dividing H / 32;
// each the one whose modelled time is least, the smallest on a tie: the
// conv's stages over the persistent grid, plus for S > 1 the partials'
// bytes and their sum's launch, for G > 1 the shares' bytes and the
// launches of their sum and the LayerNorm.  Returns the floats of scratch
// the call needs: S B L H partial sums of conv1, then, with G > 1, G B L 256
// shares of conv2.
extern "C" long long fs2_conv_ffn_f32_plan(int B, int L, int H, int k1,
                                           int k2, int* cfg) {
  const double rows = static_cast<double>(B) * L;
  const long long tiles1 = static_cast<long long>((L + 127) / 128) *
                           (H / 128) * B;
  int splits = 1;
  double best = -1.0;
  for (int s = 1; s <= k1 && s <= kMaxSplits; ++s) {
    if (k1 % s) continue;
    double us = conv_us(tiles1 * s, kD / kSlice * k1 / s);
    if (s > 1)
      us += kLaunchUs + (2.0 * s + 1.0) * rows * H * sizeof(float) /
                            kBytesPerUs;
    if (best < 0.0 || us < best) {
      best = us;
      splits = s;
    }
  }
  const long long tiles2 = static_cast<long long>((L + 63) / 64) * B;
  int groups = 1;
  best = -1.0;
  for (int grp = 1; grp <= H / kSlice && (H / kSlice) % grp == 0; grp *= 2) {
    double us = conv_us(tiles2 * grp, H / kSlice / grp * k2);
    if (grp > 1)
      us += 2.0 * kLaunchUs +
            (2.0 * grp + 2.0) * rows * kD * sizeof(float) / kBytesPerUs;
    if (best < 0.0 || us < best) {
      best = us;
      groups = grp;
    }
  }
  cfg[0] = splits;
  cfg[1] = groups;
  return (static_cast<long long>(splits) * H +
          (groups > 1 ? static_cast<long long>(groups) * kD : 0)) *
         B * L;
}

// x, out: [B, L, D]; w1, w2: the packs of conv1 ([D/32][k1][2][H][32]
// floats) and conv2 ([H/32][k2][2][D][32]): for each (32-channel slice,
// tap) the big and small tf32 planes of the weights as [C_out][32] rows in
// the 128-byte swizzle (ops/cuda_ffn.py); b1: [H]; b2, gamma, beta: [D];
// scratch: fs2_conv_ffn_f32_plan's floats.  All float32, contiguous,
// 16-byte aligned.  Takes D = 256, H a multiple of 128, k1, k2 >= 1 (a
// k-tap conv pads (k-1)/2 zeros before and k/2 after, SAME), splits
// dividing k1 (at most 16) and groups a power of two dividing H / 32, as
// fs2_conv_ffn_f32_plan gives them.  Launches the two convs on `stream`,
// with the partials' sum between them for splits > 1 and the shares' sum
// and the LayerNorm after them for groups > 1; returns cudaGetLastError()
// after each (or cudaErrorInvalidValue for a shape the kernels do not
// take).
extern "C" int fs2_conv_ffn_fwd_f32(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* gamma,
                                    const void* beta, void* scratch,
                                    void* out, int B, int L, int D, int H,
                                    int k1, int k2, int splits, int groups,
                                    void* stream) {
  if (D != kD || H <= 0 || H % 128 != 0 || B <= 0 || L <= 0 || k1 <= 0 ||
      k2 <= 0 || splits <= 0 || splits > kMaxSplits || k1 % splits != 0 ||
      groups <= 0 ||
      (groups & (groups - 1)) != 0 || (H / kSlice) % groups != 0 ||
      static_cast<long long>(splits) * B * L * H >= (1LL << 31) ||
      static_cast<long long>(groups) * B * L * kD >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* part = static_cast<float*>(scratch);
  float* ypart = part + static_cast<size_t>(splits) * B * L * H;
  cudaError_t err = launch<false>(xf, static_cast<const float*>(w1), nullptr,
                                  nullptr, nullptr, nullptr, nullptr, part,
                                  B, L, H, k1, splits, 1, st);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long n4 = static_cast<long>(B) * L * H / 4;
    ffn_sum_kernel<<<(n4 + kThreadsSum - 1) / kThreadsSum, kThreadsSum, 0,
                     st>>>(part, splits, n4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = launch<true>(part, static_cast<const float*>(w2),
                     static_cast<const float*>(b1),
                     static_cast<const float*>(b2), xf,
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(beta),
                     groups > 1 ? ypart : static_cast<float*>(out), B, L, H,
                     k2, 1, groups, st);
  if (err != cudaSuccess || groups == 1) return err;
  const long n4 = static_cast<long>(B) * L * kD / 4;
  ffn_share_sum_kernel<<<(n4 + kThreadsShare - 1) / kThreadsShare,
                         kThreadsShare, 0, st>>>(
      ypart, static_cast<const float*>(b2), xf, groups, n4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * L;
  ffn_ln_f32_kernel<<<(rows + kRowsLN - 1) / kRowsLN, kThreadsLN, 0, st>>>(
      ypart, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(out), rows);
  return cudaGetLastError();
}

// Dynamic shared memory of a block of conv1 (conv2 != 0: of conv2), for the
// build report.
extern "C" int fs2_conv_ffn_f32_smem_bytes(int conv2) {
  return conv2 ? Cfg<true>::kSmemBytes : Cfg<false>::kSmemBytes;
}
