// K4: the convolutions of a HiFi-GAN MRF ResBlock, float32 on Hopper's
// tensor cores (3xTF32 on wgmma, the weights fed by TMA), for sm_90a.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_resblock.py
// (_resblock_kernel via _pallas_forward), which fuses a whole ResBlock
// (3 dilation units) over one L tile and its halo in VMEM.  On channels-first
// [B, C, L] activations, one dilation unit d with k-tap convs is
//
//   t   = lrelu(conv_{k,d}(lrelu(x); w1) + b1)
//   out = x + conv_{k,1}(t; w2) + b2
//
// with lrelu slope 0.1 and SAME zero padding on each conv's own input:
// (k-1)/2 * d positions for the first conv, (k-1)/2 for the second.  Tap j
// of a conv dilated by d reads position l + (j - (k-1)/2) * d; positions
// outside [0, L) read 0.  The first conv's input is lrelu(x), and
// lrelu(0) = 0, so a zero read is exact there; the second conv reads t,
// which is 0 outside [0, L) (never lrelu(b1 + partial sums)).  A unit is two
// launches of one kernel, t through device memory:
//
//   first:  t   = lrelu(conv_{k,d}(lrelu(in); w1) + b1)
//   second: out = res + (conv_{k,1}(in = t; w2) + b2)     (res = x)
//
// What bounds it on an H100: 4 k C^2 L operations per unit, 3xTF32 on the
// tensor cores (3 x operations / 495 TFLOP/s: 38.43 ms for the six iSTFT
// ResBlocks at batch 16, 3.603 ms for the twelve of a 1000-frame parity
// forward), against five float32 passes over [C, L] per unit (x, t written
// and read, x again, out): operations at C >= 64, bytes at C = 32.
//
// Why t goes through device memory: a wgmma tile is 64 positions, so the
// halo of t that a fused unit recomputes costs a whole extra 64-position
// tile of the first conv, and t's big and small planes for the widest
// useful tile exceed the 227 KB of shared memory at C = 128 beside the
// weight ring.  t's write and read (2 C L floats per unit) run under the
// products' time at C >= 128 (PERF.md gives the measurements).
//
// Design: the conv is a GEMM, out[co][l] += sum over taps j and input
// channels c of W_j[co][c] in[c][l + (j - (k-1)/2) d], with positions as
// M, output channels as N and each tap's input channels as K.  A block of
// two warpgroups owns 128 positions (64 each) of NB output channels of one
// batch row: NB = C, or C/2, C/4 where a grid of whole-C blocks would
// leave most of the card idle (fs2_resblock_n_block: [1, 256, 8000] runs as
// 126 blocks of 128 channels on 132 SMs, not 63).  It walks stages of
// (32 input channels, one tap), slices outer, taps inner:
//   - the weights are the B operand, read by wgmma from shared memory: the
//     stage's [NB][32] tf32 big and small planes, split and laid out in the
//     128-byte swizzle once, when they are packed (ops/cuda_resblock.py),
//     arrive by two bulk copies (TMA) into a ring of kStages stages with a
//     full and an empty mbarrier each; thread 0 refills the slot the block
//     left a stage before, once all eight warps released it;
//   - the activations are the A operand, from registers: each thread loads
//     its 16 values of the stage (4 k-steps of the fragment's 4) straight
//     from global memory one stage ahead (L1 serves the taps' overlap),
//     zero outside [0, L), and splits them (lrelu first, for the first
//     conv) when the stage begins.  A tap's shift is only another start
//     address, and each loaded value feeds all NB output channels;
//   - per stage, 4 k-steps of 8 channels, each three m64nNk8 products in
//     the order x_small w_big, x_big w_small, x_big w_big (3xTF32: the
//     small*small term dropped), issued as one group and waited for
//     before the next stage's fragments are written, so that no write
//     touches a register an in-flight product reads (ptxas would serialise
//     every product); the other warpgroup's group keeps the tensor cores
//     busy meanwhile, and the next stage's activation loads are in flight;
//   - the grid is persistent (at most the blocks the card holds at once),
//     each block walking its tiles' stages as one sequence, so that the
//     ring and the activation loads run on from one tile into the next;
//     the epilogue adds the bias and applies lrelu (first) or adds the
//     residual (second) from the accumulators, guarding positions past L.
// Accumulation order, the same for every tile and grid, so the result does
// not depend on them (tests/test_torch_conv_tiles.py models it): slices of
// 32 input channels, taps, k-steps of 8, the three products.  No atomics:
// two launches on the same inputs agree bit for bit.  `out` may alias
// `res` (each element is read and then written by one thread), never `in`.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace fs2_hopper;
using fs2_conv::sm_count;
using fs2_tc::split;

constexpr int kWGs = 2;
constexpr int kThreads = 128 * kWGs;
constexpr int kBM = 64 * kWGs;         // positions per block
constexpr int kSlice = 32;             // input channels per stage (128 B)
constexpr int kKSteps = kSlice / 8;    // k-steps per stage
constexpr uint32_t kAtomBytes = 1024;  // 8 rows of 128 bytes
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float lrelu(float v) {
  return v > 0.f ? v : kSlope * v;
}

// NB output channels per block: a stage is two [NB][32] tf32 planes; the
// ring fills ~192 KB at NB >= 128 (one block per SM), and leaves room for
// two blocks per SM at NB <= 64
template <int NB>
struct Cfg {
  static constexpr uint32_t kPlaneBytes = NB * kSlice * 4;
  static constexpr int kStages = NB == 256 ? 3 : 6;
  static constexpr int kMinBlocks = NB <= 64 ? 2 : 1;
  static constexpr int kSmemBytes =
      kStages * 2 * kPlaneBytes + 2 * kStages * 8 + 1024;
};

template <int NB, bool kFirst>
__global__ void __launch_bounds__(kThreads, Cfg<NB>::kMinBlocks)
resblock_wgmma_kernel(const float* __restrict__ in,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, const float* res,
                      float* out, int B, int C, int L, int K, int d) {
  using G = Cfg<NB>;
  constexpr int S = G::kStages;
  constexpr int kPlane = NB * kSlice;   // floats
  extern __shared__ unsigned char smem_raw[];
  // the ring (1,024-byte aligned for the swizzle), then the barriers
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * 2 * kPlane);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // tiles of kBM positions by NB channels, positions fastest; this block
  // takes blockIdx.x, + gridDim.x, ... (grid <= tiles), and runs their
  // stages as one sequence n = 0 .. N - 1, so that the ring runs on from
  // one tile into the next
  const int l_tiles = (L + kBM - 1) / kBM;
  const int tiles = l_tiles * (C / NB) * B;
  const int T = (C / kSlice) * K;   // stages per tile, in the pack's order
  const int N = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * T;
  const int H = (K - 1) / 2;
  // a tile's batch row, first channel and first position
  auto coords = [&](int tile, int& b, int& nb0, int& l0) {
    l0 = (tile % l_tiles) * kBM;
    const int rest = tile / l_tiles;
    nb0 = (rest % (C / NB)) * NB;
    b = rest / (C / NB);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads / 32);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the producer's step (thread 0): stage n into slot n % S once the stage
  // before it there is released (a fresh slot passes at once).  The pack is
  // [C/32][K][2][C][32]: the stage's two planes, rows nb0 .. nb0 + NB - 1
  auto load_stage = [&](int n) {
    const int slot = n % S;
    int b, nb0, l0;
    coords(blockIdx.x + n / T * gridDim.x, b, nb0, l0);
    mbar_wait(&empty[slot], ((n / S) & 1) ^ 1);
    mbar_expect_tx(&full[slot], 2 * G::kPlaneBytes);
    const float* src =
        w + (static_cast<size_t>(n % T) * 2 * C + nb0) * kSlice;
#pragma unroll
    for (int p = 0; p < 2; ++p)
      bulk_load(ring + (slot * 2 + p) * kPlane,
                src + static_cast<size_t>(p) * C * kSlice, G::kPlaneBytes,
                &full[slot]);
  };
  if (tid == 0)
    for (int n = 0; n < N && n < S; ++n) load_stage(n);

  // stage i of a tile: raw[4 q + 2 e + h] = in[b][32 s + 8 q + 4 e + t]
  // [p0 + 8 h + (j - H) d] (i = s K + j), 0 outside [0, L): the A
  // fragment's a0..a3 of k-step q
  float raw[4 * kKSteps];
  auto load_raw = [&](int tile, int i) {
    int b, nb0, l0;
    coords(tile, b, nb0, l0);
    const int s = i / K;
    const int pos = l0 + 64 * wg + 16 * warp + g + (i - s * K - H) * d;
    const bool v0 = static_cast<unsigned>(pos) < static_cast<unsigned>(L);
    const bool v1 =
        static_cast<unsigned>(pos + 8) < static_cast<unsigned>(L);
    const float* row =
        in + (static_cast<size_t>(b) * C + s * kSlice + t) * L + pos;
#pragma unroll
    for (int q = 0; q < kKSteps; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int off = (8 * q + 4 * e) * L;
        raw[4 * q + 2 * e] = v0 ? __ldg(row + off) : 0.f;
        raw[4 * q + 2 * e + 1] = v1 ? __ldg(row + off + 8) : 0.f;
      }
  };

  float acc[NB / 2];
  uint32_t xb[kKSteps][4], xs[kKSteps][4];   // big and small planes of A
  int n = 0;   // the block's stage counter
  // one stage: split the landed activations, issue the products, load the
  // next stage's activations while they run, wait for them, then release
  // the weights.  `fresh`: the tile's first stage, whose first product
  // starts the accumulator
  auto stage = [&](auto fresh, int tile, int i) {
#pragma unroll
    for (int q = 0; q < kKSteps; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split(kFirst ? lrelu(raw[4 * q + r]) : raw[4 * q + r], xb[q][r],
              xs[q][r]);
    const int slot = n % S;
    const float* wb = ring + slot * 2 * kPlane;   // big plane
    const float* wsm = wb + kPlane;               // small plane
    mbar_wait(&full[slot], (n / S) & 1);
    // every register the products touch is tied to a point before the
    // fence, so that the compiler moves no write of one past it
    if (!decltype(fresh)::value) reg_fence(acc);
#pragma unroll
    for (int q = 0; q < kKSteps; ++q) {
      reg_fence(xb[q]);
      reg_fence(xs[q]);
    }
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kKSteps; ++q) {
      const uint64_t big = make_desc(wb + 8 * q, 16, kAtomBytes);
      if (decltype(fresh)::value && q == 0)
        wgmma_tf32_rs_first<NB>(acc, xs[q], big);
      else
        wgmma_tf32_rs<NB>(acc, xs[q], big);
      wgmma_tf32_rs<NB>(acc, xb[q], make_desc(wsm + 8 * q, 16, kAtomBytes));
      wgmma_tf32_rs<NB>(acc, xb[q], big);
    }
    wgmma_commit();
    if (i + 1 < T)
      load_raw(tile, i + 1);
    else if (tile + static_cast<int>(gridDim.x) < tiles)
      load_raw(tile + gridDim.x, 0);
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int q = 0; q < kKSteps; ++q) {
      reg_fence(xb[q]);
      reg_fence(xs[q]);
    }
    // release the slot; thread 0 fills the one the block left a stage
    // ago (both warpgroups are past it by now) with stage n - 1 + S
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (tid == 0 && n >= 1 && n - 1 + S < N) load_stage(n - 1 + S);
    __syncwarp();
    ++n;
  };

  load_raw(blockIdx.x, 0);
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    stage(std::true_type{}, tile, 0);
#pragma unroll 1
    for (int i = 1; i < T; ++i) stage(std::false_type{}, tile, i);

    // the epilogue, kChunk accumulator columns at a time: the second
    // conv's residuals of a chunk are loaded before any of its stores
    // (out may be res, so a load is never moved past a store: one load
    // after another would each wait a round trip)
    int b, nb0, l0;
    coords(tile, b, nb0, l0);
    const int p0 = l0 + 64 * wg + 16 * warp + g;
    const float* res_t = res + static_cast<size_t>(b) * C * L;
    float* out_t = out + static_cast<size_t>(b) * C * L;
    constexpr int kChunk = NB / 16 < 8 ? NB / 16 : 8;   // registers
#pragma unroll
    for (int j0 = 0; j0 < NB / 8; j0 += kChunk) {
      float r[kChunk][2][2];
#pragma unroll
      for (int jn = 0; jn < kChunk; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = nb0 + 8 * (j0 + jn) + 2 * t + e;
            const int l = p0 + 8 * h;
            r[jn][e][h] = !kFirst && l < L
                              ? res_t[static_cast<size_t>(co) * L + l]
                              : 0.f;
          }
#pragma unroll
      for (int jn = 0; jn < kChunk; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = nb0 + 8 * (j0 + jn) + 2 * t + e;
          const float bv = __ldg(bias + co);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int l = p0 + 8 * h;
            if (l < L) {
              const float v = acc[4 * (j0 + jn) + 2 * h + e] + bv;
              out_t[static_cast<size_t>(co) * L + l] =
                  kFirst ? lrelu(v) : r[jn][e][h] + v;
            }
          }
        }
    }
  }
}

template <int NB, bool kFirst>
cudaError_t launch(const float* in, const float* w, const float* bias,
                   const float* res, float* out, int B, int C, int L, int k,
                   int d, cudaStream_t s) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        resblock_wgmma_kernel<NB, kFirst>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<NB>::kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  // persistent: at most the blocks the card holds at once
  const long long tiles =
      static_cast<long long>((L + kBM - 1) / kBM) * (C / NB) * B;
  const long long most = static_cast<long long>(sm_count()) *
                         Cfg<NB>::kMinBlocks;
  const int grid = static_cast<int>(tiles < most ? tiles : most);
  resblock_wgmma_kernel<NB, kFirst><<<grid, kThreads, Cfg<NB>::kSmemBytes,
                                      s>>>(in, w, bias, res, out, B, C, L, k,
                                           d);
  return cudaGetLastError();
}

template <bool kFirst>
cudaError_t dispatch(const float* in, const float* w, const float* bias,
                     const float* res, float* out, int B, int C, int L,
                     int k, int d, int nb, cudaStream_t s) {
  switch (nb) {
    case 32: return launch<32, kFirst>(in, w, bias, res, out, B, C, L, k, d, s);
    case 64: return launch<64, kFirst>(in, w, bias, res, out, B, C, L, k, d, s);
    case 128:
      return launch<128, kFirst>(in, w, bias, res, out, B, C, L, k, d, s);
    case 256:
      return launch<256, kFirst>(in, w, bias, res, out, B, C, L, k, d, s);
    default: return cudaErrorInvalidValue;
  }
}

bool valid_channels(int n) {
  return n == 32 || n == 64 || n == 128 || n == 256;
}

}  // namespace

// Output channels per block at [B, C, L]: C, halved while a grid of the
// halved width still fits one wave of the card's SMs (a batch-1 grid of
// whole-C blocks would leave most of them idle).
extern "C" int fs2_resblock_n_block(int B, int C, int L) {
  int nb = C;
  long long blocks = static_cast<long long>((L + kBM - 1) / kBM) * B;
  while (nb > 32 && 2 * blocks <= sm_count()) {
    nb /= 2;
    blocks *= 2;
  }
  return nb;
}

// Dynamic shared memory of a block at nb output channels, or 0 for an nb
// the kernel does not take.
extern "C" int fs2_resblock_smem_bytes(int nb) {
  switch (nb) {
    case 32: return Cfg<32>::kSmemBytes;
    case 64: return Cfg<64>::kSmemBytes;
    case 128: return Cfg<128>::kSmemBytes;
    case 256: return Cfg<256>::kSmemBytes;
    default: return 0;
  }
}

// One conv of a dilation unit on `stream`.  first != 0: out = lrelu(conv
// dilated by d of lrelu(in) + bias) (res unused); first == 0: out = res +
// (conv dilated by d of in + bias), out may be res.  in, res, out:
// [B, C, L]; w: the conv's pack, [C/32][k][2][C][32] floats (the big and
// small tf32 planes of each (32-channel slice, tap), rows in the 128-byte
// swizzle: ops/cuda_resblock.py); bias: [C].  All float32, contiguous, w
// 16-byte aligned.  C in {32, 64, 128, 256}, k in {3, 7, 11}, 1 <= d <= 64,
// L >= 1; nb output channels per block (32 .. C, a power of two), or 0 for
// fs2_resblock_n_block's.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int fs2_resblock_conv_f32(const void* in, const void* w,
                                     const void* bias, const void* res,
                                     void* out, int B, int C, int L, int k,
                                     int d, int first, int nb,
                                     void* stream) {
  if (B <= 0 || L <= 0 || !valid_channels(C) || d <= 0 || d > 64 ||
      (k != 3 && k != 7 && k != 11) ||
      static_cast<long long>(C) * L >= (1LL << 31) ||
      static_cast<long long>((L + kBM - 1) / kBM) * B * C / 32 >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (nb == 0) nb = fs2_resblock_n_block(B, C, L);
  if (!valid_channels(nb) || nb > C) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* inf = static_cast<const float*>(in);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  const float* rf = static_cast<const float*>(res);
  float* of = static_cast<float*>(out);
  if (first) return dispatch<true>(inf, wf, bf, rf, of, B, C, L, k, d, nb, s);
  return dispatch<false>(inf, wf, bf, rf, of, B, C, L, k, d, nb, s);
}
