// K2, bfloat16: fused position-wise conv FFN forward for sm_90a, on bfloat16
// wgmma, the weights fed by TMA.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_ffn.py (_ffn_kernel via
// _pallas_forward) at --dtype bfloat16, which keeps one batch row's [L, H]
// hidden activation in VMEM.  Computes, on [B, L, D] row-major activations
// (D = 256),
//
//   h   = ReLU(conv1d_k1(x; w1 [k1, D, H]) + b1)          (SAME zero padding)
//   y   = conv1d_k2(h; w2 [k2, H, D]) + b2 + x
//   out = (y - mean) / sqrt(E[y^2] - mean^2 + 1e-5) * gamma + beta   (over D)
//
// Each k-tap conv is k shifted products (tap j reads row l + j - (k-1)/2);
// taps that fall outside [0, L) read zero.  It computes what the TPU kernel
// computes on a bfloat16 x: both convs on the bfloat16 tensor cores (exact
// products, float32 accumulation) with the weights rounded to bfloat16 (the
// TPU kernel's w.astype(x.dtype)); h = ReLU(sum + b1) with float32 b1,
// rounded to bfloat16; b2 and x added in float32; the LayerNorm in float32;
// the output rounded to bfloat16.  One level of sums: a bfloat16 h and
// output carry 2^-9 of rounding, far above the tensor cores' accumulation
// error.
//
// What bounds it on an H100: 2 L D H (k1 + k2) operations (5.24 GFLOP at
// L = 1000, H = 1024, k = (9, 1)) at the bfloat16 tensor cores' 989 TFLOP/s:
// 0.0053 ms at [1, 1000], 0.0848 ms at [16, 1000]; at L = 32 the 5.2 MB of
// bfloat16 weights (1.6 us at 3.35 TB/s), which asks that many SMs pull
// them at once.
//
// Design: both convs are implicit GEMMs on the float32 instance's machinery
// (conv_ffn_f32.cu; K4's resblock.cu): positions are M, output channels N,
// and each tap's input channels K.  A conv walks stages of (64 input
// channels, one tap), slices outer, taps inner:
//   - the weights are the B operand, read by wgmma from shared memory: the
//     stage's [256][64] bfloat16 rows (128 bytes), laid out in the 128-byte
//     swizzle once, when they are packed (ops/cuda_ffn.py), arrive by one
//     bulk copy into a ring with a full and an empty mbarrier per slot;
//     thread 0 refills a slot the block left a stage before;
//   - the activations are the A operand, from shared memory too: the
//     stage's [128 positions][64 channels] box of the bfloat16 input
//     (x, or h) arrives by TMA into the same slot, a tap's shift only the
//     box's first row, rows outside [0, L) filled with zeros by the copy
//     engine (the tensor map's bounds are one batch row's);
//   - per stage, 4 k-steps of 16 channels, each one m64n256k16 product
//     (both operands from shared memory) into the warpgroup's 64 x 256
//     float32 accumulator, which sums the whole tile (one level), with up
//     to two stages' products in flight;
//   - a block is two warpgroups, 64 positions each, sharing every weight
//     stage: a tile of 128 positions by 256 output channels;
//   - the grid is persistent (at most one block per SM), each block walking
//     its tiles' stages as one sequence, so the ring and the activation
//     loads run on from one tile into the next.
// Launches, h through device memory as bfloat16 (32.8 MB at [16, 1000]):
//   (a) conv1: the k1 taps may be split over S blocks (S divides k1), each
//       writing its partial sum of the pre-activation to part[S][B][L][H];
//       with S = 1 its epilogue writes h = bfloat16(ReLU(acc + b1)), with
//       S > 1 a wide elementwise launch sums the partials in order and
//       writes h so;
//   (b) conv2: its A operand is h.  With G = 1 it ends in the LayerNorm: y =
//       (acc + b2) + x, each thread's sums over its 64 values of a row (the
//       square by fma), a butterfly over the quad, then E[y^2] - mean^2 +
//       1e-5: the warpgroup holds all 256 output channels of its rows.
//       Where its grid would be a fraction of the card the hidden channels
//       split into G groups of whole slices, each writing its share to
//       ypart[G][B][L][256];
//   (c) with G > 1, one warp per row sums the shares in order, adds b2 and
//       the residual and writes the LayerNorm.
// So two launches at the large shapes, three at the smallest.  The plan
// (fs2_conv_ffn_plan) picks S and G by a cost model fitted to a sweep of
// every plan on an H100.  Accumulation order (tests/test_torch_conv_tiles.py
// models it): slices of 64 input channels, taps, k-steps of 16, each into
// the one float32 sum; the S partials and the G shares in order.  No
// atomics: two launches on the same inputs agree bit for bit.
//
// The float32 instance is conv_ffn_f32.cu (3xTF32 on wgmma, TMA).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace fs2_hopper;
using fs2_conv::sm_count;
using fs2_tc::pack_bf16;

using bf16 = __nv_bfloat16;

constexpr int kD = 256;
constexpr int kThreads = 256;          // two warpgroups
constexpr int kBM = 128;               // positions per tile (64 a warpgroup)
constexpr int kNB = 256;               // output channels per tile
constexpr int kSlice = 64;             // input channels per stage (128 B)
constexpr int kKSteps = kSlice / 16;   // k-steps per stage
constexpr int kStages = 4;             // the ring
constexpr uint32_t kPlaneBytes = kNB * kSlice * 2;   // B: 32 KB
constexpr uint32_t kABytes = kBM * kSlice * 2;       // A: 16 KB
constexpr uint32_t kStageBytes = kPlaneBytes + kABytes;
constexpr uint32_t kAtomBytes = 1024;  // 8 rows of 128 bytes
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kMaxSplits = 16;

// Both convs.  conv1: tin = x's tensor map ([B][L][256]), w = w1's pack,
// K = k1, S splits: out = h [B][L][H] bfloat16 (S = 1) or part[S][B][L][H]
// float32; b1 read for S = 1.  conv2: tin = h's ([B][L][H]), w = w2's
// pack, K = k2, G groups: out = the output [B][L][256] bfloat16 (G = 1) or
// ypart[G][B][L][256] float32; b2, x, gamma, beta read for G = 1.
template <bool kConv2>
__global__ void __launch_bounds__(kThreads, 1)
ffn_bf16_kernel(const __grid_constant__ CUtensorMap tin,
                const bf16* __restrict__ w,
                const float* __restrict__ b1, const float* __restrict__ b2,
                const bf16* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, void* __restrict__ out,
                int B, int L, int H, int K, int S, int G) {
  extern __shared__ unsigned char smem_raw[];
  // the ring (1,024-byte aligned for the swizzle: per slot the stage's
  // weights, B, then its activations, A), the barriers
  bf16* ring = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes / 2);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cout = kConv2 ? kD : H;         // the conv's output channels
  const int cin = kConv2 ? H : kD;          // its input channels
  const int l_tiles = (L + kBM - 1) / kBM;
  const int n_blocks = cout / kNB;          // 1 for conv2
  const int parts = kConv2 ? G : S;         // the K split
  const int tiles = l_tiles * n_blocks * B * parts;
  // stages per tile: conv1 (256 / 64 slices) x (K / S taps); conv2
  // (H / 64 / G slices) x K taps
  const int taps = kConv2 ? K : K / S;
  const int slices = kConv2 ? cin / kSlice / G : cin / kSlice;
  const int T = slices * taps;
  const int N = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * T;
  const int pad = (K - 1) / 2;
  // a tile's K split, batch row, first output channel and first position
  // (positions fastest, then batch rows, then output-channel blocks)
  auto coords = [&](int tile, int& sp, int& b, int& nb0, int& l0) {
    l0 = (tile % l_tiles) * kBM;
    int rest = tile / l_tiles;
    b = rest % B;
    rest /= B;
    nb0 = (rest % n_blocks) * kNB;
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
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads / 32);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the producer's step (thread 0): the stage at pc, the block's n-th, into
  // slot n % kStages once the stage before it there is released (a fresh
  // slot passes at once): its weights, rows nb0 .. of the pack
  // [cin/64][K][cout][64], by one bulk copy, and its activations, rows l0 +
  // j - pad .. of channels 64 sl .. of the input (rows outside [0, L) read
  // as zeros), by TMA
  Cursor pc;   // thread 0's: the next stage load_stage loads
  set_tile(pc, blockIdx.x);
  auto load_stage = [&](int n) {
    const int slot = n % kStages;
    mbar_wait(&empty[slot], ((n / kStages) & 1) ^ 1);
    mbar_expect_tx(&full[slot], kStageBytes);
    bf16* dst = ring + slot * (kStageBytes / 2);
    const bf16* src = w + ((static_cast<size_t>(pc.sl) * K + pc.j0 + pc.jt) *
                               cout + pc.nb0) * kSlice;
    bulk_load(dst, src, kPlaneBytes, &full[slot]);
    tma_load_3d(dst + kPlaneBytes / 2, &tin, &full[slot], pc.sl * kSlice,
                pc.l0 + pc.j0 + pc.jt - pad, pc.b);
    advance(pc);
  };
  if (tid == 0)
    for (int n = 0; n < N && n < kStages; ++n) load_stage(n);

  // this thread's rows of a tile: p0 and p0 + 8 of the accumulator
  const int row0 = 64 * wg + 16 * warp + g;
  float acc[kNB / 2];
  int n = 0;   // the block's stage counter
  // stage n: issue its products (`fresh`: the tile's first stage, whose
  // first product starts the accumulator), then wait for stage n - 1's
  // products and release their slot
  auto stage = [&](auto fresh) {
    const int slot = n % kStages;
    const bf16* wb = ring + slot * (kStageBytes / 2);
    const bf16* ab = wb + kPlaneBytes / 2 + wg * 64 * kSlice;
    mbar_wait(&full[slot], (n / kStages) & 1);
    if (!decltype(fresh)::value) reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kKSteps; ++q) {
      const uint64_t bd = make_desc(wb + 16 * q, 16, kAtomBytes);
      const uint64_t ad = make_desc(ab + 16 * q, 16, kAtomBytes);
      if (decltype(fresh)::value && q == 0)
        wgmma_bf16_ss256_first(acc, ad, bd);
      else
        wgmma_bf16_ss256(acc, ad, bd);
    }
    wgmma_commit();
    wgmma_wait<1>();   // stage n - 1's products are done
    // release stage n - 1's slot; thread 0 refills the one the block left
    // a stage before that (both warpgroups are past it by now)
    if (n > 0 && lane == 0) mbar_arrive(&empty[(n - 1) % kStages]);
    if (tid == 0 && n >= 2 && n - 2 + kStages < N) load_stage(n - 2 + kStages);
    __syncwarp();
    ++n;
  };
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    stage(std::true_type{});
#pragma unroll 1
    for (int i = 1; i < T; ++i) stage(std::false_type{});
    wgmma_wait<0>();
    reg_fence(acc);

    int sp, b, nb0, l0;
    coords(tile, sp, b, nb0, l0);
    const int p0 = l0 + row0;
    if constexpr (!kConv2) {
      // columns nb0 + 8 c + 2 t + e: h (S = 1) or split sp's partial
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        if (p >= L) continue;
        const size_t row = (static_cast<size_t>(b) * L + p) * H + nb0 + 2 * t;
        if (S == 1) {
          uint32_t* op = reinterpret_cast<uint32_t*>(out) + row / 2;
#pragma unroll
          for (int c = 0; c < kNB / 8; ++c) {
            const float2 bv =
                __ldg(reinterpret_cast<const float2*>(b1 + nb0 + 8 * c + 2 * t));
            op[4 * c] = pack_bf16(fmaxf(acc[4 * c + 2 * h] + bv.x, 0.f),
                                  fmaxf(acc[4 * c + 2 * h + 1] + bv.y, 0.f));
          }
        } else {
          float* op = static_cast<float*>(out) +
                      static_cast<size_t>(sp) * B * L * H + row;
#pragma unroll
          for (int c = 0; c < kNB / 8; ++c)
            *reinterpret_cast<float2*>(op + 8 * c) =
                make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
        }
      }
    } else {
      if (G > 1) {
        // this group's share
        float* op = static_cast<float*>(out) +
                    (static_cast<size_t>(sp) * B + b) * L * kD + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = p0 + 8 * h;
          if (p >= L) continue;
#pragma unroll
          for (int c = 0; c < kNB / 8; ++c)
            *reinterpret_cast<float2*>(op + static_cast<size_t>(p) * kD +
                                       8 * c) =
                make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
        }
        continue;
      }
      // the LayerNorm epilogue: y = (acc + b2) + x, in place in acc; the
      // quad's four lanes hold the row's 256 columns
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + 8 * h;
        const bool ok = p < L;
        const uint32_t* xr = reinterpret_cast<const uint32_t*>(x) +
                             ((static_cast<size_t>(b) * L + (ok ? p : 0)) * kD +
                              2 * t) / 2;
        float s = 0.f, sq = 0.f;
#pragma unroll
        for (int c = 0; c < kNB / 8; ++c) {
          const uint32_t xv = ok ? xr[4 * c] : 0u;
          const float2 bv =
              __ldg(reinterpret_cast<const float2*>(b2 + 8 * c + 2 * t));
          float& y0 = acc[4 * c + 2 * h];
          float& y1 = acc[4 * c + 2 * h + 1];
          y0 = y0 + bv.x + __uint_as_float(xv << 16);
          y1 = y1 + bv.y + __uint_as_float(xv & 0xffff0000u);
          s += y0;
          sq = fmaf(y0, y0, sq);
          s += y1;
          sq = fmaf(y1, y1, sq);
        }
#pragma unroll
        for (int off = 1; off <= 2; off *= 2) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        }
        const float mean = s / kD;
        const float var = sq / kD - mean * mean;
        const float inv = 1.f / sqrtf(var + 1e-5f);
        if (!ok) continue;
        uint32_t* op = static_cast<uint32_t*>(out) +
                       ((static_cast<size_t>(b) * L + p) * kD + 2 * t) / 2;
#pragma unroll
        for (int c = 0; c < kNB / 8; ++c) {
          const int col = 8 * c + 2 * t;
          op[4 * c] = pack_bf16(
              (acc[4 * c + 2 * h] - mean) * inv * gamma[col] + beta[col],
              (acc[4 * c + 2 * h + 1] - mean) * inv * gamma[col + 1] +
                  beta[col + 1]);
        }
      }
    }
  }
}

// Between the convs when the taps are split (S > 1): h = bfloat16(ReLU(the
// S partials summed in the order 0, 1, ... + b1)), two values a thread
constexpr int kThreadsSum = 256;

__global__ void __launch_bounds__(kThreadsSum)
ffn_hidden_bf16_kernel(const float* __restrict__ part,
                       const float* __restrict__ b1, uint32_t* __restrict__ h,
                       int S, int H, long n2) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n2) return;
  const float2* p = reinterpret_cast<const float2*>(part);
  float2 v[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < S) v[s] = p[s * n2 + i];   // every load issued before a sum
  float2 acc = v[0];
#pragma unroll
  for (int s = 1; s < kMaxSplits; ++s)
    if (s < S) {
      acc.x += v[s].x;
      acc.y += v[s].y;
    }
  const float2 bv =
      __ldg(reinterpret_cast<const float2*>(b1) + i % (H / 2));
  h[i] = pack_bf16(fmaxf(acc.x + bv.x, 0.f), fmaxf(acc.y + bv.y, 0.f));
}

// (c) with G > 1: out = LN(the groups' shares summed in order + b2 + x)
// over D = 256, one warp per row
constexpr int kThreadsLN = 256;

__global__ void __launch_bounds__(kThreadsLN)
ffn_ln_bf16_kernel(const float* __restrict__ ypart,
                   const float* __restrict__ b2, const bf16* __restrict__ x,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, bf16* __restrict__ out,
                   int rows, int groups) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreadsLN / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;   // warp-uniform
  const size_t plane = static_cast<size_t>(rows) * kD;
  const size_t at = static_cast<size_t>(r) * kD + lane;
  float y[kD / 32];
#pragma unroll
  for (int u = 0; u < kD / 32; ++u) y[u] = ypart[at + 32 * u];
#pragma unroll 4
  for (int grp = 1; grp < groups; ++grp) {
    const float* p = ypart + grp * plane + at;
#pragma unroll
    for (int u = 0; u < kD / 32; ++u) y[u] += p[32 * u];
  }
  float s = 0.f, sq = 0.f;
#pragma unroll
  for (int u = 0; u < kD / 32; ++u) {
    y[u] = y[u] + __ldg(b2 + lane + 32 * u) + __bfloat162float(x[at + 32 * u]);
    s += y[u];
    sq = fmaf(y[u], y[u], sq);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  const float mean = s / kD;
  const float var = sq / kD - mean * mean;
  const float inv = 1.f / sqrtf(var + 1e-5f);
#pragma unroll
  for (int u = 0; u < kD / 32; ++u) {
    const int col = lane + 32 * u;
    out[at + 32 * u] =
        __float2bfloat16_rn((y[u] - mean) * inv * gamma[col] + beta[col]);
  }
}

template <bool kConv2>
cudaError_t launch(const bf16* in, const bf16* w, const float* b1,
                   const float* b2, const bf16* x, const float* gamma,
                   const float* beta, void* out, int B, int L, int H, int K,
                   int S, int G, cudaStream_t st) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ffn_bf16_kernel<kConv2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const long long tiles = static_cast<long long>((L + kBM - 1) / kBM) *
                          ((kConv2 ? kD : H) / kNB) * B * (kConv2 ? G : S);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  CUtensorMap tin;
  if (!tensor_map_rows_bf16(&tin, in, kConv2 ? H : kD, L, B, kBM))
    return cudaErrorInvalidValue;
  ffn_bf16_kernel<kConv2><<<grid, kThreads, kSmemBytes, st>>>(
      tin, w, b1, b2, x, gamma, beta, out, B, L, H, K, S, G);
  return cudaGetLastError();
}

// The plan's cost model, in microseconds of device time on an H100 (from a
// sweep of every plan at the paths' shapes): one stage of one block (two
// warpgroups' four m64n256k16 products each), a block's first stages' wait
// for the ring in stages, a small launch (the partials' sum, the
// LayerNorm), the LayerNorm's time per share it sums (its warps read the
// shares in turn), and the device memory's rate for the partials and
// shares (written once, read once)
constexpr double kStageUs = 0.8;
constexpr double kPrologueStages = 2.0;
constexpr double kLaunchUs = 2.0;
constexpr double kGroupUs = 0.25;   // per share the LayerNorm launch reads
constexpr double kBytesPerUs = 3.35e6;

// the modelled time of a conv of `tiles` tiles, `stages` stages each, on a
// persistent grid of one block per SM
double conv_us(long long tiles, int stages) {
  const long long per = (tiles + sm_count() - 1) / sm_count();
  return (static_cast<double>(per) * stages + kPrologueStages) * kStageUs;
}

// the hidden groups conv2 may take: a power of two dividing H / 64
bool groups_ok(int H, int grp) {
  return grp >= 1 && (grp & (grp - 1)) == 0 && (H / kSlice) % grp == 0;
}

}  // namespace

// K2's bfloat16 plan at [B, L, 256] -> H with a k1-tap first conv and a
// k2-tap second one (the float32 instance has its own,
// fs2_conv_ffn_f32_plan):
//   cfg[0] = the tap splits S of conv1, a divisor of k1 (at most 16);
//   cfg[1] = the hidden groups G of conv2 (groups_ok);
// each the one whose modelled time is least, the smallest on a tie: the
// conv's stages over the persistent grid, plus for S > 1 the partials'
// bytes and their sum's launch, for G > 1 the shares' bytes and the
// LayerNorm's launch.  Returns the floats of scratch the call needs: h
// (B L H bfloat16 values), then, with S > 1, S B L H partial sums of
// conv1, then, with G > 1, G B L 256 shares of conv2.
extern "C" long long fs2_conv_ffn_plan(int B, int L, int H, int k1, int k2,
                                       int* cfg) {
  const double rows = static_cast<double>(B) * L;
  const long long tiles1 =
      static_cast<long long>((L + kBM - 1) / kBM) * (H / kNB) * B;
  int splits = 1;
  double best = -1.0;
  for (int s = 1; s <= k1 && s <= kMaxSplits; ++s) {
    if (k1 % s) continue;
    double us = conv_us(tiles1 * s, kD / kSlice * k1 / s);
    if (s > 1)
      us += kLaunchUs + (2.0 * s + 0.5) * rows * H * sizeof(float) /
                            kBytesPerUs;
    if (best < 0.0 || us < best) {
      best = us;
      splits = s;
    }
  }
  const long long tiles2 = static_cast<long long>((L + kBM - 1) / kBM) * B;
  int groups = 1;
  best = -1.0;
  for (int grp = 1; grp <= H / kSlice; grp *= 2) {
    if (!groups_ok(H, grp)) continue;
    double us = conv_us(tiles2 * grp, H / kSlice / grp * k2);
    if (grp > 1)
      us += kLaunchUs + kGroupUs * grp +
            (2.0 * grp + 1.0) * rows * kD * sizeof(float) / kBytesPerUs;
    if (best < 0.0 || us < best) {
      best = us;
      groups = grp;
    }
  }
  cfg[0] = splits;
  cfg[1] = groups;
  return (static_cast<long long>(H) / 2 +
          (splits > 1 ? static_cast<long long>(splits) * H : 0) +
          (groups > 1 ? static_cast<long long>(groups) * kD : 0)) *
         B * L;
}

// x, out: [B, L, D] bfloat16; w1, w2: the bfloat16 packs of conv1
// ([D/64][k1][H][64]) and conv2 ([H/64][k2][D][64]): for each (64-channel
// slice, tap) the weights as [C_out][64] rows in the 128-byte swizzle
// (ops/cuda_ffn.py); b1: [H]; b2, gamma, beta: [D]; scratch:
// fs2_conv_ffn_plan's floats; b1, b2, gamma, beta and the scratch float32.
// All contiguous, 16-byte aligned.  Takes D = 256, H a multiple of 256, k1,
// k2 >= 1 (a k-tap conv pads (k-1)/2 zeros before and k/2 after, SAME),
// splits dividing k1 (at most 16) and groups as groups_ok takes them, as
// fs2_conv_ffn_plan gives them.  Launches the two convs on `stream`, with
// the partials' sum between them for splits > 1 and the LayerNorm after
// them for groups > 1; returns cudaGetLastError() after each (or
// cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int fs2_conv_ffn_fwd_bf16(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* gamma,
                                     const void* beta, void* scratch,
                                     void* out, int B, int L, int D, int H,
                                     int k1, int k2, int splits, int groups,
                                     void* stream) {
  if (D != kD || H <= 0 || H % kNB != 0 || B <= 0 || L <= 0 || k1 <= 0 ||
      k2 <= 0 || splits <= 0 || splits > kMaxSplits || k1 % splits != 0 ||
      !groups_ok(H, groups) ||
      static_cast<long long>(splits) * B * L * H >= (1LL << 31) ||
      static_cast<long long>(groups) * B * L * kD >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xs = static_cast<const bf16*>(x);
  const float* b1f = static_cast<const float*>(b1);
  bf16* hid = static_cast<bf16*>(scratch);
  float* part = static_cast<float*>(scratch) + static_cast<size_t>(B) * L * H / 2;
  float* ypart = part + (splits > 1 ? static_cast<size_t>(splits) * B * L * H : 0);
  cudaError_t err = launch<false>(
      xs, static_cast<const bf16*>(w1), b1f, nullptr, nullptr, nullptr,
      nullptr, splits > 1 ? static_cast<void*>(part) : static_cast<void*>(hid),
      B, L, H, k1, splits, 1, st);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long n2 = static_cast<long>(B) * L * H / 2;
    ffn_hidden_bf16_kernel<<<(n2 + kThreadsSum - 1) / kThreadsSum,
                             kThreadsSum, 0, st>>>(
        part, b1f, reinterpret_cast<uint32_t*>(hid), splits, H, n2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = launch<true>(hid, static_cast<const bf16*>(w2), nullptr,
                     static_cast<const float*>(b2), xs,
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(beta),
                     groups > 1 ? static_cast<void*>(ypart) : out, B, L, H,
                     k2, 1, groups, st);
  if (err != cudaSuccess || groups == 1) return err;
  const int rows = B * L;
  ffn_ln_bf16_kernel<<<(rows + kThreadsLN / 32 - 1) / (kThreadsLN / 32),
                       kThreadsLN, 0, st>>>(
      ypart, static_cast<const float*>(b2), xs,
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(out), rows, groups);
  return cudaGetLastError();
}

// Dynamic shared memory of a block of either conv, for the build report.
extern "C" int fs2_conv_ffn_bf16_smem_bytes() { return kSmemBytes; }
