// K1, bfloat16: fused masked multi-head self-attention forward for sm_90a,
// on wgmma and TMA.
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_attention.py
// (_mha_kernel via _pallas_forward_impl) at --dtype bfloat16, and computes
// what it computes on bfloat16 q, k, v ([B, H, L, 128] row-major): S = Q K^T
// with float32 accumulation (exact products), the scale applied after the
// product, the FINITE -1e9 mask on padded keys (a fully padded row comes
// out as the uniform mean of V; padded tiles are never skipped), a float32
// online softmax, P rounded to bfloat16 before the product with V into a
// float32 accumulator, the output rounded to bfloat16.  The rounded P is
// the running exp(s - m), the normaliser 1/l applied to the float32 sum at
// the end (the TPU kernel rounds the normalised P: the two differ by less
// than an ulp of bfloat16 in each term).  Keys at or past L (the ragged
// edge) get P = 0.
//
// What bounds it on an H100: the two products, 4 L^2 Dh operations per
// (b, h), at the bfloat16 tensor cores' 989 TFLOP/s, against 4 L Dh 2-byte
// tensors: at L = 1000 ~500 operations per byte, above the ridge (~295),
// so operations.  Only wgmma reaches that rate.
//
// Design (FlashAttention-3's shape, kept simple): a block of two
// warpgroups, 64 query rows each, sharing every K and V tile.  One elected
// thread loads Q once by TMA, then K and V tiles of 64 keys into a
// five-stage ring, each stage with its own mbarriers for K and for V and one
// for its release by the eight warps (tensor maps over [B*H, L, 128]: rows
// past L arrive as zeros and never read the next head); it refills a stage
// as soon as both warpgroups release it, four tiles ahead of them.  Per tile
// a warpgroup forms S = Q K^T by score_tile_wgmma (attention_bf16.cuh: Q as
// A and K as B, both K-major from shared memory, eight m64n64k16 products)
// and O += P V by four m64n128k16 products whose A is P from registers (S's
// accumulator rounded pairwise to bfloat16 is the A fragment as it stands)
// and whose B is V read MN-major (transposed) from shared memory.  The
// softmax, not the products, bounds this kernel on the card (test builds
// without the exponentials lost far more time than builds without either
// product), so the loop overlaps them: tile i + 1's S and tile i's P V are
// in flight together while the softmax of tile i + 1 runs, and the two
// warpgroups take turns at the tensor cores (attention_bf16.cuh:
// turn_wait), one's softmax beside the other's products.  The softmax's
// max and sum are pairwise trees, keys past L enter as kInitMax (no
// select), the exponential is exp_shifted's, and O is rescaled only when a
// row's max moved.  The exponential's ex2.approx (~2 ulp) stands where the
// TPU kernel takes exp: K1's P is rounded to bfloat16 and K3 takes the same
// function, so K3's P sums to 1 with K1's row sums.  Shared memory: Q 32
// KB plus five stages of K and V, 192 KB and the barriers: one block of 256
// threads per SM, so each thread may hold 255 registers (a separate
// producer warp would cap them at 168, which ptxas keeps whatever
// setmaxnreg asks).  Nothing is summed by atomics: every sum has a fixed
// order, so every launch gives the same bits.
//
// Filling the card: the (query tile, b*h) grid is 160 blocks at [10, 2,
// 1000, 128] and 16 at [1, 2, 1000, 128].  The keys may be split into
// chunks (flash-decoding): each (query tile, b*h, chunk) block writes its
// float32 partial (row max, row sum, accumulator) to scratch and a second
// launch combines the chunks in the order 0, 1, ....  The plan (below)
// costs each chunk count by its waves and by the partials' bytes written and
// read back, so the split pays only where the grid is a fraction of a wave:
// at [1, 2, 1000, 128] and not at [10, 2, 1000, 128].
//
// For training the kernel also writes each row's final max m and sum l (P =
// exp(s - m) / l); K3 (attention_bwd_bf16.cu) recomputes every score through
// score_tile_wgmma and tile_scores, bit for bit K1's.

#include <cuda_runtime.h>

#include <algorithm>

#include "attention_bf16.cuh"

namespace {

using namespace fs2_attn;

constexpr int kWGs = 2;           // warpgroups, 64 query rows each
constexpr int kBM = 64 * kWGs;    // query rows per block
constexpr int kBN = 64;           // keys per tile
constexpr int kStages = 5;
constexpr int kThreads = 128 * kWGs;
constexpr int kBlocksPerSM = 1;   // what the shared memory below allows

// shared memory: boxes (1,024-byte aligned) then the barriers
struct FwdSmem {
  bf16 q[kWGs][2 * kBoxElems];
  bf16 k[kStages][2 * kBoxElems];
  bf16 v[kStages][2 * kBoxElems];
  uint64_t full_q;
  uint64_t full_k[kStages];
  uint64_t full_v[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(FwdSmem) + 1024;

// loads the [64][128] tile at row r0 of head bh as its two boxes
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh) {
  tma_load_3d(dst, map, bar, 0, r0, bh);
  tma_load_3d(dst + kBoxElems, map, bar, kBox, r0, bh);
}

// the producer's step: key tile kt (the i-th of the block's chunk) into
// stage i % kStages once its previous tile is released (a fresh stage
// passes at once)
__device__ __forceinline__ void load_kv(FwdSmem& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int i, int kt,
                                        int bh) {
  const int s = i % kStages;
  mbar_wait(&sm.empty[s], ((i / kStages) & 1) ^ 1);
  mbar_expect_tx(&sm.full_k[s], kTileBytes);
  load_tile(sm.k[s], tk, &sm.full_k[s], kt * kBN, bh);
  mbar_expect_tx(&sm.full_v[s], kTileBytes);
  load_tile(sm.v[s], tv, &sm.full_v[s], kt * kBN, bh);
}

// the max and the sum over one row's 16 values of a 64-key accumulator
// (x[4j + 2h + e], j = 0..7, e = 0..1) as pairwise trees, in a fixed order
__device__ __forceinline__ float row_max16(const float (&x)[32], int h) {
  float a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = fmaxf(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] = fmaxf(a[j], a[j + w]);
  return a[0];
}

__device__ __forceinline__ float row_sum16(const float (&x)[32], int h) {
  float a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = x[4 * j + 2 * h] + x[4 * j + 2 * h + 1];
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] = a[j] + a[j + w];
  return a[0];
}

// The online softmax of one tile's scores x (raw S in, P out): the rows'
// new max m (from their running max), the factor alpha = exp(m_old - m)
// their running sums l and the output take, and P = exp(x - m) as the
// k-steps' A fragments rounded to bfloat16
__device__ __forceinline__ void softmax_tile(float (&x)[32], uint64_t valid,
                                             uint64_t padded, int t,
                                             float scale, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             uint32_t (&pa)[4][4]) {
  tile_scores(x, valid, padded, t, scale);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mx = quad_max(fmaxf(m[h], row_max16(x, h)));
    alpha[h] = exp_shifted(m[h] - mx);
    m[h] = mx;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = exp_shifted(x[i] - m[(i / 2) % 2]);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = l[h] * alpha[h] + quad_sum(row_sum16(x, h));
  // P of keys 16kk..16kk+15, rounded to bfloat16: k-step kk's A fragment
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mha_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const unsigned char* __restrict__ key_pad,
                    bf16* __restrict__ out, float* __restrict__ row_max,
                    float* __restrict__ row_sum, float* __restrict__ part_o,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    int H, int L, float scale, int tiles_per_chunk) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(align_smem(smem_raw));

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
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty[s], kThreads / 32);   // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {   // the producer's first steps: Q, and the ring filled
    mbar_expect_tx(&sm.full_q, kWGs * kTileBytes);
    for (int w = 0; w < kWGs; ++w)
      load_tile(sm.q[w], &tq, &sm.full_q, blockIdx.x * kBM + 64 * w, bh);
    for (int i = 0; i < min(n, kStages); ++i)
      load_kv(sm, &tk, &tv, i, t_begin + i, bh);
  }
  __syncwarp();

  // rows g and g + 8 of the warp's 16: running max, running sum; the
  // output accumulator o[4n + 2h + e] at column 8n + 2t + e
  float m[2] = {kInitMax, kInitMax};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float x[32];
  uint32_t pa[4][4], pb[4][4];   // P of a tile and of the next, in turn
  uint64_t valid, padded;

  // tile 0's scores and softmax
  turn_first(wg);
  tile_mask(tile_pad(pad, t_begin * kBN, L, lane), t_begin * kBN, L, &valid,
            &padded);
  TilePad next_pad = tile_pad(pad, (t_begin + 1) * kBN, L, lane);
  mbar_wait(&sm.full_q, 0);
  mbar_wait(&sm.full_k[0], 0);
  turn_wait(wg);
  wgmma_fence();
  score_tile_wgmma(x, sm.q[wg], sm.k[0]);
  wgmma_commit();
  turn_pass(wg);
  wgmma_wait<0>();
  reg_fence(x);
  softmax_tile(x, valid, padded, t, scale, m, l, alpha, pa);

  // step i: tile i's P V and tile i + 1's S in flight together, then tile
  // i + 1's softmax while P V runs.  P's fragments alternate between pa and
  // pb (the loop is unrolled by two) so that the softmax never writes
  // registers an in-flight product reads, which would serialise the products
  auto step = [&](uint32_t(&p_cur)[4][4], uint32_t(&p_next)[4][4], int i) {
    const int s = i % kStages;
    const int s1 = (i + 1) % kStages;
    const int k1 = (t_begin + i + 1) * kBN;
    tile_mask(next_pad, k1, L, &valid, &padded);
    next_pad = tile_pad(pad, k1 + kBN, L, lane);
    mbar_wait(&sm.full_k[s1], ((i + 1) / kStages) & 1);
    mbar_wait(&sm.full_v[s], (i / kStages) & 1);
    turn_wait(wg);
    // every register the products touch is tied to a point before the
    // fence, so that the compiler moves no write of one past it (ptxas
    // would serialise the products)
    reg_fence(x);
    reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(p_cur[kk]);
    wgmma_fence();
    score_tile_wgmma(x, sm.q[wg], sm.k[s1]);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_64x128_rs<1>(o, p_cur[kk], mn_major_desc(sm.v[s], kk), 1);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();   // S done, P V may still run
    reg_fence(x);
    softmax_tile(x, valid, padded, t, scale, m, l, alpha, p_next);
    wgmma_wait<0>();
    reg_fence(o);
    if (lane == 0) mbar_arrive(&sm.empty[s]);   // this stage is refilled
    if (alpha[0] != 1.f || alpha[1] != 1.f) {   // x * 1 = x: skip
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        o[4 * c] *= alpha[0];
        o[4 * c + 1] *= alpha[0];
        o[4 * c + 2] *= alpha[1];
        o[4 * c + 3] *= alpha[1];
      }
    }
    // the stage tile i - 1 released (both warpgroups are past it by now)
    // takes tile i - 1 + kStages
    if (tid == 0 && i >= 1 && i - 1 + kStages < n)
      load_kv(sm, &tk, &tv, i - 1 + kStages, t_begin + i - 1 + kStages, bh);
    __syncwarp();
  };
  // the last tile's P V
  auto last = [&](uint32_t(&p_cur)[4][4], int i) {
    const int s = i % kStages;
    mbar_wait(&sm.full_v[s], (i / kStages) & 1);
    turn_wait(wg);
    reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) reg_fence(p_cur[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_64x128_rs<1>(o, p_cur[kk], mn_major_desc(sm.v[s], kk), 1);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    reg_fence(o);
  };
  int i = 0;
  for (; i + 2 < n; i += 2) {
    step(pa, pb, i);
    step(pb, pa, i + 1);
  }
  if (i + 1 < n) {
    step(pa, pb, i);
    last(pb, i + 1);
  } else {
    last(pa, i);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= L) continue;
    const size_t row = static_cast<size_t>(bh) * L + r;
    if (part_o == nullptr) {
      const float inv = 1.f / l[h];
      bf16* op = out + row * kDh + 2 * t;
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
// and writes the output rounded to bfloat16 and the row statistics
__global__ void __launch_bounds__(256)
mha_fwd_combine_bf16_kernel(const float* __restrict__ part_o,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l, int n_chunks,
                            long rows, bf16* __restrict__ out,
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
    const float w = exp_shifted(part_m[c * rows + row] - mx);
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

// The plan's cost model, in microseconds on an H100: a key tile of one
// block (128 query rows), the combining launch's fixed cost, and the device
// memory's rate for the partials (written once, read back once)
constexpr double kTileUs = 1.0;
constexpr double kCombineUs = 3.0;
constexpr double kBytesPerUs = 3.35e6;

// the launch: grid (query tiles, B*H, key chunks) and key tiles per chunk.
// Blocks run in waves of kBlocksPerSM per SM, and a block takes about one
// key tile's time for each tile of its chunk plus one for its Q load and
// epilogue; a split also writes chunks * B*H*L * 130 floats of partials
// and reads them back in a second launch.  The plan takes the chunk count
// whose modelled time is least, the smallest on a tie.
// FS2_MHA_FWD_CHUNKS, when defined at build time, fixes the count instead
// (tools/attention_bench.py --split-sweep builds such variants).
void plan(int B, int H, int L, int grid[3], int* tiles_per_chunk) {
  const int n_tiles = (L + kBN - 1) / kBN;
  const long blocks = static_cast<long>(B) * H * ((L + kBM - 1) / kBM);
  const long slots = static_cast<long>(kBlocksPerSM) * sm_count();
  const double rows = static_cast<double>(B) * H * L;
  int per = n_tiles;
#ifdef FS2_MHA_FWD_CHUNKS
  per = (n_tiles + FS2_MHA_FWD_CHUNKS - 1) / FS2_MHA_FWD_CHUNKS;
#else
  double best = -1.0;
  for (int c = 1; c <= n_tiles; ++c) {
    const int tiles = (n_tiles + c - 1) / c;
    const long used = (n_tiles + tiles - 1) / tiles;   // no empty chunk
    double us = static_cast<double>((blocks * used + slots - 1) / slots) *
                (tiles + 1) * kTileUs;
    if (used > 1)
      us += kCombineUs +
            2.0 * used * rows * (kDh + 2) * sizeof(float) / kBytesPerUs;
    if (best < 0.0 || us < best) {
      best = us;
      per = tiles;
    }
  }
#endif
  per = std::max(per, 1);
  *tiles_per_chunk = per;
  grid[0] = (L + kBM - 1) / kBM;
  grid[1] = B * H;
  grid[2] = (n_tiles + per - 1) / per;
}

}  // namespace

// The grid the bfloat16 K1 launches for [B, H, L, 128] (written to
// grid[3]: query tiles, B*H, key chunks) and the float32 scratch it needs:
// 0 without a split, else chunks * B*H*L * (128 + 2) floats.
// fs2_mha_fwd_plan(..., bf16 = 1, ...) answers with this.
extern "C" long long fs2_mha_fwd_bf16_plan(int B, int H, int L, int* grid) {
  if (B <= 0 || H <= 0 || L <= 0) return -1;
  int tiles_per_chunk;
  plan(B, H, L, grid, &tiles_per_chunk);
  if (grid[2] == 1) return 0;
  return static_cast<long long>(grid[2]) * B * H * L * (kDh + 2);
}

// q, k, v, out: [B, H, L, 128] bfloat16, contiguous, 16-byte aligned.
// key_pad: [B, L] bytes, nonzero = padded key.  row_max, row_sum:
// [B, H, L] float32, or both null.  scratch: fs2_mha_fwd_bf16_plan(B, H, L)
// floats (null when that is 0).  scale = 1/sqrt(D) as float.  Launches on
// `stream` (a second, combining launch when the keys are split); returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take (or a driver without tensor maps).
extern "C" int fs2_mha_fwd_bf16(const void* q, const void* k, const void* v,
                                const void* key_pad, void* out, void* row_max,
                                void* row_sum, void* scratch, int B, int H,
                                int L, int D, float scale, void* stream) {
  if (D != kDh || B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  if ((row_max == nullptr) != (row_sum == nullptr)) return cudaErrorInvalidValue;
  int grid[3], tiles_per_chunk;
  plan(B, H, L, grid, &tiles_per_chunk);
  const bool split = grid[2] > 1;
  if (split && scratch == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tensor_map_rows128(&tq, q, L, B * H) ||
      !tensor_map_rows128(&tk, k, L, B * H) ||
      !tensor_map_rows128(&tv, v, L, B * H))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = set_smem_once(
      reinterpret_cast<const void*>(mha_fwd_bf16_kernel), kSmemBytes, ready);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long rows = static_cast<long>(B) * H * L;
  float* part_o = split ? static_cast<float*>(scratch) : nullptr;
  float* part_m = split ? part_o + grid[2] * rows * kDh : nullptr;
  float* part_l = split ? part_m + grid[2] * rows : nullptr;
  mha_fwd_bf16_kernel<<<dim3(grid[0], grid[1], grid[2]), kThreads,
                        kSmemBytes, st>>>(
      tq, tk, tv, static_cast<const unsigned char*>(key_pad),
      static_cast<bf16*>(out), static_cast<float*>(row_max),
      static_cast<float*>(row_sum), part_o, part_m, part_l, H, L, scale,
      tiles_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const int warps_per_block = 256 / 32;
  mha_fwd_combine_bf16_kernel<<<(rows + warps_per_block - 1) /
                                    warps_per_block,
                                256, 0, st>>>(
      part_o, part_m, part_l, grid[2], rows, static_cast<bf16*>(out),
      static_cast<float*>(row_max), static_cast<float*>(row_sum));
  return cudaGetLastError();
}

// Resident blocks per SM of the bfloat16 K1's main kernel, for the build
// report; -1 on an error.
extern "C" int fs2_mha_fwd_bf16_blocks_per_sm() {
  const void* fn = reinterpret_cast<const void*>(mha_fwd_bf16_kernel);
  int n = 0;
  if (set_smem(fn, kSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}
