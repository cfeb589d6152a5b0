// K1: fused masked multi-head self-attention forward, float32, for sm_90a.
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
// (b, h), run on the tensor cores as 3xTF32 (attention_common.cuh), within
// ~1e-5 of float32 at three TF32 products each: 3 x 4 L^2 Dh at 495
// TFLOP/s, against 4 L Dh 4-byte tensors moved.  At L = 1000 that is ~750
// TF32 operations per byte (the card's ridge is ~150), so the tensor cores
// bound it.
//
// Design: one block of 4 warps owns (b, h, 64 query rows) and walks the
// keys in tiles of 32 with an online softmax; each warp owns 16 query rows,
// so its S tile (16 x 32) and output accumulator (16 x 128) sit in mma
// fragments in registers.  S = Q K^T comes from score_tile (Q as A and K as
// B, both by ldmatrix from shared memory); P stays in registers and feeds
// O += P V as the A operand directly, in the permuted key order
// (attention_common.cuh), eight independent output fragments per pass.  K
// and V tiles arrive by cp.async in a two-stage ring, so the next tile's
// copy overlaps this tile's products.  Shared memory: Q 64 x 132 floats
// plus two stages of K and V at 32 x 132: 101,376 bytes, so two blocks
// (8 warps) fit on one SM.  Every operand is split into its TF32 parts where
// it is loaded; splitting K and V once per tile instead needs their small
// parts in shared memory too, which leaves room for one block per SM, and
// keeping Q's fragments in registers spills: both were slower on the card.
//
// Filling the card: a grid of B*H*ceil(L/64) blocks is 32 at [1, 2, 1000,
// 128], a quarter of the 132 SMs, and 320 at [10, 2, 1000, 128], one full
// wave of two blocks per SM and a second that is a fifth full.  So the keys
// may be split into chunks (a flash-decoding split): each block of the
// (query tile, b*h, chunk) grid writes its unnormalised partial (row max
// m, row sum l, accumulator) to scratch, and a second, small launch
// combines the chunks in the fixed order 0, 1, ... and writes the output
// and the row statistics.  fs2_mha_fwd_plan counts the waves each chunk
// count takes (plan, below): 8 chunks (256 blocks) at [1, 2, 1000, 128], 4
// at [10, 2, 1000|128, 128], none at [10, 2, 768, 128] or [1, 2, 32,
// 128].  Nothing is summed by atomics, so every launch gives the same bits.
//
// The ragged edge (L not a multiple of the tiles) is masked: keys at or past
// L get probability exactly 0 and are loaded as zeros (cp.async zero fill).
//
// For training, the kernel also writes each query row's softmax statistics
// (the final row max m and row sum l, so that P = exp(s - m) / l) through
// two optional pointers; K3 (attention_bwd.cu) reads them and recomputes
// each score through the same score_tile and masked_score, so its P is
// this kernel's P.  They are kept apart, not folded into a log-sum-exp: for
// a fully padded row m = -1e9, and -1e9 + log(L) rounds back to -1e9 in
// float32.  Inference passes null.
//
// The bfloat16 instance is attention_bf16.cu (wgmma and TMA); this file's
// fs2_mha_fwd_plan answers for both.

#include <cuda_runtime.h>

#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace fs2_attn;

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 32;        // keys per tile
constexpr int kWarps = kBM / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 2;   // what the shared memory below allows

// Q, then two stages of (K, V)
constexpr size_t kSmemBytes = sizeof(float) * kStride * (kBM + 4 * kBN);

// O += P V for float32: P's C fragments as A (keys in the permuted order),
// V as B, 3xTF32, eight output column groups at a time
__device__ __forceinline__ void pv_product(const float* Vs,
                                           const float s[4][4], int lane,
                                           float o[16][4]) {
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t ab[4], as[4];
    c_as_a(s[j], ab, as);
#pragma unroll
    for (int n0 = 0; n0 < 16; n0 += 8) {
      uint32_t bb[8][2], bs[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        load_b_perm(Vs + 8 * j * kStride + 8 * (n0 + n), kStride, g, t,
                    bb[n], bs[n]);
      mma_3xtf32_n<8>(o + n0, ab, as, bb, bs);
    }
  }
}

// The block's work
__device__ __forceinline__ void mha_fwd_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ key_pad,
    float* __restrict__ out, float* __restrict__ row_max,
    float* __restrict__ row_sum, float* __restrict__ part_o,
    float* __restrict__ part_m, float* __restrict__ part_l, int H, int L,
    float scale, int tiles_per_chunk) {
  constexpr int kS = kStride;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBM][kS]
  float* stage_base = Qs + kBM * kS;             // per stage: K then V

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (L + kBN - 1) / kBN;
  const int t_begin = blockIdx.z * tiles_per_chunk;
  const int t_end = min(n_tiles, t_begin + tiles_per_chunk);
  const size_t base = static_cast<size_t>(bh) * L * kDh;
  const float* kp = k + base;
  const float* vp = v + base;
  const unsigned char* pad = key_pad + static_cast<size_t>(b) * L;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_tile_async<kBM, kThreads>(Qs, q + base, q0, L, tid);
  load_tile_async<kBN, kThreads>(stage_base, kp, t_begin * kBN, L, tid);
  load_tile_async<kBN, kThreads>(stage_base + kBN * kS, vp, t_begin * kBN,
                                 L, tid);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max, running sum, and the
  // output accumulator o[n] over columns 8n..8n+7 (C fragments)
  float m[2] = {kInitMax, kInitMax};
  float l[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  const float* Qw = Qs + warp * 16 * kS;
  for (int kt = t_begin; kt < t_end; ++kt) {
    const int stage = (kt - t_begin) & 1;
    if (kt + 1 < t_end) {
      float* next = stage_base + (stage ^ 1) * 2 * kBN * kS;
      load_tile_async<kBN, kThreads>(next, kp, (kt + 1) * kBN, L, tid);
      load_tile_async<kBN, kThreads>(next + kBN * kS, vp, (kt + 1) * kBN, L,
                                     tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ks = stage_base + stage * 2 * kBN * kS;
    const float* Vs = Ks + kBN * kS;

    float s[4][4];
    score_tile(Qw, Ks, lane, s);

    const int k0 = kt * kBN;
    bool valid[4][2];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        valid[j][e] = key < L;
        const bool padded = valid[j][e] && pad[key] != 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sc = masked_score(s[j][2 * h + e], padded, scale);
          s[j][2 * h + e] = sc;
          if (valid[j][e]) mx[h] = fmaxf(mx[h], sc);
        }
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = expf(m[h] - mx[h]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p = valid[j][e] ? expf(s[j][2 * h + e] - mx[h]) : 0.f;
          s[j][2 * h + e] = p;
          rs[h] += p;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * alpha[h] + quad_sum(rs[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    pv_product(Vs, s, lane, o);
    __syncthreads();   // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    if (r >= L) continue;
    const size_t row = static_cast<size_t>(bh) * L + r;
    if (part_o == nullptr) {
      const float inv = 1.f / l[h];
      float* op = out + row * kDh + 2 * t;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        store2(op + 8 * n, o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      if (row_max != nullptr && t == 0) {
        row_max[row] = m[h];
        row_sum[row] = l[h];
      }
    } else {
      const size_t rows = static_cast<size_t>(gridDim.y) * L;
      const size_t prow = blockIdx.z * rows + row;
      float* op = part_o + prow * kDh + 2 * t;
#pragma unroll
      for (int n = 0; n < 16; ++n)
        store2(op + 8 * n, o[n][2 * h], o[n][2 * h + 1]);
      if (t == 0) {
        part_m[prow] = m[h];
        part_l[prow] = l[h];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
mha_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const unsigned char* __restrict__ key_pad,
                   float* __restrict__ out, float* __restrict__ row_max,
                   float* __restrict__ row_sum, float* __restrict__ part_o,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   int H, int L, float scale, int tiles_per_chunk) {
  mha_fwd_block(q, k, v, key_pad, out, row_max, row_sum, part_o, part_m,
                part_l, H, L, scale, tiles_per_chunk);
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

// the launch: grid (query tiles, B*H, key chunks) and key tiles per chunk.
// Blocks run in waves of kBlocksPerSM per SM, and a block takes about one
// key tile's time for each tile of its chunk plus one for its Q load and
// epilogue.  The plan takes the chunk count c whose
// waves(c) * (tiles per chunk + 1) is least, the smallest c on a tie.  The
// combining launch is left out of the count: it reads c partials once,
// a few microseconds at the path's shapes (tools/attention_bench.py
// --split-sweep times every c there).  FS2_MHA_FWD_CHUNKS, when defined at
// build time, fixes c instead (the sweep builds such variants).
void plan(int B, int H, int L, int grid[3], int* tiles_per_chunk) {
  const int n_tiles = (L + kBN - 1) / kBN;
  const long blocks = static_cast<long>(B) * H * ((L + kBM - 1) / kBM);
  const long slots = static_cast<long>(kBlocksPerSM) * sm_count();
  int per = n_tiles;
#ifdef FS2_MHA_FWD_CHUNKS
  per = (n_tiles + FS2_MHA_FWD_CHUNKS - 1) / FS2_MHA_FWD_CHUNKS;
#else
  long best = -1;
  for (int c = 1; c <= n_tiles; ++c) {
    const int tiles = (n_tiles + c - 1) / c;
    const long used = (n_tiles + tiles - 1) / tiles;   // no empty chunk
    const long cost = (blocks * used + slots - 1) / slots * (tiles + 1L);
    if (best < 0 || cost < best) {
      best = cost;
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

// K1's launches (fs2_mha_fwd_f32's contract below)
int mha_fwd(const void* q, const void* k, const void* v, const void* key_pad,
            void* out, void* row_max, void* row_sum, void* scratch, int B,
            int H, int L, int D, float scale, void* stream) {
  if (D != kDh || B <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
  if ((row_max == nullptr) != (row_sum == nullptr)) return cudaErrorInvalidValue;
  int grid[3], tiles_per_chunk;
  plan(B, H, L, grid, &tiles_per_chunk);
  const bool split = grid[2] > 1;
  if (split && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err =
      set_smem(reinterpret_cast<const void*>(mha_fwd_f32_kernel), kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long rows = static_cast<long>(B) * H * L;
  float* part_o = split ? static_cast<float*>(scratch) : nullptr;
  float* part_m = split ? part_o + grid[2] * rows * kDh : nullptr;
  float* part_l = split ? part_m + grid[2] * rows : nullptr;
  mha_fwd_f32_kernel<<<dim3(grid[0], grid[1], grid[2]), kThreads,
                       kSmemBytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const unsigned char*>(key_pad),
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

}  // namespace

extern "C" long long fs2_mha_fwd_bf16_plan(int B, int H, int L, int* grid);

// The grid K1 launches for [B, H, L, 128] (written to grid[3]: query tiles,
// B*H, key chunks) and the float32 scratch it needs: 0 without a split,
// else chunks * B*H*L * (128 + 2) floats; of the float32 instance, or with
// bf16 != 0 of the bfloat16 one (attention_bf16.cu, its own tiles and
// plan).
extern "C" long long fs2_mha_fwd_plan(int B, int H, int L, int bf16,
                                      int* grid) {
  if (bf16) return fs2_mha_fwd_bf16_plan(B, H, L, grid);
  if (B <= 0 || H <= 0 || L <= 0) return -1;
  int tiles_per_chunk;
  plan(B, H, L, grid, &tiles_per_chunk);
  if (grid[2] == 1) return 0;
  return static_cast<long long>(grid[2]) * B * H * L * (kDh + 2);
}

// q, k, v, out: [B, H, L, 128] float32, contiguous.  key_pad: [B, L] bytes,
// nonzero = padded key.  row_max, row_sum: [B, H, L] float32, or both null.
// scratch: fs2_mha_fwd_plan(B, H, L) floats (null when that is 0).
// scale = 1/sqrt(D), rounded to float by the caller as the reference rounds
// it.  Launches on `stream` (a second, combining launch when the keys are
// split); returns cudaGetLastError() (or cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int fs2_mha_fwd_f32(const void* q, const void* k, const void* v,
                               const void* key_pad, void* out, void* row_max,
                               void* row_sum, void* scratch, int B, int H,
                               int L, int D, float scale, void* stream) {
  return mha_fwd(q, k, v, key_pad, out, row_max, row_sum, scratch, B, H, L,
                 D, scale, stream);
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
