// Shared by the bfloat16 K1 (attention_bf16.cu) and K3
// (attention_bwd_bf16.cu): the score contract on wgmma, the tile layout,
// the key masks and scaled scores, the exponential both take, the split of
// a float32 operand into three exact bfloat16 parts, and the two
// warpgroups' turns at the tensor cores.  The float32 instances'
// counterparts are in attention_common.cuh, whose constants, masked score,
// quad reductions and stores these kernels share.
//
// A [64][128] bfloat16 tile of Q, K, V or G sits in shared memory as two
// 64 x 64 boxes in the 128-byte swizzle (hopper.cuh), d 0-63 then d 64-127,
// as one TMA load per box writes it from a tensor map over [B*H, L, 128]
// (hopper.cuh: tensor_map_rows128).  Rows at or past L arrive as zeros.

#pragma once

#include <atomic>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace fs2_attn {

using namespace fs2_hopper;

constexpr int kBox = 64;                                 // rows and columns
constexpr int kBoxElems = kBox * kBox;                   // 4096
constexpr uint32_t kBoxBytes = kBoxElems * sizeof(bf16);   // 8192
constexpr uint32_t kTileBytes = 2 * kBoxBytes;   // a [64][128] tile: 16384
constexpr uint32_t kAtomBytes = 1024;            // 8 rows of 128 bytes
constexpr uint32_t kKStepRows = 16;              // rows per MN-major k-step

// THE SCORE CONTRACT of the bfloat16 instances.  The 64 x 64 tile of raw
// scores s = A B^T of a [64][128] tile A (query rows, or G's rows for dP)
// against a [64][128] tile B (keys, or V's rows), both K-major: eight
// wgmma.m64n64k16 bfloat16 products with float32 accumulation (a product
// of two bfloat16 values is exact in float32), in the order d = 0, 16, ...,
// 112, the first into a zero accumulator.  s[4j + 2h + e] is row
// 16 w + g + 8 h (w the warp of the warpgroup), key 8 j + 2 t + e.  K1
// forms every score through this function with Q as A and K as B, and K3
// recomputes every score through it with the same roles (and dP = G V^T),
// so K3's scores, and through K1's row max and row sum its probabilities,
// are K1's bit for bit.  The caller fences before, commits and waits after.
__device__ __forceinline__ void score_tile_wgmma(float (&s)[32],
                                                 const bf16* a,
                                                 const bf16* b) {
  wgmma_64x64_ss_first<0, 0>(s, make_desc(a, 16, kAtomBytes),
                             make_desc(b, 16, kAtomBytes));
#pragma unroll
  for (int step = 1; step < kDh / 16; ++step) {
    const int off = (step / 4) * kBoxElems + (step % 4) * 16;
    wgmma_64x64_ss<0, 0>(s, make_desc(a + off, 16, kAtomBytes),
                         make_desc(b + off, 16, kAtomBytes), 1);
  }
}

// The pad bytes lane `lane` reads for the 64-key tile at k0 (keys k0 +
// lane and k0 + 32 + lane; 0 at or past L), fetched a tile ahead of their
// use: a load's latency on the way to tile_mask's ballots stalled the warp
// every tile
struct TilePad {
  uint32_t a, c;
};

__device__ __forceinline__ TilePad tile_pad(const unsigned char* pad, int k0,
                                            int L, int lane) {
  const int a = k0 + lane, c = k0 + 32 + lane;
  return {a < L ? pad[a] : 0u, c < L ? pad[c] : 0u};
}

// The key mask of the 64-key tile at k0, the same in every lane of the
// warp (two ballots over the tile's pad bytes f): bit k of *valid says that
// key k0 + k lies below L, of *padded that it is a padded key below L.  A
// thread of quad lane t reads its keys 8j + 2t + e at bit 8j + e of the
// masks shifted right by 2t.
__device__ __forceinline__ void tile_mask(TilePad f, int k0, int L,
                                          uint64_t* valid, uint64_t* padded) {
  const uint32_t lo = __ballot_sync(0xffffffffu, f.a != 0);
  const uint32_t hi = __ballot_sync(0xffffffffu, f.c != 0);
  *padded = static_cast<uint64_t>(hi) << 32 | lo;
  const int below = L - k0;
  *valid = below >= 64 ? ~0ull : below <= 0 ? 0ull : (1ull << below) - 1;
}

// The scaled, masked scores of one 64-key tile (x[4j + 2h + e]: key
// 8j + 2t + e) in place, and kInitMax for a key at or past L: below every
// score a row has (-1e9 at the lowest), so it raises no row max, and its
// exponential is exactly 0, the probability such a key has.  A tile whose
// keys are all below L and unpadded (the warp agrees: the masks are
// ballots) takes the scale alone.
__device__ __forceinline__ void tile_scores(float (&x)[32], uint64_t valid,
                                            uint64_t padded, int t,
                                            float scale) {
  if (padded == 0 && valid == ~0ull) {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = __fmul_rn(x[i], scale);
    return;
  }
  const uint64_t v = valid >> (2 * t), p = padded >> (2 * t);
#pragma unroll
  for (int j = 0; j < 8; ++j)
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

// exp(y) for y = s - m <= 0 as the bfloat16 kernels take it, K1 for P and
// its row sums and K3 for P again: 2^(y log2 e) on the special function
// unit (ex2.approx, ~2 ulp; one multiply and one MUFU where expf spends
// about eight instructions).  Both kernels use it, so K3's P = exp(s - m)
// / l sums to 1 over a row as K1's sums do; y is formed exactly first, as
// a fully padded row's y = -1e9 - (-1e9) = 0 needs
__device__ __forceinline__ float exp_shifted(float y) { return __expf(y); }

// descriptor of k-step s (16 rows) of an MN-major [rows][128] tile (two
// boxes: the second 64 columns at LBO) or of one 64-column box
__device__ __forceinline__ uint64_t mn_major_desc(const bf16* tile, int s) {
  return make_desc(tile + s * kKStepRows * kBox, kBoxBytes, kAtomBytes);
}

// (x0, x1) = hi + mid + lo exactly, each part a bfloat16 value, packed as
// bfloat16 pairs with x0 in the low half.  Each part is the leading 8 bits
// of what the parts before it leave (the float32 bit pattern's upper half:
// truncation, in integer and float adds alone): a float32 has 24
// significant bits, so the two remainders are exact in float32 and the
// last is exact in bfloat16 (values below float32's normal range aside).  A
// product of a part with a bfloat16 value is exact in float32, so the sum
// of the three products is a float32-accurate product of the float32
// operand: 3xBF16, the bfloat16 instances' counterpart of 3xTF32.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  constexpr uint32_t kUpper = 0xffff0000u;
  const uint32_t b0 = __float_as_uint(x0), b1 = __float_as_uint(x1);
  const float r0 = x0 - __uint_as_float(b0 & kUpper);
  const float r1 = x1 - __uint_as_float(b1 & kUpper);
  const uint32_t c0 = __float_as_uint(r0), c1 = __float_as_uint(r1);
  const float l0 = r0 - __uint_as_float(c0 & kUpper);
  const float l1 = r1 - __uint_as_float(c1 & kUpper);
  hi = __byte_perm(b0, b1, 0x7632);   // the upper halves, x0's low
  mid = __byte_perm(c0, c1, 0x7632);
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// set_smem for a kernel once per device (the attribute is the device's;
// the call costs host time on every launch of a small shape): `ready` holds
// one bit per device that has it
inline cudaError_t set_smem_once(const void* fn, size_t bytes,
                                 std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = set_smem(fn, bytes);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// Two warpgroups take turns to issue their products (FlashAttention-3's
// ping-pong): warpgroup w waits for its turn (barrier kTurnBarrier + w),
// issues, and hands the turn over (barrier kTurnBarrier + 1 - w); warpgroup
// 1 hands warpgroup 0 the first turn.  So the two run out of phase, one's
// products on the tensor cores while the other computes on the CUDA cores,
// where a copy both wait for would otherwise keep them in step.
constexpr int kTurnBarrier = 3;   // and 4; ids 1 and 2 stay free

__device__ __forceinline__ void turn_first(int wg) {
  if (wg == 1) named_barrier_arrive(kTurnBarrier, 256);
}

__device__ __forceinline__ void turn_wait(int wg) {
  named_barrier(kTurnBarrier + wg, 256);
}

__device__ __forceinline__ void turn_pass(int wg) {
  named_barrier_arrive(kTurnBarrier + 1 - wg, 256);
}

// the 1,024-byte aligned start of dynamic shared memory (the allocation
// carries 1,024 bytes of slack for it)
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

}  // namespace fs2_attn
