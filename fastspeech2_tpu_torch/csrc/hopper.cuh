// Hopper's asynchronous machinery as inline PTX, for the kernels on wgmma:
// the attention forward and backward (attention.cu, attention_bwd.cu,
// float32; attention_bf16.cu, attention_bwd_bf16.cu), the conv FFN
// (conv_ffn_f32.cu, conv_ffn.cu) and K4 (resblock.cu): mbarriers (whose waits trap after
// 2 s), TMA tile loads and bulk copies, warpgroup matrix products (wgmma,
// bfloat16 and tf32) and their shared-memory descriptors, and the
// host-side tensor maps.  sm_90a only (wgmma).
//
// Tiles.  Every operand tile in shared memory is one or more 64 x 64
// bfloat16 boxes in the 128-byte swizzle: 64 rows of 128 bytes, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), each box 8,192 bytes and
// 1,024-byte aligned.  A TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes a
// box in that layout, and a wgmma descriptor with layout type 1 reads it:
//   K-major (the contraction index runs along the 128-byte rows, as d does
//     in a [rows][128] tile of Q, K or G): rows in groups of 8 at a stride
//     (SBO) of 1,024 bytes; the 16-wide k-step s of a box starts 32 s bytes
//     into it (the swizzle acts on the address bits, so the start moves
//     within the atom).
//   MN-major (the contraction index runs across rows, as the keys do in V
//     for P V): 8 rows of k at a stride (SBO) of 1,024 bytes, the next 64
//     columns of M or N (the next box) at LBO; the k-step of 16 rows starts
//     2,048 bytes further.
//
// Fragments (per warp w of the warpgroup, lane (g, t) = (lane / 4,
// lane % 4)):
//   accumulator of m64nNk16, float32: d[4j + 2h + e] at row 16 w + g + 8 h,
//     column 8 j + 2 t + e;
//   A from registers, m64nNk16 bfloat16: a0 (row g, k 2t..2t+1), a1 (row
//     g + 8, the same k), a2 (row g, k 2t+8..2t+9), a3 (row g + 8, k
//     2t+8..2t+9), rows offset by 16 w, the lower k in the low half.
// So the accumulator of keys 16 s..16 s + 15 (n-tiles 2 s and 2 s + 1) is,
// rounded pairwise to bfloat16, the A fragment of k-step s as it stands.
//   A from registers, m64nNk8 tf32: a0 (row g, k t), a1 (row g + 8, k t),
//     a2 (row g, k t + 4), a3 (row g + 8, k t + 4), rows offset by 16 w.
// A tf32 operand in shared memory is K-major only (no transpose for 32-bit
// types): 8 tf32 values are the 32 bytes of 16 bfloat16 ones, so a
// [rows][32] tf32 tile in the 128-byte swizzle is read by the same K-major
// descriptor, the k-step s of 8 starting 32 s bytes into each row.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (no driver call is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fs2_hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one try_wait on the phase of parity `parity`: true once it has completed.
// The thread sleeps in it until the phase completes or about a millisecond
// passes (the suspend hint), so that a waiting warp leaves the issue slots
// to the warps it shares its scheduler with
__device__ __forceinline__ bool mbar_try_wait(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(a), "r"(parity), "r"(1000000)
      : "memory");
  return done != 0;
}

// the low 32 bits of the card's nanosecond clock
__device__ __forceinline__ uint32_t global_ns() {
  uint32_t t;
  asm volatile("mov.u32 %0, %%globaltimer_lo;\n" : "=r"(t));
  return t;
}

// a barrier wait longer than this is a fault (2 s; below 2^32 ns, so that
// the difference of two readings of the low word stays exact)
constexpr uint32_t kMbarStallNs = 2000000000u;

// waits until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed).  Every wait here is on a copy
// or on a warp of the same block, so it ends within microseconds; one that
// lasts kMbarStallNs by the card's clock is a fault, and traps (the launch
// fails with an error within seconds) rather than hanging the card.  The
// clock is read only once the first try has failed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint32_t start = global_ns();
  while (!mbar_try_wait(a, parity))
    if (global_ns() - start > kMbarStallNs) __trap();
}

// ---- TMA ---------------------------------------------------------------------

// one box of the 3-D tensor map `map` at (c0, c1, c2), innermost first,
// into shared memory at dst; completes `bytes` transactions on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the bulk-copy engine (TMA without a tensor map); completes
// `bytes` transactions on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// orders this thread's shared-memory stores before later reads by the
// async proxy (wgmma operands written by threads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `threads` threads (a multiple of 32) under id `id` > 0
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// this thread's arrival at that barrier, without waiting for it
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// a shared-memory matrix descriptor in the 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_addr(p) & 0x3ffffu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties the registers of an accumulator (or an A fragment) to this point,
// so that the compiler neither reads them before a wgmma_wait nor writes
// them after a wgmma_fence out of order
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// the accumulator operands d[0 .. n - 1] of a wgmma, with constraint m:
// "+f" to accumulate onto d, "=f" for a fresh accumulator
#define FS2_D8(m, i)                                                       \
  m(d[i]), m(d[i + 1]), m(d[i + 2]), m(d[i + 3]), m(d[i + 4]), m(d[i + 5]),   \
      m(d[i + 6]), m(d[i + 7])
#define FS2_D16(m) FS2_D8(m, 0), FS2_D8(m, 8)
#define FS2_D32(m) FS2_D16(m), FS2_D8(m, 16), FS2_D8(m, 24)
#define FS2_D64(m) \
  FS2_D32(m), FS2_D8(m, 32), FS2_D8(m, 40), FS2_D8(m, 48), FS2_D8(m, 56)
#define FS2_D128(m)                                                       \
  FS2_D64(m), FS2_D8(m, 64), FS2_D8(m, 72), FS2_D8(m, 80), FS2_D8(m, 88),  \
      FS2_D8(m, 96), FS2_D8(m, 104), FS2_D8(m, 112), FS2_D8(m, 120)

// d (64 x 64, float32) = A B + (accumulate ? d : 0), A (64 x 16) and B
// (16 x 64) bfloat16 from shared memory; TA / TB = 1 for an MN-major A / B
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : FS2_D32("+f")
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 64, float32) = A B, a fresh accumulator: d's earlier values are
// no input, so a product never waits on (or orders itself after) whatever
// last wrote those registers, a write under a branch included (ptxas
// serialises every product of a kernel for such a dependence, C7520)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64x64_ss_first(float (&d)[32],
                                                     uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : FS2_D32("=f")
      : "l"(a), "l"(b), "r"(0), "n"(TA), "n"(TB));
}

// d (64 x 128, float32) = A B + (accumulate ? d : 0), A (64 x 16) and B
// (16 x 128) bfloat16 from shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64x128_ss(float (&d)[64], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : FS2_D64("+f")
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 128, float32) = A B + (accumulate ? d : 0), A (64 x 16) bfloat16
// from registers (the fragment above), B (16 x 128) bfloat16 from shared
// memory
template <int TB>
__device__ __forceinline__ void wgmma_64x128_rs(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : FS2_D64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TB));
}

// d (64 x 256, float32) += A B, A (64 x 16) and B (16 x 256) bfloat16, both
// K-major from shared memory (descriptors a and b); the _first form starts
// from a fresh accumulator (scale-d 0; see wgmma_64x64_ss_first)
__device__ __forceinline__ void wgmma_bf16_ss256(float (&d)[128], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : FS2_D128("+f")
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_ss256_first(float (&d)[128],
                                                       uint64_t a,
                                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : FS2_D128("=f")
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x N, float32) += A B: A (64 x 8) tf32 from registers (the fragment
// above, as tf32 bit patterns), B (8 x N) tf32 K-major from shared memory
// (descriptor b).  N = 32, 64, 128 or 256: N / 2 accumulators a thread.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : FS2_D16("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : FS2_D32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : FS2_D64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<256>(
    float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : FS2_D128("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N, float32) = A B, a fresh accumulator (scale-d 0): d's earlier
// values are no input, so the product never waits on whatever last wrote
// those registers (ptxas would serialise every product of a kernel for a
// write under a branch, C7520)
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs_first(float (&d)[N / 2],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32_rs_first<32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : FS2_D16("=f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs_first<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : FS2_D32("=f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs_first<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : FS2_D64("=f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs_first<256>(
    float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n"
      "}\n"
      : FS2_D128("=f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// d (64 x 32, float32) += A B: A (64 x 8) and B (8 x 32) tf32, both
// K-major from shared memory (descriptors a and b)
__device__ __forceinline__ void wgmma_tf32_ss32(float (&d)[16], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n"
      "}\n"
      : FS2_D16("+f")
      : "l"(a), "l"(b), "r"(1));
}

// the same from a fresh accumulator (scale-d 0; see wgmma_tf32_rs_first)
__device__ __forceinline__ void wgmma_tf32_ss32_first(float (&d)[16],
                                                      uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n"
      "}\n"
      : FS2_D16("=f")
      : "l"(a), "l"(b), "r"(0));
}

#undef FS2_D128
#undef FS2_D64
#undef FS2_D32
#undef FS2_D16
#undef FS2_D8

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (the
// library does not link libcuda); null if the driver lacks it
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// the tensor map of a row-major bfloat16 [heads, rows, 128] tensor in
// 64 x 64 boxes (64 rows, 64 columns) in the 128-byte swizzle: rows at or
// past `rows` read as zeros, so a box never reaches into the next head
inline bool tensor_map_rows128(CUtensorMap* map, const void* base, int rows,
                               int heads) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {128, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {128 * sizeof(__nv_bfloat16),
                                 static_cast<cuuint64_t>(rows) * 128 *
                                     sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor map of a row-major bfloat16 [batch, rows, C] tensor (C a
// multiple of 64) in boxes of `box_rows` rows by 64 values (128 bytes) in
// the 128-byte swizzle: rows outside [0, rows) read as zeros, so a box
// never reaches into the next batch row
inline bool tensor_map_rows_bf16(CUtensorMap* map, const void* base, int C,
                                 int rows, int batch, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(C) * sizeof(__nv_bfloat16),
      static_cast<cuuint64_t>(rows) * C * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor map of a row-major float32 [heads, rows, 128] tensor in
// boxes of `box_rows` rows by 32 columns (128 bytes) in the 128-byte
// swizzle: a [box_rows][128] tile is four such boxes, d 0-31 first.  Rows
// at or past `rows` read as zeros, so a box never reaches into the next
// head
inline bool tensor_map_rows128_f32(CUtensorMap* map, const void* base,
                                   int rows, int heads, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {128, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {
      128 * sizeof(float), static_cast<cuuint64_t>(rows) * 128 * sizeof(float)};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the offset, in floats, of element (r, c) of a [rows][32] float32 (tf32)
// box in the 128-byte swizzle: the 16-byte chunk c / 4 of row r stored at
// chunk (c / 4) ^ (r % 8)
__device__ __forceinline__ int swz32(int r, int c) {
  return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

}  // namespace fs2_hopper
