// K2, bfloat16: fused position-wise conv FFN forward for sm_90a, on the
// bfloat16 tensor cores (mma.sync).
//
// Replaces the TPU kernel fastspeech2_tpu/ops/pallas_ffn.py (_ffn_kernel via
// _pallas_forward) at --dtype bfloat16, which keeps one batch row's [L, H]
// hidden activation in VMEM.  Computes, on [B, L, D] row-major activations,
//
//   h   = ReLU(conv1d_k1(x; w1 [k1, D, H]) + b1)          (SAME zero padding)
//   y   = conv1d_k2(h; w2 [k2, H, D]) + b2 + x
//   out = (y - mean) / sqrt(E[y^2] - mean^2 + 1e-5) * gamma + beta   (over D)
//
// Each k-tap conv is k shifted products (tap j reads row t + j - (k-1)/2);
// taps that fall outside [0, L) read zero.  It computes what the TPU kernel
// computes on a bfloat16 x: both convs on the bfloat16 tensor cores
// (m16n8k16, exact products, float32 accumulation) with the weights
// rounded to bfloat16 (the TPU kernel's w.astype(x.dtype)) and packed in
// the A fragments' order ([M/16][T][K/16][32 lanes][8 values],
// ops/tf32_pack.py::pack_fragments_bf16); h = ReLU(sum + b1) with float32
// b1, rounded to bfloat16; b2 and x added in float32; the LayerNorm in
// float32; the output rounded to bfloat16.  One level of sums: a bfloat16
// h and output carry 2^-9 of rounding, far above the tensor cores'
// accumulation error.  Its bound on an H100 is the bfloat16 tensor cores'
// 989 TFLOP/s against the 2-byte x, output and weights.
//
// Design: three launches, h and the second conv's partial sums through
// device memory (in L2 at the path's shapes):
//   (a) conv1: M = H (64 per block, 4 warps) by N = positions (BN = 64 or
//       128 per block) by K = D x the block's taps.  The k1 taps are split
//       over S blocks (S chosen so that the grid fills every SM: 9 at
//       L = 32, 2 at L = 1000), each writing its partial sum of the
//       pre-activation to part[S][B][L][H].  The block stages the whole
//       window of x (BN + taps - 1 rows of 256 channels) in shared memory
//       at once by cp.async.
//   (b) conv2: 16 rows x all D = 256 columns per block (8 warps of 32) x
//       one of G groups of the hidden channels (G chosen so that the grid
//       fills every SM: 16 at L = 32, 4 at L = 1000), so that many SMs pull
//       w2 at once.  The block stages the S partials of its rows' h (with
//       the (k2-1)/2 halo) 64 hidden channels at a time by cp.async, and
//       forms h = ReLU(sum over s in order + b1), 0 outside [0, L), rounded
//       to bfloat16; it writes its group's share of the product to
//       ypart[G][B][L][256].
//   (c) LayerNorm: one warp per row sums the G shares in order, adds b2
//       and the residual, reduces the sum and the sum of squares with
//       shuffles and writes the normalised row.
// No atomics: the partials are summed in a fixed order, and two launches
// on the same inputs agree bit for bit.
//
// The float32 instance is conv_ffn_f32.cu (3xTF32 on wgmma, TMA).

#include <cuda_runtime.h>

#include "conv_tiles.cuh"

namespace {

using namespace fs2_conv;

using bf16 = __nv_bfloat16;

constexpr int kD = 256;
constexpr int kMaxSmem = 227 * 1024;   // a block's dynamic shared memory

// ---- (a) part[s] = the taps of split s of conv_k1(x) -----------------------
constexpr int kThreadsA = 128;
constexpr int kBM_A = 64;       // hidden channels per block

// ---- bfloat16 fragments ---------------------------------------------------

// A fragment of one 16 x 16 block of bfloat16 packed weights: 8 values per
// lane, one 16-byte load
__device__ __forceinline__ void load_a_bf16(const uint4* p, int lane,
                                            uint32_t a[4]) {
  const uint4 w = __ldg(p + lane);
  a[0] = w.x;
  a[1] = w.y;
  a[2] = w.z;
  a[3] = w.w;
}

// the B fragment of positions (rows) col.. at channels c0.. of a
// channels-last bfloat16 plane: b0 = channels c0 + 2t, +1 of row col + g,
// b1 = channels c0 + 8 + 2t, +1
__device__ __forceinline__ void load_b_bf16(const bf16* plane, int stride,
                                            int row, int c0, int t,
                                            uint32_t b[2]) {
  const bf16* p = plane + row * stride + c0 + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

constexpr int kStrideXH = kD + 8;   // bf16 row stride of x's window

// (a) for bfloat16 x: as ffn_conv1_kernel, with the window of x staged at
// once and the bfloat16 weights [H/16][k1][D/16][32][8]
template <int MT, int WN>
__global__ void __launch_bounds__(kThreadsA)
ffn_conv1_bf16_kernel(const bf16* __restrict__ x,
                      const uint4* __restrict__ w1, float* __restrict__ part,
                      int B, int L, int H, int k1, int splits) {
  constexpr int WM = kBM_A / (16 * MT);
  constexpr int BN = 32 * WN;
  static_assert(WM * WN * 32 == kThreadsA, "4 warps");
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);   // [span][kStrideXH]

  const int l0 = blockIdx.x * BN;
  const int n0 = blockIdx.y * kBM_A;
  const int b = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int per = (k1 + splits - 1) / splits;
  const int j0 = min(sp * per, k1);
  const int j1 = min(j0 + per, k1);
  const int win0 = l0 + j0 - (k1 - 1) / 2;
  const int span = BN + (j1 > j0 ? j1 - j0 - 1 : 0);
  const bf16* xb = x + static_cast<size_t>(b) * L * kD;
  // 16 x 16 blocks of the packed weights: per tap D/16, per m-tile k1 D/16
  const int wf_mt = k1 * (kD / 16) * 32;
  const uint4* wf = w1 + (n0 / 16 + wm * MT) * wf_mt;

  float acc[MT][4][4];
  zero(acc);
  if (j1 > j0) {
    for (int i = tid; i < span * (kD / 8); i += kThreadsA) {
      const int row = i / (kD / 8);
      const int c = (i % (kD / 8)) * 8;
      const int pos = win0 + row;
      const bool ok = pos >= 0 && pos < L;
      cp_async16(reinterpret_cast<float*>(xs + row * kStrideXH + c),
                 reinterpret_cast<const float*>(
                     ok ? xb + static_cast<size_t>(pos) * kD + c : xb),
                 ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int j = j0; j < j1; ++j) {
#pragma unroll 4
      for (int ks = 0; ks < kD / 16; ++ks) {
        uint32_t a[MT][4], bfr[4][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a_bf16(wf + mt * wf_mt + (j * (kD / 16) + ks) * 32, lane,
                      a[mt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          load_b_bf16(xs, kStrideXH, wn * 32 + 8 * nt + g + (j - j0),
                      16 * ks, t, bfr[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], bfr[nt]);
      }
    }
  }

  float* pout = part + static_cast<size_t>(sp * B + b) * L * H;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + 16 * (wm * MT + mt) + g + (i >= 2 ? 8 : 0);
        const int l = l0 + wn * 32 + 8 * nt + 2 * t + (i & 1);
        if (l < L) pout[static_cast<size_t>(l) * H + n] = acc[mt][nt][i];
      }
}

// ---- (b) ypart[g] = hidden group g's share of conv_k2(ReLU(sum part + b1))
constexpr int kThreadsB = 256;
constexpr int kBN_B = 16;       // rows per block
constexpr int kSliceB = 64;     // hidden channels per staged slice
constexpr int kStrideB = 68;    // 4 mod 32, 16-byte rows

// rows [win0, win0 + span) of the hidden channels [c0, c0 + 64) of each of
// the splits partial planes (plane floats apart, rows H apart) into dst
// [splits][span][68], zero outside [0, L)
__device__ __forceinline__ void stage_rows_b(float* dst, const float* part,
                                             size_t plane, int splits, int c0,
                                             int L, int H, int win0, int span,
                                             int tid) {
  for (int s = 0; s < splits; ++s)
    for (int i = tid; i < span * (kSliceB / 4); i += kThreadsB) {
      const int row = i >> 4;
      const int q = (i & 15) * 4;
      const int pos = win0 + row;
      const bool ok = pos >= 0 && pos < L;
      cp_async16(dst + (s * span + row) * kStrideB + q,
                 ok ? part + s * plane + static_cast<size_t>(pos) * H + c0 + q
                    : part,
                 ok);
    }
}

// the bfloat16 row stride of h's staged slice
constexpr int kStrideHH = kSliceB + 8;

int smem_b(int splits, int k2) {
  const int span = kBN_B + k2 - 1;
  return 4 * 2 * splits * span * kStrideB + 2 * span * kStrideHH;
}

// grid (row tiles, groups, B): 16 rows x all 256 columns (8 warps of 32) x
// the hidden channels [g H / groups, (g + 1) H / groups); w2: the packed
// weights, [D/16][k2][H/16][32][8] bfloat16 values (h rounded to bfloat16,
// the bfloat16 tensor cores accumulating into the running sum)
__global__ void __launch_bounds__(kThreadsB)
ffn_conv2_bf16_kernel(const float* __restrict__ part,
                      const float* __restrict__ b1,
                      const uint4* __restrict__ w2, float* __restrict__ ypart,
                      int B, int L, int H, int k2, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int grp = blockIdx.y;
  const int l0 = blockIdx.x * kBN_B;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;    // columns [32 warp, 32 warp + 32)
  const int g = lane >> 2;
  const int t = lane & 3;
  const int span = kBN_B + k2 - 1;
  const int win0 = l0 - (k2 - 1) / 2;
  const int wf_mt = k2 * (H / 16) * 32;
  const uint4* wf = w2 + 2 * warp * wf_mt;
  const size_t plane = static_cast<size_t>(B) * L * H;   // floats per split
  const float* pb0 = part + static_cast<size_t>(b) * L * H;
  const int slices = H / kSliceB / gridDim.y;
  const int sl0 = grp * slices;

  float* raw = smem;        // [2][splits][span][68]
  const int buf = splits * span * kStrideB;
  bf16* hs = reinterpret_cast<bf16*>(smem + 2 * buf);   // h [span][72]

  float acc[2][2][4];
  zero(acc);
  stage_rows_b(raw, pb0, plane, splits, sl0 * kSliceB, L, H, win0, span,
               tid);
  cp_async_commit();
#pragma unroll 1
  for (int i_sl = 0; i_sl < slices; ++i_sl) {
    const int sl = sl0 + i_sl;
    cp_async_wait<0>();
    __syncthreads();
    if (i_sl + 1 < slices)
      stage_rows_b(raw + ((i_sl + 1) & 1) * buf, pb0, plane, splits,
                   (sl + 1) * kSliceB, L, H, win0, span, tid);
    cp_async_commit();
    const float* src = raw + (i_sl & 1) * buf;
    for (int i = tid; i < span * kSliceB; i += kThreadsB) {
      const int row = i >> 6;
      const int c = i & 63;
      const int pos = win0 + row;
      float v = 0.f;
      if (pos >= 0 && pos < L) {
        float sum = src[row * kStrideB + c];
        for (int s = 1; s < splits; ++s)
          sum += src[(s * span + row) * kStrideB + c];
        v = fmaxf(sum + __ldg(b1 + sl * kSliceB + c), 0.f);
      }
      hs[row * kStrideHH + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < k2; ++j)
#pragma unroll
      for (int ks = 0; ks < kSliceB / 16; ++ks) {
        uint32_t a[2][4], bfr[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          load_a_bf16(wf + mt * wf_mt +
                          (j * (H / 16) + sl * (kSliceB / 16) + ks) * 32,
                      lane, a[mt]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          load_b_bf16(hs, kStrideHH, 8 * nt + g + j, 16 * ks, t, bfr[nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_bf16(acc[mt][nt], a[mt], bfr[nt]);
      }
  }

  float* yb = ypart + (static_cast<size_t>(grp) * B + b) * L * kD;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 32 * warp + 16 * mt + g + (i >= 2 ? 8 : 0);
        const int l = l0 + 8 * nt + 2 * t + (i & 1);
        if (l < L) yb[static_cast<size_t>(l) * kD + n] = acc[mt][nt][i];
      }
}

// ---- (c) out = LN(sum of the groups' ypart + b2 + x) over D = 256 ---------
constexpr int kThreadsC = 256;   // one warp per row

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// T: the type of x and the output (float, or bf16 rounded to nearest even)
template <typename T>
__global__ void __launch_bounds__(kThreadsC)
ffn_ln_kernel(const float* __restrict__ ypart, const float* __restrict__ b2,
              const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ out,
              int rows, int groups) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreadsC / 32) + (threadIdx.x >> 5);
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
    y[u] = y[u] + __ldg(b2 + lane + 32 * u) + to_f32(x[at + 32 * u]);
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
    const int n = lane + 32 * u;
    store(out + at + 32 * u, (y[u] - mean) * inv * gamma[n] + beta[n]);
  }
}

template <int MT, int WN>
cudaError_t launch_a(const bf16* x, const uint4* w1, float* part, int B,
                     int L, int H, int k1, int splits, cudaStream_t s) {
  constexpr int BN = 32 * WN;
  const int per = (k1 + splits - 1) / splits;
  const int smem = 2 * (BN + per - 1) * kStrideXH;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        ffn_conv1_bf16_kernel<MT, WN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((L + BN - 1) / BN, H / kBM_A, B * splits);
  ffn_conv1_bf16_kernel<MT, WN><<<grid, kThreadsA, smem, s>>>(
      x, w1, part, B, L, H, k1, splits);
  return cudaGetLastError();
}

// K2's three launches (fs2_conv_ffn_fwd_bf16's contract below)
int conv_ffn_fwd(const void* x, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* gamma,
                 const void* beta, void* scratch, void* out, int B, int L,
                 int D, int H, int k1, int k2, int bn, int splits,
                 int groups, void* stream) {
  if (D != kD || H <= 0 || H % kBM_A != 0 || B <= 0 || L <= 0 || k1 <= 0 ||
      k2 <= 0 || splits <= 0 || splits > k1 || groups <= 0 ||
      (H / kSliceB) % groups != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xs = static_cast<const bf16*>(x);
  const uint4* w1s = static_cast<const uint4*>(w1);
  float* part = static_cast<float*>(scratch);
  float* ypart = part + static_cast<size_t>(splits) * B * L * H;
  cudaError_t err;
  switch (bn) {
    case 128:
      err = launch_a<4, 4>(xs, w1s, part, B, L, H, k1, splits, s);
      break;
    case 64:
      err = launch_a<2, 2>(xs, w1s, part, B, L, H, k1, splits, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int smem = smem_b(splits, k2);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    err = cudaFuncSetAttribute(ffn_conv2_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid_b((L + kBN_B - 1) / kBN_B, groups, B);
  ffn_conv2_bf16_kernel<<<grid_b, kThreadsB, smem, s>>>(
      part, static_cast<const float*>(b1), static_cast<const uint4*>(w2),
      ypart, B, L, H, k2, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * L;
  const dim3 grid_c((rows + kThreadsC / 32 - 1) / (kThreadsC / 32));
  ffn_ln_kernel<bf16><<<grid_c, kThreadsC, 0, s>>>(
      ypart, static_cast<const float*>(b2), xs,
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<bf16*>(out), rows, groups);
  return cudaGetLastError();
}

}  // namespace

// K2's bfloat16 launch plan at [B, L, 256] -> H with a k1-tap first conv
// (the float32 instance has its own, fs2_conv_ffn_f32_plan):
//   cfg[0] = positions per block of (a): 64 up to L = 64, else 128;
//   cfg[1] = the tap splits S of (a), the smallest whose grid has a block
//            for every SM (at most k1, and no split left without a tap);
//   cfg[2] = the hidden groups G of (b), the smallest power of two (at most
//            H / 64) whose grid has a block for every SM.
// Chosen by measurement on an H100 (PERF.md).  Returns the floats of
// scratch the call needs: S B L H partial sums of the first conv, then
// G B L 256 of the second.
extern "C" long long fs2_conv_ffn_plan(int B, int L, int H, int k1,
                                       int* cfg) {
  const int bn = L <= 64 ? 64 : 128;
  const long long blocks =
      static_cast<long long>((L + bn - 1) / bn) * (H / kBM_A) * B;
  int splits = k1;
  for (int s = 1; s <= k1; ++s)
    if (blocks * s >= sm_count()) {
      splits = s;
      break;
    }
  const int per = (k1 + splits - 1) / splits;
  splits = (k1 + per - 1) / per;
  const long long tiles = static_cast<long long>((L + kBN_B - 1) / kBN_B) * B;
  int groups = 1;
  while (groups * 2 <= H / kSliceB && (H / kSliceB) % (groups * 2) == 0 &&
         tiles * groups < sm_count())
    groups *= 2;
  cfg[0] = bn;
  cfg[1] = splits;
  cfg[2] = groups;
  return (static_cast<long long>(splits) * H + groups * kD) * B * L;
}

// x, out: [B, L, D] bfloat16; w1, w2: the bfloat16 packs of conv1
// ([H/16][k1][D/16][32][8] values) and conv2 ([D/16][k2][H/16][32][8]); b1:
// [H]; b2, gamma, beta: [D]; scratch: fs2_conv_ffn_plan's floats; b1, b2,
// gamma, beta and the scratch float32.  All contiguous, 16-byte aligned.
// Takes D = 256, H a multiple of 64, k1, k2 >= 1 (a k-tap conv pads
// (k-1)/2 zeros before and k/2 after, SAME), and bn, splits, groups as
// fs2_conv_ffn_plan gives them (bn in {64, 128}, 1 <= splits <= k1, groups
// dividing H / 64).  Launches the three kernels on `stream`; returns
// cudaGetLastError() after each (or cudaErrorInvalidValue for a shape the
// kernels do not take).
extern "C" int fs2_conv_ffn_fwd_bf16(const void* x, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, const void* gamma,
                                     const void* beta, void* scratch,
                                     void* out, int B, int L, int D, int H,
                                     int k1, int k2, int bn, int splits,
                                     int groups, void* stream) {
  return conv_ffn_fwd(x, w1, b1, w2, b2, gamma, beta, scratch, out, B, L, D,
                      H, k1, k2, bn, splits, groups, stream);
}
