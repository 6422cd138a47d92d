// Fused E2VID encoder level: stride-2 5x5 conv + ReLU + int8 ConvLSTM cell,
// with every quantization scale found on the device by these kernels.
//
// Replaces the TPU kernel ess_tpu/ops/level_pallas.py::_level_kernel, which
// holds one (sample, row tile) group in VMEM: it quantizes the group's rows
// of u by their absmax, runs the conv as an int8 3x3 product over the 2x2
// space-to-depth view of u, quantizes the conv's output x by the group's
// absmax without x ever leaving VMEM, and runs the gate conv as two int8
// products (x and h carry different scales) before the LSTM pointwise.
//
// One group of x is 24 x 320 x 64 values at the first DSEC level: more than
// the 227 KB of shared memory a block has here. So both absmax reductions
// cross thread blocks, and the one TPU kernel becomes a fixed sequence of
// five kernels on one stream (no torch operation between them). G = B * NT
// groups of TH output rows; the quantization groups are the JAX package's
// whatever the thread blocks below cover:
//
// 1. amax_u_kernel: per group, max |u| over its space-to-depth rows
//    r0-2 .. r0+TH+1 inside the image. In NHWC these rows are one contiguous
//    range in either input form. atomicMax on the bits of a non-negative
//    float is exact and order-free.
// 2. quant_u_kernel: u * (127 / amax_u), rounded half to even and clipped,
//    into an int8 copy uq (G, TH+4, WO, CU) in space-to-depth layout, zero
//    rows past the image. A full-resolution u is read at (2Y+r, 2X+s)
//    directly: no space-to-depth pass of its own. cp.async cannot convert
//    while it copies, hence the int8 copy.
// 3. level_conv_kernel: implicit GEMM per group, M = (TH+2) * WO pixels (x
//    on the cell's halo rows too, with this group's u scale), N = CH,
//    K = 9 * CU; x = relu(f32(acc) * (wse * (amax_u / 127)) + bias), rows
//    outside the image set to 0 (the gate conv's zero padding); x goes to a
//    f32 scratch buffer and its max to amax_x.
// 4. quant_xh_kernel: x * (127 / amax_x) and h * 127 into int8 copies with
//    the same group layout (G, TH+2, WO, CH), zero rows of h past the image.
// 5. level_gates_kernel: implicit GEMM per group, M = TH * WO, N = 4 * CH in
//    the permuted gate columns of conv_lstm.cu, the two K ranges of 9 * CH
//    (x and h) on two warp groups with one i32 accumulator each, gates =
//    f32(acc_x) * (wsx * (amax_x / 127)) + f32(acc_h) * (wsh / 127) + bias,
//    then the LSTM pointwise of conv_lstm_int8.cu; h' to a new buffer, c in
//    place.
//
// Every f32 operation of the scales and the epilogues is rounded on its own
// (__fdiv_rn, __fmul_rn, __fadd_rn, fmaxf) in the plain version's order, and
// the i32 accumulators are exact, so x, both scales and both quantized
// operands equal the plain version's bit for bit, and h', c' differ from it
// only where expf/tanhf round differently before the bf16 store.
//
// Bounds on the H100 at B=8: 390 GOP of int8 products per level (the 25
// taps of the 5x5 conv and the gate conv; 0.20 ms at 1,979 TOP/s) against
// 0.13 ms of bytes at the first level, so the operations bound it. This
// first version runs mma.sync m16n8k32 from a 3-stage cp.async ring (64 x 32
// tiles per warp) and moves x through device memory twice (f32, then int8);
// wgmma, TMA and keeping x on the chip come later. The conv multiplies the
// 11 zero (tap, phase) pairs of its space-to-depth form too: skipping their
// stages through a stage list was measured on an H100 and gained nothing
// (0.24 -> 0.22 ms at the second level, 0.30 -> 0.31 ms at the first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

using namespace ess;

constexpr int BK = 64, STAGES = 3;     // BK in bytes
constexpr int LDS = BK + 16;          // padded smem row: 80 B, as conv_lstm.cu
constexpr int kThreads = 256;         // 8 warps
constexpr float kAmaxFloor = 1e-6f;

// Block tile BM_ x (32 * WN): WN warps along N, 8 / WN along M.
template <int WN, int BM_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = 32 * WN;
  static constexpr int WM = 8 / WN;
  static constexpr int WROWS = BM / WM;
  static constexpr int MT = WROWS / 16;
  static constexpr int kStageBytes = (BM + BN) * LDS;
  static constexpr int kSmem = STAGES * kStageBytes;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(round_half_even(v * s), -127, 127) of four values, packed
__device__ __forceinline__ unsigned quant4(float v0, float v1, float v2,
                                           float v3, float s) {
  const float v[4] = {v0, v1, v2, v3};
  unsigned out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int q = __float2int_rn(__fmul_rn(v[j], s));
    q = min(127, max(-127, q));
    out |= (static_cast<unsigned>(q) & 0xffu) << (8 * j);
  }
  return out;
}

__device__ __forceinline__ uint2 quant8_bf16(const __nv_bfloat16* src,
                                             float s) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  uint2 q;
  q.x = quant4(__bfloat162float(e[0]), __bfloat162float(e[1]),
               __bfloat162float(e[2]), __bfloat162float(e[3]), s);
  q.y = quant4(__bfloat162float(e[4]), __bfloat162float(e[5]),
               __bfloat162float(e[6]), __bfloat162float(e[7]), s);
  return q;
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// max into a non-negative float: the bits of non-negative floats order as
// the floats do
__device__ __forceinline__ void atomic_max_nonneg(float* dst, float m) {
  atomicMax(reinterpret_cast<int*>(dst), __float_as_int(m));
}

// Rows lo .. hi-1 of sample b's space-to-depth view are the contiguous
// elements [ (b*HO + lo) * row_elems, (b*HO + hi) * row_elems ) of u in
// either input form (row_elems = WO * CU: one space-to-depth row, or two
// full-resolution rows).
__global__ void __launch_bounds__(kThreads)
amax_u_kernel(const __nv_bfloat16* __restrict__ u, int64_t row_elems, int HO,
              int TH, int NT, float* __restrict__ amax_u) {
  const int g = blockIdx.y, b = g / NT, it = g - b * NT;
  const int lo = max(0, it * TH - 2), hi = min(HO, it * TH + TH + 2);
  const uint4* p = reinterpret_cast<const uint4*>(
      u + ((int64_t)b * HO + lo) * row_elems);
  const int64_t n8 = (int64_t)(hi - lo) * row_elems / 8;
  float m = 0.f;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n8;
       i += (int64_t)gridDim.x * kThreads) {
    const uint4 v = p[i];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(e[j])));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) atomic_max_nonneg(amax_u + g, m);
}

// One thread per 8 channels of uq (G, TH+4, WO, CU).
__global__ void __launch_bounds__(kThreads)
quant_u_kernel(const __nv_bfloat16* __restrict__ u,
               const float* __restrict__ amax_u, int8_t* __restrict__ uq,
               int HO, int WO, int CU, int TH, int NT, int u_s2d,
               int64_t n8) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n8) return;
  const int c8 = CU / 8;
  const int cu = (int)(idx % c8) * 8;
  int64_t t = idx / c8;
  const int X = (int)(t % WO);
  t /= WO;
  const int i = (int)(t % (TH + 4));
  const int g = (int)(t / (TH + 4));
  const int b = g / NT, it = g - b * NT;
  const int R = it * TH - 2 + i;          // space-to-depth row in the image
  uint2 q = make_uint2(0u, 0u);
  if (R >= 0 && R < HO) {
    const float s = __fdiv_rn(127.f, fmaxf(amax_u[g], kAmaxFloor));
    const __nv_bfloat16* src;
    if (u_s2d) {
      src = u + (((int64_t)b * HO + R) * WO + X) * CU + cu;
    } else {
      // channel (r*2 + s)*C1 + c of the view is pixel (2R + r, 2X + s)
      const int C1 = CU / 4, ph = cu / C1, c = cu - ph * C1;
      src = u + (((int64_t)b * 2 * HO + 2 * R + (ph >> 1)) * (2 * WO) +
                 2 * X + (ph & 1)) * C1 + c;
    }
    q = quant8_bf16(src, s);
  }
  *reinterpret_cast<uint2*>(uq + idx * 8) = q;
}

// Threads [0, nx8) quantize x (f32, G x (TH+2) x WO x CH) by its group's
// scale; the next nx8 threads gather and quantize h by 127 into the same
// group layout.
__global__ void __launch_bounds__(kThreads)
quant_xh_kernel(const float* __restrict__ xs,
                const float* __restrict__ amax_x,
                const __nv_bfloat16* __restrict__ h, int8_t* __restrict__ xq,
                int8_t* __restrict__ hq, int HO, int WO, int CH, int TH,
                int NT, int64_t nx8) {
  int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int c8 = CH / 8;
  const int64_t group8 = (int64_t)(TH + 2) * WO * c8;
  if (idx < nx8) {
    const int g = (int)(idx / group8);
    const float s = __fdiv_rn(127.f, fmaxf(amax_x[g], kAmaxFloor));
    const float4 a = *reinterpret_cast<const float4*>(xs + idx * 8);
    const float4 b = *reinterpret_cast<const float4*>(xs + idx * 8 + 4);
    uint2 q;
    q.x = quant4(a.x, a.y, a.z, a.w, s);
    q.y = quant4(b.x, b.y, b.z, b.w, s);
    *reinterpret_cast<uint2*>(xq + idx * 8) = q;
    return;
  }
  idx -= nx8;
  if (idx >= nx8) return;
  const int c = (int)(idx % c8) * 8;
  int64_t t = idx / c8;
  const int X = (int)(t % WO);
  t /= WO;
  const int j = (int)(t % (TH + 2));
  const int g = (int)(t / (TH + 2));
  const int b = g / NT, it = g - b * NT;
  const int R = it * TH - 1 + j;
  uint2 q = make_uint2(0u, 0u);
  if (R >= 0 && R < HO)
    q = quant8_bf16(h + (((int64_t)b * HO + R) * WO + X) * CH + c, 127.f);
  *reinterpret_cast<uint2*>(hq + idx * 8) = q;
}

// acc = A (BM pixels x 9*C) * W^T: the 3x3 taps of output pixel m = j*W + X
// of one group read rows j .. j+2 (the source has two rows more than the
// output: no row padding) and columns X-1 .. X+1 (zero outside) of the
// group's int8 source src (rows, W, C). W is (N, 9*C) with column
// tap*C + cin; rows past N are zero-filled. One stage is 64 channels of one
// tap; a tap's tail past C is zero-filled in both operands.
template <int WN, int BM>
__device__ __forceinline__ void tap_gemm(
    int (&acc)[Tile<WN, BM>::MT][4][4], const int8_t* __restrict__ src,
    const int8_t* __restrict__ w, int C, int W, int Mg, int N, int m0, int n0,
    int8_t* smem) {
  using T = Tile<WN, BM>;
  constexpr int AROWS = BM / 64;     // A rows each thread loads per stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int K = 9 * C;
  const int chunks_per_tap = (C + BK - 1) / BK, KT = 9 * chunks_per_tap;

  int a_j[AROWS], a_x[AROWS];
  bool a_ok[AROWS];
#pragma unroll
  for (int i = 0; i < AROWS; ++i) {
    const int m = m0 + (tid >> 2) + i * 64;
    a_ok[i] = m < Mg;
    const int mm = a_ok[i] ? m : 0;
    a_j[i] = mm / W;
    a_x[i] = mm - a_j[i] * W;
  }
  const int part = (tid & 3) * 16;   // this thread's 16 bytes of a row

  auto load_stage = [&](int stage, int ks) {
    int8_t* As = smem + stage * T::kStageBytes;
    int8_t* Bs = As + BM * LDS;
    const int tap = ks / chunks_per_tap;
    const int c0 = (ks - tap * chunks_per_tap) * BK;
    const int dy = tap / 3, dx = tap % 3 - 1;
    const int co = c0 + part;
    const bool in_k = co < C;
#pragma unroll
    for (int i = 0; i < AROWS; ++i) {
      const int row = (tid >> 2) + i * 64;
      const int sx = a_x[i] + dx;
      const bool ok = in_k && a_ok[i] && sx >= 0 && sx < W;
      const int8_t* g =
          ok ? src + ((int64_t)(a_j[i] + dy) * W + sx) * C + co : src;
      cp_async16(As + row * LDS + part, g, ok);
    }
    for (int c = tid; c < T::BN * 4; c += kThreads) {
      const int row = c >> 2, p = (c & 3) * 16;
      const bool ok = c0 + p < C && n0 + row < N;
      const int8_t* gb =
          ok ? w + (int64_t)(n0 + row) * K + tap * C + c0 + p : w;
      cp_async16(Bs + row * LDS + p, gb, ok);
    }
  };

  auto mma_stage = [&](const int8_t* As) {
    const int8_t* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[T::MT][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const int r = wm * T::WROWS + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], As + r * LDS + kk + (lane >> 4) * 16);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r4[4];
        const int r = wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4(r4, Bs + r * LDS + kk + ((lane >> 3) & 1) * 16);
        b[np * 2][0] = r4[0];
        b[np * 2][1] = r4[1];
        b[np * 2 + 1][0] = r4[2];
        b[np * 2 + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  };

#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < KT; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = ks + STAGES - 1;
    if (nxt < KT) load_stage(nxt % STAGES, nxt);
    cp_async_commit();
    mma_stage(smem + (ks % STAGES) * T::kStageBytes);
  }
  cp_async_wait<0>();
}

// Pixels per block of the conv: 128 x 128 with four warps along N, 256 x 64
// with two (CH <= 64), so that a warp's tile is 64 x 32 either way.
template <int WN>
constexpr int kConvBM = WN == 4 ? 128 : 256;

template <int WN>
__global__ void __launch_bounds__(kThreads, 2)
level_conv_kernel(const int8_t* __restrict__ uq,   // (G, TH+4, WO, CU)
                  const int8_t* __restrict__ we,   // (CH, 9*CU)
                  const float* __restrict__ sbe,   // (2, CH): wse, bias
                  const float* __restrict__ amax_u,
                  float* __restrict__ xs,          // (G, TH+2, WO, CH)
                  float* __restrict__ amax_x, int HO, int WO, int CU, int CH,
                  int TH, int NT) {
  using T = Tile<WN, kConvBM<WN>>;
  extern __shared__ __align__(16) int8_t smem8[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = blockIdx.z, it = g % NT;
  const int Mg = (TH + 2) * WO;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int8_t* src = uq + (int64_t)g * (TH + 4) * WO * CU;

  int acc[T::MT][4][4];
  tap_gemm<WN, T::BM>(acc, src, we, CU, WO, Mg, CH, m0, n0, smem8);

  const float su = __fdiv_rn(fmaxf(amax_u[g], kAmaxFloor), 127.f);
  float* xg = xs + (int64_t)g * Mg * CH;
  float lmax = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
    if (col >= CH) continue;           // CH is even: both columns or none
    const float sc0 = __fmul_rn(sbe[col], su);
    const float sc1 = __fmul_rn(sbe[col + 1], su);
    const float bi0 = sbe[CH + col], bi1 = sbe[CH + col + 1];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * T::WROWS + mt * 16 + (lane >> 2) + half * 8;
        if (m >= Mg) continue;
        const int R = it * TH - 1 + m / WO;     // x row in the image
        float v0 = 0.f, v1 = 0.f;
        if (R >= 0 && R < HO) {
          v0 = fmaxf(__fadd_rn(__fmul_rn(
                         __int2float_rn(acc[mt][nt][half * 2]), sc0),
                     bi0), 0.f);
          v1 = fmaxf(__fadd_rn(__fmul_rn(
                         __int2float_rn(acc[mt][nt][half * 2 + 1]), sc1),
                     bi1), 0.f);
        }
        lmax = fmaxf(lmax, fmaxf(v0, v1));
        *reinterpret_cast<float2*>(xg + (int64_t)m * CH + col) =
            make_float2(v0, v1);
      }
    }
  }
  lmax = warp_max(lmax);
  if (lane == 0) atomic_max_nonneg(amax_x + g, lmax);
}

// The gate conv with its two K ranges on two warp groups: warps 0-3 multiply
// the x taps, warps 4-7 the h taps, each warp a 64 x 32 tile of the block's
// 64 pixels x 128 gate columns in one accumulator. A stage holds 64 channels
// of one tap of both sources and both weight matrices. At the end each group
// dequantizes the half of its tile that the other group finishes (x warps
// keep pixels 0-31, h warps 32-63) into shared memory, so that both groups
// run the pointwise. (With both accumulators in every warp a 128-pixel
// block tile takes 128 accumulator registers a thread and leaves one block
// on an SM: 2.19 ms per step at the first DSEC level at B=8 on an H100 at
// 700 W; 32 x 32 per warp 1.95 ms; this form 1.63 ms.)
constexpr int kGatesBM = 64, kGatesBN = 128;
constexpr int kGatesStageBytes = (2 * kGatesBM + 2 * kGatesBN) * LDS;
constexpr int kGatesSmem = STAGES * kGatesStageBytes;

__global__ void __launch_bounds__(kThreads, 2)
level_gates_kernel(const int8_t* __restrict__ xq,   // (G, TH+2, WO, CH)
                   const int8_t* __restrict__ hq,   // (G, TH+2, WO, CH)
                   const int8_t* __restrict__ wx,   // (4*CH, 9*CH) permuted
                   const int8_t* __restrict__ wh,   // (4*CH, 9*CH) permuted
                   const float* __restrict__ sbg,   // (3, 4*CH) i,f,o,g
                   const float* __restrict__ amax_x,
                   __nv_bfloat16* __restrict__ c,
                   __nv_bfloat16* __restrict__ h_out, int HO, int WO, int CH,
                   int TH, int NT) {
  extern __shared__ __align__(16) int8_t smem8[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2, wn = warp & 3;      // grp 0: x taps, 1: h taps
  const int g = blockIdx.z, b = g / NT, it = g - b * NT;
  const int Mg = TH * WO, K = 9 * CH;
  const int m0 = blockIdx.x * kGatesBM, n0 = blockIdx.y * kGatesBN;
  const int64_t gsz = (int64_t)(TH + 2) * WO * CH;
  const int8_t* srcx = xq + g * gsz;
  const int8_t* srch = hq + g * gsz;
  const int chunks_per_tap = (CH + BK - 1) / BK, KT = 9 * chunks_per_tap;

  // the A row (pixel) and the two B rows this thread loads each stage, for
  // both sources
  const int a_m = m0 + (tid >> 2);
  const bool a_ok = a_m < Mg;
  const int a_j = (a_ok ? a_m : 0) / WO;
  const int a_x = (a_ok ? a_m : 0) - a_j * WO;
  const int part = (tid & 3) * 16;

  auto load_stage = [&](int stage, int ks) {
    int8_t* Ax = smem8 + stage * kGatesStageBytes;
    int8_t* Ah = Ax + kGatesBM * LDS;
    int8_t* Bx = Ah + kGatesBM * LDS;
    int8_t* Bh = Bx + kGatesBN * LDS;
    const int tap = ks / chunks_per_tap;
    const int co = (ks - tap * chunks_per_tap) * BK + part;
    const int dy = tap / 3, dx = tap % 3 - 1;
    const bool in_k = co < CH;
    const int sx = a_x + dx;
    const bool ok = in_k && a_ok && sx >= 0 && sx < WO;
    const int64_t a_off = ok ? ((int64_t)(a_j + dy) * WO + sx) * CH + co : 0;
    const int row = tid >> 2;
    cp_async16(Ax + row * LDS + part, srcx + a_off, ok);
    cp_async16(Ah + row * LDS + part, srch + a_off, ok);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int brow = row + i * 64;
      const int64_t b_off =
          in_k ? (int64_t)(n0 + brow) * K + tap * CH + co : 0;
      cp_async16(Bx + brow * LDS + part, wx + b_off, in_k);
      cp_async16(Bh + brow * LDS + part, wh + b_off, in_k);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < KT; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = ks + STAGES - 1;
    if (nxt < KT) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const int8_t* As = smem8 + (ks % STAGES) * kGatesStageBytes +
                       grp * kGatesBM * LDS;
    const int8_t* Bs = smem8 + (ks % STAGES) * kGatesStageBytes +
                       (2 * kGatesBM + grp * kGatesBN) * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], As + r * LDS + kk + (lane >> 4) * 16);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r4[4];
        const int r = wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4(r4, Bs + r * LDS + kk + ((lane >> 3) & 1) * 16);
        bf[np * 2][0] = r4[0];
        bf[np * 2][1] = r4[1];
        bf[np * 2 + 1][0] = r4[2];
        bf[np * 2 + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a[mt], bf[nt][0], bf[nt][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: reuse it

  // epilogue: n-tile nt of this warp is gate nt of channels ch .. ch+1.
  // own[q][j]: this group's dequantizing factor; x warps keep m-tiles 0-1,
  // h warps 2-3, and hand the other two over as f32 products
  const float sxg = __fdiv_rn(fmaxf(amax_x[g], kAmaxFloor), 127.f);
  const int ch = (n0 + wn * 32) / 4 + (lane & 3) * 2;
  float own[4][2], bi[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = q * CH + ch + j;
      own[q][j] = grp == 0 ? __fmul_rn(sbg[n], sxg) : sbg[4 * CH + n];
      bi[q][j] = sbg[8 * CH + n];
    }
  // exchange buffer: [giving group][wn][m-tile of the pair][nt][r][lane].
  // The m-tile indices are compile-time constants per group, so that the
  // accumulators stay in registers.
  float* xch = reinterpret_cast<float*>(smem8);
  auto give = [&](auto group) {
    constexpr int GRP = decltype(group)::value, GIVE0 = 2 - 2 * GRP;
#pragma unroll
    for (int ml = 0; ml < 2; ++ml)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          xch[((((GRP * 4 + wn) * 2 + ml) * 4 + q) * 4 + r) * 32 + lane] =
              __fmul_rn(__int2float_rn(acc[GIVE0 + ml][q][r]),
                        own[q][r & 1]);
  };
  const int64_t pix0 = ((int64_t)b * HO + it * TH) * WO;
  auto keep = [&](auto group) {
    constexpr int GRP = decltype(group)::value, KEEP0 = 2 * GRP;
#pragma unroll
    for (int ml = 0; ml < 2; ++ml) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + (KEEP0 + ml) * 16 + (lane >> 2) + half * 8;
        if (m >= Mg) continue;
        const int64_t off = (pix0 + m) * CH + ch;
        const __nv_bfloat162 cp2 =
            *reinterpret_cast<const __nv_bfloat162*>(c + off);
        const float cp[2] = {__bfloat162float(cp2.x),
                             __bfloat162float(cp2.y)};
        float hn[2], cn[2], gt[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = half * 2 + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float mine = __fmul_rn(
                __int2float_rn(acc[KEEP0 + ml][q][r]), own[q][j]);
            const float other =
                xch[(((((1 - GRP) * 4 + wn) * 2 + ml) * 4 + q) * 4 + r) *
                        32 + lane];
            // f32(acc_x) * sx + f32(acc_h) * sh, then the bias
            gt[q] = __fadd_rn(__fadd_rn(mine, other), bi[q][j]);
          }
          cn[j] = __fadd_rn(__fmul_rn(sigmoidf_(gt[1]), cp[j]),
                            __fmul_rn(sigmoidf_(gt[0]), tanhf(gt[3])));
          hn[j] = __fmul_rn(sigmoidf_(gt[2]), tanhf(cn[j]));
        }
        *reinterpret_cast<__nv_bfloat162*>(c + off) =
            __floats2bfloat162_rn(cn[0], cn[1]);
        *reinterpret_cast<__nv_bfloat162*>(h_out + off) =
            __floats2bfloat162_rn(hn[0], hn[1]);
      }
    }
  };
  if (grp == 0)
    give(std::integral_constant<int, 0>{});
  else
    give(std::integral_constant<int, 1>{});
  __syncthreads();
  if (grp == 0)
    keep(std::integral_constant<int, 0>{});
  else
    keep(std::integral_constant<int, 1>{});
}

template <int WN>
cudaError_t launch_conv(const int8_t* uq, const int8_t* we, const float* sbe,
                        const float* amax_u, float* xs, float* amax_x, int G,
                        int HO, int WO, int CU, int CH, int TH, int NT,
                        cudaStream_t stream) {
  using T = Tile<WN, kConvBM<WN>>;
  cudaError_t err = cudaFuncSetAttribute(
      level_conv_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return err;
  const int Mg = (TH + 2) * WO;
  dim3 blocks((Mg + T::BM - 1) / T::BM, (CH + T::BN - 1) / T::BN, G);
  level_conv_kernel<WN><<<blocks, kThreads, T::kSmem, stream>>>(
      uq, we, sbe, amax_u, xs, amax_x, HO, WO, CU, CH, TH, NT);
  return cudaGetLastError();
}

}  // namespace

// u: bf16 NHWC, (B, HO, WO, CU) if u_s2d else (B, 2*HO, 2*WO, CU/4); h, c:
// bf16 (B, HO, WO, CH); we (CH, 9*CU), wx, wh (4*CH, 9*CH): int8; sbe
// (2, CH), sbg (3, 4*CH): f32. Scratch: uq int8 (G, TH+4, WO, CU), xs f32 and
// xq, hq int8 (G, TH+2, WO, CH), amax f32 (2, G) with G = B * HO / TH groups
// (row 0: amax_u, row 1: amax_x, as found, before the 1e-6 floor). h_out:
// bf16 (B, HO, WO, CH); c is updated in place. CH a multiple of 32, CU of 16
// (32 for a full-resolution u), TH divides HO. All 16-byte aligned.
extern "C" int ess_level_int8(const void* u, const void* h, void* c,
                              const void* we, const void* wx, const void* wh,
                              const void* sbe, const void* sbg, void* uq,
                              void* xs, void* xq, void* hq, void* amax,
                              void* h_out, int B, int HO, int WO, int CU,
                              int CH, int TH, int u_s2d, void* stream_) {
  if (B <= 0 || HO <= 0 || WO <= 0) return 0;
  if (TH <= 0 || HO % TH != 0 || CH % 32 != 0 ||
      CU % (u_s2d ? 16 : 32) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int NT = HO / TH, G = B * NT;
  if (G > 65535) return (int)cudaErrorInvalidValue;
  float* amax_u = (float*)amax;
  float* amax_x = amax_u + G;
  cudaError_t err = cudaMemsetAsync(amax, 0, 2 * G * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;

  const int64_t row_elems = (int64_t)WO * CU;
  const int64_t range8 = (int64_t)(TH + 4) * row_elems / 8;
  const int64_t want = (range8 + kThreads - 1) / kThreads;
  const int chunks = want < 64 ? (int)want : 64;
  amax_u_kernel<<<dim3(chunks, G), kThreads, 0, stream>>>(
      (const __nv_bfloat16*)u, row_elems, HO, TH, NT, amax_u);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int64_t nu8 = (int64_t)G * (TH + 4) * row_elems / 8;
  quant_u_kernel<<<(unsigned)((nu8 + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>((const __nv_bfloat16*)u, amax_u, (int8_t*)uq, HO,
                             WO, CU, TH, NT, u_s2d, nu8);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = CH > 64 ? launch_conv<4>((const int8_t*)uq, (const int8_t*)we,
                                 (const float*)sbe, amax_u, (float*)xs,
                                 amax_x, G, HO, WO, CU, CH, TH, NT, stream)
                : launch_conv<2>((const int8_t*)uq, (const int8_t*)we,
                                 (const float*)sbe, amax_u, (float*)xs,
                                 amax_x, G, HO, WO, CU, CH, TH, NT, stream);
  if (err != cudaSuccess) return (int)err;

  const int64_t nx8 = (int64_t)G * (TH + 2) * WO * CH / 8;
  quant_xh_kernel<<<(unsigned)((2 * nx8 + kThreads - 1) / kThreads), kThreads,
                    0, stream>>>((const float*)xs, amax_x,
                                 (const __nv_bfloat16*)h, (int8_t*)xq,
                                 (int8_t*)hq, HO, WO, CH, TH, NT, nx8);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(level_gates_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGatesSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 blocks((TH * WO + kGatesBM - 1) / kGatesBM, 4 * CH / kGatesBN, G);
  level_gates_kernel<<<blocks, kThreads, kGatesSmem, stream>>>(
      (const int8_t*)xq, (const int8_t*)hq, (const int8_t*)wx,
      (const int8_t*)wh, (const float*)sbg, amax_x, (__nv_bfloat16*)c,
      (__nv_bfloat16*)h_out, HO, WO, CH, TH, NT);
  return (int)cudaGetLastError();
}
