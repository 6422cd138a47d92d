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
// cross thread blocks, and the one TPU kernel becomes three kernels on one
// stream (no torch operation and no memset between them), the last two on
// the halo-tile wgmma core of conv_halo.cuh. G = B * NT groups of TH output
// rows; the quantization groups are the JAX package's whatever the thread
// blocks below cover, and a pixel tile of either product never straddles
// two groups (the plan, ops/conv_halo.py::level_plan):
//
// 1. amax_u_kernel: per group, the maxima of |u| over its space-to-depth
//    rows r0-2 .. r0+TH+1 inside the image, one partial per block of a
//    (P, G) grid (in NHWC these rows are one contiguous range in either
//    input form); it also zeroes the group's amax_x for kernel 2.
// 2. level_conv_kernel: the level conv as the s8 instantiation of the
//    halo-tile conv (as B4-int8's conv3x3_halo_kernel<true>): a group is an
//    image of TH + 2 output rows (x on the cell's halo rows too, with this
//    group's u scale) whose input rows are u's r0-2 .. r0+TH+1, zero past
//    the image. Per chunk of 64 space-to-depth channels the block copies
//    the halo's bf16 pixels with cp.async (a full-resolution u gathered at
//    (2Y+r, 2X+s): one 16-byte piece lies in one phase) into a raw stage
//    and quantizes it into the s8 halo tile by the group's 127 / amax_u,
//    which every warp reduces from the partials at the tile's first chunk
//    (one thread also stores it as the group's amax_u). wgmma
//    .s32.s8.s8, A from registers. Epilogue: x = relu(f32(acc) *
//    (wse * (amax_u / 127)) + bias), rows outside the image set to 0 (the
//    gate conv's zero padding), rows past the group's TH + 2 not stored;
//    x is written once, in f32, in the group layout (G, TH+2, WO, CH), and
//    its max goes to amax_x by atomicMax on the bits (non-negative floats
//    order as their bits).
// 3. level_cell_kernel: the gate conv on the int8 cell kernel's machinery
//    (conv_halo.cuh's last section: a producer warpgroup, a 2-stage
//    mbarrier ring of bulk-copied weight stages, 64-byte-swizzled s8 halos
//    read by load_a_sw, two consumer warpgroups taking turns on wgmma
//    .s32.s8.s8 and running the LSTM epilogue in registers). Its two
//    operand sources are quantized as they are staged: the producer
//    warpgroup loads each chunk's halo of x (f32, group layout, by the
//    group's 127 / amax_x) or of h (bf16, image layout, zero past the
//    image, by 127) and stores it swizzled as s8. A work item is one pixel
//    tile with all its N tiles: every chunk's s8 halo stays in shared
//    memory for the item, so x and h are staged once a pixel tile, not
//    once an N tile (restaged for each of its 8 N tiles, the third level's
//    halos took 0.29 ms a call on the H100); the weights stream in stages
//    of a whole chunk, or of half a chunk (32 channels of every tap) where
//    the halos leave no room for more. The x and h chunks of a tile
//    accumulate into two s32 accumulators (x and h carry different column
//    scales; two m64 x 128 accumulators take 128 registers a thread), so a
//    consumer warpgroup owns one m64 row tile of a 128-pixel patch where
//    the int8 cell's owns two. gates = f32(acc_x) * (wsx * (amax_x / 127))
//    + f32(acc_h) * (wsh / 127) + bias, then the LSTM pointwise; h' to a
//    new buffer, c in place. The pointwise of a tile's 128 x 32 outputs
//    (three sigmoids and two tanh each, rounded as torch's) runs while the
//    other warpgroup's last stage multiplies, and costs as much as the
//    products (tools/bench_level.py --attribute).
//
// Every f32 operation of the scales and the epilogues is rounded on its own
// (__fdiv_rn, __fmul_rn, __fadd_rn, fmaxf) in the plain version's order, and
// the s32 accumulators are exact, so x, both scales and both quantized
// operands equal the plain version's bit for bit, and h', c' differ from it
// only where expf/tanhf round differently before the bf16 store.
//
// Bounds on the H100 at B=8: 390 GOP of int8 products per level (the 25
// taps of the 5x5 conv and the gate conv; 0.20 ms at 1,979 TOP/s) against
// 0.13 ms of bytes at the first level, so the operations bound it. The
// conv multiplies the 11 zero (tap, phase) pairs of its space-to-depth form
// too (skipping them gained nothing on the earlier design). x crosses device
// memory once each way in f32 (157 MB at the first level at B=8); the int8
// copies of u, x and h of the earlier design are gone.

#include "conv_halo.cuh"

// Attribution builds only (tools/bench_level.py --attribute): the gate
// kernel without its halo staging (1), its weight copies (2) or its
// epilogue (4), the conv without its input copies and quantize (8), its
// streamed weight copies (16) or its epilogue (32); the products run on
// whatever the stages hold.
#ifndef LEVEL_SKIP
#define LEVEL_SKIP 0
#endif

namespace {

using namespace ess;
using namespace ess::halo;

constexpr float kAmaxFloor = 1e-6f;
constexpr int kAmaxThreads = 256;
constexpr int kMaxAmaxBlocks = 64;     // partials a group (ops: AMAX_BLOCKS)

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
// full-resolution rows). Block (i, g) writes the max |u| of its share of
// group g's rows to partials[g * P + i]; block (0, g) zeroes amax_x[g].
__global__ void __launch_bounds__(kAmaxThreads)
amax_u_kernel(const __nv_bfloat16* __restrict__ u, int64_t row_elems, int HO,
              int TH, int NT, float* __restrict__ partials,
              float* __restrict__ amax_x) {
  __shared__ float red[kAmaxThreads / 32];
  const int g = blockIdx.y, b = g / NT, it = g - b * NT;
  const int lo = max(0, it * TH - 2), hi = min(HO, it * TH + TH + 2);
  const uint4* p = reinterpret_cast<const uint4*>(
      u + ((int64_t)b * HO + lo) * row_elems);
  const int64_t n8 = (int64_t)(hi - lo) * row_elems / 8;
  float m = 0.f;
  for (int64_t i = (int64_t)blockIdx.x * kAmaxThreads + threadIdx.x; i < n8;
       i += (int64_t)gridDim.x * kAmaxThreads) {
    const uint4 v = p[i];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(e[j])));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kAmaxThreads / 32; ++w) m = fmaxf(m, red[w]);
    partials[(int64_t)g * gridDim.x + blockIdx.x] = m;
    if (blockIdx.x == 0) amax_x[g] = 0.f;
  }
}

// amax_u of group g from its P partials (every lane of the warp gets it)
__device__ __forceinline__ float group_amax_u(const float* __restrict__ part,
                                              int P, int g) {
  float m = 0.f;
  for (int i = threadIdx.x & 31; i < P; i += 32)
    m = fmaxf(m, part[(int64_t)g * P + i]);
  return warp_max(m);
}

// The level's geometry, shared by kernels 2 and 3.
struct Level {
  int B, HO, WO, CU, CH, TH, NT, u_s2d;
};

// The input side of the level conv: a stage is the halo of one pixel tile
// (tp.b: the group; tp.y0: the tile's first row among the group's TH + 2
// x rows) and one chunk of 64 space-to-depth channels of u, copied as bf16
// pixels into a raw stage (in_pitch bytes a pixel, 16-byte pieces), then
// quantized into the s8 halo tile. Threads t of nt share the work.
struct UStager {
  const unsigned char* u;       // bf16, NHWC
  Level L;
  int C1, hw, npix, in_pitch, per;
  Div by_hw, by_per, by_c1;

  __device__ __forceinline__ UStager(const unsigned char* u_, const Level& L_,
                                     const Plan& p)
      : u(u_), L(L_), C1(L_.CU / 4), hw(p.tw + 2),
        npix((p.th + 2) * (p.tw + 2)), in_pitch(conv_raw_pitch(L_.CU)),
        per(conv_raw_pitch(L_.CU) / 16), by_hw(p.tw + 2),
        by_per(conv_raw_pitch(L_.CU) / 16), by_c1(L_.CU / 4) {}

  __device__ __forceinline__ void copy(unsigned char* dst, const TilePos& tp,
                                       int k, int t, int nt) const {
    const int b = tp.b / L.NT, it = tp.b - b * L.NT;
    const int r0 = it * L.TH - 2 + tp.y0;     // image row of halo row 0
    for (int c = t; c < npix * per; c += nt) {
      const int px = by_per(c), j = c - px * per;
      const int hr = by_hw(px), hc = px - hr * hw;
      const int R = r0 + hr, X = tp.x0 - 1 + hc;
      const int cs = k * 64 + j * 8;          // space-to-depth channel
      const bool ok = R >= 0 && R < L.HO && X >= 0 && X < L.WO && cs < L.CU;
      int64_t e;                              // element offset in u
      if (L.u_s2d) {
        e = (((int64_t)b * L.HO + R) * L.WO + X) * L.CU + cs;
      } else {
        // channel (r*2 + s)*C1 + c of the view is pixel (2R + r, 2X + s)
        const int ph = by_c1(cs), ch = cs - ph * C1;
        e = (((int64_t)b * 2 * L.HO + 2 * R + (ph >> 1)) * (2 * L.WO) +
             2 * X + (ph & 1)) * C1 + ch;
      }
      cp_async_zfill<16>(dst + px * in_pitch + j * 16, ok ? u + e * 2 : u,
                         ok);
    }
  }

  // the raw stage in quantized by s = 127 / amax_u into the s8 halo hq
  __device__ __forceinline__ void quantize(unsigned char* hq,
                                           const unsigned char* in, float s,
                                           int t, int nt) const {
    for (int c = t; c < npix * per; c += nt) {
      const int px = by_per(c), j = c - px * per;
      const uint4 v = *reinterpret_cast<const uint4*>(in + px * in_pitch +
                                                      j * 16);
      *reinterpret_cast<uint2*>(hq + px * kPixBytes + j * 8) =
          make_uint2(quant_bf16x4(v.x, v.y, s), quant_bf16x4(v.z, v.w, s));
    }
  }
};

// Epilogue of one warp of the level conv: x = relu(f32(acc) * (wse * su) +
// bias) for the rows of its m16 tiles that lie among the group's TH + 2 x
// rows (0 where the row is outside the image), f32 pairs into xs (G, TH+2,
// WO, CH); returns the max of what it stored.
template <int MT, int BN>
__device__ __forceinline__ float conv_store(
    const int (&acc)[MT][BN / 8][4], const float* __restrict__ sbe,
    float su, float* __restrict__ xs, const TilePos& tp, const Level& L,
    int tw, int n0, int warp, int lane) {
  const int it = tp.b % L.NT;
  float lmax = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = warp_row<MT>(warp, mt);
    const int r = m / tw, c0 = m - r * tw;
    const int gl = tp.y0 + r;                 // x row of the group
    if (gl >= L.TH + 2) continue;             // the whole m16 tile
    const int R = it * L.TH - 1 + gl;         // x row in the image
    const bool inside = R >= 0 && R < L.HO;
    float* row = xs + ((int64_t)tp.b * (L.TH + 2) + gl) * L.WO * L.CH;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int n = n0 + nt * 8 + (lane & 3) * 2;
      if (n >= L.CH) continue;                // CH is even: both or none
      const float sc0 = __fmul_rn(sbe[n], su), sc1 = __fmul_rn(sbe[n + 1], su);
      const float bi0 = sbe[L.CH + n], bi1 = sbe[L.CH + n + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int x = tp.x0 + c0 + (lane >> 2) + half * 8;
        if (x >= L.WO) continue;
        float v0 = 0.f, v1 = 0.f;
        if (inside) {
          v0 = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][half * 2]),
                                         sc0), bi0), 0.f);
          v1 = fmaxf(__fadd_rn(__fmul_rn(
                         __int2float_rn(acc[mt][nt][half * 2 + 1]), sc1),
                     bi1), 0.f);
        }
        lmax = fmaxf(lmax, fmaxf(v0, v1));
        *reinterpret_cast<float2*>(row + (int64_t)x * L.CH + n) =
            make_float2(v0, v1);
      }
    }
  }
  return lmax;
}

// Kernel 2 (256 threads, two warpgroups that each copy, quantize, multiply
// and store), the shared-memory layout of conv_halo.cuh::conv_smem with one
// s8 halo: [weights: every chunk (resident) or two stages][raw 0][raw 1]
// [s8 halo][epilogue slots]. Stage g + 1 is copied while stage g is
// quantized and multiplied.
template <int MT, int BN>
__global__ void __launch_bounds__(kThreads, kMinBlocks<BN>)
level_conv_kernel(const unsigned char* __restrict__ u,     // bf16 NHWC
                  const unsigned char* __restrict__ w,     // (CH, 9*CUP) s8
                  const float* __restrict__ sbe,           // (2, CH)
                  const float* __restrict__ partials,      // (G, P)
                  int P, float* __restrict__ amax_u,       // (G,)
                  float* __restrict__ amax_x,              // (G,), zeroed
                  float* __restrict__ xs,                  // (G, TH+2, WO, CH)
                  Level L, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int CUP = (L.CU + 63) / 64 * 64, chunks = CUP / 64;
  const UStager st(u, L, p);
  const int halo_bytes = st.npix * kPixBytes;
  const int in_bytes = st.npix * st.in_pitch;
  constexpr int wchunk = BN * kWRowBytes;
  const int n0 = blockIdx.y * BN;
  unsigned char* in_ring = smem + (p.resident ? chunks : 2) * wchunk;
  unsigned char* halo_q = in_ring + 2 * in_bytes;

  const int G = my_tiles(p) * chunks;
  if (G == 0) return;
  auto tile_of = [&](int g) {
    return tile_pos(p, blockIdx.x + (g / chunks) * gridDim.x);
  };
  auto issue = [&](int g) {
    if (!(LEVEL_SKIP & 8))
      st.copy(in_ring + (g & 1) * in_bytes, tile_of(g), g % chunks, tid,
              kThreads);
    if (!p.resident && !(LEVEL_SKIP & 16))
      load_weights<BN, 1>(smem + (g & 1) * wchunk, w, n0, L.CH, CUP,
                          g % chunks);
  };

  // channels past the raw stage's (CU < 64) stay zero: the K padding
  for (int c = tid; c < halo_bytes / 16; c += kThreads)
    reinterpret_cast<uint4*>(halo_q)[c] = make_uint4(0u, 0u, 0u, 0u);
  if (p.resident)
    for (int k = 0; k < chunks; ++k)
      load_weights<BN, 1>(smem + k * wchunk, w, n0, L.CH, CUP, k);
  issue(0);
  cp_async_commit();

  const Frag<MT> f(p.tw, warp, lane);
  int acc[MT][BN / 8][4];
  float s_q = 0.f, su = 0.f;

  for (int g = 0; g < G; ++g) {
    const int k = g % chunks;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();          // stage g landed; stage g+1's buffers are free
    if (g + 1 < G) issue(g + 1);
    cp_async_commit();
    if (k == 0) {
      zero(acc);
      const int grp = tile_of(g).b;
      const float am = group_amax_u(partials, P, grp);
      const float fl = fmaxf(am, kAmaxFloor);
      s_q = __fdiv_rn(127.f, fl);
      su = __fdiv_rn(fl, 127.f);
      if (tid == 0) amax_u[grp] = am;
    }
    const unsigned char* wts = smem + (p.resident ? k : g & 1) * wchunk;
    if (!(LEVEL_SKIP & 8))
      st.quantize(halo_q, in_ring + (g & 1) * in_bytes, s_q, tid, kThreads);
    __syncthreads();          // the s8 halo is ready
    mma_chunk<MT, BN>(acc, halo_q, wts, f);
    if (k == chunks - 1 && !(LEVEL_SKIP & 32)) {
      const TilePos tp = tile_of(g);
      const float m = warp_max(
          conv_store<MT, BN>(acc, sbe, su, xs, tp, L, p.tw, n0, warp, lane));
      if (lane == 0) atomic_max_nonneg(amax_x + tp.b, m);
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Kernel 3: the gate conv and the LSTM pointwise, on the cell kernel's
// machinery (conv_halo.cuh: the 64-byte-swizzled halo read by load_a_sw,
// the mbarriers and the turn barriers). A pixel tile is a 128-pixel patch
// (8 x 16 or 4 x 32) of one group's TH output rows; an item is a pixel
// tile with all its N tiles of 128 gate columns, dealt round-robin to one
// persistent block an SM. chunks_x chunks of x then chunks_x of h, 64
// channels each (zeros past CH), every one's s8 halo resident for the
// item. Stage g of a block is (item, N tile, chunk) with NH = 2, or (item,
// N tile, chunk, half) with NH = 1 where a whole chunk's weights do not fit
// beside the halos (the third DSEC level): NH halves of [9 taps][2 k
// groups][128 columns][16 B] of the level's weight image
// (ops/level.py::prepare_level_weights), one bulk copy. Shared memory:
// [align][weights x 2][halo x chunks][epilogue slots][barriers]
// (level_cell_smem).

constexpr int kLvMT = 1;
constexpr int kLvWStage = 9 * 2 * kCellBN * 16;   // 36,864: a half chunk

// nh: weight halves a stage, 2 (a whole chunk) where they fit beside every
// chunk's halo, else 1
__host__ inline int level_cell_smem(int th, int tw, int chunks, int nh) {
  return kCellAlign + kCellStages * nh * kLvWStage +
         chunks * cell_halo_pad(th, tw) + kCellConsumerWarps * kCellSlot +
         kCellBarriers;
}
constexpr int kLvProducerRegs = 72, kLvConsumerRegs = 216;
static_assert(kProducers * kLvProducerRegs + kThreads * kLvConsumerRegs ==
                  kCellThreads * 168,
              "setmaxnreg must hand over exactly the launch's registers");

// The gate kernel's plan.
struct LevelCellPlan {
  Plan t;            // patch and pixel tiles (tile_pos's b: the group)
  int n_tiles_n;     // N tiles of 128 gate columns
  int chunks_x;      // chunks of x, then as many of h
  int chunks;
  int halo_pad;      // one chunk's halo padded to kCellAlign
};

// clip(round_half_even(v * s), -127, 127) as the low byte of the result:
// the clip first (the same integers), then one add of 1.5 * 2^23 leaves the
// integer in the low mantissa bits (conv_halo.cuh::quant_bf16x4)
__device__ __forceinline__ unsigned q8(float v, float s) {
  return __float_as_uint(__fadd_rn(
      fminf(fmaxf(__fmul_rn(v, s), -127.f), 127.f), 12582912.f));
}

// four values as 4 s8 bytes, the first in the lowest
__device__ __forceinline__ unsigned pack4(float a, float b, float c, float d,
                                          float s) {
  return __byte_perm(__byte_perm(q8(a, s), q8(b, s), 0x0040),
                     __byte_perm(q8(c, s), q8(d, s), 0x0040), 0x5410);
}

__device__ __forceinline__ float bf_lo(unsigned v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

// 16 bf16 values (two 16-byte loads) quantized by s as 16 s8 bytes
__device__ __forceinline__ uint4 quant_bf16x16(const uint4& a, const uint4& b,
                                               float s) {
  return make_uint4(pack4(bf_lo(a.x), bf_hi(a.x), bf_lo(a.y), bf_hi(a.y), s),
                    pack4(bf_lo(a.z), bf_hi(a.z), bf_lo(a.w), bf_hi(a.w), s),
                    pack4(bf_lo(b.x), bf_hi(b.x), bf_lo(b.y), bf_hi(b.y), s),
                    pack4(bf_lo(b.z), bf_hi(b.z), bf_lo(b.w), bf_hi(b.w), s));
}

// The producer warpgroup's share of one stage's s8 halo: chunk k of pixel
// tile tp (th x tw output pixels), one work unit a 16-channel piece j of a
// halo pixel px, loaded from x (f32, group layout, rows past the group's
// TH + 2 zero) or h (bf16, image layout, rows past the image zero),
// quantized by s and stored at the 64-byte swizzle's place of the piece,
// j ^ ((px >> 1) & 3) (load_a_sw reads it there). Two units in flight a
// thread.
template <bool FROM_X>
__device__ __forceinline__ void stage_halo(
    unsigned char* halo, const float* __restrict__ xs,
    const __nv_bfloat16* __restrict__ h, const TilePos& tp, const Level& L,
    int th, int tw, int c0, float s, int t) {
  const int hw = tw + 2, units = (th + 2) * hw * 4;
  const int b = tp.b / L.NT, it = tp.b - b * L.NT;
  const Div by_hw(hw);
  for (int u0 = t; u0 < units; u0 += 2 * kProducers) {
    uint4 raw[2][FROM_X ? 4 : 2];
    int px[2], j[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int unit = u0 + e * kProducers;
      px[e] = unit >> 2;
      j[e] = unit & 3;
      const int hr = by_hw(px[e]), hc = px[e] - hr * hw;
      const int X = tp.x0 - 1 + hc, ch = c0 + j[e] * 16;
      bool ok = unit < units && X >= 0 && X < L.WO && ch < L.CH;
      const uint4* src;
      if constexpr (FROM_X) {
        const int gr = tp.y0 + hr;            // x row of the group
        ok = ok && gr < L.TH + 2;
        src = reinterpret_cast<const uint4*>(
            xs + (((int64_t)tp.b * (L.TH + 2) + gr) * L.WO + X) * L.CH + ch);
      } else {
        const int R = it * L.TH + tp.y0 - 1 + hr;
        ok = ok && R >= 0 && R < L.HO;
        src = reinterpret_cast<const uint4*>(
            h + (((int64_t)b * L.HO + R) * L.WO + X) * L.CH + ch);
      }
#pragma unroll
      for (int i = 0; i < (FROM_X ? 4 : 2); ++i)
        raw[e][i] = ok ? src[i] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (u0 + e * kProducers >= units) continue;
      uint4 q;
      if constexpr (FROM_X) {
        const uint4* r = raw[e];
        auto f = [](unsigned v) { return __uint_as_float(v); };
        q = make_uint4(
            pack4(f(r[0].x), f(r[0].y), f(r[0].z), f(r[0].w), s),
            pack4(f(r[1].x), f(r[1].y), f(r[1].z), f(r[1].w), s),
            pack4(f(r[2].x), f(r[2].y), f(r[2].z), f(r[2].w), s),
            pack4(f(r[3].x), f(r[3].y), f(r[3].z), f(r[3].w), s));
      } else {
        q = quant_bf16x16(raw[e][0], raw[e][1], s);
      }
      *reinterpret_cast<uint4*>(halo + (px[e] << 6) +
                                (((j[e] ^ (px[e] >> 1)) & 3) << 4)) = q;
    }
  }
}

// acc += one stage: NH half chunks from half h0 on, each the 9 k-steps
// (one a tap) of 16-byte pieces 2h and 2h + 1 of the halo's 64-byte pixels
// against [tap][2 k groups] of the stage's half, in groups of 3 steps, one
// group in flight while the next group's fragments load (cell_chunk's
// loop). Once the last group is issued, `pass` hands the tensor cores to
// the other warpgroup.
template <int NH, typename Acc>
__device__ __forceinline__ void stage_mma(Acc (&acc)[kLvMT][kCellBN / 8][4],
                                          uint32_t halo, uint32_t wts,
                                          const SwFrag<kLvMT>& f, int lane,
                                          int h0, bool pass, int wg) {
  constexpr int KB = 3, NB = 9 * NH / KB;
  // k-step q: half h0 + q / 9, tap q % 9
  auto step = [&](int q) { return 2 * (q % 9) + h0 + q / 9; };
  unsigned a[2][KB][kLvMT][4];
#pragma unroll
  for (int j = 0; j < KB; ++j) load_a_sw(a[0][j], halo, f, step(j), lane);
  fence_acc(acc);
#pragma unroll
  for (int bt = 0; bt < NB; ++bt) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int q = bt * KB + j;
      const uint64_t desc = make_desc(
          wts + (q / 9) * kLvWStage + (q % 9) * 2 * kCellBN * 16,
          kCellBN * 16, 128);
#pragma unroll
      for (int mt = 0; mt < kLvMT; ++mt)
        WgmmaS8<kCellBN>::mma(acc[mt], a[bt & 1][j][mt], desc);
    }
    wgmma_commit();
    if (bt + 1 < NB) {
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < KB; ++j)
        load_a_sw(a[(bt + 1) & 1][j], halo, f, step((bt + 1) * KB + j), lane);
    }
  }
  if (pass) turn_pass(wg);
  wgmma_wait<0>();
  fence_acc(acc);
}

// c of this warp's rows of a pixel tile (16 pixels x 32 channels, two
// 16-byte pieces a lane), loaded before the tile's last chunk; rows past the
// group's TH and columns past WO are not read.
__device__ __forceinline__ void level_load_c(
    uint4 (&cr)[kLvMT][2], const __nv_bfloat16* __restrict__ c,
    const TilePos& tp, const Level& L, int tw, int nt, int warp, int lane) {
  const int ch0 = nt * (kCellBN / 4);
  const int b = tp.b / L.NT, it = tp.b - b * L.NT;
#pragma unroll
  for (int mt = 0; mt < kLvMT; ++mt) {
    const int m = warp_row<kLvMT>(warp, mt);
    const int r = m / tw, c0 = m - r * tw;
    const int ly = tp.y0 + r, xs = tp.x0 + c0;
    if (ly >= L.TH) continue;
    const int64_t row0 = ((int64_t)b * L.HO + it * L.TH + ly) * L.WO;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = lane + 32 * i, px = q >> 2, part = (q & 3) * 8;
      if (xs + px < L.WO)
        cr[mt][i] = *reinterpret_cast<const uint4*>(
            c + (row0 + xs + px) * L.CH + ch0 + part);
    }
  }
}

// The LSTM epilogue of one consumer warp for one pixel tile: gates =
// f32(acc_x) * (wsx * sx) + f32(acc_h) * (wsh / 127) + bias, each f32
// operation rounded on its own in the plain version's order, then c' =
// sigmoid(f) * c + sigmoid(i) * tanh(g), h' = sigmoid(o) * tanh(c'). c (cr)
// is read and c' written back in place, h' to h_out, through the warp's
// slot ([16 pixels][40] bf16 for c/c', the same for h'), as cell_store.
__device__ __forceinline__ void level_store(
    const int (&ax)[kLvMT][kCellBN / 8][4],
    const int (&ah)[kLvMT][kCellBN / 8][4], const uint4 (&cr)[kLvMT][2],
    const float* __restrict__ sbg, float sxg, __nv_bfloat16* __restrict__ c,
    __nv_bfloat16* __restrict__ h_out, unsigned char* slot, const TilePos& tp,
    const Level& L, int tw, int nt, int warp, int lane) {
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(slot);
  __nv_bfloat16* sh = sc + 16 * 40;
  const int ch0 = nt * (kCellBN / 4), CH = L.CH;
  const int b = tp.b / L.NT, it = tp.b - b * L.NT;
#pragma unroll
  for (int mt = 0; mt < kLvMT; ++mt) {
    const int m = warp_row<kLvMT>(warp, mt);
    const int r = m / tw, c0 = m - r * tw;
    const int ly = tp.y0 + r, xs = tp.x0 + c0;
    if (ly >= L.TH) continue;                   // the whole m16 tile
    const int64_t row0 = ((int64_t)b * L.HO + it * L.TH + ly) * L.WO;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = lane + 32 * i, px = q >> 2, part = (q & 3) * 8;
      *reinterpret_cast<uint4*>(sc + px * 40 + part) = cr[mt][i];
    }
    __syncwarp();
#pragma unroll
    for (int g4 = 0; g4 < 4; ++g4) {            // 8-channel group
      const int col = g4 * 8 + (lane & 3) * 2;
      float wx[4][2], wh[4][2], bi[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = g * CH + ch0 + col + j;
          wx[g][j] = __fmul_rn(sbg[n], sxg);
          wh[g][j] = sbg[4 * CH + n];
          bi[g][j] = sbg[8 * CH + n];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = (lane >> 2) + half * 8;
        const __nv_bfloat162 cp2 =
            *reinterpret_cast<const __nv_bfloat162*>(sc + px * 40 + col);
        const float cp[2] = {__bfloat162float(cp2.x), __bfloat162float(cp2.y)};
        float hn[2], cn[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int rr = half * 2 + j;
          float gt[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gt[g] = __fadd_rn(
                __fadd_rn(
                    __fmul_rn(__int2float_rn(ax[mt][g4 * 4 + g][rr]),
                              wx[g][j]),
                    __fmul_rn(__int2float_rn(ah[mt][g4 * 4 + g][rr]),
                              wh[g][j])),
                bi[g][j]);
          cn[j] = __fadd_rn(__fmul_rn(sigmoidf_(gt[1]), cp[j]),
                            __fmul_rn(sigmoidf_(gt[0]), tanhf(gt[3])));
          hn[j] = __fmul_rn(sigmoidf_(gt[2]), tanhf(cn[j]));
        }
        *reinterpret_cast<__nv_bfloat162*>(sc + px * 40 + col) =
            __floats2bfloat162_rn(cn[0], cn[1]);
        *reinterpret_cast<__nv_bfloat162*>(sh + px * 40 + col) =
            __floats2bfloat162_rn(hn[0], hn[1]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = lane + 32 * i, px = q >> 2, part = (q & 3) * 8;
      if (xs + px < L.WO) {
        const int64_t off = (row0 + xs + px) * CH + ch0 + part;
        *reinterpret_cast<uint4*>(c + off) =
            *reinterpret_cast<const uint4*>(sc + px * 40 + part);
        *reinterpret_cast<uint4*>(h_out + off) =
            *reinterpret_cast<const uint4*>(sh + px * 40 + part);
      }
    }
    __syncwarp();
  }
}

// Kernel 3. xs: kernel 2's x (G, TH+2, WO, CH) f32; h: bf16 NHWC;
// w_img: the gate weight image [N tile][chunk][half][9 taps][2][128][16 B]
// (x chunks, then h chunks); sbg: (3, 4*CH) f32 wsx, wsh / 127, bias in i,
// f, o, g order; amax_x: kernel 2's (G,); c: bf16 NHWC, updated in place;
// h_out: bf16 NHWC.
template <int NH>
__global__ void __launch_bounds__(kCellThreads, 1)
level_cell_kernel(const float* __restrict__ xs,
                  const __nv_bfloat16* __restrict__ h,
                  const unsigned char* __restrict__ w_img,
                  const float* __restrict__ sbg,
                  const float* __restrict__ amax_x,
                  __nv_bfloat16* __restrict__ c,
                  __nv_bfloat16* __restrict__ h_out, Level L,
                  LevelCellPlan p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kCellAlign - 1) & ~(uint32_t)(kCellAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int S = kCellStages;
  constexpr int WSTAGE = NH * kLvWStage, SPLIT = 2 / NH;
  const uint32_t halos = base + S * WSTAGE;
  const uint32_t bars = halos + p.chunks * p.halo_pad +
                        kCellConsumerWarps * kCellSlot;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  // items (pixel tiles) dealt round-robin to the persistent blocks; stage
  // g of a block is (item, N tile, chunk[, half])
  const int bid = blockIdx.x, nb = gridDim.x;
  const int mine = bid < p.t.n_tiles
                       ? (p.t.n_tiles - bid + nb - 1) / nb : 0;
  const int per_item = p.n_tiles_n * p.chunks * SPLIT;
  const int G = mine * per_item;            // stages this block consumes

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // every producer thread arrives once a stage, and the one that
      // issues the weight copy once more with its transaction bytes
      mbar_init(full(s), kProducers + 1);
      mbar_init(empty(s), kCellConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kCellConsumerWarps) {
    // producer warpgroup: every thread stages halo pieces at an item's
    // first N tile, one also issues every weight copy
    setmaxnreg_dec<kLvProducerRegs>();
    const int t = threadIdx.x - kThreads;
    for (int g = 0; g < G; ++g) {
      const int s = g % S;
      mbar_wait(empty(s), ((g / S) & 1) ^ 1);
      const int i = g / per_item, r = g - i * per_item;
      const int nt = r / (SPLIT * p.chunks), k = (r / SPLIT) % p.chunks;
      const int hf = r % SPLIT;
      if (t == 0) {
        if (LEVEL_SKIP & 2) {
          mbar_arrive(full(s));
        } else {
          mbar_expect_tx(full(s), WSTAGE);
          bulk_load(base + s * WSTAGE,
                    w_img + (((int64_t)nt * p.chunks + k) * 2 + hf) *
                                kLvWStage,
                    WSTAGE, full(s));
        }
      }
      // chunk k's halo: written once an item, at its first N tile; its
      // last reader (the item before's last N tile, at least two stages
      // back) has released it, as every stage up to g - 2 has
      if (nt == 0 && hf == 0 && !(LEVEL_SKIP & 1)) {
        const TilePos tp = tile_pos(p.t, bid + i * nb);
        unsigned char* halo = smem + S * WSTAGE + k * p.halo_pad;
        if (k < p.chunks_x)
          stage_halo<true>(halo, xs, h, tp, L, p.t.th, p.t.tw, k * 64,
                           __fdiv_rn(127.f,
                                     fmaxf(amax_x[tp.b], kAmaxFloor)), t);
        else
          stage_halo<false>(halo, xs, h, tp, L, p.t.th, p.t.tw,
                            (k - p.chunks_x) * 64, 127.f, t);
      }
      mbar_arrive(full(s));
    }
  } else {
    setmaxnreg_inc<kLvConsumerRegs>();
    // the two warpgroups take turns on the tensor cores, half chunk by half
    // chunk, warpgroup 0 first, as in the cell kernel
    const int wg = warp >> 2;
    if (wg == 1 && G > 0) turn_pass(wg);
    const SwFrag<kLvMT> f(p.t.tw, warp, lane);
    unsigned char* slot =
        smem + S * WSTAGE + p.chunks * p.halo_pad + warp * kCellSlot;
    int ax[kLvMT][kCellBN / 8][4], ah[kLvMT][kCellBN / 8][4];
    uint4 cr[kLvMT][2];
    for (int g = 0; g < G; ++g) {
      const int s = g % S;
      const int i = g / per_item, r = g - i * per_item;
      const int nt = r / (SPLIT * p.chunks), k = (r / SPLIT) % p.chunks;
      const int hf = r % SPLIT;
      const bool last = k == p.chunks - 1 && hf == SPLIT - 1;
      const TilePos tp = tile_pos(p.t, bid + i * nb);
      if (last && !(LEVEL_SKIP & 4))
        level_load_c(cr, c, tp, L, p.t.tw, nt, warp, lane);
      mbar_wait(full(s), (g / S) & 1);
      if (k == 0 && hf == 0) {
        zero(ax);
        zero(ah);
      }
      turn_wait(wg);
      // warpgroup 1's last stage hands over to no one: every wait on a
      // turn is matched by one pass
      const bool pass = wg == 0 || g + 1 < G;
      const uint32_t halo = halos + k * p.halo_pad;
      const uint32_t wts = base + s * WSTAGE;
      if (k < p.chunks_x)
        stage_mma<NH>(ax, halo, wts, f, lane, hf, pass, wg);
      else
        stage_mma<NH>(ah, halo, wts, f, lane, hf, pass, wg);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      if (last && !(LEVEL_SKIP & 4))
        level_store(ax, ah, cr, sbg,
                    __fdiv_rn(fmaxf(amax_x[tp.b], kAmaxFloor), 127.f), c,
                    h_out, slot, tp, L, p.t.tw, nt, warp, lane);
    }
  }
}

// The conv's plan from the launch's arguments; false where it disagrees
// with the layout of level_conv_kernel<MT, BN>.
template <int MT, int BN>
bool conv_plan(Plan& p, const Level& L, int th, int tw, int resident,
               int grid_x, int smem) {
  const int chunks = (L.CU + 63) / 64;
  if (th <= 0 || tw <= 0 || th * tw != Cfg<MT, BN>::BM || tw % 16 ||
      smem != conv_smem(true, th, tw, BN, chunks, resident, L.CU, 1))
    return false;
  p.th = th;
  p.tw = tw;
  p.tiles_y = (L.TH + 2 + th - 1) / th;      // over the group's x rows
  p.tiles_x = (L.WO + tw - 1) / tw;
  p.n_tiles = L.B * L.NT * p.tiles_y * p.tiles_x;
  p.resident = resident;
  p.q_stages = 1;
  return grid_x >= 1 && grid_x <= p.n_tiles;
}

template <int MT, int BN>
int launch_conv(const Plan& p, const void* u, const void* we,
                const void* sbe, const float* partials, int P, float* amax_u,
                float* amax_x, void* xs, const Level& L, int grid_x,
                int smem, cudaStream_t stream) {
  auto kern = level_conv_kernel<MT, BN>;
  int err = prepare_launch(kern, smem);
  if (err) return err;
  dim3 grid(grid_x, (L.CH + BN - 1) / BN);
  kern<<<grid, kThreads, smem, stream>>>(
      (const unsigned char*)u, (const unsigned char*)we, (const float*)sbe,
      partials, P, amax_u, amax_x, (float*)xs, L, p);
  return (int)cudaGetLastError();
}

// The gate kernel's plan from the launch's arguments; false where it
// disagrees with level_cell_kernel's layout.
bool cell_plan(LevelCellPlan& p, const Level& L, int th, int tw, int nh,
               int grid, int smem) {
  const int chunks = 2 * ((L.CH + 63) / 64);
  if (th <= 0 || tw <= 0 || th * tw != 2 * kLvMT * 64 || tw % 16 ||
      tw + 2 > 256 || (nh != 1 && nh != 2) ||
      smem != level_cell_smem(th, tw, chunks, nh) || smem > kMaxSmem)
    return false;
  p.t.th = th;
  p.t.tw = tw;
  p.t.tiles_y = (L.TH + th - 1) / th;        // over the group's rows
  p.t.tiles_x = (L.WO + tw - 1) / tw;
  p.t.n_tiles = L.B * L.NT * p.t.tiles_y * p.t.tiles_x;
  p.t.resident = 0;
  p.t.q_stages = 0;
  p.n_tiles_n = 4 * L.CH / kCellBN;
  p.chunks_x = chunks / 2;
  p.chunks = chunks;
  p.halo_pad = cell_halo_pad(th, tw);
  return grid >= 1 && grid <= p.t.n_tiles;
}

}  // namespace

// u: bf16 NHWC, (B, HO, WO, CU) if u_s2d else (B, 2*HO, 2*WO, CU/4); h, c:
// bf16 (B, HO, WO, CH); we: s8 (CH, 9*CUP), CUP = CU rounded up to 64
// (zeros past CU); w_img: s8 gate weight image (4*CH/128, 2*CHP/64, 36,
// 128, 16), CHP = CH rounded up to 64; sbe (2, CH), sbg (3, 4*CH): f32.
// scratch: f32 (2 + P) * G with G = B * HO / TH groups: amax_u, amax_x (as
// found, before the 1e-6 floor), then the (G, P) partials of kernel 1; xs:
// f32 (G, TH+2, WO, CH). h_out: bf16 (B, HO, WO, CH); c is updated in
// place. CH a multiple of 32, CU of 16 (32 for a full-resolution u), TH
// divides HO. All 16-byte aligned. The plan (P; the conv's patch,
// residency, grid and shared memory; the gate kernel's patch, weight
// halves a stage, grid and shared memory) is
// ops/conv_halo.py::level_plan's; the layout is recomputed here and a plan
// that disagrees is refused. Three launches.
extern "C" int ess_level_int8(const void* u, const void* h, void* c,
                              const void* we, const void* w_img,
                              const void* sbe, const void* sbg, void* scratch,
                              void* xs, void* h_out, int B, int HO, int WO,
                              int CU, int CH, int TH, int u_s2d, int P,
                              int c_th, int c_tw, int c_resident,
                              int c_grid_x, int c_smem, int g_th, int g_tw,
                              int g_nh, int g_grid, int g_smem,
                              void* stream_) {
  if (B <= 0 || HO <= 0 || WO <= 0) return 0;
  if (TH <= 0 || HO % TH != 0 || CH <= 0 || CH % 32 != 0 || CU <= 0 ||
      CU % (u_s2d ? 16 : 32) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const Level L{B, HO, WO, CU, CH, TH, HO / TH, u_s2d};
  const int G = B * L.NT;
  const int64_t row_elems = (int64_t)WO * CU;
  const int64_t want =
      ((int64_t)(TH + 4) * row_elems / 8 + kAmaxThreads - 1) / kAmaxThreads;
  if (G > 65535 || P != (int)(want < kMaxAmaxBlocks ? want : kMaxAmaxBlocks))
    return (int)cudaErrorInvalidValue;
  float* amax_u = (float*)scratch;
  float* amax_x = amax_u + G;
  float* partials = amax_x + G;
  // every plan checked before anything is launched
  Plan cp;
  LevelCellPlan gp;
  const bool conv_ok =
      CH > 64 ? conv_plan<1, 128>(cp, L, c_th, c_tw, c_resident, c_grid_x,
                                  c_smem)
      : CH > 32 ? conv_plan<2, 64>(cp, L, c_th, c_tw, c_resident, c_grid_x,
                                   c_smem)
                : conv_plan<2, 32>(cp, L, c_th, c_tw, c_resident, c_grid_x,
                                   c_smem);
  if (!conv_ok || !cell_plan(gp, L, g_th, g_tw, g_nh, g_grid, g_smem))
    return (int)cudaErrorInvalidValue;

  amax_u_kernel<<<dim3(P, G), kAmaxThreads, 0, stream>>>(
      (const __nv_bfloat16*)u, row_elems, HO, TH, L.NT, partials, amax_x);
  int err = (int)cudaGetLastError();
  if (err) return err;

  if (CH > 64)
    err = launch_conv<1, 128>(cp, u, we, sbe, partials, P, amax_u, amax_x,
                              xs, L, c_grid_x, c_smem, stream);
  else if (CH > 32)
    err = launch_conv<2, 64>(cp, u, we, sbe, partials, P, amax_u, amax_x,
                             xs, L, c_grid_x, c_smem, stream);
  else
    err = launch_conv<2, 32>(cp, u, we, sbe, partials, P, amax_u, amax_x,
                             xs, L, c_grid_x, c_smem, stream);
  if (err) return err;

  auto kern = g_nh == 2 ? level_cell_kernel<2> : level_cell_kernel<1>;
  err = prepare_launch(kern, g_smem);
  if (err) return err;
  kern<<<g_grid, kCellThreads, g_smem, stream>>>(
      (const float*)xs, (const __nv_bfloat16*)h, (const unsigned char*)w_img,
      (const float*)sbg, amax_x, (__nv_bfloat16*)c, (__nv_bfloat16*)h_out, L,
      gp);
  return (int)cudaGetLastError();
}
