// Halo-tile implicit-GEMM 3x3 SAME conv core for Hopper, shared by the
// fused 3x3 conv over NHWC in its exact (B4, conv3x3.cu) and int8 (B4-int8,
// conv3x3_int8.cu) instantiations, the C-major head conv T1 (head_cmajor.cu,
// NCHW input with the normalize fused) and the ConvLSTM cell kernels B2 and
// B2-int8 (conv_lstm.cu, conv_lstm_int8.cu; their kernel, with a producer
// warpgroup, TMA halos and streamed weight stages, is the last section of
// this file).
//
// Output tile: a block of two warpgroups owns TH x TW output pixels of one
// image (8 x 16 when the block is 128 channels wide, 8 x 32 or 16 x 16 when
// it is 64 or 32 wide) and BN output channels (all of C_out up to 128;
// blockIdx.y picks the N tile beyond). Blocks are persistent: block (bx, nt)
// walks the pixel tiles bx, bx + gridDim.x, ... of its N tile, so its
// weights are loaded once (resident) where they fit, and the next tile's
// loads overlap this tile's products and epilogue.
//
// Halo tile: the (TH+2) x (TW+2) input pixels around the patch, one channel
// chunk of 64 bytes a pixel at a time (kKC = 32 bf16 channels, or 64 s8),
// are staged into shared memory pixel-major ([pixel][channel], kPixBytes = 80
// bytes a pixel: an odd multiple of 16, so the 8 row addresses of an
// ldmatrix fall on 8 distinct 16-byte bank groups). Every input value is
// loaded from device memory once per halo, not once per tap; zeros outside
// the image are the conv's padding, zeros past C_in the K padding (their
// weight columns are zero). The loaders are the callers': cp.async straight
// from NHWC (B4), the same copies of the chunk's bf16 pixels into a raw
// stage and one quantizing pass into the s8 halo tile (B4-int8), or aligned
// cp.async of C-major rows and one normalize pass (T1).
//
// Taps: every tap's A fragment is an ldmatrix from the halo tile shifted by
// (dy, dx) pixels: one uniform offset added to per-lane row addresses
// computed once.
//
// MMA: wgmma in its register-A form, m64 x BN x k16 (bf16, f32
// accumulators) or m64 x BN x k32 (s8, s32 accumulators) per instruction:
// 32 bytes of K either way. Each warpgroup owns MT m64 row tiles of the
// block and all BN columns; each warp loads the A fragment of its 16 rows
// with ldmatrix (the register form shares the m16n8k16 fragment layout, and
// the s8 m16n8k32 fragment is byte for byte the same), and the tensor cores
// read B from shared memory in the no-swizzle K-major layout of 8 x 16-byte
// core matrices, [k group of 16 bytes][n][16 bytes]: the descriptor's
// core-matrix strides are BN * 16 bytes along K and 128 bytes along N. The
// register form keeps the shifted-row addressing of the taps (a
// shared-memory A operand would need a canonical copy per tap). The 18
// k-steps of a chunk are issued in batches, the next batch's fragments
// loaded while one batch of wgmma groups is in flight.
//
// Epilogue: bias (int8: float(acc) * ws first, each f32 operation rounded
// on its own), optional ReLU, one rounding to bf16; each warp stages its 16
// rows 32 columns at a time in its own shared-memory slot (no block
// barrier) and writes 16-byte chunks: NHWC rows of 64 bytes, or NCHW runs
// of 16 pixels along W.
//
// The tile plan (TH, TW, grid, residency, shared-memory bytes) is computed
// in Python (ess_tpu_torch/ops/conv_halo.py) and passed in; the launchers
// recompute the shared-memory layout and refuse a plan that disagrees.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"
#include "tma.cuh"

namespace ess {
namespace halo {

constexpr int kThreads = 256;                  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;                        // input channels per chunk
constexpr int kPixBytes = kKC * 2 + 16;        // 80: one staged halo pixel
constexpr int kWRowBytes = 9 * kKC * 2;        // 576: one output channel
constexpr int kStageNhwc = 16 * (32 + 8) * 2;  // epilogue slot per warp
constexpr int kStageNchw = 32 * (16 + 8) * 2;
constexpr int kMaxSmem = 232448;               // per block on the H100

// The tile plan, as ops/conv_halo.py computes it.
struct Plan {
  int th, tw;               // output patch
  int tiles_y, tiles_x;     // patches per image
  int n_tiles;              // B * tiles_y * tiles_x
  int resident;             // every weight chunk of the N tile held at once
  int q_stages;             // B4-int8: s8 halo tiles (1 or 2)
};

// MT m64 row tiles per warpgroup, BN output channels: BM = 2 * MT * 64
template <int MT, int BN>
struct Cfg {
  static constexpr int BM = 2 * MT * 64;
};

// Blocks of 128 columns run two per SM (at most 128 registers a thread);
// narrower ones run one per SM (encoder 0's resident weights take 147 KB)
// and may use 255, which buys k-step batches of 3 fragment sets (below).
template <int BN>
constexpr int kMinBlocks = BN == 128 ? 2 : 1;
template <int BN>
constexpr int kBatch = BN == 128 ? 1 : 3;

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

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int MT, int NT>
__device__ __forceinline__ void fence_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+f"(acc[i][j][r])::"memory");
}

template <int MT, int NT>
__device__ __forceinline__ void fence_acc(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+r"(acc[i][j][r])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// offset between core matrices along K (lbo) and along N (sbo).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int lbo,
                                              int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (m64 x N f32: this thread's N/2 values, as n8 tiles in the m16n8
// accumulator layout) += a (this warp's 16 rows x k16, registers) * B
// (k16 x N at desc)
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[4][4],
                                              const unsigned (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[8][4],
                                              const unsigned (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[16][4],
                                              const unsigned (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// The same with s8 operands and s32 accumulators: a (16 rows x k32 s8, the
// m16n8k32 fragment, byte for byte the bf16 m16n8k16 one), B k32 x N s8
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<32> {
  __device__ static __forceinline__ void mma(int (&d)[4][4],
                                              const unsigned (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15 "
        "}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<64> {
  __device__ static __forceinline__ void mma(int (&d)[8][4],
                                              const unsigned (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31 "
        "}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ static __forceinline__ void mma(int (&d)[16][4],
                                              const unsigned (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63 "
        "}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
          "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
          "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
          "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
          "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
          "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
          "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
          "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
          "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// The product of an accumulator type: bf16 operands into f32, s8 into s32
template <typename Acc, int N>
using WgmmaOf = std::conditional_t<std::is_same_v<Acc, int>, WgmmaS8<N>,
                                   Wgmma<N>>;

struct TilePos {
  int b, y0, x0;
};

__device__ __forceinline__ TilePos tile_pos(const Plan& p, int t) {
  const int tx = t % p.tiles_x;
  const int r = t / p.tiles_x;
  const int ty = r % p.tiles_y;
  return {r / p.tiles_y, ty * p.th, tx * p.tw};
}

// Pixel tiles this block walks: blockIdx.x, blockIdx.x + gridDim.x, ...
__device__ __forceinline__ int my_tiles(const Plan& p) {
  const int bx = blockIdx.x, gx = gridDim.x;
  return bx < p.n_tiles ? (p.n_tiles - bx + gx - 1) / gx : 0;
}

// First output row of this warp's m16 row tile mt: warp w of warpgroup g
// holds rows 16 * w of each of the group's m64 tiles.
template <int MT>
__device__ __forceinline__ int warp_row(int warp, int mt) {
  return ((warp >> 2) * MT + mt) * 64 + (warp & 3) * 16;
}

// Per-lane A fragment addresses, computed once: byte offset, for tap (0, 0),
// of this lane's ldmatrix row (pixel (lane & 15) of each of its m16 row
// tiles, channel half lane >> 4) in the halo tile. An m16 tile lies in one
// patch row (TW is a multiple of 16).
template <int MT>
struct Frag {
  int a_off[MT];
  int row_bytes;            // one halo row: (TW + 2) pixels

  __device__ __forceinline__ Frag(int tw, int warp, int lane) {
    row_bytes = (tw + 2) * kPixBytes;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = warp_row<MT>(warp, mt);
      const int r = m / tw, c0 = m - r * tw;
      a_off[mt] = r * row_bytes + (c0 + (lane & 15)) * kPixBytes +
                  (lane >> 4) * 16;
    }
  }
};

template <int MT, int NT, typename Acc>
__device__ __forceinline__ void zero(Acc (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = Acc(0);
}

// The A fragments of k-step s (tap s / 2, channel half s % 2) of a chunk.
template <int MT>
__device__ __forceinline__ void load_a(unsigned (&a)[MT][4],
                                       const unsigned char* halo,
                                       const Frag<MT>& f, int s) {
  const int tap = s >> 1, dy = tap / 3, dx = tap % 3;
  const unsigned char* h =
      halo + dy * f.row_bytes + dx * kPixBytes + (s & 1) * 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], h + f.a_off[mt]);
}

// acc += the nine taps of one channel chunk: halo tile x weight chunk, 18
// k-steps of wgmma (32 bytes of K each: 16 bf16 or 32 s8 channels) in
// batches of KB = kBatch<BN> steps between one fence and one commit; the
// fragments of batch i + 1 are loaded once batch i - 1 has retired (one
// batch stays in flight).
template <int MT, int BN, typename Acc>
__device__ __forceinline__ void mma_chunk(Acc (&acc)[MT][BN / 8][4],
                                          const unsigned char* halo,
                                          const unsigned char* wts,
                                          const Frag<MT>& f) {
  constexpr int kSteps = 18;
  constexpr int KB = kBatch<BN>, NB = kSteps / KB;
  static_assert(kSteps % KB == 0, "batches must tile the chunk's k-steps");
  unsigned a[2][KB][MT][4];
#pragma unroll
  for (int j = 0; j < KB; ++j) load_a(a[0][j], halo, f, j);
  const uint32_t wbase = smem_u32(wts);
  fence_acc(acc);
#pragma unroll
  for (int bt = 0; bt < NB; ++bt) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int s = bt * KB + j;
      // k groups 2s, 2s + 1 of the chunk: bytes 32 s .. 32 s + 31 of the
      // chunk's [tap][channel] columns
      const uint64_t desc = make_desc(wbase + s * 2 * BN * 16, BN * 16, 128);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        WgmmaOf<Acc, BN>::mma(acc[mt], a[bt & 1][j][mt], desc);
    }
    wgmma_commit();
    if (bt + 1 < NB) {
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < KB; ++j)
        load_a(a[(bt + 1) & 1][j], halo, f, (bt + 1) * KB + j);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// One chunk of weights for output channels n0 .. n0+BN-1 into shared memory
// as wgmma's K-major core matrices: [k group (tap*4 + 16-byte part)][n][16
// bytes], BN * 576 bytes; rows past COUT are zero. w: (COUT, 9*CP) of ES-byte
// values (bf16 or s8), column tap*CP + cin; a chunk is 64 / ES channels.
template <int BN, int ES = 2>
__device__ __forceinline__ void load_weights(unsigned char* dst,
                                             const unsigned char* w, int n0,
                                             int COUT, int CP, int chunk) {
  for (int c = threadIdx.x; c < BN * 36; c += kThreads) {
    const int row = c / 36, kg = c - row * 36;
    const int tap = kg >> 2, part = (kg & 3) * 16;
    const bool ok = n0 + row < COUT;
    const unsigned char* src =
        w + ((int64_t)(n0 + row) * 9 * CP + tap * CP + chunk * (64 / ES)) *
                ES +
        part;
    cp_async_zfill<16>(dst + (kg * BN + row) * 16, ok ? src : w, ok);
  }
}

// The value before the activation: acc + bias (f32 accumulators), or
// float(acc) * ws + bias with each f32 operation rounded on its own (s32
// accumulators): the plain int8 conv's elementwise operations in its order.
__device__ __forceinline__ float pre_act(float acc, float, float b) {
  return acc + b;
}

__device__ __forceinline__ float pre_act(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// Epilogue of one warp: pre_act (ws: the s32 accumulators' column scales,
// unused for f32), ReLU, one rounding to bf16, staged per m16 row tile and
// 32 columns in this warp's slot, then 16-byte stores. NHWC: 16 pixels x 32
// channels, two chunks a lane along the channel rows. NCHW: 32 channels x
// 16 pixels, two 8-pixel runs a lane along W (element stores where W is not
// a multiple of 8).
template <int MT, int NT, typename Acc>
__device__ __forceinline__ void store_tile(
    const Acc (&acc)[MT][NT][4], const float* __restrict__ ws,
    const float* __restrict__ bias, int relu, int nchw, unsigned char* slot,
    __nv_bfloat16* __restrict__ out, const TilePos& tp, int tw, int H, int W,
    int COUT, int n0, int warp, int lane) {
  __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(slot);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = warp_row<MT>(warp, mt);
    const int r = m / tw, c0 = m - r * tw;
    const int y = tp.y0 + r, xs = tp.x0 + c0;
#pragma unroll
    for (int cg = 0; cg < NT / 4; ++cg) {
      const int n_grp = n0 + cg * 32;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = nt * 8 + (lane & 3) * 2;
        const float b0 = n_grp + col < COUT ? bias[n_grp + col] : 0.f;
        const float b1 = n_grp + col + 1 < COUT ? bias[n_grp + col + 1] : 0.f;
        float s0 = 0.f, s1 = 0.f;
        if constexpr (std::is_same_v<Acc, int>) {
          s0 = n_grp + col < COUT ? ws[n_grp + col] : 0.f;
          s1 = n_grp + col + 1 < COUT ? ws[n_grp + col + 1] : 0.f;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = (lane >> 2) + half * 8;
          float v0 = pre_act(acc[mt][cg * 4 + nt][half * 2], s0, b0);
          float v1 = pre_act(acc[mt][cg * 4 + nt][half * 2 + 1], s1, b1);
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if (nchw) {
            s[col * 24 + row] = __float2bfloat16_rn(v0);
            s[(col + 1) * 24 + row] = __float2bfloat16_rn(v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(s + row * 40 + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      __syncwarp();
      if (y < H) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = lane + 32 * i;
          if (!nchw) {
            const int row = q >> 2, cc = (q & 3) * 8;
            const int x = xs + row, n = n_grp + cc;
            if (x < W && n < COUT)
              *reinterpret_cast<uint4*>(
                  out + (((int64_t)tp.b * H + y) * W + x) * COUT + n) =
                  *reinterpret_cast<const uint4*>(s + row * 40 + cc);
          } else {
            const int ch = q >> 1, h8 = (q & 1) * 8;
            const int n = n_grp + ch, x = xs + h8;
            if (n < COUT && x < W) {
              __nv_bfloat16* dst =
                  out + (((int64_t)tp.b * COUT + n) * H + y) * W + x;
              if ((W & 7) == 0) {
                *reinterpret_cast<uint4*>(dst) =
                    *reinterpret_cast<const uint4*>(s + ch * 24 + h8);
              } else {
                for (int j = 0; j < 8 && x + j < W; ++j)
                  dst[j] = s[ch * 24 + h8 + j];
              }
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// The dynamic shared-memory opt-in of a launch; returns a cudaError_t.
template <typename Kernel>
__host__ int prepare_launch(Kernel kern, int smem) {
  if (smem <= 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// ---------------------------------------------------------------------------
// The fused 3x3 conv over NHWC on the core: B4 (conv3x3.cu, bf16 operands,
// f32 accumulators) and B4-int8 (conv3x3_int8.cu, s8 x s8 -> s32).
//
// B4 copies each chunk's halo pixels with cp.async straight into the halo
// tile (VECB = 16 or 8 bytes, the largest that divides a pixel's CIN*2
// bytes: the head's 20 channels are 40 bytes, which also rules out TMA).
// B4-int8 copies the same bf16 pixels, 64 channels a chunk, into a raw stage
// of conv_raw_pitch bytes a pixel, then quantizes it into an s8 halo tile
// (x * (1/s_x) rounded half to even, as the plain version's quantize), so
// no int8 copy of x exists in device memory. Two kernels:
//  - conv3x3_halo_kernel (256 threads: two warpgroups that each copy,
//    quantize, multiply and store): B4, and B4-int8 with one s8 halo tile
//    (the plan's q_stages = 1), which it quantizes between two block
//    barriers. Stage g + 1 is copied while stage g is multiplied.
//  - conv3x3_int8_ws_kernel (384 threads, q_stages = 2, every weight chunk
//    resident): a producer warpgroup copies stage g + 1 and quantizes
//    stage g into one of two s8 halo tiles while the two consumer
//    warpgroups multiply stage g - 1 and store; named barriers hand the s8
//    halos over. The copies, the quantize pass and the products then run
//    side by side, where one block's warps would otherwise run them one
//    after the other.
//
// Shared memory, as ops/conv_halo.py::conv_smem lays it out:
//   [weights: every chunk (resident) or two stages][in 0][in 1]
//   [s8 halo x q_stages (int8)][epilogue slots of the 8 multiplying warps]
// with "in" the halo tile (B4) or the raw stage (B4-int8).

// bytes of one raw-stage pixel: the chunk's bf16 channels, at most 64
__host__ __device__ inline int conv_raw_pitch(int CIN) {
  return (CIN < 64 ? CIN : 64) * 2;
}

__host__ __device__ inline int conv_smem(bool int8, int th, int tw, int BN,
                                         int chunks, bool resident, int CIN,
                                         int q_stages) {
  const int npix = (th + 2) * (tw + 2);
  const int halo = npix * kPixBytes;
  const int in = int8 ? npix * conv_raw_pitch(CIN) : halo;
  return (resident ? chunks : 2) * BN * kWRowBytes + 2 * in +
         (int8 ? q_stages * halo : 0) + kWarps * kStageNhwc;
}

// 4 bf16 values (lo, hi: two packed pairs) times s = 1/s_x, each rounded
// half to even, as 4 s8 bytes: the plain version's quantize, whose clip to
// [-127, 127] cannot bind here. |x| <= absmax(x) and s_x = absmax / 127
// and 1/s_x are each rounded once, so |x * s| <= 127 (1 + 2^-22) < 127.5.
// Rounding is one add of 1.5 * 2^23, which leaves the integer in the low
// mantissa bits (exact for |v| < 2^22) without the conversion unit.
__device__ __forceinline__ unsigned quant_bf16x4(unsigned lo, unsigned hi,
                                                 float s) {
  auto q = [s](unsigned bits) {
    return __float_as_uint(
        __fadd_rn(__fmul_rn(__uint_as_float(bits), s), 12582912.f));
  };
  return __byte_perm(__byte_perm(q(lo << 16), q(lo & 0xffff0000u), 0x0040),
                     __byte_perm(q(hi << 16), q(hi & 0xffff0000u), 0x0040),
                     0x5410);
}

// n / d for the small n of a halo tile (n * d < 2^32): one multiply-high
// by a constant computed once
struct Div {
  unsigned d, m;
  __device__ __forceinline__ explicit Div(unsigned d_)
      : d(d_), m(d_ > 1 ? 0xffffffffu / d_ + 1 : 0) {}
  __device__ __forceinline__ int operator()(int n) const {
    return d > 1 ? (int)__umulhi((unsigned)n, m) : n;
  }
};

// The input side of the NHWC conv for one launch: copying a stage's input
// pixels (the halo of one pixel tile and one chunk) and, for B4-int8,
// quantizing the raw stage into an s8 halo tile. Threads t of nt share the
// work.
template <bool INT8, int VECB>
struct Stager {
  static constexpr int kChunkIn = INT8 ? 128 : 64;   // x bytes a pixel+chunk
  const unsigned char* x;
  int H, W, CINB, hw, npix, in_pitch, per;
  Div by_hw, by_per;

  __device__ __forceinline__ Stager(const unsigned char* x_, int H_, int W_,
                                    int CINB_, const Plan& p)
      : x(x_), H(H_), W(W_), CINB(CINB_), hw(p.tw + 2),
        npix((p.th + 2) * (p.tw + 2)),
        in_pitch(INT8 ? conv_raw_pitch(CINB_ / 2) : kPixBytes),
        per((INT8 ? conv_raw_pitch(CINB_ / 2) : 64) / VECB), by_hw(p.tw + 2),
        by_per((INT8 ? conv_raw_pitch(CINB_ / 2) : 64) / VECB) {}

  // chunk k of the halo of tile tp into dst, zero outside the image and
  // past CIN (cp.async, VECB bytes a copy)
  __device__ __forceinline__ void copy(unsigned char* dst, const TilePos& tp,
                                       int k, int t, int nt) const {
    for (int c = t; c < npix * per; c += nt) {
      const int px = by_per(c), j = c - px * per;
      const int hr = by_hw(px), hc = px - hr * hw;
      const int y = tp.y0 - 1 + hr, xx = tp.x0 - 1 + hc;
      const int cb = k * kChunkIn + j * VECB;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W && cb < CINB;
      const unsigned char* src =
          x + (((int64_t)tp.b * H + y) * W + xx) * CINB + cb;
      ess::cp_async_zfill<VECB>(dst + px * in_pitch + j * VECB,
                                ok ? src : x, ok);
    }
  }

  // the raw stage in quantized by inv_sx into the s8 halo hq: VECB raw
  // bytes (VECB / 2 channels) into VECB / 2 s8 bytes a step
  __device__ __forceinline__ void quantize(unsigned char* hq,
                                           const unsigned char* in,
                                           float inv_sx, int t,
                                           int nt) const {
    for (int c = t; c < npix * per; c += nt) {
      const int px = by_per(c), j = c - px * per;
      const unsigned char* src = in + px * in_pitch + j * VECB;
      unsigned char* dst = hq + px * kPixBytes + j * (VECB / 2);
      if constexpr (VECB == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            quant_bf16x4(v.x, v.y, inv_sx), quant_bf16x4(v.z, v.w, inv_sx));
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        *reinterpret_cast<unsigned*>(dst) = quant_bf16x4(v.x, v.y, inv_sx);
      }
    }
  }
};

template <bool INT8, int MT, int BN, int VECB>
__global__ void __launch_bounds__(kThreads, kMinBlocks<BN>)
conv3x3_halo_kernel(const unsigned char* __restrict__ x,   // NHWC bf16
                    const unsigned char* __restrict__ w,   // (COUT, 9*CP)
                    const float* __restrict__ ws,          // int8: (COUT,)
                    const float* __restrict__ scal,        // int8: s_x, 1/s_x
                    const float* __restrict__ bias,        // (COUT,)
                    __nv_bfloat16* __restrict__ out,       // NHWC
                    int H, int W, int CINB, int COUT, int CP, int relu,
                    Plan p) {
  using Acc = std::conditional_t<INT8, int, float>;
  constexpr int ES = INT8 ? 1 : 2;            // bytes of an operand value
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = CP * ES / 64;
  const Stager<INT8, VECB> st(x, H, W, CINB, p);
  const int halo_bytes = st.npix * kPixBytes;
  const int in_bytes = st.npix * st.in_pitch;
  constexpr int wchunk = BN * kWRowBytes;
  const int n0 = blockIdx.y * BN;
  unsigned char* in_ring = smem + (p.resident ? chunks : 2) * wchunk;
  unsigned char* halo_q = in_ring + 2 * in_bytes;   // int8: the s8 halo
  unsigned char* slot =
      halo_q + (INT8 ? halo_bytes : 0) + warp * kStageNhwc;

  const int G = my_tiles(p) * chunks;
  if (G == 0) return;
  // stage g: pixel tile g / chunks of this block, chunk g % chunks
  auto tile_of = [&](int g) {
    return tile_pos(p, blockIdx.x + (g / chunks) * gridDim.x);
  };
  // the input pixels of stage g into in stage g & 1, its weights into
  // weight stage g & 1 where they are streamed
  auto issue = [&](int g) {
    st.copy(in_ring + (g & 1) * in_bytes, tile_of(g), g % chunks, tid,
            kThreads);
    if (!p.resident)
      load_weights<BN, ES>(smem + (g & 1) * wchunk, w, n0, COUT, CP,
                           g % chunks);
  };

  float inv_sx = 0.f;
  if constexpr (INT8) {
    inv_sx = scal[1];
    // channels past the raw stage's (CIN < 64) stay zero: the K padding
    for (int c = tid; c < halo_bytes / 16; c += kThreads)
      reinterpret_cast<uint4*>(halo_q)[c] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (p.resident)
    for (int k = 0; k < chunks; ++k)
      load_weights<BN, ES>(smem + k * wchunk, w, n0, COUT, CP, k);
  issue(0);
  ess::cp_async_commit();

  const Frag<MT> f(p.tw, warp, lane);
  Acc acc[MT][BN / 8][4];

  for (int g = 0; g < G; ++g) {
    const int k = g % chunks;
    ess::cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();          // stage g landed; stage g+1's buffers are free
    if (g + 1 < G) issue(g + 1);
    ess::cp_async_commit();
    if (k == 0) zero(acc);
    const unsigned char* in = in_ring + (g & 1) * in_bytes;
    const unsigned char* wts = smem + (p.resident ? k : g & 1) * wchunk;
    if constexpr (INT8) {
      st.quantize(halo_q, in, inv_sx, tid, kThreads);
      __syncthreads();        // the s8 halo is ready
      mma_chunk<MT, BN>(acc, halo_q, wts, f);
    } else {
      mma_chunk<MT, BN>(acc, in, wts, f);
    }
    if (k == chunks - 1)
      store_tile(acc, ws, bias, relu, 0, slot, out, tile_of(g), p.tw, H, W,
                 COUT, n0, warp, lane);
  }
  ess::cp_async_wait<0>();
}

constexpr int kWsThreads = 384;   // two consumer warpgroups + a producer
constexpr int kProducers = 128;
// registers a thread after setmaxnreg: the launch holds 168 a thread (the
// launch bound), and an increase waits for registers that a decrease freed,
// so the two must sum to the launch's: else the consumers wait forever
constexpr int kWsProducerRegs = 56, kWsConsumerRegs = 224;
static_assert(kThreads * kWsConsumerRegs + kProducers * kWsProducerRegs ==
                  kWsThreads * 168,
              "setmaxnreg must hand over exactly the launch's registers");
// named barriers (0 is __syncthreads'): s8 halo s full, s8 halo s empty,
// and the producer warpgroup's own
constexpr int kBarFull = 1, kBarEmpty = 3, kBarProducer = 5;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int MT, int BN, int VECB>
__global__ void __launch_bounds__(kWsThreads, 1)
conv3x3_int8_ws_kernel(const unsigned char* __restrict__ x,   // NHWC bf16
                       const unsigned char* __restrict__ w,   // (COUT, 9*CP)
                       const float* __restrict__ ws,          // (COUT,)
                       const float* __restrict__ scal,        // s_x, 1/s_x
                       const float* __restrict__ bias,        // (COUT,)
                       __nv_bfloat16* __restrict__ out,       // NHWC
                       int H, int W, int CINB, int COUT, int CP, int relu,
                       Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = CP / 64;
  const Stager<true, VECB> st(x, H, W, CINB, p);
  const int halo_bytes = st.npix * kPixBytes;
  const int in_bytes = st.npix * st.in_pitch;
  constexpr int wchunk = BN * kWRowBytes;
  const int n0 = blockIdx.y * BN;
  unsigned char* in_ring = smem + chunks * wchunk;   // weights resident
  unsigned char* halo_q = in_ring + 2 * in_bytes;   // two s8 halos

  const int G = my_tiles(p) * chunks;
  if (G == 0) return;
  auto tile_of = [&](int g) {
    return tile_pos(p, blockIdx.x + (g / chunks) * gridDim.x);
  };
  // channels past the raw stage's (CIN < 64) stay zero: the K padding
  for (int c = tid; c < 2 * halo_bytes / 16; c += kWsThreads)
    reinterpret_cast<uint4*>(halo_q)[c] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < kThreads)
    for (int k = 0; k < chunks; ++k)
      load_weights<BN, 1>(smem + k * wchunk, w, n0, COUT, CP, k);
  ess::cp_async_commit();
  ess::cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  if (warp >= kWarps) {
    // producer: stage g + 1's copies in flight while stage g is quantized
    setmaxnreg_dec<kWsProducerRegs>();
    const int t = tid - kThreads;
    const float inv_sx = scal[1];
    auto issue = [&](int g) {
      st.copy(in_ring + (g & 1) * in_bytes, tile_of(g), g % chunks, t,
              kProducers);
    };
    issue(0);
    ess::cp_async_commit();
    for (int g = 0; g < G; ++g) {
      const int s = g & 1;
      if (g + 1 < G) issue(g + 1);
      ess::cp_async_commit();
      ess::cp_async_wait<1>();
      bar_sync(kBarProducer, kProducers);       // stage g landed
      // s8 halo s held stage g - 2 until the consumers released it
      if (g >= 2) bar_sync(kBarEmpty + s, kWsThreads);
      st.quantize(halo_q + s * halo_bytes, in_ring + s * in_bytes, inv_sx,
                  t, kProducers);
      __threadfence_block();
      bar_arrive(kBarFull + s, kWsThreads);
      // raw stage s is free for stage g + 2 once every producer is done
      bar_sync(kBarProducer, kProducers);
    }
    ess::cp_async_wait<0>();
  } else {
    setmaxnreg_inc<kWsConsumerRegs>();
    const Frag<MT> f(p.tw, warp, lane);
    unsigned char* slot = halo_q + 2 * halo_bytes + warp * kStageNhwc;
    int acc[MT][BN / 8][4];
    for (int g = 0; g < G; ++g) {
      const int s = g & 1, k = g % chunks;
      bar_sync(kBarFull + s, kWsThreads);       // stage g quantized
      if (k == 0) zero(acc);
      mma_chunk<MT, BN>(acc, halo_q + s * halo_bytes, smem + k * wchunk, f);
      // every wait of the producer on a release is matched by one
      if (g + 2 < G) bar_arrive(kBarEmpty + s, kWsThreads);
      if (k == chunks - 1)
        store_tile(acc, ws, bias, relu, 0, slot, out, tile_of(g), p.tw, H, W,
                   COUT, n0, warp, lane);
    }
  }
}

template <bool INT8, int MT, int BN, int VECB>
int conv_launch_shape(const void* x, const void* w, const void* ws,
                      const void* scal, const void* bias, void* out, int H,
                      int W, int CIN, int COUT, int CP, int relu,
                      const Plan& p, int grid_x, int smem, void* stream) {
  if (p.th * p.tw != Cfg<MT, BN>::BM || p.tw % 16 != 0 ||
      (p.q_stages == 2 && !p.resident))
    return (int)cudaErrorInvalidValue;
  const int chunks = CP * (INT8 ? 1 : 2) / 64;
  if (smem != conv_smem(INT8, p.th, p.tw, BN, chunks, p.resident, CIN,
                        p.q_stages))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kern, int threads) {
    int err = prepare_launch(kern, smem);
    if (err) return err;
    dim3 grid(grid_x, (COUT + BN - 1) / BN);
    kern<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const unsigned char*)x, (const unsigned char*)w, (const float*)ws,
        (const float*)scal, (const float*)bias, (__nv_bfloat16*)out, H, W,
        CIN * 2, COUT, CP, relu, p);
    return (int)cudaGetLastError();
  };
  if constexpr (INT8)
    if (p.q_stages == 2)
      return run(conv3x3_int8_ws_kernel<MT, BN, VECB>, kWsThreads);
  return run(conv3x3_halo_kernel<INT8, MT, BN, VECB>, kThreads);
}

template <bool INT8, int MT, int BN>
int conv_launch_vec(const void* x, const void* w, const void* ws,
                    const void* scal, const void* bias, void* out, int H,
                    int W, int CIN, int COUT, int CP, int relu,
                    const Plan& p, int grid_x, int smem, void* stream) {
  // CIN is a multiple of 4: a pixel's CIN * 2 bytes are a multiple of 8
  if (CIN % 8 == 0)
    return conv_launch_shape<INT8, MT, BN, 16>(x, w, ws, scal, bias, out, H,
                                               W, CIN, COUT, CP, relu, p,
                                               grid_x, smem, stream);
  return conv_launch_shape<INT8, MT, BN, 8>(x, w, ws, scal, bias, out, H, W,
                                            CIN, COUT, CP, relu, p, grid_x,
                                            smem, stream);
}

// Launch the NHWC conv with the plan of ops/conv_halo.py::conv_plan; the
// layout is recomputed here and a plan that disagrees is refused. x: bf16
// NHWC (B, H, W, CIN), CIN a multiple of 4; w: (COUT, 9*CP) bf16 with CP =
// CIN rounded up to 32, or s8 with CP = CIN rounded up to 64 (INT8); ws:
// f32 (COUT,) and scal: f32 (s_x, 1/s_x) on the device (INT8 only); bias:
// f32 (COUT,); out: bf16 NHWC (B, H, W, COUT), COUT a multiple of 8. All
// 16-byte aligned. Returns a cudaError_t.
template <bool INT8>
int conv_launch(const void* x, const void* w, const void* ws,
                const void* scal, const void* bias, void* out, int B, int H,
                int W, int CIN, int COUT, int relu, int th, int tw,
                int resident, int q_stages, int grid_x, int smem,
                void* stream) {
  if ((int64_t)B * H * W == 0 || COUT == 0) return 0;
  if (CIN <= 0 || CIN % 4 != 0 || COUT % 8 != 0 || th <= 0 || tw <= 0 ||
      grid_x <= 0 ||
      (INT8 && (ws == nullptr || scal == nullptr || q_stages < 1 ||
                q_stages > 2)))
    return (int)cudaErrorInvalidValue;
  const int kc = INT8 ? 64 : kKC;
  const int CP = (CIN + kc - 1) / kc * kc;
  Plan p;
  p.th = th;
  p.tw = tw;
  p.tiles_y = (H + th - 1) / th;
  p.tiles_x = (W + tw - 1) / tw;
  p.n_tiles = B * p.tiles_y * p.tiles_x;
  p.resident = resident;
  p.q_stages = INT8 ? q_stages : 0;
  if (COUT > 64)
    return conv_launch_vec<INT8, 1, 128>(x, w, ws, scal, bias, out, H, W, CIN,
                                         COUT, CP, relu, p, grid_x, smem,
                                         stream);
  if (COUT > 32)
    return conv_launch_vec<INT8, 2, 64>(x, w, ws, scal, bias, out, H, W, CIN,
                                        COUT, CP, relu, p, grid_x, smem,
                                        stream);
  return conv_launch_vec<INT8, 2, 32>(x, w, ws, scal, bias, out, H, W, CIN,
                                      COUT, CP, relu, p, grid_x, smem, stream);
}

// ---------------------------------------------------------------------------
// The int8 preps' first kernel, shared by B2-int8 and B4-int8: the per-call
// x scale s_x = max(absmax(x), 1e-8) / 127 is reduced in two steps, per
// block maxima here, then in every block of the prep kernel that follows
// (x_scales). No host sync: the scales stay on the device.

constexpr int kPrepThreads = 256;
constexpr int kMaxPartials = 512;   // ops/conv_lstm.py::PREP_PARTIALS

// max over the block of v (every thread gets it)
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kPrepThreads / 32; ++w) v = fmaxf(v, red[w]);
  return v;
}

// max |x| of n bf16 values over their bits (non-negative bf16 values order
// as their bits), one partial a block; x 16-byte aligned
static __global__ void __launch_bounds__(kPrepThreads)
absmax_kernel(const __nv_bfloat16* __restrict__ x, int64_t n,
              float* __restrict__ partials) {
  __shared__ float red[kPrepThreads / 32];
  const uint4* x16 = reinterpret_cast<const uint4*>(x);
  const int64_t n16 = n / 8;
  const int64_t stride = (int64_t)gridDim.x * kPrepThreads;
  unsigned m = 0;
  auto take = [&m](const uint4& v) {
    const unsigned w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      m = max(m, max(w4[j] & 0x7fffu, (w4[j] >> 16) & 0x7fffu));
  };
  int64_t i = (int64_t)blockIdx.x * kPrepThreads + threadIdx.x;
  for (; i + 3 * stride < n16; i += 4 * stride) {   // 4 loads in flight
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = x16[i + u * stride];
#pragma unroll
    for (int u = 0; u < 4; ++u) take(v[u]);
  }
  for (; i < n16; i += stride) take(x16[i]);
  if (blockIdx.x == 0 && threadIdx.x < n - n16 * 8)   // the last n % 8
    m = max(m, (unsigned)__bfloat16_as_ushort(x[n16 * 8 + threadIdx.x]) &
                   0x7fffu);
  const float amax = block_max(__uint_as_float(m << 16), red);
  if (threadIdx.x == 0) partials[blockIdx.x] = amax;
}

// Blocks of absmax_kernel over n values: one per kPrepThreads x 4 loads of
// 16 bytes, at most kMaxPartials
inline int absmax_blocks(int64_t n) {
  const int64_t per = (int64_t)kPrepThreads * 4 * 8;
  const int64_t nb = (n + per - 1) / per;
  return (int)(nb < 1 ? 1 : nb < kMaxPartials ? nb : kMaxPartials);
}

// (s_x, 1/s_x) from the partials, as input_scale and torch.reciprocal
// compute them (every thread of the block gets both)
__device__ __forceinline__ float2 x_scales(const float* __restrict__ partials,
                                           int n_partials, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < n_partials; i += kPrepThreads)
    m = fmaxf(m, partials[i]);
  const float amax = block_max(m, red);
  const float s_x = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  return make_float2(s_x, __fdiv_rn(1.f, s_x));
}


// ---------------------------------------------------------------------------
// The ConvLSTM cell kernels on the core: B2 (conv_lstm.cu, bf16 operands,
// f32 accumulators) and B2-int8 (conv_lstm_int8.cu, s8 x s8 -> s32), one
// kernel template instantiated twice. Output of a block tile: 256 pixels
// (a 16 x 16 or 8 x 32 patch) x 128 gate columns (32 hidden channels x the
// four gates, in the prepared column order of
// ess_tpu_torch/ops/conv_lstm.py::gate_column_order).
//
// Warp roles: two consumer warpgroups (warps 0-7) each own MT = 2 m64 row
// tiles and all 128 columns (128 accumulator registers a thread, raised to
// 232 registers by setmaxnreg); a producer warpgroup (warps 8-11, lowered
// to 40 registers) of which one thread issues every copy. The consumers
// only ldmatrix, wgmma and run the epilogue. They take turns on the tensor
// cores chunk by chunk (two named barriers), so that one warpgroup's
// epilogue runs while the other's products do.
//
// Ring: kCellStages = 2 stages of [weight chunk | halo chunk] (a third
// would need ~285 KB of the 227 KB a block may have), each with a full
// and an empty mbarrier. A stage is one chunk of 64 bytes a pixel (32 bf16
// or 64 int8 channels) of concat(x, h): chunk k < chunks_x is staged from x,
// the rest from h (the second source). Per stage the producer
//  - streams the N tile's weights of the chunk with cp.async.bulk: the
//    prepared image (ops/conv_lstm.py::gate_weight_image, or the int8 prep
//    kernel) lies in global memory exactly as wgmma's no-swizzle K-major
//    core matrices lie in shared memory, [36 k groups][128 columns][16 B],
//    so one copy of 73,728 bytes needs no index math;
//  - copies the (th+2) x (tw+2) halo of the chunk with one TMA load of a
//    4-D tensor map (C, W, H, B) of x or h: out-of-bounds boxes are zero
//    filled, which is the conv's padding, and the 64-byte swizzle puts the
//    16-byte piece j of halo pixel p at j ^ ((p >> 1) & 3), so the 8 rows of
//    every shifted ldmatrix fall on 8 distinct bank groups;
//  - sets the full barrier's transaction bytes; the copies complete it.
// The consumers wait on the full barrier, run the 18 k-steps of the chunk
// (each tap a shifted view of the halo, as above), and release the stage
// on its empty barrier.
//
// Epilogue: wgmma's accumulator fragment of an n8 column tile is the m16n8
// layout, so with the prepared column order each thread holds gates i, f,
// o, g of 2 channels x 2 rows per m16 tile: the LSTM pointwise runs in
// registers, reading c (16-byte loads issued before the tile's last chunk,
// staged per warp) and writing c' in place and h' to its own buffer
// (neighbouring patches read h_prev's halo) with 16-byte stores. Pixels
// outside the image are not stored.

constexpr int kCellThreads = 384;
constexpr int kCellStages = 2;
constexpr int kCellConsumerWarps = 8;
constexpr int kCellMT = 2;
constexpr int kCellBN = 128;
constexpr int kCellPixBytes = 64;
constexpr int kCellWStage = 36 * kCellBN * 16;   // 73,728
constexpr int kCellSlot = 2 * 16 * 40 * 2;       // c/c' and h' of 16 pixels
constexpr int kCellBarriers = 64;
constexpr int kCellAlign = 1024;

// The cell's plan, as ops/conv_halo.py::cell_plan computes it.
struct CellPlan {
  Plan t;            // patch and pixel tiles (t.resident unused)
  int n_tiles_n;     // N tiles of 128 gate columns
  int chunks_x;      // chunks staged from x, then from h
  int chunks;
  int halo_bytes;    // (th + 2) * (tw + 2) * 64
  int stage_bytes;   // weights + halo padded to kCellAlign
};

__host__ __device__ inline int cell_halo_pad(int th, int tw) {
  const int raw = (th + 2) * (tw + 2) * kCellPixBytes;
  return (raw + kCellAlign - 1) / kCellAlign * kCellAlign;
}

__host__ inline int cell_smem(int th, int tw) {
  return kCellAlign + kCellStages * (kCellWStage + cell_halo_pad(th, tw)) +
         kCellConsumerWarps * kCellSlot + kCellBarriers;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed. A phase
// that never completes (a fault of the ring) traps after ~10 s of waiting
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (int n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0) {
      t0 = clock64();
    } else if ((n & 1023) == 0 && clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// `bytes` from global memory into this block's shared memory, completing
// transaction bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Per-lane halo pixel, for tap (0, 0), of this lane's ldmatrix row in each
// of its m16 row tiles (the rows of an m16 tile lie in one patch row).
template <int MT>
struct SwFrag {
  int p0[MT];
  int hw;            // halo row: tw + 2 pixels

  __device__ __forceinline__ SwFrag(int tw, int warp, int lane) {
    hw = tw + 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = warp_row<MT>(warp, mt);
      const int r = m / tw, c0 = m - r * tw;
      p0[mt] = r * hw + c0 + (lane & 15);
    }
  }
};

// The A fragments of k-step s (tap s / 2; 16-byte pieces 2 (s % 2) and
// 2 (s % 2) + 1 of each 64-byte pixel) from a 64-byte-swizzled halo.
template <int MT>
__device__ __forceinline__ void load_a_sw(unsigned (&a)[MT][4], uint32_t halo,
                                          const SwFrag<MT>& f, int s,
                                          int lane) {
  const int tap = s >> 1, dy = tap / 3, dx = tap - dy * 3;
  const int j = (s & 1) * 2 + (lane >> 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = f.p0[mt] + dy * f.hw + dx;
    ldmatrix_x4_at(a[mt], halo + (p << 6) + (((j ^ (p >> 1)) & 3) << 4));
  }
}

// Named barriers of the consumer warpgroups' turns on the tensor cores
// (barrier 0 is __syncthreads'): warpgroup g waits on 1 + g, the other
// warpgroup arrives on it.
constexpr int kTurnThreads = 2 * 128;
constexpr int kCellBatch = 3;     // k-steps per wgmma group

__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kTurnThreads)
               : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kTurnThreads)
               : "memory");
}

// acc += one chunk: the 18 k-steps (9 taps x 2) of halo x weight stage in
// groups of kCellBatch steps, one group in flight while the next group's
// fragments load (a warpgroup alone keeps the tensor cores busier with 3
// steps a group than with 1: PERF.md). Once the last group is
// issued, `pass` hands the tensor cores to the other warpgroup
// (turn_pass) while this one's last group runs.
template <bool INT8, int MT, typename Acc>
__device__ __forceinline__ void cell_chunk(Acc (&acc)[MT][kCellBN / 8][4],
                                           uint32_t halo, uint32_t wts,
                                           const SwFrag<MT>& f, int lane,
                                           bool pass, int wg) {
  constexpr int kSteps = 18, KB = kCellBatch, NB = kSteps / KB;
  static_assert(kSteps % KB == 0, "batches must tile the chunk's k-steps");
  unsigned a[2][KB][MT][4];
#pragma unroll
  for (int j = 0; j < KB; ++j) load_a_sw(a[0][j], halo, f, j, lane);
  fence_acc(acc);
#pragma unroll
  for (int bt = 0; bt < NB; ++bt) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int s = bt * KB + j;
      const uint64_t desc =
          make_desc(wts + s * 2 * kCellBN * 16, kCellBN * 16, 128);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (INT8)
          WgmmaS8<kCellBN>::mma(acc[mt], a[bt & 1][j][mt], desc);
        else
          Wgmma<kCellBN>::mma(acc[mt], a[bt & 1][j][mt], desc);
      }
    }
    wgmma_commit();
    if (bt + 1 < NB) {
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < KB; ++j)
        load_a_sw(a[(bt + 1) & 1][j], halo, f, (bt + 1) * KB + j, lane);
    }
  }
  if (pass) turn_pass(wg);
  wgmma_wait<0>();
  fence_acc(acc);
}

// c of this warp's rows of a pixel tile (16 pixels x 32 channels per m16
// tile, two 16-byte pieces a lane), loaded into registers before the
// tile's last chunk so that their latency hides behind its products.
template <int MT>
__device__ __forceinline__ void cell_load_c(uint4 (&cr)[MT][2],
                                            const __nv_bfloat16* __restrict__ c,
                                            const TilePos& tp, int tw, int H,
                                            int W, int CH, int nt, int warp,
                                            int lane) {
  const int ch0 = nt * (kCellBN / 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = warp_row<MT>(warp, mt);
    const int r = m / tw, c0 = m - r * tw;
    const int y = tp.y0 + r, xs = tp.x0 + c0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = lane + 32 * i, px = q >> 2, part = (q & 3) * 8;
      if (y < H && xs + px < W)
        cr[mt][i] = *reinterpret_cast<const uint4*>(
            c + (((int64_t)tp.b * H + y) * W + xs + px) * CH + ch0 + part);
    }
  }
}

// The LSTM epilogue of one consumer warp for one pixel tile: gates (+ bias;
// int8: the s32 sums times the column scales ws first), then the cell's
// pointwise (or a variant's, MODE != kFull). c (cr, from cell_load_c) is
// read and c' written back in place; h' goes to h_out. Rows staged in the
// warp's slot: [16 pixels][40] bf16 for c/c' and the same for h'.
template <bool INT8, int MODE, int MT, typename Acc>
__device__ __forceinline__ void cell_store(
    const Acc (&acc)[MT][kCellBN / 8][4], const uint4 (&cr)[MT][2],
    const float* __restrict__ ws, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ c, __nv_bfloat16* __restrict__ h_out,
    unsigned char* slot, const TilePos& tp, int tw, int H, int W, int CH,
    int nt, int warp, int lane) {
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(slot);
  __nv_bfloat16* sh = sc + 16 * 40;
  const int ch0 = nt * (kCellBN / 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = warp_row<MT>(warp, mt);
    const int r = m / tw, c0 = m - r * tw;
    const int y = tp.y0 + r, xs = tp.x0 + c0;
    if (y >= H) continue;                       // the whole m16 tile
    const int64_t row0 = ((int64_t)tp.b * H + y) * W;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = lane + 32 * i, px = q >> 2, part = (q & 3) * 8;
      *reinterpret_cast<uint4*>(sc + px * 40 + part) = cr[mt][i];
    }
    __syncwarp();
#pragma unroll
    for (int g4 = 0; g4 < 4; ++g4) {            // 8-channel group
      const int col = g4 * 8 + (lane & 3) * 2;
      float bi[4][2], sc_w[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bi[g][j] = bias[g * CH + ch0 + col + j];
          sc_w[g][j] = INT8 ? ws[g * CH + ch0 + col + j] : 1.f;
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
          for (int g = 0; g < 4; ++g) {
            if constexpr (INT8)
              gt[g] = __fadd_rn(
                  __fmul_rn(__int2float_rn(acc[mt][g4 * 4 + g][rr]),
                            sc_w[g][j]),
                  bi[g][j]);
            else if constexpr (MODE == kFull)
              gt[g] = acc[mt][g4 * 4 + g][rr] + bi[g][j];
            else
              gt[g] = __fadd_rn(acc[mt][g4 * 4 + g][rr], bi[g][j]);
          }
          if constexpr (MODE == kFull && INT8) {
            // one rounding per operation, no fused multiply-add: the plain
            // version's elementwise ops, so both round alike
            cn[j] = __fadd_rn(__fmul_rn(sigmoidf_(gt[1]), cp[j]),
                              __fmul_rn(sigmoidf_(gt[0]), tanhf(gt[3])));
            hn[j] = __fmul_rn(sigmoidf_(gt[2]), tanhf(cn[j]));
          } else if constexpr (MODE == kFull) {
            cn[j] = sigmoidf_(gt[1]) * cp[j] +
                    sigmoidf_(gt[0]) * tanhf(gt[3]);
            hn[j] = sigmoidf_(gt[2]) * tanhf(cn[j]);
          } else {
            variant_pointwise<MODE>(gt, cp[j], hn[j], cn[j]);
          }
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
      if (xs + px < W) {
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

// The cell kernel. map_x / map_h: 4-D tensor maps of x and h (bf16, or
// their int8 copies with channels padded to 64), box 64 bytes x (tw + 2) x
// (th + 2) x 1; w_img: the weight image [N tile][chunk][36][128][16 B]; ws
// (int8 only) and bias: f32 (4 * CH,) in i, f, o, g order; c: bf16 NHWC,
// updated in place; h_out: bf16 NHWC. MODE != kFull: an attribution
// variant (kNoBuild: no halo copies, the product runs on whatever the
// stage holds, the output is undefined).
template <bool INT8, int MODE>
__global__ void __launch_bounds__(kCellThreads, 1)
cell_kernel(const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_h,
            const unsigned char* __restrict__ w_img,
            const float* __restrict__ ws, const float* __restrict__ bias,
            __nv_bfloat16* __restrict__ c, __nv_bfloat16* __restrict__ h_out,
            int H, int W, int CH, CellPlan p) {
  using Acc = std::conditional_t<INT8, int, float>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kCellAlign - 1) & ~(uint32_t)(kCellAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int S = kCellStages;
  const uint32_t bars = base + S * p.stage_bytes +
                        kCellConsumerWarps * kCellSlot;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  // work items (N tile fastest) dealt round-robin to the persistent blocks
  const int bid = blockIdx.x, nb = gridDim.x;
  const int items = p.t.n_tiles * p.n_tiles_n;
  const int mine = bid < items ? (items - bid + nb - 1) / nb : 0;
  const int G = mine * p.chunks;            // stages this block consumes

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kCellConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kCellConsumerWarps) {
    // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<40>();
    if (warp == kCellConsumerWarps && lane == 0) {
      for (int g = 0; g < G; ++g) {
        const int s = g % S;
        mbar_wait(empty(s), ((g / S) & 1) ^ 1);
        const int i = g / p.chunks, k = g - i * p.chunks;
        const int wc = bid + i * nb;
        const int nt = wc % p.n_tiles_n, t = wc / p.n_tiles_n;
        const bool halo = MODE != kNoBuild;
        mbar_expect_tx(full(s), kCellWStage + (halo ? p.halo_bytes : 0));
        const uint32_t dst = base + s * p.stage_bytes;
        bulk_load(dst, w_img + ((int64_t)nt * p.chunks + k) * kCellWStage,
                  kCellWStage, full(s));
        if (halo) {
          const TilePos tp = tile_pos(p.t, t);
          const bool from_x = k < p.chunks_x;
          tma_load_4d(dst + kCellWStage, from_x ? &map_x : &map_h,
                      (from_x ? k : k - p.chunks_x) * (INT8 ? 64 : 32),
                      tp.x0 - 1, tp.y0 - 1, tp.b, full(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    // the two warpgroups take turns on the tensor cores, chunk by chunk,
    // warpgroup 0 first, so that one's epilogue runs beside the other's
    // products (the other's last chunk of the tile, or its next tile's)
    const int wg = warp >> 2;
    if (wg == 1 && G > 0) turn_pass(wg);
    const SwFrag<kCellMT> f(p.t.tw, warp, lane);
    unsigned char* slot = smem + S * p.stage_bytes + warp * kCellSlot;
    Acc acc[kCellMT][kCellBN / 8][4];
    uint4 cr[kCellMT][2];
    for (int g = 0; g < G; ++g) {
      const int s = g % S;
      const int i = g / p.chunks, k = g - i * p.chunks;
      const int wc = bid + i * nb;
      const int nt = wc % p.n_tiles_n, t = wc / p.n_tiles_n;
      const bool last = k == p.chunks - 1;
      if (last)
        cell_load_c(cr, c, tile_pos(p.t, t), p.t.tw, H, W, CH, nt, warp,
                    lane);
      mbar_wait(full(s), (g / S) & 1);
      if (k == 0) zero(acc);
      const uint32_t stage = base + s * p.stage_bytes;
      turn_wait(wg);
      // warpgroup 1's last chunk hands over to no one: every wait on a
      // turn is matched by one pass
      cell_chunk<INT8, kCellMT>(acc, stage + kCellWStage, stage, f, lane,
                                wg == 0 || g + 1 < G, wg);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      if (last)
        cell_store<INT8, MODE, kCellMT>(acc, cr, ws, bias, c, h_out, slot,
                                        tile_pos(p.t, t), p.t.tw, H, W, CH,
                                        nt, warp, lane);
    }
  }
}

// The halo map of an NHWC tensor (B, H, W, C) of bf16 (int8 = false) or
// int8 channels: dims (C, W, H, B), box (64 bytes of channels, tw + 2,
// th + 2, 1), 64-byte swizzle, zero fill out of bounds. Returns a
// cudaError_t.
inline int halo_map(CUtensorMap* map, const void* base, bool int8, int B,
                    int H, int W, int C, int th, int tw) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t e = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * e, W * C * e, (cuuint64_t)H * W * C * e};
  const cuuint32_t box[4] = {(cuuint32_t)(64 / e), (cuuint32_t)(tw + 2),
                             (cuuint32_t)(th + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map,
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Launch the cell kernel with the plan of ops/conv_halo.py::cell_plan; the
// layout is recomputed here and a plan that disagrees is refused. x and h
// hold CXS = CX and CHS = CH channels (bf16) or CX, CH rounded up to 64
// (their int8 copies). Returns a cudaError_t.
template <bool INT8, int MODE>
int cell_launch(const void* x, const void* h, void* c, const void* w_img,
                const void* ws, const void* bias, void* h_out, int B, int H,
                int W, int CX, int CH, int th, int tw, int grid, int smem,
                void* stream) {
  if ((int64_t)B * H * W == 0) return 0;
  const int kc = INT8 ? 64 : 32;
  if (CX <= 0 || CH <= 0 || CX % 32 || CH % 32 || th <= 0 || tw <= 0 ||
      th * tw != 2 * kCellMT * 64 || tw % 16 || tw + 2 > 256 ||
      th + 2 > 256 || grid <= 0 || smem != cell_smem(th, tw))
    return (int)cudaErrorInvalidValue;
  const int cxs = (CX + kc - 1) / kc * kc, chs = (CH + kc - 1) / kc * kc;
  CellPlan p;
  p.t.th = th;
  p.t.tw = tw;
  p.t.tiles_y = (H + th - 1) / th;
  p.t.tiles_x = (W + tw - 1) / tw;
  p.t.n_tiles = B * p.t.tiles_y * p.t.tiles_x;
  p.t.resident = 0;
  p.n_tiles_n = 4 * CH / kCellBN;
  p.chunks_x = cxs / kc;
  p.chunks = p.chunks_x + chs / kc;
  p.halo_bytes = (th + 2) * (tw + 2) * kCellPixBytes;
  p.stage_bytes = kCellWStage + cell_halo_pad(th, tw);
  CUtensorMap map_x, map_h;
  int err = halo_map(&map_x, x, INT8, B, H, W, cxs, th, tw);
  if (!err) err = halo_map(&map_h, h, INT8, B, H, W, chs, th, tw);
  if (err) return err;
  auto kern = cell_kernel<INT8, MODE>;
  err = prepare_launch(kern, smem);
  if (err) return err;
  kern<<<grid, kCellThreads, smem, (cudaStream_t)stream>>>(
      map_x, map_h, (const unsigned char*)w_img, (const float*)ws,
      (const float*)bias, (__nv_bfloat16*)c, (__nv_bfloat16*)h_out, H, W, CH,
      p);
  return (int)cudaGetLastError();
}

}  // namespace halo
}  // namespace ess
