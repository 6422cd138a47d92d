// Halo-tile implicit-GEMM 3x3 SAME conv core for Hopper, shared by the
// exact fused conv B4 (conv3x3.cu, NHWC input), the C-major head conv T1
// (head_cmajor.cu, NCHW input with the normalize fused) and the ConvLSTM
// cell kernels B2 and B2-int8 (conv_lstm.cu, conv_lstm_int8.cu; their
// kernel, with a producer warpgroup, TMA halos and streamed weight stages,
// is the last section of this file).
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
// chunk of kKC = 32 channels at a time, are staged into shared memory
// pixel-major ([pixel][channel], kPixBytes = 80 bytes a pixel: an odd
// multiple of 16, so the 8 row addresses of an ldmatrix fall on 8 distinct
// 16-byte bank groups). Every input value is loaded from device memory once
// per halo, not once per tap; zeros outside the image are the conv's
// padding, zeros past C_in the K padding (their weight columns are zero).
// The loaders are the callers': cp.async straight from NHWC (B4), or
// aligned cp.async of C-major rows and one normalize pass (T1).
//
// Taps: every tap's A fragment is an ldmatrix from the halo tile shifted by
// (dy, dx) pixels: one uniform offset added to per-lane row addresses
// computed once.
//
// MMA: wgmma in its register-A form, m64 x BN x k16 per instruction, f32
// accumulators. Each warpgroup owns MT m64 row tiles of the block and all
// BN columns; each warp loads the A fragment of its 16 rows with ldmatrix
// (the register form shares the m16n8k16 fragment layout), and the tensor
// cores read B from shared memory in the no-swizzle K-major layout of 8 x
// 16-byte core matrices, [k group of 8 channels][n][8 channels]: the
// descriptor's core-matrix strides are BN * 16 bytes along K and 128 bytes
// along N. The register form keeps the shifted-row addressing of the taps
// (a shared-memory A operand would need a canonical copy per tap). The 18
// k-steps of a chunk are issued in batches, the next batch's fragments
// loaded while one batch of wgmma groups is in flight.
//
// Epilogue: bias, optional ReLU, one rounding to bf16; each warp stages its
// 16 rows 32 columns at a time in its own shared-memory slot (no block
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

// cp.async writes shared memory through the generic proxy; wgmma reads its
// shared-memory operand through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
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
// k-steps of wgmma in batches of KB = kBatch<BN> steps between one fence
// and one commit; the fragments of batch i + 1 are loaded once batch i - 1
// has retired (one batch stays in flight).
template <int MT, int BN>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][BN / 8][4],
                                          const unsigned char* halo,
                                          const unsigned char* wts,
                                          const Frag<MT>& f) {
  constexpr int kSteps = 9 * kKC / 16;
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
      // k groups 2s, 2s + 1 of the chunk: channels 16 s .. 16 s + 15 of the
      // chunk's [tap][channel] columns
      const uint64_t desc = make_desc(wbase + s * 2 * BN * 16, BN * 16, 128);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        Wgmma<BN>::mma(acc[mt], a[bt & 1][j][mt], desc);
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
// as wgmma's K-major core matrices: [k group (tap*4 + 8-channel part)][n][8
// channels], BN * 576 bytes; rows past COUT are zero. w: (COUT, 9*CP) bf16,
// column tap*CP + cin.
template <int BN>
__device__ __forceinline__ void load_weights(unsigned char* dst,
                                             const unsigned char* w, int n0,
                                             int COUT, int CP, int chunk) {
  for (int c = threadIdx.x; c < BN * 36; c += kThreads) {
    const int row = c / 36, kg = c - row * 36;
    const int tap = kg >> 2, part = (kg & 3) * 16;
    const bool ok = n0 + row < COUT;
    const unsigned char* src =
        w + ((int64_t)(n0 + row) * 9 * CP + tap * CP + chunk * kKC) * 2 + part;
    cp_async_zfill<16>(dst + (kg * BN + row) * 16, ok ? src : w, ok);
  }
}

// Epilogue of one warp: + bias, ReLU, one rounding to bf16, staged per m16
// row tile and 32 columns in this warp's slot, then 16-byte stores. NHWC:
// 16 pixels x 32 channels, two chunks a lane along the channel rows. NCHW:
// 32 channels x 16 pixels, two 8-pixel runs a lane along W (element stores
// where W is not a multiple of 8).
template <int MT, int NT>
__device__ __forceinline__ void store_tile(
    const float (&acc)[MT][NT][4], const float* __restrict__ bias, int relu,
    int nchw, unsigned char* slot, __nv_bfloat16* __restrict__ out,
    const TilePos& tp, int tw, int H, int W, int COUT, int n0, int warp,
    int lane) {
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
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = (lane >> 2) + half * 8;
          float v0 = acc[mt][cg * 4 + nt][half * 2] + b0;
          float v1 = acc[mt][cg * 4 + nt][half * 2 + 1] + b1;
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

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
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

template <int MT, int NT>
__device__ __forceinline__ void zero(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
}

// d (m64 x 128 s32) += a (this warp's 16 rows x k32 s8, registers: the
// m16n8k32 fragment) * B (k32 x 128 s8 at desc)
struct WgmmaS8 {
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
          WgmmaS8::mma(acc[mt], a[bt & 1][j][mt], desc);
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

// cuTensorMapEncodeTiled, reached through the runtime (the library is not
// linked against libcuda)
typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(ptr);
  }
  return fn;
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
