// Halo-tile implicit-GEMM 3x3 SAME conv core for Hopper, shared by the
// exact fused conv B4 (conv3x3.cu, NHWC input) and the C-major head conv T1
// (head_cmajor.cu, NCHW input with the normalize fused).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace halo
}  // namespace ess
