// Halo-tiled trilinear voxelizer over tile-sorted events.
//
// Replaces the TPU kernel ess_tpu/ops/voxel_pallas.py::_kernel in halo mode
// (voxelize_tiled) together with its halo fold (_fold_halo). The TPU version
// turns the scatter into matrix work: a pre-pass derives per-event plane
// positions, each 1024-event block builds row and column tent planes, their
// product accumulates on the matrix unit into (rows, 5 x 136) tiles with a
// +1 halo row and column, and selection matmuls fold the halos afterwards.
// None of that layout is kept: an H100 has fast shared-memory atomics, so
// each event deposits its up to 8 corners directly, and only the output
// (windows, bins, H, W) f32 has to match.
//
// Design, two kernels on one stream:
//   1. voxel_tiled_kernel: one block per (window, tile), a tile being tile_h
//      rows by 128 columns. The sort gives each tile a contiguous event
//      range offsets[tile] .. offsets[tile + 1]. The block zeroes a
//      bins x (tile_h + 1) x (128 + 1) f32 accumulator in shared memory
//      (5 x 25 x 129 x 4 B = 64.5 KB at 5 bins: dynamic shared memory above
//      the 48 KB default, opted into by the launcher), reads x, y, ts, pol,
//      derives tile-local coordinates and the three fractions in registers
//      (flooring, so a coordinate in (-1, 0) keeps only its in-frame corner)
//      and adds every in-range, nonzero corner with a shared atomic. Row
//      tile_h and column 128 of the accumulator are the halo: corners that
//      belong to the tile below and to the right. The block then stores its
//      tile_h x 128 core to the grid with plain coalesced writes (every grid
//      element has exactly one such writer, so the grid needs no zero fill)
//      and its halo row and column to a small scratch buffer.
//   2. voxel_tiled_fold_kernel: one thread per grid cell on a tile's first
//      row or first column adds the halos of the tiles above, to the left
//      and above-left from the scratch buffer. One thread owns one cell, so
//      the fold has no race and no global atomics; halos that point past
//      the grid (last tile row and column) are never read.
// Storing cores with plain writes while neighbours add halos into the same
// cells would race; the scratch buffer plus the second pass is the choice
// made here over a zero fill with global atomics, because it writes the
// 6 MB grid once and keeps the cross-tile sum order fixed.
//
// Bounds on the H100: per 100k-event DSEC window the kernels read 1.6 MB of
// events and write a 6.1 MB grid; memory traffic and shared-atomic
// throughput bound them, not arithmetic. Corners whose time bin is `bins`
// (ts == bins - 1) or that fall outside the accumulator are skipped by
// explicit bounds checks; a tile without events writes zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 128;
constexpr int kAccW = kTileW + 1;     // + halo column
constexpr int kThreads = 256;

// Halo scratch of one (window, tile, bin): the halo row (129 values, the
// last one the corner) followed by the halo column (tile_h values).
__host__ __device__ inline int halo_stride(int tile_h) {
  return kAccW + tile_h;
}

__global__ void __launch_bounds__(kThreads)
voxel_tiled_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ tss,
                   const float* __restrict__ pols,
                   const int32_t* __restrict__ offsets,
                   float* __restrict__ grid, float* __restrict__ halo,
                   int n_events, int bins, int tile_h, int n_tx) {
  extern __shared__ float acc[];

  const int tile = blockIdx.x;              // ty * n_tx + tx
  const int w = blockIdx.y;                 // window
  const int n_tiles = gridDim.x;
  const int ty = tile / n_tx;
  const int tx = tile - ty * n_tx;
  const int acc_h = tile_h + 1;
  const int acc_n = bins * acc_h * kAccW;

  for (int i = threadIdx.x; i < acc_n; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int32_t* offs = offsets + (int64_t)w * (n_tiles + 1);
  // clamp to the window's events: offsets may come from the host
  const int start = min(max(offs[tile], 0), n_events);
  const int end = min(max(offs[tile + 1], start), n_events);
  const int64_t base = (int64_t)w * n_events;
  const float row0 = (float)(ty * tile_h);
  const float col0 = (float)(tx * kTileW);

  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    const float p = pols[base + i];
    if (p == 0.f) continue;
    const float yl = ys[base + i] - row0;
    const float xl = xs[base + i] - col0;
    const float ts = tss[base + i];
    const float yf = floorf(yl), xf = floorf(xl), cf = floorf(ts);
    const float fy = yl - yf, fx = xl - xf, wt = ts - cf;
    const int r0 = (int)yf, q0 = (int)xf, c0 = (int)cf;
    const float sc[2] = {p * (1.f - wt), p * wt};
    const float wy[2] = {1.f - fy, fy};
    const float wx[2] = {1.f - fx, fx};
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
      const int c = c0 + dc;
      if (c < 0 || c >= bins) continue;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int r = r0 + dy;
        if (r < 0 || r > tile_h) continue;
        const float swy = sc[dc] * wy[dy];
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int q = q0 + dx;
          const float v = swy * wx[dx];
          if (q < 0 || q > kTileW || v == 0.f) continue;
          atomicAdd(&acc[(c * acc_h + r) * kAccW + q], v);
        }
      }
    }
  }
  __syncthreads();

  // core -> grid, one 128-float row per (bin, row)
  const int height = n_tiles / n_tx * tile_h;
  const int width = n_tx * kTileW;
  const int core_n = bins * tile_h * kTileW;
  for (int i = threadIdx.x; i < core_n; i += kThreads) {
    const int q = i % kTileW;
    const int cr = i / kTileW;
    const int c = cr / tile_h;
    const int r = cr - c * tile_h;
    grid[(((int64_t)w * bins + c) * height + ty * tile_h + r) * width
         + tx * kTileW + q] = acc[(c * acc_h + r) * kAccW + q];
  }
  // halo row (with the corner) and halo column -> scratch
  const int hs = halo_stride(tile_h);
  float* out = halo + ((int64_t)w * n_tiles + tile) * bins * hs;
  for (int i = threadIdx.x; i < bins * hs; i += kThreads) {
    const int c = i / hs;
    const int j = i - c * hs;
    out[i] = j < kAccW ? acc[(c * acc_h + tile_h) * kAccW + j]
                       : acc[(c * acc_h + (j - kAccW)) * kAccW + kTileW];
  }
}

__global__ void __launch_bounds__(kThreads)
voxel_tiled_fold_kernel(const float* __restrict__ halo,
                        float* __restrict__ grid, int64_t total, int bins,
                        int tile_h, int n_ty, int n_tx) {
  // one thread per cell of a tile's first row (j < 128: column j) or first
  // column (j >= 128: row j - 127), per (window, tile, bin)
  const int per = kTileW + tile_h - 1;
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % per);
  int64_t rest = idx / per;
  const int c = (int)(rest % bins);
  rest /= bins;
  const int n_tiles = n_ty * n_tx;
  const int tile = (int)(rest % n_tiles);
  const int w = (int)(rest / n_tiles);
  const int ty = tile / n_tx;
  const int tx = tile - ty * n_tx;
  if (ty == 0 && tx == 0) return;

  const int hs = halo_stride(tile_h);
  const float* hw = halo + (int64_t)w * n_tiles * bins * hs;
  auto at = [&](int t) { return hw + ((int64_t)t * bins + c) * hs; };
  float add = 0.f;
  int r, q;
  if (j < kTileW) {                       // first row
    r = 0;
    q = j;
    if (ty > 0) add += at(tile - n_tx)[q];
    if (q == 0 && tx > 0) {
      add += at(tile - 1)[kAccW];                          // left, row 0
      if (ty > 0) add += at(tile - n_tx - 1)[kTileW];      // corner
    }
  } else {                                // first column, rows 1..tile_h-1
    r = j - kTileW + 1;
    q = 0;
    if (tx > 0) add += at(tile - 1)[kAccW + r];
  }
  if (add == 0.f) return;
  const int height = n_ty * tile_h;
  const int width = n_tx * kTileW;
  grid[(((int64_t)w * bins + c) * height + ty * tile_h + r) * width
       + tx * kTileW + q] += add;
}

}  // namespace

extern "C" int ess_voxel_tiled(const void* x, const void* y, const void* ts,
                               const void* pol, const void* offsets,
                               void* grid, void* halo, int n_windows,
                               int n_events, int bins, int tile_h, int n_ty,
                               int n_tx, void* stream) {
  if (n_windows == 0) return 0;
  const int smem = bins * (tile_h + 1) * kAccW * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      voxel_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 blocks(n_ty * n_tx, n_windows);
  voxel_tiled_kernel<<<blocks, kThreads, smem, st>>>(
      (const float*)x, (const float*)y, (const float*)ts, (const float*)pol,
      (const int32_t*)offsets, (float*)grid, (float*)halo, n_events, bins,
      tile_h, n_tx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)n_windows * n_ty * n_tx * bins
                        * (kTileW + tile_h - 1);
  const int64_t fold_blocks = (total + kThreads - 1) / kThreads;
  voxel_tiled_fold_kernel<<<(unsigned)fold_blocks, kThreads, 0, st>>>(
      (const float*)halo, (float*)grid, total, bins, tile_h, n_ty, n_tx);
  return (int)cudaGetLastError();
}
