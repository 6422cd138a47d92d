// Fold-free trilinear voxelizer over host ghost-folded (band, x-slot) records.
//
// Replaces the TPU kernel ess_tpu/ops/voxel_pallas.py::_kernel_slotted, which
// builds row and column tent planes per 1024-record chunk and accumulates
// their product on the matrix unit. That formulation exists to turn a
// scatter into dense matrix work on a TPU; an H100 has fast shared-memory
// atomics, so here each record deposits its 8 corners directly.
//
// Design: the persistent scatter core of voxel_scatter.cuh. A work item is
// one (window, group), a group being one band of tile_h rows by one
// 128-column x-slot; the host sort and the offsets give each group a
// contiguous record range, and the host folding guarantees that no nonzero
// corner leaves the group's tile, so an item walks its own range only. Each
// item's tile leaves by one TMA tensor store, and the pass that zeroes its
// accumulator afterwards also reduces the tile's (sum, sum of squares,
// nonzero count) into one partial per (window, group); the caller sums the
// partials per window in group order. One launch a call.
//
// Bound on the H100: per 100k-event DSEC window it reads ~104.6k records x
// 16 B and writes a 6.1 MB f32 grid, so bytes bound it: at one step's 160
// windows 268 MB + 983 MB over 3.35 TB/s = 0.373 ms. The old design (one
// block per item, zero, scatter with one compare-and-swap loop per corner,
// then 4-byte stores) wrote the grid only in each block's last phase and
// reached a third of that rate; here the TMA stores one block's tile while
// the SM's other blocks scatter, a record's corners go to shared memory in
// one batch of swaps, and the next item's records are in registers before
// its accumulator is free. Corners that fall outside the tile (x exactly
// 127.0 in a slot, row exactly tile_h - 1, time exactly bins - 1) carry zero
// weight and are skipped by explicit bounds checks.
//
// Second entry, ess_voxel_folded_band: the legacy full-width band wire
// (voxel_pallas.py::_kernel with k_tiles=1, col_slot=width under
// voxelize_folded, :1176-1184), fed by host_band_bin_folded(x_slots=False)
// or a native ingest with ntx=1. Records are ghost-folded across band rows
// and frame edges only; their columns are global x and a record's corners
// may cross any 128-column boundary. The TPU kernel keeps one
// bins x tile_h x width accumulator per band; at DSEC width that is
// 5 x 24 x 640 x 4 B = 307 KB, more than a block's 227 KB of shared memory.
// So each band is split into column slabs (the caller picks the slab width,
// 320 columns = 154 KB at DSEC width): one block per (window, band, slab)
// walks the band's whole record range and deposits only the corners that
// land in its slab. Every grid element is still written by exactly one
// block (no zero fill), the partial stats count each element once, and
// the records are read once per slab, which the byte bound does not count.

#include "voxel_scatter.cuh"

// offsets (n_windows, n_bands * n_slots + 1); grid (n_windows, bins,
// n_bands * tile_h, width); partials (n_windows, n_bands * n_slots, 3). The
// plan (threads, grid_blocks, smem) is ops/voxel_scatter.py's.
extern "C" int ess_voxel_folded(const void* x, const void* y, const void* ts,
                                const void* pol, const void* offsets,
                                void* grid, void* partials, int n_windows,
                                int n_records, int bins, int tile_h,
                                int n_bands, int n_slots, int width,
                                int threads, int grid_blocks, int smem,
                                void* stream) {
  const scatter::Args a{(const float*)x,  (const float*)y,
                        (const float*)ts, (const float*)pol,
                        (const int32_t*)offsets, (float*)grid,
                        (float*)partials, n_records, bins, tile_h, n_slots,
                        n_bands * n_slots, n_bands * tile_h, width,
                        n_windows * n_bands * n_slots};
  return scatter::launch<false>(a, threads, grid_blocks, smem, stream);
}

namespace {

constexpr int kBandThreads = 512;   // one large block per SM at 154 KB

__global__ void __launch_bounds__(kBandThreads)
voxel_folded_band_kernel(const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ tss,
                         const float* __restrict__ pols,
                         const int32_t* __restrict__ offsets,
                         float* __restrict__ grid,
                         float* __restrict__ partials, int n_records,
                         int bins, int tile_h, int n_slabs, int slab_w,
                         int width) {
  extern __shared__ float acc[];
  __shared__ float red[3][kBandThreads / 32];

  const int g = blockIdx.x;                 // band * n_slabs + slab
  const int w = blockIdx.y;                 // window
  const int n_bands = gridDim.x / n_slabs;
  const int band = g / n_slabs;
  const int col0 = (g - band * n_slabs) * slab_w;
  const int cols = min(slab_w, width - col0);
  const int tile = bins * tile_h * cols;

  for (int i = threadIdx.x; i < tile; i += kBandThreads) acc[i] = 0.f;
  __syncthreads();

  const int32_t* offs = offsets + (int64_t)w * (n_bands + 1);
  const int start = min(max(offs[band], 0), n_records);
  const int end = min(max(offs[band + 1], start), n_records);
  const int64_t base = (int64_t)w * n_records;
  const float row0 = (float)(band * tile_h);

  for (int i = start + threadIdx.x; i < end; i += kBandThreads) {
    const float yl = ys[base + i] - row0;
    const float xg = xs[base + i];
    const float ts = tss[base + i];
    const float p = pols[base + i];
    const float yf = floorf(yl), xf = floorf(xg), cf = floorf(ts);
    const float fy = yl - yf, fx = xg - xf, wt = ts - cf;
    const int r0 = (int)yf, q0 = (int)xf - col0, c0 = (int)cf;
    if (q0 + 1 < 0 || q0 >= cols) continue;   // both columns off the slab
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
        if (r < 0 || r >= tile_h) continue;
        const float swy = sc[dc] * wy[dy];
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int q = q0 + dx;
          const float v = swy * wx[dx];
          if (q < 0 || q >= cols || v == 0.f) continue;
          atomicAdd(&acc[(c * tile_h + r) * cols + q], v);
        }
      }
    }
  }
  __syncthreads();

  // slab -> grid (one run of `cols` floats per (bin, row)), partial stats
  const int height = n_bands * tile_h;
  float s = 0.f, sq = 0.f, nz = 0.f;
  for (int i = threadIdx.x; i < tile; i += kBandThreads) {
    const int q = i % cols;
    const int cr = i / cols;
    const int c = cr / tile_h;
    const int r = cr - c * tile_h;
    const float v = acc[i];
    grid[(((int64_t)w * bins + c) * height + band * tile_h + r) * width +
         col0 + q] = v;
    s += v;
    sq += v * v;
    nz += v != 0.f ? 1.f : 0.f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    sq += __shfl_down_sync(0xffffffffu, sq, o);
    nz += __shfl_down_sync(0xffffffffu, nz, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = sq;
    red[2][warp] = nz;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float t = 0.f;
    for (int k = 0; k < kBandThreads / 32; ++k) t += red[threadIdx.x][k];
    partials[((int64_t)w * gridDim.x + g) * 3 + threadIdx.x] = t;
  }
}

}  // namespace

// Legacy full-width band wire: offsets (n_windows, n_bands + 1); grid
// (n_windows, bins, n_bands * tile_h, width); partials (n_windows,
// n_bands * n_slabs, 3); slab_w * n_slabs >= width.
extern "C" int ess_voxel_folded_band(const void* x, const void* y,
                                     const void* ts, const void* pol,
                                     const void* offsets, void* grid,
                                     void* partials, int n_windows,
                                     int n_records, int bins, int tile_h,
                                     int n_bands, int n_slabs, int slab_w,
                                     int width, void* stream) {
  if (n_windows == 0) return 0;
  if (slab_w <= 0 || (int64_t)n_slabs * slab_w < width ||
      (int64_t)(n_slabs - 1) * slab_w >= width)
    return (int)cudaErrorInvalidValue;
  const int smem = bins * tile_h * slab_w * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      voxel_folded_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 blocks(n_bands * n_slabs, n_windows);
  voxel_folded_band_kernel<<<blocks, kBandThreads, smem,
                             (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)ts, (const float*)pol,
      (const int32_t*)offsets, (float*)grid, (float*)partials, n_records,
      bins, tile_h, n_slabs, slab_w, width);
  return (int)cudaGetLastError();
}

extern "C" const char* ess_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
