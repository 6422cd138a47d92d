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
// Design: the persistent scatter core of voxel_scatter.cuh, one launch a
// call. A work item is one (window, tile), a tile being tile_h rows by 128
// columns; the sort gives each tile a contiguous event range
// offsets[tile] .. offsets[tile + 1]. An event reaches only its own tile,
// the row below and the column to the right, so the item for tile (ty, tx)
// walks its own range and those of its upper, left and upper-left
// neighbours (their events rejected on one 4-byte load unless they sit on
// the neighbour's last row or column), computes each event's fractions in
// the event's own tile frame (flooring, so a coordinate in (-1, 0) keeps
// only its in-frame corner) and deposits only the corners that land inside
// its own tile: no halo leaves the block, so there is no halo scratch and
// no fold pass, and every grid element is stored once, by the drain of
// its tile.
//
// Bound on the H100: per 100k-event DSEC window the kernel reads 1.6 MB of
// events and writes a 6.1 MB grid, so bytes bound it (0.018 ms at the
// streaming B=8); the neighbours' ranges are read again from L2, which the
// byte bound does not count. Corners whose time bin is `bins` (ts ==
// bins - 1) or that fall outside the grid are skipped by explicit bounds
// checks; a tile without events stores zeros.
//
// q8 (PipelineConfig.voxel_oh_dtype='int8') selects the core's int8 form:
// the TPU kernel's int8 tent planes in halo mode (voxel_pallas.py:560-585:
// the wy_fold of a row in (-1, 0), the x127 prescale; the tall row plane,
// its gap tile_h + 1; each tile's columns at tile id * COL_SLOT), exact
// integer products in the cells. Same bytes, same bound.

#include "voxel_scatter.cuh"

// offsets (n_windows, n_ty * n_tx + 1); grid (n_windows, bins,
// n_ty * tile_h, n_tx * 128); partials (n_windows, n_ty * n_tx, 3), the
// tiles' (sum, sum of squares, nonzero count), or null. The plan (threads,
// grid_blocks, smem) is ops/voxel_scatter.py's; q8 the int8 form.
extern "C" int ess_voxel_tiled_stats(const void* x, const void* y,
                                     const void* ts, const void* pol,
                                     const void* offsets, void* grid,
                                     void* partials, int n_windows,
                                     int n_events, int bins, int tile_h,
                                     int n_ty, int n_tx, int threads,
                                     int grid_blocks, int smem, int q8,
                                     void* stream) {
  const scatter::Args a{(const float*)x,  (const float*)y,
                        (const float*)ts, (const float*)pol,
                        (const int32_t*)offsets, (float*)grid,
                        (float*)partials, n_events, bins, tile_h, n_tx,
                        n_ty * n_tx, n_ty * tile_h, n_tx * scatter::kTileW,
                        n_windows * n_ty * n_tx, n_ty * n_tx};
  return scatter::launch<scatter::kTiled>(a, threads, grid_blocks, smem,
                                          stream, scatter::kNCHW, q8);
}

// The grid alone.
extern "C" int ess_voxel_tiled(const void* x, const void* y, const void* ts,
                               const void* pol, const void* offsets,
                               void* grid, int n_windows, int n_events,
                               int bins, int tile_h, int n_ty, int n_tx,
                               int threads, int grid_blocks, int smem,
                               int q8, void* stream) {
  return ess_voxel_tiled_stats(x, y, ts, pol, offsets, grid, nullptr,
                               n_windows, n_events, bins, tile_h, n_ty, n_tx,
                               threads, grid_blocks, smem, q8, stream);
}
