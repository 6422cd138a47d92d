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
// corner leaves the group's tile, so an item walks its own range only. Its
// corners add into 64-bit fixed-point cells, so the grid and the stats are
// the same bits on every launch; the pass that stores the tile converts it
// to f32 and reduces its (sum, sum of squares, nonzero count) into one
// partial per (window, group), which the caller sums per window in group
// order. One launch a call.
//
// Bound on the H100: per 100k-event DSEC window it reads ~104.6k records x
// 16 B and writes a 6.1 MB f32 grid, so bytes bound it: at one step's 160
// windows 268 MB + 983 MB over 3.35 TB/s = 0.373 ms. Persistent blocks
// walk the items, and the next item's records are in registers before its
// accumulator is free. Corners that fall outside the tile (x exactly
// 127.0 in a slot, row exactly tile_h - 1, time exactly bins - 1) carry zero
// weight and are skipped by explicit bounds checks.
//
// Second entry, ess_voxel_folded_band: the legacy full-width band wire
// (voxel_pallas.py::_kernel with k_tiles=1, col_slot=width under
// voxelize_folded, :1177 / :1185), fed by
// host_band_bin_folded(x_slots=False) or a native ingest with ntx=1.
// Records are ghost-folded across band rows and frame edges only; their
// columns are global x and a record's corners may cross any 128-column
// boundary. The TPU kernel keeps one bins x tile_h x width accumulator per
// band (307 KB at DSEC width, more than a block's 227 KB); here the band
// is cut into its 128-column tiles, each a work item of the same core
// (voxel_scatter.cuh, Kind kBand): the band's tiles are consecutive items,
// each walks the band's whole range and keeps the records whose floor(x)
// lies in [128 tx - 1, 128 tx + 127], so the band's records are read from
// device memory once and from L2 by the other tiles. Every grid element is
// stored once, by its tile's drain, and the partial stats count each
// element once. Bound as B1's (the same records and grid bytes): 0.373 ms
// at 160 windows.
//
// The opt-in pins (PipelineConfig.voxel_oh_dtype, raw_windows,
// stack_windows) select forms of the same core (voxel_scatter.cuh, LAYOUT
// and Q8): layout 1 writes the TPU kernel's raw band accumulator (windows,
// n_bands, bins * tile_h, width) (voxel_pallas.py:1257-1289, both wires),
// layout 2 the space-to-depth NCHW stack (windows, 4 * bins, height / 2,
// width / 2) of _kernel_slotted's stack_out (:480-495, x-slot wire only),
// and q8 the int8 tent planes (oh_dtype=jnp.int8: :308-316, :463-470, the
// x127 prescale :1108-1111). The same bytes move in every form, so the
// bound is the default's.

#include "voxel_scatter.cuh"

// offsets (n_windows, n_bands * n_slots + 1); grid (n_windows, bins,
// n_bands * tile_h, width) in layout 0 (else as above); partials
// (n_windows, n_bands * n_slots, 3). The plan (threads, grid_blocks, smem)
// is ops/voxel_scatter.py's.
extern "C" int ess_voxel_folded(const void* x, const void* y, const void* ts,
                                const void* pol, const void* offsets,
                                void* grid, void* partials, int n_windows,
                                int n_records, int bins, int tile_h,
                                int n_bands, int n_slots, int width,
                                int threads, int grid_blocks, int smem,
                                int layout, int q8, void* stream) {
  const scatter::Args a{(const float*)x,  (const float*)y,
                        (const float*)ts, (const float*)pol,
                        (const int32_t*)offsets, (float*)grid,
                        (float*)partials, n_records, bins, tile_h, n_slots,
                        n_bands * n_slots, n_bands * tile_h, width,
                        n_windows * n_bands * n_slots, n_bands * n_slots};
  return scatter::launch<scatter::kFolded>(a, threads, grid_blocks, smem,
                                           stream, layout, q8);
}

// Legacy full-width band wire: offsets (n_windows, n_bands + 1); grid
// (n_windows, bins, n_bands * tile_h, width); partials (n_windows,
// n_bands * width / 128, 3). The plan (threads, grid_blocks, smem) is
// ops/voxel_scatter.py's in mode 'band'; layout 0 or 1, q8 as above.
extern "C" int ess_voxel_folded_band(const void* x, const void* y,
                                     const void* ts, const void* pol,
                                     const void* offsets, void* grid,
                                     void* partials, int n_windows,
                                     int n_records, int bins, int tile_h,
                                     int n_bands, int width, int threads,
                                     int grid_blocks, int smem, int layout,
                                     int q8, void* stream) {
  const int n_tx = width / scatter::kTileW;
  const scatter::Args a{(const float*)x,  (const float*)y,
                        (const float*)ts, (const float*)pol,
                        (const int32_t*)offsets, (float*)grid,
                        (float*)partials, n_records, bins, tile_h, n_tx,
                        n_bands * n_tx, n_bands * tile_h, width,
                        n_windows * n_bands * n_tx, n_bands};
  return scatter::launch<scatter::kBand>(a, threads, grid_blocks, smem,
                                         stream, layout, q8);
}

extern "C" const char* ess_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
