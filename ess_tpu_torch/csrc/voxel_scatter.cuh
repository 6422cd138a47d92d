// Persistent scatter core of the trilinear voxelizers for Hopper, shared by
// the fold-free x-slot voxelizer (B1, voxel_folded.cu::ess_voxel_folded),
// its full-width band wire (B3-legacy, voxel_folded.cu::
// ess_voxel_folded_band) and the halo-tiled voxelizer (B3,
// voxel_tiled.cu::ess_voxel_tiled): three kinds of work item (Kind).
//
// Work items. A tile is tile_h rows by 128 columns of one window's
// (bins, H, W) f32 grid (a B1 group: one band by one x-slot); a work item is
// one (window, tile), numbered window-major. The records an item reads are
// one group of the window's sorted records (offsets, n_groups + 1 a
// window): its own tile's (B1, B3) or its whole band's (B3-legacy). The
// grid holds as many blocks as fit on the SMs (at most one per item), and
// block b walks the items b, b + gridDim.x, ...: the items in flight are a
// contiguous run of one or two windows, so a window's events stay in L2
// while its tiles run (B3's tiles read their neighbours' ranges again, and
// B3-legacy's tiles their band's, from there).
//
// Accumulator. Each item deposits into a dense bins x tile_h x 128 f32
// accumulator in shared memory (row pitch 128 floats; bins * (tile_h + 1)
// <= 128 keeps it under 64 KB: 60 KB at 5 bins). A block holds one, so
// three 256-thread blocks share an SM at 5 bins and the TMA stores one
// block's tile while the others scatter (two accumulators in one block an
// SM measured slower at every main-path shape on the H100).
//
// Deposit. The H100 has no shared-memory f32 add: atomicAdd on shared
// memory compiles to a compare-and-swap loop (ATOMS.CAST.SPIN), one corner
// after the other. So a record's up to 8 corners are added in one batch:
// 8 shared loads, then 8 independent compare-and-swaps in flight together,
// and only a corner whose swap lost a race (another thread changed the
// cell in between) goes through atomicAdd. The sum is the same as eight
// atomicAdds; only the order of the additions to a cell differs.
//
// Stores. A finished tile leaves as one TMA tensor store
// (cp.async.bulk.tensor.4d.global.shared::cta.bulk_group) of a 128 x tile_h
// x bins x 1 box of the (W, H, bins, windows) grid: the box's shared-memory
// image is the accumulator itself. The deposits write shared memory through
// the generic proxy and the TMA reads it through the async proxy, so every
// thread runs fence.proxy.async.shared::cta before the block barrier that
// ends the scatter, and the issuing thread runs it again after the barrier.
// Before the accumulator is scattered into again, the issuing thread waits
// with cp.async.bulk.wait_group.read, then comes a block barrier, then one
// pass of 16-byte shared loads and stores reads it (B1: the item's sum, sum
// of squares and nonzero count) and zeroes it. Every grid element is stored by exactly one box,
// empty tiles as zeros, so the grid needs no zero fill; nothing is added to
// device memory, so there are no global atomics and no second pass.
//
// Loads. The next item's first kAhead records (x, y, ts, pol) are loaded
// into registers right after the current item's store is issued, so they
// arrive while the block waits for and zeroes the accumulator; records past
// the first kAhead are loaded on demand.
//
// Band rule (B3-legacy). The host folds ghosts across band rows and frame
// edges only, so a band's records keep global columns and a record's x + 1
// corners may cross into the next tile. The five (at DSEC width) tiles of a
// band are consecutive items and run side by side on neighbouring blocks;
// each walks the band's whole range (from L2 after the first) and keeps a
// record only if floor(x) lies in [128 tx - 1, 128 tx + 127] (the -1: a
// record just left of the tile still puts its x + 1 corners into it); rows
// need no check. A warp queues its kept records in shared memory and
// deposits them 32 at a time, one a lane. Partials as B1's.
//
// B3 gather rule. An event of tile (ty, tx) deposits only into its own
// tile, the row below and the column to the right, so tile (ty, tx)
// receives corners only from the ranges of its own tile and of its upper,
// left and upper-left neighbours. The block walks those up to four ranges,
// computes each event's fractions in the event's own tile frame (as
// voxelize_tiled_ref does) and keeps only the corners inside its tile. A
// neighbour's event is rejected on one 4-byte load: it counts only if its
// local row floor is the neighbour's last row (tile_h - 1) or its column
// floor is 127.
//
// The plan (threads, grid, shared bytes) is computed in Python
// (ess_tpu_torch/ops/voxel_scatter.py::scatter_plan) and passed in; the
// launchers recompute the layout and refuse a plan that disagrees.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

// Attribution builds only (tools/bench_voxel.py --attribute): leave out the
// neighbours' gathers (1), the deposits (2) or the tile stores (4).
#ifndef VOXEL_SCATTER_SKIP
#define VOXEL_SCATTER_SKIP 0
#endif

namespace {
namespace scatter {

constexpr int kTileW = 128;     // tile columns = accumulator row pitch
constexpr int kRowBytes = kTileW * 4;
constexpr int kAhead = 1024;    // records of the next item loaded ahead
constexpr int kMaxSmem = 232448;

// What a work item reads and reduces: B1 (own group, stats), B3 (own tile
// and its neighbours' ranges, no stats), B3-legacy (its band, stats).
enum Kind { kFolded = 0, kTiled = 1, kBand = 2 };

struct Args {
  const float* xs;
  const float* ys;
  const float* tss;
  const float* pols;
  const int32_t* offsets;       // (windows, n_groups + 1)
  float* grid;                  // (windows, bins, height, width)
  float* partials;              // (windows, n_tiles, 3), B1 and B3-legacy
  int n_records;                // records per window
  int bins;
  int tile_h;
  int n_tx;
  int n_tiles;
  int height;
  int width;
  int n_items;                  // windows * n_tiles
  int n_groups;                 // record groups a window: n_tiles, or the
                                // bands (B3-legacy)
};

// The band height both host binnings use (ops/voxel_scatter.py).
inline int tile_h_for_bins(int bins) {
  int th = 128 / bins - 1;
  th -= th % 2;
  return th < 4 ? 4 : (th > 64 ? 64 : th);
}

// One tile's box (x = tx * 128, y = ty * tile_h, bin 0, window w) from its
// accumulator.
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const float* acc, int x, int y,
                                           int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(static_cast<uint32_t>(__cvta_generic_to_shared(acc))), "r"(x),
      "r"(y), "r"(0), "r"(w)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The up to 8 corners of one event that land in the accumulator. (yl, xl)
// are the event's coordinates in its own tile's frame; the receiving tile's
// row and column are that frame's less (dr, dq).
__device__ __forceinline__ void deposit(float* acc, float yl, float xl,
                                        float ts, float p, int bins, int th,
                                        int dr, int dq) {
  if (VOXEL_SCATTER_SKIP & 2) return;
  const float yf = floorf(yl), xf = floorf(xl), cf = floorf(ts);
  const float fy = yl - yf, fx = xl - xf, wt = ts - cf;
  const int r0 = (int)yf - dr, q0 = (int)xf - dq, c0 = (int)cf;
  const float sc[2] = {p * (1.f - wt), p * wt};
  const float wy[2] = {1.f - fy, fy};
  const float wx[2] = {1.f - fx, fx};
  int idx[8];
  float val[8], old[8];
  bool ok[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dc = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int c = c0 + dc, r = r0 + dy, q = q0 + dx;
    val[k] = sc[dc] * wy[dy] * wx[dx];
    ok[k] = c >= 0 && c < bins && r >= 0 && r < th && q >= 0 &&
            q < kTileW && val[k] != 0.f;
    idx[k] = (c * th + r) * kTileW + q;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    old[k] = 0.f;
    if (ok[k]) old[k] = acc[idx[k]];
  }
  unsigned seen[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (ok[k])
      seen[k] = atomicCAS(reinterpret_cast<unsigned*>(acc + idx[k]),
                          __float_as_uint(old[k]),
                          __float_as_uint(old[k] + val[k]));
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (ok[k] && seen[k] != __float_as_uint(old[k]))
      atomicAdd(acc + idx[k], val[k]);
}

// One item's place: window, tile row and column, and its record range.
struct Item {
  int w, ty, tx, start, end;
  int64_t base;                 // first record of the window
};

__device__ __forceinline__ int2 record_range(const Args& a, int w,
                                             int group) {
  const int32_t* offs = a.offsets + (int64_t)w * (a.n_groups + 1);
  // clamp to the window's records: offsets may come from the host
  const int start = min(max(offs[group], 0), a.n_records);
  const int end = min(max(offs[group + 1], start), a.n_records);
  return make_int2(start, end);
}

template <int KIND>
__device__ __forceinline__ Item locate(const Args& a, int item) {
  Item it;
  it.w = item / a.n_tiles;
  const int tile = item - it.w * a.n_tiles;
  it.ty = tile / a.n_tx;
  it.tx = tile - it.ty * a.n_tx;
  const int2 r = record_range(a, it.w, KIND == kBand ? it.ty : tile);
  it.start = r.x;
  it.end = r.y;
  it.base = (int64_t)it.w * a.n_records;
  return it;
}

// The first kAhead records of an item's own range, in registers.
template <int THREADS>
struct Ahead {
  static constexpr int R = kAhead / THREADS;
  float x[R], y[R], t[R], p[R];

  __device__ __forceinline__ void load(const Args& a, const Item& it) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = it.start + (int)threadIdx.x + j * THREADS;
      if (i < it.end) {
        x[j] = a.xs[it.base + i];
        y[j] = a.ys[it.base + i];
        t[j] = a.tss[it.base + i];
        p[j] = a.pols[it.base + i];
      } else {
        x[j] = y[j] = t[j] = p[j] = 0.f;
      }
    }
  }
};

// A neighbour's range: only events whose row floor (UP) and / or column
// floor (LEFT) is the neighbour's last reach this tile.
template <int THREADS, bool UP, bool LEFT>
__device__ __forceinline__ void gather(const Args& a, float* acc,
                                       const Item& it, int tile, float row0,
                                       float col0) {
  constexpr int U = 4;
  const int th = a.tile_h;
  const int2 r = record_range(a, it.w, tile);
  for (int i0 = r.x + (int)threadIdx.x; i0 < r.y; i0 += U * THREADS) {
    float key[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * THREADS;
      key[u] = i < r.y ? (UP ? a.ys[it.base + i] - row0
                             : a.xs[it.base + i] - col0)
                       : -1.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (floorf(key[u]) != (float)(UP ? th - 1 : kTileW - 1)) continue;
      const int64_t i = it.base + i0 + u * THREADS;
      float yl = key[u], xl = key[u];
      if (UP) {
        xl = a.xs[i] - col0;
        if (LEFT && floorf(xl) != (float)(kTileW - 1)) continue;
      } else {
        yl = a.ys[i] - row0;
      }
      const float p = a.pols[i];
      if (p == 0.f) continue;
      deposit(acc, yl, xl, a.tss[i], p, a.bins, th, UP ? th : 0,
              LEFT ? kTileW : 0);
    }
  }
}

// B3-legacy: whether a record at column xl of the tile's frame (exact: x
// and the tile's origin are within a factor of two of each other, or the
// origin is 0) reaches the tile, floor(xl) in [-1, 127]
__device__ __forceinline__ bool in_band_tile(float xl) {
  return xl >= -1.f && xl < (float)kTileW;
}

// B3-legacy: a warp's queue of the records that reach its item's tile, in
// shared memory (64 slots: fewer than 32 wait between flushes, and one
// round adds at most 32). About one record in five of a band reaches a
// given tile, so depositing straight from the records a lane loaded would
// leave four lanes in five idle in every deposit; the queue hands the warp
// 32 kept records at a time instead.
constexpr int kQueue = 64;

struct BandQueue {
  float4* q;                    // this warp's kQueue slots: (yl, xl, t, p)
  int n;                        // records waiting (the same in every lane)
};

// Every lane offers one record (keep: it reaches the tile); once 32 wait,
// each lane deposits one. Called by the whole warp.
__device__ __forceinline__ void band_offer(BandQueue& bq, float* acc,
                                           bool keep, float yl, float xl,
                                           float t, float p, int bins,
                                           int th) {
  const int lane = threadIdx.x & 31;
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (keep)
    bq.q[bq.n + __popc(m & ((1u << lane) - 1u))] = make_float4(yl, xl, t, p);
  bq.n += __popc(m);
  if (bq.n >= 32) {
    __syncwarp();
    const float4 r = bq.q[lane];
    const float4 rest = bq.q[32 + lane];
    __syncwarp();
    if (lane < bq.n - 32) bq.q[lane] = rest;
    bq.n -= 32;
    deposit(acc, r.x, r.y, r.z, r.w, bins, th, 0, 0);
    __syncwarp();
  }
}

// The records still waiting, one a lane.
__device__ __forceinline__ void band_flush(BandQueue& bq, float* acc,
                                           int bins, int th) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < bq.n) {
    const float4 r = bq.q[lane];
    deposit(acc, r.x, r.y, r.z, r.w, bins, th, 0, 0);
  }
  bq.n = 0;
  __syncwarp();
}

// B3-legacy: the records of the item's band past those loaded ahead, U a
// lane at a time with all four fields' loads in flight together (from L2
// after the band's first tile; loading y, ts and pol only after x passed
// put two dependent load latencies on every kept record), offered to the
// warp's queue. The loop runs warp-uniform rounds (the queue's ballots).
template <int THREADS>
__device__ __forceinline__ void band_rest(const Args& a, float* acc,
                                          BandQueue& bq, const Item& it,
                                          float row0, float col0) {
  constexpr int U = 4;
  const int lane = threadIdx.x & 31, w0 = threadIdx.x - lane;
  for (int r0 = it.start + kAhead + w0; r0 < it.end; r0 += U * THREADS) {
    float xl[U], yl[U], t[U], p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = r0 + lane + u * THREADS;
      const int64_t k = it.base + (i < it.end ? i : it.start);
      xl[u] = a.xs[k] - col0;
      yl[u] = a.ys[k] - row0;
      t[u] = a.tss[k];
      p[u] = i < it.end ? a.pols[k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      band_offer(bq, acc, p[u] != 0.f && in_band_tile(xl[u]), yl[u], xl[u],
                 t[u], p[u], a.bins, a.tile_h);
  }
  band_flush(bq, acc, a.bins, a.tile_h);
}

// One pass over an accumulator whose store has read it: 16-byte loads for
// the stats (STATS), 16-byte zero stores (zero). Each warp leaves its sums
// in red[warp].
template <int THREADS, bool STATS>
__device__ __forceinline__ void drain(float* acc, int n4, bool zero,
                                      float (*red)[3]) {
  float4* a4 = reinterpret_cast<float4*>(acc);
  float s = 0.f, sq = 0.f, nz = 0.f;
  for (int i = threadIdx.x; i < n4; i += THREADS) {
    if (STATS) {
      const float4 v = a4[i];
      s += v.x;
      s += v.y;
      s += v.z;
      s += v.w;
      sq += v.x * v.x;
      sq += v.y * v.y;
      sq += v.z * v.z;
      sq += v.w * v.w;
      nz += (v.x != 0.f) + (v.y != 0.f) + (v.z != 0.f) + (v.w != 0.f);
    }
    if (zero) a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (STATS) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      sq += __shfl_down_sync(0xffffffffu, sq, o);
      nz += __shfl_down_sync(0xffffffffu, nz, o);
    }
    if ((threadIdx.x & 31) == 0) {
      red[threadIdx.x >> 5][0] = s;
      red[threadIdx.x >> 5][1] = sq;
      red[threadIdx.x >> 5][2] = nz;
    }
  }
}

// Threads 0..2 sum the warps' stats of one item into its partial (B1,
// B3-legacy).
template <int THREADS>
__device__ __forceinline__ void write_partial(const Args& a,
                                              float (*red)[3], int item) {
  if (threadIdx.x < 3) {
    float t = 0.f;
    for (int k = 0; k < THREADS / 32; ++k) t += red[k][threadIdx.x];
    a.partials[(int64_t)item * 3 + threadIdx.x] = t;
  }
}

// KIND: B1 (own range only, one stats partial per item), B3 (gather from
// the neighbours' ranges, no stats) or B3-legacy (the band's range with the
// band rule and the warps' queues, one stats partial per item). map: the
// grid as a (W, H, bins, windows) f32 tensor, box 128 x tile_h x bins x 1.
template <int KIND, int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 3 : 2)
scatter_kernel(const Args a, const __grid_constant__ CUtensorMap map) {
  constexpr bool TILED = KIND == kTiled;
  extern __shared__ __align__(128) float acc[];
  __shared__ float red[THREADS / 32][3];
  const int tid = threadIdx.x;
  const int th = a.tile_h;
  const int n4 = a.bins * th * kTileW / 4;

  for (int i = tid; i < n4; i += THREADS)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  Ahead<THREADS> ahead;
  int item = blockIdx.x;
  Item it;
  if (item < a.n_items) {
    it = locate<KIND>(a, item);
    ahead.load(a, it);
  }
  __syncthreads();

  int held = -1;                // the item whose store reads acc
  while (item < a.n_items) {
    if (held >= 0) {
      if (tid == 0) bulk_wait_read();
      __syncthreads();
      drain<THREADS, !TILED>(acc, n4, true, red);
      __syncthreads();
      if (!TILED) write_partial<THREADS>(a, red, held);
    }

    // own range: the records loaded ahead, then the rest
    const float row0 = (float)(it.ty * th), col0 = (float)(it.tx * kTileW);
    if constexpr (KIND == kBand) {
      __shared__ float4 queue[THREADS / 32][kQueue];
      BandQueue bq{queue[tid / 32], 0};
#pragma unroll
      for (int j = 0; j < Ahead<THREADS>::R; ++j)
        band_offer(bq, acc,
                   ahead.p[j] != 0.f && in_band_tile(ahead.x[j] - col0),
                   ahead.y[j] - row0, ahead.x[j] - col0, ahead.t[j],
                   ahead.p[j], a.bins, th);
      band_rest<THREADS>(a, acc, bq, it, row0, col0);
    } else {
#pragma unroll
      for (int j = 0; j < Ahead<THREADS>::R; ++j)
        if (ahead.p[j] != 0.f)
          deposit(acc, ahead.y[j] - row0, ahead.x[j] - col0, ahead.t[j],
                  ahead.p[j], a.bins, th, 0, 0);
      for (int i = it.start + kAhead + tid; i < it.end; i += THREADS) {
        const float p = a.pols[it.base + i];
        if (p == 0.f) continue;
        deposit(acc, a.ys[it.base + i] - row0, a.xs[it.base + i] - col0,
                a.tss[it.base + i], p, a.bins, th, 0, 0);
      }
    }
    if constexpr (TILED && !(VOXEL_SCATTER_SKIP & 1)) {
      const int tile = it.ty * a.n_tx + it.tx;
      const float up0 = row0 - (float)th, left0 = col0 - (float)kTileW;
      if (it.ty > 0)
        gather<THREADS, true, false>(a, acc, it, tile - a.n_tx, up0, col0);
      if (it.tx > 0)
        gather<THREADS, false, true>(a, acc, it, tile - 1, row0, left0);
      if (it.ty > 0 && it.tx > 0)
        gather<THREADS, true, true>(a, acc, it, tile - a.n_tx - 1, up0,
                                    left0);
    }
    fence_proxy_async();
    __syncthreads();

    if (tid == 0 && !(VOXEL_SCATTER_SKIP & 4)) {
      fence_proxy_async();
      store_tile(&map, acc, it.tx * kTileW, it.ty * th, it.w);
    }
    held = item;
    item += gridDim.x;
    if (item < a.n_items) {
      it = locate<KIND>(a, item);
      ahead.load(a, it);
    }
  }

  // the store must have read shared memory before the block exits; its
  // writes to the grid complete with the kernel
  if (tid == 0) bulk_wait_read();
  __syncthreads();
  if (!TILED && held >= 0) {
    drain<THREADS, true>(acc, n4, false, red);
    __syncthreads();
    write_partial<THREADS>(a, red, held);
  }
}

// The grid as a (W, H, bins, windows) f32 tensor with a 128 x tile_h x
// bins x 1 box: one box is one tile's accumulator. Returns a cudaError_t.
inline int grid_map(CUtensorMap* map, const Args& a) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t plane = (cuuint64_t)a.height * a.width * 4;
  const cuuint64_t dims[4] = {(cuuint64_t)a.width, (cuuint64_t)a.height,
                              (cuuint64_t)a.bins,
                              (cuuint64_t)(a.n_items / a.n_tiles)};
  const cuuint64_t strides[3] = {(cuuint64_t)a.width * 4, plane,
                                 plane * a.bins};
  const cuuint32_t box[4] = {kTileW, (cuuint32_t)a.tile_h,
                             (cuuint32_t)a.bins, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.grid, dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Checks the plan against the layout and launches one kernel over every
// (window, tile). Returns a cudaError_t.
template <int KIND>
int launch(const Args& a, int threads, int grid, int smem, void* stream) {
  if (a.n_items == 0) return 0;
  if (a.tile_h != tile_h_for_bins(a.bins) || a.width % kTileW ||
      a.n_tx * kTileW != a.width || a.height % a.tile_h ||
      (a.height / a.tile_h) * a.n_tx != a.n_tiles || a.bins > 256 ||
      a.n_groups != (KIND == kBand ? a.height / a.tile_h : a.n_tiles) ||
      (threads != 256 && threads != 512) ||
      smem != a.bins * a.tile_h * kRowBytes || smem > kMaxSmem ||
      grid < 1 || grid > a.n_items)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int err = grid_map(&map, a);
  if (err) return err;
  void (*kern)(const Args, const CUtensorMap) =
      threads == 256 ? scatter_kernel<KIND, 256>
                     : scatter_kernel<KIND, 512>;
  err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(a, map);
  return (int)cudaGetLastError();
}

}  // namespace scatter
}  // namespace
