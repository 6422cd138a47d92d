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
// Accumulator. Each item deposits into a dense bins x tile_h x 128
// accumulator of 64-bit integers in shared memory (row pitch 128 cells,
// 1 KB; bins * (tile_h + 1) <= 128 keeps it under 128 KB: 120 KB at 5
// bins, so one block an SM).
//
// Deposit: fixed point, so that a cell's sum is the same in any order. A
// corner's f32 value v (|v| <= 1: the polarity, pre-weighted by at most 1
// on the folded wires, times three tent weights) is rounded to the nearest
// multiple of 2^-kFracBits, or to one unit of its own sign where that is
// 0, and added to its 64-bit cell (deposit). Integer addition is
// associative, so the order in which a cell's corners arrive (which the
// threads' races decide) does not reach the sum, and two launches, or two
// processes, give the same bits. A cell's sum of n corners is at most
// n * 2^32 units, under 2^63 for any n an int can count, so no
// cell overflows (ops/voxel_scatter.py::fixed_point_bound; a pile of every
// record of a window on one cell included). The rounding moves a corner by
// at most 2^-33, far below f32's rounding of the sums it replaces; a corner
// that rounds to 0 keeps one unit, so no cell that a nonzero corner
// reaches reads 0 (the normalization counts nonzero cells). 32-bit cells
// with a per-item scale 2^(30 - bitlen(n)) fit three blocks an SM but
// round at ~1e-6: an exact CPU emulation at the DSEC shape gave 5 cells in
// 8 windows whose zero pattern differs from the plain version's, which
// moves the normalized grid by 2.7e-3 (bound 1e-4; PERF.md).
// The corner products are rounded IEEE multiplies (__fmul_rn), as the
// plain versions compute them, so no compiler contraction moves a value.
//
// Stores. After an item's scatter, one pass over the accumulator (16-byte
// shared loads) converts each cell to f32 (one rounding of the exact sum),
// stores the tile's rows to the grid as 16-byte global stores (512
// contiguous bytes a warp), reduces the tile's sum, sum of squares and
// nonzero count (one partial an item, summed per window by the caller in
// tile order: the same bits whatever the call's number of windows), and
// zeroes the cells. Every grid element
// is stored by exactly one item, empty tiles as zeros, so the grid needs no
// zero fill; nothing is added to device memory, so there are no global
// atomics and no second pass.
//
// Loads. The next item's first kAhead records (x, y, ts, pol) are loaded
// into registers right after the current item's scatter ends, so they
// arrive while the block drains its accumulator; records past the first
// kAhead are loaded on demand.
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
// Forms (template parameters; the default instantiation, NCHW and f32, is
// the code above). LAYOUT: the drain stores the tile as the NCHW grid
// (kNCHW), as the TPU kernel's raw band accumulator (kRaw: (windows,
// n_bands, bins * tile_h, width), voxelize_folded's layout='raw', B1 and
// B3-legacy) or as the space-to-depth NCHW stack (kStack: (windows,
// 4 * bins, height / 2, width / 2), channel (py * 2 + px) * bins + c,
// layout='stack', B1 only; each 4-cell group goes out as two 8-byte stores,
// one a column phase). The stats are reduced in the same loop in the same
// order whatever the layout, so every layout's partials are the same bits.
// Q8: the int8 tent planes of the TPU kernel (oh_dtype=jnp.int8): a
// corner's row and column weights are rounded to multiples of 1/127 by the
// same f32 expressions as the TPU kernel's prepass and planes, in the same
// order (deposit_q8), and the corner adds the exact integer product (at
// most 127 * 127) to its 64-bit cell; the drain scales a cell by
// fl(1 / 127^2). A corner whose product is 0 adds nothing, as in the TPU
// kernel (no unit is kept: the nonzero count is JAX's).
//
// The plan (threads, grid, shared bytes) is computed in Python
// (ess_tpu_torch/ops/voxel_scatter.py::scatter_plan) and passed in; the
// launchers recompute the layout and refuse a plan that disagrees.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Attribution builds only (tools/bench_voxel.py --attribute): leave out the
// neighbours' gathers (1), the deposits (2) or the tile stores (4).
#ifndef VOXEL_SCATTER_SKIP
#define VOXEL_SCATTER_SKIP 0
#endif

namespace {
namespace scatter {

constexpr int kTileW = 128;     // tile columns = accumulator row pitch
typedef unsigned long long Cell;   // a fixed-point cell, two's complement
constexpr int kRowBytes = kTileW * (int)sizeof(Cell);
constexpr int kFracBits = 32;      // fraction bits of a cell
constexpr float kToFixed = (float)(1ull << kFracBits);
constexpr float kFromFixed = 1.f / kToFixed;
constexpr int kAhead = 1024;    // records of the next item loaded ahead
constexpr int kMaxSmem = 232448;
constexpr float kQ = 127.f;     // INT8_SCALE of the TPU kernel
constexpr float kFromQ = 1.f / (kQ * kQ);   // one unit of an int8 cell
constexpr int kColSlot = kTileW + 8;   // B3's TPU column slot (COL_SLOT)

// Where the drain stores a tile (ops/voxel_scatter.py::LAYOUTS).
enum Layout { kNCHW = 0, kRaw = 1, kStack = 2 };

// What a work item reads: B1 its own group, B3 its own tile's and its
// neighbours' ranges, B3-legacy its band.
enum Kind { kFolded = 0, kTiled = 1, kBand = 2 };

struct Args {
  const float* xs;
  const float* ys;
  const float* tss;
  const float* pols;
  const int32_t* offsets;       // (windows, n_groups + 1)
  float* grid;                  // (windows, bins, height, width)
  float* partials;              // (windows, n_tiles, 3), or null (B3)
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

// A corner's value in fixed point: the nearest multiple of 2^-kFracBits,
// or one unit of v's sign where that is 0 (v != 0).
__device__ __forceinline__ Cell to_fixed(float v) {
  long long q = __float2ll_rn(v * kToFixed);   // exact scaling, one rounding
  if (q == 0) q = v > 0.f ? 1 : -1;
  return (Cell)q;
}

// Adds each corner's fixed-point value to its cell (null: none). The H100
// has no 64-bit shared-memory add (atomicAdd on a 64-bit cell compiles to a
// compare-and-swap loop, ATOMS.CAST.SPIN.64), but a native 32-bit one. So a
// cell's two halves take the add: a 32-bit atomicAdd of the low half that
// returns the old low word, then, where the high half or the carry out of
// the low word is not 0, an atomicAdd of (high half + carry) to the high
// word. Every wrap of the low word is counted once, in whatever order the
// corners arrive, so the cell ends at the exact 64-bit sum; the 8 corners'
// low-word adds are in flight together.
__device__ __forceinline__ void add_corners(unsigned* const (&word)[8],
                                            const Cell (&add)[8]) {
  unsigned old[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (word[k]) old[k] = atomicAdd(word[k], (unsigned)add[k]);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (!word[k]) continue;
    const unsigned lo = (unsigned)add[k];
    const unsigned up = (unsigned)(add[k] >> 32) + (old[k] + lo < old[k]);
    if (up) atomicAdd(word[k] + 1, up);
  }
}

// The up to 8 corners of one event that land in the accumulator. (yl, xl)
// are the event's coordinates in its own tile's frame; the receiving tile's
// row and column are that frame's less (dr, dq).
__device__ __forceinline__ void deposit(Cell* acc, float yl, float xl,
                                        float ts, float p, int bins, int th,
                                        int dr, int dq) {
  if (VOXEL_SCATTER_SKIP & 2) return;
  const float yf = floorf(yl), xf = floorf(xl), cf = floorf(ts);
  const float fy = __fsub_rn(yl, yf), fx = __fsub_rn(xl, xf),
              wt = __fsub_rn(ts, cf);
  const int r0 = (int)yf - dr, q0 = (int)xf - dq, c0 = (int)cf;
  const float sc[2] = {__fmul_rn(p, __fsub_rn(1.f, wt)), __fmul_rn(p, wt)};
  const float wy[2] = {__fsub_rn(1.f, fy), fy};
  const float wx[2] = {__fsub_rn(1.f, fx), fx};
  unsigned* word[8];
  Cell add[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dc = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int c = c0 + dc, r = r0 + dy, q = q0 + dx;
    const float v = __fmul_rn(__fmul_rn(sc[dc], wy[dy]), wx[dx]);
    const bool ok = c >= 0 && c < bins && r >= 0 && r < th && q >= 0 &&
                    q < kTileW && v != 0.f;
    word[k] = ok ? reinterpret_cast<unsigned*>(acc + (c * th + r) * kTileW +
                                               q)
                 : nullptr;
    add[k] = ok ? to_fixed(v) : 0ull;
  }
  add_corners(word, add);
}

// The int8 form of deposit: the TPU kernel's quantized tent planes
// (ess_tpu/ops/voxel_pallas.py: the prepasses :560-585 of voxelize_tiled
// and :1096-1111 of voxelize_folded, the planes :308-316 of _kernel and
// :463-470 of _kernel_slotted), each weight the same f32 expression:
//   scales   s_c = pol * (1 - wt) or pol * wt, times 1 + yl first where
//            yl < 0 (B3's wy_fold, the row then 0), times 127;
//   rows     p0 = c0 * gap + yl (gap: tile_h, B3 tile_h + 1), yl' = p0 -
//            c0 * gap; the tent 1 - |r - yl'| of the factored row plane
//            (gap % 8 == 0), in the tall form (B3, 10 bins) 1 - |(c0 + 1) *
//            gap + r - p0 - gap| for the second bin; times s_c, rounded;
//   columns  cx = fl(cb + xl) * 127 at the TPU kernel's global column base
//            cb (B1 and B3-legacy: band * width + tile column; B3: tile id
//            * COL_SLOT), the tent 127 - |127 * (cb + q) - cx|, rounded
//            (127 * (cb + q) is an exact integer);
// rounding half to even as jnp.round. A corner adds qy * qx.
__device__ __forceinline__ void deposit_q8(Cell* acc, float yl, float xl,
                                           float ts, float p, int bins,
                                           int th, int dr, int dq, int gap,
                                           float cb) {
  if (VOXEL_SCATTER_SKIP & 2) return;
  const float cf = floorf(ts);
  const float wt = __fsub_rn(ts, cf);
  float s0 = __fmul_rn(p, __fsub_rn(1.f, wt)), s1 = __fmul_rn(p, wt);
  if (yl < 0.f) {
    const float fold = __fadd_rn(1.f, yl);
    s0 = __fmul_rn(s0, fold);
    s1 = __fmul_rn(s1, fold);
    yl = 0.f;
  }
  const float sq[2] = {__fmul_rn(s0, kQ), __fmul_rn(s1, kQ)};
  const float g = (float)gap;
  const float cg = __fmul_rn(cf, g);              // exact
  const float p0 = __fadd_rn(cg, yl);
  const float ylq = __fsub_rn(p0, cg);            // exact
  const float yf = floorf(ylq), xf = floorf(xl);
  const float cx = __fmul_rn(__fadd_rn(cb, xl), kQ);
  int qy[2][2], qx[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float col = __fmul_rn(__fadd_rn(cb, xf + (float)d), kQ);
    qx[d] = __float2int_rn(
        fmaxf(0.f, __fsub_rn(kQ, fabsf(__fsub_rn(col, cx)))));
    const float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(
                                    yf + (float)d, ylq))));
    float w1 = w0;
    if (gap % 8) {
      const float row = __fadd_rn(__fmul_rn(cf + 1.f, g), yf + (float)d);
      w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(__fsub_rn(row, p0),
                                                      g))));
    }
    qy[0][d] = __float2int_rn(__fmul_rn(w0, sq[0]));
    qy[1][d] = __float2int_rn(__fmul_rn(w1, sq[1]));
  }
  const int r0 = (int)yf - dr, q0 = (int)xf - dq, c0 = (int)cf;
  unsigned* word[8];
  Cell add[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dc = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const int c = c0 + dc, r = r0 + dy, q = q0 + dx;
    const int v = qy[dc][dy] * qx[dx];
    const bool ok = c >= 0 && c < bins && r >= 0 && r < th && q >= 0 &&
                    q < kTileW && v != 0;
    word[k] = ok ? reinterpret_cast<unsigned*>(acc + (c * th + r) * kTileW +
                                               q)
                 : nullptr;
    add[k] = ok ? (Cell)(long long)v : 0ull;
  }
  add_corners(word, add);
}

// deposit or deposit_q8; (gap, cb) as deposit_q8's.
template <bool Q8>
__device__ __forceinline__ void put(Cell* acc, float yl, float xl, float ts,
                                    float p, int bins, int th, int dr,
                                    int dq, int gap, float cb) {
  if constexpr (Q8)
    deposit_q8(acc, yl, xl, ts, p, bins, th, dr, dq, gap, cb);
  else
    deposit(acc, yl, xl, ts, p, bins, th, dr, dq);
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
template <int THREADS, bool UP, bool LEFT, bool Q8>
__device__ __forceinline__ void gather(const Args& a, Cell* acc,
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
      put<Q8>(acc, yl, xl, a.tss[i], p, a.bins, th, UP ? th : 0,
              LEFT ? kTileW : 0, th + 1, (float)(tile * kColSlot));
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
// each lane deposits one. Called by the whole warp. cb: the tile's column
// base (deposit_q8).
template <bool Q8>
__device__ __forceinline__ void band_offer(BandQueue& bq, Cell* acc,
                                           bool keep, float yl, float xl,
                                           float t, float p, int bins,
                                           int th, float cb) {
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
    put<Q8>(acc, r.x, r.y, r.z, r.w, bins, th, 0, 0, th, cb);
    __syncwarp();
  }
}

// The records still waiting, one a lane.
template <bool Q8>
__device__ __forceinline__ void band_flush(BandQueue& bq, Cell* acc,
                                           int bins, int th, float cb) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (lane < bq.n) {
    const float4 r = bq.q[lane];
    put<Q8>(acc, r.x, r.y, r.z, r.w, bins, th, 0, 0, th, cb);
  }
  bq.n = 0;
  __syncwarp();
}

// B3-legacy: the records of the item's band past those loaded ahead, U a
// lane at a time with all four fields' loads in flight together (from L2
// after the band's first tile; loading y, ts and pol only after x passed
// put two dependent load latencies on every kept record), offered to the
// warp's queue. The loop runs warp-uniform rounds (the queue's ballots).
template <int THREADS, bool Q8>
__device__ __forceinline__ void band_rest(const Args& a, Cell* acc,
                                          BandQueue& bq, const Item& it,
                                          float row0, float col0, float cb) {
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
      band_offer<Q8>(bq, acc, p[u] != 0.f && in_band_tile(xl[u]), yl[u],
                     xl[u], t[u], p[u], a.bins, a.tile_h, cb);
  }
  band_flush<Q8>(bq, acc, a.bins, a.tile_h, cb);
}

// One pass over an item's accumulator: each thread takes 4 cells at a time
// (two 16-byte shared loads), converts them to f32, stores them to the grid
// as one 16-byte store (a warp: one 512-byte tile row; kStack: two 8-byte
// stores, one a column phase), adds them to the tile's stats and zeroes
// them. Each warp leaves its sums in red[warp].
template <int THREADS, int LAYOUT, bool Q8>
__device__ __forceinline__ void drain(const Args& a, const Item& it,
                                      Cell* acc, float (*red)[3]) {
  constexpr float kScale = Q8 ? kFromQ : kFromFixed;
  const int th = a.tile_h;
  const int n4 = a.bins * th * kTileW / 4;
  ulonglong2* a2 = reinterpret_cast<ulonglong2*>(acc);
  float* g0;
  if constexpr (LAYOUT == kNCHW)
    g0 = a.grid + (int64_t)it.w * a.bins * a.height * a.width +
         (int64_t)it.ty * th * a.width + it.tx * kTileW;
  else if constexpr (LAYOUT == kRaw)     // (w, band, c * th + r, x)
    g0 = a.grid + ((int64_t)it.w * (a.height / th) + it.ty) * a.bins * th *
                      a.width + it.tx * kTileW;
  else                                   // (w, (py * 2 + px) * bins + c,
    g0 = a.grid + (int64_t)it.w * 4 * a.bins * (a.height / 2) *  // Y, X)
                      (a.width / 2) +
         (int64_t)it.ty * (th / 2) * (a.width / 2) + it.tx * (kTileW / 2);
  float s = 0.f, sq = 0.f, nz = 0.f;
  for (int i = threadIdx.x; i < n4; i += THREADS) {
    const ulonglong2 u = a2[2 * i], w = a2[2 * i + 1];
    const float4 v = make_float4(
        __ll2float_rn((long long)u.x) * kScale,
        __ll2float_rn((long long)u.y) * kScale,
        __ll2float_rn((long long)w.x) * kScale,
        __ll2float_rn((long long)w.y) * kScale);
    a2[2 * i] = a2[2 * i + 1] = make_ulonglong2(0ull, 0ull);
    const int row = i / (kTileW / 4), c = row / th;
    if (!(VOXEL_SCATTER_SKIP & 4)) {
      if constexpr (LAYOUT == kNCHW) {
        *reinterpret_cast<float4*>(
            g0 + ((int64_t)c * a.height + row - c * th) * a.width +
            (i % (kTileW / 4)) * 4) = v;
      } else if constexpr (LAYOUT == kRaw) {
        *reinterpret_cast<float4*>(g0 + (int64_t)row * a.width +
                                   (i % (kTileW / 4)) * 4) = v;
      } else {
        // cells (r, q .. q + 3): row phase r & 1, columns q / 2, q / 2 + 1
        // of the phases px = 0 (v.x, v.z) and px = 1 (v.y, v.w)
        const int r = row - c * th;
        const int64_t plane = (int64_t)(a.height / 2) * (a.width / 2);
        float* d = g0 + ((r & 1) * 2 * a.bins + c) * plane +
                   (int64_t)(r >> 1) * (a.width / 2) + (i % (kTileW / 4)) * 2;
        *reinterpret_cast<float2*>(d) = make_float2(v.x, v.z);
        *reinterpret_cast<float2*>(d + a.bins * plane) =
            make_float2(v.y, v.w);
      }
    }
    {
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
  }
  {
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

// Threads 0..2 sum the warps' stats of one item into its partial, in warp
// order (where the caller asked for partials).
template <int THREADS>
__device__ __forceinline__ void write_partial(const Args& a,
                                              float (*red)[3], int item) {
  if (threadIdx.x < 3) {
    float t = 0.f;
    for (int k = 0; k < THREADS / 32; ++k) t += red[k][threadIdx.x];
    a.partials[(int64_t)item * 3 + threadIdx.x] = t;
  }
}

// KIND: B1 (own range only), B3 (gather from the neighbours' ranges) or
// B3-legacy (the band's range with the band rule and the warps' queues);
// each item's stats partial where a.partials is not null. LAYOUT and Q8:
// the forms (header).
template <int KIND, int THREADS, int LAYOUT, bool Q8>
__global__ void __launch_bounds__(THREADS, THREADS == 256 ? 2 : 1)
scatter_kernel(const Args a) {
  constexpr bool TILED = KIND == kTiled;
  extern __shared__ __align__(128) Cell acc[];
  __shared__ float red[THREADS / 32][3];
  const int tid = threadIdx.x;
  const int th = a.tile_h;
  const int n2 = a.bins * th * kTileW / 2;

  for (int i = tid; i < n2; i += THREADS)
    reinterpret_cast<ulonglong2*>(acc)[i] = make_ulonglong2(0ull, 0ull);
  Ahead<THREADS> ahead;
  int item = blockIdx.x;
  Item it;
  if (item < a.n_items) {
    it = locate<KIND>(a, item);
    ahead.load(a, it);
  }
  __syncthreads();

  while (item < a.n_items) {
    // own range: the records loaded ahead, then the rest
    const float row0 = (float)(it.ty * th), col0 = (float)(it.tx * kTileW);
    // deposit_q8's row gap and the own records' column base
    const int gap = TILED ? th + 1 : th;
    const float cb = TILED ? (float)((it.ty * a.n_tx + it.tx) * kColSlot)
                           : (float)(it.ty * a.width + it.tx * kTileW);
    if constexpr (KIND == kBand) {
      __shared__ float4 queue[THREADS / 32][kQueue];
      BandQueue bq{queue[tid / 32], 0};
#pragma unroll
      for (int j = 0; j < Ahead<THREADS>::R; ++j)
        band_offer<Q8>(bq, acc,
                       ahead.p[j] != 0.f && in_band_tile(ahead.x[j] - col0),
                       ahead.y[j] - row0, ahead.x[j] - col0, ahead.t[j],
                       ahead.p[j], a.bins, th, cb);
      band_rest<THREADS, Q8>(a, acc, bq, it, row0, col0, cb);
    } else {
#pragma unroll
      for (int j = 0; j < Ahead<THREADS>::R; ++j)
        if (ahead.p[j] != 0.f)
          put<Q8>(acc, ahead.y[j] - row0, ahead.x[j] - col0, ahead.t[j],
                  ahead.p[j], a.bins, th, 0, 0, gap, cb);
      for (int i = it.start + kAhead + tid; i < it.end; i += THREADS) {
        const float p = a.pols[it.base + i];
        if (p == 0.f) continue;
        put<Q8>(acc, a.ys[it.base + i] - row0, a.xs[it.base + i] - col0,
                a.tss[it.base + i], p, a.bins, th, 0, 0, gap, cb);
      }
    }
    if constexpr (TILED && !(VOXEL_SCATTER_SKIP & 1)) {
      const int tile = it.ty * a.n_tx + it.tx;
      const float up0 = row0 - (float)th, left0 = col0 - (float)kTileW;
      if (it.ty > 0)
        gather<THREADS, true, false, Q8>(a, acc, it, tile - a.n_tx, up0,
                                         col0);
      if (it.tx > 0)
        gather<THREADS, false, true, Q8>(a, acc, it, tile - 1, row0, left0);
      if (it.ty > 0 && it.tx > 0)
        gather<THREADS, true, true, Q8>(a, acc, it, tile - a.n_tx - 1, up0,
                                        left0);
    }
    __syncthreads();

    // the next item's records load while this one drains
    const Item done = it;
    const int done_item = item;
    item += gridDim.x;
    if (item < a.n_items) {
      it = locate<KIND>(a, item);
      ahead.load(a, it);
    }
    drain<THREADS, LAYOUT, Q8>(a, done, acc, red);
    __syncthreads();
    if (a.partials) write_partial<THREADS>(a, red, done_item);
  }
}

// The kernel of a form and block size: null where the form does not exist
// for KIND (kRaw: B1 and B3-legacy; kStack: B1).
template <int KIND, int LAYOUT, bool Q8>
void (*form_kernel(int threads))(const Args) {
  if constexpr ((LAYOUT == kRaw && KIND == kTiled) ||
                (LAYOUT == kStack && KIND != kFolded))
    return nullptr;
  else
    return threads == 256 ? scatter_kernel<KIND, 256, LAYOUT, Q8>
                          : scatter_kernel<KIND, 512, LAYOUT, Q8>;
}

template <int KIND, bool Q8>
void (*kernel_for(int layout, int threads))(const Args) {
  switch (layout) {
    case kNCHW: return form_kernel<KIND, kNCHW, Q8>(threads);
    case kRaw: return form_kernel<KIND, kRaw, Q8>(threads);
    case kStack: return form_kernel<KIND, kStack, Q8>(threads);
    default: return nullptr;
  }
}

// Checks the plan against the layout and launches one kernel over every
// (window, tile) in the form asked for (layout, q8: the int8 tent planes).
// Returns a cudaError_t.
template <int KIND>
int launch(const Args& a, int threads, int grid, int smem, void* stream,
           int layout, int q8) {
  if (a.n_items == 0) return 0;
  if (a.tile_h != tile_h_for_bins(a.bins) || a.width % kTileW ||
      a.n_tx * kTileW != a.width || a.height % a.tile_h ||
      (a.height / a.tile_h) * a.n_tx != a.n_tiles || a.bins > 256 ||
      a.n_groups != (KIND == kBand ? a.height / a.tile_h : a.n_tiles) ||
      (threads != 256 && threads != 512) ||
      smem != a.bins * a.tile_h * kRowBytes || smem > kMaxSmem ||
      grid < 1 || grid > a.n_items || a.tile_h % 2)
    return (int)cudaErrorInvalidValue;
  void (*kern)(const Args) = q8 ? kernel_for<KIND, true>(layout, threads)
                                : kernel_for<KIND, false>(layout, threads);
  if (!kern) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace scatter
}  // namespace
