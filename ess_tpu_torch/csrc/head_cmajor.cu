// E2VID head conv on a C-major space-to-depth window, normalize fused (T1).
//
// Replaces the TPU kernel tools/bench_head.py::kern (built by make_pallas,
// pallas_call at :133): a 3x3 SAME conv over the 2x2 space-to-depth window
// (20 -> 128 channels for 5 bins and a 32-channel head) read straight from
// the channel-major (NCHW) layout the voxelizers write, with the per-window
// nonzero normalize applied to every input value on the way in:
//   v -> where(v != 0, (v - shift) * scale, 0), f32, rounded once to bf16,
// then f32 accumulation of bf16 products, + bias, ReLU, one rounding to
// bf16, stored NHWC or NCHW. The TPU kernel builds 180 (th, W) plane copies
// and contracts their outer dimension; none of that is carried over.
//
// Bounds on the H100 at B=8, 220x320: 22.5 MB read and 144.2 MB written
// (0.050 ms at 3.35 TB/s) for 25.9 GFLOP (0.026 ms at 989 TFLOP/s): the
// output bytes bound it.
//
// Design: the halo-tile core of conv_halo.cuh with a C-major loader. Per
// pixel tile (8 x 16 pixels x 128 channels a block):
// 1. every channel plane's halo rows are staged raw with aligned 16-byte
//    cp.async copies: the span starts at the 8-pixel boundary left of the
//    halo (x0 - 8) and ends at the one right of it, and the normalize pass
//    indexes the shift; outside the image the copies zero-fill. Where W is
//    not a multiple of 8 (rows not 16-byte aligned), the pass reads the
//    values from device memory itself.
// 2. one pass over the staged values normalizes each value once with
//    __fsub_rn / __fmul_rn (no contraction into a fused multiply-add, the
//    plain version's rounding, v != 0 kept), rounds it once to bf16 and
//    writes the pixel-major halo tile that the core's ldmatrix reads; the
//    channels CIN..31 are zero. The zero fill of the padding is exact: the
//    plain version pads after the normalize, and the normalize maps 0 to 0.
// 3. the nine taps as shifted ldmatrix rows into wgmma (K padded 20 -> 32
//    per tap), resident weights (74 KB, loaded once per persistent block),
//    and the per-warp epilogue in NHWC or NCHW (runs of 16 pixels along W).
// The next tile's raw rows are copied while this tile multiplies and stores.

#include "conv_halo.cuh"

namespace {

using namespace ess::halo;

template <int MT, int BN, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks<BN>)
head_halo_kernel(const __nv_bfloat16* __restrict__ x,   // (B, CIN, H, W)
                 const unsigned char* __restrict__ w,   // (COUT, 9*kKC)
                 const float* __restrict__ bias,        // (COUT,)
                 __nv_bfloat16* __restrict__ out,       // NHWC or NCHW
                 int H, int W, int CIN, int COUT, float shift, float scale,
                 int nchw_out, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = p.tw + 2, hh = p.th + 2, npix = hh * hw;
  const int span = p.tw + 16;                 // staged raw row, pixels
  const int n0 = blockIdx.y * BN;
  // [weights][halo][raw rows, kAligned only][epilogue slots]
  unsigned char* halo = smem + BN * kWRowBytes;
  __nv_bfloat16* raw =
      reinterpret_cast<__nv_bfloat16*>(halo + npix * kPixBytes);
  unsigned char* slot = reinterpret_cast<unsigned char*>(raw) +
                        (kAligned ? CIN * hh * span * 2 : 0) +
                        warp * (nchw_out ? kStageNchw : kStageNhwc);

  const int T = my_tiles(p);
  if (T == 0) return;

  auto load_raw = [&](int t) {
    const TilePos tp = tile_pos(p, t);
    const int cpr = span / 8;
    for (int c = tid; c < CIN * hh * cpr; c += kThreads) {
      const int j = c % cpr, r = c / cpr;
      const int hr = r % hh, ch = r / hh;
      const int y = tp.y0 - 1 + hr, xs = tp.x0 - 8 + j * 8;
      const bool ok = y >= 0 && y < H && xs >= 0 && xs < W;
      const __nv_bfloat16* src =
          x + (((int64_t)tp.b * CIN + ch) * H + y) * W + xs;
      ess::cp_async_zfill<16>(raw + (r * span + j * 8), ok ? src : x, ok);
    }
  };

  // raw (or device memory) -> normalized bf16, pixel-major halo tile
  auto normalize = [&](int t) {
    const TilePos tp = tile_pos(p, t);
    for (int c = tid; c < 4 * npix; c += kThreads) {
      const int grp = c / npix, px = c - grp * npix;
      const int hr = px / hw, hc = px - hr * hw;
      const int y = tp.y0 - 1 + hr, xx = tp.x0 - 1 + hc;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
      unsigned packed[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        float f[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = grp * 8 + j + e;
          float v = 0.f;
          if (ch < CIN) {
            if constexpr (kAligned)
              v = __bfloat162float(raw[(ch * hh + hr) * span + hc + 7]);
            else if (in)
              v = __bfloat162float(
                  x[(((int64_t)tp.b * CIN + ch) * H + y) * W + xx]);
          }
          f[e] = v != 0.f ? __fmul_rn(__fsub_rn(v, shift), scale) : 0.f;
        }
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(f[0], f[1]);
        packed[j / 2] = *reinterpret_cast<const unsigned*>(&b2);
      }
      *reinterpret_cast<uint4*>(halo + px * kPixBytes + grp * 16) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  };

  load_weights<BN>(smem, w, n0, COUT, kKC, 0);
  if (kAligned) load_raw(blockIdx.x);
  ess::cp_async_commit();

  const Frag<MT> f(p.tw, warp, lane);
  float acc[MT][BN / 8][4];

  for (int i = 0; i < T; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    ess::cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();          // raw rows landed; the last tile's taps done
    normalize(t);
    __syncthreads();          // halo ready; raw rows free
    if (kAligned && i + 1 < T) load_raw(t + gridDim.x);
    ess::cp_async_commit();
    zero(acc);
    mma_chunk<MT, BN>(acc, halo, smem, f);
    store_tile(acc, nullptr, bias, 1, nchw_out, slot, out, tile_pos(p, t),
               p.tw, H, W, COUT, n0, warp, lane);
  }
  ess::cp_async_wait<0>();
}

template <int MT, int BN, bool kAligned>
int launch(const void* x, const void* w, const void* bias, void* out, int H,
           int W, int CIN, int COUT, float shift, float scale, int nchw_out,
           const Plan& p, int grid_x, int smem, void* stream) {
  if (p.th * p.tw != Cfg<MT, BN>::BM || p.tw % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int want = BN * kWRowBytes + (p.th + 2) * (p.tw + 2) * kPixBytes +
                   (kAligned ? CIN * (p.th + 2) * (p.tw + 16) * 2 : 0) +
                   kWarps * (nchw_out ? kStageNchw : kStageNhwc);
  if (smem != want) return (int)cudaErrorInvalidValue;
  auto kern = head_halo_kernel<MT, BN, kAligned>;
  int err = prepare_launch(kern, smem);
  if (err) return err;
  dim3 grid(grid_x, (COUT + BN - 1) / BN);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const unsigned char*)w, (const float*)bias,
      (__nv_bfloat16*)out, H, W, CIN, COUT, shift, scale, nchw_out, p);
  return (int)cudaGetLastError();
}

template <int MT, int BN>
int launch_aligned(const void* x, const void* w, const void* bias, void* out,
                   int H, int W, int CIN, int COUT, float shift, float scale,
                   int nchw_out, int aligned, const Plan& p, int grid_x,
                   int smem, void* stream) {
  if (aligned)
    return launch<MT, BN, true>(x, w, bias, out, H, W, CIN, COUT, shift,
                                scale, nchw_out, p, grid_x, smem, stream);
  return launch<MT, BN, false>(x, w, bias, out, H, W, CIN, COUT, shift, scale,
                               nchw_out, p, grid_x, smem, stream);
}

}  // namespace

// x: bf16 (B, CIN, H, W) contiguous, CIN <= 32; with `aligned` (W a
// multiple of 8, x 16-byte aligned) its rows are copied with 16-byte
// cp.async. w: bf16 (COUT, 9*32) with column (dy*3 + dx)*32 + cin, zero for
// cin >= CIN, 16-byte aligned; bias: f32 (COUT,); out: bf16 (B, H, W, COUT)
// or, with nchw_out, (B, COUT, H, W), 16-byte aligned; COUT a multiple of
// 8. The plan (th, tw, grid_x, smem) is ops/conv_halo.py::head_plan's.
extern "C" int ess_head_cmajor(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int CIN,
                               int COUT, float shift, float scale,
                               int nchw_out, int aligned, int th, int tw,
                               int grid_x, int smem, void* stream) {
  if ((int64_t)B * H * W == 0 || COUT == 0) return 0;
  if (CIN <= 0 || CIN > kKC || COUT % 8 != 0 || th <= 0 || tw <= 0 ||
      grid_x <= 0 || (aligned && W % 8 != 0))
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.th = th;
  p.tw = tw;
  p.tiles_y = (H + th - 1) / th;
  p.tiles_x = (W + tw - 1) / tw;
  p.n_tiles = B * p.tiles_y * p.tiles_x;
  p.resident = 1;
  if (COUT > 64)
    return launch_aligned<1, 128>(x, w, bias, out, H, W, CIN, COUT, shift,
                                  scale, nchw_out, aligned, p, grid_x,
                                  smem, stream);
  if (COUT > 32)
    return launch_aligned<2, 64>(x, w, bias, out, H, W, CIN, COUT, shift,
                                 scale, nchw_out, aligned, p, grid_x,
                                 smem, stream);
  return launch_aligned<2, 32>(x, w, bias, out, H, W, CIN, COUT, shift, scale,
                               nchw_out, aligned, p, grid_x, smem,
                               stream);
}
