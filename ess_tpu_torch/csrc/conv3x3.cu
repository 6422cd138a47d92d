// Fused 3x3 SAME conv + bias + optional ReLU over NHWC, exact bf16 (B4).
//
// Replaces the TPU kernel ess_tpu/ops/conv3x3_pallas.py::_conv_kernel
// (bf16 variant): the E2VID head conv and the first encoder's stride-2 conv
// of the block-space rollout, both exact 3x3 convs over space-to-depth
// blocks (head: 20 -> 128 channels, encoder 0: 128 -> 64, at 220x320 for
// DSEC). The TPU kernel copies a row tile and its halo rows into VMEM,
// builds a lane-padded im2row buffer and runs one deep matrix product; none
// of that is carried over.
//
// Bounds on the H100 at B=8: the head conv moves 22.5 MB in and 144.2 MB
// out for 26 GFLOP, so bytes bound it (0.050 ms); encoder 0 reads 144.2 MB,
// writes 72.1 MB and does 83 GFLOP, bound by operations (0.084 ms).
//
// Design: the halo-tile core of conv_halo.cuh with an NHWC loader. Per
// pixel tile and channel chunk of 32, the (TH+2) x (TW+2) halo is copied
// once with cp.async (VECB = 16, 8 or 4 bytes, the largest that divides a
// pixel's CIN*2 bytes: the head's 20 channels are 40 bytes, which also rules
// out TMA), zero-filled outside the image and past CIN; all nine taps read
// it through shifted ldmatrix rows. For encoder 0 (8 x 32 pixels x 64
// channels a block) the input is read from L2 1.33 times instead of 9 times
// per N tile, and each warpgroup's wgmma covers all 64 of C_out. Weights: all
// chunks resident in shared memory when they fit beside two halo stages
// (both DSEC convs: 147 KB for encoder 0, 74 KB for the head), else
// streamed chunk by chunk with the halo. Blocks are persistent, so the
// resident weights are loaded once per block and the head's 144 MB of
// output is written by a per-warp epilogue while the next tile's halo
// arrives. K per tap is still padded to 32 channels: the head conv
// multiplies 288 columns for its 180.

#include "conv_halo.cuh"

namespace {

using namespace ess::halo;

template <int MT, int BN, int VECB>
__global__ void __launch_bounds__(kThreads, kMinBlocks<BN>)
conv3x3_halo_kernel(const unsigned char* __restrict__ x,   // NHWC bf16
                    const unsigned char* __restrict__ w,   // (COUT, 9*CP)
                    const float* __restrict__ bias,        // (COUT,)
                    __nv_bfloat16* __restrict__ out,       // NHWC
                    int H, int W, int CINB, int COUT, int CP, int relu,
                    Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = CP / kKC;
  const int hw = p.tw + 2, npix = (p.th + 2) * hw;
  const int halo_bytes = npix * kPixBytes;
  constexpr int wchunk = BN * kWRowBytes;
  const int n0 = blockIdx.y * BN;
  // resident: [weights, every chunk][halo 0][halo 1][epilogue slots]
  // streamed: [weights 0][halo 0][weights 1][halo 1][epilogue slots]
  const int stage_bytes = p.resident ? halo_bytes : wchunk + halo_bytes;
  unsigned char* ring = smem + (p.resident ? chunks * wchunk : 0);
  unsigned char* slot = ring + 2 * stage_bytes + warp * kStageNhwc;

  const int G = my_tiles(p) * chunks;
  if (G == 0) return;

  // stage g: pixel tile g / chunks of this block, chunk g % chunks
  auto issue = [&](int g) {
    const int k = g % chunks;
    const TilePos tp = tile_pos(p, blockIdx.x + (g / chunks) * gridDim.x);
    unsigned char* stage = ring + (g & 1) * stage_bytes;
    unsigned char* dst = p.resident ? stage : stage + wchunk;
    constexpr int PER = 64 / VECB;            // copies per pixel and chunk
    for (int c = tid; c < npix * PER; c += kThreads) {
      const int px = c / PER, j = c % PER;
      const int hr = px / hw, hc = px - hr * hw;
      const int y = tp.y0 - 1 + hr, xx = tp.x0 - 1 + hc;
      const int cb = k * 64 + j * VECB;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W && cb < CINB;
      const unsigned char* src =
          x + (((int64_t)tp.b * H + y) * W + xx) * CINB + cb;
      ess::cp_async_zfill<VECB>(dst + px * kPixBytes + j * VECB,
                                ok ? src : x, ok);
    }
    if (!p.resident) load_weights<BN>(stage, w, n0, COUT, CP, k);
  };

  if (p.resident)
    for (int k = 0; k < chunks; ++k)
      load_weights<BN>(smem + k * wchunk, w, n0, COUT, CP, k);
  issue(0);
  ess::cp_async_commit();

  const Frag<MT> f(p.tw, warp, lane);
  float acc[MT][BN / 8][4];

  for (int g = 0; g < G; ++g) {
    const int k = g % chunks;
    ess::cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();          // stage g landed; stage g+1's buffer is free
    if (g + 1 < G) issue(g + 1);
    ess::cp_async_commit();
    if (k == 0) zero(acc);
    const unsigned char* stage = ring + (g & 1) * stage_bytes;
    if (p.resident)
      mma_chunk<MT, BN>(acc, stage, smem + k * wchunk, f);
    else
      mma_chunk<MT, BN>(acc, stage + wchunk, stage, f);
    if (k == chunks - 1)
      store_tile(acc, bias, relu, 0, slot, out,
                 tile_pos(p, blockIdx.x + (g / chunks) * gridDim.x), p.tw, H,
                 W, COUT, n0, warp, lane);
  }
  ess::cp_async_wait<0>();
}

template <int MT, int BN, int VECB>
int launch(const void* x, const void* w, const void* bias, void* out, int H,
           int W, int CINB, int COUT, int CP, int relu, const Plan& p,
           int grid_x, int smem, void* stream) {
  if (p.th * p.tw != Cfg<MT, BN>::BM || p.tw % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = CP / kKC;
  const int halo_bytes = (p.th + 2) * (p.tw + 2) * kPixBytes;
  const int wchunk = BN * kWRowBytes;
  const int want = (p.resident ? chunks * wchunk + 2 * halo_bytes
                               : 2 * (halo_bytes + wchunk)) +
                   kWarps * kStageNhwc;
  if (smem != want) return (int)cudaErrorInvalidValue;
  auto kern = conv3x3_halo_kernel<MT, BN, VECB>;
  int err = prepare_launch(kern, smem);
  if (err) return err;
  dim3 grid(grid_x, (COUT + BN - 1) / BN);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)x, (const unsigned char*)w, (const float*)bias,
      (__nv_bfloat16*)out, H, W, CINB, COUT, CP, relu, p);
  return (int)cudaGetLastError();
}

template <int MT, int BN>
int launch_vec(const void* x, const void* w, const void* bias, void* out,
               int H, int W, int CINB, int COUT, int CP, int relu,
               const Plan& p, int grid_x, int smem, void* stream) {
  if (CINB % 16 == 0)
    return launch<MT, BN, 16>(x, w, bias, out, H, W, CINB, COUT, CP, relu, p,
                              grid_x, smem, stream);
  if (CINB % 8 == 0)
    return launch<MT, BN, 8>(x, w, bias, out, H, W, CINB, COUT, CP, relu, p,
                             grid_x, smem, stream);
  return launch<MT, BN, 4>(x, w, bias, out, H, W, CINB, COUT, CP, relu, p,
                           grid_x, smem, stream);
}

}  // namespace

// x: bf16 NHWC (B, H, W, CIN), CIN a multiple of 4; w: bf16 (COUT, 9*CP)
// with CP = CIN rounded up to 32; bias: f32 (COUT,); out: bf16 NHWC
// (B, H, W, COUT), COUT a multiple of 8. All 16-byte aligned. The plan
// (th, tw, resident, grid_x, smem) is ops/conv_halo.py::conv_plan's.
extern "C" int ess_conv3x3(const void* x, const void* w, const void* bias,
                           void* out, int B, int H, int W, int CIN, int COUT,
                           int relu, int th, int tw, int resident, int grid_x,
                           int smem, void* stream) {
  if ((int64_t)B * H * W == 0 || COUT == 0) return 0;
  if (CIN <= 0 || CIN % 4 != 0 || COUT % 8 != 0 || th <= 0 || tw <= 0 ||
      grid_x <= 0)
    return (int)cudaErrorInvalidValue;
  const int CP = (CIN + kKC - 1) / kKC * kKC;
  Plan p;
  p.th = th;
  p.tw = tw;
  p.tiles_y = (H + th - 1) / th;
  p.tiles_x = (W + tw - 1) / tw;
  p.n_tiles = B * p.tiles_y * p.tiles_x;
  p.resident = resident;
  if (COUT > 64)
    return launch_vec<1, 128>(x, w, bias, out, H, W, CIN * 2, COUT, CP, relu,
                              p, grid_x, smem, stream);
  if (COUT > 32)
    return launch_vec<2, 64>(x, w, bias, out, H, W, CIN * 2, COUT, CP, relu,
                             p, grid_x, smem, stream);
  return launch_vec<2, 32>(x, w, bias, out, H, W, CIN * 2, COUT, CP, relu, p,
                           grid_x, smem, stream);
}
