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
// Design: conv_halo.cuh::conv3x3_halo_kernel<false>, the halo-tile core
// with an NHWC loader (B4-int8 is the same kernel with s8 operands). Per
// pixel tile and channel chunk of 32, the (TH+2) x (TW+2) halo is copied
// once with cp.async (VECB = 16 or 8 bytes, the largest that divides a
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

// x: bf16 NHWC (B, H, W, CIN), CIN a multiple of 4; w: bf16 (COUT, 9*CP)
// with CP = CIN rounded up to 32; bias: f32 (COUT,); out: bf16 NHWC
// (B, H, W, COUT), COUT a multiple of 8. All 16-byte aligned. The plan
// (th, tw, resident, grid_x, smem) is ops/conv_halo.py::conv_plan's.
extern "C" int ess_conv3x3(const void* x, const void* w, const void* bias,
                           void* out, int B, int H, int W, int CIN, int COUT,
                           int relu, int th, int tw, int resident, int grid_x,
                           int smem, void* stream) {
  return ess::halo::conv_launch<false>(x, w, nullptr, nullptr, bias, out, B,
                                       H, W, CIN, COUT, relu, th, tw,
                                       resident, 0, grid_x, smem, stream);
}
