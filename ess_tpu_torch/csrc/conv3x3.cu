// Fused 3x3 SAME conv + bias + optional ReLU over NHWC, exact bf16.
//
// Replaces the TPU kernel ess_tpu/ops/conv3x3_pallas.py::_conv_kernel
// (bf16 variant): the E2VID head conv and the first encoder's stride-2 conv
// of the block-space rollout, both exact 3x3 convs over space-to-depth
// blocks (head: 20 -> 128 channels, encoder 0: 128 -> 64, at 220x320 for
// DSEC). The TPU kernel copies a row tile and its halo rows into VMEM,
// builds a lane-padded im2row buffer and runs one deep matrix product; none
// of that is carried over. Here the same product runs as the implicit GEMM
// of conv3x3_common.cuh: bf16 operands read straight from device memory
// into a cp.async ring, mma.sync m16n8k16 with f32 accumulators, bias and
// ReLU on the accumulator, one rounding to bf16.
//
// Bounds on the H100 at B=8: the head conv moves 22.5 MB in and 144.2 MB
// out for 26 GFLOP, so bytes bound it (0.050 ms) and the coalesced output
// stores matter most; encoder 0 reads 144.2 MB, writes 72.1 MB and does
// 83 GFLOP, bound by operations (0.084 ms). K per tap is padded to 32
// channels, so the head conv multiplies 288 columns for its 180.

#include "conv3x3_common.cuh"

// x: bf16 NHWC (B, H, W, CIN), CIN a multiple of 4; w: bf16 (COUT, 9*CP)
// with CP = CIN rounded up to 32; bias: f32 (COUT,); out: bf16 NHWC
// (B, H, W, COUT), COUT a multiple of 8. All 16-byte aligned.
extern "C" int ess_conv3x3(const void* x, const void* w, const void* bias,
                           void* out, int B, int H, int W, int CIN, int COUT,
                           int relu, void* stream) {
  if (CIN % 4 != 0) return (int)cudaErrorInvalidValue;
  return ess::conv3x3_launch<float>(x, w, nullptr, bias, out, B, H, W,
                                    CIN * 2, COUT, relu, stream);
}
