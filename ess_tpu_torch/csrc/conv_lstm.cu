// Fused ConvLSTM cell, exact bf16 (B2): 3x3 gate conv over concat(x, h) +
// LSTM pointwise.
//
// Replaces the TPU kernel ess_tpu/ops/conv_lstm_pallas.py::_fused_kernel
// (exact bf16 variant). That kernel copies each row tile and its halo rows
// into VMEM, builds a full im2row buffer and runs one deep matrix product;
// the halo arrays and the im2row buffer exist to fit the TPU's memory
// system. Here the same product runs on the halo-tile core of
// conv_halo.cuh (cell_kernel, INT8 = false): per 256-pixel patch and
// 32-channel chunk of concat(x, h), the halo is copied once by TMA and all
// nine taps read it through shifted ldmatrix rows; the N tile's weights of
// the chunk stream in by one bulk copy; wgmma m64n128k16 with A from
// registers, f32 accumulators; a producer warpgroup keeps the next stage in
// flight, and the two consumer warpgroups take turns so that one's
// epilogue overlaps the other's products.
//
// Gate columns: the weight image (ops/conv_lstm.py::gate_weight_image) is
// built from the prepared matrix, whose columns are permuted once
// (prepare_gate_weights) so that each 32-column group holds gates i, f, o,
// g of 8 consecutive channels in 8-column runs; with wgmma's m16n8
// accumulator layout every thread holds all four gates of its channels:
// the epilogue adds the bias, applies sigmoid/tanh in f32, reads c_prev and
// writes h' and c' as bf16.
//
// Aliasing: blocks run in parallel and read neighbouring rows of h_prev, so
// h' goes to a separate buffer (the caller ping-pongs). c is updated in
// place: each element is read and written by the same thread only.
//
// Bounds on the H100: 41.5 GFLOP per window per sample at each DSEC encoder
// level against a few MB of operands, so the tensor cores bound it
// (989 TFLOP/s bf16).
//
// The MODE template parameter (mma_common.cuh::CellMode) compiles the
// attribution variants of the body: kFull is the cell; the others replace
// the epilogue (variant_pointwise) or, kNoBuild, also skip the halo copies
// (the producer still completes the stages with the weights), so that the
// product runs on whatever the shared memory holds and the output is
// undefined (it is timed, never compared).

#include "conv_halo.cuh"

namespace {

using namespace ess;
using namespace ess::halo;

template <int MODE>
int launch(const void* x, const void* h, void* c, const void* w,
           const void* bias, void* h_out, int B, int H, int W, int CX, int CH,
           int th, int tw, int grid, int smem, void* stream) {
  return cell_launch<false, MODE>(x, h, c, w, nullptr, bias, h_out, B, H, W,
                                  CX, CH, th, tw, grid, smem, stream);
}

}  // namespace

// x: bf16 NHWC (B, H, W, CX), h and c (B, H, W, CH), CX and CH multiples of
// 32; w: the weight image (ops/conv_lstm.py::gate_weight_image); bias: f32
// (4*CH,) in i, f, o, g order; h_out: bf16 NHWC (B, H, W, CH). All 16-byte
// aligned. The plan (th, tw, grid, smem) is ops/conv_halo.py::cell_plan's.
extern "C" int ess_conv_lstm(const void* x, const void* h, void* c,
                             const void* w, const void* bias, void* h_out,
                             int B, int H, int W, int CX, int CH, int th,
                             int tw, int grid, int smem, void* stream) {
  return launch<kFull>(x, h, c, w, bias, h_out, B, H, W, CX, CH, th, tw,
                       grid, smem, stream);
}

// The same cell in the attribution variant `mode`: a CellMode other than
// kFull, which is ess_conv_lstm and is refused here.
extern "C" int ess_conv_lstm_mode(const void* x, const void* h, void* c,
                                  const void* w, const void* bias,
                                  void* h_out, int B, int H, int W, int CX,
                                  int CH, int th, int tw, int grid, int smem,
                                  int mode, void* stream) {
#define ESS_CELL_MODE(M)                                                    \
  case M:                                                                   \
    return launch<M>(x, h, c, w, bias, h_out, B, H, W, CX, CH, th, tw,      \
                     grid, smem, stream);
  switch (mode) {
    ESS_CELL_MODE(kPtwBf16)
    ESS_CELL_MODE(kPtwMul)
    ESS_CELL_MODE(kNoPtw)
    ESS_CELL_MODE(kNoBuild)
  }
#undef ESS_CELL_MODE
  return (int)cudaErrorInvalidValue;
}
