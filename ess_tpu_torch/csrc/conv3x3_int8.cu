// Fused 3x3 SAME conv + bias + optional ReLU over NHWC, int8 operands.
//
// Replaces the int8 variant of the TPU kernel
// ess_tpu/ops/conv3x3_pallas.py::_conv_kernel (int8=True), which quantizes
// its bf16 row tile in VMEM by a per-call absmax scale, multiplies it on the
// int8 MXU path against per-output-channel quantized weights and
// dequantizes the i32 accumulator with one multiply per column. The absmax
// and the weight re-quantization stay torch ops on the device, as they are
// XLA ops beside the TPU kernel (ess_tpu_torch/ops/conv3x3.py).
//
// Two launches per conv:
// 1. quantize_kernel: x (bf16 NHWC) * inv_sx, rounded half to even and
//    clipped to [-127, 127], into an int8 copy. inv_sx is read from device
//    memory, so no host sync happens per call. cp.async cannot convert
//    while it copies, so this is a pre-pass (encoder 0 at B=8: 144 MB read,
//    72 MB written).
// 2. the implicit GEMM of conv3x3_common.cuh with s8 operands, mma.sync
//    m16n8k32 (s8 x s8 -> s32), K per tap padded to 64 channels. Epilogue:
//    out = float(acc) * ws + bias, ReLU, one rounding to bf16, each f32
//    operation rounded on its own as in the plain version's elementwise
//    ops, so the kernel equals the plain int8 conv bit for bit.
//
// Bounds on the H100 at B=8: the same bytes as the bf16 conv (bf16 in and
// out) at twice the operation rate, so both the head conv (0.050 ms) and
// encoder 0 (0.065 ms) are bound by bytes.

#include "conv3x3_common.cuh"

namespace {

constexpr int kQuantThreads = 256;

// 4 elements per thread (CIN is a multiple of 4, so is the element count)
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const __nv_bfloat16* __restrict__ x, int64_t n4,
                const float* __restrict__ inv_sx, int8_t* __restrict__ xq) {
  const int64_t i = (int64_t)blockIdx.x * kQuantThreads + threadIdx.x;
  if (i >= n4) return;
  const float s = *inv_sx;
  const uint2 v = *reinterpret_cast<const uint2*>(x + i * 4);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  unsigned q4 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int q = __float2int_rn(__fmul_rn(__bfloat162float(e[j]), s));
    q = min(127, max(-127, q));
    q4 |= (static_cast<unsigned>(q) & 0xffu) << (8 * j);
  }
  *reinterpret_cast<unsigned*>(xq + i * 4) = q4;
}

}  // namespace

// x: bf16 with n elements (a multiple of 4), 8-byte aligned; inv_sx: one f32
// on the device; xq: int8 output of the same size.
extern "C" int ess_conv3x3_quant(const void* x, const void* inv_sx, void* xq,
                                 int64_t n, void* stream) {
  if (n % 4 != 0) return (int)cudaErrorInvalidValue;
  const int64_t n4 = n / 4;
  if (n4 == 0) return 0;
  const int64_t blocks = (n4 + kQuantThreads - 1) / kQuantThreads;
  quantize_kernel<<<(unsigned)blocks, kQuantThreads, 0,
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, n4, (const float*)inv_sx, (int8_t*)xq);
  return (int)cudaGetLastError();
}

// xq: int8 NHWC (B, H, W, CIN), CIN a multiple of 4; w: int8 (COUT, 9*CP)
// with CP = CIN rounded up to 64; ws, bias: f32 (COUT,); out: bf16 NHWC
// (B, H, W, COUT), COUT a multiple of 8. All 16-byte aligned.
extern "C" int ess_conv3x3_int8(const void* xq, const void* w, const void* ws,
                                const void* bias, void* out, int B, int H,
                                int W, int CIN, int COUT, int relu,
                                void* stream) {
  if (CIN % 4 != 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  return ess::conv3x3_launch<int>(xq, w, ws, bias, out, B, H, W, CIN, COUT,
                                  relu, stream);
}
