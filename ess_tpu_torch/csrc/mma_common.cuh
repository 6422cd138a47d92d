// Device helpers shared by the halo-tile core (conv_halo.cuh: the 3x3 conv
// kernels and the ConvLSTM cell kernels) and the fused encoder level
// (level_int8.cu): cp.async copies into shared memory, ldmatrix, the f32
// sigmoid of the LSTM epilogue, and the epilogues of the cell kernels'
// attribution variants.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ess {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;      // src-size 0 writes 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

// cp.async of N bytes (16, 8 or 4); !valid writes N zero bytes
template <int N>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool valid) {
  const int n = valid ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix at a shared-memory address
__device__ __forceinline__ void ldmatrix_x4_at(unsigned (&r)[4],
                                               unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  ldmatrix_x4_at(r, smem_u32(p));
}

// 1 / (1 + exp(-v)) rounded per operation, as torch.sigmoid computes it
__device__ __forceinline__ float sigmoidf_(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// Compile-time variants of the cell kernels (the MODE template parameter;
// ess_tpu_torch/ops/conv_lstm.py::MODES in this order). kFull is the cell.
// Replaces the TPU kernel tools/bench_lstm_breakdown.py::kern, whose modes
// these are: the differences between their times attribute the cell's time
// to the pointwise, the transcendentals and the operand gather. The product
// bounds every variant as it bounds the cell.
enum CellMode { kFull = 0, kPtwBf16 = 1, kPtwMul = 2, kNoPtw = 3,
                kNoBuild = 4 };

// v rounded to bf16 and back: one bf16 operation's result
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// tanh(v / 2) / 2 + 1 / 2 with every operation rounded to bf16
__device__ __forceinline__ float sigmoid_bf16_(float v) {
  const float t = bf16_round(tanhf(bf16_round(__fmul_rn(v, 0.5f))));
  return bf16_round(__fadd_rn(bf16_round(__fmul_rn(t, 0.5f)), 0.5f));
}

// The epilogue of a variant other than kFull on the f32 gates gt = (i, f, o,
// g) and the previous cell state cp (a bf16 value), every f32 operation
// rounded on its own as the plain version's elementwise operations are.
// kPtwMul: c' = f*c + i*g, h' = o*c' on the raw gates. kPtwBf16: the gates
// rounded to bf16, sigmoid as tanh, every operation in bf16. kNoPtw and
// kNoBuild: h' = gate i, c' = gate f.
template <int MODE>
__device__ __forceinline__ void variant_pointwise(const float (&gt)[4],
                                                  float cp, float& hn,
                                                  float& cn) {
  static_assert(MODE != kFull, "the cell's own epilogue is in its kernel");
  if constexpr (MODE == kPtwMul) {
    cn = __fadd_rn(__fmul_rn(gt[1], cp), __fmul_rn(gt[0], gt[3]));
    hn = __fmul_rn(gt[2], cn);
  } else if constexpr (MODE == kPtwBf16) {
    const float gi = bf16_round(gt[0]), gf = bf16_round(gt[1]);
    const float go = bf16_round(gt[2]), gg = bf16_round(gt[3]);
    const float keep = bf16_round(__fmul_rn(sigmoid_bf16_(gf), cp));
    const float add = bf16_round(
        __fmul_rn(sigmoid_bf16_(gi), bf16_round(tanhf(gg))));
    cn = bf16_round(__fadd_rn(keep, add));
    hn = bf16_round(__fmul_rn(sigmoid_bf16_(go), bf16_round(tanhf(cn))));
  } else {
    hn = gt[0];
    cn = gt[1];
  }
}

}  // namespace ess
