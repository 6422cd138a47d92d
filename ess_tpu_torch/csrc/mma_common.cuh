// Device helpers shared by the ConvLSTM kernels (conv_lstm.cu,
// conv_lstm_int8.cu): cp.async copies into shared memory, ldmatrix, and the
// f32 sigmoid of the LSTM epilogue.

#pragma once

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// 1 / (1 + exp(-v)) rounded per operation, as torch.sigmoid computes it
__device__ __forceinline__ float sigmoidf_(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

}  // namespace ess
