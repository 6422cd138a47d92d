// What the kernels' TMA and async-proxy copies share (conv_halo.cuh's halo
// loads and wgmma operands): the proxy
// fence and the tensor-map encoder, cuTensorMapEncodeTiled.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

// Generic-proxy writes to shared memory (threads' stores, cp.async,
// atomics) become visible to async-proxy readers (wgmma's shared-memory
// operand, TMA copies) only after this fence
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime (the library is not
// linked against libcuda)
typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(ptr);
  }
  return fn;
}
