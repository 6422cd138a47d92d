// Implicit-GEMM body of the int8 fused 3x3 conv (conv3x3_int8.cu, B4-int8):
// 3x3 SAME conv over NHWC s8 + per-channel scale/bias + optional ReLU, one
// rounding to bf16. The exact bf16 conv (B4) and the C-major head conv (T1)
// run on the halo-tile core of conv_halo.cuh instead; moving this body onto
// that core too is queued.
//
//   M = pixels (B*H*W, NHWC order), N = COUT, K = 9*CP,
//   k = tap*CP + cin with tap = dy*3 + dx and CP = CIN rounded up to one
//   64-byte chunk (64 s8 values).
//
// Everything below counts the K dimension in bytes (the s8 m16n8k32
// fragments are byte-for-byte images of bf16 m16n8k16 ones); Acc is the
// i32 accumulator.
//
// A tile: 128 pixels x 64 bytes of one tap, gathered with cp.async from the
// shifted pixels; zero fill outside the image is the conv's padding, zero
// fill past CIN is the K padding, whose weight columns are zero in the
// prepared matrix. A pixel is CIN*elem bytes, which need not be a multiple
// of 16 (the head conv has CIN = 20: 40 bytes in bf16, 20 in s8), so the
// copy width VECB is the largest of 16, 8, 4 bytes that divides it; two
// threads share a pixel row and each owns 32 of its 64 bytes.
//
// Block tile 128 x (32*WN) with 8 warps, WN of them along N (COUT 128 -> 4,
// 64 -> 2, <= 32 -> 1), each warp 32 columns wide; weight rows past COUT
// are zero-filled. mma.sync from a 3-stage cp.async ring; wgmma and TMA
// come later.
//
// Epilogue: scale/bias/ReLU on the accumulator, bf16 tile staged in shared
// memory, then 16-byte row-contiguous stores: the head conv writes 128
// channels per pixel and is bound by those bytes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace ess {

constexpr int kConvBM = 128;           // pixels per block
constexpr int kConvBKB = 64;           // bytes of K per stage row
constexpr int kConvStages = 3;
constexpr int kConvLDSB = kConvBKB + 16;   // padded smem row: 80 B (ldmatrix
                                           // rows on distinct bank groups)
constexpr int kConvThreads = 256;

__device__ __forceinline__ void mma_tile(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// i32 accumulator: float(acc) * ws + bias with each f32 operation rounded
// on its own (no fused multiply-add), the plain version's elementwise ops
// in its order.
__device__ __forceinline__ float conv_finish(int acc, float scale, float bias,
                                             int relu) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  return relu ? fmaxf(v, 0.f) : v;
}

template <typename Acc, int WN, int VECB>
__global__ void __launch_bounds__(kConvThreads, 2)
conv3x3_kernel(const unsigned char* __restrict__ x,   // NHWC, CINB B/pixel
               const unsigned char* __restrict__ w,   // (COUT, 9*CPB) bytes
               const float* __restrict__ ws,          // (COUT,), i32 acc only
               const float* __restrict__ bias,        // (COUT,)
               __nv_bfloat16* __restrict__ out,       // NHWC
               int B, int H, int W, int CINB, int COUT, int relu) {
  constexpr int BM = kConvBM, BN = 32 * WN, LDSB = kConvLDSB;
  constexpr int WM = 8 / WN, WROWS = BM / WM, MT = WROWS / 16;
  constexpr int kStageBytes = (BM + BN) * LDSB;
  constexpr int STAGES = kConvStages;
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int M = B * H * W, HW = H * W;
  const int CPB = (CINB + kConvBKB - 1) / kConvBKB * kConvBKB;
  const int chunks_per_tap = CPB / kConvBKB, KT = 9 * chunks_per_tap;
  const int64_t KB = 9 * (int64_t)CPB;            // bytes of one weight row
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // A loader: two threads per pixel row, 32 bytes each
  const int a_row = tid >> 1, a_byte0 = (tid & 1) * 32;
  const bool a_ok = m0 + a_row < M;
  const int a_m = a_ok ? m0 + a_row : 0;
  const int a_rem = a_m % HW;
  const int a_y = a_rem / W, a_x = a_rem - a_y * W;

  auto load_stage = [&](int stage, int ks) {
    unsigned char* As = conv_smem + stage * kStageBytes;
    unsigned char* Bs = As + BM * LDSB;
    const int tap = ks / chunks_per_tap;
    const int cb0 = (ks - tap * chunks_per_tap) * kConvBKB + a_byte0;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int sy = a_y + dy, sx = a_x + dx;
    const bool pix_ok = a_ok && sy >= 0 && sy < H && sx >= 0 && sx < W;
    const unsigned char* src =
        x + ((int64_t)a_m + dy * W + dx) * CINB + cb0;
#pragma unroll
    for (int j = 0; j < 32 / VECB; ++j) {
      const bool ok = pix_ok && cb0 + j * VECB < CINB;
      cp_async_zfill<VECB>(As + a_row * LDSB + a_byte0 + j * VECB,
                           ok ? src + j * VECB : x, ok);
    }
    for (int c = tid; c < BN * 4; c += kConvThreads) {
      const int row = c >> 2, part = (c & 3) * 16;
      const bool ok = n0 + row < COUT;
      cp_async_zfill<16>(
          Bs + row * LDSB + part,
          ok ? w + (int64_t)(n0 + row) * KB + (int64_t)ks * kConvBKB + part
             : w,
          ok);
    }
  };

  Acc acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int ks = 0; ks < KT; ++ks) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = ks + STAGES - 1;
    if (nxt < KT) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const unsigned char* As = conv_smem + (ks % STAGES) * kStageBytes;
    const unsigned char* Bs = As + BM * LDSB;
#pragma unroll
    for (int kk = 0; kk < kConvBKB; kk += 32) {
      unsigned a[MT][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * WROWS + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], As + r * LDSB + kk + (lane >> 4) * 16);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r4[4];
        const int r = wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4(r4, Bs + r * LDSB + kk + ((lane >> 3) & 1) * 16);
        b[np * 2][0] = r4[0];
        b[np * 2][1] = r4[1];
        b[np * 2 + 1][0] = r4[2];
        b[np * 2 + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tile(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: reuse it for C

  // epilogue: the bf16 tile goes through shared memory so that the global
  // stores are 16-byte chunks of contiguous rows
  constexpr int BNP = BN + 8;        // padded row (bf16): 16-byte multiple
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(conv_smem);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = wn * 32 + nt * 8 + (lane & 3) * 2;
    float sc[2], bi[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + col + j;
      const bool ok = n < COUT;
      bi[j] = ok ? bias[n] : 0.f;
      sc[j] = (ok && ws != nullptr) ? ws[n] : 1.f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * WROWS + mt * 16 + (lane >> 2) + half * 8;
        const float v0 =
            conv_finish(acc[mt][nt][half * 2], sc[0], bi[0], relu);
        const float v1 =
            conv_finish(acc[mt][nt][half * 2 + 1], sc[1], bi[1], relu);
        *reinterpret_cast<__nv_bfloat162*>(Cs + row * BNP + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
  constexpr int CPR = BN / 8;        // 16-byte chunks per tile row
  for (int c = tid; c < BM * CPR; c += kConvThreads) {
    const int row = c / CPR, cc = (c % CPR) * 8;
    const int m = m0 + row, n = n0 + cc;
    if (m < M && n < COUT)
      *reinterpret_cast<uint4*>(out + (int64_t)m * COUT + n) =
          *reinterpret_cast<const uint4*>(Cs + row * BNP + cc);
  }
}

template <typename Acc, int WN, int VECB>
int conv3x3_launch_tile(const void* x, const void* w, const void* ws,
                        const void* bias, void* out, int B, int H, int W,
                        int CINB, int COUT, int relu, void* stream) {
  constexpr int BN = 32 * WN;
  const int smem = kConvStages * (kConvBM + BN) * kConvLDSB;
  auto kern = conv3x3_kernel<Acc, WN, VECB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int M = B * H * W;
  dim3 blocks((M + kConvBM - 1) / kConvBM, (COUT + BN - 1) / BN);
  kern<<<blocks, kConvThreads, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)x, (const unsigned char*)w, (const float*)ws,
      (const float*)bias, (__nv_bfloat16*)out, B, H, W, CINB, COUT, relu);
  return (int)cudaGetLastError();
}

template <typename Acc, int WN>
int conv3x3_launch_vec(const void* x, const void* w, const void* ws,
                       const void* bias, void* out, int B, int H, int W,
                       int CINB, int COUT, int relu, void* stream) {
  if (CINB % 16 == 0)
    return conv3x3_launch_tile<Acc, WN, 16>(x, w, ws, bias, out, B, H, W,
                                            CINB, COUT, relu, stream);
  if (CINB % 8 == 0)
    return conv3x3_launch_tile<Acc, WN, 8>(x, w, ws, bias, out, B, H, W, CINB,
                                           COUT, relu, stream);
  if (CINB % 4 == 0)
    return conv3x3_launch_tile<Acc, WN, 4>(x, w, ws, bias, out, B, H, W, CINB,
                                           COUT, relu, stream);
  return (int)cudaErrorInvalidValue;
}

// CINB = bytes of one input pixel (a multiple of 4); COUT a multiple of 8.
template <typename Acc>
int conv3x3_launch(const void* x, const void* w, const void* ws,
                   const void* bias, void* out, int B, int H, int W, int CINB,
                   int COUT, int relu, void* stream) {
  if (B * H * W == 0 || COUT == 0) return 0;
  if (CINB <= 0 || COUT % 8 != 0) return (int)cudaErrorInvalidValue;
  if (COUT > 64)
    return conv3x3_launch_vec<Acc, 4>(x, w, ws, bias, out, B, H, W, CINB,
                                      COUT, relu, stream);
  if (COUT > 32)
    return conv3x3_launch_vec<Acc, 2>(x, w, ws, bias, out, B, H, W, CINB,
                                      COUT, relu, stream);
  return conv3x3_launch_vec<Acc, 1>(x, w, ws, bias, out, B, H, W, CINB, COUT,
                                    relu, stream);
}

}  // namespace ess
