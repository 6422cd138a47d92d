// Fused ConvLSTM cell: 3x3 gate conv over concat(x, h) + LSTM pointwise.
//
// Replaces the TPU kernel ess_tpu/ops/conv_lstm_pallas.py::_fused_kernel
// (exact bf16 variant). That kernel copies each row tile and its halo rows
// into VMEM, builds a full im2row buffer and runs one deep matrix product;
// the halo arrays and the im2row buffer exist to fit the TPU's memory
// system. Here the same product runs as an implicit GEMM that reads x and
// h straight from device memory:
//   M = pixels (B*H*W, NHWC order), N = 4*CH gate columns,
//   K = 9*(CX+CH), k = tap*(CX+CH) + cin with tap = dy*3 + dx,
// each 128-pixel x 32-k A tile gathered with cp.async from the shifted
// pixels of one tap (zero fill outside the image is the conv's padding).
// bf16 operands on the tensor cores (mma.sync m16n8k16), f32 accumulators.
//
// Gate columns: the weight matrix arrives with its columns permuted once at
// preparation time (ess_tpu_torch/ops/conv_lstm.py::prepare_gate_weights) so
// that each 32-column group holds gates i, f, o, g of 8 consecutive channels
// in 8-column runs. A warp owns 32 columns, and with the m16n8 accumulator
// layout every thread then holds all four gates of its channels: the
// epilogue adds the bias, applies sigmoid/tanh in f32, reads c_prev, and
// writes h' and c' as bf16 with no shared-memory exchange.
//
// Aliasing: blocks run in parallel and read neighbouring rows of h_prev, so
// h' goes to a separate buffer (the caller ping-pongs). c is updated in
// place: each element is read and written by the same thread only.
//
// Bounds on the H100: about 41.5 GFLOP per window per sample at each DSEC
// encoder level against a few MB of operands, so the tensor cores bound it.
// This first version uses mma.sync with a 3-stage cp.async pipeline and
// 128x128x32 block tiles; wgmma, TMA and warp specialisation come later.
//
// The MODE template parameter (mma_common.cuh::CellMode) compiles the
// attribution variants of the body: kFull is the cell; the others replace
// the epilogue (variant_pointwise) or, kNoBuild, also skip the cp.async
// gather of the A tile, so that the product runs on whatever the shared
// memory holds and the output is undefined (it is timed, never compared).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace ess;

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
constexpr int LDS = BK + 8;          // padded smem row (bf16): 80 B, ldmatrix
                                     // rows land on distinct bank groups
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int kStageElems = (BM + BN) * LDS;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
conv_lstm_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ h,
                 __nv_bfloat16* __restrict__ c,
                 const __nv_bfloat16* __restrict__ w,   // (4*CH, K) permuted
                 const float* __restrict__ bias,        // (4*CH,) i,f,o,g
                 __nv_bfloat16* __restrict__ h_out,
                 int B, int H, int W, int CX, int CH) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int M = B * H * W, HW = H * W;
  const int CIN = CX + CH, K = 9 * CIN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks_per_tap = CIN / BK, KT = 9 * chunks_per_tap;

  // the two A rows (pixels) and B rows this thread loads each stage
  int a_y[2], a_x[2], a_b[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + i * 64;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_b[i] = mm / HW;
    const int rem = mm - a_b[i] * HW;
    a_y[i] = rem / W;
    a_x[i] = rem - a_y[i] * W;
  }
  const int part = (tid & 3) * 8;

  auto load_stage = [&](int stage, int ks) {
    __nv_bfloat16* As = smem + stage * kStageElems;
    __nv_bfloat16* Bs = As + BM * LDS;
    const int tap = ks / chunks_per_tap;
    const int cin0 = (ks - tap * chunks_per_tap) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool from_x = cin0 < CX;
    const __nv_bfloat16* src = from_x ? x : h;
    const int cs = from_x ? CX : CH;
    const int co = (from_x ? cin0 : cin0 - CX) + part;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const int sy = a_y[i] + dy, sx = a_x[i] + dx;
      const bool ok = a_ok[i] && sy >= 0 && sy < H && sx >= 0 && sx < W;
      const __nv_bfloat16* g =
          ok ? src + ((int64_t)(a_b[i] * H + sy) * W + sx) * cs + co : src;
      if constexpr (MODE != kNoBuild)
        cp_async16(As + row * LDS + part, g, ok);
      const __nv_bfloat16* gb = w + (int64_t)(n0 + row) * K + ks * BK + part;
      cp_async16(Bs + row * LDS + part, gb, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

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

    const __nv_bfloat16* As = smem + (ks % STAGES) * kStageElems;
    const __nv_bfloat16* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], As + r * LDS + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r4[4];
        const int r = wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4(r4, Bs + r * LDS + kk + ((lane >> 3) & 1) * 8);
        b[np * 2][0] = r4[0];
        b[np * 2][1] = r4[1];
        b[np * 2 + 1][0] = r4[2];
        b[np * 2 + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: n-tile nt of this warp is gate nt of channels ch0 .. ch0+7
  const int ch = (n0 + wn * 32) / 4 + (lane & 3) * 2;
  float bi[4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    bi[g][0] = bias[g * CH + ch];
    bi[g][1] = bias[g * CH + ch + 1];
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
      const int64_t off = (int64_t)m * CH + ch;
      const __nv_bfloat162 cp2 =
          *reinterpret_cast<const __nv_bfloat162*>(c + off);
      const float cp[2] = {__bfloat162float(cp2.x), __bfloat162float(cp2.y)};
      float hn[2], cn[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = half * 2 + j;
        if constexpr (MODE == kFull) {
          const float gi = acc[mt][0][r] + bi[0][j];
          const float gf = acc[mt][1][r] + bi[1][j];
          const float go = acc[mt][2][r] + bi[2][j];
          const float gg = acc[mt][3][r] + bi[3][j];
          cn[j] = sigmoidf_(gf) * cp[j] + sigmoidf_(gi) * tanhf(gg);
          hn[j] = sigmoidf_(go) * tanhf(cn[j]);
        } else {
          float gt[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            gt[g] = __fadd_rn(acc[mt][g][r], bi[g][j]);
          variant_pointwise<MODE>(gt, cp[j], hn[j], cn[j]);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(c + off) =
          __floats2bfloat162_rn(cn[0], cn[1]);
      *reinterpret_cast<__nv_bfloat162*>(h_out + off) =
          __floats2bfloat162_rn(hn[0], hn[1]);
    }
  }
}

template <int MODE>
int launch(const void* x, const void* h, void* c, const void* w,
           const void* bias, void* h_out, int B, int H, int W, int CX, int CH,
           void* stream) {
  const int M = B * H * W;
  if (M == 0) return 0;
  const int smem = STAGES * kStageElems * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      conv_lstm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 blocks((M + BM - 1) / BM, 4 * CH / BN);
  conv_lstm_kernel<MODE><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (__nv_bfloat16*)c,
      (const __nv_bfloat16*)w, (const float*)bias, (__nv_bfloat16*)h_out, B,
      H, W, CX, CH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ess_conv_lstm(const void* x, const void* h, void* c,
                             const void* w, const void* bias, void* h_out,
                             int B, int H, int W, int CX, int CH,
                             void* stream) {
  return launch<kFull>(x, h, c, w, bias, h_out, B, H, W, CX, CH, stream);
}

// The same cell in the attribution variant `mode`: a CellMode other than
// kFull, which is ess_conv_lstm and is refused here.
extern "C" int ess_conv_lstm_mode(const void* x, const void* h, void* c,
                                  const void* w, const void* bias,
                                  void* h_out, int B, int H, int W, int CX,
                                  int CH, int mode, void* stream) {
  switch (mode) {
    case kPtwBf16:
      return launch<kPtwBf16>(x, h, c, w, bias, h_out, B, H, W, CX, CH,
                              stream);
    case kPtwMul:
      return launch<kPtwMul>(x, h, c, w, bias, h_out, B, H, W, CX, CH,
                             stream);
    case kNoPtw:
      return launch<kNoPtw>(x, h, c, w, bias, h_out, B, H, W, CX, CH, stream);
    case kNoBuild:
      return launch<kNoBuild>(x, h, c, w, bias, h_out, B, H, W, CX, CH,
                              stream);
  }
  return (int)cudaErrorInvalidValue;
}
