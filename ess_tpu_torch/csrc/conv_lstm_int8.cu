// Int8 ConvLSTM cell: the 3x3 gate conv over concat(x, h) as one int8
// product with int32 accumulation, a per-column dequantizing epilogue, then
// the LSTM pointwise in f32.
//
// Replaces the int8 variant of the TPU kernel
// ess_tpu/ops/conv_lstm_pallas.py::_fused_kernel (int8=True), which
// quantizes its x and h row tiles in VMEM (x by a per-call absmax scale,
// h by the static 1/127 of a tanh*sigmoid-bounded state), multiplies them
// on the int8 MXU path against per-output-channel quantized weights and
// dequantizes the i32 accumulator with one multiply per column. The scale
// reduce and the weight re-quantization stay torch ops on the device, as
// they are XLA ops beside the TPU kernel (ess_tpu_torch/ops/conv_lstm.py).
//
// Two launches per cell:
// 1. quantize_kernel: x (bf16 NHWC) * inv_sx and h (bf16) * 127, rounded
//    half to even and clipped to [-127, 127], into int8 copies. inv_sx is
//    read from device memory, so no host sync happens per cell. cp.async
//    cannot convert while it copies, so this is a pre-pass: at DSEC level
//    0, B=8, it reads ~72 MB and writes ~36 MB (~35 us at 3.35 TB/s).
// 2. conv_lstm_int8_kernel: the implicit GEMM of conv_lstm.cu with int8
//    operands, mma.sync m16n8k32 (s8 x s8 -> s32). Its fragments are
//    byte-for-byte images of the bf16 m16n8k16 fragments, so the ldmatrix
//    addressing of the bf16 kernel carries over with the k step counted in
//    bytes (BK = 64 int8 = the bf16 kernel's 64 bytes per stage row), and
//    the accumulator layout (hence the permuted gate columns and the
//    shared-memory-free epilogue) is unchanged. Epilogue:
//    gates = float(acc) * ws + bias, c' = sigmoid(f)*c + sigmoid(i)*tanh(g),
//    h' = sigmoid(o)*tanh(c'), each f32 operation rounded on its own as in
//    the plain version's elementwise ops (no contraction into FMAs), so the
//    kernel's h' and c' equal the plain int8 cell's bit for bit wherever
//    expf/tanhf agree with torch's; h' to a new buffer, c in place.
//
// The MODE template parameter (mma_common.cuh::CellMode) compiles the
// attribution variants of the GEMM body, as in conv_lstm.cu: kFull is the
// cell; the others replace the epilogue or, kNoBuild, also skip the gather
// of the A tile (output undefined, timed only).
//
// K per tap is CIN rounded up to BK; the tail of a tap is zero-filled in
// both operands, so CX and CH need only be multiples of 32 (a 16-byte copy
// never straddles x and h).
//
// Bounds on the H100: twice the MACs of the bf16 cell per byte staged, on
// a 1,979 TOP/s int8 peak; this first version keeps the bf16 kernel's
// mma.sync and 3-stage cp.async ring, so it is bound by issue and
// shared-memory traffic well below that peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

using namespace ess;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3;   // BK in bytes
constexpr int LDS = BK + 16;         // padded smem row: 80 B, as conv_lstm.cu
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int kStageBytes = (BM + BN) * LDS;
constexpr int kQuantThreads = 256;

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned quant4(const __nv_bfloat16* v, float s) {
  unsigned out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int q = __float2int_rn(__fmul_rn(__bfloat162float(v[j]), s));
    q = min(127, max(-127, q));
    out |= (static_cast<unsigned>(q) & 0xffu) << (8 * j);
  }
  return out;
}

// 8 elements per thread: threads [0, nx8) take x, the rest h.
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const __nv_bfloat16* __restrict__ x, int64_t nx8,
                const __nv_bfloat16* __restrict__ h, int64_t nh8,
                const float* __restrict__ inv_sx,
                int8_t* __restrict__ xq, int8_t* __restrict__ hq) {
  int64_t i = (int64_t)blockIdx.x * kQuantThreads + threadIdx.x;
  const __nv_bfloat16* src = x;
  int8_t* dst = xq;
  float s;
  if (i < nx8) {
    s = *inv_sx;
  } else {
    i -= nx8;
    if (i >= nh8) return;
    src = h;
    dst = hq;
    s = 127.f;
  }
  const uint4 v = *reinterpret_cast<const uint4*>(src + i * 8);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  uint2 q;
  q.x = quant4(e, s);
  q.y = quant4(e + 4, s);
  *reinterpret_cast<uint2*>(dst + i * 8) = q;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
conv_lstm_int8_kernel(const int8_t* __restrict__ xq,
                      const int8_t* __restrict__ hq,
                      __nv_bfloat16* __restrict__ c,
                      const int8_t* __restrict__ w,     // (4*CH, 9*CIN) permuted
                      const float* __restrict__ ws,     // (4*CH,) i,f,o,g
                      const float* __restrict__ bias,   // (4*CH,) i,f,o,g
                      __nv_bfloat16* __restrict__ h_out,
                      int B, int H, int W, int CX, int CH) {
  extern __shared__ __align__(16) int8_t smem8[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int M = B * H * W, HW = H * W;
  const int CIN = CX + CH, K = 9 * CIN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int chunks_per_tap = (CIN + BK - 1) / BK, KT = 9 * chunks_per_tap;

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
  const int part = (tid & 3) * 16;   // this thread's 16 bytes of a row

  auto load_stage = [&](int stage, int ks) {
    int8_t* As = smem8 + stage * kStageBytes;
    int8_t* Bs = As + BM * LDS;
    const int tap = ks / chunks_per_tap;
    const int co = (ks - tap * chunks_per_tap) * BK + part;   // input channel
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool in_k = co < CIN;
    const bool from_x = co < CX;
    const int8_t* src = from_x ? xq : hq;
    const int cs = from_x ? CX : CH;
    const int cc = from_x ? co : co - CX;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const int sy = a_y[i] + dy, sx = a_x[i] + dx;
      const bool ok = in_k && a_ok[i] && sy >= 0 && sy < H && sx >= 0 &&
                      sx < W;
      const int8_t* g =
          ok ? src + ((int64_t)(a_b[i] * H + sy) * W + sx) * cs + cc : src;
      if constexpr (MODE != kNoBuild)
        cp_async16(As + row * LDS + part, g, ok);
      const int8_t* gb =
          in_k ? w + (int64_t)(n0 + row) * K + tap * CIN + co : w;
      cp_async16(Bs + row * LDS + part, gb, in_k);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
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

    const int8_t* As = smem8 + (ks % STAGES) * kStageBytes;
    const int8_t* Bs = As + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], As + r * LDS + kk + (lane >> 4) * 16);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r4[4];
        const int r = wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7);
        ldmatrix_x4(r4, Bs + r * LDS + kk + ((lane >> 3) & 1) * 16);
        b[np * 2][0] = r4[0];
        b[np * 2][1] = r4[1];
        b[np * 2 + 1][0] = r4[2];
        b[np * 2 + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: n-tile nt of this warp is gate nt of channels ch0 .. ch0+7
  const int ch = (n0 + wn * 32) / 4 + (lane & 3) * 2;
  float sc[4][2], bi[4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    sc[g][0] = ws[g * CH + ch];
    sc[g][1] = ws[g * CH + ch + 1];
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
      float hn[2], cn[2], gt[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = half * 2 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gt[g] = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[mt][g][r]), sc[g][j]), bi[g][j]);
        if constexpr (MODE == kFull) {
          // one rounding per operation, no fused multiply-add: the plain
          // version's elementwise ops, so both round alike
          cn[j] = __fadd_rn(__fmul_rn(sigmoidf_(gt[1]), cp[j]),
                            __fmul_rn(sigmoidf_(gt[0]), tanhf(gt[3])));
          hn[j] = __fmul_rn(sigmoidf_(gt[2]), tanhf(cn[j]));
        } else {
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
int launch(const void* xq, const void* hq, void* c, const void* w,
           const void* ws, const void* bias, void* h_out, int B, int H, int W,
           int CX, int CH, void* stream) {
  const int M = B * H * W;
  if (M == 0) return 0;
  const int smem = STAGES * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_lstm_int8_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 blocks((M + BM - 1) / BM, 4 * CH / BN);
  conv_lstm_int8_kernel<MODE>
      <<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
          (const int8_t*)xq, (const int8_t*)hq, (__nv_bfloat16*)c,
          (const int8_t*)w, (const float*)ws, (const float*)bias,
          (__nv_bfloat16*)h_out, B, H, W, CX, CH);
  return (int)cudaGetLastError();
}

}  // namespace

// x, h: bf16 NHWC with nx, nh elements (multiples of 8); inv_sx: one f32 on
// the device; xq, hq: int8 outputs of the same sizes.
extern "C" int ess_conv_lstm_quant(const void* x, const void* h,
                                   const void* inv_sx, void* xq, void* hq,
                                   int64_t nx, int64_t nh, void* stream) {
  const int64_t n8 = nx / 8 + nh / 8;
  if (n8 == 0) return 0;
  const int64_t blocks = (n8 + kQuantThreads - 1) / kQuantThreads;
  quantize_kernel<<<(unsigned)blocks, kQuantThreads, 0,
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, nx / 8, (const __nv_bfloat16*)h, nh / 8,
      (const float*)inv_sx, (int8_t*)xq, (int8_t*)hq);
  return (int)cudaGetLastError();
}

extern "C" int ess_conv_lstm_int8(const void* xq, const void* hq, void* c,
                                  const void* w, const void* ws,
                                  const void* bias, void* h_out, int B, int H,
                                  int W, int CX, int CH, void* stream) {
  return launch<kFull>(xq, hq, c, w, ws, bias, h_out, B, H, W, CX, CH,
                       stream);
}

// The same GEMM in the attribution variant `mode`: a CellMode other than
// kFull, which is ess_conv_lstm_int8 and is refused here.
extern "C" int ess_conv_lstm_int8_mode(const void* xq, const void* hq,
                                       void* c, const void* w, const void* ws,
                                       const void* bias, void* h_out, int B,
                                       int H, int W, int CX, int CH, int mode,
                                       void* stream) {
  switch (mode) {
    case kPtwBf16:
      return launch<kPtwBf16>(xq, hq, c, w, ws, bias, h_out, B, H, W, CX, CH,
                              stream);
    case kPtwMul:
      return launch<kPtwMul>(xq, hq, c, w, ws, bias, h_out, B, H, W, CX, CH,
                             stream);
    case kNoPtw:
      return launch<kNoPtw>(xq, hq, c, w, ws, bias, h_out, B, H, W, CX, CH,
                            stream);
    case kNoBuild:
      return launch<kNoBuild>(xq, hq, c, w, ws, bias, h_out, B, H, W, CX, CH,
                              stream);
  }
  return (int)cudaErrorInvalidValue;
}
