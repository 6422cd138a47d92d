// Int8 ConvLSTM cell (B2-int8): the 3x3 gate conv over concat(x, h) as one
// int8 product with int32 accumulation, a per-column dequantizing epilogue,
// then the LSTM pointwise in f32.
//
// Replaces the int8 variant of the TPU kernel
// ess_tpu/ops/conv_lstm_pallas.py::_fused_kernel (int8=True), which
// quantizes its x and h row tiles in VMEM (x by a per-call absmax scale,
// h by the static 1/127 of a tanh*sigmoid-bounded state), multiplies them
// on the int8 MXU path against per-output-channel quantized weights (both
// scales folded in, ess_tpu/ops/conv_lstm_pallas.py:238-253) and
// dequantizes the i32 accumulator with one multiply per column.
//
// Three launches per cell:
// 1. absmax_kernel (conv_halo.cuh, shared with B4-int8): per-block maxima
//    of |x| over bf16 bits, written to `partials`.
// 2. prep_kernel: every block reduces the partials to
//    s_x = max(amax, 1e-8) / 127 and 1/s_x (conv_halo.cuh::x_scales, as
//    input_scale and torch.reciprocal compute them; block 0 stores both);
//    then
//    - weight blocks, one warp per prepared gate row: the row scale (s_x on
//      x columns, 1/127 on h columns) folded in with __fmul_rn,
//      ws = max(absmax, 1e-20) / 127, wq = clip(rint(w~ / ws)) with
//      __fdiv_rn, written straight into the kernel's weight image (zeros
//      on channels past CX or CH) and ws in i, f, o, g order
//      (ops/conv_lstm.py::quantize_gate_weights, bit for bit);
//    - quantize blocks: x * (1/s_x) and h * 127, rounded half to even and
//      clipped to [-127, 127], into int8 NHWC copies whose channels are
//      padded with zeros to a multiple of 64 (one 64-byte halo pixel per
//      chunk; TMA cannot convert while it copies).
// 3. the cell: conv_halo.cuh::cell_kernel with INT8 = true, wgmma
//    m64n128k32 .s32.s8.s8 with A from registers (the register-A form
//    exists for .s8; its fragment is the m16n8k32 one, byte for byte the
//    bf16 m16n8k16 fragment, so the swizzled ldmatrix addressing of the
//    exact cell carries over with 64 int8 channels a chunk). Epilogue:
//    gates = float(acc) * ws + bias, c' = sigmoid(f)*c + sigmoid(i)*tanh(g),
//    h' = sigmoid(o)*tanh(c'), each f32 operation rounded on its own as in
//    the plain version's elementwise ops (no contraction into FMAs), so
//    h' and c' equal the plain int8 cell's bit for bit wherever
//    expf/tanhf agree with torch's; h' to a new buffer, c in place.
// No host sync: the scales stay on the device.
//
// The MODE template parameter (mma_common.cuh::CellMode) compiles the
// attribution variants of the cell, as in conv_lstm.cu.
//
// Bounds on the H100: twice the bf16 cell's operations per staged byte on
// a 1,979 TOP/s int8 peak.

#include <algorithm>

#include "conv_halo.cuh"

namespace {

using namespace ess;
using namespace ess::halo;

constexpr int kMaxQuantBlocks = 2048;

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

__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ h,
            const float* __restrict__ w,        // (4*CH, 9*(CX+CH)) prepared
            const float* __restrict__ partials, int n_partials,
            float* __restrict__ scal,           // s_x, 1/s_x
            int8_t* __restrict__ w_img, float* __restrict__ ws,
            int8_t* __restrict__ xq, int8_t* __restrict__ hq, int64_t npix,
            int CX, int CH, int w_blocks) {
  __shared__ float red[kPrepThreads / 32];
  const float2 sc = x_scales(partials, n_partials, red);
  const float s_x = sc.x, inv_sx = sc.y;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scal[0] = s_x;
    scal[1] = inv_sx;
  }
  const int cxp = (CX + 63) / 64 * 64, chp = (CH + 63) / 64 * 64;
  if ((int)blockIdx.x < w_blocks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n = blockIdx.x * (kPrepThreads / 32) + warp;
    if (n >= 4 * CH) return;
    const int CIN = CX + CH, K = 9 * CIN;
    const float* row = w + (int64_t)n * K;
    const float rh = (float)(1.0 / 127.0);
    float am = 0.f;
    for (int k = lane; k < K; k += 32)
      am = fmaxf(am, fabsf(__fmul_rn(row[k], k % CIN < CX ? s_x : rh)));
#pragma unroll
    for (int o = 16; o; o >>= 1) am = fmaxf(am, __shfl_xor_sync(~0u, am, o));
    const float s = __fdiv_rn(fmaxf(am, 1e-20f), 127.f);
    // prepared row n holds gate (n % 32) / 8 of channel (n / 32) * 8 + n % 8
    if (lane == 0) ws[((n & 31) >> 3) * CH + (n >> 5) * 8 + (n & 7)] = s;
    const int chunks_x = cxp / 64, chunks = chunks_x + chp / 64;
    const int nt = n / kCellBN, nn = n % kCellBN;
    // 4 channels a step: (chunk, tap, 4-channel quad of the 64)
    for (int u = lane; u < chunks * 9 * 16; u += 32) {
      const int quad = u & 15, kt = u >> 4, tap = kt % 9, kk = kt / 9;
      const int within = quad * 4;
      const int hc = (kk - chunks_x) * 64 + within;
      const bool from_x = kk < chunks_x;
      const int cin0 = from_x ? kk * 64 + within : CX + hc;
      const bool ok = from_x ? cin0 < CX : hc < CH;
      unsigned packed = 0;
      if (ok) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __fmul_rn(row[tap * CIN + cin0 + e],
                                    from_x ? s_x : rh);
          const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
          packed |= ((unsigned)(int)q & 0xffu) << (8 * e);
        }
      }
      *reinterpret_cast<unsigned*>(
          w_img +
          ((((int64_t)nt * chunks + kk) * 36 + tap * 4 + (within >> 4)) *
               kCellBN +
           nn) *
              16 +
          (within & 15)) = packed;
    }
    return;
  }
  // 8 channels a thread: x then h of each pixel, zeros past CX or CH
  const int gx = cxp / 8, gh = chp / 8;
  const int64_t total = npix * (gx + gh);
  for (int64_t i = (int64_t)(blockIdx.x - w_blocks) * kPrepThreads +
                   threadIdx.x;
       i < total; i += (int64_t)(gridDim.x - w_blocks) * kPrepThreads) {
    const int64_t pix = i / (gx + gh);
    const int gq = (int)(i - pix * (gx + gh));
    const bool is_x = gq < gx;
    const int grp = is_x ? gq : gq - gx, C = is_x ? CX : CH;
    uint2 q = make_uint2(0u, 0u);
    if (grp * 8 < C) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          (is_x ? x : h) + pix * C + grp * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      const float s = is_x ? inv_sx : 127.f;
      q.x = quant4(e, s);
      q.y = quant4(e + 4, s);
    }
    *reinterpret_cast<uint2*>((is_x ? xq + pix * cxp : hq + pix * chp) +
                              grp * 8) = q;
  }
}

template <int MODE>
int launch(const void* xq, const void* hq, void* c, const void* w,
           const void* ws, const void* bias, void* h_out, int B, int H,
           int W, int CX, int CH, int th, int tw, int grid, int smem,
           void* stream) {
  return cell_launch<true, MODE>(xq, hq, c, w, ws, bias, h_out, B, H, W, CX,
                                 CH, th, tw, grid, smem, stream);
}

}  // namespace

// The absmax kernel alone over n bf16 values (16-byte aligned): one
// partial a block into `partials` (kMaxPartials f32), the blocks past
// absmax_blocks(n) untouched. Data parallel reduces the partials over the
// ranks and hands the prep the global maximum (n_given = 1).
extern "C" int ess_int8_absmax(const void* x, long long n, void* partials,
                               void* stream) {
  if (n <= 0) return 0;
  absmax_kernel<<<absmax_blocks(n), kPrepThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (int64_t)n, (float*)partials);
  return (int)cudaGetLastError();
}

// The prep of one int8 cell, two launches (one when n_given > 0: then
// `partials` holds n_given maxima of |x| already, ess_int8_absmax's or
// their maximum over data-parallel ranks, and the absmax kernel is
// skipped). x: bf16 NHWC (B, H, W, CX), h:
// (B, H, W, CH), CX and CH multiples of 32; w: the f32 prepared gate matrix
// (4*CH, 9*(CX+CH)) (ops/conv_lstm.py::prepare_gate_weights); partials:
// f32 scratch of kMaxPartials; scal: 2 f32 (s_x, 1/s_x); w_img: int8
// (4*CH/128, chunks, 36, 128, 16); ws: f32 (4*CH,); xq, hq: int8 NHWC with
// CX, CH rounded up to 64 channels. All 16-byte aligned.
extern "C" int ess_conv_lstm_int8_prep(const void* x, const void* h,
                                       const void* w, void* partials,
                                       int n_given, void* scal, void* w_img,
                                       void* ws, void* xq, void* hq, int B,
                                       int H, int W, int CX, int CH,
                                       void* stream) {
  const int64_t npix = (int64_t)B * H * W;
  if (npix == 0) return 0;
  if (CX <= 0 || CH <= 0 || CX % 32 || CH % 32 || n_given < 0 ||
      n_given > kMaxPartials)
    return (int)cudaErrorInvalidValue;
  const int na = n_given ? n_given : absmax_blocks(npix * CX);
  if (!n_given)
    absmax_kernel<<<na, kPrepThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, npix * CX, (float*)partials);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int w_blocks = (4 * CH + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  const int64_t groups =
      npix * ((CX + 63) / 64 * 64 + (CH + 63) / 64 * 64) / 8;
  const int qb = (int)std::min<int64_t>(
      kMaxQuantBlocks, (groups + kPrepThreads - 1) / kPrepThreads);
  prep_kernel<<<w_blocks + qb, kPrepThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)h, (const float*)w,
      (const float*)partials, na, (float*)scal, (int8_t*)w_img, (float*)ws,
      (int8_t*)xq, (int8_t*)hq, npix, CX, CH, w_blocks);
  return (int)cudaGetLastError();
}

// xq, hq: the int8 copies of ess_conv_lstm_int8_prep; c: bf16 NHWC
// (B, H, W, CH), updated in place; w, ws: the prep's weight image and
// column scales; bias: f32 (4*CH,) in i, f, o, g order; h_out: bf16 NHWC.
// The plan (th, tw, grid, smem) is ops/conv_halo.py::cell_plan's with
// int8=True.
extern "C" int ess_conv_lstm_int8(const void* xq, const void* hq, void* c,
                                  const void* w, const void* ws,
                                  const void* bias, void* h_out, int B, int H,
                                  int W, int CX, int CH, int th, int tw,
                                  int grid, int smem, void* stream) {
  return launch<kFull>(xq, hq, c, w, ws, bias, h_out, B, H, W, CX, CH, th,
                       tw, grid, smem, stream);
}

// The same cell in the attribution variant `mode`: a CellMode other than
// kFull, which is ess_conv_lstm_int8 and is refused here.
extern "C" int ess_conv_lstm_int8_mode(const void* xq, const void* hq,
                                       void* c, const void* w, const void* ws,
                                       const void* bias, void* h_out, int B,
                                       int H, int W, int CX, int CH, int th,
                                       int tw, int grid, int smem, int mode,
                                       void* stream) {
#define ESS_CELL_MODE(M)                                                    \
  case M:                                                                   \
    return launch<M>(xq, hq, c, w, ws, bias, h_out, B, H, W, CX, CH, th,    \
                     tw, grid, smem, stream);
  switch (mode) {
    ESS_CELL_MODE(kPtwBf16)
    ESS_CELL_MODE(kPtwMul)
    ESS_CELL_MODE(kNoPtw)
    ESS_CELL_MODE(kNoBuild)
  }
#undef ESS_CELL_MODE
  return (int)cudaErrorInvalidValue;
}
