// Fused 3x3 SAME conv + bias + optional ReLU over NHWC, int8 operands
// (B4-int8).
//
// Replaces the int8 variant of the TPU kernel
// ess_tpu/ops/conv3x3_pallas.py::_conv_kernel (int8=True), which quantizes
// its bf16 row tile in VMEM by a per-call absmax scale, multiplies it on the
// int8 MXU path against per-output-channel quantized weights (the scale
// folded in, :94-100) and dequantizes the i32 accumulator with one multiply
// per column.
//
// Bounds on the H100 at B=8: the same bytes as the bf16 conv (bf16 in and
// out) at twice the operation rate, so both the head conv (22.5 MB in,
// 144.2 MB out: 0.050 ms) and encoder 0 (144.2 MB in, 72.1 MB out: 0.065
// ms) are bound by bytes. The x scale needs the absmax of x before any
// product, so x is read twice (the absmax pass and the conv).
//
// Three launches per conv, no torch op between them and no host sync (the
// scales stay on the device):
// 1. absmax_kernel (conv_halo.cuh, shared with B2-int8): per-block maxima
//    of |x| over bf16 bits into `partials`.
// 2. weight_prep_kernel: every block reduces the partials to
//    s_x = max(amax, 1e-8) / 127 and 1/s_x (conv_halo.cuh::x_scales, as
//    input_scale and torch.reciprocal compute them; block 0 stores both);
//    then one warp per output channel folds s_x into the f32 tap matrix
//    with __fmul_rn, ws = max(absmax, 1e-20) / 127 and
//    wq = clip(rint(w~ / ws), -127, 127) with __fdiv_rn, in the plain
//    order (ops/conv3x3.py::quantize_conv_weights, bit for bit), into the
//    s8 (COUT, 9*CP) matrix that the conv's weight loader reads.
// 3. the halo-tile conv of conv_halo.cuh with s8 operands, 64 channels a
//    64-byte chunk, wgmma .s32.s8.s8 with A from registers. Its loader
//    copies the chunk's bf16 pixels with cp.async and quantizes them in
//    shared memory (x * (1/s_x), rounded half to even), so no int8 copy of
//    x is written: for encoder 0 at B=8 that saves a pass that read 144 MB
//    and wrote 72 MB and the conv's 72 MB read of it. The s8 weights of
//    both DSEC convs take 73.7 KB of shared memory, half the bf16 ones,
//    which leaves room for the bf16 raw stages. Encoder 0 runs
//    conv3x3_int8_ws_kernel, where a producer warpgroup copies and
//    quantizes while two warpgroups multiply; the head keeps two blocks an
//    SM on conv3x3_halo_kernel<true> (ops/conv_halo.py::conv_plan chooses).
//    Epilogue: out = float(acc) * ws + bias, ReLU, one rounding to bf16,
//    each f32 operation rounded on its own as in the plain version's
//    elementwise ops, so the kernel equals the plain int8 conv bit for
//    bit.

#include "conv_halo.cuh"

namespace {

using namespace ess::halo;

__device__ __forceinline__ unsigned quant_w(float v, float s_x, float s) {
  const float q =
      fminf(fmaxf(rintf(__fdiv_rn(__fmul_rn(v, s_x), s)), -127.f), 127.f);
  return (unsigned)(int)q & 0xffu;
}

__global__ void __launch_bounds__(kPrepThreads)
weight_prep_kernel(const float* __restrict__ w,   // (COUT, K) prepared f32
                   const float* __restrict__ partials, int n_partials,
                   float* __restrict__ scal,      // s_x, 1/s_x
                   int8_t* __restrict__ wq, float* __restrict__ ws, int COUT,
                   int K) {
  __shared__ float red[kPrepThreads / 32];
  const float2 sc = x_scales(partials, n_partials, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scal[0] = sc.x;
    scal[1] = sc.y;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * (kPrepThreads / 32) + warp;
  if (n >= COUT) return;
  const float4* row = reinterpret_cast<const float4*>(w + (int64_t)n * K);
  float am = 0.f;
  for (int k = lane; k < K / 4; k += 32) {
    const float4 v = row[k];
    am = fmaxf(am, fmaxf(fmaxf(fabsf(__fmul_rn(v.x, sc.x)),
                               fabsf(__fmul_rn(v.y, sc.x))),
                         fmaxf(fabsf(__fmul_rn(v.z, sc.x)),
                               fabsf(__fmul_rn(v.w, sc.x)))));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) am = fmaxf(am, __shfl_xor_sync(~0u, am, o));
  const float s = __fdiv_rn(fmaxf(am, 1e-20f), 127.f);
  if (lane == 0) ws[n] = s;
  unsigned* dst = reinterpret_cast<unsigned*>(wq + (int64_t)n * K);
  for (int k = lane; k < K / 4; k += 32) {
    const float4 v = row[k];
    dst[k] = quant_w(v.x, sc.x, s) | quant_w(v.y, sc.x, s) << 8 |
             quant_w(v.z, sc.x, s) << 16 | quant_w(v.w, sc.x, s) << 24;
  }
}

}  // namespace

// The prep of one int8 conv, two launches (one when n_given > 0: then
// `partials` holds n_given maxima of |x| already, see ess_int8_absmax in
// conv_lstm_int8.cu). x: bf16 NHWC (B, H, W, CIN), CIN
// a multiple of 4; w: the f32 prepared tap matrix (COUT, 9*CP) with CP =
// CIN rounded up to 64 (ops/conv3x3.py::prepare_conv_weights(int8=True));
// partials: f32 scratch of kMaxPartials; scal: 2 f32 (s_x, 1/s_x); wq: s8
// (COUT, 9*CP); ws: f32 (COUT,). All 16-byte aligned.
extern "C" int ess_conv3x3_int8_prep(const void* x, const void* w,
                                     void* partials, int n_given,
                                     void* scal, void* wq, void* ws, int B,
                                     int H, int W, int CIN, int COUT,
                                     void* stream) {
  const int64_t n = (int64_t)B * H * W * CIN;
  if (n == 0 || COUT == 0) return 0;
  if (CIN <= 0 || CIN % 4 != 0 || COUT % 8 != 0 || n_given < 0 ||
      n_given > kMaxPartials)
    return (int)cudaErrorInvalidValue;
  const int na = n_given ? n_given : absmax_blocks(n);
  if (!n_given)
    absmax_kernel<<<na, kPrepThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, n, (float*)partials);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const int K = 9 * ((CIN + 63) / 64 * 64);
  const int rows = kPrepThreads / 32;
  weight_prep_kernel<<<(COUT + rows - 1) / rows, kPrepThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)w, (const float*)partials, na, (float*)scal,
      (int8_t*)wq, (float*)ws, COUT, K);
  return (int)cudaGetLastError();
}

// x: bf16 NHWC (B, H, W, CIN); wq, ws, scal: the prep's; bias: f32 (COUT,);
// out: bf16 NHWC (B, H, W, COUT). The plan (th, tw, resident, q_stages,
// grid_x, smem) is ops/conv_halo.py::conv_plan's with int8=True.
extern "C" int ess_conv3x3_int8(const void* x, const void* wq, const void* ws,
                                const void* scal, const void* bias, void* out,
                                int B, int H, int W, int CIN, int COUT,
                                int relu, int th, int tw, int resident,
                                int q_stages, int grid_x, int smem,
                                void* stream) {
  return conv_launch<true>(x, wq, ws, scal, bias, out, B, H, W, CIN, COUT,
                           relu, th, tw, resident, q_stages, grid_x, smem,
                           stream);
}
