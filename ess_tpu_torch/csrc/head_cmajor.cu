// E2VID head conv on a C-major space-to-depth window, normalize fused.
//
// Replaces the TPU kernel tools/bench_head.py::kern (built by make_pallas,
// pallas_call at :133): a 3x3 SAME conv over the 2x2 space-to-depth window
// (20 -> 128 channels for 5 bins and a 32-channel head) read straight from
// the channel-major (NCHW) layout the voxelizers write, with the per-window
// nonzero normalize applied to every input value on the way in:
//   v -> where(v != 0, (v - shift) * scale, 0), f32, rounded once to bf16,
// then f32 accumulation of bf16 products, + bias, ReLU, one rounding to
// bf16, stored NHWC or NCHW. The TPU kernel builds 180 (th, W) plane copies
// and contracts their outer dimension; none of that is carried over.
//
// Design: the implicit GEMM of conv3x3_common.cuh (M = pixels in 128-pixel
// tiles, N = C_out in 128-column tiles, K = 9 taps x 32 channels, C_in
// padded to 32 per tap, mma.sync m16n8k16, 8 warps of 64 x 32) with two
// other ends:
// - the A tile cannot be copied with cp.async: the input is C-major and
//   every value must be normalized before the product. Each thread owns one
//   pixel of the tile and every other channel; per tap it loads its values
//   (consecutive threads read consecutive pixels of one channel plane),
//   normalizes them in registers with __fsub_rn / __fmul_rn (no contraction
//   into a fused multiply-add), rounds once to bf16 and stores them into a
//   K-major shared tile ([channel][pixel]); ldmatrix.trans turns that into
//   the row-major A fragment. Conv padding and the channels past C_in are
//   zeros written after the normalize. The next tap's loads are issued
//   before the current tap's products, the weights arrive by cp.async into
//   a two-stage ring.
// - the NCHW store stages the bf16 tile transposed ([channel][pixel]) and
//   writes 16-byte runs along the pixel axis: with H*W a multiple of 128
//   (220 x 320 = 550 x 128) a tile never crosses an image and its pixels are
//   contiguous in every channel plane. Other shapes store pixel by pixel.
//
// Bounds on the H100 at B=8, 220x320: 22.5 MB read and 144.2 MB written
// (0.050 ms at 3.35 TB/s) for 25.9 GFLOP (0.026 ms at 989 TFLOP/s): the
// output bytes bound it, so the stores are the part that must be coalesced.
// The kernel multiplies 288 K columns per pixel for the 180 real ones.

#include "conv3x3_common.cuh"

namespace {

constexpr int kBM = 128;                 // pixels per block
constexpr int kBN = 128;                 // output channels per block
constexpr int kKP = 32;                  // K per tap: C_in padded to 32
constexpr int kThreads = 256;
constexpr int kPerThread = kKP / 2;      // channels per thread per tap
constexpr int kLDA = kBM + 8;            // A row (one channel), bf16: 272 B
constexpr int kLDB = kKP + 8;            // B row (one output channel): 80 B
constexpr int kLDC = kBM + 8;            // epilogue row, bf16: 272 B
constexpr int kABytes = kKP * kLDA * 2;
constexpr int kBBytes = kBN * kLDB * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kCBytes = kBM * kLDC * 2;
constexpr int kSmem =
    2 * kStageBytes > kCBytes ? 2 * kStageBytes : kCBytes;

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(ess::smem_u32(p)));
}

__global__ void __launch_bounds__(kThreads, 2)
head_cmajor_kernel(const __nv_bfloat16* __restrict__ x,   // (B, CIN, H, W)
                   const unsigned char* __restrict__ w,   // (COUT, 9*kKP) bf16
                   const float* __restrict__ bias,        // (COUT,)
                   __nv_bfloat16* __restrict__ out,       // NHWC or NCHW
                   int B, int H, int W, int CIN, int COUT, float shift,
                   float scale, int nchw_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps of 64 x 32
  const int HW = H * W, M = B * HW;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // A loader: this thread's pixel, and channels a_c0, a_c0 + 2, ...
  const int a_pix = tid & (kBM - 1), a_c0 = tid >> 7;
  const int a_m = m0 + a_pix;
  const bool a_ok = a_m < M;
  const int a_b = a_ok ? a_m / HW : 0;
  const int a_rem = a_ok ? a_m - a_b * HW : 0;
  const int a_y = a_rem / W, a_x = a_rem - a_y * W;
  const __nv_bfloat16* a_img = x + (int64_t)a_b * CIN * HW;

  auto a_tile = [&](int stage) {
    return reinterpret_cast<__nv_bfloat16*>(smem + stage * kStageBytes);
  };
  auto b_tile = [&](int stage) {
    return smem + stage * kStageBytes + kABytes;
  };

  // normalized bf16 values of this thread's channels at tap (dy, dx); zero
  // outside the image (the conv's padding) and past CIN (the K padding)
  auto load_a = [&](int tap, __nv_bfloat16 (&v)[kPerThread]) {
    const int sy = a_y + tap / 3 - 1, sx = a_x + tap % 3 - 1;
    const bool ok = a_ok && sy >= 0 && sy < H && sx >= 0 && sx < W;
    const __nv_bfloat16* src = a_img + (ok ? sy * W + sx : 0);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = a_c0 + 2 * j;
      float f = 0.f;
      if (ok && c < CIN) {
        const float raw = __bfloat162float(src[(int64_t)c * HW]);
        f = raw != 0.f ? __fmul_rn(__fsub_rn(raw, shift), scale) : 0.f;
      }
      v[j] = __float2bfloat16_rn(f);
    }
  };
  auto store_a = [&](int stage, const __nv_bfloat16 (&v)[kPerThread]) {
    __nv_bfloat16* a = a_tile(stage);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      a[(a_c0 + 2 * j) * kLDA + a_pix] = v[j];
  };
  auto load_b = [&](int stage, int tap) {
    unsigned char* b = b_tile(stage);
    for (int c = tid; c < kBN * 4; c += kThreads) {
      const int row = c >> 2, part = (c & 3) * 16;
      const bool ok = n0 + row < COUT;
      ess::cp_async_zfill<16>(
          b + row * kLDB * 2 + part,
          ok ? w + ((int64_t)(n0 + row) * 9 * kKP + tap * kKP) * 2 + part
             : w,
          ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  __nv_bfloat16 va[kPerThread];
  load_b(0, 0);
  ess::cp_async_commit();
  load_a(0, va);
  store_a(0, va);
  ess::cp_async_wait<0>();
  __syncthreads();

  for (int tap = 0; tap < 9; ++tap) {
    const int cur = tap & 1;
    if (tap + 1 < 9) {
      load_b(cur ^ 1, tap + 1);
      ess::cp_async_commit();
      load_a(tap + 1, va);
    }
    const __nv_bfloat16* a = a_tile(cur);
    const unsigned char* bs = b_tile(cur);
#pragma unroll
    for (int kk = 0; kk < kKP; kk += 16) {
      unsigned af[4][4], bf[4][2];
      const int q = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int k = kk + (q >> 1) * 8 + r8;
        const int m = wm * 64 + mt * 16 + (q & 1) * 8;
        ldmatrix_x4_trans(af[mt], a + k * kLDA + m);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r4[4];
        const int row = wn * 32 + np * 16 + (lane >> 4) * 8 + (lane & 7);
        ess::ldmatrix_x4(r4, bs + row * kLDB * 2 + kk * 2 +
                                 ((lane >> 3) & 1) * 16);
        bf[np * 2][0] = r4[0];
        bf[np * 2][1] = r4[1];
        bf[np * 2 + 1][0] = r4[2];
        bf[np * 2 + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          ess::mma_tile(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    if (tap + 1 < 9) store_a(cur ^ 1, va);
    ess::cp_async_wait<0>();
    __syncthreads();   // the other stage is ready, this one is free
  }

  // epilogue: bias + ReLU, bf16 tile staged in shared memory as [pixel][n]
  // (NHWC) or [n][pixel] (NCHW), then 16-byte stores along the minor axis
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = wn * 32 + nt * 8 + (lane & 3) * 2;
    const float b0 = n0 + col < COUT ? bias[n0 + col] : 0.f;
    const float b1 = n0 + col + 1 < COUT ? bias[n0 + col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 64 + mt * 16 + (lane >> 2) + half * 8;
        const float v0 = fmaxf(acc[mt][nt][half * 2] + b0, 0.f);
        const float v1 = fmaxf(acc[mt][nt][half * 2 + 1] + b1, 0.f);
        if (nchw_out) {
          cs[col * kLDC + row] = __float2bfloat16_rn(v0);
          cs[(col + 1) * kLDC + row] = __float2bfloat16_rn(v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(cs + row * kLDC + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  __syncthreads();
  if (!nchw_out) {
    for (int c = tid; c < kBM * (kBN / 8); c += kThreads) {
      const int row = c / (kBN / 8), cc = (c % (kBN / 8)) * 8;
      const int m = m0 + row, n = n0 + cc;
      if (m < M && n < COUT)
        *reinterpret_cast<uint4*>(out + (int64_t)m * COUT + n) =
            *reinterpret_cast<const uint4*>(cs + row * kLDC + cc);
    }
    return;
  }
  const int b0i = m0 / HW, rem0 = m0 - b0i * HW;
  const bool runs = HW % 8 == 0 && m0 + kBM <= M && rem0 + kBM <= HW;
  for (int c = tid; c < kBN * (kBM / 8); c += kThreads) {
    const int nr = c / (kBM / 8), pc = (c % (kBM / 8)) * 8;
    const int n = n0 + nr;
    if (n >= COUT) continue;
    if (runs) {
      *reinterpret_cast<uint4*>(out + ((int64_t)b0i * COUT + n) * HW + rem0 +
                                pc) =
          *reinterpret_cast<const uint4*>(cs + nr * kLDC + pc);
    } else {
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + pc + i;
        if (m >= M) break;
        const int bi = m / HW;
        out[((int64_t)bi * COUT + n) * HW + (m - bi * HW)] =
            cs[nr * kLDC + pc + i];
      }
    }
  }
}

}  // namespace

// x: bf16 (B, CIN, H, W) contiguous, CIN <= 32; w: bf16 (COUT, 9*32) with
// column (dy*3 + dx)*32 + cin, zero for cin >= CIN, 16-byte aligned; bias:
// f32 (COUT,); out: bf16 (B, H, W, COUT) or, with nchw_out, (B, COUT, H, W),
// 16-byte aligned; COUT a multiple of 8.
extern "C" int ess_head_cmajor(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int CIN,
                               int COUT, float shift, float scale,
                               int nchw_out, void* stream) {
  const int64_t M = (int64_t)B * H * W;
  if (M == 0 || COUT == 0) return 0;
  if (CIN <= 0 || CIN > kKP || COUT % 8 != 0 || M > (int64_t)INT32_MAX - kBM)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_cmajor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 blocks((unsigned)((M + kBM - 1) / kBM), (COUT + kBN - 1) / kBN);
  head_cmajor_kernel<<<blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const unsigned char*)w, (const float*)bias,
      (__nv_bfloat16*)out, B, H, W, CIN, COUT, shift, scale, nchw_out);
  return (int)cudaGetLastError();
}
