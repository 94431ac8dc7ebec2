// int8 implicit-GEMM convolution of the W8A8 pass 1 (--pass1_int8) for
// Hopper (sm_90a): NHWC int8 codes x, int8 weight codes w, exact int32 sums,
// and an epilogue that applies the dequantize and bias.
//
// No TPU kernel: JAX runs its int8 conv through XLA
// (comat_tpu/models/quant.py `QConv`: lax.conv_general_dilated on the codes
// with preferred_element_type=int32, then `_dequant_bias`), so this is a
// kernel of the port with no Pallas counterpart. As a GEMM:
//   acc[m, n] = sum_k A[m, k] W[n, k],  m = (b, ho, wo), k = (dy, dx, c),
//   A[m, k]   = x[b, ho*stride - pad + dy, wo*stride - pad + dx, c]
//               (code 0 outside the image),
// with M = B*Ho*Wo, N = Cout, K = ks*ks*C and w stored (Cout, ks*ks*C), K
// contiguous (both operands K-major, as the s8 tensor-core products take
// them). The sums are exact in int32: |acc| <= 127^2 * 9 * 2560 < 2^31.
// The epilogue writes either the int32 sums (out_kind 0, for checks) or
//   y = (float(acc) * sx[b]) * ws[n] (+ bias[n])
// with __fmul_rn / __fadd_rn in JAX's order, one rounding to the output
// dtype (fp32, or bf16 round to nearest even), NHWC: a channels_last
// tensor. The UNet's convs are 3x3 at stride 1 (resnet conv1/conv2,
// Upsample2D after the nearest resize) and 2 (Downsample2D), and 1x1
// (conv_shortcut); every UNet channel count of SD1.5 and SDXL is a multiple
// of 64, so a 64-deep K slice never crosses a tap (C % 64 == 0 is required).
//
// What bounds it on the H100: 2*K operations a sum against ~(C + Cout)
// bytes a pixel, hundreds of operations a byte: the int8 tensor-core rate.
// This first design is simple: a CTA owns a 128 x 128 output tile; 8 warps
// as 2 x 4, each a 64 x 32 tile of mma.sync.m16n8k32 s8 products (16 a k
// step of 32); the A and B tiles (128 rows of 64 bytes, rows padded to 80
// bytes so that the fragments' 32-bit reads hit 32 distinct banks) come in
// with cp.async, 16 bytes a copy, zero-filled outside the image and past
// Cout and M, double-buffered. Not wgmma and not TMA: a later PR's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // bytes a shared-memory row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

enum OutKind { kInt32 = 0, kF32 = 1, kBF16 = 2 };

template <int kOut>
__device__ __forceinline__ void store(void* out, long long i, int acc, float sx, float ws,
                                      const float* bias, int n) {
  if (kOut == kInt32) {
    static_cast<int32_t*>(out)[i] = acc;
    return;
  }
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), ws);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  if (kOut == kF32)
    static_cast<float*>(out)[i] = y;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
}

template <int kOut>
__global__ void __launch_bounds__(kThreads)
    conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   void* __restrict__ out, const float* __restrict__ sx,
                   const float* __restrict__ ws, const float* __restrict__ bias, int H, int W,
                   int C, int Ho, int Wo, int Cout, int ks, int stride, int pad, long long M) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const long long HWo = static_cast<long long>(Ho) * Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = ks * ks * C;
  const int KT = K / BK;

  // the loader: rows tid/4 and tid/4 + 64 of both tiles, 16 bytes at
  // offset (tid % 4) * 16; each A row's pixel is fixed for the whole loop
  const int part = tid & 3;
  long long lbase[2];
  int lh[2], lw[2];
  bool lm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + i * 64;
    lm[i] = m < M;
    const long long mm = lm[i] ? m : 0;
    const long long b = mm / HWo, r = mm - b * HWo;
    lbase[i] = b * H;
    lh[i] = static_cast<int>(r / Wo) * stride - pad;
    lw[i] = static_cast<int>(r % Wo) * stride - pad;
  }
  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / C, c0 = k0 - tap * C;
    const int dy = tap / ks, dx = tap - dy * ks;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const int hi = lh[i] + dy, wi = lw[i] + dx;
      const bool ok = lm[i] && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const int8_t* src = ok ? x + ((lbase[i] + hi) * W + wi) * C + c0 + part * 16 : x;
      cp_async16(&As[stage][row * LDS + part * 16], src, ok);
      const bool okb = n0 + row < Cout;
      const int8_t* srcb = okb ? w + static_cast<long long>(n0 + row) * K + k0 + part * 16 : w;
      cp_async16(&Bs[stage][row * LDS + part * 16], srcb, okb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* a_s = As[kt & 1];
    const int8_t* b_s = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = a_s + (wm * 64 + mi * 16 + g) * LDS + kk + t * 4;
        af[mi][0] = *reinterpret_cast<const unsigned*>(p);
        af[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = b_s + (wn * 32 + ni * 8 + g) * LDS + kk + t * 4;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(p);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // accumulator (mi, ni, j): row g (j < 2) or g + 8, column t*2 + j % 2
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const float s = kOut == kInt32 ? 0.0f : sx[m / HWo];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * 32 + ni * 8 + t * 2 + j;
          if (n < Cout)
            store<kOut>(out, m * Cout + n, acc[mi][ni][half * 2 + j], s,
                        kOut == kInt32 ? 0.0f : ws[n], bias, n);
        }
    }
}

}  // namespace

// x (B, H, W, C) int8, w (Cout, ks*ks*C) int8 -> out (B, Ho, Wo, Cout):
// out_kind 0 int32 sums; 1 fp32, 2 bf16 dequantized with sx (B,), ws (Cout,)
// and bias (Cout,) fp32 (bias may be null). C % 64 == 0. Returns a
// cudaError_t.
extern "C" int comat_conv_s8(const void* x, const void* w, void* out, const void* sx,
                             const void* ws, const void* bias, int out_kind, int B, int H, int W,
                             int C, int Cout, int ks, int stride, int pad, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || ks <= 0 || stride <= 0 || pad < 0 ||
      C % BK != 0 || out_kind < 0 || out_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H + 2 * pad - ks) / stride + 1, Wo = (W + 2 * pad - ks) / stride + 1;
  if (Ho <= 0 || Wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long mblocks = (M + BM - 1) / BM;
  if (mblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(mblocks), (Cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xq = static_cast<const int8_t*>(x);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fw = static_cast<const float*>(ws);
  const auto* fb = static_cast<const float*>(bias);
  if (out_kind == kInt32)
    conv_s8_kernel<kInt32><<<grid, kThreads, 0, s>>>(xq, wq, out, fx, fw, fb, H, W, C, Ho, Wo,
                                                      Cout, ks, stride, pad, M);
  else if (out_kind == kF32)
    conv_s8_kernel<kF32><<<grid, kThreads, 0, s>>>(xq, wq, out, fx, fw, fb, H, W, C, Ho, Wo,
                                                    Cout, ks, stride, pad, M);
  else
    conv_s8_kernel<kBF16><<<grid, kThreads, 0, s>>>(xq, wq, out, fx, fw, fb, H, W, C, Ho, Wo,
                                                     Cout, ks, stride, pad, M);
  return static_cast<int>(cudaGetLastError());
}
