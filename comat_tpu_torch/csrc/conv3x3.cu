// 3x3 stride-1 SAME convolution forward for Hopper (sm_90a), NHWC, no bias.
//
// Replaces the TPU kernels comat_tpu/ops/conv3x3.py:_conv_strip_kernel and
// _conv_resident_kernel (both reached through _fwd_impl / conv3x3_same from
// the VAE's Conv3x3 module). The two TPU variants are VMEM-fit choices for
// one function; here one implicit-GEMM kernel computes it:
//   y[m, n] = sum_k A[m, k] W[k, n],   m = (b, y, x), k = (di, dj, c),
//   A[m, k] = x[b, y + di - 1, x + dj - 1, c]  (zero outside the image),
// with M = B*H*W, N = Cout, K = 9*C, fp32 accumulation and the output in
// the input dtype.
//
// What bounds it on the H100: the VAE decoder's convs do 2*9*C*Cout flops
// per output pixel against (C + Cout) elements of traffic, i.e. hundreds
// of flops per byte at C, Cout >= 128, so the bound is arithmetic.
//
// Design (simple first, fast later): the classic 128x128x8 shared-memory
// GEMM tile on the CUDA cores in fp32, 256 threads each owning an 8x8
// block of outputs, with the next K slice prefetched into registers while
// the current one is multiplied. The 1-pixel halo is a bounds check on the
// gathered A rows: no padded copy of x and no im2col buffer in device
// memory. C must be a multiple of 8, so each 8-wide K slice lies inside one
// tap and its 8 channels are contiguous in x. No tensor cores yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 8;
constexpr int LDA = BM + 4;  // the two 4-channel halves of a row land 16 banks apart

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                   int B, int H, int W, int C, int Cout) {
  __shared__ __align__(16) float As[BK][LDA];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long M = static_cast<long long>(B) * H * W;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;

  // A loader: one output pixel (row of A) and 4 of the slice's 8 channels
  const int a_r = tid >> 1, a_c = (tid & 1) * 4;
  const long long am = m0 + a_r;
  const bool a_row_ok = am < M;
  int ab = 0, ay = 0, ax = 0;
  if (a_row_ok) {
    ab = static_cast<int>(am / (static_cast<long long>(H) * W));
    const int rem = static_cast<int>(am % (static_cast<long long>(H) * W));
    ay = rem / W;
    ax = rem % W;
  }
  // B loader: one K row, 4 consecutive output channels
  const int b_r = tid >> 5, b_c = (tid & 31) * 4;

  float a_reg[4], b_reg[4];

#define LOAD_SLICE(k0)                                                                   \
  {                                                                                      \
    const int tap = (k0) / C, c0 = (k0) - tap * C;                                       \
    const int iy = ay + tap / 3 - 1, ix = ax + tap % 3 - 1;                              \
    const bool ok = a_row_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;                  \
    if (ok) {                                                                            \
      const T* src = x + ((static_cast<long long>(ab) * H + iy) * W + ix) * C + c0 + a_c; \
      _Pragma("unroll") for (int e = 0; e < 4; ++e) a_reg[e] = to_f(src[e]);             \
    } else {                                                                             \
      _Pragma("unroll") for (int e = 0; e < 4; ++e) a_reg[e] = 0.f;                      \
    }                                                                                    \
    const T* wsrc = w + static_cast<long long>((k0) + b_r) * Cout + n0 + b_c;            \
    _Pragma("unroll") for (int e = 0; e < 4; ++e) b_reg[e] =                             \
        (n0 + b_c + e < Cout) ? to_f(wsrc[e]) : 0.f;                                     \
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  LOAD_SLICE(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) As[a_c + e][a_r] = a_reg[e];
    *reinterpret_cast<float4*>(&Bs[b_r][b_c]) = make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
    __syncthreads();
    if (k0 + BK < K) LOAD_SLICE(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#undef LOAD_SLICE

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    T* dst = y + m * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < Cout) dst[n] = from_f<T>(acc[i][j]);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): x (B, H, W, C) and w (3, 3, C,
// Cout) contiguous, y (B, H, W, Cout) contiguous, all fp32 or all bf16.
// Returns the cudaError_t of the launch.
extern "C" int comat_conv3x3_fwd(const void* x, const void* w, void* y, int is_bf16, int B, int H,
                                 int W, int C, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || C % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * H * W;
  const long long mblocks = (M + BM - 1) / BM;
  if (mblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(mblocks), (Cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    conv3x3_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), B, H, W, C, Cout);
  } else {
    conv3x3_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(w),
                                                    static_cast<float*>(y), B, H, W, C, Cout);
  }
  return static_cast<int>(cudaGetLastError());
}
