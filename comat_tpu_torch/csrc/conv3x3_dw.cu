// Weight gradient of the 3x3 stride-1 SAME convolution for Hopper (sm_90a),
// NHWC, no bias:
//   dw[di, dj, c, n] = sum over (b, y, x) of x[b, y + di - 1, x + dj - 1, c] * dy[b, y, x, n]
// (zero outside the image), summed in fp32 and written in the weight dtype.
//
// Replaces the TPU kernel comat_tpu/ops/conv3x3.py:_conv_dw_kernel (launched
// from _vjp_bwd when the VAE trains). The TPU kernel runs its grid in order
// and accumulates every (batch, row strip) into one resident output block;
// on the card blocks run in parallel and in no order, so the sum is split:
//   pass 1: dw^T = A^T dY as a GEMM with M = 9*C rows (tap, channel), N =
//           Cout columns and the reduction over the B*H*W pixels; each block
//           owns one 128x128 output tile and one contiguous range of pixels
//           and writes its fp32 partial sum to a workspace slice;
//   pass 2: one thread per output element adds the slices in a fixed order
//           and rounds to the weight dtype.
// No float atomics, so a run repeats bit for bit.
//
// What bounds it on the H100: 2*B*H*W*9*C*Cout operations against
// B*H*W*(C + Cout) elements read, hundreds of operations per byte at C,
// Cout >= 128: arithmetic. The output is small (9*C*Cout), so the pixel
// split is what gives the card enough blocks (about two per SM).
//
// Design (simple first, fast later): the 128x128x8 shared-memory GEMM tile
// of conv3x3.cu on the CUDA cores in fp32, 256 threads each owning 8x8
// outputs, the next 8-pixel slice prefetched into registers while the
// current one is multiplied. The halo is a bounds check on the gathered x
// rows: no padded copy and no im2col buffer. C must be a multiple of 8, so
// each 4-channel group a thread loads lies inside one tap. No tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BP = 8;  // (tap, channel) rows, Cout columns, pixels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_dw_partial(const T* __restrict__ x, const T* __restrict__ dy,
                       float* __restrict__ part, int B, int H, int W, int C, int Cout,
                       long long pix_per_split) {
  __shared__ __align__(16) float As[BP][BM];  // x taps: [pixel][(tap, channel)]
  __shared__ __align__(16) float Bs[BP][BN];  // dy: [pixel][output channel]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long M = static_cast<long long>(B) * H * W;
  const int K = 9 * C;
  const int k0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long m_begin = static_cast<long long>(blockIdx.z) * pix_per_split;
  const long long m_end = m_begin + pix_per_split < M ? m_begin + pix_per_split : M;

  // loader: one pixel of the slice, 4 consecutive rows of A and 4 columns of B
  const int lp = tid >> 5, lc = (tid & 31) * 4;
  const int kk = k0 + lc;
  const bool k_ok = kk < K;
  const int tap = k_ok ? kk / C : 0;
  const int c = kk - tap * C;
  const int di = tap / 3 - 1, dj = tap % 3 - 1;
  const int n = n0 + lc;

  float a_reg[4], b_reg[4];
  auto load_slice = [&](long long m0) {
    const long long m = m0 + lp;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a_reg[e] = 0.f;
      b_reg[e] = 0.f;
    }
    if (m < m_end) {
      const int b = static_cast<int>(m / (static_cast<long long>(H) * W));
      const int rem = static_cast<int>(m - static_cast<long long>(b) * H * W);
      const int y = rem / W, xx = rem % W;
      const int iy = y + di, ix = xx + dj;
      if (k_ok && iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const T* src = x + ((static_cast<long long>(b) * H + iy) * W + ix) * C + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) a_reg[e] = to_f(src[e]);
      }
      const T* gsrc = dy + m * Cout + n;
#pragma unroll
      for (int e = 0; e < 4; ++e) b_reg[e] = (n + e < Cout) ? to_f(gsrc[e]) : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_slice(m_begin);
  for (long long m0 = m_begin; m0 < m_end; m0 += BP) {
    *reinterpret_cast<float4*>(&As[lp][lc]) = make_float4(a_reg[0], a_reg[1], a_reg[2], a_reg[3]);
    *reinterpret_cast<float4*>(&Bs[lp][lc]) = make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
    __syncthreads();
    if (m0 + BP < m_end) load_slice(m0 + BP);
#pragma unroll
    for (int pp = 0; pp < BP; ++pp) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[pp][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[pp][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[pp][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[pp][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + static_cast<long long>(blockIdx.z) * K * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = k0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < Cout) out[static_cast<long long>(row) * Cout + col] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_dw_reduce(const float* __restrict__ part, T* __restrict__ dw, long long count,
                      int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; idx < count;
       idx += stride) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * count + idx];
    dw[idx] = from_f<T>(s);
  }
}

template <typename T>
cudaError_t run(const void* x, const void* dy, void* dw, float* work, int B, int H, int W, int C,
                int Cout, int splits, long long pix_per_split, cudaStream_t s) {
  const int K = 9 * C;
  const dim3 grid((K + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
  conv3x3_dw_partial<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(dy), work, B, H, W, C,
                                                  Cout, pix_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(K) * Cout;
  const long long blocks = (count + kThreads - 1) / kThreads;
  conv3x3_dw_reduce<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(
      work, static_cast<T*>(dw), count, splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): x (B, H, W, C) and dy (B, H, W,
// Cout) contiguous, both fp32 or both bf16; dw (3, 3, C, Cout) contiguous in
// the same dtype; `work` an fp32 scratch of splits * 9*C*Cout elements. The
// pixels are cut into `splits` ranges of `pix_per_split` (the last may be
// shorter; none is empty). Returns the cudaError_t of the launches.
extern "C" int comat_conv3x3_dw(const void* x, const void* dy, void* dw, float* work, int is_bf16,
                                int B, int H, int W, int C, int Cout, int splits,
                                long long pix_per_split, void* stream) {
  const long long M = static_cast<long long>(B) * H * W;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || C % 8 != 0 || splits <= 0 ||
      splits > 65535 || pix_per_split <= 0 || (splits - 1) * pix_per_split >= M ||
      static_cast<long long>(splits) * pix_per_split < M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? run<__nv_bfloat16>(x, dy, dw, work, B, H, W, C, Cout, splits, pix_per_split, s)
              : run<float>(x, dy, dw, work, B, H, W, C, Cout, splits, pix_per_split, s);
  return static_cast<int>(err);
}
