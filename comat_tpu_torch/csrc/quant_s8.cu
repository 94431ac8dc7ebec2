// Symmetric dynamic int8 quantization and the int32 -> float dequantize of
// the W8A8 pass 1 (--pass1_int8), for Hopper (sm_90a).
//
// No TPU kernel: JAX computes W8A8 through XLA (comat_tpu/models/quant.py
// `_quant_dynamic`, `_weight_quant`, `_dequant_bias`), so these are kernels
// of the port with no Pallas counterpart. Their arithmetic is JAX's, to the
// bit:
//   quantize: per group g of n values (a linear's token row, a conv's whole
//     sample (H, W, C), a weight's output channel),
//       s[g] = max(max |x|, 1e-12) / 127            (fp32, IEEE division)
//       q    = clip(rint(x / s[g]), -127, 127)       (round half to even)
//   dequantize: y = (float(acc) * s_x[row]) * w_s[col] (+ bias[col]),
//     fp32 with IEEE rounding at each step, then one rounding to the
//     output dtype (bf16 round to nearest even).
// The divisions are __fdiv_rn and the products __fmul_rn / __fadd_rn, so no
// contraction into an FMA and no approximate reciprocal changes a code:
// build without --use_fast_math.
//
// What bounds it on the H100: both passes move bytes and do a few
// operations each (quantize: read x twice, write one byte a value;
// dequantize: read 4 bytes, write 2 or 4 a value), so the bound is the
// memory rate. Design, simple first: the group's absmax is taken by
// blocks of kChunk values each, reduced in the block and combined across
// blocks with atomicMax on the bits of a non-negative float (the order of
// non-negative floats is the order of their bits, so the result does not
// depend on the blocks' order); a second kernel over the same blocks
// writes the codes and, from the group's first block, the scale (a
// row-parallel layer under tensor parallelism runs the two passes as two
// launches, its ranks' absmax reduced by a MAX all-reduce between). A group
// of up to ~2.6 M values (a conv's sample at 64^2 x 640) spreads over
// hundreds of blocks, a token row of 320-5120 values takes one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 4096;  // values a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const T* __restrict__ x, long long n, long long chunks,
                  unsigned* __restrict__ amax) {
  const long long g = blockIdx.x / chunks;
  const long long start = g * n + (blockIdx.x % chunks) * kChunk;
  const long long end = start + kChunk < (g + 1) * n ? start + kChunk : (g + 1) * n;
  float m = 0.0f;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) m = fmaxf(m, fabsf(to_f32(x[i])));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (threadIdx.x == 0) atomicMax(&amax[g], __float_as_uint(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    codes_kernel(const T* __restrict__ x, long long n, long long chunks,
                 const unsigned* __restrict__ amax, int8_t* __restrict__ q,
                 float* __restrict__ scale) {
  const long long g = blockIdx.x / chunks;
  const long long start = g * n + (blockIdx.x % chunks) * kChunk;
  const long long end = start + kChunk < (g + 1) * n ? start + kChunk : (g + 1) * n;
  const float s = __fdiv_rn(fmaxf(__uint_as_float(amax[g]), 1e-12f), 127.0f);
  if (blockIdx.x % chunks == 0 && threadIdx.x == 0) scale[g] = s;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float v = rintf(__fdiv_rn(to_f32(x[i]), s));
    q[i] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(v, -127.0f), 127.0f)));
  }
}

template <typename OutT>
__device__ __forceinline__ OutT from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    dequant_kernel(const int32_t* __restrict__ acc, const float* __restrict__ sx,
                   long long rows_per_scale, const float* __restrict__ ws,
                   const float* __restrict__ bias, OutT* __restrict__ out, long long total,
                   int N) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long row = i / N;
    const int col = static_cast<int>(i - row * N);
    float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), sx[row / rows_per_scale]), ws[col]);
    if (bias != nullptr) y = __fadd_rn(y, bias[col]);
    out[i] = from_f32<OutT>(y);
  }
}

template <typename T>
cudaError_t quantize(const void* x, long long groups, long long n, void* q, void* scale,
                     void* amax, int phase, cudaStream_t s) {
  const long long chunks = (n + kChunk - 1) / kChunk;
  if (groups * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(groups * chunks);
  cudaError_t err = cudaSuccess;
  if (phase != 2) {
    err = cudaMemsetAsync(amax, 0, groups * sizeof(unsigned), s);
    if (err != cudaSuccess) return err;
    absmax_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), n, chunks,
                                                 static_cast<unsigned*>(amax));
    err = cudaGetLastError();
    if (err != cudaSuccess || phase == 1) return err;
  }
  codes_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), n, chunks,
                                              static_cast<const unsigned*>(amax),
                                              static_cast<int8_t*>(q),
                                              static_cast<float*>(scale));
  return cudaGetLastError();
}

}  // namespace

// x (groups, n) fp32 or bf16, contiguous -> q (groups, n) int8 and scale
// (groups,) fp32; amax: (groups,) 4 bytes, the absmax's float bits.
// phase 0: both passes (amax is scratch); 1: the absmax alone, into amax
// (q and scale unused); 2: the codes and scales from the absmax in amax (a
// tensor-parallel layer's, reduced over its ranks in between). Returns a
// cudaError_t.
extern "C" int comat_quant_s8(const void* x, int is_bf16, long long groups, long long n, void* q,
                              void* scale, void* amax, int phase, void* stream) {
  if (groups <= 0 || n <= 0 || phase < 0 || phase > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16
                              ? quantize<__nv_bfloat16>(x, groups, n, q, scale, amax, phase, s)
                              : quantize<float>(x, groups, n, q, scale, amax, phase, s));
}

// acc (M, N) int32 -> out (M, N) fp32 or bf16: (acc * sx[m / rows_per_scale])
// * ws[n] (+ bias[n]; bias may be null), all fp32.
extern "C" int comat_dequant_s8(const void* acc, const void* sx, long long rows_per_scale,
                                const void* ws, const void* bias, void* out, int out_bf16,
                                long long M, int N, void* stream) {
  if (M <= 0 || N <= 0 || rows_per_scale <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = M * N;
  const long long need = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(need < 132LL * 64 ? need : 132LL * 64);
  const auto* a = static_cast<const int32_t*>(acc);
  const auto* x = static_cast<const float*>(sx);
  const auto* w = static_cast<const float*>(ws);
  const auto* b = static_cast<const float*>(bias);
  if (out_bf16)
    dequant_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        a, x, rows_per_scale, w, b, static_cast<__nv_bfloat16*>(out), total, N);
  else
    dequant_kernel<float><<<blocks, kThreads, 0, s>>>(a, x, rows_per_scale, w, b,
                                                       static_cast<float*>(out), total, N);
  return static_cast<int>(cudaGetLastError());
}
