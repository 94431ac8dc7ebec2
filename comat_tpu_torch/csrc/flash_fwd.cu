// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(d)) v.
//
// Replaces the TPU kernel comat_tpu/ops/flash_attention.py:_flash_fwd_kernel
// (called through _fwd / flash_attention / flash_attention_diff). Same
// function: q is scaled by 1/sqrt(d) and rounded to the input dtype before
// the product (as _fwd does), keys at or past Skv are masked, the running
// max, denominator and accumulator are fp32, and the per-row logsumexp
// m + log(l) is written when the caller asks for it.
//
// What bounds it on the H100: at the UNet's shapes (S = 4096/1024/256 keys,
// d = 40/80/160) attention is far above the card's ridge point
// (4*S*d flops per 2*d*bytes of q/o), so the bound is arithmetic; the VAE's
// single head (S = 4096, d = 512) likewise.
//
// Design (simple first, fast later): one 256-thread block per (b*h, BQ-row
// q tile). The q tile is staged once in shared memory; K and V tiles of BK
// rows stream through shared memory; scores, online softmax and the P*V
// product run on the CUDA cores in fp32 with a 16x16 thread grid (each
// thread owns BQ/16 rows and every 16th column). No tensor cores yet, so
// the arithmetic bound is the fp32 rate, not the bf16 one: the table in
// PERF.md records how far the kernel is from either.
//   - d = 40/80/160 are not multiples of 16: the head dim is zero-padded
//     inside shared memory (DQK for q.k, DP for the output columns), never
//     by padded copies in device memory.
//   - d = 512 does not fit a 64-row tile of q, k, v and the accumulator in
//     227 KB: that case uses 32-row tiles (200 KB of dynamic shared memory,
//     set with cudaFuncSetAttribute).
//   - q, k, v and o are read and written through (batch, seq, head) strides
//     with a contiguous last dim, so the (B, S, H*d) projections need no
//     transpose copies.
//   - The TPU kernel's ones-column-in-V trick (a VPU workaround) is not
//     carried over: the denominator is a warp-shuffle row sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B*H, Sq) or null
  int B, H, Sq, Skv, d;
  // element strides of batch, sequence and head; the last dim is contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;  // 1/sqrt(d), already rounded to the input dtype
};

// Max and sum over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// BQ q rows and BK keys per tile; DQK = head dim padded for q.k (multiple
// of 8), DP = head dim padded for the output (multiple of 16).
template <typename T, int BQ, int BK, int DQK, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashParams p) {
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = DP / 16;
  constexpr int LDK = DQK + 1;   // odd row stride: column reads hit 16 banks
  constexpr int LDP = BK + 16;   // rows ty, ty+1 of a warp land 16 banks apart
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x DQK
  float* Ks = Qs + BQ * DQK;     // BK x LDK
  float* Vs = Ks + BK * LDK;     // BK x DP
  float* Ps = Vs + BK * DP;      // BQ x LDP

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * DQK; idx += kThreads) {
    const int r = idx / DQK, c = idx % DQK;
    float x = 0.f;
    if (q0 + r < p.Sq && c < p.d)
      x = to_f(from_f<T>(to_f(q[(long long)(q0 + r) * p.q_ss + c]) * p.scale));
    Qs[idx] = x;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < p.Skv; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < BK * DQK; idx += kThreads) {
      const int r = idx / DQK, c = idx % DQK;
      float x = 0.f;
      if (k0 + r < p.Skv && c < p.d) x = to_f(k[(long long)(k0 + r) * p.k_ss + c]);
      Ks[r * LDK + c] = x;
    }
    for (int idx = tid; idx < BK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      float x = 0.f;
      if (k0 + r < p.Skv && c < p.d) x = to_f(v[(long long)(k0 + r) * p.v_ss + c]);
      Vs[idx] = x;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < DQK; ++kk) {
      float a[RQ], bk[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + 16 * i) * DQK + kk];
#pragma unroll
      for (int j = 0; j < RK; ++j) bk[j] = Ks[(tx + 16 * j) * LDK + kk];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        if (k0 + tx + 16 * j >= p.Skv) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds key k0 < Skv, so the row max is finite
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = e;
        sum += e;
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pp[RQ], vv[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pp[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) vv[j] = Vs[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pp[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.Sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) o[(long long)r * p.o_ss + c] = from_f<T>(acc[i][j] * inv);
    }
    if (p.lse != nullptr && tx == 0) p.lse[(long long)bh * p.Sq + r] = m[i] + logf(l[i]);
  }
}

template <typename T, int BQ, int BK, int DQK, int DP>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  constexpr int LDK = DQK + 1, LDP = BK + 16;
  const int smem = static_cast<int>(sizeof(float) * (BQ * DQK + BK * LDK + BK * DP + BQ * LDP));
  auto kernel = flash_fwd_kernel<T, BQ, BK, DQK, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FlashParams& p, cudaStream_t s) {
  if (p.d <= 40) return launch<T, 64, 64, 40, 48>(p, s);
  if (p.d <= 64) return launch<T, 64, 64, 64, 64>(p, s);
  if (p.d <= 80) return launch<T, 64, 64, 80, 80>(p, s);
  if (p.d <= 128) return launch<T, 64, 32, 128, 128>(p, s);
  if (p.d <= 160) return launch<T, 64, 32, 160, 160>(p, s);
  if (p.d <= 512) return launch<T, 32, 32, 512, 512>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). `strides` holds the 12 element
// strides (batch, seq, head) of q, k, v and o. `lse` may be null. Returns
// the cudaError_t of the launch.
extern "C" int comat_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               int is_bf16, int B, int H, int Sq, int Skv, int d,
                               const long long* strides, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || d <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.d = d;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
  return static_cast<int>(err);
}
