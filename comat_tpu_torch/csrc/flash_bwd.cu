// Flash-attention backward for Hopper (sm_90a): dq, and dk with dv, of
// o = softmax(q k^T / sqrt(d)) v, from the forward's per-row logsumexp.
//
// Replaces the TPU kernels comat_tpu/ops/flash_attention.py:
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (both launched from
// _flash_diff_bwd). Same function and the same rounding points:
//   q^ = q * scale rounded to the input dtype (scale = 1/sqrt(d) rounded too),
//   P  = exp(q^ k^T - lse),   dP = dO v^T,   dS = P o (dP - D),
//   dq = (dS rounded to k's dtype) k * (1/sqrt(d) in fp32),
//   dk = (dS rounded to q's dtype)^T q^,   dv = (P rounded to dO's dtype)^T dO,
// with D = rowsum(dO o) computed by the caller in fp32 (as _flash_diff_bwd
// does outside its kernels) and every sum in fp32. Keys at or past Skv get
// P = 0; q rows at or past Sq contribute nothing.
//
// What bounds it on the H100: 6*BH*Sq*Skv*d (dq) and 8*BH*Sq*Skv*d (dk, dv)
// operations against a few d-wide rows of traffic per key and query, so at
// the UNet's and VAE's shapes the bound is arithmetic, as for the forward.
//
// Design (simple first, fast later): CUDA-core fp32 arithmetic on a 16x16
// thread grid, as in flash_fwd.cu; no tensor cores yet.
//   - dq: one 256-thread block per (b*h, BQ-row q tile); q^ and dO stay in
//     shared memory while kv tiles stream past. One shared buffer holds the
//     kv tile's V (for dP) and then its K (for S and dS K), so d = 512 fits
//     a 32-row tile in 201 KB of dynamic shared memory.
//   - dk, dv: one block per (b*h, BK-row kv tile); K and V stay in shared
//     memory while q tiles stream past; P and dS of each q tile go through
//     shared memory to the two register accumulators. d = 512 uses 16-row
//     tiles (134 KB) so the two accumulators stay in registers.
//   - No atomics: each output row is written by exactly one block, so a run
//     repeats bit for bit.
//   - Every tile row has an odd stride (d + 1 floats): the column-wise reads
//     of the q.k and dO.v products hit 16 different banks.
//   - q, k, v, dO, dq, dk and dv are read and written through (batch, seq,
//     head) strides with a contiguous last dim, so the head split and merge
//     of the (B, S, H*d) projections stay views.
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
// x rounded to T and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // (B*H, Sq)
  const float* dvec;  // (B*H, Sq): rowsum(dO * o)
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Skv, d;
  // element strides of batch, sequence and head; the last dim is contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;     // dO
  long long a_sb, a_ss, a_sh;     // dq, or dk
  long long c_sb, c_ss, c_sh;     // dv
  float qscale;   // 1/sqrt(d) rounded to the input dtype: q^ = q * qscale
  float dqscale;  // 1/sqrt(d) in fp32: dq = (dS k) * dqscale
};

// Stage rows [r0, r0 + R) of a (seq, d) slice into a R x (D + 1) fp32 tile,
// zero past `rows` and past d; `scale` != 0 rounds x * scale to T (q^).
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, int r0,
                                          int rows, int d, float scale) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (r0 + r < rows && c < d) {
      x = to_f(src[static_cast<long long>(r0 + r) * ss + c]);
      if (scale != 0.f) x = round_to<T>(x * scale);
    }
    dst[r * LD + c] = x;
  }
}

template <typename T, int BQ, int BK, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  constexpr int LD = D + 1, LDS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD: q^
  float* dOs = Qs + BQ * LD;    // BQ x LD
  float* KVs = dOs + BQ * LD;   // BK x LD: the kv tile's V, then its K
  float* dSs = KVs + BK * LD;   // BQ x LDS: dS rounded to k's dtype

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  T* dq = static_cast<T*>(p.dq) + b * p.a_sb + h * p.a_sh;

  load_tile<T, BQ, D>(Qs, q, p.q_ss, q0, p.Sq, p.d, p.qscale);
  load_tile<T, BQ, D>(dOs, dout, p.o_ss, q0, p.Sq, p.d, 0.f);

  bool row_ok[RQ];
  float lse[RQ], dvec[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty + 16 * i;
    row_ok[i] = r < p.Sq;
    lse[i] = row_ok[i] ? p.lse[static_cast<long long>(bh) * p.Sq + r] : 0.f;
    dvec[i] = row_ok[i] ? p.dvec[static_cast<long long>(bh) * p.Sq + r] : 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < p.Skv; k0 += BK) {
    __syncthreads();  // the previous tile's K and dS reads are done
    load_tile<T, BK, D>(KVs, v, p.v_ss, k0, p.Skv, p.d, 0.f);
    __syncthreads();
    float dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[RQ], bv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = dOs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) bv[j] = KVs[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) dp[i][j] = fmaf(a[i], bv[j], dp[i][j]);
    }
    __syncthreads();  // V reads are done
    load_tile<T, BK, D>(KVs, k, p.k_ss, k0, p.Skv, p.d, 0.f);
    __syncthreads();
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[RQ], bk[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < RK; ++j) bk[j] = KVs[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        float ds = 0.f;
        if (row_ok[i] && k0 + tx + 16 * j < p.Skv)
          ds = expf(s[i][j] - lse[i]) * (dp[i][j] - dvec[i]);
        dSs[(ty + 16 * i) * LDS + tx + 16 * j] = round_to<T>(ds);
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[RQ], bk[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = dSs[(ty + 16 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) bk[j] = KVs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    if (!row_ok[i]) continue;
    const long long r = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) dq[r * p.a_ss + c] = from_f<T>(acc[i][j] * p.dqscale);
    }
  }
}

template <typename T, int BK, int BQ, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int RK = BK / 16, RQ = BQ / 16, RD = D / 16;
  constexpr int LD = D + 1, LDP = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x LD
  float* Vs = Ks + BK * LD;     // BK x LD
  float* Qs = Vs + BK * LD;     // BQ x LD: q^
  float* dOs = Qs + BQ * LD;    // BQ x LD
  float* Ps = dOs + BQ * LD;    // BK x LDP: P rounded to dO's dtype
  float* dSs = Ps + BK * LDP;   // BK x LDP: dS rounded to q's dtype
  float* lse = dSs + BK * LDP;  // BQ
  float* dvec = lse + BQ;       // BQ

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BK;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  T* dk = static_cast<T*>(p.dk) + b * p.a_sb + h * p.a_sh;
  T* dv = static_cast<T*>(p.dv) + b * p.c_sb + h * p.c_sh;

  load_tile<T, BK, D>(Ks, k, p.k_ss, k0, p.Skv, p.d, 0.f);
  load_tile<T, BK, D>(Vs, v, p.v_ss, k0, p.Skv, p.d, 0.f);

  float dk_acc[RK][RD], dv_acc[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
    __syncthreads();  // the previous q tile's reads are done
    load_tile<T, BQ, D>(Qs, q, p.q_ss, q0, p.Sq, p.d, p.qscale);
    load_tile<T, BQ, D>(dOs, dout, p.o_ss, q0, p.Sq, p.d, 0.f);
    for (int r = tid; r < BQ; r += kThreads) {
      const bool ok = q0 + r < p.Sq;
      lse[r] = ok ? p.lse[static_cast<long long>(bh) * p.Sq + q0 + r] : 0.f;
      dvec[r] = ok ? p.dvec[static_cast<long long>(bh) * p.Sq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[RK][RQ], dp[RK][RQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kr[RK], vr[RK], qc[RQ], oc[RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kr[i] = Ks[(ty + 16 * i) * LD + c];
        vr[i] = Vs[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        qc[j] = Qs[(tx + 16 * j) * LD + c];
        oc[j] = dOs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
          dp[i][j] = fmaf(vr[i], oc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        const int qc = tx + 16 * j;
        float pp = 0.f, ds = 0.f;
        if (q0 + qc < p.Sq) {
          pp = expf(s[i][j] - lse[qc]);
          ds = pp * (dp[i][j] - dvec[qc]);
        }
        Ps[(ty + 16 * i) * LDP + qc] = round_to<T>(pp);
        dSs[(ty + 16 * i) * LDP + qc] = round_to<T>(ds);
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BQ; ++kk) {
      float pr[RK], sr[RK], oc[RD], qc[RD];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pr[i] = Ps[(ty + 16 * i) * LDP + kk];
        sr[i] = dSs[(ty + 16 * i) * LDP + kk];
      }
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        oc[j] = dOs[kk * LD + tx + 16 * j];
        qc[j] = Qs[kk * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          dv_acc[i][j] = fmaf(pr[i], oc[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(sr[i], qc[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const long long r = k0 + ty + 16 * i;
    if (r >= p.Skv) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) {
        dk[r * p.a_ss + c] = from_f<T>(dk_acc[i][j]);
        dv[r * p.c_ss + c] = from_f<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int BQ, int BK, int D>
cudaError_t launch_dq(const BwdParams& p, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int smem = static_cast<int>(sizeof(float) * (2 * BQ * LD + BK * LD + BQ * (BK + 1)));
  auto kernel = flash_bwd_dq_kernel<T, BQ, BK, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BK, int BQ, int D>
cudaError_t launch_dkv(const BwdParams& p, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int smem = static_cast<int>(
      sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BK * (BQ + 1) + 2 * BQ));
  auto kernel = flash_bwd_dkv_kernel<T, BK, BQ, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Skv + BK - 1) / BK, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tiles by head dim (padded to a multiple of 16); shared memory per block
// stays within 227 KB (the largest, d = 512 dq, takes 201 KB).
template <typename T>
cudaError_t dispatch_dq(const BwdParams& p, cudaStream_t s) {
  if (p.d <= 48) return launch_dq<T, 64, 64, 48>(p, s);
  if (p.d <= 64) return launch_dq<T, 64, 64, 64>(p, s);
  if (p.d <= 80) return launch_dq<T, 64, 64, 80>(p, s);
  if (p.d <= 128) return launch_dq<T, 64, 32, 128>(p, s);
  if (p.d <= 160) return launch_dq<T, 64, 32, 160>(p, s);
  if (p.d <= 512) return launch_dq<T, 32, 32, 512>(p, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dkv(const BwdParams& p, cudaStream_t s) {
  if (p.d <= 48) return launch_dkv<T, 64, 64, 48>(p, s);
  if (p.d <= 64) return launch_dkv<T, 64, 64, 64>(p, s);
  if (p.d <= 80) return launch_dkv<T, 64, 64, 80>(p, s);
  if (p.d <= 128) return launch_dkv<T, 64, 32, 128>(p, s);
  if (p.d <= 160) return launch_dkv<T, 32, 32, 160>(p, s);
  if (p.d <= 512) return launch_dkv<T, 16, 16, 512>(p, s);
  return cudaErrorInvalidValue;
}

bool shape_ok(int B, int H, int Sq, int Skv, int d) {
  return B > 0 && H > 0 && Sq > 0 && Skv > 0 && d > 0 && B * H <= 65535;
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dvec, int B, int H, int Sq, int Skv,
                      int d, const long long* st, int n_out) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.dvec = dvec;
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.d = d;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.a_sb = st[12]; p.a_ss = st[13]; p.a_sh = st[14];
  if (n_out == 2) {
    p.c_sb = st[15]; p.c_ss = st[16]; p.c_sh = st[17];
  }
  return p;
}

}  // namespace

// Plain C entry points (loaded with ctypes). `strides` holds the element
// strides (batch, seq, head) of q, k, v, dO and dq (15 values), or of q, k,
// v, dO, dk and dv (18). lse and dvec are fp32 (B*H, Sq), contiguous.
// Each returns the cudaError_t of its launch.
extern "C" int comat_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* dvec, void* dq, int is_bf16,
                                  int B, int H, int Sq, int Skv, int d, const long long* strides,
                                  float qscale, float dqscale, void* stream) {
  if (!shape_ok(B, H, Sq, Skv, d)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(q, k, v, dout, lse, dvec, B, H, Sq, Skv, d, strides, 1);
  p.dq = dq;
  p.qscale = qscale;
  p.dqscale = dqscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch_dq<__nv_bfloat16>(p, s) : dispatch_dq<float>(p, s));
}

extern "C" int comat_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* dvec, void* dk, void* dv,
                                   int is_bf16, int B, int H, int Sq, int Skv, int d,
                                   const long long* strides, float qscale, void* stream) {
  if (!shape_ok(B, H, Sq, Skv, d)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(q, k, v, dout, lse, dvec, B, H, Sq, Skv, d, strides, 2);
  p.dk = dk;
  p.dv = dv;
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch_dkv<__nv_bfloat16>(p, s) : dispatch_dkv<float>(p, s));
}
