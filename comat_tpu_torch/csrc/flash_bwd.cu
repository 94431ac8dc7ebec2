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
// Two kernels, as in JAX, and no atomics: each output row is written by
// exactly one CTA, so a run repeats bit for bit. The split recomputes S and
// dP in both kernels (14 products of BH*Sq*Skv*d against 10 for one fused
// backward with atomic dq).
//
// The dtype picks the code, explicitly:
// - bf16 runs on the tensor cores (wgmma, HGMMA in the SASS). One producer
//   warp streams tiles through a shared-memory ring with TMA and mbarriers;
//   each consumer warpgroup owns 64 rows of the output (the wgmma M). q^,
//   k, v and dO are read through 4-d tensor maps over (d, S, H, B) with
//   their own strides; every coordinate outside the tensor reads as zero,
//   which pads the head dim to a multiple of 64 in shared memory and the
//   rows past Sq or Skv. The wrapper forms q^ once (JAX's _fwd hands its
//   scaled qf to the backward likewise) and passes qscale = 1.
//   * dk, dv: one CTA per (b*h, 64 keys per consumer warpgroup, output
//     column block). K and V stay resident; q^ and dO tiles of BQ query
//     rows stream past, with lse and D, which the producer
//     warp's lanes copy into the stage. The transposed products come out
//     directly: S^T = K q^T and dP^T = V dO^T (A and B K-major), then P^T
//     and dS^T in registers, rounded to bf16 as the register A operand of
//     dV += P^T dO and dK += dS^T q^, which read the same dO and q^ tiles
//     MN-major. Query rows past Sq are masked by index (their lse and D
//     are never read).
//   * dq: one CTA per (b*h, 64 query rows per consumer warpgroup, output
//     column block). q^ and dO stay resident; K and V tiles of BK keys
//     stream past. S = q^ K^T and dP = dO V^T (both K-major), dS in
//     registers, rounded to bf16, as the A operand of dQ += dS K (K read
//     MN-major); dq is scaled by 1/sqrt(d) in the epilogue. A zero-filled
//     key row past Skv gives a logit of 0, not -inf, so those columns of
//     dS are masked by index.
//   Widths: the depth of S and dP is ceil(d/16)*16; the output width NW is
//   d rounded up to 48, 64, 80, 128 or 160 (hopper.cuh writes out those
//   wgmma widths), so d = 40 computes 48 columns and d = 80 exactly 80.
//   Where a 64-row accumulator of that width does not fit the registers
//   beside S and dP, the output columns are split over CTAs (grid z) in
//   64-aligned blocks and each block recomputes S and dP over the full
//   depth: dk/dv at d in (128, 192] in 64-column blocks (d = 160: 3 blocks,
//   2.1x the products of one pass), dq and dk/dv at d in (192, 512] in
//   128-column blocks with one consumer warpgroup, since K and V (or q^ and
//   dO) of 64 rows at d = 512 take 128 KB of shared memory (d = 512: 4
//   blocks, 2.5x the products).
// - fp32 stays on the CUDA cores in fp32: TF32 tensor cores would keep
//   about three decimal digits, short of the 1e-4 that the fp32 checks and
//   the card-vs-CPU train parity ask.
//   * dq: one 256-thread block per (b*h, BQ-row q tile); q^ and dO stay in
//     shared memory while kv tiles stream past. One shared buffer holds the
//     kv tile's V (for dP) and then its K (for S and dS K), so d = 512 fits
//     a 32-row tile in 201 KB of dynamic shared memory.
//   * dk, dv: one block per (b*h, BK-row kv tile); K and V stay in shared
//     memory while q tiles stream past; P and dS of each q tile go through
//     shared memory to the two register accumulators. d = 512 uses 16-row
//     tiles (134 KB) so the two accumulators stay in registers.
//   * Every tile row has an odd stride (d + 1 floats): the column-wise
//     reads of the q.k and dO.v products hit 16 different banks.
//   * q, k, v, dO, dq, dk and dv are read and written through (batch, seq,
//     head) strides with a contiguous last dim, so the head split and
//     merge of the (B, S, H*d) projections stay views.
#include <math.h>

#include "hopper.cuh"

namespace {

using hopper::sw128_desc;

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

// ---------------------------------------------------------------- fp32

constexpr int kThreads = 256;

// Stage rows [r0, r0 + R) of a (seq, d) slice into a R x (D + 1) fp32 tile,
// zero past `rows` and past d; `scale` != 0 multiplies by it (q^).
template <int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ss, int r0,
                                          int rows, int d, float scale) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (r0 + r < rows && c < d) {
      x = src[static_cast<long long>(r0 + r) * ss + c];
      if (scale != 0.f) x *= scale;
    }
    dst[r * LD + c] = x;
  }
}

template <int BQ, int BK, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(const BwdParams p) {
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  constexpr int LD = D + 1, LDS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LD: q^
  float* dOs = Qs + BQ * LD;    // BQ x LD
  float* KVs = dOs + BQ * LD;   // BK x LD: the kv tile's V, then its K
  float* dSs = KVs + BK * LD;   // BQ x LDS

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  float* dq = static_cast<float*>(p.dq) + b * p.a_sb + h * p.a_sh;

  load_tile<BQ, D>(Qs, q, p.q_ss, q0, p.Sq, p.d, p.qscale);
  load_tile<BQ, D>(dOs, dout, p.o_ss, q0, p.Sq, p.d, 0.f);

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
    load_tile<BK, D>(KVs, v, p.v_ss, k0, p.Skv, p.d, 0.f);
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
    load_tile<BK, D>(KVs, k, p.k_ss, k0, p.Skv, p.d, 0.f);
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
        dSs[(ty + 16 * i) * LDS + tx + 16 * j] = ds;
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
      if (c < p.d) dq[r * p.a_ss + c] = acc[i][j] * p.dqscale;
    }
  }
}

template <int BK, int BQ, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(const BwdParams p) {
  constexpr int RK = BK / 16, RQ = BQ / 16, RD = D / 16;
  constexpr int LD = D + 1, LDP = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x LD
  float* Vs = Ks + BK * LD;     // BK x LD
  float* Qs = Vs + BK * LD;     // BQ x LD: q^
  float* dOs = Qs + BQ * LD;    // BQ x LD
  float* Ps = dOs + BQ * LD;    // BK x LDP
  float* dSs = Ps + BK * LDP;   // BK x LDP
  float* lse = dSs + BK * LDP;  // BQ
  float* dvec = lse + BQ;       // BQ

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BK;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  float* dk = static_cast<float*>(p.dk) + b * p.a_sb + h * p.a_sh;
  float* dv = static_cast<float*>(p.dv) + b * p.c_sb + h * p.c_sh;

  load_tile<BK, D>(Ks, k, p.k_ss, k0, p.Skv, p.d, 0.f);
  load_tile<BK, D>(Vs, v, p.v_ss, k0, p.Skv, p.d, 0.f);

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
    load_tile<BQ, D>(Qs, q, p.q_ss, q0, p.Sq, p.d, p.qscale);
    load_tile<BQ, D>(dOs, dout, p.o_ss, q0, p.Sq, p.d, 0.f);
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
        Ps[(ty + 16 * i) * LDP + qc] = pp;
        dSs[(ty + 16 * i) * LDP + qc] = ds;
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
        dk[r * p.a_ss + c] = dk_acc[i][j];
        dv[r * p.c_ss + c] = dv_acc[i][j];
      }
    }
  }
}

template <int BQ, int BK, int D>
cudaError_t launch_dq_f32(const BwdParams& p, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int smem = static_cast<int>(sizeof(float) * (2 * BQ * LD + BK * LD + BQ * (BK + 1)));
  auto kernel = flash_bwd_dq_f32_kernel<BQ, BK, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BK, int BQ, int D>
cudaError_t launch_dkv_f32(const BwdParams& p, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int smem = static_cast<int>(
      sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BK * (BQ + 1) + 2 * BQ));
  auto kernel = flash_bwd_dkv_f32_kernel<BK, BQ, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Skv + BK - 1) / BK, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Tiles by head dim (padded to a multiple of 16); shared memory per block
// stays within 227 KB (the largest, d = 512 dq, takes 201 KB).
cudaError_t dispatch_dq_f32(const BwdParams& p, cudaStream_t s) {
  if (p.d <= 48) return launch_dq_f32<64, 64, 48>(p, s);
  if (p.d <= 64) return launch_dq_f32<64, 64, 64>(p, s);
  if (p.d <= 80) return launch_dq_f32<64, 64, 80>(p, s);
  if (p.d <= 128) return launch_dq_f32<64, 32, 128>(p, s);
  if (p.d <= 160) return launch_dq_f32<64, 32, 160>(p, s);
  if (p.d <= 512) return launch_dq_f32<32, 32, 512>(p, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_dkv_f32(const BwdParams& p, cudaStream_t s) {
  if (p.d <= 48) return launch_dkv_f32<64, 64, 48>(p, s);
  if (p.d <= 64) return launch_dkv_f32<64, 64, 64>(p, s);
  if (p.d <= 80) return launch_dkv_f32<64, 64, 80>(p, s);
  if (p.d <= 128) return launch_dkv_f32<64, 32, 128>(p, s);
  if (p.d <= 160) return launch_dkv_f32<32, 32, 160>(p, s);
  if (p.d <= 512) return launch_dkv_f32<16, 16, 512>(p, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- bf16

// Pack two fp32 values as the bf16 pair of one wgmma A register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store a 64 x NW fp32 accumulator (rows row0 + ..., columns n0 + ...) as
// bf16, times `scale`, masked to rows < rows_valid and columns < d
// (d % 8 == 0, so a column pair is in or out together).
template <int NW>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           const float (&acc)[NW / 2], int row0, int rows_valid,
                                           int n0, int d, float scale) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * hh;
    if (row >= rows_valid) continue;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(out + row * ss + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
    }
  }
}

// dk, dv. DQK: 64-wide chunks of the head dim held (the depth of S^T and
// dP^T); NW: output columns per CTA; BQ: query rows per streamed tile;
// STAGES: depth of the ring; NWG: consumer warpgroups, 64 keys each.
template <int DQK, int NW, int BQ, int STAGES, int NWG>
struct DkvConfig {
  static constexpr int kKeys = 64 * NWG;
  static constexpr int kKvChunk = kKeys * 128;   // bytes of one 64-wide chunk of K or V
  static constexpr int kQChunk = BQ * 128;       // ... of a q^ or dO tile
  static constexpr int kStage = 2 * DQK * kQChunk;
  static constexpr int kSmem =
      1024 + 2 * DQK * kKvChunk + STAGES * kStage + STAGES * 2 * BQ * 4 + (1 + 2 * STAGES) * 8;
};

template <int DQK, int NW, int BQ, int STAGES, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tmap_q,
                              const __grid_constant__ CUtensorMap tmap_k,
                              const __grid_constant__ CUtensorMap tmap_v,
                              const __grid_constant__ CUtensorMap tmap_o, const BwdParams p) {
  using Cfg = DkvConfig<DQK, NW, BQ, STAGES, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sk = smem;
  uint8_t* sv = sk + DQK * Cfg::kKvChunk;
  uint8_t* sqo = sv + DQK * Cfg::kKvChunk;   // per stage: q^ chunks, then dO chunks
  float* rowv = reinterpret_cast<float*>(sqo + STAGES * Cfg::kStage);  // per stage: lse, D
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rowv + STAGES * 2 * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * Cfg::kKeys, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.z * NW;
  const int dq = (p.d + 63) / 64;   // chunks read
  const int tiles = (p.Sq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);   // the TMA's expect_tx and the 32 lanes' rows
      hopper::mbar_init(&empty[s], 128 * NWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer warp: K and V once, then q^, dO, lse and D tiles
    if (NWG == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x < 128 * NWG + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::mbar_expect_tx(kv_full, 2 * dq * Cfg::kKvChunk);
        for (int c = 0; c < dq; ++c) {
          hopper::tma_load_4d(sk + c * Cfg::kKvChunk, &tmap_k, 64 * c, k0, h, b, kv_full);
          hopper::tma_load_4d(sv + c * Cfg::kKvChunk, &tmap_v, 64 * c, k0, h, b, kv_full);
        }
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* st = sqo + s * Cfg::kStage;
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[s], 2 * dq * Cfg::kQChunk);
          for (int c = 0; c < dq; ++c) {
            hopper::tma_load_4d(st + c * Cfg::kQChunk, &tmap_q, 64 * c, t * BQ, h, b, &full[s]);
            hopper::tma_load_4d(st + (DQK + c) * Cfg::kQChunk, &tmap_o, 64 * c, t * BQ, h, b,
                                &full[s]);
          }
        }
        float* lv = rowv + s * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int r = t * BQ + i;
          const bool ok = r < p.Sq;
          lv[i] = ok ? p.lse[static_cast<long long>(bh) * p.Sq + r] : 0.f;
          lv[BQ + i] = ok ? p.dvec[static_cast<long long>(bh) * p.Sq + r] : 0.f;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else {
    if (NWG == 2) hopper::setmaxnreg_inc<232>();
    const int lane = threadIdx.x % 32;
    const uint32_t k_base = hopper::smem_u32(sk) + wg * 64 * 128;   // this warpgroup's keys
    const uint32_t v_base = hopper::smem_u32(sv) + wg * 64 * 128;
    const uint32_t qo_base = hopper::smem_u32(sqo);
    const int ksteps = (p.d + 15) / 16;
    const int nc = n0 / 64;   // first chunk of the output block
    float dk[NW / 2], dv[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    hopper::mbar_wait(kv_full, 0);

    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      hopper::mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t sq = qo_base + s * Cfg::kStage, so = sq + DQK * Cfg::kQChunk;

      // S^T = K q^T and dP^T = V dO^T: keys x query rows
      float st[BQ / 2], dpt[BQ / 2];
      hopper::wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const int c = kk / 4, off = 32 * (kk % 4);
        hopper::wgmma_ss<0>(st, sw128_desc(k_base + c * Cfg::kKvChunk + off, 16, 1024),
                            sw128_desc(sq + c * Cfg::kQChunk + off, 16, 1024), kk > 0);
      }
      for (int kk = 0; kk < ksteps; ++kk) {
        const int c = kk / 4, off = 32 * (kk % 4);
        hopper::wgmma_ss<0>(dpt, sw128_desc(v_base + c * Cfg::kKvChunk + off, 16, 1024),
                            sw128_desc(so + c * Cfg::kQChunk + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(st);
      hopper::reg_fence(dpt);

      // P^T and dS^T, rounded to bf16 and packed as the A fragments of the
      // k16 steps over query rows: registers 8j .. 8j+7 are rows 16j .. 16j+15
      const float* lv = rowv + s * 2 * BQ;
      const int valid = p.Sq - t * BQ;
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int r = 0; r < BQ / 2; r += 2) {
        const int c = 8 * (r / 4) + 2 * (lane % 4);   // query row of registers r, r + 1
        float pp[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pp[e] = expf(st[r + e] - lv[c + e]);
          ds[e] = pp[e] * (dpt[r + e] - lv[BQ + c + e]);
          if (c + e >= valid) pp[e] = ds[e] = 0.f;
        }
        pa[r / 8][(r % 8) / 2] = pack_bf16(pp[0], pp[1]);
        da[r / 8][(r % 8) / 2] = pack_bf16(ds[0], ds[1]);
      }

      // dV += P^T dO and dK += dS^T q^, dO and q^ read MN-major
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        hopper::wgmma_rs<1>(dv, pa[j], sw128_desc(so + nc * Cfg::kQChunk + 2048 * j,
                                                  Cfg::kQChunk, 1024), 1);
        hopper::wgmma_rs<1>(dk, da[j], sw128_desc(sq + nc * Cfg::kQChunk + 2048 * j,
                                                  Cfg::kQChunk, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(dv);
      hopper::reg_fence(dk);
      hopper::mbar_arrive(&empty[s]);
    }

    const int row0 = k0 + wg * 64;
    store_rows<NW>(static_cast<__nv_bfloat16*>(p.dk) + b * p.a_sb + h * p.a_sh, p.a_ss, dk, row0,
                   p.Skv, n0, p.d, 1.f);
    store_rows<NW>(static_cast<__nv_bfloat16*>(p.dv) + b * p.c_sb + h * p.c_sh, p.c_ss, dv, row0,
                   p.Skv, n0, p.d, 1.f);
  }
}

// dq. DQK: 64-wide chunks of the head dim held; NW: output columns per
// CTA; BK: keys per streamed tile; STAGES: depth of the ring; NWG:
// consumer warpgroups, 64 query rows each.
template <int DQK, int NW, int BK, int STAGES, int NWG>
struct DqConfig {
  static constexpr int kRows = 64 * NWG;
  static constexpr int kQChunk = kRows * 128;   // bytes of one 64-wide chunk of q^ or dO
  static constexpr int kKChunk = BK * 128;      // ... of a K or V tile
  static constexpr int kStage = 2 * DQK * kKChunk;
  static constexpr int kSmem = 1024 + 2 * DQK * kQChunk + STAGES * kStage + (1 + 2 * STAGES) * 8;
};

template <int DQK, int NW, int BK, int STAGES, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tmap_q,
                             const __grid_constant__ CUtensorMap tmap_k,
                             const __grid_constant__ CUtensorMap tmap_v,
                             const __grid_constant__ CUtensorMap tmap_o, const BwdParams p) {
  using Cfg = DqConfig<DQK, NW, BK, STAGES, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sq = smem;
  uint8_t* so = sq + DQK * Cfg::kQChunk;
  uint8_t* skv = so + DQK * Cfg::kQChunk;   // per stage: K chunks, then V chunks
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + STAGES * Cfg::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * Cfg::kRows, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.z * NW;
  const int dq = (p.d + 63) / 64;   // chunks read
  const int tiles = (p.Skv + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * NWG);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: q^ and dO once, then K and V tiles through the ring
    if (NWG == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 128 * NWG) {
      hopper::mbar_expect_tx(q_full, 2 * dq * Cfg::kQChunk);
      for (int c = 0; c < dq; ++c) {
        hopper::tma_load_4d(sq + c * Cfg::kQChunk, &tmap_q, 64 * c, q0, h, b, q_full);
        hopper::tma_load_4d(so + c * Cfg::kQChunk, &tmap_o, 64 * c, q0, h, b, q_full);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* st = skv + s * Cfg::kStage;
        hopper::mbar_expect_tx(&full[s], 2 * dq * Cfg::kKChunk);
        for (int c = 0; c < dq; ++c) {
          hopper::tma_load_4d(st + c * Cfg::kKChunk, &tmap_k, 64 * c, t * BK, h, b, &full[s]);
          hopper::tma_load_4d(st + (DQK + c) * Cfg::kKChunk, &tmap_v, 64 * c, t * BK, h, b,
                              &full[s]);
        }
      }
    }
  } else {
    if (NWG == 2) hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // this thread's two query rows: lse and D
    float lse[2], dvec[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * hh;
      const bool ok = row < p.Sq;
      lse[hh] = ok ? p.lse[static_cast<long long>(bh) * p.Sq + row] : 0.f;
      dvec[hh] = ok ? p.dvec[static_cast<long long>(bh) * p.Sq + row] : 0.f;
    }
    const uint32_t q_base = hopper::smem_u32(sq) + wg * 64 * 128;   // this warpgroup's rows
    const uint32_t o_base = hopper::smem_u32(so) + wg * 64 * 128;
    const uint32_t kv_base = hopper::smem_u32(skv);
    const int ksteps = (p.d + 15) / 16;
    const int nc = n0 / 64;   // first chunk of the output block
    float acc[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(q_full, 0);

    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      hopper::mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t sk = kv_base + s * Cfg::kStage, sv = sk + DQK * Cfg::kKChunk;

      // S = q^ K^T and dP = dO V^T: query rows x keys
      float sc[BK / 2], dp[BK / 2];
      hopper::wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const int c = kk / 4, off = 32 * (kk % 4);
        hopper::wgmma_ss<0>(sc, sw128_desc(q_base + c * Cfg::kQChunk + off, 16, 1024),
                            sw128_desc(sk + c * Cfg::kKChunk + off, 16, 1024), kk > 0);
      }
      for (int kk = 0; kk < ksteps; ++kk) {
        const int c = kk / 4, off = 32 * (kk % 4);
        hopper::wgmma_ss<0>(dp, sw128_desc(o_base + c * Cfg::kQChunk + off, 16, 1024),
                            sw128_desc(sv + c * Cfg::kKChunk + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(sc);
      hopper::reg_fence(dp);

      // dS rounded to bf16, packed as the A fragments of the k16 steps
      // over keys; keys past Skv (zero-filled rows of K) masked by index
      const int valid = p.Skv - t * BK;
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int r = 0; r < BK / 2; r += 2) {
        const int hh = (r / 2) % 2, c = 8 * (r / 4) + 2 * (lane % 4);
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ds[e] = expf(sc[r + e] - lse[hh]) * (dp[r + e] - dvec[hh]);
          if (c + e >= valid) ds[e] = 0.f;
        }
        da[r / 8][(r % 8) / 2] = pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS K, K read MN-major
      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        hopper::wgmma_rs<1>(acc, da[j], sw128_desc(sk + nc * Cfg::kKChunk + 2048 * j,
                                                   Cfg::kKChunk, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
      hopper::mbar_arrive(&empty[s]);
    }

    store_rows<NW>(static_cast<__nv_bfloat16*>(p.dq) + b * p.a_sb + h * p.a_sh, p.a_ss, acc,
                   q0 + wg * 64, p.Sq, n0, p.d, p.dqscale);
  }
}

// The tensor maps of a launch, in the kernels' order (q^, k, v, dO): q^
// and dO read in boxes of `q_rows` rows, k and v in boxes of `kv_rows`.
cudaError_t make_maps(CUtensorMap (&m)[4], const BwdParams& p, int q_rows, int kv_rows) {
  cudaError_t err = hopper::make_bshd_map(&m[0], p.q, p.B, p.Sq, p.H, p.d, p.q_sb, p.q_ss,
                                          p.q_sh, q_rows);
  if (err == cudaSuccess)
    err = hopper::make_bshd_map(&m[1], p.k, p.B, p.Skv, p.H, p.d, p.k_sb, p.k_ss, p.k_sh,
                                kv_rows);
  if (err == cudaSuccess)
    err = hopper::make_bshd_map(&m[2], p.v, p.B, p.Skv, p.H, p.d, p.v_sb, p.v_ss, p.v_sh,
                                kv_rows);
  if (err == cudaSuccess)
    err = hopper::make_bshd_map(&m[3], p.dout, p.B, p.Sq, p.H, p.d, p.o_sb, p.o_ss, p.o_sh,
                                q_rows);
  return err;
}

template <int DQK, int NW, int BQ, int STAGES, int NWG>
cudaError_t launch_dkv_bf16(const BwdParams& p, cudaStream_t stream) {
  using Cfg = DkvConfig<DQK, NW, BQ, STAGES, NWG>;
  CUtensorMap m[4];
  cudaError_t err = make_maps(m, p, BQ, Cfg::kKeys);
  if (err != cudaSuccess) return err;
  constexpr auto kernel = flash_bwd_dkv_bf16_kernel<DQK, NW, BQ, STAGES, NWG>;
  if ((err = hopper::allow_smem<kernel>(Cfg::kSmem)) != cudaSuccess) return err;
  const dim3 grid((p.Skv + Cfg::kKeys - 1) / Cfg::kKeys, p.B * p.H, (p.d + NW - 1) / NW);
  kernel<<<grid, 128 * (NWG + 1), Cfg::kSmem, stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

template <int DQK, int NW, int BK, int STAGES, int NWG>
cudaError_t launch_dq_bf16(const BwdParams& p, cudaStream_t stream) {
  using Cfg = DqConfig<DQK, NW, BK, STAGES, NWG>;
  CUtensorMap m[4];
  cudaError_t err = make_maps(m, p, Cfg::kRows, BK);
  if (err != cudaSuccess) return err;
  constexpr auto kernel = flash_bwd_dq_bf16_kernel<DQK, NW, BK, STAGES, NWG>;
  if ((err = hopper::allow_smem<kernel>(Cfg::kSmem)) != cudaSuccess) return err;
  const dim3 grid((p.Sq + Cfg::kRows - 1) / Cfg::kRows, p.B * p.H, (p.d + NW - 1) / NW);
  kernel<<<grid, 128 * (NWG + 1), Cfg::kSmem, stream>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

// Tiles by head dim. Dynamic shared memory per CTA stays within 227 KB;
// registers per consumer thread (S, dP and the output accumulators) within
// setmaxnreg's 232 where two consumer warpgroups share an SM.
cudaError_t dispatch_dq_bf16(const BwdParams& p, cudaStream_t s) {
  if (p.d <= 48) return launch_dq_bf16<1, 48, 64, 4, 2>(p, s);
  if (p.d <= 64) return launch_dq_bf16<1, 64, 64, 4, 2>(p, s);
  if (p.d <= 80) return launch_dq_bf16<2, 80, 64, 3, 2>(p, s);
  if (p.d <= 128) return launch_dq_bf16<2, 128, 64, 3, 2>(p, s);
  if (p.d <= 160) return launch_dq_bf16<3, 160, 64, 2, 2>(p, s);
  if (p.d <= 512) return launch_dq_bf16<8, 128, 16, 2, 1>(p, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_dkv_bf16(const BwdParams& p, cudaStream_t s) {
  if (p.d <= 48) return launch_dkv_bf16<1, 48, 64, 3, 2>(p, s);
  if (p.d <= 64) return launch_dkv_bf16<1, 64, 64, 3, 2>(p, s);
  if (p.d <= 80) return launch_dkv_bf16<2, 80, 64, 3, 2>(p, s);
  if (p.d <= 128) return launch_dkv_bf16<2, 128, 32, 4, 2>(p, s);
  if (p.d <= 192) return launch_dkv_bf16<3, 64, 64, 2, 2>(p, s);
  if (p.d <= 512) return launch_dkv_bf16<8, 128, 16, 2, 1>(p, s);
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

// What the bf16 kernels take: d % 8 == 0 (TMA rows are 16-byte multiples;
// the wrapper checks alignment and strides) and q already scaled to q^.
bool bf16_ok(int d, float qscale) { return d % 8 == 0 && qscale == 1.f; }

}  // namespace

// Plain C entry points (loaded with ctypes). `strides` holds the element
// strides (batch, seq, head) of q, k, v, dO and dq (15 values), or of q, k,
// v, dO, dk and dv (18). lse and dvec are fp32 (B*H, Sq), contiguous. The
// kernels read q^ = q * qscale rounded to the dtype; bf16 takes q^ itself
// (qscale = 1), d % 8 == 0, 16-byte aligned tensors and strides that are
// multiples of 8. Each returns the cudaError_t of its launch.
extern "C" int comat_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* dvec, void* dq, int is_bf16,
                                  int B, int H, int Sq, int Skv, int d, const long long* strides,
                                  float qscale, float dqscale, void* stream) {
  if (!shape_ok(B, H, Sq, Skv, d) || (is_bf16 && !bf16_ok(d, qscale)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(q, k, v, dout, lse, dvec, B, H, Sq, Skv, d, strides, 1);
  p.dq = dq;
  p.qscale = qscale;
  p.dqscale = dqscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch_dq_bf16(p, s) : dispatch_dq_f32(p, s));
}

extern "C" int comat_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* dvec, void* dk, void* dv,
                                   int is_bf16, int B, int H, int Sq, int Skv, int d,
                                   const long long* strides, float qscale, void* stream) {
  if (!shape_ok(B, H, Sq, Skv, d) || (is_bf16 && !bf16_ok(d, qscale)))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(q, k, v, dout, lse, dvec, B, H, Sq, Skv, d, strides, 2);
  p.dk = dk;
  p.dv = dv;
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch_dkv_bf16(p, s) : dispatch_dkv_f32(p, s));
}
