// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(d)) v.
//
// Replaces the TPU kernel comat_tpu/ops/flash_attention.py:_flash_fwd_kernel
// (called through _fwd / flash_attention / flash_attention_diff). Same
// function: q is scaled by 1/sqrt(d) and rounded to the input dtype before
// the product (as _fwd does), keys at or past Skv are masked, the running
// max, denominator and accumulator are fp32, and the per-row logsumexp
// m + log(l) is written when the caller asks for it. As in the TPU kernel,
// the probabilities are rounded to v's dtype before P*V, and the
// denominator l is the sum of those rounded values (the TPU kernel's ones
// column appended to V).
//
// What bounds it on the H100: at the UNet's shapes (S = 4096/1024/256 keys,
// d = 40/80/160) attention is far above the card's ridge point
// (4*S*d flops per 2*d*bytes of q/o), so the bound is arithmetic; the VAE's
// single head (S = 4096, d = 512) likewise.
//
// The dtype picks the code, explicitly:
// - bf16 runs on the tensor cores (wgmma, HGMMA in the SASS). One CTA per
//   (b*h, 128 query rows, 64*NO output columns): two consumer warpgroups of
//   64 rows each and a producer warp. The producer loads the q tile once
//   and streams K and V tiles of BK keys through a shared-memory ring with
//   TMA and mbarriers. q, k and v are read through 4-d tensor maps over
//   (d, S, H, B) with their own strides, so the (B, S, H, d) head split of
//   a projection needs no copy, and every coordinate outside the tensor
//   reads as zero: that pads the head dim to a multiple of 64 in shared
//   memory (d = 40, 80, 160), and the rows past Sq or Skv.
//   Each warpgroup scales its q rows in place (q * scale rounded to bf16),
//   then per key tile: S = q^ K^T with wgmma (A and B K-major from shared
//   memory, depth ceil(d/16)*16), the online softmax in registers over the
//   accumulator's rows, P rounded to bf16 in registers and used as the
//   register A operand of O += P V (V MN-major). l, the sum of the rounded
//   P, comes from the tensor cores too where the output block has spare
//   columns past d (d = 40, 80, 160): one of V's zero columns is set to 1
//   in shared memory, the TPU kernel's ones column; at d = 64, 128, 512
//   each thread sums it in registers. The output width is 64*NO per CTA:
//   d = 512 splits it over CTAs in 128-column blocks, and each of them
//   recomputes S over the full d, since a 64 x 512 fp32 accumulator does
//   not fit the registers.
// - fp32 stays on the CUDA cores in fp32: one 256-thread block per
//   (b*h, BQ-row q tile), K and V tiles staged in shared memory, a 16x16
//   thread grid for both products. TF32 tensor cores would keep about
//   three decimal digits, short of the 1e-4 that the fp32 checks and the
//   card-vs-CPU parity ask. Its d = 512 case uses 32-row tiles (200 KB of
//   dynamic shared memory).
#include <math.h>

#include "hopper.cuh"

namespace {

using hopper::sw128_desc;

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

// ---------------------------------------------------------------- fp32

constexpr int kThreads = 256;

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
template <int BQ, int BK, int DQK, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const FlashParams p) {
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
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * DQK; idx += kThreads) {
    const int r = idx / DQK, c = idx % DQK;
    float x = 0.f;
    if (q0 + r < p.Sq && c < p.d) x = q[(long long)(q0 + r) * p.q_ss + c] * p.scale;
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
      if (k0 + r < p.Skv && c < p.d) x = k[(long long)(k0 + r) * p.k_ss + c];
      Ks[r * LDK + c] = x;
    }
    for (int idx = tid; idx < BK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      float x = 0.f;
      if (k0 + r < p.Skv && c < p.d) x = v[(long long)(k0 + r) * p.v_ss + c];
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
      if (c < p.d) o[(long long)r * p.o_ss + c] = acc[i][j] * inv;
    }
    if (p.lse != nullptr && tx == 0) p.lse[(long long)bh * p.Sq + r] = m[i] + logf(l[i]);
  }
}

template <int BQ, int BK, int DQK, int DP>
cudaError_t launch_f32(const FlashParams& p, cudaStream_t stream) {
  constexpr int LDK = DQK + 1, LDP = BK + 16;
  const int smem = static_cast<int>(sizeof(float) * (BQ * DQK + BK * LDK + BK * DP + BQ * LDP));
  auto kernel = flash_fwd_f32_kernel<BQ, BK, DQK, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const FlashParams& p, cudaStream_t s) {
  if (p.d <= 40) return launch_f32<64, 64, 40, 48>(p, s);
  if (p.d <= 64) return launch_f32<64, 64, 64, 64>(p, s);
  if (p.d <= 80) return launch_f32<64, 64, 80, 80>(p, s);
  if (p.d <= 128) return launch_f32<64, 32, 128, 128>(p, s);
  if (p.d <= 160) return launch_f32<64, 32, 160, 160>(p, s);
  if (p.d <= 512) return launch_f32<32, 32, 512, 512>(p, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- bf16

constexpr int kBQ = 128;               // q rows per CTA: 64 per consumer warpgroup
constexpr int kTcThreads = 384;        // 2 consumer warpgroups + 1 producer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// DQ: 64-wide chunks of the head dim held for q.k^T; NO: 64-wide chunks
// of the output per CTA; BK: keys per tile; STAGES: depth of the K/V ring.
// ONES: the output block has spare columns past d (d = 40, 80, 160).
// Then V's last 8-aligned column, 64*NO - 8, is set to 1 in every tile,
// and O's same column sums the rounded P on the tensor cores, as the TPU
// kernel's ones column does; otherwise (d = 64, 128, 512) each thread
// sums them in registers.
template <int DQ, int NO, int BK, int STAGES>
struct TcConfig {
  static constexpr int kQChunk = kBQ * 128;   // bytes of one 64-wide chunk of the q tile
  static constexpr int kKChunk = BK * 128;    // ... of a K or V tile
  static constexpr int kStage = (DQ + NO) * kKChunk;
  static constexpr int kSmem = DQ * kQChunk + STAGES * kStage + 1024 + (1 + 2 * STAGES) * 8;
};

template <int DQ, int NO, int BK, int STAGES, bool ONES>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tmap_q,
                          const __grid_constant__ CUtensorMap tmap_k,
                          const __grid_constant__ CUtensorMap tmap_v, const FlashParams p) {
  using Cfg = TcConfig<DQ, NO, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sq = smem;
  uint8_t* skv = smem + DQ * Cfg::kQChunk;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + STAGES * Cfg::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * kBQ, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int n0 = blockIdx.z * NO * 64;
  const int dq = (p.d + 63) / 64;                    // chunks of q and k read
  const int no = min(NO, (p.d - n0 + 63) / 64);      // chunks of v read
  const int tiles = (p.Skv + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: the q tile once, then K and V tiles through the ring
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::mbar_expect_tx(q_full, dq * Cfg::kQChunk);
      for (int c = 0; c < dq; ++c)
        hopper::tma_load_4d(sq + c * Cfg::kQChunk, &tmap_q, 64 * c, q0, h, b, q_full);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) hopper::mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        uint8_t* st = skv + s * Cfg::kStage;
        hopper::mbar_expect_tx(&full[s], (dq + no) * Cfg::kKChunk);
        for (int c = 0; c < dq; ++c)
          hopper::tma_load_4d(st + c * Cfg::kKChunk, &tmap_k, 64 * c, t * BK, h, b, &full[s]);
        for (int c = 0; c < no; ++c)
          hopper::tma_load_4d(st + (DQ + c) * Cfg::kKChunk, &tmap_v, n0 + 64 * c, t * BK, h, b,
                              &full[s]);
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;

    // q^ = q * scale rounded to bf16, in place, in this warpgroup's 64 rows
    // of each chunk (an elementwise pass: the swizzle does not matter)
    hopper::mbar_wait(q_full, 0);
    for (int c = 0; c < dq; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(sq + c * Cfg::kQChunk + wg * (Cfg::kQChunk / 2));
      for (int i = tid; i < Cfg::kQChunk / 2 / 16; i += 128) {
        uint4 u = rows[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          e[j] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
        }
        rows[i] = u;
      }
    }
    hopper::fence_proxy_async();
    hopper::named_bar_sync(1 + wg, 128);

    const uint32_t q_base = hopper::smem_u32(sq) + wg * (Cfg::kQChunk / 2);
    const uint32_t kv_base = hopper::smem_u32(skv);
    const int ksteps = (p.d + 15) / 16;
    float o[NO * 32];
#pragma unroll
    for (int i = 0; i < NO * 32; ++i) o[i] = 0.f;
    // per row half (rows lane/4 and lane/4 + 8 of the warp's 16): the
    // running max in log2 units, and this thread's part of the denominator
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    constexpr int kOnes = 64 * NO - 8;  // with ONES: the column of V and O that holds l

    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      hopper::mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t st = kv_base + s * Cfg::kStage;
      if (ONES) {
        // V[key, kOnes] = 1 for the tile's keys (both warpgroups write the
        // same value); rows are 128 bytes, 16-byte groups swizzled by row
        uint8_t* vc = skv + s * Cfg::kStage + (DQ + NO - 1) * Cfg::kKChunk;
        for (int r = tid; r < BK; r += 128)
          *reinterpret_cast<uint16_t*>(vc + 128 * r + 16 * (7 ^ (r % 8))) = 0x3F80;
        hopper::fence_proxy_async();
        hopper::named_bar_sync(1 + wg, 128);
      }

      float sc[BK / 2];
      hopper::wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const int c = kk / 4, off = 32 * (kk % 4);
        hopper::wgmma_ss<0>(sc, sw128_desc(q_base + c * Cfg::kQChunk + off, 16, 1024),
                            sw128_desc(st + c * Cfg::kKChunk + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(sc);

      if ((t + 1) * BK > p.Skv) {
        const int valid = p.Skv - t * BK;
#pragma unroll
        for (int r = 0; r < BK / 2; ++r)
          if (8 * (r / 4) + 2 * (lane % 4) + (r % 2) >= valid) sc[r] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) mx[(r / 2) % 2] = fmaxf(mx[(r / 2) % 2], sc[r]);
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        // every tile holds key t*BK < Skv, so the row max is finite
        const float m_new = fmaxf(m[hh], mx[hh] * kLog2e);
        corr[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
        l[hh] *= corr[hh];
      }
      // P in bf16, packed as the A fragments of the k16 steps of P*V:
      // registers 8j .. 8j+7 of the S accumulator are keys 16j .. 16j+15
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int r = 0; r < BK / 2; r += 2) {
        const int hh = (r / 2) % 2;
        const __nv_bfloat162 pb =
            __floats2bfloat162_rn(exp2f(fmaf(sc[r], kLog2e, -m[hh])),
                                  exp2f(fmaf(sc[r + 1], kLog2e, -m[hh])));
        if (!ONES) {
          const float2 pf = __bfloat1622float2(pb);
          l[hh] += pf.x + pf.y;
        }
        pa[r / 8][(r % 8) / 2] = *reinterpret_cast<const uint32_t*>(&pb);
      }
#pragma unroll
      for (int r = 0; r < NO * 32; ++r) o[r] *= corr[(r / 2) % 2];

      hopper::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        hopper::wgmma_rs<1>(o, pa[j], sw128_desc(st + DQ * Cfg::kKChunk + 2048 * j,
                                                 Cfg::kKChunk, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::reg_fence(o);
      hopper::mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (ONES) {
        // column kOnes is register 4 * (kOnes / 8) + 2 * hh of the lanes
        // with lane % 4 == 0
        l[hh] = __shfl_sync(0xffffffffu, o[4 * (kOnes / 8) + 2 * hh], lane & ~3);
      } else {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      }
      const int row = q0 + wg * 64 + warp * 16 + lane / 4 + 8 * hh;
      if (row >= p.Sq) continue;
      const float inv = 1.f / l[hh];
#pragma unroll
      for (int j = 0; j < NO * 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col < p.d)  // d % 8 == 0, so col + 1 < d too
          *reinterpret_cast<__nv_bfloat162*>(out + row * p.o_ss + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
      }
      if (p.lse != nullptr && blockIdx.z == 0 && lane % 4 == 0)
        p.lse[(long long)bh * p.Sq + row] = (m[hh] + log2f(l[hh])) * kLn2;
    }
  }
}

template <int DQ, int NO, int BK, int STAGES, bool ONES>
cudaError_t launch_bf16(const FlashParams& p, cudaStream_t stream) {
  using Cfg = TcConfig<DQ, NO, BK, STAGES>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = hopper::make_bshd_map(&tq, p.q, p.B, p.Sq, p.H, p.d, p.q_sb, p.q_ss, p.q_sh,
                                   kBQ)) != cudaSuccess)
    return err;
  if ((err = hopper::make_bshd_map(&tk, p.k, p.B, p.Skv, p.H, p.d, p.k_sb, p.k_ss, p.k_sh,
                                   BK)) != cudaSuccess)
    return err;
  if ((err = hopper::make_bshd_map(&tv, p.v, p.B, p.Skv, p.H, p.d, p.v_sb, p.v_ss, p.v_sh,
                                   BK)) != cudaSuccess)
    return err;
  constexpr auto kernel = flash_fwd_bf16_kernel<DQ, NO, BK, STAGES, ONES>;
  if ((err = hopper::allow_smem<kernel>(Cfg::kSmem)) != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.B * p.H, (p.d + 64 * NO - 1) / (64 * NO));
  kernel<<<grid, kTcThreads, Cfg::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const FlashParams& p, cudaStream_t s) {
  if (p.d % 8 != 0) return cudaErrorInvalidValue;  // TMA row strides are 16-byte multiples
  if (p.d < 64) return launch_bf16<1, 1, 128, 3, true>(p, s);
  if (p.d == 64) return launch_bf16<1, 1, 128, 3, false>(p, s);
  if (p.d < 128) return launch_bf16<2, 2, 128, 2, true>(p, s);
  if (p.d == 128) return launch_bf16<2, 2, 128, 2, false>(p, s);
  if (p.d < 192) return launch_bf16<3, 3, 64, 3, true>(p, s);
  if (p.d == 192) return launch_bf16<3, 3, 64, 3, false>(p, s);
  if (p.d <= 512) return launch_bf16<8, 2, 32, 2, false>(p, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). `strides` holds the 12 element
// strides (batch, seq, head) of q, k, v and o. `lse` may be null. bf16
// asks d % 8 == 0, 16-byte aligned q, k, v and strides that are multiples
// of 8. Returns the cudaError_t of the launch.
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
  const cudaError_t err = is_bf16 ? dispatch_bf16(p, s) : dispatch_f32(p, s);
  return static_cast<int>(err);
}
