// 3x3 stride-1 SAME convolution forward for Hopper (sm_90a), NHWC, no bias.
//
// Replaces the TPU kernels comat_tpu/ops/conv3x3.py:_conv_strip_kernel and
// _conv_resident_kernel (both reached through _fwd_impl / conv3x3_same from
// the VAE's Conv3x3 module). The two TPU variants are VMEM-fit choices for
// one function; here one implicit GEMM computes it:
//   y[m, n] = sum_k A[m, k] W[k, n],   m = (b, y, x), k = (di, dj, c),
//   A[m, k] = x[b, y + di - 1, x + dj - 1, c]  (zero outside the image),
// with M = B*H*W, N = Cout, K = 9*C, fp32 accumulation and the output in
// the input dtype. dx is the same kernel on dy with flip_io(w).
//
// What bounds it on the H100: the VAE decoder's convs do 2*9*C*Cout flops
// per output pixel against (C + Cout) elements of traffic, i.e. hundreds
// of flops per byte at C, Cout >= 128, so the bound is arithmetic: the
// tensor cores' bf16 rate.
//
// The dtype picks the code, explicitly:
// - bf16 runs on the tensor cores (wgmma, HGMMA in the SASS). A CTA owns
//   128 output pixels (2 image rows x 64 columns) by BN output channels:
//   256 where Cout is a multiple of 256, else 128 (the larger tile loads
//   each x box half as often). Its K loop walks 9 taps x ceil(C/64) channel chunks. For
//   each step one producer thread loads, with TMA, the box x[b, y0+di-1 :
//   +2, x0+dj-1 : +64, c0 : +64] and the weight tile w[tap, c0 : +64, n0 :
//   +BN] into a 4-stage shared-memory ring (mbarriers, 128-byte swizzle).
//   TMA fills coordinates outside the tensor with zeros: that is the
//   1-pixel halo and the channel tail (C % 64 != 0), with no padded copy
//   and no bounds checks. Two consumer warpgroups, one image row each, run
//   wgmma.m64nBNk16 (A K-major, B MN-major: Cout is contiguous), keep one
//   group in flight, and store bf16 with masks at the ragged edges of W, H
//   and Cout. The tensor map's row strides must be multiples of 16 bytes:
//   C % 8 == 0 and Cout % 8 == 0 (the wrapper pads Cout).
// - fp32 stays on the CUDA cores: the classic 128x128x8 shared-memory GEMM
//   tile, 256 threads each owning an 8x8 block of outputs, the halo a
//   bounds check. TF32 tensor cores would keep about three decimal digits,
//   short of the 1e-4 that the fp32 checks and the card-vs-CPU parity ask.
#include "hopper.cuh"

namespace {

using hopper::sw128_desc;

// ---------------------------------------------------------------- fp32

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 8;
constexpr int LDA = BM + 4;  // the two 4-channel halves of a row land 16 banks apart

__global__ void __launch_bounds__(kThreads)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, int B, int H, int W, int C, int Cout) {
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

#define LOAD_SLICE(k0)                                                                       \
  {                                                                                          \
    const int tap = (k0) / C, c0 = (k0) - tap * C;                                           \
    const int iy = ay + tap / 3 - 1, ix = ax + tap % 3 - 1;                                  \
    const bool ok = a_row_ok && iy >= 0 && iy < H && ix >= 0 && ix < W;                      \
    if (ok) {                                                                                \
      const float* src = x + ((static_cast<long long>(ab) * H + iy) * W + ix) * C + c0 + a_c; \
      _Pragma("unroll") for (int e = 0; e < 4; ++e) a_reg[e] = src[e];                       \
    } else {                                                                                 \
      _Pragma("unroll") for (int e = 0; e < 4; ++e) a_reg[e] = 0.f;                          \
    }                                                                                        \
    const float* wsrc = w + static_cast<long long>((k0) + b_r) * Cout + n0 + b_c;            \
    _Pragma("unroll") for (int e = 0; e < 4; ++e) b_reg[e] =                                 \
        (n0 + b_c + e < Cout) ? wsrc[e] : 0.f;                                               \
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
    float* dst = y + m * Cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < Cout) dst[n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- bf16

namespace tc {
constexpr int kCols = 64, kRows = 2;             // the M tile: 2 image rows x 64 columns
constexpr int kChunk = 64, kStages = 4;
constexpr int kTcThreads = 384;                  // 2 consumer warpgroups + 1 producer
constexpr int kABytes = kRows * kCols * kChunk * 2;  // 16 KB: 128 pixels x 64 channels
constexpr int kBBlock = kChunk * 64 * 2;             // 8 KB: 64 channels x 64 outputs
// BN output channels per CTA (128 or 256), in 64-wide blocks
template <int BN>
struct Tile {
  static constexpr int kStageBytes = kABytes + BN / 64 * kBBlock;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};
}  // namespace tc

template <int BN>
__global__ void __launch_bounds__(tc::kTcThreads, 1)
    conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap tmap_x,
                        const __grid_constant__ CUtensorMap tmap_w,
                        __nv_bfloat16* __restrict__ y, int H, int W, int C, int Cout,
                        int tiles_x, int tiles_y) {
  using namespace tc;
  constexpr int kStageBytes = Tile<BN>::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int n0 = blockIdx.x * BN;
  int mt = blockIdx.y;
  const int x0 = (mt % tiles_x) * kCols;
  mt /= tiles_x;
  const int y0 = (mt % tiles_y) * kRows;
  const int b = mt / tiles_y;
  const int chunks = (C + kChunk - 1) / kChunk;
  const int iters = 9 * chunks;
  // 64-wide weight blocks to load: the rest hold columns never stored
  const int blocks = min(BN / 64, (Cout - n0 + 63) / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const uint32_t bytes = kABytes + blocks * kBBlock;
      for (int it = 0; it < iters; ++it) {
        const int s = it % kStages;
        if (it >= kStages) hopper::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        const int tap = it / chunks, c0 = (it - tap * chunks) * kChunk;
        hopper::mbar_expect_tx(&full[s], bytes);
        hopper::tma_load_4d(st, &tmap_x, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b, &full[s]);
        for (int j = 0; j < blocks; ++j)
          hopper::tma_load_3d(st + kABytes + j * kBBlock, &tmap_w, n0 + 64 * j, c0, tap,
                              &full[s]);
      }
    }
  } else {
    // consumers: warpgroup wg owns image row y0 + wg (A rows 64 wg .. 64 wg + 63)
    hopper::setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const uint32_t base = hopper::smem_u32(smem);
    for (int it = 0; it < iters; ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a = base + s * kStageBytes + wg * (kABytes / 2);
      const uint32_t bw = base + s * kStageBytes + kABytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k)
        hopper::wgmma_ss<1>(acc, sw128_desc(a + 32 * k, 16, 1024),
                            sw128_desc(bw + 2048 * k, kBBlock, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (it > 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::reg_fence(acc);

    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int yy = y0 + wg;
    if (yy < H) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int xx = x0 + 16 * warp + lane / 4 + 8 * hh;
        if (xx >= W) continue;
        __nv_bfloat16* dst = y + ((static_cast<long long>(b) * H + yy) * W + xx) * Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * (lane % 4);
          if (n < Cout)  // Cout % 8 == 0, so n + 1 < Cout too
            *reinterpret_cast<__nv_bfloat162*>(dst + n) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch_bf16(const void* x, const void* w, void* y, int B, int H, int W, int C,
                        int Cout, cudaStream_t stream) {
  using namespace tc;
  if (C % 8 != 0 || Cout % 8 != 0) return cudaErrorInvalidValue;
  const int tiles_x = (W + kCols - 1) / kCols, tiles_y = (H + kRows - 1) / kRows;
  const long long mtiles = static_cast<long long>(tiles_x) * tiles_y * B;
  if (mtiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap tmap_x, tmap_w;
  const uint64_t xd[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                          static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t xs[3] = {2ull * C, 2ull * W * C, 2ull * H * W * C};
  const uint32_t xb[4] = {kChunk, kCols, kRows, 1};
  const uint64_t wd[3] = {static_cast<uint64_t>(Cout), static_cast<uint64_t>(C), 9};
  const uint64_t ws[2] = {2ull * Cout, 2ull * C * Cout};
  const uint32_t wb[3] = {64, kChunk, 1};
  cudaError_t err = hopper::make_tmap(&tmap_x, x, 4, xd, xs, xb);
  if (err != cudaSuccess) return err;
  err = hopper::make_tmap(&tmap_w, w, 3, wd, ws, wb);
  if (err != cudaSuccess) return err;
  constexpr int kSmem = Tile<BN>::kSmem;
  if ((err = hopper::allow_smem<conv3x3_bf16_kernel<BN>>(kSmem)) != cudaSuccess) return err;
  const dim3 grid((Cout + BN - 1) / BN, static_cast<unsigned>(mtiles));
  conv3x3_bf16_kernel<BN><<<grid, kTcThreads, kSmem, stream>>>(
      tmap_x, tmap_w, static_cast<__nv_bfloat16*>(y), H, W, C, Cout, tiles_x, tiles_y);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): x (B, H, W, C) and w (3, 3, C,
// Cout) contiguous, y (B, H, W, Cout) contiguous, all fp32 or all bf16
// (bf16: 16-byte aligned, Cout % 8 == 0). Returns the cudaError_t of the
// launch.
extern "C" int comat_conv3x3_fwd(const void* x, const void* w, void* y, int is_bf16, int B, int H,
                                 int W, int C, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || C % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bf16: 256 output channels a CTA where they fill it, else 128
  if (is_bf16)
    return static_cast<int>(Cout % 256 == 0 ? launch_bf16<256>(x, w, y, B, H, W, C, Cout, s)
                                            : launch_bf16<128>(x, w, y, B, H, W, C, Cout, s));
  const long long M = static_cast<long long>(B) * H * W;
  const long long mblocks = (M + BM - 1) / BM;
  if (mblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(mblocks), (Cout + BN - 1) / BN);
  conv3x3_f32_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(y), B, H, W, C, Cout);
  return static_cast<int>(cudaGetLastError());
}
