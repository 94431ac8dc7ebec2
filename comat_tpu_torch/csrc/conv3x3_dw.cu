// Weight gradient of the 3x3 stride-1 SAME convolution for Hopper (sm_90a),
// NHWC, no bias:
//   dw[di, dj, c, n] = sum over (b, y, x) of x[b, y + di - 1, x + dj - 1, c] * dy[b, y, x, n]
// (zero outside the image), summed in fp32 and rounded once to the weight
// dtype.
//
// Replaces the TPU kernel comat_tpu/ops/conv3x3.py:_conv_dw_kernel (launched
// from _vjp_bwd when the VAE trains). The TPU kernel runs its grid in order
// and accumulates every (batch, row strip) into one resident output block;
// on the card blocks run in parallel and in no order, so the sum is split:
//   pass 1: dw^T = A^T dY as a GEMM with M = 9*C rows (tap, channel), N =
//           Cout columns and the reduction over the B*H*W pixels; each block
//           owns one output tile and one contiguous range of pixels and
//           writes its fp32 partial sum to a workspace slice;
//   pass 2: one thread per output element adds the slices in a fixed order
//           and rounds to the weight dtype.
// No float atomics, so a run repeats bit for bit.
//
// What bounds it on the H100: 2*B*H*W*9*C*Cout operations against
// B*H*W*(C + Cout) elements read, hundreds of operations per byte at C,
// Cout >= 128: arithmetic. The output is small (9*C*Cout), so the pixel
// split is what gives the card enough blocks.
//
// The dtype picks the code, explicitly:
// - bf16 runs on the tensor cores (wgmma, HGMMA in the SASS). The M rows
//   are cut into row boxes of 64 channels of one tap, 9 * ceil(C / 64) of
//   them, tap-major (a tap's last box runs past C when C % 64 != 0). Each
//   consumer warpgroup multiplies one 64-wide A box by four B boxes
//   (m64n256k16, 128 accumulators a thread), so a block computes 128 x
//   256 products for 48 KB of operands a step. Where Cout is a multiple
//   of 256, A is 2 row boxes and B 256 output channels; else A is 128
//   output channels and B 4 row boxes (the product transposed). A block
//   walks its pixel range in steps of one image row
//   by 64 columns: the wgmma K dimension. For each step one producer
//   thread loads, with TMA, the x box x[b, y + di - 1, x0 + dj - 1 : +64,
//   c0 : +64] of each row box (its tap's shifted coordinate) and the dy
//   boxes dy[b, y, x0 : +64, n0 : +64] into a shared-memory ring
//   (mbarriers, 128-byte swizzle). TMA fills coordinates outside the
//   tensor with zeros: the halo, the ragged end of a row (W % 64) and the
//   channel tails, with no bounds checks. In NHWC both tiles are MN-major
//   (pixels are rows, channels contiguous), which wgmma reads from shared
//   memory for bf16 without a transpose. Blocks are numbered output tile
//   fastest and pixel split slowest, so the blocks resident together read
//   the same pixel range and share its x and dy rows in L2; the wrapper
//   picks the split count from the tile count, the waves of 132 blocks it
//   makes and the workspace it costs (`ops/conv3x3.py:dw_splits`). Row
//   strides must be multiples of 16 bytes: C % 8 == 0, Cout % 8 == 0.
// - fp32 stays on the CUDA cores: a 128x128x8 shared-memory GEMM tile, 256
//   threads each owning 8x8 outputs, the next 8-pixel slice prefetched
//   into registers while the current one is multiplied; the halo is a
//   bounds check on the gathered x rows. Each 4-channel group a thread
//   loads lies inside one tap (C % 8 == 0).
#include "hopper.cuh"

namespace {

using hopper::sw128_desc;

// ---------------------------------------------------------------- fp32

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BP = 8;  // (tap, channel) rows, Cout columns, pixels

__device__ __forceinline__ float from_f(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f(float x, __nv_bfloat16) {
  return __float2bfloat16(x);
}

__global__ void __launch_bounds__(kThreads)
    conv3x3_dw_f32_partial(const float* __restrict__ x, const float* __restrict__ dy,
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
        const float* src = x + ((static_cast<long long>(b) * H + iy) * W + ix) * C + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) a_reg[e] = src[e];
      }
      const float* gsrc = dy + m * Cout + n;
#pragma unroll
      for (int e = 0; e < 4; ++e) b_reg[e] = (n + e < Cout) ? gsrc[e] : 0.f;
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
    dw[idx] = from_f(s, T());
  }
}

template <typename T>
cudaError_t reduce(const float* work, void* dw, int C, int Cout, int splits, cudaStream_t s) {
  const long long count = 9LL * C * Cout;
  const long long blocks = (count + kThreads - 1) / kThreads;
  conv3x3_dw_reduce<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(
      work, static_cast<T*>(dw), count, splits);
  return cudaGetLastError();
}

cudaError_t run_f32(const float* x, const float* dy, float* dw, float* work, int B, int H, int W,
                    int C, int Cout, int splits, long long pix_per_split, cudaStream_t s) {
  const dim3 grid((9 * C + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
  conv3x3_dw_f32_partial<<<grid, kThreads, 0, s>>>(x, dy, work, B, H, W, C, Cout, pix_per_split);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : reduce<float>(work, dw, C, Cout, splits, s);
}

// ---------------------------------------------------------------- bf16

namespace tc {
constexpr int kCols = 64;                  // pixels a step: one image row x 64 columns
constexpr int kTcThreads = 384;            // 2 consumer warpgroups + 1 producer
constexpr int kBox = kCols * 64 * 2;       // 8 KB: 64 pixels x 64 channels (x or dy)
// a stage: 2 A boxes (one a consumer warpgroup, wgmma M = 64) and 4 B
// boxes (wgmma N = 256); the ring as deep as 192 KB of shared memory allows
constexpr int kStageBytes = 6 * kBox;
constexpr int kStages = 196608 / kStageBytes;
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
}  // namespace tc

// SWAP = false: A = 2 x row boxes (128 rows), B = 4 dy boxes (256 output
// channels). SWAP = true: A = 2 dy boxes (128 output channels), B = 4 x
// row boxes.
template <bool SWAP>
__global__ void __launch_bounds__(tc::kTcThreads, 1)
    conv3x3_dw_bf16_kernel(const __grid_constant__ CUtensorMap tmap_x,
                           const __grid_constant__ CUtensorMap tmap_dy,
                           float* __restrict__ part, int H, int C, int Cout, int tiles_x,
                           int chunks, int per_split) {
  using namespace tc;
  constexpr int kXBoxes = SWAP ? 4 : 2, kDyBoxes = SWAP ? 2 : 4;
  constexpr int kXSlot = SWAP ? 2 : 0, kDySlot = SWAP ? 0 : 2;  // their first slot in a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  // the output tile: output channel block fastest, then the run of x row
  // boxes
  const int wg = threadIdx.x / 128;
  const int box_per_tap = (C + 63) / 64, boxes = 9 * box_per_tap;
  const int n_blocks = (Cout + 64 * kDyBoxes - 1) / (64 * kDyBoxes);
  const int n0 = (blockIdx.x % n_blocks) * 64 * kDyBoxes;
  const int box0 = (blockIdx.x / n_blocks) * kXBoxes;
  // this block's steps (image row, 64-column chunk) of the pixel sum
  const int q0 = blockIdx.y * per_split;
  const int iters = min(per_split, chunks - q0);
  // boxes to load: the rest hold rows or columns never stored
  const int x_boxes = min(kXBoxes, boxes - box0);
  const int dy_boxes = min(kDyBoxes, (Cout - n0 + 63) / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const uint32_t bytes = (x_boxes + dy_boxes) * kBox;
      for (int it = 0; it < iters; ++it) {
        const int s = it % kStages;
        if (it >= kStages) hopper::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        uint8_t* st = smem + s * kStageBytes;
        const int q = q0 + it, row = q / tiles_x;
        const int x0 = (q - row * tiles_x) * kCols, y = row % H, b = row / H;
        hopper::mbar_expect_tx(&full[s], bytes);
        for (int j = 0; j < x_boxes; ++j) {
          const int tap = (box0 + j) / box_per_tap;
          const int c0 = (box0 + j - tap * box_per_tap) * 64;
          hopper::tma_load_4d(st + (kXSlot + j) * kBox, &tmap_x, c0, x0 + tap % 3 - 1,
                              y + tap / 3 - 1, b, &full[s]);
        }
        for (int j = 0; j < dy_boxes; ++j)
          hopper::tma_load_4d(st + (kDySlot + j) * kBox, &tmap_dy, n0 + 64 * j, x0, y, b,
                              &full[s]);
      }
    }
  } else {
    // consumers: warpgroup wg multiplies A box wg (M = 64) by the 4 B
    // boxes (N = 256); both operands MN-major
    hopper::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    float acc[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] = 0.f;
    const uint32_t base = hopper::smem_u32(smem);
    for (int it = 0; it < iters; ++it) {
      const int s = it % kStages;
      hopper::mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a = base + s * kStageBytes + wg * kBox;
      const uint32_t bq = base + s * kStageBytes + 2 * kBox;
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kCols / 16; ++k)
        hopper::wgmma_ss<1, 1>(acc, sw128_desc(a + 2048 * k, kBox, 1024),
                               sw128_desc(bq + 2048 * k, kBox, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (it > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::reg_fence(acc);

    // fp32 partial sums into this split's workspace slice, rows (tap, c);
    // acc[r]: A row 16 warp + lane / 4 + 8 ((r / 2) % 2), B column 8 (r / 4)
    // + 2 (lane % 4) + r % 2. C % 8 == 0, so c < C gives c + 1 < C too;
    // the same for n and Cout.
    float* out = part + static_cast<long long>(blockIdx.y) * 9 * C * Cout;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = 16 * warp + lane / 4 + 8 * hh;
      if (!SWAP) {
        const int box = box0 + wg;
        const int tap = box / box_per_tap, c = (box - tap * box_per_tap) * 64 + m;
        if (box >= boxes || c >= C) continue;
        float* dst = out + (static_cast<long long>(tap) * C + c) * Cout;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int n = n0 + 8 * j + 2 * (lane % 4);
          if (n < Cout)
            *reinterpret_cast<float2*>(dst + n) =
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      } else {
        const int n = n0 + 64 * wg + m;
        if (n >= Cout) continue;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int box = box0 + j / 8;
          const int tap = box / box_per_tap;
          const int c = (box - tap * box_per_tap) * 64 + 8 * (j % 8) + 2 * (lane % 4);
          if (box >= boxes || c >= C) continue;
          float* dst = out + (static_cast<long long>(tap) * C + c) * Cout + n;
          dst[0] = acc[4 * j + 2 * hh];
          dst[Cout] = acc[4 * j + 2 * hh + 1];
        }
      }
    }
  }
}

template <bool SWAP>
cudaError_t launch_bf16(const void* x, const void* dy, float* work, int B, int H, int W, int C,
                        int Cout, int splits, int per_split, cudaStream_t stream) {
  using namespace tc;
  const int tiles_x = (W + kCols - 1) / kCols;
  const int chunks = B * H * tiles_x;
  const int x_boxes = SWAP ? 4 : 2, cols = SWAP ? 128 : 256;
  const long long tiles =
      (9LL * ((C + 63) / 64) + x_boxes - 1) / x_boxes * ((Cout + cols - 1) / cols);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap tmap_x, tmap_dy;
  const uint32_t box[4] = {64, kCols, 1, 1};
  const uint64_t xd[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                          static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t xs[3] = {2ull * C, 2ull * W * C, 2ull * H * W * C};
  const uint64_t gd[4] = {static_cast<uint64_t>(Cout), static_cast<uint64_t>(W),
                          static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t gs[3] = {2ull * Cout, 2ull * W * Cout, 2ull * H * W * Cout};
  cudaError_t err = hopper::make_tmap(&tmap_x, x, 4, xd, xs, box);
  if (err != cudaSuccess) return err;
  if ((err = hopper::make_tmap(&tmap_dy, dy, 4, gd, gs, box)) != cudaSuccess) return err;
  if ((err = hopper::allow_smem<conv3x3_dw_bf16_kernel<SWAP>>(kSmem)) != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), splits);
  conv3x3_dw_bf16_kernel<SWAP><<<grid, kTcThreads, kSmem, stream>>>(
      tmap_x, tmap_dy, work, H, C, Cout, tiles_x, chunks, per_split);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): x (B, H, W, C) and dy (B, H, W,
// Cout) contiguous, both fp32 or both bf16 (bf16: 16-byte aligned, Cout %
// 8 == 0); dw (3, 3, C, Cout) contiguous in the same dtype; `work` an fp32
// scratch of splits * 9*C*Cout elements. The pixel sum is cut into
// `splits` ranges of `per_split` units (the last may be shorter; none is
// empty): pixels in fp32, steps of one image row by 64 columns (B * H *
// ceil(W / 64) in all) in bf16. Returns the cudaError_t of the launches.
extern "C" int comat_conv3x3_dw(const void* x, const void* dy, void* dw, float* work, int is_bf16,
                                int B, int H, int W, int C, int Cout, int splits,
                                long long per_split, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || C % 8 != 0 ||
      (is_bf16 && Cout % 8 != 0) || splits <= 0 || splits > 65535 || per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = is_bf16 ? static_cast<long long>(B) * H * ((W + tc::kCols - 1) / tc::kCols)
                                  : static_cast<long long>(B) * H * W;
  if ((splits - 1) * per_split >= units || splits * per_split < units ||
      (is_bf16 && units > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return static_cast<int>(run_f32(static_cast<const float*>(x), static_cast<const float*>(dy),
                                    static_cast<float*>(dw), work, B, H, W, C, Cout, splits,
                                    per_split, s));
  const int per = static_cast<int>(per_split);
  // 128 x 256 products a block (see ops/conv3x3.py:dw_tiles)
  cudaError_t err = Cout % 256 == 0
                        ? launch_bf16<false>(x, dy, work, B, H, W, C, Cout, splits, per, s)
                        : launch_bf16<true>(x, dy, work, B, H, W, C, Cout, splits, per, s);
  if (err == cudaSuccess) err = reduce<__nv_bfloat16>(work, dw, C, Cout, splits, s);
  return static_cast<int>(err);
}
