// Input gradient of the lowering conv for Hopper (sm_90a): dX as one
// implicit GEMM on tensor cores in 3xTF32, with no patch-column matrix and
// no col2im pass.
//
// Replaces the TPU kernel src/repro/kernels/lowering_conv/bwd.py ::
// dgrad_pallas (_dgrad_kernel, _col2im_accumulate).
//
// What it computes: the JAX kernel's dcols = dY @ K^T followed by col2im,
// written as one product over the taps,
//   dX[b, h, w, c] = sum_{i, j, n} dY[b, (h-i)/s, (w-j)/s, n] * W[i, j, c, n]
// over the taps (i, j) where h-i and w-j are non-negative multiples of the
// stride s inside (Ho, Wo): a GEMM of M' = B*H*W rows (the pixels of dX),
// N' = Cin columns and depth K' = kh*kw*Cout, taken tap by tap in (i, j)
// order, Cout fastest. The A operand is gathered from dY (zero off the
// output and off the stride's lattice); the B operand is W as it lies, read
// as (kh*kw*Cout, Cin) with Cout contiguous.
//
// Bound on an H100: operations. The necessary work is the product form's
// 2*M*K*Cout flops (M = B*Ho*Wo, K = kh*kw*Cin); 3xTF32 spends three TF32
// tensor-core products on each, so the least time is 3 * flops / 495
// TFLOP/s (0.375 ms over CaffeNet's conv2-5 at group batch 64, against
// 0.926 ms at the 67 TFLOP/s fp32 CUDA-core rate). The implicit form does
// 1.46x the product form's flops on those layers (VALID padding leaves a
// zero border of taps that only add zeros).
//
// Design. One block of 4 warps per 64 x BN tile of dX, each warp a 32 x
// BN/2 tile of mma.sync m16n8k8 TF32 products; the wrapper picks BN (64 or
// 96 input channels) so that Cin pads least, conv2's 96 channels filling
// one tile. 64-pixel tiles keep the grid at several blocks per SM, which
// beat 128-pixel tiles at conv2 and conv5 on an H100 (wave quantization).
// Each block owns its dX tile: no atomics, no scratch, and the same bits
// every run. Stages of 32 output channels of one tap go through a 3-stage
// cp.async ring: the A stage (64 pixels x 32 channels) is gathered straight
// from dY, 16 bytes at a time, each thread keeping its rows' pixel offsets
// in registers and walking the taps with counters; the B stage (BN input
// channels x 32 output channels) is copied from W. Shared rows are padded
// by 16 bytes, so ldmatrix reads (fp32 pairs moved as b16 pairs) are
// conflict-free. Every fragment is split as big = the nearest TF32 and
// small = x - big, and each product accumulates big*small + small*big, then
// big*big, in fp32: the relative error stays near fp32's (one TF32 product
// alone is ~3e-4, which the 1e-5 checks reject). The tensor cores' own fp32
// accumulation truncates where IEEE rounds; chained over all of K' (2400
// products at conv2) it drifted to 4e-5 relative RMS on an H100, so each
// stage sums into a fresh register tile (its first product from a zero
// accumulator) that is added to the running sum with one IEEE fp32 add per
// output element and stage. With Cout not a multiple of 4 the copies fall
// back to 4 bytes an element.
// Stride > 1 takes the same path, paying for the taps that miss the lattice.
#include "../../common/ptx.cuh"

namespace {

constexpr int kBM = 64;        // pixels of dX per block
constexpr int kBK = 32;        // output channels of one tap per stage
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, 2 x 2, each a 32 x BN/2 tile
constexpr int kRS = kBK + 4;   // shared row stride in floats (16 bytes of padding)

template <int BN>
constexpr int smem_bytes() {
  return kStages * (kBM + BN) * kRS * static_cast<int>(sizeof(float));
}

using namespace ptx;

template <int BN, int VEC>
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ w, float* __restrict__ dx,
             int H, int W, int Cin, int kw, int stride, int Ho, int Wo, int Cout, int M,
             int n_k) {
  constexpr int WN = BN / 2;                // columns of a warp's tile
  constexpr int NB = WN / 8;                // 8-column mma blocks per warp
  constexpr int CPR = kBK / VEC;            // copies per shared row
  constexpr int RPP = kThreads / CPR;       // rows one pass of the block copies
  constexpr int PA = kBM / RPP;             // A rows this thread copies per stage
  static_assert(NB % 2 == 0 && kBM % RPP == 0 && BN % RPP == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                         // kStages x kBM x kRS: dY gathered
  float* Bs = smem + kStages * kBM * kRS;   // kStages x BN x kRS: W[i, j, c, n]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * BN;
  const int nch = (Cout + kBK - 1) / kBK;   // stages per tap
  const int cp_col = (tid % CPR) * VEC;     // this thread's column in a stage
  const int cp_row = tid / CPR;             // and its first row

  // The pixels (b, h, w) of this thread's A rows, as h, w and the dY index
  // of tap (0, 0) at stride 1, b*Ho*Wo + h*Wo + w; rows past M get h < 0.
  int row_h[PA], row_x[PA], row_base[PA];
#pragma unroll
  for (int p = 0; p < PA; ++p) {
    const int m = m0 + cp_row + p * RPP;
    row_h[p] = -1;
    row_x[p] = 0;
    row_base[p] = 0;
    if (m < M) {
      const int img = m / (H * W);
      const int rem = m - img * H * W;
      row_h[p] = rem / W;
      row_x[p] = rem - row_h[p] * W;
      row_base[p] = img * Ho * Wo + row_h[p] * Wo + row_x[p];
    }
  }

  // The loader walks the stages in order, tap (i, j) outer and 32 output
  // channels at a time inner, so it keeps counters instead of dividing.
  int ld_i = 0, ld_j = 0, ld_tap = 0, ld_chunk = 0;
  auto load = [&](int st) {
    const int i = ld_i, j = ld_j;
    const int n = ld_chunk * kBK + cp_col;
    const float* wt = w + static_cast<long long>(ld_tap) * Cin * Cout + n;
    if (++ld_chunk == nch) {
      ld_chunk = 0;
      ++ld_tap;
      if (++ld_j == kw) {
        ld_j = 0;
        ++ld_i;
      }
    }
    float* as = As + st * kBM * kRS;
    float* bs = Bs + st * BN * kRS;
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int hb = row_h[p] - i, xb = row_x[p] - j;
      bool ok = hb >= 0 && xb >= 0 && n < Cout;
      int idx;
      if (stride == 1) {
        ok = ok && hb < Ho && xb < Wo;
        idx = row_base[p] - i * Wo - j;
      } else {
        const int ho = hb / stride, wo = xb / stride;
        ok = ok && ho * stride == hb && wo * stride == xb && ho < Ho && wo < Wo;
        idx = row_base[p] - row_h[p] * Wo - row_x[p] + ho * Wo + wo;
      }
      const float* src = ok ? dy + static_cast<long long>(idx) * Cout + n : dy;
      cp_async<VEC>(smem_u32(as + (cp_row + p * RPP) * kRS + cp_col), src, ok);
    }
#pragma unroll
    for (int p = 0; p < BN / RPP; ++p) {
      const int r = cp_row + p * RPP;
      const bool ok = c0 + r < Cin && n < Cout;
      const float* src = ok ? wt + static_cast<long long>(c0 + r) * Cout : w;
      cp_async<VEC>(smem_u32(bs + r * kRS + cp_col), src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();
  }

  float acc[2][NB][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < n_k) load(nxt % kStages);
    cp_async_commit();

    const float* as = As + (kt % kStages) * kBM * kRS;
    const float* bs = Bs + (kt % kStages) * BN * kRS;
    float part[2][NB][4];  // this stage's sums, added to acc with IEEE fp32 adds
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        uint32_t raw[4];
        ldmatrix_x4(raw, smem_u32(as + (wm * 32 + mb * 16 + (lane & 15)) * kRS + ks * 8 +
                                  (lane >> 4) * 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(raw[e], a_big[mb][e], a_small[mb][e]);
      }
      uint32_t b_big[NB][2], b_small[NB][2];
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t raw[4];
        ldmatrix_x4(raw, smem_u32(bs + (wn * WN + np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                           kRS +
                                  ks * 8 + ((lane >> 3) & 1) * 4));
        split_tf32(raw[0], b_big[2 * np][0], b_small[2 * np][0]);
        split_tf32(raw[1], b_big[2 * np][1], b_small[2 * np][1]);
        split_tf32(raw[2], b_big[2 * np + 1][0], b_small[2 * np + 1][0]);
        split_tf32(raw[3], b_big[2 * np + 1][1], b_small[2 * np + 1][1]);
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (ks == 0)
            mma_tf32_first(part[mb][nb], a_big[mb], b_small[nb]);
          else
            mma_tf32(part[mb][nb], a_big[mb], b_small[nb]);
          mma_tf32(part[mb][nb], a_small[mb], b_big[nb]);
          mma_tf32(part[mb][nb], a_big[mb], b_big[nb]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] += part[a][b][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * 32 + mb * 16 + g + (e >> 1) * 8;
        const int c = c0 + wn * WN + nb * 8 + 2 * tig + (e & 1);
        if (r < M && c < Cin) dx[static_cast<long long>(r) * Cin + c] = acc[mb][nb][e];
      }
}

template <int BN, int VEC>
cudaError_t launch(const float* dy, const float* w, float* dx, int B, int H, int W, int Cin,
                   int kh, int kw, int stride, int Ho, int Wo, int Cout, cudaStream_t s) {
  constexpr int smem = smem_bytes<BN>();
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(dgrad_kernel<BN, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  const int n_k = kh * kw * ((Cout + kBK - 1) / kBK);
  const dim3 grid((M + kBM - 1) / kBM, (Cin + BN - 1) / BN);
  dgrad_kernel<BN, VEC><<<grid, kThreads, smem, s>>>(dy, w, dx, H, W, Cin, kw, stride, Ho, Wo,
                                                     Cout, M, n_k);
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory one block asks for at tile width block_n (64 or
// 96 input channels), -1 for any other width: the footprint model
// (lowering_conv.smem_bytes) is held to it on the card.
extern "C" int dgrad_smem_bytes(int block_n) {
  return block_n == 96 ? smem_bytes<96>() : block_n == 64 ? smem_bytes<64>() : -1;
}

// dy: (B, Ho, Wo, Cout), w: (kh, kw, Cin, Cout), dx: (B, H, W, Cin); all
// fp32 and contiguous; VALID padding. block_n (64 or 96) is the tile's
// width in input channels. Returns cudaGetLastError() after the launch.
extern "C" int dgrad_launch(const void* dy, const void* w, void* dx, int B, int H, int W,
                            int Cin, int kh, int kw, int stride, int Cout, int block_n,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stride < 1 || kh > H || kw > W || B < 1 || Cin < 1 || Cout < 1 ||
      static_cast<long long>(B) * H * W > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - kh) / stride + 1;
  const int Wo = (W - kw) / stride + 1;
  const float* a = static_cast<const float*>(dy);
  const float* b = static_cast<const float*>(w);
  float* c = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = Cout % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  if (block_n == 96)
    err = vec ? launch<96, 4>(a, b, c, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s)
              : launch<96, 1>(a, b, c, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s);
  else if (block_n == 64)
    err = vec ? launch<64, 4>(a, b, c, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s)
              : launch<64, 1>(a, b, c, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
