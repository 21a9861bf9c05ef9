// Input gradient of the lowering conv for Hopper (sm_90a): dCols = dY @ K^T,
// then col2im back onto the image.
//
// Replaces the TPU kernel src/repro/kernels/lowering_conv/bwd.py ::
// dgrad_pallas (_dgrad_kernel, _col2im_accumulate).
//
// What it computes: dcols[m, k] = sum_n dY[m, n] * w[k, n] over the Cout
// channels (w in HWIO is the (K, Cout) kernel matrix), then
//   dX[b, h, w, c] = sum over taps (i, j) with h = ho*s + i, w = wo*s + j
//                    inside the output of dcols[(b, ho, wo), (i, j, c)],
// adding the taps in (i, j) order from 0, as the reference's col2im does.
//
// Bound on an H100: operations. 2*M*K*Cout flops for the product against
// (M*Cout + K*Cout + B*H*W*Cin)*4 bytes; at CaffeNet's layers 2-5 well
// above ~20 fp32 flops a byte, so the least time is flops / 67 TFLOP/s.
//
// Design: the TPU kernel takes a whole batch block at once so that
// overlapping windows never race on a pixel. Here two kernels run in turn
// (one launch of dgrad for the wrapper's count): a 64 x 64-tile product
// (tile_gemm.cuh) writes dcols into an fp32 scratch in device memory, and
// col2im runs in gather form, one thread per dX element summing its own
// taps: no atomics, no race, any stride. Known limit: dcols makes a round
// trip through device memory (M*K*4 bytes each way); fusing col2im into the
// product's epilogue is later work.
#include "tile_gemm.cuh"

namespace {

__global__ void __launch_bounds__(tile::kThreads)
dgrad_gemm_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                  float* __restrict__ dcols, int M, int K, int Cout) {
  const int m0 = blockIdx.x * tile::kBM;
  const int k0 = blockIdx.y * tile::kBN;
  const int t = threadIdx.x;
  __shared__ __align__(16) tile::Smem s;
  // both stages: thread t reads channel n = q0 + t % 16 of rows t / 16 + 16p
  const int qn = t & 15;
  const int r = t >> 4;

  auto load = [&](tile::Smem& sm, int q0) {
    const int n = q0 + qn;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int m = m0 + r + 16 * p;
      const int k = k0 + r + 16 * p;
      sm.a[qn][r + 16 * p] =
          (n < Cout && m < M) ? dy[static_cast<long long>(m) * Cout + n] : 0.f;
      sm.b[qn][r + 16 * p] =
          (n < Cout && k < K) ? w[static_cast<long long>(k) * Cout + n] : 0.f;
    }
  };

  float acc[4][4] = {};
  tile::gemm(s, acc, 0, Cout, load);
  tile::store(dcols, K, m0, k0, M, K, acc);
}

__global__ void col2im_gather_kernel(const float* __restrict__ dcols, float* __restrict__ dx,
                                     int B, int H, int W, int Cin, int kh, int kw, int stride,
                                     int Ho, int Wo) {
  const long long total = static_cast<long long>(B) * H * W * Cin;
  const long long K = static_cast<long long>(kh) * kw * Cin;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const int c = static_cast<int>(idx % Cin);
    long long rest = idx / Cin;
    const int x = static_cast<int>(rest % W);
    rest /= W;
    const int h = static_cast<int>(rest % H);
    const int b = static_cast<int>(rest / H);
    float acc = 0.f;
    for (int i = 0; i < kh; ++i) {
      const int hh = h - i;
      if (hh < 0) break;
      if (hh % stride) continue;
      const int ho = hh / stride;
      if (ho >= Ho) continue;
      for (int j = 0; j < kw; ++j) {
        const int ww = x - j;
        if (ww < 0) break;
        if (ww % stride) continue;
        const int wo = ww / stride;
        if (wo >= Wo) continue;
        acc += dcols[((static_cast<long long>(b) * Ho + ho) * Wo + wo) * K +
                     static_cast<long long>(i * kw + j) * Cin + c];
      }
    }
    dx[idx] = acc;
  }
}

}  // namespace

// dy: (B, Ho, Wo, Cout), w: (kh, kw, Cin, Cout), dcols: (B*Ho*Wo, kh*kw*Cin)
// scratch, dx: (B, H, W, Cin); all fp32 and contiguous; VALID padding.
// Returns cudaGetLastError() after the launches.
extern "C" int dgrad_launch(const void* dy, const void* w, void* dcols, void* dx, int B, int H,
                            int W, int Cin, int kh, int kw, int stride, int Cout, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stride < 1 || kh > H || kw > W || B < 1 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - kh) / stride + 1;
  const int Wo = (W - kw) / stride + 1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const int K = kh * kw * Cin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((M + tile::kBM - 1) / tile::kBM),
                  static_cast<unsigned>((K + tile::kBN - 1) / tile::kBN));
  dgrad_gemm_kernel<<<grid, tile::kThreads, 0, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(w), static_cast<float*>(dcols),
      static_cast<int>(M), K, Cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * H * W * Cin;
  const long long blocks = (total + 255) / 256;
  col2im_gather_kernel<<<static_cast<unsigned>(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0,
                         s>>>(static_cast<const float*>(dcols), static_cast<float*>(dx), B, H, W,
                              Cin, kh, kw, stride, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}
