// Convolution by lowering + GEMM for Hopper (sm_90a): a VALID NHWC conv as
// one implicit GEMM against the kernel matrix, optionally writing the
// lowered patch matrix as the backward's residual.
//
// Replaces the TPU kernel src/repro/kernels/lowering_conv/lowering_conv.py ::
// lowering_conv_pallas (_kernel, _kernel_with_lowered, _lower_block).
//
// What it computes: with M = B*Ho*Wo rows m = (b, ho, wo) and K = kh*kw*Cin
// columns k = (i, j, c) (c fastest, the order of the JAX `lower`),
//   y[m, n] = sum_k x[b, ho*s + i, wo*s + j, c] * w[i, j, c, n]
// (w in HWIO is the (K, Cout) kernel matrix as it lies), and with a
// residual buffer also lowered[m, k] = x[b, ho*s + i, wo*s + j, c], i.e.
// the (B, Ho, Wo, K) lowered matrix of the JAX `return_lowered`.
//
// Bound on an H100: operations. 2*M*K*Cout fp32 flops over the input, the
// weights and the output is well above the card's ~20 fp32 flops a byte at
// every CaffeNet layer, so the least time is flops / 67 TFLOP/s (fp32
// outside the tensor cores). The residual's M*K*4 bytes come closest at
// conv1 (K = 363, ~34 flops a byte with it).
//
// Design, simple first: one block per 64 x 64 tile of y (tile_gemm.cuh).
// Each stage of 16 columns of K is lowered straight into shared memory from
// x (one integer division per thread and stage finds the (i, j, c) offset;
// each thread keeps the image offsets of its four rows), so the lowered
// matrix never passes through device memory on the way to the product.
// With the residual, only the blocks of the first Cout tile write the
// patches they lowered, so every residual element is written once. No
// tensor cores yet: wgmma on TF32 or bf16 tiles fed by TMA is later work.
#include "tile_gemm.cuh"

namespace {

__global__ void __launch_bounds__(tile::kThreads)
lowering_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, float* __restrict__ lowered, int B, int H, int W,
                     int Cin, int kh, int kw, int stride, int Ho, int Wo, int Cout) {
  const int M = B * Ho * Wo;
  const int K = kh * kw * Cin;
  const int m0 = blockIdx.x * tile::kBM;
  const int n0 = blockIdx.y * tile::kBN;
  const int t = threadIdx.x;
  __shared__ __align__(16) tile::Smem s;

  // A stage: thread t lowers column q = t % 16 for rows t / 16 + 16p.
  const int qa = t & 15;
  const int ra = t >> 4;
  long long rowbase[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + ra + 16 * p;
    if (m < M) {
      const int b = m / (Ho * Wo);
      const int r = m - b * Ho * Wo;
      const int ho = r / Wo;
      const int wo = r - ho * Wo;
      rowbase[p] = (static_cast<long long>(b * H + ho * stride) * W + wo * stride) * Cin;
    } else {
      rowbase[p] = -1;
    }
  }
  const bool write_low = lowered != nullptr && blockIdx.y == 0;
  const int kwc = kw * Cin;
  const long long wc = static_cast<long long>(W) * Cin;
  // B stage: thread t reads column n = t % 64 of rows t / 64 + 4p.
  const int nb = t & 63;
  const int qb = t >> 6;

  auto load = [&](tile::Smem& sm, int q0) {
    const int k = q0 + qa;
    long long koff = -1;
    if (k < K) {
      const int i = k / kwc;
      koff = i * wc + (k - i * kwc);  // (i*W + j)*Cin + c, as j*Cin + c = k - i*kw*Cin
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float val = 0.f;
      if (rowbase[p] >= 0 && koff >= 0) {
        val = x[rowbase[p] + koff];
        if (write_low)
          lowered[static_cast<long long>(m0 + ra + 16 * p) * K + k] = val;
      }
      sm.a[qa][ra + 16 * p] = val;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int q = q0 + qb + 4 * p;
      const int n = n0 + nb;
      sm.b[qb + 4 * p][nb] =
          (q < K && n < Cout) ? w[static_cast<long long>(q) * Cout + n] : 0.f;
    }
  };

  float acc[4][4] = {};
  tile::gemm(s, acc, 0, K, load);
  tile::store(y, Cout, m0, n0, M, Cout, acc);
}

}  // namespace

// x: (B, H, W, Cin), w: (kh, kw, Cin, Cout), y: (B, Ho, Wo, Cout), all fp32
// and contiguous; lowered: (B, Ho, Wo, kh*kw*Cin) or null. VALID padding.
// Returns cudaGetLastError() after the launch.
extern "C" int lowering_conv_launch(const void* x, const void* w, void* y, void* lowered, int B,
                                    int H, int W, int Cin, int kh, int kw, int stride, int Cout,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stride < 1 || kh > H || kw > W || B < 1 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - kh) / stride + 1;
  const int Wo = (W - kw) / stride + 1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((M + tile::kBM - 1) / tile::kBM),
                  static_cast<unsigned>((Cout + tile::kBN - 1) / tile::kBN));
  lowering_conv_kernel<<<grid, tile::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
      static_cast<float*>(lowered), B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout);
  return static_cast<int>(cudaGetLastError());
}
