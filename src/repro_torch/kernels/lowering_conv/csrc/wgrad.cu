// Weight gradient of the lowering conv for Hopper (sm_90a): dW = lowered^T @ dY
// from the forward's lowered residual, reduced over all M = B*Ho*Wo rows.
//
// Replaces the TPU kernel src/repro/kernels/lowering_conv/bwd.py ::
// wgrad_pallas (_wgrad_kernel).
//
// What it computes: dW[k, n] = sum_m lowered[m, k] * dY[m, n], the (K, Cout)
// matrix that is the HWIO weight gradient as it lies, accumulated in fp32
// (the residual's type on this path, as in the reference).
//
// Bound on an H100: operations. 2*M*K*Cout flops over M*(K + Cout)*4 bytes
// read: K*Cout/(2*(K + Cout)) flops a byte, 38-173 at CaffeNet's layers,
// above the card's ~20 fp32 flops a byte; the least time is flops / 67
// TFLOP/s.
//
// Design: the TPU kernel sums every grid step into one output block that
// stays in VMEM, which needs the grid to run in order. Blocks run in
// parallel here, and the output has few tiles (363 x 96 is 12 tiles of 64 x
// 64 at conv1), so the M rows are split into S slices of `slice_rows` (a
// multiple of 16) and block (tile, slice) writes an fp32 partial product
// into an (S, K, Cout) scratch (tile_gemm.cuh: dY and the residual are read
// 16 rows at a time into shared memory). A second kernel sums the S
// partials of each element in slice order. No atomics: a run gives the same
// bits as the last one. The wrapper picks S so that enough blocks fill the
// card and each slice sums at most 2048 rows.
#include "tile_gemm.cuh"

namespace {

__global__ void __launch_bounds__(tile::kThreads)
wgrad_partial_kernel(const float* __restrict__ low, const float* __restrict__ dy,
                     float* __restrict__ part, int M, int K, int Cout, int slice_rows) {
  const int n0 = blockIdx.x * tile::kBN;
  const int k0 = blockIdx.y * tile::kBM;
  const int z = blockIdx.z;
  const int q_begin = z * slice_rows;
  const int q_end = min(M, q_begin + slice_rows);
  const int t = threadIdx.x;
  __shared__ __align__(16) tile::Smem s;
  // both stages: thread t reads column t % 64 of rows t / 64 + 4p
  const int c = t & 63;
  const int qr = t >> 6;

  auto load = [&](tile::Smem& sm, int q0) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int m = q0 + qr + 4 * p;
      const bool in = m < q_end;
      const int k = k0 + c;
      const int n = n0 + c;
      sm.a[qr + 4 * p][c] = (in && k < K) ? low[static_cast<long long>(m) * K + k] : 0.f;
      sm.b[qr + 4 * p][c] = (in && n < Cout) ? dy[static_cast<long long>(m) * Cout + n] : 0.f;
    }
  };

  float acc[4][4] = {};
  tile::gemm(s, acc, q_begin, q_end, load);
  tile::store(part + static_cast<long long>(z) * K * Cout, Cout, k0, n0, K, Cout, acc);
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                    long long kn, int slices) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < kn;
       i += stride) {
    float acc = 0.f;
    for (int z = 0; z < slices; ++z) acc += part[z * kn + i];
    dw[i] = acc;
  }
}

}  // namespace

// lowered: (M, K), dy: (M, Cout), partial: (slices, K, Cout) scratch,
// dw: (K, Cout); all fp32 and contiguous. slices * slice_rows >= M and
// slice_rows % 16 == 0. Returns cudaGetLastError() after the launches.
extern "C" int wgrad_launch(const void* lowered, const void* dy, void* partial, void* dw, int M,
                            int K, int Cout, int slice_rows, int slices, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 1 || K < 1 || Cout < 1 || slices < 1 || slice_rows < 1 ||
      slice_rows % tile::kBQ != 0 || static_cast<long long>(slices) * slice_rows < M ||
      static_cast<long long>(slices - 1) * slice_rows >= M || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Cout + tile::kBN - 1) / tile::kBN, (K + tile::kBM - 1) / tile::kBM, slices);
  wgrad_partial_kernel<<<grid, tile::kThreads, 0, s>>>(
      static_cast<const float*>(lowered), static_cast<const float*>(dy),
      static_cast<float*>(partial), M, K, Cout, slice_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kn = static_cast<long long>(K) * Cout;
  const long long blocks = (kn + 255) / 256;
  wgrad_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), kn, slices);
  return static_cast<int>(cudaGetLastError());
}
