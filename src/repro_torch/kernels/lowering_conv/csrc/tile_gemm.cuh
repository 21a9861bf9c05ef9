// A 64 x 64 fp32 tile product on CUDA cores, used by the wgrad kernel
// (wgrad.cu); the lowering-conv forward (lowering_conv.cu) and dgrad.cu run
// their own implicit GEMMs on TF32 tensor cores.
//
// One block of 256 threads owns a 64 x 64 tile of C = A @ B. The reduction
// runs in stages of 16: the caller's loader fills the shared tiles a[q][r]
// (A, transposed) and b[q][n] (B) for one stage, zero past every edge, and
// each thread then accumulates a 4 x 4 sub-tile of C in registers from two
// 16-byte shared-memory reads per step. The loader is the caller's: wgrad
// reads the lowered residual and dY.
#pragma once
#include <cuda_runtime.h>

namespace tile {

constexpr int kBM = 64;       // rows of C per block
constexpr int kBN = 64;       // columns of C per block
constexpr int kBQ = 16;       // reduction depth of one shared-memory stage
constexpr int kThreads = 256;
constexpr int kPad = 4;       // row padding in floats: keeps rows 16-byte aligned

struct Smem {
  float a[kBQ][kBM + kPad];   // a[q][r] = A[r0 + r, q0 + q]
  float b[kBQ][kBN + kPad];   // b[q][n] = B[q0 + q, n0 + n]
};

// acc[i][j] += sum over the stage of a[q][ty*4 + i] * b[q][tx*4 + j]
__device__ __forceinline__ void mma_stage(const Smem& s, float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int q = 0; q < kBQ; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[q][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[q][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The reduction over [q_begin, q_end) in stages of kBQ; load(s, q0) fills
// one stage (every thread of the block calls it).
template <class Load>
__device__ __forceinline__ void gemm(Smem& s, float (&acc)[4][4], int q_begin, int q_end,
                                     Load load) {
  for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
    load(s, q0);
    __syncthreads();
    mma_stage(s, acc);
    __syncthreads();
  }
}

// Write this thread's 4 x 4 sub-tile of the block's tile (r0, c0) into the
// row-major C (ld columns), inside rows x cols only.
__device__ __forceinline__ void store(float* C, long long ld, int r0, int c0, int rows,
                                      int cols, const float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < cols) C[r * ld + c] = acc[i][j];
    }
  }
}

}  // namespace tile
