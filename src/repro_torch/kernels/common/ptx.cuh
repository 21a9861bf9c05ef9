// PTX building blocks shared by the port's kernels: cp.async copies into
// shared memory (paged decode, the conv kernels), the bf16 packing (flash
// attention and paged decode) and the TF32 split (the 3xTF32 conv
// forward, wgrad and dgrad, and hopper.cuh's prologue).
//
// 3xTF32: every fp32 operand x is split as big = the nearest TF32 and
// small = x - big (split_tf32), and a product accumulates big*small +
// small*big, then big*big, in fp32, which keeps the relative error near
// fp32's where one TF32 product alone is ~3e-4.
//
// A kernel source includes it as "../../common/ptx.cuh"; the build hashes
// it into every kernel's library name.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !pred (reads nothing).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
// Async copy of VEC (4 or 1) floats global -> shared, zero-filled when !pred.
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool pred) {
  if constexpr (VEC == 4) {
    cp_async16(dst, src, pred);
  } else {
    const int n = pred ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = big + small: big the nearest TF32 (ties away, as cvt.rna.tf32.f32)
// by integer ops, small = x - big exactly; the mma reads only the top 10
// mantissa bits of small's fp32 pattern (truncation), an error below
// 2^-22 of x.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big, uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
}

}  // namespace ptx
