// Fused grouped momentum-SGD update for Hopper (sm_90a): the closed form of
// g sequential sub-steps applied to one parameter leaf (or one flat slab of
// several leaves) in a single pass.
//
// Replaces the TPU kernel src/repro/kernels/fused_update/fused_update.py ::
// fused_update_pallas (_kernel).
//
// What it computes, element by element, in the plain version's fp32 order:
//   W' = cww*W + cwv*V, then W' += a[i]*G[i] for i = 0..g-1
//   V' = cvw*W + cvv*V, then V' += b[i]*G[i] for i = 0..g-1
// Every product and every sum is rounded on its own (__fmul_rn / __fadd_rn:
// nvcc may not contract them to FMAs), so the result equals the plain
// PyTorch version (kernels/fused_update/ref.py), which runs one elementwise
// op at a time, bit for bit. Outputs are stored in the leaf's type (bf16 by
// round to nearest even).
//
// Bound on an H100: memory. It reads W, V and g gradients and writes W', V'
// once, (g + 4) * 4 bytes per fp32 element against 4g + 6 flops: about a
// quarter flop per byte, far below the card's ~20 fp32 flops a byte, so the
// least time is bytes / 3.35 TB/s.
//
// Design: a grid-stride elementwise pass. Where every operand is fp32,
// 16-byte aligned and n % 4 == 0 (every CaffeNet leaf), each thread moves
// four elements with 16-byte loads and stores; otherwise one element at a
// time. The coefficients (g <= 64 pairs plus the 2x2 block) travel by value
// in the kernel's parameters and the group loop is unrolled against the
// bound, so every coefficient is read at a constant offset.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxGroups = 64;
constexpr int kThreads = 256;

struct Coeffs {
  float cww, cwv, cvw, cvv;
  float a[kMaxGroups];
  float b[kMaxGroups];
  int g;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One element: gs points at G[0][idx], gstride = n.
template <typename TG>
__device__ __forceinline__ void combine(float w, float v, const TG* gs, long long gstride,
                                        const Coeffs& c, float* wn, float* vn) {
  float aw = __fadd_rn(__fmul_rn(c.cww, w), __fmul_rn(c.cwv, v));
  float av = __fadd_rn(__fmul_rn(c.cvw, w), __fmul_rn(c.cvv, v));
#pragma unroll
  for (int i = 0; i < kMaxGroups; ++i) {
    if (i >= c.g) break;
    const float gi = to_f(gs[i * gstride]);
    aw = __fadd_rn(aw, __fmul_rn(c.a[i], gi));
    av = __fadd_rn(av, __fmul_rn(c.b[i], gi));
  }
  *wn = aw;
  *vn = av;
}

template <typename TW, typename TV, typename TG>
__global__ void __launch_bounds__(kThreads)
fused_update_scalar(const TW* __restrict__ w, const TV* __restrict__ v,
                    const TG* __restrict__ gs, TW* __restrict__ wo, TV* __restrict__ vo,
                    long long n, Coeffs c) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    float wn, vn;
    combine(to_f(w[i]), to_f(v[i]), gs + i, n, c, &wn, &vn);
    wo[i] = from_f<TW>(wn);
    vo[i] = from_f<TV>(vn);
  }
}

// All fp32, 16-byte aligned, n % 4 == 0: n4 = n / 4 float4 groups.
__global__ void __launch_bounds__(kThreads)
fused_update_vec4(const float4* __restrict__ w, const float4* __restrict__ v,
                  const float4* __restrict__ gs, float4* __restrict__ wo,
                  float4* __restrict__ vo, long long n4, Coeffs c) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 w4 = w[i];
    const float4 v4 = v[i];
    float4 aw, av;
    aw.x = __fadd_rn(__fmul_rn(c.cww, w4.x), __fmul_rn(c.cwv, v4.x));
    aw.y = __fadd_rn(__fmul_rn(c.cww, w4.y), __fmul_rn(c.cwv, v4.y));
    aw.z = __fadd_rn(__fmul_rn(c.cww, w4.z), __fmul_rn(c.cwv, v4.z));
    aw.w = __fadd_rn(__fmul_rn(c.cww, w4.w), __fmul_rn(c.cwv, v4.w));
    av.x = __fadd_rn(__fmul_rn(c.cvw, w4.x), __fmul_rn(c.cvv, v4.x));
    av.y = __fadd_rn(__fmul_rn(c.cvw, w4.y), __fmul_rn(c.cvv, v4.y));
    av.z = __fadd_rn(__fmul_rn(c.cvw, w4.z), __fmul_rn(c.cvv, v4.z));
    av.w = __fadd_rn(__fmul_rn(c.cvw, w4.w), __fmul_rn(c.cvv, v4.w));
#pragma unroll
    for (int k = 0; k < kMaxGroups; ++k) {
      if (k >= c.g) break;
      const float4 g4 = gs[k * n4 + i];
      aw.x = __fadd_rn(aw.x, __fmul_rn(c.a[k], g4.x));
      aw.y = __fadd_rn(aw.y, __fmul_rn(c.a[k], g4.y));
      aw.z = __fadd_rn(aw.z, __fmul_rn(c.a[k], g4.z));
      aw.w = __fadd_rn(aw.w, __fmul_rn(c.a[k], g4.w));
      av.x = __fadd_rn(av.x, __fmul_rn(c.b[k], g4.x));
      av.y = __fadd_rn(av.y, __fmul_rn(c.b[k], g4.y));
      av.z = __fadd_rn(av.z, __fmul_rn(c.b[k], g4.z));
      av.w = __fadd_rn(av.w, __fmul_rn(c.b[k], g4.w));
    }
    wo[i] = aw;
    vo[i] = av;
  }
}

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);
}

template <typename TW, typename TV, typename TG>
cudaError_t launch_scalar(const void* w, const void* v, const void* gs, void* wo, void* vo,
                          long long n, const Coeffs& c, cudaStream_t s) {
  fused_update_scalar<TW, TV, TG><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const TW*>(w), static_cast<const TV*>(v), static_cast<const TG*>(gs),
      static_cast<TW*>(wo), static_cast<TV*>(vo), n, c);
  return cudaGetLastError();
}

template <typename TW, typename TV>
cudaError_t dispatch_g(int gdt, const void* w, const void* v, const void* gs, void* wo,
                       void* vo, long long n, const Coeffs& c, cudaStream_t s) {
  if (gdt == 0) return launch_scalar<TW, TV, float>(w, v, gs, wo, vo, n, c, s);
  if (gdt == 1) return launch_scalar<TW, TV, __nv_bfloat16>(w, v, gs, wo, vo, n, c, s);
  return cudaErrorInvalidValue;
}

template <typename TW>
cudaError_t dispatch_v(int vdt, int gdt, const void* w, const void* v, const void* gs,
                       void* wo, void* vo, long long n, const Coeffs& c, cudaStream_t s) {
  if (vdt == 0) return dispatch_g<TW, float>(gdt, w, v, gs, wo, vo, n, c, s);
  if (vdt == 1) return dispatch_g<TW, __nv_bfloat16>(gdt, w, v, gs, wo, vo, n, c, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0; }

}  // namespace

// w, v: n elements each; gstack: g * n; wo, vo: n (may not alias the inputs).
// coeffs: host array {cww, cwv, cvw, cvv, a[0..g-1], b[0..g-1]} of fp32.
// dtypes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int fused_update_launch(const void* w, const void* v, const void* gstack, void* wo,
                                   void* vo, const void* coeffs, int g, long long n, int wdt,
                                   int vdt, int gdt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g < 1 || g > kMaxGroups || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const float* cf = static_cast<const float*>(coeffs);
  Coeffs c;
  c.cww = cf[0];
  c.cwv = cf[1];
  c.cvw = cf[2];
  c.cvv = cf[3];
  for (int i = 0; i < kMaxGroups; ++i) {
    c.a[i] = i < g ? cf[4 + i] : 0.f;
    c.b[i] = i < g ? cf[4 + g + i] : 0.f;
  }
  c.g = g;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wdt == 0 && vdt == 0 && gdt == 0 && n % 4 == 0 && aligned16(w) && aligned16(v) &&
      aligned16(gstack) && aligned16(wo) && aligned16(vo)) {
    const long long n4 = n / 4;
    fused_update_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
        static_cast<const float4*>(w), static_cast<const float4*>(v),
        static_cast<const float4*>(gstack), static_cast<float4*>(wo), static_cast<float4*>(vo),
        n4, c);
    return static_cast<int>(cudaGetLastError());
  }
  if (wdt == 0) err = dispatch_v<float>(vdt, gdt, w, v, gstack, wo, vo, n, c, s);
  else if (wdt == 1) err = dispatch_v<__nv_bfloat16>(vdt, gdt, w, v, gstack, wo, vo, n, c, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
