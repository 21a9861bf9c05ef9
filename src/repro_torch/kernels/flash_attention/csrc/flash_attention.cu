// Forward flash attention for Hopper (sm_90a): causal and/or sliding
// window, grouped-query heads without repeating K/V, per-row query offsets.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py :: flash_attention_pallas (_kernel).
//
// What it computes (the JAX kernel's recurrence, kept exactly): for each
// batch row b and query head h, query i at absolute position
// off[b] + i attends to keys j with j <= qpos (causal) and j > qpos - window
// (window); scores (q . k) * scale in fp32, masked to -1e30, online softmax
// from m = -1e30 with fp32 m / l / acc, p rounded to the value type before
// the PV product, out = acc / max(l, 1e-30) in q's type. The kv head of
// query head h is h / G (G = H / K), i.e. kv row b*K + h/G = bh / G.
// Layouts are the JAX wrapper's public ones, read in place through strides:
// q / out (B, Sq, H, hd), k / v (B, Sk, K, hd).
//
// Differences from the TPU tiling, none of which changes a result:
//  - fixed tiles (64 queries x 32 keys) instead of a divisor search; keys
//    past Sk (the ragged edge) score -inf, so they add exactly 0 and never
//    move the running max; query rows past Sq are computed and not stored;
//  - a KV tile that lies wholly beyond the causal edge of every query in
//    the block is skipped: every such row has already met its own key,
//    so those keys would have added exp(-1e30 - m) = 0.
//
// Bound on an H100: operations. 4 * hd flops per unmasked (query, key)
// pair against (Sq + 2 Sk) * hd * sizeof(T) bytes per head; at Sq = Sk =
// 512 that is ~170 flops a byte at bf16 before causal skipping and grows
// with Sq, so the least time is flops / 989 TFLOP/s (bf16 tensor cores).
//
// Design, simple first: CUDA-core fp32 FMAs with register tiles, no tensor
// cores. One block of 128 threads per (b*H + h, 64-query tile); the Q tile
// stays in shared memory (fp32, padded rows against bank conflicts), K and
// V tiles of 32 keys are staged through it, each thread computes a 4 x 4
// score tile and owns a 4 x hd/8 tile of the output accumulator. This runs
// far below the bound; wgmma on bf16 tiles fed by TMA comes later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (HD + 1) + kBK * (HD + 1) +
                          kBK * HD + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_offsets,
                 T* __restrict__ out, int H, int K, int Sq, int Sk, int causal,
                 int window, float scale) {
  constexpr int QS = HD + 1;     // padded fp32 row stride of the Q and K tiles
  constexpr int SS = kBK + 1;    // padded row stride of the score tile
  constexpr int CPT = HD / 8;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // kBQ x QS
  float* Ks = Qs + kBQ * QS;     // kBK x QS
  float* Vs = Ks + kBK * QS;     // kBK x HD
  float* Ss = Vs + kBK * HD;     // kBQ x SS scores, then probabilities
  float* m_s = Ss + kBQ * SS;    // running max per query row
  float* l_s = m_s + kBQ;        // running denominator
  float* a_s = l_s + kBQ;        // this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;     // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / K);
  const int q0 = blockIdx.x * kBQ;
  const int off = q_offsets != nullptr ? q_offsets[b] : 0;

  const size_t q_stride = static_cast<size_t>(H) * HD;   // between positions
  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Sk * K + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Sk * K + kvh) * HD;
  T* ob = out + (static_cast<size_t>(b) * Sq * H + h) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i - (i / HD) * HD;
    Qs[r * QS + c] = q0 + r < Sq ? to_f(qb[(q0 + r) * q_stride + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int tx = tid % 8;        // score cols tx + 8c, output cols tx + 8c
  const int ty = tid / 8;        // rows 4 ty .. 4 ty + 3
  float acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  int kend = Sk;
  if (causal) kend = min(Sk, off + min(q0 + kBQ, Sq));  // last query pos + 1
  const int n_kv = (kend + kBK - 1) / kBK;
  __syncthreads();

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, c = i - (i / HD) * HD;
      const bool in = k0 + r < Sk;
      Ks[r * QS + c] = in ? to_f(kb[(k0 + r) * kv_stride + c]) : 0.f;
      Vs[r * HD + c] = in ? to_f(vb[(k0 + r) * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty * 4 + r) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 8 * c) * QS + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty * 4 + r;
      const int qpos = off + q0 + row;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 8 * c;
        const int kpos = k0 + col;
        float val = s[r][c] * scale;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window >= 0) ok = ok && kpos > qpos - window;
        if (!ok) val = kNegInf;
        if (kpos >= Sk) val = -INFINITY;  // ragged edge: contributes nothing
        Ss[row * SS + col] = val;
      }
    }
    __syncthreads();

    if (tid < kBQ) {  // online softmax update of query row tid
      float* srow = Ss + tid * SS;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int j = 0; j < kBK; ++j) m_new = fmaxf(m_new, srow[j]);
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = expf(srow[j] - m_new);
        psum += p;
        srow[j] = to_f(from_f<T>(p));  // p in the value type for the PV product
      }
      l_s[tid] = l_s[tid] * alpha + psum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float al = a_s[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] *= al;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4], vv[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ss[(ty * 4 + r) * SS + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[j * HD + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
    __syncthreads();  // the next tile overwrites Ks, Vs, Ss
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    if (q0 + row >= Sq) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
    T* orow = ob + (q0 + row) * q_stride;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 8 * c] = from_f<T>(acc[r][c] / l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* offs,
                   void* out, int B, int H, int K, int Sq, int Sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(offs), static_cast<T*>(out), H, K, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* offs, void* out, int B, int H, int K, int Sq,
                        int Sk, int causal, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, offs, out, B, H, K, Sq, Sk, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, offs, out, B, H, K, Sq, Sk, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, offs, out, B, H, K, Sq, Sk, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window < 0 means no window. q_offsets
// may be null (all rows start at position 0). Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_offsets, void* out, int B, int H,
                                      int K, int Sq, int Sk, int hd, int causal,
                                      int window, float scale, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, q_offsets, out, B, H, K, Sq, Sk, causal, window, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, q_offsets, out, B, H, K, Sq, Sk, causal, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
