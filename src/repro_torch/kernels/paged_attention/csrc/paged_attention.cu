// Paged flash-decode for Hopper (sm_90a): one query token per batch row,
// attending over that row's K/V pages, which it finds by walking its
// page-table row inside the kernel.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py :: paged_attention_pallas (_kernel, _live_jmax, kv_map).
//
// What it computes (the JAX kernel's recurrence, kept exactly):
//   for each batch row b and kv head k, with the G = H / K query heads
//   h = k * G + g of that kv head (K/V are never repeated):
//     jmax = min(pos // page, n_pages - 1), or n_pages - 1 once a ring
//     row has wrapped (pos >= W); stale positions of retired rows are
//     clamped, so the walk never reads past the table row.
//     for j in 0..jmax: the page table[b, j], scores s = (q . k) * scale in
//     fp32, masked to -1e30 (linear: slot <= pos; ring: the reference
//     valid_mask), online softmax from m = -1e30 with fp32 m / l / acc,
//     p rounded to the value type before the PV product, fp32 sums.
//   out = acc / max(l, 1e-30), in q's type.
//   -1e30 and not -inf: a fully masked page met before any valid one adds
//   exp(0) = 1 terms, which the next valid page's alpha = exp(-1e30 - m)
//   wipes to exactly 0; -inf would give -inf - -inf = NaN.
//
// Bound on an H100: memory. Per (row, kv head) it reads the live K and V
// pages once (2 * live_tokens * hd * sizeof(T) bytes) and does 4 * G * hd
// flops per token, about G flops a byte in bf16, far below the card's
// ~295 flops a byte: the least time is live K/V bytes / 3.35 TB/s.
//
// Design, simple first: one block per (b, kv head), hd threads. The block
// copies its table row into shared memory, then each live page's K and V
// tiles with cp.async, double buffered: the copy of page j+1 is in flight
// while page j is computed, so the walk pays the memory latency about
// once. Scores: thread i takes the pair (g, t) = (i / page, i % page) and
// runs the whole hd-long dot product from shared memory, 16 bytes at a
// time, in a chunk order skewed by t so that neighbouring rows sit in
// different banks (no cross-lane reductions on the critical path). One
// warp per query row runs the online-softmax update; thread d accumulates
// column d of all G outputs. Known limit: B * K blocks (32 at 8 slots x 4
// kv heads) on 132 SMs leave most of the card idle; a split over pages
// (flash-decoding) with a second reduction pass, TMA and wgmma come later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxG = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Shared memory: 2 stages x {K, V} x page x HD of T, then fp32 q / scores /
// m / l / alpha, then the int32 table row. The wrapper computes the same.
template <typename T, int HD>
size_t smem_bytes(int G, int page, int n_pages) {
  return sizeof(T) * 4 * static_cast<size_t>(page) * HD +
         sizeof(float) * (static_cast<size_t>(G) * HD + static_cast<size_t>(G) * page + 3 * kMaxG) +
         sizeof(int) * static_cast<size_t>(n_pages);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ table,
                    const int* __restrict__ pos_arr, T* __restrict__ out,
                    int K, int G, int page, int n_pages, int window, float scale) {
  constexpr int kWarps = HD / 32;
  constexpr int kChunk = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr int kChunksPerRow = HD / kChunk;
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int H = K * G;
  const int tile = page * HD;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);     // [stage][K|V][page][HD]
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * tile);  // G x HD query rows
  float* s_s = q_s + G * HD;                    // G x page scores, then probabilities
  float* m_s = s_s + G * page;                  // running max per query row
  float* l_s = m_s + kMaxG;                     // running denominator
  float* a_s = l_s + kMaxG;                     // this page's rescale factor
  int* tbl_s = reinterpret_cast<int*>(a_s + kMaxG);  // the live table row

  const int pos = pos_arr[b];
  const int W = n_pages * page;
  const bool ring = window >= 0;
  int jmax = pos / page;
  if (ring && pos >= W) jmax = n_pages - 1;
  jmax = min(jmax, n_pages - 1);
  const int* trow = table + static_cast<size_t>(b) * n_pages;
  const size_t row_stride = static_cast<size_t>(K) * HD;  // pool (P, page, K, hd)

  auto issue = [&](int pid, int stage) {  // async copy of one page's K and V
    const size_t base = (static_cast<size_t>(pid) * page * K + kh) * HD;
    T* ks = kv_s + 2 * stage * tile;
    T* vs = ks + tile;
    for (int i = d; i < page * kChunksPerRow; i += HD) {
      const int t = i / kChunksPerRow;
      const int c = (i - t * kChunksPerRow) * kChunk;
      const size_t off = base + t * row_stride + c;
      cp_async16(ks + t * HD + c, k_pages + off);
      cp_async16(vs + t * HD + c, v_pages + off);
    }
    cp_async_commit();
  };
  issue(trow[0], 0);
  for (int j = d; j <= jmax; j += HD) tbl_s[j] = trow[j];

  // q is (B, 1, H, hd): the G heads of kv head kh are contiguous rows
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * HD;
  for (int g = 0; g < G; ++g) q_s[g * HD + d] = to_f(qb[g * HD + d]);
  if (d < G) {
    m_s[d] = kNegInf;
    l_s[d] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  __syncthreads();  // tbl_s, q_s, m_s, l_s are visible

  for (int j = 0; j <= jmax; ++j) {
    const int stage = j & 1;
    if (j < jmax) {
      issue(tbl_s[j + 1], stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // page j's tiles are visible
    const T* ks = kv_s + 2 * stage * tile;
    const T* vs = ks + tile;

    for (int i = d; i < G * page; i += HD) {
      const int g = i / page;
      const int t = i - g * page;
      const T* krow = ks + t * HD;
      const float* qrow = q_s + g * HD;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int cc = 0; cc < kChunksPerRow; ++cc) {
        const int c = ((cc + t) & (kChunksPerRow - 1)) * kChunk;  // bank skew
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) part[e & 3] = fmaf(qrow[c + e], to_f(kv[e]), part[e & 3]);
      }
      const float dot = (part[0] + part[1]) + (part[2] + part[3]);
      const int slot = j * page + t;
      bool ok;
      if (!ring) {
        ok = slot <= pos;
      } else {  // the reference valid_mask, one slot at a time
        const int head = pos % W;
        const int start = pos - head;
        const int absp = slot <= head ? start + slot : start - W + slot;
        ok = absp <= pos && absp >= 0 && absp > pos - window;
      }
      s_s[g * page + t] = ok ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {  // online softmax, one warp per row
      float* srow = s_s + g * page;
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = lane; t < page; t += 32) m_new = fmaxf(m_new, srow[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, o));
      const float alpha = expf(m_prev - m_new);
      float psum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(srow[t] - m_new);
        psum += p;
        srow[t] = to_f(from_f<T>(p));  // p in the value type for the PV product
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    float pv[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) pv[g] = 0.f;
#pragma unroll 4
    for (int t = 0; t < page; ++t) {
      const float v = to_f(vs[t * HD + d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) pv[g] = fmaf(s_s[g * page + t], v, pv[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] = acc[g] * a_s[g] + pv[g];
    __syncthreads();  // this stage, s_s and a_s are rewritten from here on
  }

  T* ob = out + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * HD;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) ob[g * HD + d] = from_f<T>(acc[g] / fmaxf(l_s[g], 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* table,
                   const void* pos, void* out, int B, int K, int G, int page,
                   int n_pages, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, HD>(G, page, n_pages);
  paged_decode_kernel<T, HD><<<dim3(B, K), HD, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(table), static_cast<const int*>(pos), static_cast<T*>(out),
      K, G, page, n_pages, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const void* table, const void* pos, void* out, int B, int K,
                        int G, int page, int n_pages, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, kp, vp, table, pos, out, B, K, G, page, n_pages, window, scale, stream);
    case 64: return launch<T, 64>(q, kp, vp, table, pos, out, B, K, G, page, n_pages, window, scale, stream);
    case 128: return launch<T, 128>(q, kp, vp, table, pos, out, B, K, G, page, n_pages, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window < 0 means a linear (non-ring) cache.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* pos, void* out,
                                      int B, int K, int G, int hd, int page, int n_pages,
                                      int window, float scale, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G < 1 || G > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k_pages, v_pages, table, pos, out, B, K, G, page, n_pages, window, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, table, pos, out, B, K, G, page, n_pages, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
