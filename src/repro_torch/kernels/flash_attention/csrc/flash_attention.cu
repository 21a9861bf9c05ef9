// Forward flash attention for Hopper (sm_90a): causal and/or sliding
// window, grouped-query heads without repeating K/V, per-row query offsets.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py :: flash_attention_pallas (_kernel).
//
// What it computes (the JAX kernel's recurrence, kept exactly): for each
// batch row b and query head h, query i at absolute position
// off[b] + i attends to keys j with j <= qpos (causal) and j > qpos - window
// (window); scores (q . k) * scale in fp32, masked to -1e30, keys past Sk
// to -inf; online softmax from m = -1e30 with fp32 m / l / acc, l summed
// from the fp32 p, p rounded to the value type only for the PV product,
// out = acc / max(l, 1e-30) in q's type. The kv head of query head h is
// h / G (G = H / K), i.e. kv row b*K + h/G = bh / G. Layouts are the JAX
// wrapper's public ones, read in place through strides: q / out
// (B, Sq, H, hd), k / v (B, Sk, K, hd).
//
// Bound on an H100: 4 * hd flops per unmasked (query, key) pair against
// (2 Sq H + 2 Sk K) * hd * 2 bytes in bf16. At the serving path's shapes
// (B=8, H=28, K=4, hd=128, causal) that is bytes / 3.35 TB/s at
// Sq = Sk = 256 (0.010 ms) and flops / 989 TFLOP/s (bf16 tensor cores) at
// 1024 (0.061 ms).
//
// Two kernels behind one entry point, chosen by dtype:
//
// bf16 (dtype 1, what serving runs), on tensor cores. One block of 4 warps
// per (b*H + h, 64-query tile), each warp owning 16 query rows; the
// heaviest causal tiles are launched first. The Q tile is copied once into
// shared memory and kept in registers as mma fragments. K/V tiles of 64
// keys go through a 2-stage cp.async ring (16-byte copies, zero-filled past
// Sk) whose rows are padded by 16 bytes, so the 8 row addresses of every
// ldmatrix fall in distinct banks (~85 KB of dynamic shared memory at
// hd=128, 165 KB at hd=256). S = Q K^T runs on mma.sync m16n8k16 bf16 -> fp32 with K through
// ldmatrix; the online softmax stays in registers (each row's max and sum
// over the 4 threads of a quad by __shfl_xor_sync, no shared-memory score
// tile, no barrier inside it); P is rounded to bf16 in registers and is the
// A fragment of the PV mma directly, with V through ldmatrix.trans. Tiles
// wholly past every row's causal edge or wholly before every row's window
// start are skipped (their keys would add exp(-1e30 - m) = 0 once the row
// has met a live key; a block whose window can miss every key skips
// nothing, so degenerate rows keep the reference's uniform average); masks
// are applied only on tiles that straddle an edge or Sk.
//
// fp32 (dtype 0) stays on CUDA cores: the checks hold it to 1e-5 (and the
// port's fp32 slice parity to 1e-4), which TF32 tensor cores cannot meet.
// One block of 128 threads per (b*H + h, 64-query tile); the Q tile stays
// in shared memory, K and V tiles of 32 keys are staged through it, each
// thread computes a 4 x 4 score tile and owns a 4 x hd/8 tile of the
// output; only a KV tile wholly beyond every row's causal edge is skipped.
#include <math.h>

#include "../../common/ptx.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (HD + 1) + kBK * (HD + 1) +
                          kBK * HD + kBQ * (kBK + 1) + 3 * kBQ);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ q_offsets,
                     float* __restrict__ out, int H, int K, int Sq, int Sk, int causal,
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
  const float* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const float* kb = k + (static_cast<size_t>(b) * Sk * K + kvh) * HD;
  const float* vb = v + (static_cast<size_t>(b) * Sk * K + kvh) * HD;
  float* ob = out + (static_cast<size_t>(b) * Sq * H + h) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i - (i / HD) * HD;
    Qs[r * QS + c] = q0 + r < Sq ? qb[(q0 + r) * q_stride + c] : 0.f;
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
      Ks[r * QS + c] = in ? kb[(k0 + r) * kv_stride + c] : 0.f;
      Vs[r * HD + c] = in ? vb[(k0 + r) * kv_stride + c] : 0.f;
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
        srow[j] = p;
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
    float* orow = ob + (q0 + row) * q_stride;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 8 * c] = acc[r][c] / l;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async ring, softmax in registers
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 64;        // query rows per block, 16 per warp
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kStages = 2;     // K/V ring depth
constexpr int kPad = 8;        // bf16 elements of padding per shared row (16 bytes)

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kBQ + 2 * kStages * kBK) * (HD + kPad);
}

using namespace ptx;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_offsets,
                      __nv_bfloat16* __restrict__ out, int H, int K, int Sq, int Sk, int causal,
                      int window, float scale) {
  constexpr int RS = HD + kPad;  // shared row stride, elements
  constexpr int CH = HD / 8;     // 16-byte chunks per row
  constexpr int KS = HD / 16;    // k-steps of Q K^T
  constexpr int NO = HD / 8;     // 8-column blocks of the output
  constexpr int NS = kBK / 8;    // 8-key blocks of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kBQ x RS
  __nv_bfloat16* Ks = Qs + kBQ * RS;                               // kStages x kBK x RS
  __nv_bfloat16* Vs = Ks + kStages * kBK * RS;                     // kStages x kBK x RS

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment row group, thread in group
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const int off = q_offsets != nullptr ? q_offsets[b] : 0;

  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(K) * HD;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * Sk * K + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * Sk * K + kvh) * HD;
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * Sq * H + h) * HD;

  // Key tiles [t_begin, t_end): the causal edge of the last stored row
  // bounds them above; the window start of the first row bounds them below,
  // unless some stored row's window holds no key at all.
  const int pmin = off + q0;
  const int pmax = off + min(q0 + kBQ, Sq) - 1;
  const int kend = causal ? min(Sk, pmax + 1) : Sk;
  const int kbeg = (window >= 1 && pmax - window + 1 <= Sk - 1) ? max(0, pmin - window + 1) : 0;
  const int t_begin = kbeg / kBK;
  const int t_end = (kend + kBK - 1) / kBK;
  const int n_tiles = t_end - t_begin;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    __nv_bfloat16* ks = Ks + stage * kBK * RS;
    __nv_bfloat16* vs = Vs + stage * kBK * RS;
#pragma unroll
    for (int i = 0; i < kBK * CH / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / CH, ch = c % CH;
      const bool in = k0 + r < Sk;
      const size_t o = in ? (k0 + r) * kv_stride + ch * 8 : 0;
      cp_async16(smem_u32(ks + r * RS + ch * 8), kb + o, in);
      cp_async16(smem_u32(vs + r * RS + ch * 8), vb + o, in);
    }
  };

#pragma unroll
  for (int i = 0; i < kBQ * CH / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / CH, ch = c % CH;
    const bool in = q0 + r < Sq;
    const size_t o = in ? (q0 + r) * q_stride + ch * 8 : 0;
    cp_async16(smem_u32(Qs + r * RS + ch * 8), qb + o, in);
  }
  if (n_tiles > 0) load_kv(t_begin, 0);
  cp_async_commit();

  const int row0 = warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const int qpos0 = pmin + row0;
  const int qpos1 = qpos0 + 8;
  // Up to hd 128 the Q fragments stay in registers for the whole block. At
  // hd 256 they would take 64 registers beside the 128 of the output
  // accumulators, so each k-step reads its fragment again from the Q tile,
  // which stays in shared memory anyway.
  constexpr bool kQRegs = HD <= 128;
  uint32_t qf[kQRegs ? KS : 1][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row's l

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(t_begin + it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kQRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(Qs + (warp * 16 + (lane & 15)) * RS + kk * 16 +
                                     (lane >> 4) * 8));
    }
    const __nv_bfloat16* ks = Ks + stage * kBK * RS;
    const __nv_bfloat16* vs = Vs + stage * kBK * RS;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, smem_u32(Qs + (warp * 16 + (lane & 15)) * RS + kk * 16 +
                                 (lane >> 4) * 8));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qa, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
      }
    }

    // scale, mask on edge tiles, online softmax in registers
    const int k0 = (t_begin + it) * kBK;
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > pmin) ||
                      (window >= 0 && k0 < pmax - window + 1);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = true;
          if (causal) ok = kpos <= qpos;
          if (window >= 0) ok = ok && kpos > qpos - window;
          if (!ok) x = kNegInf;
          if (kpos >= Sk) x = -INFINITY;  // ragged edge: contributes nothing
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        ps[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ps[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P in bf16 is the A fragment as it lies in registers
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(vs + (kk * 16 + (lane & 15)) * RS + np * 16 +
                                       (lane >> 4) * 8));
        mma_bf16(o[2 * np], a, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float d0 = fmaxf(l_r[0], 1e-30f);
  const float d1 = fmaxf(l_r[1], 1e-30f);
  const int r0 = q0 + row0;
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * tig;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_stride + col) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * q_stride + col) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
}

}  // namespace tc

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* offs, void* out,
                       int B, int H, int K, int Sq, int Sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_fwd_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(offs), static_cast<float*>(out), H, K, Sq, Sk, causal, window,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* offs, void* out,
                        int B, int H, int K, int Sq, int Sk, int causal, int window, float scale,
                        cudaStream_t stream) {
  // 16-byte cp.async and bf16x2 stores need aligned base pointers
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  constexpr size_t smem = tc::smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(tc::flash_fwd_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + tc::kBQ - 1) / tc::kBQ, B * H);
  tc::flash_fwd_bf16_kernel<HD><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(offs),
      static_cast<__nv_bfloat16*>(out), H, K, Sq, Sk, causal, window, scale);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* offs,
                        void* out, int B, int H, int K, int Sq, int Sk, int causal, int window,
                        float scale, cudaStream_t s) {
  switch (hd) {
#define FA_CASE(HD)                                                                       \
  case HD:                                                                                \
    return BF16 ? launch_bf16<HD>(q, k, v, offs, out, B, H, K, Sq, Sk, causal, window,    \
                                  scale, s)                                               \
                : launch_f32<HD>(q, k, v, offs, out, B, H, K, Sq, Sk, causal, window,     \
                                 scale, s);
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
#undef FA_CASE
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
    err = dispatch_hd<false>(hd, q, k, v, q_offsets, out, B, H, K, Sq, Sk, causal, window, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<true>(hd, q, k, v, q_offsets, out, B, H, K, Sq, Sk, causal, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
