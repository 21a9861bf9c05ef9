// Paged flash-decode for Hopper (sm_90a), split over the page walk
// (flash-decoding): one query token per batch row, attending over that
// row's K/V pages, which each block finds by reading the row's page table
// inside the kernel.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/
// paged_attention.py :: paged_attention_pallas (_kernel, _live_jmax, kv_map).
//
// What it computes (the JAX kernel's function): for each batch row b and
// kv head k, with the G = H / K query heads h = k * G + g of that kv head
// (K/V are never repeated):
//   jmax = min(pos // page, n_pages - 1), or n_pages - 1 once a ring row
//   has wrapped (pos >= W); stale positions of retired rows are clamped, so
//   no block reads past the table row. The live slots [0, (jmax+1)*page)
//   are the row's keys: slot t lies in page table[b, t / page] at offset
//   t % page. Scores s = (q . k) * scale in fp32, masked to -1e30 (linear:
//   slot <= pos; ring: the reference valid_mask), softmax with fp32
//   m / l / acc from m = -1e30, p rounded to the value type before the PV
//   product, l summed from the fp32 p; out = acc / max(l, 1e-30) in q's
//   type. -1e30 and not -inf: a fully masked run of keys met before any
//   valid one adds exp(0) = 1 terms, which a later weight exp(-1e30 - M)
//   wipes to exactly 0; -inf would give -inf - -inf = NaN. Slots past a
//   block's share (the end of a key tile) score -inf and add nothing.
//
// Bound on an H100: memory. Per (row, kv head) it reads the live K and V
// slots once (2 * live_tokens * hd * sizeof(T) bytes) and does 4 * G * hd
// flops per token, about G flops a byte in bf16, far below the card's ~295
// flops a byte: the least time is live K/V bytes / 3.35 TB/s (0.001 ms at
// the serving run's contexts, 0.005 ms with all 8 rows at a full table).
//
// What held the first design back: one block per (row, kv head) walked all
// of the row's pages in series, 32 blocks on 132 SMs at 8 slots x 4 kv
// heads, each page paying a chain of four barriers, 112 scalar dot products
// and a warp-serial softmax. Latency, not bytes, set its time.
//
// Design. The live keys are cut into key tiles of 16 slots, and the grid
// (B, K, S) gives each of S splits a contiguous share of a row's tiles
// (ceil(n_tiles / S) each, computed in the kernel from pos, so the host
// never reads pos); the wrapper picks S from B, K and the table's size so
// that a full table fills the card. Each block writes its partial
// (m, l, acc[G][hd]) in fp32 to a scratch tensor, and a second kernel
// (paged_combine_kernel, one block per (row, kv head, query head)) adds the
// row's partials in split order: weight exp(m_s - M), M the largest m_s, then
// out = sum(w * acc) / max(sum(w * l), 1e-30). The order is fixed, so a run
// gives the same bits every time; a split whose keys are all masked has
// m = -1e30 and weight exactly 0, because M is a real score (slot pos is
// always live).
//
// bf16 (dtype 1, what serving runs), on tensor cores: 4 warps a block, warp
// w taking tiles w, w + 4, ... of the block's share. K/V tiles come in
// through a 2-stage cp.async ring of 64 slots (one tile per warp; each
// slot's 256-byte row found through the table, zero-filled past the share),
// rows padded by 16 bytes so ldmatrix is conflict-free. S = Q K^T and
// O += P V run on mma.sync m16n8k16 bf16 -> fp32, the G query rows padded to
// the MMA's 16 with zeros; the softmax stays in registers (quad shuffles),
// and P, rounded to bf16, is the PV product's A fragment as it lies, as in
// the flash kernel (the PTX helpers of common/ptx.cuh). Masks are applied only on tiles that reach past pos or
// the share's end, and on every tile of a ring. The four warps' states are
// merged through shared memory (the ring's space, once drained) in warp
// order, the same combine as between splits.
//
// fp32 (dtype 0) keeps CUDA-core arithmetic, because its 1e-5 checks rule
// out TF32: one block of hd threads per (row, kv head, split) walks its
// share one tile at a time (double-buffered cp.async tiles; thread i scores
// the pair (g, t) = (i / 16, i % 16) over hd from shared memory, one warp
// per query row updates the softmax, thread d accumulates column d).
#include <math.h>

#include "../../common/ptx.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxG = 16;   // query heads per kv head: the MMA's 16 rows
constexpr int kKT = 16;     // slots per key tile
constexpr int kMaxSplits = 32;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

using namespace ptx;

// A row's live slots and this split's share of its key tiles, all from pos.
struct Share {
  int live;    // live slots [0, live): pages 0..jmax
  int t0, t1;  // this split's key tiles [t0, t1); empty when t0 >= t1
  int end;     // this split's last slot + 1: min(t1 * kKT, live)
  int per;     // tiles per split for this row
};

__device__ __forceinline__ Share share_of(int pos, int page, int n_pages, bool ring, int splits,
                                          int split) {
  int jmax = pos / page;
  if (ring && pos >= n_pages * page) jmax = n_pages - 1;
  jmax = min(jmax, n_pages - 1);
  Share s;
  s.live = (jmax + 1) * page;
  const int n_tiles = (s.live + kKT - 1) / kKT;
  s.per = max(1, (n_tiles + splits - 1) / splits);
  s.t0 = split * s.per;
  s.t1 = min(s.t0 + s.per, n_tiles);
  s.end = min(s.t1 * kKT, s.live);
  return s;
}

// Whether slot t may be attended at pos (the reference valid_mask).
__device__ __forceinline__ bool slot_ok(int t, int pos, int W, int window) {
  if (window < 0) return t <= pos;
  const int head = pos % W;
  const int start = pos - head;
  const int absp = t <= head ? start + t : start - W + t;
  return absp <= pos && absp >= 0 && absp > pos - window;
}

// Element offset of slot t's row (kv head kh) in a pool (P, page, K, hd).
template <int HD>
__device__ __forceinline__ size_t slot_offset(const int* trow, int t, int page, int K, int kh) {
  const int j = t / page;
  const int pid = __ldg(trow + j);
  return ((static_cast<size_t>(pid) * page + (t - j * page)) * K + kh) * HD;
}

// Partials: acc (B*K*S, G, hd) then (m, l) (B*K*S, G, 2), fp32.
struct Partials {
  float* acc;
  float* ml;
  __device__ __forceinline__ Partials(float* part, int n_blocks, int G, int hd)
      : acc(part), ml(part + static_cast<size_t>(n_blocks) * G * hd) {}
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kWarps * kKT;  // slots per ring stage, one tile per warp
constexpr int kStages = 2;
constexpr int kPad = 8;               // bf16 elements of padding per shared row (16 bytes)

template <int HD>
constexpr size_t ring_bytes() {
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kKT + 2 * kStages * kChunk) * (HD + kPad);
}
template <int HD>
constexpr size_t merge_bytes() {
  return sizeof(float) * static_cast<size_t>(kWarps) * kMaxG * (HD + 2);
}
template <int HD>
constexpr size_t smem_bytes() {
  return ring_bytes<HD>() > merge_bytes<HD>() ? ring_bytes<HD>() : merge_bytes<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_split_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                        const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
                        const int* __restrict__ pos_arr, float* __restrict__ part, int K, int G,
                        int page, int n_pages, int window, float scale) {
  constexpr int RS = HD + kPad;  // shared row stride, elements
  constexpr int CH = HD / 8;     // 16-byte chunks per row
  constexpr int KS = HD / 16;    // k-steps of Q K^T
  constexpr int NO = HD / 8;     // 8-column blocks of the output
  static_assert((kChunk * CH) % kThreads == 0, "copy shape");
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int pos = pos_arr[b];
  const bool ring = window >= 0;
  const int W = n_pages * page;
  const Share sh = share_of(pos, page, n_pages, ring, splits, split);
  if (sh.t0 >= sh.t1) return;  // the row is too short to reach this split

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kKT x RS
  __nv_bfloat16* Ks = Qs + kKT * RS;                               // kStages x kChunk x RS
  __nv_bfloat16* Vs = Ks + kStages * kChunk * RS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int H = K * G;
  const int* trow = table + static_cast<size_t>(b) * n_pages;

  auto load_kv = [&](int c, int stage) {  // ring stage <- slots of tiles t0 + 4c ...
    const int s0 = (sh.t0 + c * kWarps) * kKT;
    __nv_bfloat16* ks = Ks + stage * kChunk * RS;
    __nv_bfloat16* vs = Vs + stage * kChunk * RS;
#pragma unroll
    for (int i = 0; i < kChunk * CH / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / CH, ch = idx % CH;
      const int t = s0 + r;
      const bool in = t < sh.end;
      const size_t o = in ? slot_offset<HD>(trow, t, page, K, kh) + ch * 8 : 0;
      cp_async16(smem_u32(ks + r * RS + ch * 8), kp + o, in);
      cp_async16(smem_u32(vs + r * RS + ch * 8), vp + o, in);
    }
  };

  // q is (B, 1, H, hd): the G heads of kv head kh are contiguous rows;
  // rows G..15 of the MMA tile are zero
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * HD;
  for (int idx = tid; idx < kKT * CH; idx += kThreads) {
    const int r = idx / CH, ch = idx % CH;
    const bool in = r < G;
    cp_async16(smem_u32(Qs + r * RS + ch * 8), qb + (in ? r * HD + ch * 8 : 0), in);
  }
  const int n_chunks = (sh.t1 - sh.t0 + kWarps - 1) / kWarps;
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row's l

  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    if (c + 1 < n_chunks) load_kv(c + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(Qs + (lane & 15) * RS + kk * 16 + (lane >> 4) * 8));
    }
    const int tile = sh.t0 + c * kWarps + warp;
    if (tile < sh.t1) {
      const __nv_bfloat16* ks = Ks + (stage * kChunk + warp * kKT) * RS;
      const __nv_bfloat16* vs = Vs + (stage * kChunk + warp * kKT) * RS;

      // S = Q K^T: the 16 (padded) query rows x the tile's 16 slots
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_u32(ks + ((lane & 7) + ((lane >> 4) << 3)) * RS + kk * 16 +
                                 ((lane >> 3) & 1) * 8));
        mma_bf16(s[0], qf[kk], bf[0], bf[1]);
        mma_bf16(s[1], qf[kk], bf[2], bf[3]);
      }

      // scale, mask where the tile reaches past pos or the share's end
      // (every tile of a ring), online softmax in registers
      const int t_first = tile * kKT;
      const bool edge = ring || t_first + kKT - 1 > pos || t_first + kKT > sh.end;
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (edge) {
            const int t = t_first + n * 8 + 2 * tig + (e & 1);
            if (t >= sh.end)
              x = -INFINITY;  // past the share: adds nothing
            else if (!slot_ok(t, pos, W, window))
              x = kNegInf;
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
      for (int n = 0; n < 2; ++n) {
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
      const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_u32(vs + (lane & 15) * RS + np * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * np], a, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its space holds the warps' states

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  float* mo = reinterpret_cast<float*>(smem_raw);  // kWarps x kMaxG x HD
  float* mm = mo + kWarps * kMaxG * HD;            // kWarps x kMaxG
  float* ml = mm + kWarps * kMaxG;                 // kWarps x kMaxG
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row < G) {
      float* orow = mo + (warp * kMaxG + row) * HD;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * tig) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      if (tig == 0) {
        mm[warp * kMaxG + row] = m_r[r];
        ml[warp * kMaxG + row] = l_r[r];
      }
    }
  }
  __syncthreads();

  // the block's partial: the four warps' states merged in warp order, the
  // weights exp(m_w - M) taken once per row (they overwrite mm)
  const int blk = (b * K + kh) * splits + split;
  const Partials pt(part, gridDim.x * K * splits, G, HD);
  if (tid < G) {
    float M = mm[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, mm[w * kMaxG + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(mm[w * kMaxG + tid] - M);
      l += ml[w * kMaxG + tid] * wt;
      mm[w * kMaxG + tid] = wt;
    }
    pt.ml[(static_cast<size_t>(blk) * G + tid) * 2] = M;
    pt.ml[(static_cast<size_t>(blk) * G + tid) * 2 + 1] = l;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int row = i / HD, d = i - row * HD;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += mo[(w * kMaxG + row) * HD + d] * mm[w * kMaxG + row];
    pt.acc[(static_cast<size_t>(blk) * G + row) * HD + d] = acc;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

// Shared memory: 2 stages x {K, V} x kKT x HD, then q (G x HD), the scores
// (G x kKT), m / l / alpha. The wrapper computes the same.
template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (4 * static_cast<size_t>(kKT) * HD + kMaxG * HD + kMaxG * kKT + 3 * kMaxG);
}

template <int HD>
__global__ void __launch_bounds__(HD)
paged_split_f32_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                       const float* __restrict__ vp, const int* __restrict__ table,
                       const int* __restrict__ pos_arr, float* __restrict__ part, int K, int G,
                       int page, int n_pages, int window, float scale) {
  constexpr int kWarps = HD / 32;
  constexpr int kChunksPerRow = HD / 4;  // 16-byte copies per slot row
  constexpr int tile = kKT * HD;
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int pos = pos_arr[b];
  const bool ring = window >= 0;
  const int W = n_pages * page;
  const Share sh = share_of(pos, page, n_pages, ring, splits, split);
  if (sh.t0 >= sh.t1) return;

  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int H = K * G;
  const int* trow = table + static_cast<size_t>(b) * n_pages;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kv_s = reinterpret_cast<float*>(smem_raw);  // [stage][K|V][kKT][HD]
  float* q_s = kv_s + 4 * tile;                      // G x HD query rows
  float* s_s = q_s + kMaxG * HD;                     // G x kKT scores, then probabilities
  float* m_s = s_s + kMaxG * kKT;                    // running max per query row
  float* l_s = m_s + kMaxG;                          // running denominator
  float* a_s = l_s + kMaxG;                          // this tile's rescale factor

  auto issue = [&](int tl, int stage) {  // async copy of one key tile's K and V
    float* ks = kv_s + 2 * stage * tile;
    float* vs = ks + tile;
    for (int i = d; i < kKT * kChunksPerRow; i += HD) {
      const int r = i / kChunksPerRow;
      const int c = (i - r * kChunksPerRow) * 4;
      const int t = tl * kKT + r;
      const bool in = t < sh.end;
      const size_t off = in ? slot_offset<HD>(trow, t, page, K, kh) + c : 0;
      cp_async16(smem_u32(ks + r * HD + c), kp + off, in);
      cp_async16(smem_u32(vs + r * HD + c), vp + off, in);
    }
    cp_async_commit();
  };
  issue(sh.t0, 0);

  const float* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kh) * G) * HD;
  for (int g = 0; g < G; ++g) q_s[g * HD + d] = qb[g * HD + d];
  if (d < G) {
    m_s[d] = kNegInf;
    l_s[d] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  __syncthreads();  // q_s, m_s, l_s are visible

  for (int tl = sh.t0; tl < sh.t1; ++tl) {
    const int stage = (tl - sh.t0) & 1;
    if (tl + 1 < sh.t1) {
      issue(tl + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile tl is visible
    const float* ks = kv_s + 2 * stage * tile;
    const float* vs = ks + tile;

    for (int i = d; i < G * kKT; i += HD) {
      const int g = i / kKT;
      const int r = i - g * kKT;
      const float* krow = ks + r * HD;
      const float* qrow = q_s + g * HD;
      float part4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int cc = 0; cc < kChunksPerRow; ++cc) {
        const int c = ((cc + r) & (kChunksPerRow - 1)) * 4;  // bank skew
        const float4 kv = *reinterpret_cast<const float4*>(krow + c);
        part4[0] = fmaf(qrow[c], kv.x, part4[0]);
        part4[1] = fmaf(qrow[c + 1], kv.y, part4[1]);
        part4[2] = fmaf(qrow[c + 2], kv.z, part4[2]);
        part4[3] = fmaf(qrow[c + 3], kv.w, part4[3]);
      }
      const float dot = (part4[0] + part4[1]) + (part4[2] + part4[3]);
      const int t = tl * kKT + r;
      float x = dot * scale;
      if (t >= sh.end)
        x = -INFINITY;
      else if (!slot_ok(t, pos, W, window))
        x = kNegInf;
      s_s[g * kKT + r] = x;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {  // online softmax, one warp per row
      float* srow = s_s + g * kKT;
      const float m_prev = m_s[g];
      const float x = lane < kKT ? srow[lane] : -INFINITY;
      float m_new = fmaxf(m_prev, x);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, o));
      const float alpha = expf(m_prev - m_new);
      const float p = lane < kKT ? expf(x - m_new) : 0.f;
      if (lane < kKT) srow[lane] = p;
      float psum = p;
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
    for (int r = 0; r < kKT; ++r) {
      const float v = vs[r * HD + d];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) pv[g] = fmaf(s_s[g * kKT + r], v, pv[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] = acc[g] * a_s[g] + pv[g];
    __syncthreads();  // this stage, s_s and a_s are rewritten from here on
  }

  const int blk = (b * K + kh) * splits + split;
  const Partials pt(part, gridDim.x * K * splits, G, HD);
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) pt.acc[(static_cast<size_t>(blk) * G + g) * HD + d] = acc[g];
  if (d < G) {
    pt.ml[(static_cast<size_t>(blk) * G + d) * 2] = m_s[d];
    pt.ml[(static_cast<size_t>(blk) * G + d) * 2 + 1] = l_s[d];
  }
}

// ---------------------------------------------------------------------------
// the combine: a row's partials in split order
// ---------------------------------------------------------------------------

// One block per (row, kv head, query head) and one thread per column: the
// row's m and l of each split are read once into shared memory, thread 0
// turns them into the weights exp(m_s - M) and the denominator, summed in
// split order, and each thread adds its column of the splits' acc in split
// order, eight loads in flight at a time.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
paged_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos_arr,
                     T* __restrict__ out, int K, int G, int page, int n_pages, int window,
                     int splits) {
  const int b = blockIdx.x, kh = blockIdx.y, g = blockIdx.z, d = threadIdx.x;
  __shared__ float m_s[kMaxSplits], l_s[kMaxSplits];
  __shared__ float den_s;
  const Share sh = share_of(pos_arr[b], page, n_pages, window >= 0, splits, 0);
  const int n_tiles = (sh.live + kKT - 1) / kKT;
  const int used = (n_tiles + sh.per - 1) / sh.per;  // splits that hold tiles
  const Partials pt(const_cast<float*>(part), gridDim.x * K * splits, G, HD);
  const size_t r0 = static_cast<size_t>(b * K + kh) * splits * G + g;  // split s: r0 + s * G
  if (d < used) {
    m_s[d] = pt.ml[(r0 + static_cast<size_t>(d) * G) * 2];
    l_s[d] = pt.ml[(r0 + static_cast<size_t>(d) * G) * 2 + 1];
  }
  __syncthreads();
  if (d == 0) {
    float M = kNegInf;
    for (int s = 0; s < used; ++s) M = fmaxf(M, m_s[s]);
    float l = 0.f;
    for (int s = 0; s < used; ++s) {
      m_s[s] = expf(m_s[s] - M);
      l += l_s[s] * m_s[s];
    }
    den_s = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  float acc = 0.f;
  for (int s0 = 0; s0 < used; s0 += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = s0 + i < used ? pt.acc[(r0 + static_cast<size_t>(s0 + i) * G) * HD + d] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (s0 + i < used) acc += v[i] * m_s[s0 + i];
  }
  out[(static_cast<size_t>(b) * K * G + static_cast<size_t>(kh) * G + g) * HD + d] =
      from_f<T>(acc / den_s);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* table,
                   const void* pos, void* out, void* part, int B, int K, int G, int page,
                   int n_pages, int window, int splits, float scale, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const dim3 grid(B, K, splits);
  cudaError_t err;
  if constexpr (kBf16) {
    // 16-byte cp.async copies need aligned pools and q
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kp) |
         reinterpret_cast<uintptr_t>(vp)) & 15)
      return cudaErrorMisalignedAddress;
    constexpr size_t smem = tc::smem_bytes<HD>();
    // Set on every launch: the attribute is per device, and the call is cheap.
    err = cudaFuncSetAttribute(tc::paged_split_bf16_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    tc::paged_split_bf16_kernel<HD><<<grid, tc::kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
        static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(table),
        static_cast<const int*>(pos), static_cast<float*>(part), K, G, page, n_pages, window,
        scale);
  } else {
    if ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) & 15)
      return cudaErrorMisalignedAddress;
    constexpr size_t smem = f32_smem_bytes<HD>();
    paged_split_f32_kernel<HD><<<grid, HD, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kp),
        static_cast<const float*>(vp), static_cast<const int*>(table),
        static_cast<const int*>(pos), static_cast<float*>(part), K, G, page, n_pages, window,
        scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T, HD><<<dim3(B, K, G), HD, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(pos), static_cast<T*>(out), K, G,
      page, n_pages, window, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kp, const void* vp,
                        const void* table, const void* pos, void* out, void* part, int B, int K,
                        int G, int page, int n_pages, int window, int splits, float scale,
                        cudaStream_t stream) {
  switch (hd) {
#define PA_CASE(HD)                                                                           \
  case HD:                                                                                    \
    return launch<T, HD>(q, kp, vp, table, pos, out, part, B, K, G, page, n_pages, window,    \
                         splits, scale, stream);
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
#undef PA_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window < 0 means a linear (non-ring)
// cache. part: B * K * splits * G * (hd + 2) fp32 of scratch for the
// splits' partials. Launches the split kernel, then the combine; returns
// cudaGetLastError() after them.
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* pos, void* out, void* part,
                                      int B, int K, int G, int hd, int page, int n_pages,
                                      int window, int splits, float scale, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G < 1 || G > kMaxG || splits < 1 || splits > kMaxSplits || page < 1 || n_pages < 1 ||
      B < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_hd<float>(hd, q, k_pages, v_pages, table, pos, out, part, B, K, G, page,
                             n_pages, window, splits, scale, s);
  else if (dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, table, pos, out, part, B, K, G,
                                     page, n_pages, window, splits, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
