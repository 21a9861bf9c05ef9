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
// h / G (G = H / K). Layouts are the JAX wrapper's public ones, read in
// place: q / out (B, Sq, H, hd), k / v (B, Sk, K, hd).
//
// Bound on an H100: 4 * hd flops per unmasked (query, key) pair against
// (2 Sq H + 2 Sk K) * hd * 2 bytes in bf16. At the serving path's shapes
// (B=8, H=28, K=4, hd=128, causal) that is bytes / 3.35 TB/s at
// Sq = Sk = 256 (0.010 ms) and flops / 989 TFLOP/s (bf16 tensor cores) at
// 1024 (0.061 ms): the products must run on wgmma, the only way to the
// card's full bf16 rate, and the K/V stream must never wait on the
// threads that compute.
//
// Two kernels behind one entry point, chosen by dtype:
//
// bf16 (dtype 1, what serving runs): wgmma fed by TMA. One block per
// (b*H + h, 128-query tile), the heaviest causal tiles launched first: two
// warpgroups of 64 query rows. One thread copies the Q tile once by TMA and
// fills a ring of key tiles (128 keys, or 64 at hd 256; 3 stages, 2 at hd
// 256), K and V each with a "full" mbarrier that the TMA bytes complete.
// The tensor maps are 4-D over (hd, heads, positions, batch), so a tile of
// keys past Sk is zero-filled by the hardware and never reads the next
// batch row. Boxes are 64 bf16 wide (128-byte swizzle; hd 32 is 32 wide
// with the 64-byte swizzle), hd 128 and 256 taking two and four of them
// side by side. A stage is refilled by whichever warp is the last of the
// block's eight to finish reading it (a count in shared memory): K as soon
// as its scores are computed, V after its P V, and no thread ever waits
// for another to free a stage. S = Q K^T is wgmma m64nBKk16 with both
// operands K-major in shared memory; the online softmax runs in registers
// on the accumulator fragments (each row's max and sum over the 4 threads
// of a quad) in log2 units: exp(x - m) is one ex2.approx, and on a tile no
// mask touches, the scale is fused into the exponent's multiply-add; P is
// rounded to bf16 in registers and is wgmma's register A operand of O += P V, with V read
// MN-major from shared memory. Each tile's Q K^T is issued together with
// the previous tile's P V, and its softmax runs while that P V is still on
// the tensor cores; the two warpgroups take turns at issuing (two named
// barriers), so one's softmax also runs under the other's products. That
// overlap keeps the scores, P and O in registers at once (O alone is 128
// fp32 a thread at hd 256, which is why its tile of keys is 64). A block of
// 8 warps puts two on each of the SM's four register files, so ptxas may
// give a thread up to 255 registers; a producer warp or warpgroup beside
// them would make it 168 (three warps on a register file), and ptxas kept
// to 168 even where setmaxnreg raised the consumers' share, serializing the
// wgmma ops. Tiles wholly past every row's causal edge or wholly before
// every row's window start are skipped (their keys would add
// exp(-1e30 - m) = 0 once the row has met a live key; a block whose window
// can miss every key skips nothing, so degenerate rows keep the
// reference's uniform average); masks are applied only on tiles that
// straddle an edge or Sk.
//
// fp32 (dtype 0) stays on CUDA cores: the checks hold it to 1e-5 (and the
// port's fp32 slice parity to 1e-4), which TF32 tensor cores cannot meet.
// One block of 128 threads per (b*H + h, 64-query tile); the Q tile stays
// in shared memory, K and V tiles of 32 keys are staged through it, each
// thread computes a 4 x 4 score tile and owns a 4 x hd/8 tile of the
// output; only a KV tile wholly beyond every row's causal edge is skipped.
#include <math.h>

#include "../../common/hopper.cuh"
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
// bf16: wgmma fed by a TMA ring, two warpgroups
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kWarpgroups = 2;                // 64 query rows each
constexpr int kBQ = 64 * kWarpgroups;         // query rows per block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kWarps = kThreads / 32;

template <int HD>
struct Tile {
  static constexpr int kBK = HD == 256 ? 64 : 128;   // keys per tile
  static constexpr int kSwz = HD == 32 ? 64 : 128;   // bytes of a swizzled row
  static constexpr int kCols = kSwz / 2;             // bf16 columns of a box
  static constexpr int kBoxes = HD / kCols;          // boxes side by side along hd
  static constexpr int kStages = HD == 256 ? 2 : 3;  // K/V ring depth
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;      // one K (or V) stage
  // 8-byte mbarriers (Q full; K full and V full a stage), then a 4-byte
  // count of the warps done with each stage's K and with its V
  static constexpr int kBars = 1 + 2 * kStages;
  // 1024 bytes of slack align the tiles to the swizzle atoms
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBars + 4 * 2 * kStages;
  static constexpr int kLayout = HD == 32 ? kSwizzle64 : kSwizzle128;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, const int* __restrict__ q_offsets,
                      __nv_bfloat16* __restrict__ out, int H, int K, int Sq, int Sk, int causal,
                      int window, float scale) {
  using T = Tile<HD>;
  constexpr int kBK = T::kBK;
  constexpr int kSwz = T::kSwz;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;                              // kBoxes x kBQ rows x kSwz bytes
  const uint32_t sK = sQ + T::kQBytes;                   // kStages x (kBoxes x kBK x kSwz)
  const uint32_t sV = sK + kStages * T::kKVBytes;
  const uint32_t bar = sV + kStages * T::kKVBytes;       // 8-byte mbarriers
  const uint32_t bar_q = bar;
  auto bar_k = [&](int s) { return bar + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar + 8 * (1 + kStages + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const int off = q_offsets != nullptr ? q_offsets[b] : 0;

  // Key tiles [t_begin, t_end): the causal edge of the block's last stored
  // row bounds them above; the window start of its first row bounds them
  // below, unless some stored row's window holds no key at all.
  const int pmin = off + q0;
  const int pmax = off + min(q0 + kBQ, Sq) - 1;
  const int kend = causal ? min(Sk, pmax + 1) : Sk;
  const int kbeg = (window >= 1 && pmax - window + 1 <= Sk - 1) ? max(0, pmin - window + 1) : 0;
  const int t_begin = kbeg / kBK;
  const int n_tiles = (kend + kBK - 1) / kBK - t_begin;

  // the warps done with each stage's K (done[s]) and V (done[kStages + s])
  int* done = reinterpret_cast<int*>(smem_raw + (bar - smem_u32(smem_raw)) + 8 * T::kBars);
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      done[s] = done[kStages + s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();

  // One thread copies a whole tile of K (or V) into its stage by TMA.
  auto load_k = [&](int it) {
    const int s = it % kStages;
    mbar_arrive_expect_tx(bar_k(s), T::kKVBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_4d(sK + s * T::kKVBytes + x * kBK * kSwz, &tmk, bar_k(s), x * T::kCols, kvh,
                  (t_begin + it) * kBK, b);
  };
  auto load_v = [&](int it) {
    const int s = it % kStages;
    mbar_arrive_expect_tx(bar_v(s), T::kKVBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_4d(sV + s * T::kKVBytes + x * kBK * kSwz, &tmv, bar_v(s), x * T::kCols, kvh,
                  (t_begin + it) * kBK, b);
  };
  if (threadIdx.x == 0) {
    tma_prefetch(&tmq);
    tma_prefetch(&tmk);
    tma_prefetch(&tmv);
    mbar_arrive_expect_tx(bar_q, T::kQBytes);
#pragma unroll
    for (int x = 0; x < T::kBoxes; ++x)
      tma_load_4d(sQ + x * kBQ * kSwz, &tmq, bar_q, x * T::kCols, h, q0, b);
    for (int it = 0; it < min(kStages, n_tiles); ++it) {
      load_k(it);
      load_v(it);
    }
  }
  // A warp whose products have read tile it's K (or V) counts itself done
  // with that stage; the last of the block's warps refills it with tile
  // it + kStages. No thread waits for another to free a stage: the copies
  // are issued by whichever warp finishes last.
  const int warp_lane = threadIdx.x & 31;
  auto release = [&](int* count, int it, auto load) {
    if (warp_lane == 0) {
      __threadfence_block();
      if ((atomicAdd(count + it % kStages, 1) % kWarps) == kWarps - 1 &&
          it + kStages < n_tiles) {
        __threadfence_block();
        load(it + kStages);
      }
    }
    __syncwarp();
  };

  // ----- two warpgroups of 64 query rows -----
  constexpr int NS = kBK / 8;      // 8-key column blocks of a score tile
  constexpr int NO = HD / 8;       // 8-column blocks of the output
  constexpr int KQ = HD / 16;      // k-steps of Q K^T
  constexpr int KV = kBK / 16;     // k-steps of P V
  constexpr int SPB = T::kCols / 16;  // k-steps within one box
  // The softmax works in log2 units: a score s becomes s * scale * log2 e,
  // the mask -1e30 becomes -1e30 * log2 e, exp(x - m) is 2^(x2 - m2).
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kNegInf2 = kNegInf * kLog2e;
  const float scale_log2 = scale * kLog2e;
  const int cw = threadIdx.x / 128;         // this thread's warpgroup
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rbase = q0 + 64 * cw;           // this warpgroup's first query row
  const int wmin = off + rbase;             // its positions, for the edge test
  const int wmax = off + min(rbase + 64, Sq) - 1;
  const int row0 = warp * 16 + g;           // this thread's rows: row0 and row0 + 8
  const int qpos0 = off + rbase + row0;
  const int qpos1 = qpos0 + 8;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf2, kNegInf2};  // in log2 units, as the scores
  float l_r[2] = {0.f, 0.f};  // this thread's share of each row's l
  float sc[kBK / 2];          // one tile's scores, then its fp32 p
  uint32_t pa[KV][4];         // p in bf16: the register A operand of P V

  // S = Q K^T for the tile in stage s: 64 rows x kBK keys, both operands
  // K-major (issued, not waited for)
  auto issue_s = [&](int s) {
    const uint32_t ks = sK + s * T::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const uint32_t kin = (kk % SPB) * 32;   // 16 bf16 = 32 bytes along hd
      const uint64_t da = make_desc(sQ + (kk / SPB) * kBQ * kSwz + cw * 64 * kSwz + kin, 16,
                                    8 * kSwz, T::kLayout);
      const uint64_t db =
          make_desc(ks + (kk / SPB) * kBK * kSwz + kin, 16, 8 * kSwz, T::kLayout);
      wgmma_ss_bf16(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // O += P V for the tile in stage s: V is MN-major (hd contiguous),
  // boxes kBK * kSwz bytes apart along hd
  auto issue_pv = [&](int s) {
    const uint32_t vs = sV + s * T::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      const uint64_t db = make_desc(vs + kk * 16 * kSwz, kBK * kSwz, 8 * kSwz, T::kLayout);
      wgmma_rs_bf16_mn(o, pa[kk], db, 1);
    }
    wgmma_commit();
  };
  // Scale, mask on edge tiles, online softmax of tile `it` in registers:
  // sc becomes p, m and l move on, and alpha is what O must be scaled by
  // before this tile's P V (O itself is not touched: a P V may be running).
  auto softmax = [&](int it, float (&alpha)[2]) {
    const int k0 = (t_begin + it) * kBK;
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > wmin) ||
                      (window >= 0 && k0 < wmax - window + 1);
    float mx[2] = {m_r[0], m_r[1]};
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e] * scale_log2;
          const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = true;
          if (causal) ok = kpos <= qpos;
          if (window >= 0) ok = ok && kpos > qpos - window;
          if (!ok) x = kNegInf2;
          if (kpos >= Sk) x = -INFINITY;  // ragged edge: contributes nothing
          sc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
    } else {  // every key of the tile is live for every row: no mask
      float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) raw[e >> 1] = fmaxf(raw[e >> 1], sc[4 * n + e]);
      mx[0] = fmaxf(mx[0], raw[0] * scale_log2);
      mx[1] = fmaxf(mx[1], raw[1] * scale_log2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
    // edge tiles hold the scaled (and masked) scores; the others the raw
    // ones, scaled in the same fused multiply-add as the exponent
    float ps[2] = {0.f, 0.f};
    if (edge) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * n + e] = ex2(sc[4 * n + e] - mx[e >> 1]);
          ps[e >> 1] += sc[4 * n + e];
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale_log2, -mx[e >> 1]));
          ps[e >> 1] += sc[4 * n + e];
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ps[r];
  };
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[4 * n + 0] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      pa[kk][0] = ptx::pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = ptx::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = ptx::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = ptx::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // The two warpgroups take turns at issuing their products (named
  // barriers 1 and 2, each passed by one warpgroup's sync and the other's
  // arrive), so one's softmax runs while the other's products do; warpgroup
  // 0 goes first. The last turn, warpgroup 1's final P V, hands over to no
  // one.
  const int last_turn = n_tiles + 1;   // a warpgroup's turns: Q K^T of tile 0, then one a tile
  int turn = 0;
  auto take_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory"); };
  auto pass_turn = [&]() {
    if (cw == 0 || ++turn < last_turn)
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
  };
  if (cw == 1 && n_tiles > 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

  // Tile it's Q K^T runs while tile it-1's P V does: both are issued,
  // then the softmax of tile it overlaps the P V on the tensor cores.
  mbar_wait(bar_q, 0);
  if (n_tiles > 0) {
    float alpha[2];
    mbar_wait(bar_k(0), 0);
    take_turn();
    wgmma_fence();
    issue_s(0);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    release(done, 0, load_k);      // K is read: its stage may be refilled
    softmax(0, alpha);
    rescale_and_pack(alpha);
  }
  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % kStages, sp = (it - 1) % kStages;
    float alpha[2];
    mbar_wait(bar_k(s), (it / kStages) & 1);
    mbar_wait(bar_v(sp), ((it - 1) / kStages) & 1);
    take_turn();
    wgmma_fence();
    issue_s(s);
    issue_pv(sp);
    pass_turn();
    wgmma_wait<1>();          // this tile's scores have landed
    fence_regs(sc);
    release(done, it, load_k);
    softmax(it, alpha);
    wgmma_wait<0>();          // the last tile's P V is done
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) fence_regs(pa[kk]);
    release(done + kStages, it - 1, load_v);
    rescale_and_pack(alpha);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % kStages;
    mbar_wait(bar_v(sp), ((n_tiles - 1) / kStages) & 1);
    take_turn();
    wgmma_fence();
    issue_pv(sp);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) fence_regs(pa[kk]);
    release(done + kStages, n_tiles - 1, load_v);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  const float d0 = fmaxf(l_r[0], 1e-30f);
  const float d1 = fmaxf(l_r[1], 1e-30f);
  const int r0 = rbase + row0;
  const int r1 = r0 + 8;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * Sq * H + h) * HD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * tig;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * q_stride + col) =
          __floats2bfloat162_rn(o[4 * n + 0] / d0, o[4 * n + 1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * q_stride + col) =
          __floats2bfloat162_rn(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
  }
}

}  // namespace wg

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
  using T = wg::Tile<HD>;
  // TMA reads 16-byte aligned tensors; the bf16x2 stores need 4 bytes
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  // 4-D maps over (hd, heads, positions, batch): a box is one head's rows
  // of T::kCols columns; rows past Sq or Sk read as zeros
  const CUtensorMapSwizzle swz = HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  const uint64_t row = static_cast<uint64_t>(HD) * 2;
  const uint64_t q_dims[4] = {HD, static_cast<uint64_t>(H), static_cast<uint64_t>(Sq),
                              static_cast<uint64_t>(B)};
  const uint64_t q_strides[3] = {row, row * H, row * H * Sq};
  const uint64_t kv_dims[4] = {HD, static_cast<uint64_t>(K), static_cast<uint64_t>(Sk),
                               static_cast<uint64_t>(B)};
  const uint64_t kv_strides[3] = {row, row * K, row * K * Sk};
  const uint32_t q_box[4] = {T::kCols, 1, wg::kBQ, 1};
  const uint32_t kv_box[4] = {T::kCols, 1, T::kBK, 1};
  CUtensorMap mq, mk, mv;
  if (!hopper::make_map<4>(&mq, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, q_dims, q_strides, q_box,
                           swz) ||
      !hopper::make_map<4>(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, kv_dims, kv_strides, kv_box,
                           swz) ||
      !hopper::make_map<4>(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, kv_dims, kv_strides, kv_box,
                           swz))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wg::flash_fwd_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + wg::kBQ - 1) / wg::kBQ, B * H);
  wg::flash_fwd_bf16_kernel<HD><<<grid, wg::kThreads, T::kSmem, stream>>>(
      mq, mk, mv, static_cast<const int*>(offs), static_cast<__nv_bfloat16*>(out), H, K, Sq, Sk,
      causal, window, scale);
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

// The dynamic shared memory one block asks for at head dim hd (dtype as
// above), -1 for a head dim or dtype not built: the footprint model
// (ops.smem_bytes) is held to it on the card.
extern "C" int flash_attention_smem_bytes(int hd, int dtype) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (hd) {
    case 32: return dtype ? wg::Tile<32>::kSmem : static_cast<int>(smem_bytes<32>());
    case 64: return dtype ? wg::Tile<64>::kSmem : static_cast<int>(smem_bytes<64>());
    case 128: return dtype ? wg::Tile<128>::kSmem : static_cast<int>(smem_bytes<128>());
    case 256: return dtype ? wg::Tile<256>::kSmem : static_cast<int>(smem_bytes<256>());
    default: return -1;
  }
}
