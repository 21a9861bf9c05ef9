// Paged flash-decode for Hopper (sm_90a), split over the page walk
// (flash-decoding) in one launch: one query token per batch row, attending
// over that row's K/V pages, which each block finds by reading the row's
// page table inside the kernel.
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
//   block's share score -inf and add nothing.
//
// Bound on an H100: memory. Per (row, kv head) it reads the live K and V
// slots once (2 * live_tokens * hd * sizeof(T) bytes) and does 4 * G * hd
// flops per token, about G flops a byte in bf16, far below the card's ~295
// flops a byte: the least time is live K/V bytes / 3.35 TB/s (0.001 ms at
// the serving run's contexts, 0.005 ms with all 8 rows at a full table).
// At those sizes latency, not bytes, sets the time: pos -> the share -> the
// page table -> the pages -> the products -> the combine -> the store, each
// step waiting on the one before.
//
// What held the previous design back (bf16 on mma.sync, two launches): each
// split wrote its fp32 (m, l, acc) to a global scratch that a second kernel
// read back (one launch and one round trip through device memory more);
// every 16-byte cp.async of its 2-stage ring looked up its page in the table
// (a split's share arrived one 64-slot chunk a round trip); four warps on
// 16-slot mma.sync tiles merged their states through shared memory.
//
// Design. The live keys are cut into key tiles of kTile = 64 slots, and the
// grid (B, K, S) gives each of S splits a contiguous share of a row's tiles
// (ceil(n_tiles / S) each, computed in the kernel from pos, so the host
// never reads pos); the wrapper picks S <= 8 from B, K and the table's size
// so that a full table gives one block an SM (ops.paged_splits: 4 at the
// serving shapes; clusters of 8 blocks of this size fit only 30 at once on
// an H100, so 32 of them would take a second wave). The S splits of one
// (row, kv head) are one thread-block cluster (dimensions (1, 1, S)), and
// their fp32 states meet in shared memory. Each block owns a slice of the
// G x hd outputs (row-major float4s, in rank order). A split that holds
// tiles stages its acc and each row's (m, l) in its own shared memory, and
// its threads store each float4 into the inbox of the block owning it and
// each (m, l) into every block's inbox (mapa + st.shared::cluster); after
// one cluster barrier (release / acquire) every block combines its slice
// from its own shared memory, in split order: weights exp(m_s - M), M the
// largest m_s of the splits that hold tiles, l = sum(w * l_s), out =
// sum(w * acc_s) / max(l, 1e-30). The order is fixed, so a run gives the
// same bits every time; a split whose keys are all masked has m = -1e30 and
// weight exactly 0, because M is a real score (slot pos is always live). A
// block may store into a peer only once the peer has started: every block
// arrives (relaxed) on the cluster barrier as it starts and waits on it
// before its stores. No block reads a peer's memory, so none has to outlive
// another. A block with an empty share computes nothing but takes part in
// both barriers and combines its slice. (A first form had each block read
// its peers' states with ld.shared::cluster after the barrier, and a second
// barrier keep them alive until read: slower, PERF.md §6.)
//
// bf16 (dtype 1, what serving runs): one warpgroup a block, products on
// wgmma. What does not wait on pos goes first: the tensor maps' prefetch,
// the mbarriers, the row's page table into L2 and the G query rows into
// registers. Pages come in by TMA: a 3-D map over each pool seen as
// (hd, K, P * page), boxes of 64 bf16 columns (128-byte swizzle; hd 32
// takes 32 columns and the 64-byte swizzle) by `rows` slots of one kv
// head, `rows` the largest of 64, 32, 16, 8 that divides the page, so that
// a box lies inside one page and one key tile and lands on a whole swizzle
// atom; a tile is at most 32 boxes, one a lane of warp 0, each lane
// reading its box's table entry (for the first kStages tiles all at once,
// and for a refill one tile ahead) and issuing it, each tile's K and V on
// one mbarrier. The ring holds as many tiles as two blocks an SM leave
// room for (2 at hd 128, 6 at hd 64, 8 at hd 32). Boxes past the share's
// end load a live box again (their scores are -inf, p = 0, and the values
// finite). A page whose size is not a multiple of 8 slots cannot land as
// whole swizzle atoms: there the 128 threads copy the tile with 16-byte
// cp.async into the same swizzled layout (zero-filled past the share), the
// copies arriving on the same mbarrier. S = Q K^T is wgmma m64n64k16 with
// both operands K-major in shared memory, Q's G rows padded with zeros to
// the 64-row tile (only warp 0's rows are real); the softmax runs in
// registers on the accumulator fragments (quad shuffles) in log2 units
// (exp is one ex2; on a tile no mask touches, the scale is fused into its
// multiply-add); P, rounded to bf16, is the register A operand of
// O += P V (wgmma m64n{hd}k16, V MN-major). Masks are applied only on tiles
// that reach past pos or the share's end, and on every tile of a ring.
//
// fp32 (dtype 0) keeps CUDA-core arithmetic, because its 1e-5 checks rule
// out TF32: one block of hd threads per (row, kv head, split) walks its
// share in tiles of 16 slots (double-buffered cp.async tiles; thread i
// scores the pair (g, t) = (i / 16, i % 16) over hd from shared memory, one
// warp per query row updates the softmax, thread d accumulates column d),
// then takes the same cluster combine.
#include <math.h>

#include <utility>

#include "../../common/hopper.cuh"

namespace {

using namespace hopper;
using ptx::cp_async16;

constexpr float kNegInf = -1e30f;
constexpr int kMaxG = 16;       // query heads per kv head
constexpr int kTile = 64;       // slots of a key tile: the unit of a split's share
constexpr int kMaxSplits = 8;   // blocks of a cluster: the portable cluster size
constexpr int kF32Tile = 16;    // slots of the fp32 kernel's tiles

// This split's share of its row's key tiles, from pos: the row's live slots
// are [0, live), pages 0..jmax.
struct Share {
  int t0, t1;  // this split's key tiles [t0, t1); empty when t0 >= t1
  int end;     // this split's last slot + 1: min(t1 * kTile, live)
  int used;    // splits of the row that hold tiles
};

__device__ __forceinline__ Share share_of(int pos, int page, int n_pages, bool ring, int splits,
                                          int split) {
  int jmax = pos / page;
  if (ring && pos >= n_pages * page) jmax = n_pages - 1;
  jmax = min(jmax, n_pages - 1);
  Share s;
  const int live = (jmax + 1) * page;
  const int n_tiles = (live + kTile - 1) / kTile;
  const int per = max(1, (n_tiles + splits - 1) / splits);
  s.t0 = split * per;
  s.t1 = min(s.t0 + per, n_tiles);
  s.end = min(s.t1 * kTile, live);
  s.used = (n_tiles + per - 1) / per;
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

// Brings the 128-byte line at p into L2; nothing waits on it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Element offset of slot t's row (kv head kh) in a pool (P, page, K, hd).
template <int HD>
__device__ __forceinline__ size_t slot_offset(const int* trow, int t, int page, int K, int kh) {
  const int j = t / page;
  const int pid = __ldg(trow + j);
  return ((static_cast<size_t>(pid) * page + (t - j * page)) * K + kh) * HD;
}

// ---------------------------------------------------------------------------
// The cluster's combine
// ---------------------------------------------------------------------------

// Each block owns a slice of the G x HD outputs: `per4` float4s of them in
// row-major order, in rank order. Its inbox in shared memory (fp32
// offsets): (m, l) of every row of every split, then every split's part of
// this block's slice (per4 * 4 floats each).
template <int HD>
struct Inbox {
  static constexpr int kML = 0;
  static constexpr int kAcc = kML + 2 * kMaxSplits * kMaxG;
  // splits x per4 x 4 floats at most
  static constexpr int kBytes = 4 * (kAcc + kMaxG * HD + 4 * kMaxSplits);
};

// float4s of the G x HD outputs that each block of the cluster combines
__device__ __forceinline__ int slice4(int G, int HD, int splits) {
  return (G * HD / 4 + splits - 1) / splits;
}

// A split that holds tiles, after its last tile: its acc (G x HD fp32,
// row-major) lies in `acc` and the (m, l) of each row in `m` and `l`, in
// this block's shared memory. The block's threads store each float4 of acc
// into the inbox of the block owning it, and (m, l) of each row into every
// block's inbox (st.shared::cluster).
template <int HD>
__device__ __forceinline__ void send_state(const float* acc, const float* m, const float* l,
                                           float* ib, int split, int splits, int G) {
  const uint32_t inbox = smem_u32(ib);
  const int per4 = slice4(G, HD, splits);
  for (int i = threadIdx.x; i < G * HD / 4; i += blockDim.x) {
    const int owner = i / per4;
    st_cluster(mapa(inbox + 4 * (Inbox<HD>::kAcc + (split * per4 + i - owner * per4) * 4), owner),
               *reinterpret_cast<const float4*>(acc + 4 * i));
  }
  for (int i = threadIdx.x; i < splits * G; i += blockDim.x) {
    const int owner = i / G, row = i - owner * G;
    st_cluster(mapa(inbox + 4 * (Inbox<HD>::kML + 2 * (split * kMaxG + row)), owner), m[row],
               l[row]);
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(ptx::pack_bf16(v.x, v.y), ptx::pack_bf16(v.z, v.w));
}

// After the cluster barrier that follows the splits' stores into the
// inboxes: each thread takes a float4 of this block's slice of the G x HD
// outputs, turns the used splits' m and l of its row into weights
// exp(m_s - M) (M the largest m_s) and l = sum(w * l_s), adds the splits'
// parts of the float4 weighted, all in split order, and stores
// acc / max(l, 1e-30) to out, the G rows of this (row, kv head).
// Everything it reads is its own shared memory.
template <int HD, typename T>
__device__ __forceinline__ void combine_slice(const float* ib, int used, int splits, int G,
                                              T* out) {
  using I = Inbox<HD>;
  const int per4 = slice4(G, HD, splits);
  const int i0 = static_cast<int>(cluster_ctarank()) * per4;
  const int i1 = min(G * HD / 4, i0 + per4);
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const float* ml = ib + I::kML + 2 * (4 * i / HD);  // split s: ml[2 kMaxG s], +1
    const float* part = ib + I::kAcc + (i - i0) * 4;   // split s: part[4 per4 s]
    float M = kNegInf;
    for (int s = 0; s < used; ++s) M = fmaxf(M, ml[2 * kMaxG * s]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < used; ++s) {
      const float wt = expf(ml[2 * kMaxG * s] - M);
      const float4 v = *reinterpret_cast<const float4*>(part + 4 * per4 * s);
      l += ml[2 * kMaxG * s + 1] * wt;
      acc.x += v.x * wt;
      acc.y += v.y * wt;
      acc.z += v.z * wt;
      acc.w += v.w * wt;
    }
    const float den = fmaxf(l, 1e-30f);
    store4(out + 4 * i, make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den));
  }
}

// ---------------------------------------------------------------------------
// bf16: one warpgroup on wgmma, pages by TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kThreads = 128;
constexpr int kMaxStages = 8;
// Two blocks an SM: its 228 KB of shared memory less 1 KB reserved a block.
constexpr int kBudget = (233472 - 2 * 1024) / 2;

template <int HD>
struct Tile {
  static constexpr int kSwz = HD == 32 ? 64 : 128;   // bytes of a swizzled row
  static constexpr int kCols = kSwz / 2;             // bf16 columns of a box
  static constexpr int kBoxes = HD / kCols;          // boxes side by side along hd
  static constexpr int kQBytes = 64 * HD * 2;        // Q: the product's 64 rows
  static constexpr int kKVBytes = kTile * HD * 2;    // one key tile of K (or V)
  // 1024 bytes of slack align the tiles to the swizzle atoms; then Q, the
  // K ring, the V ring, the inbox, one 8-byte mbarrier a stage
  static constexpr int kFixed = 1024 + kQBytes + Inbox<HD>::kBytes;
  static constexpr int kPerStage = 2 * kKVBytes + 8;
  static constexpr int kFit = (kBudget - kFixed) / kPerStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kFixed + kStages * kPerStage;
  static constexpr int kLayout = HD == 32 ? kSwizzle64 : kSwizzle128;
};

// Byte offset of the 16-byte chunk c (along hd) of row r in a 64-row tile,
// laid out as the TMA boxes land: box c / (kSwz / 16), row r, the chunk
// swizzled within its row (the 128-byte swizzle XORs it with r % 8, the
// 64-byte one with (r / 2) % 4).
template <int HD>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  using T = Tile<HD>;
  constexpr int kPer = T::kSwz / 16;
  const int sw = T::kSwz == 128 ? (r & 7) : ((r >> 1) & 3);
  return (c / kPer) * 64 * T::kSwz + r * T::kSwz + (((c % kPer) ^ sw) << 4);
}

// TMA: pages by boxes of `rows` slots (a multiple of 8 dividing the page
// and 64); else 16-byte cp.async copies.
template <int HD, bool TMA>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_bf16_kernel(const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv,
                         const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                         const __nv_bfloat16* __restrict__ vp, const int* __restrict__ table,
                         const int* __restrict__ pos_arr, __nv_bfloat16* __restrict__ out, int K,
                         int G, int page, int n_pages, int rows, int window, float scale) {
  using T = Tile<HD>;
  constexpr int kSwz = T::kSwz;
  constexpr int kStages = T::kStages;
  constexpr int CH = HD / 8;        // 16-byte chunks of a row
  constexpr int KQ = HD / 16;       // k-steps of Q K^T
  constexpr int KV = kTile / 16;    // k-steps of P V
  constexpr int SPB = T::kCols / 16;  // k-steps within one box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::kQBytes;              // kStages key tiles
  const uint32_t sV = sK + kStages * T::kKVBytes;
  float* ib = reinterpret_cast<float*>(gbase + T::kQBytes + 2 * kStages * T::kKVBytes);
  float* stage = reinterpret_cast<float*>(gbase);  // the split's state, after the Q tile's use
  const uint32_t bar = smem_u32(ib) + Inbox<HD>::kBytes;
  auto full = [&](int s) { return bar + 8 * s; };
  cluster_arrive_relaxed();  // this block has started: its peers may write its inbox

  // Everything that does not wait on pos first: the tensor maps, the
  // mbarriers, the row's page table into L2, and the G query rows of kv
  // head kh (q is (B, 1, H, hd): they are contiguous) into registers, at
  // most kQLoads 16-byte chunks a thread.
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int* trow = table + static_cast<size_t>(b) * n_pages;
  if (warp == 0)
    for (int i = 32 * lane; i < n_pages; i += 32 * 32) prefetch_l2(trow + i);
  if (tid == 0) {
    if (TMA) {
      tma_prefetch(&tmk);
      tma_prefetch(&tmv);
    }
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), TMA ? 1 : kThreads);
    mbar_fence_init();
  }
  constexpr int kQLoads = (kMaxG * CH + kThreads - 1) / kThreads;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * K + kh) * G * HD;
  uint4 qv[kQLoads];
#pragma unroll
  for (int j = 0; j < kQLoads; ++j) {
    const int i = tid + j * kThreads;
    qv[j] = i < G * CH ? __ldg(reinterpret_cast<const uint4*>(qb) + i)
                       : make_uint4(0u, 0u, 0u, 0u);
  }

  const int pos = __ldg(pos_arr + b);
  const bool ring = window >= 0;
  const int W = n_pages * page;
  const Share sh = share_of(pos, page, n_pages, ring, splits, split);
  const int n_tiles = max(0, sh.t1 - sh.t0);
  const int g = lane >> 2, tig = lane & 3;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kNegInf2 = kNegInf * kLog2e;  // the mask in log2 units
  const float scale2 = scale * kLog2e;
  float o[HD / 2];
  float m_r[2] = {kNegInf2, kNegInf2};  // in log2 units, as the scores
  float l_r[2] = {0.f, 0.f};            // this thread's share of each row's l
  __syncthreads();                      // the mbarriers are initialised

  if (n_tiles > 0) {
    // Key tile sh.t0 + it into stage it % kStages, K and V on its mbarrier.
    // TMA: box j of a tile (K|V, hd box, group of `rows` slots; at most 32)
    // is lane j's, at the pool row box_row(it) reads from the page table.
    const int n_box = TMA ? (kTile / rows) * T::kBoxes * 2 : 0;
    const int bv = lane & 1, bx = (lane >> 1) % T::kBoxes;
    const int br0 = ((lane >> 1) / T::kBoxes) * rows;
    auto box_row = [&](int it) {
      // past the share's end: a live box again (p = 0 on it)
      const int t = min((sh.t0 + it) * kTile + br0, sh.end - rows);
      const int pg = t / page;
      return __ldg(trow + pg) * page + (t - pg * page);
    };
    auto load_tile = [&](int it, int row) {
      const int s = it % kStages;
      const uint32_t ks = sK + s * T::kKVBytes, vs = sV + s * T::kKVBytes;
      if constexpr (TMA) {
        if (warp == 0) {
          if (lane == 0) mbar_arrive_expect_tx(full(s), 2 * T::kKVBytes);
          __syncwarp();
          if (lane < n_box)
            tma_load_3d((bv ? vs : ks) + bx * 64 * kSwz + br0 * kSwz, bv ? &tmv : &tmk, full(s),
                        bx * T::kCols, kh, row);
        }
      } else {
        const int s0 = (sh.t0 + it) * kTile;
        for (int i = tid; i < kTile * CH; i += kThreads) {
          const int r = i / CH, c = i - (i / CH) * CH;
          const int t = s0 + r;
          const bool in = t < sh.end;
          const size_t src = in ? slot_offset<HD>(trow, t, page, K, kh) + c * 8 : 0;
          const uint32_t off = chunk_offset<HD>(r, c);
          cp_async16(ks + off, kp + src, in);
          cp_async16(vs + off, vp + src, in);
        }
        mbar_arrive_cp_async(full(s));
      }
    };
    // the first kStages tiles: every table read first, then every copy
    int rows0[kStages];
#pragma unroll
    for (int it = 0; it < kStages; ++it)
      rows0[it] = TMA && warp == 0 && lane < n_box ? box_row(min(it, n_tiles - 1)) : 0;
#pragma unroll
    for (int it = 0; it < kStages; ++it)
      if (it < n_tiles) load_tile(it, rows0[it]);

    // the product's 64-row Q tile: the G rows loaded above, zeros below
#pragma unroll
    for (int j = 0; j < kQLoads; ++j) {
      const int i = tid + j * kThreads;
      if (i < kMaxG * CH)
        *reinterpret_cast<uint4*>(gbase + chunk_offset<HD>(i / CH, i % CH)) = qv[j];
    }
    for (int i = kMaxG * CH + tid; i < 64 * CH; i += kThreads)
      *reinterpret_cast<uint4*>(gbase + chunk_offset<HD>(i / CH, i % CH)) =
          make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();  // the Q tile is read by wgmma
    __syncthreads();

#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float sc[kTile / 2];        // a tile's scores, then its fp32 p
    uint32_t pa[KV][4];         // p in bf16: the register A operand of P V

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t ks = sK + s * T::kKVBytes, vs = sV + s * T::kKVBytes;
      // the table read of the tile kStages on, ahead of its copy
      const int next_row = TMA && warp == 0 && lane < n_box && it + kStages < n_tiles
                               ? box_row(it + kStages)
                               : 0;
      mbar_wait(full(s), (it / kStages) & 1);
      if (!TMA) fence_proxy_async();  // cp.async's copies are read by wgmma

      // S = Q K^T: 64 (padded) query rows x the tile's 64 slots
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const uint32_t kin = (kk % SPB) * 32;  // 16 bf16 = 32 bytes along hd
        const uint64_t da = make_desc(sQ + (kk / SPB) * 64 * kSwz + kin, 16, 8 * kSwz, T::kLayout);
        const uint64_t db = make_desc(ks + (kk / SPB) * 64 * kSwz + kin, 16, 8 * kSwz, T::kLayout);
        wgmma_ss_bf16(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale, mask where the tile reaches past pos or the share's end
      // (every tile of a ring), online softmax in registers, in log2 units:
      // exp(x - m) is one ex2, and on a tile no mask touches the scale is
      // fused into the exponent's multiply-add
      const int t_first = (sh.t0 + it) * kTile;
      const bool edge = ring || t_first + kTile - 1 > pos || t_first + kTile > sh.end;
      float mx[2] = {m_r[0], m_r[1]};
      if (edge) {
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * n + e] * scale2;
            const int t = t_first + n * 8 + 2 * tig + (e & 1);
            if (t >= sh.end)
              x = -INFINITY;  // past the share: adds nothing
            else if (!slot_ok(t, pos, W, window))
              x = kNegInf2;
            sc[4 * n + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      } else {
        float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], sc[i]);
        mx[0] = fmaxf(mx[0], raw[0] * scale2);
        mx[1] = fmaxf(mx[1], raw[1] * scale2);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
      float ps[2] = {0.f, 0.f};
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) {
          sc[i] = ex2(sc[i] - mx[(i >> 1) & 1]);
          ps[(i >> 1) & 1] += sc[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) {
          sc[i] = ex2(fmaf(sc[i], scale2, -mx[(i >> 1) & 1]));
          ps[(i >> 1) & 1] += sc[i];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + ps[r];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
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

      // O += P V: V is MN-major (hd contiguous), boxes 64 rows apart along hd
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) {
        const uint64_t db = make_desc(vs + kk * 16 * kSwz, 64 * kSwz, 8 * kSwz, T::kLayout);
        wgmma_rs_bf16_mn(o, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < KV; ++kk) fence_regs(pa[kk]);
      if (it + kStages < n_tiles) {  // the stage is read: bring the tile kStages on
        __syncthreads();
        load_tile(it + kStages, next_row);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    // warp 0 holds the real rows (element 4n + e: row g + 8 (e / 2),
    // column 8n + 2 tig + (e % 2)): acc, m (back in natural units) and l
    // into the Q tile's space, which no product reads any more
    if (warp == 0) {
      fence_proxy_async();  // after the products' reads of the Q tile
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        if (row < G) {
#pragma unroll
          for (int n = 0; n < HD / 8; ++n)
            *reinterpret_cast<float2*>(stage + row * HD + n * 8 + 2 * tig) =
                make_float2(o[4 * n + 2 * r], o[4 * n + 2 * r + 1]);
          if (tig == 0) {
            stage[kMaxG * HD + row] = m_r[r] / kLog2e;
            stage[kMaxG * HD + kMaxG + row] = l_r[r];
          }
        }
      }
    }
    __syncthreads();
  }
  cluster_wait();  // every block of the cluster has started
  if (n_tiles > 0)
    send_state<HD>(stage, stage + kMaxG * HD, stage + kMaxG * HD + kMaxG, ib, split, splits, G);
  cluster_arrive();
  cluster_wait();  // every split's rows are in the inboxes
  combine_slice<HD>(ib, sh.used, splits, G, out + (static_cast<size_t>(b) * K + kh) * G * HD);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

// Shared memory (floats): 2 stages x {K, V} x kF32Tile x HD, q (kMaxG x
// HD), the scores (kMaxG x kF32Tile), alpha, m and l (kMaxG each), then the
// inbox. The wrapper computes the same.
template <int HD>
struct F32Smem {
  static constexpr int kInbox = 4 * kF32Tile * HD + kMaxG * HD + kMaxG * kF32Tile + 3 * kMaxG;
  static constexpr int kBytes = 4 * kInbox + Inbox<HD>::kBytes;
};

template <int HD>
__global__ void __launch_bounds__(HD)
paged_decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                        const float* __restrict__ vp, const int* __restrict__ table,
                        const int* __restrict__ pos_arr, float* __restrict__ out, int K, int G,
                        int page, int n_pages, int window, float scale) {
  constexpr int kWarps = HD / 32;
  constexpr int kChunksPerRow = HD / 4;  // 16-byte copies per slot row
  constexpr int tile = kF32Tile * HD;
  cluster_arrive_relaxed();  // this block has started: its peers may write its inbox
  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int pos = __ldg(pos_arr + b);
  const bool ring = window >= 0;
  const int W = n_pages * page;
  const Share sh = share_of(pos, page, n_pages, ring, splits, split);

  const int d = threadIdx.x;
  const int lane = d & 31;
  const int warp = d >> 5;
  const int* trow = table + static_cast<size_t>(b) * n_pages;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kv_s = reinterpret_cast<float*>(smem_raw);  // [stage][K|V][kF32Tile][HD]
  float* q_s = kv_s + 4 * tile;                      // G x HD query rows, then acc
  float* s_s = q_s + kMaxG * HD;                     // G x kF32Tile scores, then probabilities
  float* a_s = s_s + kMaxG * kF32Tile;               // this tile's rescale factor
  float* m_s = a_s + kMaxG;                          // running max per query row
  float* l_s = m_s + kMaxG;                          // running denominator
  float* ib = kv_s + F32Smem<HD>::kInbox;            // the combine's inbox

  // the share's 16-slot tiles [f0, f1)
  const int f0 = sh.t0 * (kTile / kF32Tile);
  const int f1 = sh.t0 < sh.t1 ? (sh.end + kF32Tile - 1) / kF32Tile : f0;
  if (f0 < f1) {
    auto issue = [&](int tl, int stage) {  // async copy of one tile's K and V
      float* ks = kv_s + 2 * stage * tile;
      float* vs = ks + tile;
      for (int i = d; i < kF32Tile * kChunksPerRow; i += HD) {
        const int r = i / kChunksPerRow;
        const int c = (i - r * kChunksPerRow) * 4;
        const int t = tl * kF32Tile + r;
        const bool in = t < sh.end;
        const size_t off = in ? slot_offset<HD>(trow, t, page, K, kh) + c : 0;
        cp_async16(smem_u32(ks + r * HD + c), kp + off, in);
        cp_async16(smem_u32(vs + r * HD + c), vp + off, in);
      }
      ptx::cp_async_commit();
    };
    issue(f0, 0);

    const float* qb = q + (static_cast<size_t>(b) * K + kh) * G * HD;
    for (int g = 0; g < G; ++g) q_s[g * HD + d] = qb[g * HD + d];
    if (d < G) {
      m_s[d] = kNegInf;
      l_s[d] = 0.f;
    }
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    __syncthreads();  // q_s, m_s, l_s are visible

    for (int tl = f0; tl < f1; ++tl) {
      const int stage = (tl - f0) & 1;
      if (tl + 1 < f1) {
        issue(tl + 1, stage ^ 1);
        ptx::cp_async_wait<1>();
      } else {
        ptx::cp_async_wait<0>();
      }
      __syncthreads();  // tile tl is visible
      const float* ks = kv_s + 2 * stage * tile;
      const float* vs = ks + tile;

      for (int i = d; i < G * kF32Tile; i += HD) {
        const int g = i / kF32Tile;
        const int r = i - g * kF32Tile;
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
        const int t = tl * kF32Tile + r;
        float x = dot * scale;
        if (t >= sh.end)
          x = -INFINITY;
        else if (!slot_ok(t, pos, W, window))
          x = kNegInf;
        s_s[g * kF32Tile + r] = x;
      }
      __syncthreads();

      for (int g = warp; g < G; g += kWarps) {  // online softmax, one warp per row
        float* srow = s_s + g * kF32Tile;
        const float m_prev = m_s[g];
        const float x = lane < kF32Tile ? srow[lane] : -INFINITY;
        float m_new = fmaxf(m_prev, x);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, o));
        const float alpha = expf(m_prev - m_new);
        const float p = lane < kF32Tile ? expf(x - m_new) : 0.f;
        if (lane < kF32Tile) srow[lane] = p;
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
      for (int r = 0; r < kF32Tile; ++r) {
        const float v = vs[r * HD + d];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) pv[g] = fmaf(s_s[g * kF32Tile + r], v, pv[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = acc[g] * a_s[g] + pv[g];
      __syncthreads();  // this stage, s_s and a_s are rewritten from here on
    }
    // acc, row-major, into q_s, which no product reads any more
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) q_s[g * HD + d] = acc[g];
    __syncthreads();
  }
  cluster_wait();  // every block of the cluster has started
  if (f0 < f1) send_state<HD>(q_s, m_s, l_s, ib, split, splits, G);
  cluster_arrive();
  cluster_wait();  // every split's rows are in the inboxes
  combine_slice<HD>(ib, sh.used, splits, G, out + (static_cast<size_t>(b) * K + kh) * G * HD);
}

// ---------------------------------------------------------------------------
// launch: the (B, K, S) grid as clusters of (1, 1, S)
// ---------------------------------------------------------------------------

// A launch of `grid` as clusters of (1, 1, grid.z), with `smem` bytes of
// dynamic shared memory a block; `attr` holds the cluster's dimensions.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                           cudaLaunchAttribute& attr, cudaLaunchConfig_t& cfg) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = grid.z;
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // Set on every launch: the attribute is per device, and the call is cheap.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename... Args, typename... Actual>
cudaError_t launch_cluster(void (*kernel)(Args...), dim3 grid, int threads, int smem,
                           cudaStream_t stream, Actual&&... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, grid, threads, smem, stream, attr, cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Actual>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD>
cudaError_t max_clusters(int B, int K, int splits, int* n) {
  const auto kernel = wg::paged_decode_bf16_kernel<HD, true>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, dim3(B, K, splits), wg::kThreads,
                                   wg::Tile<HD>::kSmem, nullptr, attr, cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, reinterpret_cast<const void*>(kernel), &cfg);
}

// The largest of 64, 32, 16, 8 slots that divides the page (a TMA box's
// rows), 0 if none does.
inline int box_rows(int page) {
  for (int r = 64; r >= 8; r /= 2)
    if (page % r == 0) return r;
  return 0;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* kp, const void* vp, const void* table,
                        const void* pos, void* out, int B, int K, int G, int page, int n_pages,
                        int n_pool, int window, int splits, float scale, cudaStream_t stream) {
  using T = wg::Tile<HD>;
  const int rows = box_rows(page);
  CUtensorMap mk{}, mv{};
  if (rows) {
    // 3-D maps over each pool seen as (hd, K, P * page): a box is `rows`
    // slots of one kv head, T::kCols columns wide
    const CUtensorMapSwizzle swz =
        HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    const uint64_t row = static_cast<uint64_t>(HD) * 2;
    const uint64_t dims[3] = {HD, static_cast<uint64_t>(K),
                              static_cast<uint64_t>(n_pool) * static_cast<uint64_t>(page)};
    const uint64_t strides[2] = {row, row * K};
    const uint32_t box[3] = {T::kCols, 1, static_cast<uint32_t>(rows)};
    if (!make_map<3>(&mk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kp, dims, strides, box, swz) ||
        !make_map<3>(&mv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, vp, dims, strides, box, swz))
      return cudaErrorInvalidValue;
  }
  auto kernel =
      rows ? wg::paged_decode_bf16_kernel<HD, true> : wg::paged_decode_bf16_kernel<HD, false>;
  return launch_cluster(kernel, dim3(B, K, splits), wg::kThreads, T::kSmem, stream, mk, mv,
                        static_cast<const __nv_bfloat16*>(q),
                        static_cast<const __nv_bfloat16*>(kp),
                        static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(table),
                        static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), K, G, page,
                        n_pages, rows, window, scale);
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* kp, const void* vp, const void* table,
                       const void* pos, void* out, int B, int K, int G, int page, int n_pages,
                       int window, int splits, float scale, cudaStream_t stream) {
  return launch_cluster(paged_decode_f32_kernel<HD>, dim3(B, K, splits), HD,
                        F32Smem<HD>::kBytes, stream, static_cast<const float*>(q),
                        static_cast<const float*>(kp), static_cast<const float*>(vp),
                        static_cast<const int*>(table), static_cast<const int*>(pos),
                        static_cast<float*>(out), K, G, page, n_pages, window, scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window < 0 means a linear (non-ring)
// cache. n_pool: the pools' page count P. One launch of splits-block
// clusters; returns its cudaError_t (a refused cluster launch included).
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* table, const void* pos, void* out, int B,
                                      int K, int G, int hd, int page, int n_pages, int n_pool,
                                      int window, int splits, float scale, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G < 1 || G > kMaxG || splits < 1 || splits > kMaxSplits || page < 1 || n_pages < 1 ||
      n_pool < 1 || B < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies of q, K and V; 16-byte (fp32) or 8-byte (bf16) stores
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
       reinterpret_cast<uintptr_t>(v_pages) | reinterpret_cast<uintptr_t>(out)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 1000 + hd) {
#define PA_CASE(HD)                                                                           \
  case HD:                                                                                    \
    err = launch_f32<HD>(q, k_pages, v_pages, table, pos, out, B, K, G, page, n_pages,        \
                         window, splits, scale, s);                                           \
    break;                                                                                    \
  case 1000 + HD:                                                                             \
    err = launch_bf16<HD>(q, k_pages, v_pages, table, pos, out, B, K, G, page, n_pages,       \
                          n_pool, window, splits, scale, s);                                  \
    break;
    PA_CASE(32)
    PA_CASE(64)
    PA_CASE(128)
#undef PA_CASE
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The dynamic shared memory one block asks for at head dim hd (dtype as
// above), -1 for a head dim or dtype not built: the footprint model
// (ops.smem_bytes) is held to it on the card.
extern "C" int paged_attention_smem_bytes(int hd, int dtype) {
  switch (dtype * 1000 + hd) {
    case 32: return F32Smem<32>::kBytes;
    case 64: return F32Smem<64>::kBytes;
    case 128: return F32Smem<128>::kBytes;
    case 1032: return wg::Tile<32>::kSmem;
    case 1064: return wg::Tile<64>::kSmem;
    case 1128: return wg::Tile<128>::kSmem;
    default: return -1;
  }
}

// Clusters of the bf16 TMA kernel at head dim hd that the card holds at
// once for a (B, K, splits) grid (cudaOccupancyMaxActiveClusters), or minus
// the error: what decides whether the grid runs in one wave.
extern "C" int paged_attention_max_clusters(int B, int K, int splits, int hd) {
  cudaError_t err;
  int n = 0;
  switch (hd) {
    case 32: err = max_clusters<32>(B, K, splits, &n); break;
    case 64: err = max_clusters<64>(B, K, splits, &n); break;
    case 128: err = max_clusters<128>(B, K, splits, &n); break;
    default: err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
