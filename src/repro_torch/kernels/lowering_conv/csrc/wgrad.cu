// Weight gradient of the lowering conv for Hopper (sm_90a): dW = lowered^T @ dY
// from the forward's lowered residual, in 3xTF32 on wgmma with tiles brought
// by TMA, split over the M = B*Ho*Wo rows.
//
// Replaces the TPU kernel src/repro/kernels/lowering_conv/bwd.py ::
// wgrad_pallas (_wgrad_kernel).
//
// What it computes: dW[k, n] = sum_m lowered[m, k] * dY[m, n], the (K, Cout)
// matrix that is the HWIO weight gradient as it lies, in fp32 (the
// residual's type on this path, as in the reference).
//
// Bound on an H100: operations. 3xTF32 spends three TF32 tensor-core
// products on each of the 2*M*K*Cout necessary flops, so the least time is
// 3 * flops / 495 TFLOP/s: 0.4571 ms over CaffeNet's conv1-5 at group batch
// 64 (75.4 GFLOP), against 1.1257 ms at the 67 TFLOP/s fp32 CUDA-core rate
// and about 0.25 ms for the bytes, 4*(M*K + M*Cout + K*Cout); conv1 alone
// (K = 363) is bound by its bytes.
//
// What held the design before this one back: mma.sync (Ampere's products),
// both operands read transposed by scalar shared-memory reads and split in
// registers by every warp at every stage, 4-warp blocks.
//
// Design (dgrad.cu's machinery, common/hopper.cuh). The TPU kernel sums
// every grid step into one output block that stays in VMEM, which needs the
// grid to run in order. Blocks run in parallel here, and the output has few
// tiles (3 at conv1), so the M rows are split into S slices of `slice_rows`
// (a multiple of 32) that the wrapper picks from the shapes alone; block
// (tile, slice) owns a 128 (K) x BN (Cout) tile of dW over its slice (BN =
// 64 or 96, an argument). Neither operand lies along the reduction (M):
// `lowered` is K-contiguous and dY Cout-contiguous, while TF32 wgmma takes
// its shared-memory operand (B) K-major only and only A from registers. So
// A = lowered^T comes from registers, read transposed from shared memory and
// split there, and B = dY is transposed to M-contiguous rows once, by a
// prologue (hopper::split_transpose) that splits it into big = the nearest
// TF32 (ties away) and small = x - big as a (2, Cout, M4) scratch (M4 = M
// rounded up to 4, zero-padded: 16-byte rows for TMA). Of the two ways to
// a K-major B, both were built and timed (PERF.md §6): a split and
// transpose of each stage's dY tile in shared memory by the producer gave
// the same bits and the same time at conv1, but was slower at conv2-5,
// where it redoes the split for every K tile of dW (19 at conv2) in the
// producer's 128 threads between two barriers a stage. The prologue moves
// 3x dY's bytes once (dY is K/Cout times smaller than the residual: 34.7 MB
// against 325 MB at conv2) and leaves the producer to issuing copies.
// One launch runs three kernels: the prologue, the partial products, and a
// sum of the partials. The partial kernel's block has three warpgroups and
// walks its slice in stages of 32 rows through a 4-stage ring, each stage
// with a "full" and an "empty" mbarrier. Warpgroup 0 is the producer: one
// thread brings the stage's big and small dY tiles (BN x 32, 128-byte
// swizzled rows) by TMA from a 3-D map over (M4, Cout, 2), and, where K is a
// multiple of 4 (rows of `lowered` 16-byte aligned: conv2-5), the A tile
// (32 rows x 128 columns of `lowered`) as 4 boxes of 32 columns x 32 rows,
// 128-byte swizzled, from a 2-D map over (K, M). TMA refuses conv1's
// 1452-byte rows (K = 363), so there all 128 producer threads copy the A
// tile with 4-byte cp.async, 4 rows x 8 columns a warp instruction, laid
// out [k / 8][m][k % 8], the copies' completion arriving on the full
// barrier. The transposed fragment reads (4 reduction rows x 8 columns a
// warp) fall in 32 distinct banks in that layout and meet 2-way conflicts
// in the swizzled boxes; but TMA boxes of 8 columns (32-byte rows) were
// slower at conv2-5, and copies into the swizzled layout slower at conv1,
// so each path keeps its own layout. Rows past
// M, columns past K and channels past Cout are zeros (TMA's fill, the
// scratch's padding, cp.async's zero fill). Warpgroups 1 and 2 consume 64
// rows of dW each: per 8-row step they read their A fragments, split them,
// and issue wgmma m64nBNk8 TF32, big*small + small*big, then big*big. The
// tensor cores' own fp32 accumulation truncates where IEEE rounds, so each
// stage sums into a fresh register tile (its first product with scale-d 0)
// that is added to the running sum with IEEE fp32 adds
// (hopper::tf32x3_stage, as in the forward and dgrad). The block writes
// its fp32 partial to an (S, K, Cout) scratch, and a last kernel
// (hopper::slice_sum) adds the S partials of each element in slice order.
// No atomics: a run gives the same bits as the last one. The default
// width is the one that takes the fewest tiles of Cout (each tile reads
// the residual again), and the split aims at three blocks an SM: one
// block of this size is resident at a time. Its time per layer beside its
// bound: PERF.md §6.
#include "../../common/hopper.cuh"
#include "../../common/ptx.cuh"

struct conv_wgrad;  // names this kernel's dY prologue and slice sum in a profile

namespace {

using namespace hopper;

constexpr int kBK = 128;          // rows of dW (K) per block, 64 a consumer warpgroup
constexpr int kBQ = 32;           // reduction rows (M) per stage
constexpr int kRow = kBQ * 4;     // bytes of a dY stage row: one 128-byte swizzle row
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducers = 128;   // threads of the producer warpgroup
constexpr int kStages = 4;
constexpr int kABoxes = kBK / 32; // TMA boxes of 32 columns x 32 rows in an A stage
constexpr int kABox = kBQ * 128;  // bytes of one: 32 rows of 128 swizzled bytes

// Byte offset of lowered[q0 + m][k0 + k] in an A stage. Brought by TMA:
// box k / 32, row m, 16-byte chunk (k % 32) / 4 at chunk ^ (m % 8) (the
// 128-byte swizzle). Copied by cp.async: [k / 8][m][k % 8].
template <bool ATMA>
__device__ __forceinline__ int a_offset(int m, int k) {
  if (ATMA) return (k >> 5) * kABox + m * 128 + ((((k & 31) >> 2) ^ (m & 7)) << 4) + (k & 3) * 4;
  return ((k >> 3) * kBQ + m) * 32 + (k & 7) * 4;
}

// 1024 bytes of alignment slack, the ring (A, big dY, small dY a stage),
// the full and empty mbarriers.
template <int BN>
constexpr int smem_bytes() {
  return 1024 + kStages * (kBK * kBQ * 4 + 2 * BN * kRow) + 8 * 2 * kStages;
}

// ATMA: the A tile by TMA (K % 4 == 0 and `low` 16-byte aligned), else by
// 4-byte cp.async.
template <int BN, bool ATMA>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_partial_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                     const float* __restrict__ low, float* __restrict__ part, int M, int K,
                     int Cout, int slice_rows) {
  constexpr int kABytes = kBK * kBQ * 4;
  constexpr int kBBytes = BN * kRow;         // one of big / small
  constexpr int kStageBytes = kABytes + 2 * kBBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar = base + kStages * kStageBytes;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };
  // stage s: A (a_offset) at s * kStageBytes, then big dY, then small dY

  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * kBK;
  const int q_begin = blockIdx.z * slice_rows;
  const int q_end = min(M, q_begin + slice_rows);
  const int n_k = (q_end - q_begin + kBQ - 1) / kBQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), ATMA ? 1 : kProducers + 1);   // the TMA bytes (+ each copier)
      mbar_init(empty(s), 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index through a shuffle, so the compiler sees the role
  // branch below as warp-uniform
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wgi == 0) {
    // ----- producer: dY tiles by TMA, the A tile by TMA or cp.async -----
    const int tid = threadIdx.x;
    if (tid == 0) {
      tma_prefetch(&tmb);
      if (ATMA) tma_prefetch(&tma);
    }
    // cp.async: a warp copies 4 rows x 8 columns an instruction, lane
    // (ki, mr) = (lane % 8, lane / 8); warp w takes the 8-column groups'
    // 4-row groups w, w + 4, ...
    const int lane = tid & 31, warp = tid >> 5;
    const int ki = lane & 7, mr = lane >> 3;
    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages;
      if (kt >= kStages) mbar_wait(empty(st), ((kt / kStages) - 1) & 1);
      const uint32_t sa = base + st * kStageBytes;
      const int q0 = q_begin + kt * kBQ;
      if (tid == 0) {
        mbar_arrive_expect_tx(full(st), (ATMA ? kABytes : 0) + 2 * kBBytes);
        tma_load_3d(sa + kABytes, &tmb, full(st), q0, n0, 0);
        tma_load_3d(sa + kABytes + kBBytes, &tmb, full(st), q0, n0, 1);
        if (ATMA) {
#pragma unroll
          for (int b = 0; b < kABoxes; ++b)
            tma_load_2d(sa + b * kABox, &tma, full(st), k0 + 32 * b, q0);
        }
      }
      if (!ATMA) {
#pragma unroll 8
        for (int p = 0; p < kBK * kBQ / 8 / 4 / 4; ++p) {   // 32 row groups a warp
          const int idx = warp + 4 * p;                 // (8-column group, 4-row group)
          const int kk = (idx >> 3) * 8 + ki;           // column in the stage
          const int mq = ((idx & 7) << 2) + mr;         // row in the stage
          const int k = k0 + kk;
          const int q = q0 + mq;
          const bool ok = k < K && q < q_end;
          ptx::cp_async<1>(sa + a_offset<false>(mq, kk),
                           ok ? low + static_cast<long long>(q) * K + k : low, ok);
        }
        mbar_arrive_cp_async(full(st));
      }
    }
  } else {
    // ----- consumers: 64 rows of dW a warpgroup -----
    const int cw = wgi - 1;
    const int t = threadIdx.x - 128 * wgi;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = 64 * cw + 16 * warp + g;   // this thread's rows of dW: r0, r0 + 8
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages;
      const uint32_t sa = base + st * kStageBytes;
      mbar_wait(full(st), (kt / kStages) & 1);

      // A = lowered^T, fragments of mma.sync's m16n8k8 TF32 A a warp:
      // a[e] = A[row g (+8 for e odd)][reduction row tig (+4 for e >= 2)],
      // read transposed from the stage
      auto a_at = [&](int ks, int e) {
        return sa + a_offset<ATMA>(8 * ks + tig + (e >> 1) * 4, r0 + (e & 1) * 8);
      };
      tf32x3_stage(acc, a_at, sa + kABytes, sa + kABytes + kBBytes, empty(st));
    }

    // element 4j + e: row r0 + 8 (e / 2), column 8j + 2 tig + (e % 2)
    float* out = part + static_cast<long long>(blockIdx.z) * K * Cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = k0 + r0 + 8 * (e >> 1);
        const int c = n0 + 8 * j + 2 * tig + (e & 1);
        if (r < K && c < Cout) out[static_cast<long long>(r) * Cout + c] = acc[4 * j + e];
      }
  }
}

template <int BN, bool ATMA>
cudaError_t launch(const float* low, const float* dy, float* dysplit, float* part, int M, int K,
                   int Cout, int slice_rows, int slices, cudaStream_t s) {
  cudaError_t err = split_transpose<conv_wgrad>(dy, dysplit, M, Cout, s);
  if (err != cudaSuccess) return err;
  const int m4 = round_up4(M);
  CUtensorMap tma{}, tmb;
  {
    const uint64_t dims[3] = {static_cast<uint64_t>(m4), static_cast<uint64_t>(Cout), 2};
    const uint64_t row = static_cast<uint64_t>(m4) * 4;
    const uint64_t strides[2] = {row, row * Cout};
    const uint32_t box[3] = {kBQ, BN, 1};
    if (!make_map<3>(&tmb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dysplit, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  if (ATMA) {
    const uint64_t dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
    const uint64_t strides[1] = {static_cast<uint64_t>(K) * 4};
    const uint32_t box[2] = {32, kBQ};
    if (!make_map<2>(&tma, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, low, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
  }
  constexpr int smem = smem_bytes<BN>();
  // Set on every launch: the attribute is per device, and the call is cheap.
  err = cudaFuncSetAttribute(wgrad_partial_kernel<BN, ATMA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Cout + BN - 1) / BN, (K + kBK - 1) / kBK, slices);
  wgrad_partial_kernel<BN, ATMA><<<grid, kThreads, smem, s>>>(tma, tmb, low, part, M, K, Cout,
                                                              slice_rows);
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory one block asks for at tile width block_n (64 or
// 96 output channels), -1 for any other width: the footprint model
// (lowering_conv.smem_bytes) is held to it on the card.
extern "C" int wgrad_smem_bytes(int block_n) {
  return block_n == 96 ? smem_bytes<96>() : block_n == 64 ? smem_bytes<64>() : -1;
}

// lowered: (M, K), dy: (M, Cout), dysplit: scratch of 2 * Cout * M4 floats
// (M4 = M rounded up to 4), 16-byte aligned; partial: (slices, K, Cout)
// scratch; dw: (K, Cout); all fp32 and contiguous.
// slices * slice_rows >= M > (slices - 1) * slice_rows, slice_rows % 32 == 0;
// block_n (64 or 96) is the tile's width in output channels. Returns
// cudaGetLastError() after the launches.
extern "C" int wgrad_launch(const void* lowered, const void* dy, void* dysplit, void* partial,
                            void* dw, int M, int K, int Cout, int slice_rows, int slices,
                            int block_n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 1 || K < 1 || Cout < 1 || slices < 1 || slice_rows < 1 || slice_rows % kBQ != 0 ||
      static_cast<long long>(slices) * slice_rows < M ||
      static_cast<long long>(slices - 1) * slice_rows >= M || slices > 65535 ||
      static_cast<long long>(M) + slice_rows > 0x7fffffffLL - 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(dysplit) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const float* a = static_cast<const float*>(lowered);
  const float* b = static_cast<const float*>(dy);
  float* bs = static_cast<float*>(dysplit);
  float* p = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool atma = K % 4 == 0 && (reinterpret_cast<uintptr_t>(lowered) & 15) == 0;
  if (block_n == 96)
    err = atma ? launch<96, true>(a, b, bs, p, M, K, Cout, slice_rows, slices, s)
               : launch<96, false>(a, b, bs, p, M, K, Cout, slice_rows, slices, s);
  else if (block_n == 64)
    err = atma ? launch<64, true>(a, b, bs, p, M, K, Cout, slice_rows, slices, s)
               : launch<64, false>(a, b, bs, p, M, K, Cout, slice_rows, slices, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(slice_sum<conv_wgrad>(p, static_cast<float*>(dw),
                                                static_cast<long long>(K) * Cout, slices, s));
}
