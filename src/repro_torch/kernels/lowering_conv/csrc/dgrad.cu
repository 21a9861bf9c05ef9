// Input gradient of the lowering conv for Hopper (sm_90a): dX as one
// implicit GEMM in 3xTF32 on wgmma, with no patch-column matrix and no
// col2im pass.
//
// Replaces the TPU kernel src/repro/kernels/lowering_conv/bwd.py ::
// dgrad_pallas (_dgrad_kernel, _col2im_accumulate).
//
// What it computes: the JAX kernel's dcols = dY @ K^T followed by col2im,
// written as one product over the taps,
//   dX[b, h, w, c] = sum_{i, j, n} dY[b, (h-i)/s, (w-j)/s, n] * W[i, j, c, n]
// over the taps (i, j) where h-i and w-j are non-negative multiples of the
// stride s inside (Ho, Wo): a GEMM of M' = B*H*W rows (the pixels of dX),
// N' = Cin columns and depth K' = kh*kw*Cout, taken tap by tap in (i, j)
// order, Cout fastest. The A operand is gathered from dY (zero off the
// output and off the stride's lattice); the B operand is W read as
// (kh*kw*Cin, Cout), Cout contiguous. Both are K-major, which is what TF32
// wgmma takes.
//
// Bound on an H100: operations. The necessary work is the product form's
// 2*M*K*Cout flops (M = B*Ho*Wo, K = kh*kw*Cin); 3xTF32 spends three TF32
// tensor-core products on each, so the least time is 3 * flops / 495
// TFLOP/s (0.375 ms over CaffeNet's conv2-5 at group batch 64, against
// 0.926 ms at the 67 TFLOP/s fp32 CUDA-core rate). The implicit form does
// 1.46x the product form's flops on those layers (VALID padding leaves a
// zero border of taps that only add zeros). Reaching the TF32 rate takes
// wgmma, and the operand feed must not stall it.
//
// Design. One launch runs two kernels. A prologue splits W once into
// big = the nearest TF32 (ties away) and small = x - big, written as a
// (2, kh*kw*Cin, Cout4) scratch the wrapper allocates (Cout4 = Cout rounded
// up to 4, zero-padded, so every row is 16-byte aligned for TMA); it moves
// ~3x W's bytes, a few microseconds at CaffeNet's widths. The main kernel
// has one block of three warpgroups per 128 x BN tile of dX (BN = 64 or 96
// input channels, an argument); each block owns its tile: no atomics, no
// scratch for dX, the same bits every run. Stages of 32 output channels of
// one tap go through a 4-stage ring, each stage with a "full" and an
// "empty" mbarrier. Warpgroup 0 is the producer: one thread brings the
// stage's big and small W tiles (BN x 32, 128-byte rows) by TMA from a 4-D
// map over (Cout4, Cin, taps, 2), input channels past Cin and output
// channels past Cout4 zero-filled by the hardware; all 128 threads gather
// the A tile (128 pixels x 32 channels) from dY with cp.async, 16 bytes at
// a time (4 when Cout is no multiple of 4), into the 128-byte swizzled
// layout, each thread keeping its rows' pixel offsets in registers and
// walking the taps with counters, and the copies' completion arrives on
// the stage's full barrier (cp.async.mbarrier.arrive). dY is gathered and
// not boxed by TMA: a 64- or 128-pixel run of dX rows is no box of dY (it
// wraps image rows, and at stride > 1 it reads dY off the lattice), and
// the flattened tiles waste no pixel at the images' edges, where 8 x 8
// boxes would waste 29% at conv2's 27 x 27. Warpgroups 1 and 2 consume 64
// pixels each: they read their A fragments from shared memory and split
// them in registers (the swizzle makes those reads conflict-free), then
// issue wgmma m64nBNk8 TF32 with A from registers and B from shared memory,
// for each 8-channel step big*small + small*big, then big*big. The tensor
// cores' own fp32 accumulation truncates where IEEE rounds; chained over
// all of K' (6400 products at conv2) it drifted to 4e-5 relative RMS on an
// H100, so each stage sums into a fresh register tile (its first product
// with scale-d 0) that is added to the running sum with one IEEE fp32 add
// per output element and stage (hopper::tf32x3_stage, shared with the
// forward and wgrad). Stride > 1 takes the same path, paying
// for the taps that miss the lattice. The block has 12 warps, so ptxas
// compiles it under 168 registers a thread, which the consumers' 48 + 48
// accumulators and 32 split A registers fit; at CaffeNet's shapes the
// products are not what holds it below the TF32 rate (PERF.md §6-7).
#include "../../common/hopper.cuh"
#include "../../common/ptx.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;          // pixels of dX per block, 64 a consumer warpgroup
constexpr int kBK = 32;           // output channels of one tap per stage
constexpr int kRow = kBK * 4;     // bytes of a stage row: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducers = 128;   // threads of the producer warpgroup

// 1024 bytes of alignment slack, the ring (A, big W, small W a stage), the
// full and empty mbarriers.
template <int BN>
constexpr int smem_bytes() {
  return 1024 + kStages * (kBM + 2 * BN) * kRow + 8 * 2 * kStages;
}

// wsplit[0] = big, wsplit[1] = small, each (rows, cout4) with zeros past
// Cout; rows = kh*kw*Cin, in W's own order.
__global__ void split_w_kernel(const float* __restrict__ w, float* __restrict__ wsplit, int rows,
                               int Cout, int cout4) {
  const long long total = static_cast<long long>(rows) * cout4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / cout4;
    const int c = static_cast<int>(i - r * cout4);
    const float x = c < Cout ? w[r * Cout + c] : 0.f;
    uint32_t big, small;
    ptx::split_tf32(__float_as_uint(x), big, small);
    wsplit[i] = __uint_as_float(big);
    wsplit[total + i] = __uint_as_float(small);
  }
}

template <int BN, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
dgrad_kernel(const __grid_constant__ CUtensorMap tmw, const float* __restrict__ dy,
             float* __restrict__ dx, int H, int W, int Cin, int kw, int stride, int Ho, int Wo,
             int Cout, int M, int n_k) {
  constexpr int kABytes = kBM * kRow;
  constexpr int kBBytes = BN * kRow;         // one of big / small
  constexpr int kStageBytes = kABytes + 2 * kBBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bar = base + kStages * kStageBytes;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };
  // stage s: A at s * kStageBytes, then big W, then small W

  const int m0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * BN;
  const int nch = (Cout + kBK - 1) / kBK;   // stages per tap

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), kProducers + 1);    // each gather thread's copies + the TMA bytes
      mbar_init(empty(s), 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index through a shuffle, so the compiler sees the role
  // branch below as warp-uniform
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wgi == 0) {
    // ----- producer: W tiles by TMA, the A gather by cp.async -----
    constexpr int CPR = kBK / VEC;            // copies per stage row
    constexpr int RPP = kProducers / CPR;     // rows one pass of the warpgroup copies
    constexpr int PA = kBM / RPP;             // rows this thread copies per stage
    const int tid = threadIdx.x;
    const int cp_col = (tid % CPR) * VEC;     // this thread's column in a stage
    const int cp_row = tid / CPR;             // and its first row
    if (tid == 0) tma_prefetch(&tmw);

    // The pixels (b, h, w) of this thread's A rows, as h, w and the dY
    // index of tap (0, 0) at stride 1, b*Ho*Wo + h*Wo + w; rows past M get
    // h < 0.
    int row_h[PA], row_x[PA], row_base[PA];
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int m = m0 + cp_row + p * RPP;
      row_h[p] = -1;
      row_x[p] = 0;
      row_base[p] = 0;
      if (m < M) {
        const int img = m / (H * W);
        const int rem = m - img * H * W;
        row_h[p] = rem / W;
        row_x[p] = rem - row_h[p] * W;
        row_base[p] = img * Ho * Wo + row_h[p] * Wo + row_x[p];
      }
    }

    // The stages in order, tap (i, j) outer and 32 output channels at a
    // time inner, walked with counters instead of divisions.
    int ld_i = 0, ld_j = 0, ld_tap = 0, ld_chunk = 0;
    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages;
      if (kt >= kStages) mbar_wait(empty(st), ((kt / kStages) - 1) & 1);
      const uint32_t sa = base + st * kStageBytes;
      if (tid == 0) {
        mbar_arrive_expect_tx(full(st), 2 * kBBytes);
        tma_load_4d(sa + kABytes, &tmw, full(st), ld_chunk * kBK, c0, ld_tap, 0);
        tma_load_4d(sa + kABytes + kBBytes, &tmw, full(st), ld_chunk * kBK, c0, ld_tap, 1);
      }
      const int n = ld_chunk * kBK + cp_col;
#pragma unroll
      for (int p = 0; p < PA; ++p) {
        const int r = cp_row + p * RPP;
        const int hb = row_h[p] - ld_i, xb = row_x[p] - ld_j;
        bool ok = hb >= 0 && xb >= 0 && n < Cout;
        int idx;
        if (stride == 1) {
          ok = ok && hb < Ho && xb < Wo;
          idx = row_base[p] - ld_i * Wo - ld_j;
        } else {
          const int ho = hb / stride, wo = xb / stride;
          ok = ok && ho * stride == hb && wo * stride == xb && ho < Ho && wo < Wo;
          idx = row_base[p] - row_h[p] * Wo - row_x[p] + ho * Wo + wo;
        }
        const float* src = ok ? dy + static_cast<long long>(idx) * Cout + n : dy;
        // 128-byte swizzle: 16-byte chunk c of row r lands at chunk c ^ (r % 8)
        const uint32_t dst =
            sa + r * kRow + ((((cp_col >> 2) ^ (r & 7)) << 4) | ((cp_col & 3) << 2));
        ptx::cp_async<VEC>(dst, src, ok);
      }
      mbar_arrive_cp_async(full(st));
      if (++ld_chunk == nch) {
        ld_chunk = 0;
        ++ld_tap;
        if (++ld_j == kw) {
          ld_j = 0;
          ++ld_i;
        }
      }
    }
  } else {
    // ----- consumers: 64 pixels a warpgroup -----
    const int cw = wgi - 1;
    const int t = threadIdx.x - 128 * wgi;
    const int warp = t >> 5, lane = t & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = 64 * cw + 16 * warp + g;   // this thread's A rows: r0 and r0 + 8
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int st = kt % kStages;
      const uint32_t sa = base + st * kStageBytes;
      mbar_wait(full(st), (kt / kStages) & 1);

      // A fragments (mma.sync's m16n8k8 TF32 A a warp: (g, t), (g+8, t),
      // (g, t+4), (g+8, t+4) of each 8-channel step; r % 8 == g)
      auto a_at = [&](int ks, int e) {
        const int r = r0 + (e & 1) * 8;
        const int chunk = 2 * ks + (e >> 1);
        return sa + r * kRow + ((chunk ^ g) << 4) + tig * 4;
      };
      tf32x3_stage(acc, a_at, sa + kABytes, sa + kABytes + kBBytes, empty(st));
    }

#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + r0 + (e >> 1) * 8;
        const int c = c0 + 8 * j + 2 * tig + (e & 1);
        if (r < M && c < Cin) dx[static_cast<long long>(r) * Cin + c] = acc[4 * j + e];
      }
  }
}

template <int BN, int VEC>
cudaError_t launch(const float* dy, const float* w, float* wsplit, float* dx, int B, int H, int W,
                   int Cin, int kh, int kw, int stride, int Ho, int Wo, int Cout,
                   cudaStream_t s) {
  const int rows = kh * kw * Cin;
  const int cout4 = (Cout + 3) / 4 * 4;
  const long long total = static_cast<long long>(rows) * cout4;
  const long long want = (total + 255) / 256;
  const int split_blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  split_w_kernel<<<split_blocks, 256, 0, s>>>(w, wsplit, rows, Cout, cout4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap tmw;
  const uint64_t dims[4] = {static_cast<uint64_t>(cout4), static_cast<uint64_t>(Cin),
                            static_cast<uint64_t>(kh * kw), 2};
  const uint64_t row = static_cast<uint64_t>(cout4) * 4;
  const uint64_t strides[3] = {row, row * Cin, row * rows};
  const uint32_t box[4] = {kBK, BN, 1, 1};
  if (!make_map<4>(&tmw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wsplit, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;

  constexpr int smem = smem_bytes<BN>();
  // Set on every launch: the attribute is per device, and the call is cheap.
  err = cudaFuncSetAttribute(dgrad_kernel<BN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  const int n_k = kh * kw * ((Cout + kBK - 1) / kBK);
  const dim3 grid((M + kBM - 1) / kBM, (Cin + BN - 1) / BN);
  dgrad_kernel<BN, VEC><<<grid, kThreads, smem, s>>>(tmw, dy, dx, H, W, Cin, kw, stride, Ho, Wo,
                                                     Cout, M, n_k);
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory one block asks for at tile width block_n (64 or
// 96 input channels), -1 for any other width: the footprint model
// (lowering_conv.smem_bytes) is held to it on the card.
extern "C" int dgrad_smem_bytes(int block_n) {
  return block_n == 96 ? smem_bytes<96>() : block_n == 64 ? smem_bytes<64>() : -1;
}

// dy: (B, Ho, Wo, Cout), w: (kh, kw, Cin, Cout), dx: (B, H, W, Cin); all
// fp32 and contiguous; VALID padding. wsplit: scratch of
// 2 * kh*kw*Cin * Cout4 floats (Cout4 = Cout rounded up to 4), 16-byte
// aligned. block_n (64 or 96) is the tile's width in input channels.
// Returns cudaGetLastError() after the launches.
extern "C" int dgrad_launch(const void* dy, const void* w, void* wsplit, void* dx, int B, int H,
                            int W, int Cin, int kh, int kw, int stride, int Cout, int block_n,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stride < 1 || kh > H || kw > W || B < 1 || Cin < 1 || Cout < 1 ||
      static_cast<long long>(B) * H * W > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(wsplit) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  const int Ho = (H - kh) / stride + 1;
  const int Wo = (W - kw) / stride + 1;
  const float* a = static_cast<const float*>(dy);
  const float* b = static_cast<const float*>(w);
  float* ws = static_cast<float*>(wsplit);
  float* c = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  if (block_n == 96)
    err = vec ? launch<96, 4>(a, b, ws, c, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s)
              : launch<96, 1>(a, b, ws, c, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s);
  else if (block_n == 64)
    err = vec ? launch<64, 4>(a, b, ws, c, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s)
              : launch<64, 1>(a, b, ws, c, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
