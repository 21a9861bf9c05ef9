// Convolution by lowering + GEMM for Hopper (sm_90a): a VALID NHWC conv as
// one implicit GEMM in 3xTF32 on wgmma, W brought by TMA, optionally
// writing the lowered patch matrix as the backward's residual.
//
// Replaces the TPU kernel src/repro/kernels/lowering_conv/lowering_conv.py ::
// lowering_conv_pallas (_kernel, _kernel_with_lowered, _lower_block).
//
// What it computes: with M = B*Ho*Wo rows m = (b, ho, wo) and K = kh*kw*Cin
// columns k = (i, j, c) (c fastest, the order of the JAX `lower`),
//   y[m, n] = sum_k x[b, ho*s + i, wo*s + j, c] * w[i, j, c, n]
// (w in HWIO is the (K, Cout) kernel matrix as it lies), and with a
// residual buffer also lowered[m, k] = x[b, ho*s + i, wo*s + j, c], i.e.
// the (B, Ho, Wo, K) lowered matrix of the JAX `return_lowered`, bit for
// bit (it is a copy).
//
// Bound on an H100: operations at conv2-5, bytes at conv1. 3xTF32 spends
// three TF32 tensor-core products on each of the 2*M*K*Cout necessary
// flops, so the least time is 3 * flops / 495 TFLOP/s: 0.4571 ms over
// CaffeNet's conv1-5 at group batch 64; conv1 alone is bound by the bytes
// of its residual (M*K*4 = 281 MB at K = 363: 0.118 ms).
//
// What held the design before this one back: mma.sync (Ampere's products,
// a quarter of a warpgroup's tile at a time), every warp re-splitting its
// W fragments at every stage by scalar shared-memory reads, 4-warp blocks
// with the residual written by the same warps between their products.
//
// Design (dgrad.cu's machinery, common/hopper.cuh). One launch runs two
// kernels, three where K is split. A prologue (hopper::split_transpose)
// splits W once into big = the nearest TF32 (ties away) and small = x -
// big, written transposed as a (2, Cout, K4) scratch the wrapper allocates
// (K4 = K rounded up to 4, zero-padded, so every row is 16-byte aligned for
// TMA): TF32 wgmma takes its shared-memory operand K-major only, and W lies
// with Cout contiguous. It moves ~3x W's bytes, a few microseconds at
// CaffeNet's widths. The main kernel has one block of three warpgroups per
// 128 x BN tile of y (BN = 64 or 96 output channels, an argument) and
// slice of K. K is walked in stages of 32 columns, in the lowered matrix's
// own order (taps (i, j) outer, channels inner), through a 4-stage ring,
// each stage with a "full" and an "empty" mbarrier. A layer whose tiles
// leave SMs idle (few output rows) is split over K into runs of stages that
// the wrapper picks from the shapes alone (lowering_conv.fwd_k_slices);
// each slice's block writes its partial tile to an (S, M, Cout) scratch,
// and a last kernel (hopper::slice_sum) adds the partials in slice order.
// No atomics: the same bits every run.
// Warpgroup 0 is the producer: one thread brings the stage's big and small
// W tiles (BN x 32, 128-byte rows) by TMA from a 3-D map over (K4, Cout,
// 2), output channels past Cout and columns past K4 zero-filled by the
// hardware; all 128 threads gather the A tile (128 pixels x 32 columns)
// from x with cp.async into the 128-byte swizzled layout, each thread
// keeping its rows' image offsets in registers and finding its columns'
// tap with one division a stage, and the copies' completion arrives on the
// stage's full barrier. Where Cin is a multiple of 4 (conv2-5), four
// columns never cross a tap and are contiguous in x, so a copy moves 16
// bytes; conv1 (Cin = 3, K = 363) copies 4 bytes over flat K (a stage per
// kernel row would pad its 33 columns to 64). The patches are a gather, not
// a box of x, so TMA cannot bring them. With the residual, the blocks of
// the first Cout tile write it from the producer, two stages behind its
// gather: once a stage has landed (its full barrier), each producer thread
// stores the elements it copied, 16 bytes a store where K allows, so the
// consumers never wait on it and every residual element is written once,
// unswizzled, to (B, Ho, Wo, K).
// Warpgroups 1 and 2 consume 64 pixels each: they read their A fragments
// from shared memory (conflict-free through the swizzle) and split them in
// registers, then issue wgmma m64nBNk8 TF32 with A from registers and B
// from shared memory, for each 8-column step big*small + small*big, then
// big*big. The tensor cores' own fp32 accumulation truncates where IEEE
// rounds, so each stage sums into a fresh register tile (its first product
// with scale-d 0) that is added to the running sum with one IEEE fp32 add
// per output element and stage (hopper::tf32x3_stage, the stage of all
// three conv kernels). The block has 12 warps, so ptxas compiles
// it under 168 registers a thread; a consumer holds BN/2 + BN/2
// accumulators and 32 split A registers, which is why the tile stops at 96
// channels: at 128 it would need 160 of them plus its addresses, and wgmma
// serializes when its registers run out. The default width is the one
// that takes the fewest tiles (96 at CaffeNet's 256 channels, not the 64
// that pad least): each tile gathers the patches again. Its time per layer
// beside its bound: PERF.md §6.
#include <limits.h>

#include "../../common/hopper.cuh"
#include "../../common/ptx.cuh"

struct conv_fwd;  // names this kernel's W prologue and slice sum in a profile

namespace {

using namespace hopper;

constexpr int kBM = 128;          // pixels (rows of y) per block, 64 a consumer warpgroup
constexpr int kBK = 32;           // columns of K per stage
constexpr int kRow = kBK * 4;     // bytes of a stage row: one 128-byte swizzle row
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducers = 128;   // threads of the producer warpgroup
constexpr int kStages = 4;
constexpr int kLag = 2;           // stages the residual's stores trail the gather by

// 1024 bytes of alignment slack, the ring (A, big W, small W a stage), the
// full and empty mbarriers.
template <int BN>
constexpr int smem_bytes() {
  return 1024 + kStages * (kBM + 2 * BN) * kRow + 8 * 2 * kStages;
}

// AVEC: floats per copy of the A gather (4 where Cin % 4 == 0). low_vec:
// the residual is stored 16 bytes at a time (AVEC 4 and a 16-byte aligned
// buffer); y_vec: y 8 bytes at a time (Cout even).
template <int BN, int AVEC>
__global__ void __launch_bounds__(kThreads, 1)
lowering_conv_kernel(const __grid_constant__ CUtensorMap tmw, const float* __restrict__ x,
                     float* __restrict__ y, float* __restrict__ part,
                     float* __restrict__ lowered, int H, int W, int Cin, int kw, int stride,
                     int Ho, int Wo, int Cout, int M, int K, int slice_stages, int low_vec,
                     int y_vec) {
  constexpr int kABytes = kBM * kRow;
  constexpr int kBBytes = BN * kRow;         // one of big / small
  constexpr int kStageBytes = kABytes + 2 * kBBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);   // the same bytes, generic address
  const uint32_t bar = base + kStages * kStageBytes;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };
  // stage s: A at s * kStageBytes, then big W, then small W

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  // this block's slice of K: stages kt0 .. kt0 + n_k - 1
  const int kt0 = blockIdx.z * slice_stages;
  const int n_k = min((K + kBK - 1) / kBK - kt0, slice_stages);

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
    // ----- producer: W tiles by TMA, the A gather by cp.async, the residual -----
    constexpr int CPR = kBK / AVEC;           // copies per stage row
    constexpr int RPP = kProducers / CPR;     // rows one pass of the warpgroup copies
    constexpr int PA = kBM / RPP;             // rows this thread copies per stage
    const int tid = threadIdx.x;
    const int cp_col = (tid % CPR) * AVEC;    // this thread's column in a stage
    const int cp_row = tid / CPR;             // and its first row
    if (tid == 0) tma_prefetch(&tmw);

    // The image offset of (b, ho*s, wo*s, 0) for this thread's A rows; -1
    // past M.
    int rowbase[PA];
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int m = m0 + cp_row + p * RPP;
      rowbase[p] = -1;
      if (m < M) {
        const int b = m / (Ho * Wo);
        const int r = m - b * Ho * Wo;
        const int ho = r / Wo;
        const int wo = r - ho * Wo;
        rowbase[p] = ((b * H + ho * stride) * W + wo * stride) * Cin;
      }
    }
    const int kwc = kw * Cin;
    const int wc = W * Cin;
    const bool write_low = lowered != nullptr && blockIdx.y == 0;

    // The landed stage i holds the residual's rows m0.. and columns
    // 32 (kt0 + i)..; this thread stores the elements it copied there
    // itself, so no other producer thread's copy into the stage can race
    // its reads.
    auto store_residual = [&](int i) {
      const int st = i % kStages;
      mbar_wait(full(st), (i / kStages) & 1);
      const unsigned char* ga = gbase + st * kStageBytes;
      const int k = (kt0 + i) * kBK + cp_col;
      if (k >= K) return;
#pragma unroll
      for (int p = 0; p < PA; ++p) {
        const int r = cp_row + p * RPP;
        if (rowbase[p] < 0) continue;
        const unsigned char* src =
            ga + r * kRow + ((((cp_col >> 2) ^ (r & 7)) << 4) | ((cp_col & 3) << 2));
        float* dst = lowered + static_cast<long long>(m0 + r) * K + k;
        if constexpr (AVEC == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          if (low_vec) {
            *reinterpret_cast<float4*>(dst) = v;
          } else {
            dst[0] = v.x;
            dst[1] = v.y;
            dst[2] = v.z;
            dst[3] = v.w;
          }
        } else {
          *dst = *reinterpret_cast<const float*>(src);
        }
      }
    };

    for (int i = 0; i < n_k; ++i) {
      const int st = i % kStages;
      if (i >= kStages) mbar_wait(empty(st), ((i / kStages) - 1) & 1);
      const uint32_t sa = base + st * kStageBytes;
      const int kt = kt0 + i;
      if (tid == 0) {
        mbar_arrive_expect_tx(full(st), 2 * kBBytes);
        tma_load_3d(sa + kABytes, &tmw, full(st), kt * kBK, n0, 0);
        tma_load_3d(sa + kABytes + kBBytes, &tmw, full(st), kt * kBK, n0, 1);
      }
      // column k = (ki, kj, c) lies at (ki*W + kj)*Cin + c = ki*W*Cin + (k - ki*kw*Cin)
      const int k = kt * kBK + cp_col;
      int koff = -1;
      if (k < K) {
        const int ki = k / kwc;
        koff = ki * wc + (k - ki * kwc);
      }
#pragma unroll
      for (int p = 0; p < PA; ++p) {
        const int r = cp_row + p * RPP;
        const bool ok = rowbase[p] >= 0 && koff >= 0;
        // 128-byte swizzle: 16-byte chunk c of row r lands at chunk c ^ (r % 8)
        const uint32_t dst =
            sa + r * kRow + ((((cp_col >> 2) ^ (r & 7)) << 4) | ((cp_col & 3) << 2));
        ptx::cp_async<AVEC>(dst, ok ? x + rowbase[p] + koff : x, ok);
      }
      mbar_arrive_cp_async(full(st));
      if (write_low && i >= kLag) store_residual(i - kLag);
    }
    if (write_low)
      for (int i = n_k > kLag ? n_k - kLag : 0; i < n_k; ++i) store_residual(i);
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
      // (g, t+4), (g+8, t+4) of each 8-column step; r % 8 == g)
      auto a_at = [&](int ks, int e) {
        const int r = r0 + (e & 1) * 8;
        const int chunk = 2 * ks + (e >> 1);
        return sa + r * kRow + ((chunk ^ g) << 4) + tig * 4;
      };
      tf32x3_stage(acc, a_at, sa + kABytes, sa + kABytes + kBBytes, empty(st));
    }

    // element 4j + e: row r0 + 8 (e / 2), column 8j + 2 tig + (e % 2); to
    // y, or split over K to this slice's partial
    float* out = part == nullptr ? y : part + static_cast<long long>(blockIdx.z) * M * Cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + r0 + h * 8;
        const int c = n0 + 8 * j + 2 * tig;
        if (r >= M || c >= Cout) continue;
        float* dst = out + static_cast<long long>(r) * Cout + c;
        if (y_vec) {  // Cout even: c + 1 < Cout, 8-byte aligned
          *reinterpret_cast<float2*>(dst) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          dst[0] = acc[4 * j + 2 * h];
          if (c + 1 < Cout) dst[1] = acc[4 * j + 2 * h + 1];
        }
      }
  }
}

template <int BN, int AVEC>
cudaError_t launch(const float* x, const float* w, float* wsplit, float* part, float* y,
                   float* low, int B, int H, int W, int Cin, int kh, int kw, int stride, int Ho,
                   int Wo, int Cout, int slice_stages, int slices, cudaStream_t s) {
  const int K = kh * kw * Cin;
  const int k4 = round_up4(K);
  cudaError_t err = split_transpose<conv_fwd>(w, wsplit, K, Cout, s);
  if (err != cudaSuccess) return err;

  CUtensorMap tmw;
  const uint64_t dims[3] = {static_cast<uint64_t>(k4), static_cast<uint64_t>(Cout), 2};
  const uint64_t row = static_cast<uint64_t>(k4) * 4;
  const uint64_t strides[2] = {row, row * Cout};
  const uint32_t box[3] = {kBK, BN, 1};
  if (!make_map<3>(&tmw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, wsplit, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;

  constexpr int smem = smem_bytes<BN>();
  // Set on every launch: the attribute is per device, and the call is cheap.
  err = cudaFuncSetAttribute(lowering_conv_kernel<BN, AVEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * Ho * Wo;
  const int low_vec = AVEC == 4 && (reinterpret_cast<uintptr_t>(low) & 15) == 0;
  const int y_vec = Cout % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0 &&
                    (reinterpret_cast<uintptr_t>(part) & 7) == 0;
  const dim3 grid((M + kBM - 1) / kBM, (Cout + BN - 1) / BN, slices);
  lowering_conv_kernel<BN, AVEC><<<grid, kThreads, smem, s>>>(
      tmw, x, y, slices > 1 ? part : nullptr, low, H, W, Cin, kw, stride, Ho, Wo, Cout, M, K,
      slice_stages, low_vec, y_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  return slice_sum<conv_fwd>(part, y, static_cast<long long>(M) * Cout, slices, s);
}

}  // namespace

// The dynamic shared memory one block asks for at tile width block_n (64 or
// 96 output channels), -1 for any other width: the footprint model
// (lowering_conv.smem_bytes) is held to it on the card.
extern "C" int lowering_conv_smem_bytes(int block_n) {
  return block_n == 96 ? smem_bytes<96>() : block_n == 64 ? smem_bytes<64>() : -1;
}

// x: (B, H, W, Cin), w: (kh, kw, Cin, Cout), y: (B, Ho, Wo, Cout), all fp32
// and contiguous; lowered: (B, Ho, Wo, kh*kw*Cin) or null. VALID padding.
// wsplit: scratch of 2 * Cout * K4 floats (K4 = kh*kw*Cin rounded up to
// 4), 16-byte aligned. K is split into `slices` slices of `slice_stages`
// 32-column stages (slices * slice_stages covers K, (slices - 1) *
// slice_stages does not); with slices > 1, partial is a (slices, M, Cout)
// scratch, else unused. block_n (64 or 96; any other width is refused) is
// the tile's width in output channels. Returns cudaGetLastError() after the
// launches.
extern "C" int lowering_conv_launch(const void* x, const void* w, void* wsplit, void* partial,
                                    void* y, void* lowered, int B, int H, int W, int Cin, int kh,
                                    int kw, int stride, int Cout, int block_n, int slice_stages,
                                    int slices, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stride < 1 || kh > H || kw > W || B < 1 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - kh) / stride + 1;
  const int Wo = (W - kw) / stride + 1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long K = static_cast<long long>(kh) * kw * Cin;
  if (static_cast<long long>(B) * H * W * Cin > INT_MAX || M * Cout > INT_MAX || M > INT_MAX ||
      K > INT_MAX - 3)
    return static_cast<int>(cudaErrorInvalidValue);  // offsets into x and y are 32-bit
  const long long n_k = (K + kBK - 1) / kBK;
  if (slices < 1 || slice_stages < 1 || slices > 65535 ||
      static_cast<long long>(slices) * slice_stages < n_k ||
      static_cast<long long>(slices - 1) * slice_stages >= n_k ||
      (slices > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(wsplit) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* ws = static_cast<float*>(wsplit);
  float* pf = static_cast<float*>(partial);
  float* yf = static_cast<float*>(y);
  float* low = static_cast<float*>(lowered);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool avec = Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (block_n == 96)
    err = avec ? launch<96, 4>(xf, wf, ws, pf, yf, low, B, H, W, Cin, kh, kw, stride, Ho, Wo,
                               Cout, slice_stages, slices, s)
               : launch<96, 1>(xf, wf, ws, pf, yf, low, B, H, W, Cin, kh, kw, stride, Ho, Wo,
                               Cout, slice_stages, slices, s);
  else if (block_n == 64)
    err = avec ? launch<64, 4>(xf, wf, ws, pf, yf, low, B, H, W, Cin, kh, kw, stride, Ho, Wo,
                               Cout, slice_stages, slices, s)
               : launch<64, 1>(xf, wf, ws, pf, yf, low, B, H, W, Cin, kh, kw, stride, Ho, Wo,
                               Cout, slice_stages, slices, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
