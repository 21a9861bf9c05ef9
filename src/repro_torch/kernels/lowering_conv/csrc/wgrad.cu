// Weight gradient of the lowering conv for Hopper (sm_90a): dW = lowered^T @ dY
// from the forward's lowered residual, on tensor cores in 3xTF32, split over
// the M = B*Ho*Wo rows.
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
// and about 0.25 ms for the bytes, 4*(M*K + M*Cout + K*Cout).
//
// What held the first design back: 64 x 64 tiles of fp32 CUDA-core FMAs
// (21-32 TFLOP/s of 67), stages of 16 rows loaded synchronously with a
// barrier on each side and no copy in flight during the product.
//
// Design (the machinery of lowering_conv.cu and dgrad.cu, common/ptx.cuh).
// The TPU kernel sums every grid step into one output block that stays in
// VMEM, which needs the grid to run in order. Blocks run in parallel here,
// and the output has few tiles (6 at conv1), so the M rows are split into S
// slices of `slice_rows` (a multiple of 32) that the wrapper picks from the
// shapes alone. Block (tile, slice) owns a 64 (K) x BN (Cout) tile of dW
// over its slice: 4 warps, 2 x 2, each a 32 x BN/2 tile of mma.sync
// m16n8k8 TF32 products; BN (64 or 96) pads Cout least (conv1's 96 fill one
// tile, 256 take 4 x 64, 384 take 4 x 96). The block walks its rows in
// stages of 32 through a 3-stage cp.async ring: the A stage is 32 rows x 64
// columns of `lowered`, the B stage 32 rows x BN columns of dY, both copied
// as they lie, 16 bytes a copy where K (A) or Cout (B) is a multiple of 4
// and 4 bytes otherwise (conv1's residual rows are 363 floats, not 16-byte
// aligned), zero past M, K and Cout. Both operands lie reduction-major, so
// the A fragments (dW row k x reduction row m) are read transposed, by
// scalar 32-bit shared-memory reads (ldmatrix's .trans moves b16 only);
// rows of 64 + 8 and BN + 8 floats (8 mod 32) put the 4 reduction rows x 8
// columns of a fragment read in 32 distinct banks, for A and B alike.
// Every fragment is split as big = the nearest TF32 and small = x - big, and
// each product accumulates big*small + small*big, then big*big, in fp32;
// each stage sums into a fresh register tile (its first product from a
// zero accumulator) that is added to the running sum with IEEE fp32 adds,
// since the tensor cores' own accumulation truncates (chained over all of
// K it drifted to 4e-5 relative RMS in dgrad). The block writes its fp32
// partial to an (S, K, Cout) scratch, and a second kernel sums the S
// partials of each element in slice order. No atomics: a run gives the
// same bits as the last one.
#include "../../common/ptx.cuh"

namespace {

constexpr int kBM = 64;        // rows of dW (K) per block
constexpr int kBQ = 32;        // reduction rows (M) per stage
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, 2 x 2, each a 32 x BN/2 tile
constexpr int kRSA = kBM + 8;  // A row stride in floats (8 mod 32)

template <int BN>
constexpr int smem_bytes() {
  return kStages * kBQ * (kRSA + BN + 8) * static_cast<int>(sizeof(float));
}

using namespace ptx;

// AVEC / BVEC: floats per copy of the A stage (4 where K % 4 == 0) and of
// the B stage (4 where Cout % 4 == 0).
template <int BN, int AVEC, int BVEC>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const float* __restrict__ low, const float* __restrict__ dy,
                     float* __restrict__ part, int M, int K, int Cout, int slice_rows) {
  constexpr int RSB = BN + 8;              // B row stride in floats (8 mod 32)
  constexpr int WN = BN / 2;               // columns of a warp's tile
  constexpr int NB = WN / 8;               // 8-column mma blocks per warp
  constexpr int ACPR = kBM / AVEC;         // A copies per stage row
  constexpr int PA = kBQ * ACPR / kThreads;
  constexpr int BCPR = BN / BVEC;          // B copies per stage row
  constexpr int PB = kBQ * BCPR / kThreads;
  static_assert((kBQ * ACPR) % kThreads == 0 && (kBQ * BCPR) % kThreads == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                        // kStages x kBQ x kRSA: lowered rows
  float* Bs = smem + kStages * kBQ * kRSA; // kStages x kBQ x RSB: dY rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * kBM;
  const int q_begin = blockIdx.z * slice_rows;
  const int q_end = min(M, q_begin + slice_rows);
  const int n_k = (q_end - q_begin + kBQ - 1) / kBQ;

  auto load = [&](int kt, int st) {
    const int q0 = q_begin + kt * kBQ;
    float* as = As + st * kBQ * kRSA;
    float* bs = Bs + st * kBQ * RSB;
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const int c = tid + p * kThreads;
      const int r = c / ACPR;
      const int col = (c - r * ACPR) * AVEC;
      const bool ok = q0 + r < q_end && k0 + col < K;
      cp_async<AVEC>(smem_u32(as + r * kRSA + col),
                     ok ? low + static_cast<long long>(q0 + r) * K + k0 + col : low, ok);
    }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const int c = tid + p * kThreads;
      const int r = c / BCPR;
      const int col = (c - r * BCPR) * BVEC;
      const bool ok = q0 + r < q_end && n0 + col < Cout;
      cp_async<BVEC>(smem_u32(bs + r * RSB + col),
                     ok ? dy + static_cast<long long>(q0 + r) * Cout + n0 + col : dy, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }

  float acc[2][NB][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < n_k) load(nxt, nxt % kStages);
    cp_async_commit();

    const uint32_t* asu = reinterpret_cast<const uint32_t*>(As + (kt % kStages) * kBQ * kRSA);
    const uint32_t* bsu = reinterpret_cast<const uint32_t*>(Bs + (kt % kStages) * kBQ * RSB);
    float stage[2][NB][4];  // this stage's sums, added to acc with IEEE fp32 adds
#pragma unroll
    for (int ks = 0; ks < kBQ / 8; ++ks) {
      // a[e] = A[row][q] with A = lowered^T: row g (+8 for e odd) of the
      // 16-row block, reduction row tig (+4 for e >= 2), read transposed
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const uint32_t* lo = asu + (ks * 8 + tig) * kRSA + wm * 32 + mb * 16 + g;
        const uint32_t* hi = lo + 4 * kRSA;
        split_tf32(lo[0], a_big[mb][0], a_small[mb][0]);
        split_tf32(lo[8], a_big[mb][1], a_small[mb][1]);
        split_tf32(hi[0], a_big[mb][2], a_small[mb][2]);
        split_tf32(hi[8], a_big[mb][3], a_small[mb][3]);
      }
      uint32_t b_big[NB][2], b_small[NB][2];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int n = wn * WN + nb * 8 + g;
        split_tf32(bsu[(ks * 8 + tig) * RSB + n], b_big[nb][0], b_small[nb][0]);
        split_tf32(bsu[(ks * 8 + tig + 4) * RSB + n], b_big[nb][1], b_small[nb][1]);
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if (ks == 0)
            mma_tf32_first(stage[mb][nb], a_big[mb], b_small[nb]);
          else
            mma_tf32(stage[mb][nb], a_big[mb], b_small[nb]);
          mma_tf32(stage[mb][nb], a_small[mb], b_big[nb]);
          mma_tf32(stage[mb][nb], a_big[mb], b_big[nb]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] += stage[a][b][e];
  }
  cp_async_wait<0>();

  float* out = part + static_cast<long long>(blockIdx.z) * K * Cout;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = k0 + wm * 32 + mb * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn * WN + nb * 8 + 2 * tig + (e & 1);
        if (r < K && c < Cout) out[static_cast<long long>(r) * Cout + c] = acc[mb][nb][e];
      }
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                    long long kn, int slices) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < kn;
       i += stride) {
    float acc = 0.f;
    for (int z = 0; z < slices; ++z) acc += part[z * kn + i];
    dw[i] = acc;
  }
}

template <int BN, int AVEC, int BVEC>
cudaError_t launch(const float* low, const float* dy, float* part, int M, int K, int Cout,
                   int slice_rows, int slices, cudaStream_t s) {
  constexpr int smem = smem_bytes<BN>();
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(wgrad_partial_kernel<BN, AVEC, BVEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Cout + BN - 1) / BN, (K + kBM - 1) / kBM, slices);
  wgrad_partial_kernel<BN, AVEC, BVEC><<<grid, kThreads, smem, s>>>(low, dy, part, M, K, Cout,
                                                                    slice_rows);
  return cudaGetLastError();
}

template <int BN>
cudaError_t dispatch_vec(bool avec, bool bvec, const float* low, const float* dy, float* part,
                         int M, int K, int Cout, int slice_rows, int slices, cudaStream_t s) {
  if (avec)
    return bvec ? launch<BN, 4, 4>(low, dy, part, M, K, Cout, slice_rows, slices, s)
                : launch<BN, 4, 1>(low, dy, part, M, K, Cout, slice_rows, slices, s);
  return bvec ? launch<BN, 1, 4>(low, dy, part, M, K, Cout, slice_rows, slices, s)
              : launch<BN, 1, 1>(low, dy, part, M, K, Cout, slice_rows, slices, s);
}

}  // namespace

// The dynamic shared memory one block asks for at tile width block_n (64 or
// 96 output channels), -1 for any other width: the footprint model
// (lowering_conv.smem_bytes) is held to it on the card.
extern "C" int wgrad_smem_bytes(int block_n) {
  return block_n == 96 ? smem_bytes<96>() : block_n == 64 ? smem_bytes<64>() : -1;
}

// lowered: (M, K), dy: (M, Cout), partial: (slices, K, Cout) scratch,
// dw: (K, Cout); all fp32 and contiguous.
// slices * slice_rows >= M > (slices - 1) * slice_rows, slice_rows % 32 == 0;
// block_n (64 or 96) is the tile's width in output channels. Returns
// cudaGetLastError() after the launches.
extern "C" int wgrad_launch(const void* lowered, const void* dy, void* partial, void* dw, int M,
                            int K, int Cout, int slice_rows, int slices, int block_n, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M < 1 || K < 1 || Cout < 1 || slices < 1 || slice_rows < 1 || slice_rows % kBQ != 0 ||
      static_cast<long long>(slices) * slice_rows < M ||
      static_cast<long long>(slices - 1) * slice_rows >= M || slices > 65535 ||
      static_cast<long long>(M) + slice_rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(lowered);
  const float* b = static_cast<const float*>(dy);
  float* p = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool avec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(lowered) & 15) == 0;
  const bool bvec = Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  if (block_n == 96)
    err = dispatch_vec<96>(avec, bvec, a, b, p, M, K, Cout, slice_rows, slices, s);
  else if (block_n == 64)
    err = dispatch_vec<64>(avec, bvec, a, b, p, M, K, Cout, slice_rows, slices, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kn = static_cast<long long>(K) * Cout;
  const long long blocks = (kn + 255) / 256;
  wgrad_reduce_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      p, static_cast<float*>(dw), kn, slices);
  return static_cast<int>(cudaGetLastError());
}
