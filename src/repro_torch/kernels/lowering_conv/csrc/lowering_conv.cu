// Convolution by lowering + GEMM for Hopper (sm_90a): a VALID NHWC conv as
// one implicit GEMM on tensor cores in 3xTF32, optionally writing the
// lowered patch matrix as the backward's residual.
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
// Bound on an H100: operations. 3xTF32 spends three TF32 tensor-core
// products on each of the 2*M*K*Cout necessary flops, so the least time is
// 3 * flops / 495 TFLOP/s: 0.457 ms over CaffeNet's conv1-5 at group batch
// 64, against 0.279 ms for the bytes with the residual (M*K*4 bytes, most
// at conv1 and conv2) and 1.126 ms at the 67 TFLOP/s fp32 CUDA-core rate.
//
// What held the first design back: 64 x 64 tiles of fp32 CUDA-core FMAs
// (8.7-25.5 TFLOP/s of 67), stages of 16 columns loaded synchronously with
// a barrier on each side and no copy in flight during the product, and the
// residual written with scattered 4-byte stores from inside the loader.
//
// Design (the dgrad kernel's machinery: common/ptx.cuh and dgrad.cu's tiles).
// One block of 4 warps per 64 x BN tile of y, each warp a 32 x BN/2 tile of
// mma.sync m16n8k8 TF32 products; the caller gives BN (64 or 96 output
// channels): by default the one that pads Cout least (conv1's 96 fill one
// tile, 256 take 4 x 64, 384 take 4 x 96), or the tile autotuner's pick.
// Each block owns its y tile: no atomics, the same bits every run.
// K is walked in stages of 32 columns, in the lowered matrix's own order
// (taps (i, j) outer, channels inner), through a 3-stage cp.async ring: the
// A stage (64 pixels x 32 columns) is gathered straight from x, each thread
// keeping its rows' image offsets in registers and finding its columns'
// tap with one division per stage; the B stage (32 rows x BN columns) is
// copied from w as it lies. Where Cin is a multiple of 4, four columns never
// cross a tap and are contiguous in x, so the gather moves 16 bytes a copy
// (CaffeNet's conv2-5: Cin 96-384, a stage never crosses a tap). conv1
// (Cin = 3, K = 363) takes the same loop with 4-byte copies over flat K:
// its kw*Cin = 33 contiguous columns of a kernel row are not 16-byte
// aligned in x, and a stage per kernel row would pad 33 columns to 64;
// flat stages pad K only from 363 to 384. A rows are padded by 16 bytes so
// ldmatrix (fp32 pairs moved as b16 pairs) is conflict-free; B rows are
// BN + 8 floats, so the scalar fragment reads of 4 k-rows x 8 columns fall
// in 32 distinct banks. Every fragment is split as big = the nearest TF32
// and small = x - big, and each product accumulates big*small + small*big,
// then big*big, in fp32; each stage sums into a fresh register tile (its
// first product from a zero accumulator) that is added to the running sum
// with IEEE fp32 adds, since the tensor cores' own accumulation truncates
// (chained over all of K it drifted to 4e-5 relative RMS in dgrad). With
// the residual, the blocks of the first Cout tile copy each landed A stage
// from shared memory to `lowered`, 16 bytes a store where K allows (64
// rows x 128 contiguous bytes a stage), so every residual element is
// written once.
#include <limits.h>

#include "../../common/ptx.cuh"

namespace {

constexpr int kBM = 64;        // pixels (rows of y) per block
constexpr int kBK = 32;        // columns of K per stage
constexpr int kStages = 3;
constexpr int kThreads = 128;  // 4 warps, 2 x 2, each a 32 x BN/2 tile
constexpr int kRSA = kBK + 4;  // A row stride in floats (16 bytes of padding)

template <int BN>
constexpr int smem_bytes() {
  return kStages * (kBM * kRSA + kBK * (BN + 8)) * static_cast<int>(sizeof(float));
}

using namespace ptx;

// AVEC / BVEC: floats per copy of the A gather (4 where Cin % 4 == 0) and
// of the B stage (4 where Cout % 4 == 0). low_vec: the residual is stored
// 16 bytes at a time (K % 4 == 0); y_vec: y 8 bytes at a time (Cout even).
template <int BN, int AVEC, int BVEC>
__global__ void __launch_bounds__(kThreads)
lowering_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, float* __restrict__ lowered, int H, int W, int Cin,
                     int kw, int stride, int Ho, int Wo, int Cout, int M, int K, int low_vec,
                     int y_vec) {
  constexpr int RSB = BN + 8;              // B row stride in floats
  constexpr int WN = BN / 2;               // columns of a warp's tile
  constexpr int NB = WN / 8;               // 8-column mma blocks per warp
  constexpr int ACPR = kBK / AVEC;         // A copies per row
  constexpr int ARPP = kThreads / ACPR;    // A rows one pass of the block copies
  constexpr int PA = kBM / ARPP;           // A rows this thread copies per stage
  constexpr int BCPR = BN / BVEC;          // B copies per k-row
  constexpr int PB = kBK * BCPR / kThreads;
  static_assert(kBM % ARPP == 0 && (kBK * BCPR) % kThreads == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                        // kStages x kBM x kRSA: x gathered
  float* Bs = smem + kStages * kBM * kRSA; // kStages x kBK x RSB: w rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int a_col = (tid % ACPR) * AVEC;   // this thread's columns in a stage
  const int a_row = tid / ACPR;            // and its first row

  // The image offset of (b, ho*s, wo*s, 0) for this thread's A rows; -1
  // past M.
  int rowbase[PA];
#pragma unroll
  for (int p = 0; p < PA; ++p) {
    const int m = m0 + a_row + p * ARPP;
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

  auto load = [&](int kt, int st) {
    // column k = (i, j, c) lies at (i*W + j)*Cin + c = i*W*Cin + (k - i*kw*Cin)
    const int k = kt * kBK + a_col;
    int koff = -1;
    if (k < K) {
      const int i = k / kwc;
      koff = i * wc + (k - i * kwc);
    }
    float* as = As + st * kBM * kRSA;
    float* bs = Bs + st * kBK * RSB;
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      const bool ok = rowbase[p] >= 0 && koff >= 0;
      cp_async<AVEC>(smem_u32(as + (a_row + p * ARPP) * kRSA + a_col),
                     ok ? x + rowbase[p] + koff : x, ok);
    }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const int c = tid + p * kThreads;
      const int r = c / BCPR;
      const int col = (c - r * BCPR) * BVEC;
      const int kk = kt * kBK + r;
      const bool ok = kk < K && n0 + col < Cout;
      cp_async<BVEC>(smem_u32(bs + r * RSB + col),
                     ok ? w + static_cast<long long>(kk) * Cout + n0 + col : w, ok);
    }
  };

  // The landed A stage kt is the residual's rows m0.. and columns 32 kt..
  auto store_residual = [&](const float* as, int kt) {
    const int k0 = kt * kBK;
    if (low_vec) {  // K % 4 == 0: rows of 16-byte stores
      for (int c = tid; c < kBM * kBK / 4; c += kThreads) {
        const int r = c / (kBK / 4);
        const int q = (c - r * (kBK / 4)) * 4;
        if (m0 + r < M && k0 + q < K)
          *reinterpret_cast<float4*>(lowered + static_cast<long long>(m0 + r) * K + k0 + q) =
              *reinterpret_cast<const float4*>(as + r * kRSA + q);
      }
    } else {
      for (int c = tid; c < kBM * kBK; c += kThreads) {
        const int r = c / kBK;
        const int q = c - r * kBK;
        if (m0 + r < M && k0 + q < K)
          lowered[static_cast<long long>(m0 + r) * K + k0 + q] = as[r * kRSA + q];
      }
    }
  };
  const bool write_low = lowered != nullptr && blockIdx.y == 0;

  const int n_k = (K + kBK - 1) / kBK;
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

    const float* as = As + (kt % kStages) * kBM * kRSA;
    const float* bs = Bs + (kt % kStages) * kBK * RSB;
    if (write_low) store_residual(as, kt);
    const uint32_t* bsu = reinterpret_cast<const uint32_t*>(bs);
    float part[2][NB][4];  // this stage's sums, added to acc with IEEE fp32 adds
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        uint32_t raw[4];
        ldmatrix_x4(raw, smem_u32(as + (wm * 32 + mb * 16 + (lane & 15)) * kRSA + ks * 8 +
                                  (lane >> 4) * 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(raw[e], a_big[mb][e], a_small[mb][e]);
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
            mma_tf32_first(part[mb][nb], a_big[mb], b_small[nb]);
          else
            mma_tf32(part[mb][nb], a_big[mb], b_small[nb]);
          mma_tf32(part[mb][nb], a_small[mb], b_big[nb]);
          mma_tf32(part[mb][nb], a_big[mb], b_big[nb]);
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] += part[a][b][e];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 32 + mb * 16 + g + h * 8;
        const int c = n0 + wn * WN + nb * 8 + 2 * tig;
        if (r >= M || c >= Cout) continue;
        float* dst = y + static_cast<long long>(r) * Cout + c;
        if (y_vec) {  // Cout even: c + 1 < Cout, 8-byte aligned
          *reinterpret_cast<float2*>(dst) = make_float2(acc[mb][nb][2 * h], acc[mb][nb][2 * h + 1]);
        } else {
          dst[0] = acc[mb][nb][2 * h];
          if (c + 1 < Cout) dst[1] = acc[mb][nb][2 * h + 1];
        }
      }
}

template <int BN, int AVEC, int BVEC>
cudaError_t launch(const float* x, const float* w, float* y, float* low, int B, int H, int W,
                   int Cin, int kh, int kw, int stride, int Ho, int Wo, int Cout, cudaStream_t s) {
  constexpr int smem = smem_bytes<BN>();
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(lowering_conv_kernel<BN, AVEC, BVEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int M = B * Ho * Wo;
  const int K = kh * kw * Cin;
  const int low_vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(low) & 15) == 0;
  const int y_vec = Cout % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0;
  const dim3 grid((M + kBM - 1) / kBM, (Cout + BN - 1) / BN);
  lowering_conv_kernel<BN, AVEC, BVEC><<<grid, kThreads, smem, s>>>(
      x, w, y, low, H, W, Cin, kw, stride, Ho, Wo, Cout, M, K, low_vec, y_vec);
  return cudaGetLastError();
}

template <int BN>
cudaError_t dispatch_vec(bool avec, bool bvec, const float* x, const float* w, float* y,
                         float* low, int B, int H, int W, int Cin, int kh, int kw, int stride,
                         int Ho, int Wo, int Cout, cudaStream_t s) {
  if (avec)
    return bvec ? launch<BN, 4, 4>(x, w, y, low, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s)
                : launch<BN, 4, 1>(x, w, y, low, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s);
  return bvec ? launch<BN, 1, 4>(x, w, y, low, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s)
              : launch<BN, 1, 1>(x, w, y, low, B, H, W, Cin, kh, kw, stride, Ho, Wo, Cout, s);
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
// block_n (64 or 96; any other width is refused) is the tile's width in
// output channels. Returns cudaGetLastError() after the launch.
extern "C" int lowering_conv_launch(const void* x, const void* w, void* y, void* lowered, int B,
                                    int H, int W, int Cin, int kh, int kw, int stride, int Cout,
                                    int block_n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (stride < 1 || kh > H || kw > W || B < 1 || Cin < 1 || Cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - kh) / stride + 1;
  const int Wo = (W - kw) / stride + 1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const long long K = static_cast<long long>(kh) * kw * Cin;
  if (static_cast<long long>(B) * H * W * Cin > INT_MAX || M * K > INT_MAX ||
      M * Cout > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);  // offsets are 32-bit
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  float* low = static_cast<float*>(lowered);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool avec = Cin % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool bvec = Cout % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (block_n == 96)
    err = dispatch_vec<96>(avec, bvec, xf, wf, yf, low, B, H, W, Cin, kh, kw, stride, Ho, Wo,
                           Cout, s);
  else if (block_n == 64)
    err = dispatch_vec<64>(avec, bvec, xf, wf, yf, low, B, H, W, Cin, kh, kw, stride, Ho, Wo,
                           Cout, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
